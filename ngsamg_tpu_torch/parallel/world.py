"""A world of ranks on ``torch.distributed``: the mesh and its spawner.

The JAX package drives many devices from one process through a ``Mesh``
(ngsamg_tpu/parallel/shard.py ``make_mesh``) and lets GSPMD insert the
collectives. PyTorch's idiom is one process per rank, so the port's mesh
is a small object over an initialised process group: the rank, the world
size, the rank's device, and the factored sub-groups that
``parallel/shard.py::shard_operator`` places mid-size levels on (one
sub-group for each 2^k-rank level placement, k = 1 .. m-1 for a world of
2^m ranks, made by ``dist.new_group`` on every rank in the same order).

The backend is the caller's choice: ``"nccl"`` where every rank has its
own card, ``"gloo"`` where ranks share one card or run on the CPU.
:func:`spawn_world` starts ``n`` fresh ranks (spawn start method, a free
port on localhost, ``init_process_group(timeout=...)``), runs one
function in each and returns rank 0's result; any rank's exception is
raised in the caller, and every rank is stopped at a deadline.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "spawn_world", "LAST_WORLD"]

# the last world's clock (time.time() epochs): when the caller started
# the ranks and had every result, and per rank when its process started,
# when its process group was up and when its function returned
LAST_WORLD: dict = {}


class Mesh:
    """The rank's view of an initialised process group.

    ``groups[j]`` is the sub-group that all-gathers a vector sharded over
    ``j`` ranks (the ranks holding the j shards of one replica), with the
    rank's shard index ``shard_index(j)``. For a world of 2^m ranks, a
    j = 2^k placement shards rows over the first k axes of the JAX
    package's factored mesh (devices reshaped to (2,) * m), so the shard
    of rank d is d >> (m - k) and its replica is d mod 2^(m - k). Any
    other world size has the binary shard-or-replicate choice only.
    """

    def __init__(self, backend: str, device: str | torch.device):
        self.backend = backend
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        n = self.size
        m = n.bit_length() - 1
        self.factored = n > 1 and (1 << m) == n
        self.groups: dict = {n: (dist.group.WORLD, tuple(range(n)))}
        if self.factored:
            for k in range(1, m):
                j = 1 << k
                stride = n // j
                for low in range(stride):
                    ranks = tuple(low + stride * i for i in range(j))
                    g = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        self.groups[j] = (g, ranks)

    def shard_index(self, j: int) -> int:
        """This rank's shard among ``j`` (0 when replicated)."""
        if j <= 1:
            return 0
        return self.groups[j][1].index(self.rank)

    def replica_index(self, j: int) -> int:
        """Which copy of a ``j``-way sharded vector this rank holds."""
        if j <= 1:
            return self.rank
        return self.rank % (self.size // j)

    def group(self, j: int):
        return self.groups[j][0]


def make_mesh(backend: str, device: str | torch.device) -> Mesh:
    """The mesh of the process group this rank has initialised."""
    return Mesh(backend, device)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, device, payload, conn, timeout):
    import pickle
    import warnings

    clock = {"start": time.time()}
    # torch 2.13 renames the call; 2.11 (the card's host) has the old name
    warnings.filterwarnings(
        "ignore", message=".*all_gather_into_tensor.*", category=FutureWarning
    )
    try:
        with open(payload, "rb") as fh:  # written by spawn_world
            fn, args = pickle.load(fh)
        if torch.device(device).type == "cpu":
            # many ranks share the host's cores (and test workers)
            torch.set_num_threads(1)
        dist.init_process_group(
            backend,
            init_method=f"tcp://127.0.0.1:{port}",
            rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            mesh = Mesh(backend, device)
            clock["ready"] = time.time()
            res = fn(mesh, *args)
            clock["done"] = time.time()
        finally:
            dist.destroy_process_group()
        conn.send(("ok", res if rank == 0 else None, clock))
    except Exception as e:  # surface the rank's failure to the caller
        conn.send(("err", f"rank {rank}: {e!r}\n{traceback.format_exc()}"))
    finally:
        conn.close()


def spawn_world(
    fn,
    n: int,
    *,
    backend: str,
    device: str,
    args: tuple = (),
    timeout: float = 300.0,
):
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks; rank 0's result.

    ``fn`` must be importable by name (a module-level function of this
    package: a spawned rank imports only what it needs). ``backend`` and
    ``device`` (every rank's tensors, e.g. ``"cuda:0"`` or ``"cpu"``)
    are the caller's to give; neither has a default. ``timeout``
    bounds each collective (the process group's timeout) and the whole
    world: a rank that has not reported by then is killed with the
    others, and the caller gets a ``TimeoutError``.
    """
    import multiprocessing as mp
    import pickle
    import tempfile
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs, conns = [], []
    # the function and its arguments go through a file that every rank
    # reads once it has started: a spawned process unpickles what it is
    # handed before it runs, so a large argument handed to each would
    # start the ranks one after another
    fd, payload = tempfile.mkstemp(prefix="ngsamg_world_", suffix=".pkl")
    with os.fdopen(fd, "wb") as fh:
        pickle.dump((fn, args), fh, protocol=pickle.HIGHEST_PROTOCOL)
    LAST_WORLD.clear()
    LAST_WORLD.update(spawned=time.time(), ranks={})
    results: dict = {}
    # the ranks inherit the environment: quiet c10d's warnings about the
    # loopback host name (one a rank), restored in the caller afterwards
    saved = os.environ.get("TORCH_CPP_LOG_LEVEL")
    os.environ["TORCH_CPP_LOG_LEVEL"] = saved or "ERROR"
    try:
        try:
            for r in range(n):
                pc, cc = ctx.Pipe(duplex=False)
                p = ctx.Process(
                    target=_rank_main,
                    args=(r, n, port, backend, str(device), payload, cc,
                          timeout),
                    daemon=True,
                )
                p.start()
                cc.close()
                procs.append(p)
                conns.append(pc)
        finally:
            if saved is None:
                os.environ.pop("TORCH_CPP_LOG_LEVEL", None)
        deadline = time.monotonic() + timeout + 30.0
        pending = dict(zip(conns, range(n)))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(pending.values())} of {n} did not "
                    f"report within {timeout + 30.0:.0f} s"
                )
            for c in wait(list(pending), timeout=left):
                r = pending.pop(c)
                try:
                    msg = c.recv()
                except EOFError:
                    raise RuntimeError(
                        f"rank {r} exited with code "
                        f"{procs[r].exitcode} without a result"
                    ) from None
                if msg[0] != "ok":
                    raise RuntimeError(msg[1])
                results[r] = msg[1]
                LAST_WORLD["ranks"][r] = msg[2]
        LAST_WORLD["results"] = time.time()
    finally:
        # a few seconds' grace for all ranks together, then stop them
        grace = time.monotonic() + (
            5.0 if results.keys() == set(range(n)) else 0.1
        )
        for p in procs:
            p.join(timeout=max(0.0, grace - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        os.unlink(payload)
    return results[0]
