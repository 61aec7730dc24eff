"""Run the sharded solve on a spawned world of ranks.

Every rank of the world runs the same list of tasks in the same order
(their collectives must match), on the hierarchy it is given: an
``AMGOperator`` (this package's, host or device tensors) or the path of a
file that ``torch.save`` wrote it to (each rank maps the file and cuts
its own rows, so the hierarchy is not sent to every rank). Rank 0's
results come back to the caller::

    from ngsamg_tpu_torch.parallel.sharded_run import spawn_tasks
    res = spawn_tasks(
        [{"kind": "pcg", "op": op, "b": b, "tol": 1e-8}], 8,
        backend="gloo", device="cuda:0",
    )

Task kinds (``shard`` is a dict of ``shard_operator`` keywords):

* ``pcg``: the sharded PCG (solve/pcg.py) from a zero guess to ``tol``;
  with ``steps`` instead, that many masked PCG steps at tolerance
  ``tol2`` (the JAX tests' fixed chunks), stopping early once the
  residual has dropped by ``until``. ``warm`` solves run first. Returns
  the full x, the iterations, the relative residual, the seconds,
  ``level_shard_counts``, the formats and placements of the levels, this
  rank's collective rounds and bytes, and every rank's kernel launches.
* ``window_k2``: K2's windowed entry on every rank's block of the
  sharded level 0 against its plain version; rank 0's timings.
* ``apply``: one cycle ``amg_apply(op_s, b)``; returns the full result,
  and each level's sharded matvec of the vectors in ``matvecs``.
* ``demo``: ``halo.demo_sharded_solve(mesh, n)``; ``dia_halo``:
  ``halo.dia_halo_matvec`` of a DiaMatrix ``A`` on ``x``.
* ``tile_halo``: ``halo.tile_halo_matvec`` of a TileELL on x.
* ``import_check``: whether ``jax`` or ``ngsamg_tpu`` is imported in the
  rank.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .shard import (
    COUNTS,
    RowShard,
    level_shard_counts,
    local_rows,
    gather_rows,
    reset_counts,
    shard_operator,
)
from .world import Mesh, spawn_world

__all__ = ["run_tasks", "spawn_tasks", "describe"]


def _load(op):
    if isinstance(op, str):
        return torch.load(op, mmap=True, weights_only=False)
    return op


def describe(op_s) -> list:
    """Per level: the rank's operator class, its shard count, whether P
    holds only the rank's rows, and the bytes of P's data on the rank."""
    out = []
    for lev in op_s.levels:
        pl = getattr(lev.A, "placement", None)
        P = lev.P
        inner = getattr(P, "A", P)
        data = getattr(inner, "data", None)
        A = lev.A.A if isinstance(lev.A, RowShard) else lev.A
        out.append({
            "A": type(A).__name__,
            "j": 1 if pl is None else pl.j,
            "smoother": type(lev.smoother).__name__,
            "P": None if P is None else type(P).__name__,
            "P_local_rows": getattr(P, "local_rows", None),
            "P_bytes": 0 if not isinstance(data, torch.Tensor)
            else data.numel() * data.element_size(),
            "comm_per_apply": getattr(lev.A, "comm_per_apply", None),
            "nrows": getattr(lev.A, "nrows", None),
        })
    return out


def _vec(b, dtype, dev):
    return torch.as_tensor(np.asarray(b)).to(dtype=dtype, device=dev)


def _op_dtype(op):
    return op.levels[0].A.data.dtype if hasattr(op.levels[0].A, "data") \
        else op.levels[0].A.vals.dtype


def _task(mesh: Mesh, t: dict):
    from ..solve.cycle import amg_apply
    from ..solve.pcg import _pcg_init, _pcg_step, pcg

    kind = t["kind"]
    if kind == "import_check":
        return {
            "jax": any(m == "jax" or m.startswith("jax.")
                       for m in sys.modules),
            "ngsamg_tpu": any(m == "ngsamg_tpu"
                              or m.startswith("ngsamg_tpu.")
                              for m in sys.modules),
        }
    if kind == "demo":
        from .halo import demo_sharded_solve

        return demo_sharded_solve(mesh, t.get("n", 24))
    if kind == "dia_halo":
        from .halo import dia_halo_matvec
        from .shard import placement

        A = t["A"]
        pl = placement(mesh, A.nrows_pad, mesh.size)
        sl = slice(pl.r0, pl.r0 + pl.local)
        x = _vec(t["x"], A.data.dtype, mesh.device)
        y = dia_halo_matvec(A, mesh, pl)(
            A.data[:, sl].contiguous().to(mesh.device), x[sl]
        )
        return {"y": pl.gather(y).cpu().numpy()}
    if kind == "tile_halo":
        from .halo import tile_halo_matvec

        fn, d, c, s, comm = tile_halo_matvec(t["A"], mesh)
        pl_n = t["A"].nrows_pad // mesh.size
        x = _vec(t["x"], d.dtype, mesh.device)
        xl = x[mesh.rank * pl_n: (mesh.rank + 1) * pl_n]
        y = fn(d, c, s, xl)
        from .shard import placement

        y = placement(mesh, t["A"].nrows_pad, mesh.size).gather(y)
        return {"y": y.cpu().numpy(), "comm": comm}
    if kind == "window_k2":
        return _window_task(mesh, t)
    if kind not in ("apply", "pcg"):
        raise ValueError(f"unknown task {kind!r}")
    op = _load(t["op"])
    op_s, A_s = shard_operator(op, op.levels[0].A, mesh, **t.get("shard", {}))
    dev = mesh.device
    dt = _op_dtype(op)
    b = _vec(t["b"], dt, dev)
    bl = local_rows(A_s, b)
    if kind == "apply":
        from ..sparse.formats import matvec

        y = amg_apply(op_s, bl)
        # each level's sharded operator on the given vectors
        mv = []
        for lev, xv in zip(op_s.levels, t.get("matvecs", ())):
            xl = _vec(xv, dt, dev)
            pl = getattr(lev.A, "placement", None)
            if pl is not None:
                xl = pl.take(xl)
            yl = matvec(lev.A, xl)
            mv.append((yl if pl is None else pl.gather(yl)).cpu().numpy())
        return {"y": gather_rows(A_s, y).cpu().numpy(),
                "matvecs": mv,
                "counts": level_shard_counts(op_s),
                "levels": describe(op_s)}
    for _ in range(t.get("warm", 0)):
        pcg(op_s, A_s, bl, tol=t.get("tol", 1e-8),
            maxiter=t.get("maxiter", 200))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    _reset_launches()
    if "steps" in t:
        # masked PCG steps at tolerance tol2 (the JAX oracle's loop): at
        # most ``steps``, or until rn <= until^2 rn0
        state = _pcg_init(bl, A_s)
        rn0 = float(state[4])
        tol2 = torch.tensor(t.get("tol2", 0.0), dtype=bl.dtype, device=dev)
        until2 = t.get("until", 0.0) ** 2
        rns = []
        for _ in range(t["steps"]):
            state = _pcg_step(op_s, A_s, state, tol2)
            rns.append(float(state[4]))
            if rns[-1] <= until2 * rn0:
                break
        x, k = state[0], len(rns)
        rel = float(np.sqrt(max(rns[-1], 0.0) / rn0))
        out = {"rn": rns, "rn0": rn0}
    else:
        res = pcg(op_s, A_s, bl, tol=t.get("tol", 1e-8),
                  maxiter=t.get("maxiter", 200))
        x, k, rel = res.x, int(res.iterations), float(res.relres)
        out = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    counts = dict(COUNTS)
    out["launches_per_rank"] = _gather_objects(_launches(), mesh)
    out.update({
        "x": gather_rows(A_s, x).cpu().numpy(),
        "iterations": k,
        "relres": rel,
        "seconds": secs,
        "collectives": counts,
        "counts": level_shard_counts(op_s),
        "levels": describe(op_s),
    })
    return out


def _launches() -> dict:
    from ..ops import dia_cuda, stencil_cuda

    return {k: v for d in (stencil_cuda.LAUNCHES, dia_cuda.LAUNCHES)
            for k, v in d.items() if v}


def _reset_launches() -> None:
    from ..ops import dia_cuda, stencil_cuda

    for d in (stencil_cuda.LAUNCHES, dia_cuda.LAUNCHES):
        for k in d:
            d[k] = 0


def _gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` (pickled over the process group)."""
    import torch.distributed as dist

    got = [None] * mesh.size
    dist.all_gather_object(got, obj)
    return got


def _window_cost(W) -> tuple:
    """(bytes, flops) of one windowed DIA matvec: the in-range data
    entries (row in the block, column in [0, x_len)), the x values the
    window reads, the offsets, and y, each once; two operations a stored
    nonzero."""
    n, base, xl = W.nrows, W.x_base, W.x_len
    es = W.data.element_size()
    used = sum(
        max(0, min(n, xl - base - o) - max(0, -base - o))
        for o in W.offsets
    )
    lo = max(0, base + min(W.offsets))
    hi = min(xl, base + n + max(W.offsets))
    nz = int((W.data != 0).sum())
    return (used + max(0, hi - lo) + n) * es + 8 * len(W.offsets), 2 * nz


def _window_task(mesh: Mesh, t: dict) -> dict:
    """K2's windowed entry on this rank's block of the sharded level 0:
    held against its plain version on every rank; rank 0 times it (the
    other ranks wait) beside its plain version and one cuSPARSE call on
    the same rows."""
    import torch.distributed as dist

    from ..ops import dia_cuda
    from ..sparse.formats import DiaWindow

    op = _load(t["op"])
    op_s, A_s = shard_operator(op, op.levels[0].A, mesh, **t.get("shard", {}))
    W = getattr(A_s, "A", None)
    if not isinstance(W, DiaWindow):
        raise TypeError(f"level 0 of rank {mesh.rank} is {type(W).__name__}"
                        ", not a DiaWindow")
    dev = mesh.device
    rng = np.random.default_rng(t.get("seed", 0))
    x = torch.from_numpy(rng.standard_normal((W.x_len, 1))).to(
        device=dev, dtype=W.data.dtype
    )
    y = dia_cuda.dia_matvec(W, x)
    y_ref = dia_cuda._dia_matvec_plain(W, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    err = float((y - y_ref).abs().max())
    rel = err / max(float(y_ref.abs().max()), 1e-300)
    same = bool(torch.equal(y, dia_cuda.dia_matvec(W, x)))
    checks = _gather_objects(
        {"rank": mesh.rank, "max_abs_err": err, "rel_err": rel,
         "same_bits": same, "rows": W.nrows, "x_base": W.x_base,
         "plan": W.launch.plan.path}, mesh,
    )
    nbytes, flops = _window_cost(W)
    out = {"checks": checks, "bytes": nbytes, "flops": flops,
           "terms": len(W.offsets), "window": W.launch.plan.window}
    if mesh.rank == 0 and dev.type == "cuda":
        from ..utils.timing import cold_ms, event_ms, graph_ms

        csr = _window_csr(W)
        out.update({
            "device_ms": graph_ms(lambda: dia_cuda.dia_matvec(W, x)),
            "cold_ms": cold_ms(lambda: dia_cuda.dia_matvec(W, x)),
            "call_ms": event_ms(lambda: dia_cuda.dia_matvec(W, x)),
            "plain_ms": graph_ms(lambda: dia_cuda._dia_matvec_plain(W, x),
                                 n=5),
            "library_ms": graph_ms(lambda: torch.sparse.mm(csr, x)),
        })
    dist.barrier()
    return out


def _window_csr(W):
    """The block's rows as a (nrows, x_len) CSR tensor (explicit zeros
    dropped): the cuSPARSE yardstick of the windowed K2."""
    i = torch.arange(W.nrows, device=W.data.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(W.offsets):
        j = W.x_base + i + off
        m = (j >= 0) & (j < W.x_len) & (W.data[d] != 0)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(W.data[d][m])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (W.nrows, W.x_len),
    ).coalesce()
    return coo.to_sparse_csr()


def run_tasks(mesh: Mesh, tasks: list) -> list:
    """Run ``tasks`` in order on this rank (see the module docstring);
    each result carries its wall seconds on this rank (``wall_s``)."""
    out = []
    for t in tasks:
        t0 = time.perf_counter()
        r = _task(mesh, t)
        if isinstance(r, dict):
            r["wall_s"] = time.perf_counter() - t0
        out.append(r)
    return out


def spawn_tasks(tasks: list, n: int, *, backend: str, device: str,
                timeout: float = 600.0) -> list:
    """``run_tasks`` on a spawned world of ``n`` ranks; rank 0's results."""
    return spawn_world(
        run_tasks, n, backend=backend, device=device, args=(tasks,),
        timeout=timeout,
    )
