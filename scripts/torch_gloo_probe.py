"""Which ``torch.distributed`` calls the gloo backend runs on CUDA tensors.

The sharded solve (parallel/shard.py, parallel/halo.py) and the
collective transport (parallel/transport.py) run several ranks on one
card, where NCCL refuses two ranks on one device, so they use gloo with
their tensors on the card. This probe starts a 4-rank gloo world on
``cuda:0`` for each call and checks its values::

    python3 scripts/torch_gloo_probe.py [--device cuda:0]

It prints one JSON line: each call's outcome ("ok" or the error) and its
seconds. Each call runs in a world of its own, so a call that fails or
hangs (stopped at the deadline) does not hide the others.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngsamg_tpu_torch.parallel.world import spawn_world  # noqa: E402

CALLS = (
    "all_reduce",
    "broadcast",
    "all_gather",
    "all_gather_into_tensor",
    "all_to_all_single",
    "send_recv",
    "subgroup_all_gather",
)


def _probe(mesh, call):
    r, n, dev = mesh.rank, mesh.size, mesh.device
    x = torch.arange(4, dtype=torch.float64, device=dev) + 10 * r
    if call == "all_reduce":
        dist.all_reduce(x)
        want = torch.arange(4, dtype=torch.float64) * n + 10 * sum(range(n))
        ok = torch.equal(x.cpu(), want)
    elif call == "broadcast":
        dist.broadcast(x, src=0)
        ok = torch.equal(x.cpu(), torch.arange(4, dtype=torch.float64))
    elif call == "all_gather":
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
        ok = all(float(o[0]) == 10 * s for s, o in enumerate(out))
    elif call == "all_gather_into_tensor":
        out = torch.empty(n * 4, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = all(float(out[4 * s]) == 10 * s for s in range(n))
    elif call == "all_to_all_single":
        src = torch.arange(n, dtype=torch.int32, device=dev) + 100 * r
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        ok = all(int(out[s]) == 100 * s + r for s in range(n))
    elif call == "send_recv":
        if r % 2 == 0:
            dist.send(x, dst=r + 1)
            ok = True
        else:
            got = torch.empty_like(x)
            dist.recv(got, src=r - 1)
            ok = float(got[0]) == 10 * (r - 1)
    elif call == "subgroup_all_gather":
        g, ranks = mesh.groups[2]
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x, group=g)
        ok = all(float(o[0]) == 10 * q for q, o in zip(ranks, out))
    else:
        raise ValueError(call)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    flags = [None] * n
    dist.all_gather_object(flags, bool(ok))  # pickled, on CPU tensors
    if not all(flags):
        raise AssertionError(f"{call}: wrong values on ranks {flags}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=60.0)
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_gloo_probe: CUDA is not available")
    out = {}
    for call in CALLS:
        t0 = time.perf_counter()
        try:
            spawn_world(
                _probe, a.ranks, backend="gloo", device=a.device,
                args=(call,), timeout=a.timeout,
            )
            res = "ok"
        except Exception as e:  # the probe's finding, recorded as such
            res = f"{type(e).__name__}: {' '.join(str(e).split())[:400]}"
        out[call] = {"result": res, "s": time.perf_counter() - t0}
    print(json.dumps({"gloo_probe": out, "device": a.device,
                      "ranks": a.ranks, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
