#!/usr/bin/env python3
"""Smoke run of ngsamg_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py    # poisson_3d(216), 9,938,375 DoF, and
                             # unstructured_poisson(55, 3, refine=1), 1,411,632

Phases, each of which raises (nonzero exit) on failure:

1. device — a CUDA device must exist; prints its name and the
   ``nvidia-smi`` name/power limit; turns TF32 off.
2. build — builds the CUDA kernels from ``ngsamg_tpu_torch/csrc`` with nvcc
   (timed), then holds each kernel against its plain PyTorch version on the
   small odd shapes of the CPU tests.
3. main path — resets the kernel launch counters, assembles
   ``fem.poisson_3d(216)``, runs ``AMGPreconditioner(..., device="cuda")
   .setup()`` and ``solve(b, tol=1e-8, return_device=True)``, reads the
   counters, and checks levels, operator complexity, convergence, the true
   relative residual (host, f64, scipy) and that every kernel ran.
4. kernels at the main path's shapes — each kernel against its plain
   version on the staged levels of that hierarchy (max |err| / max |y|
   <= 1e-6 in f32, <= 1e-13 in f64: same sum order, FMA contraction
   differs), with the median time per call of both over >= 20 calls; a
   warm second solve; and a small solve on the card against the same
   solve on the CPU.
5. unstructured path — resets the counters, assembles
   ``fem.unstructured_poisson(55, dim=3, refine=1)`` (perturbed Delaunay,
   one red refinement), sets it up on the card (generic level loop,
   tile-ELL levels and transfers, cluster correction) and solves it to
   1e-8 (host defect correction), reads the counters; checks the level
   count, operator complexity, iterations, true relative residual and
   that every level and transfer is tile-ELL or dense; a warm second
   solve.
6. tile-ELL — the median time per call (>= 20 calls, CUDA events) of the
   plain torch tile-ELL matvec of every tile-ELL level and transfer of that
   hierarchy (there is no hand-written tile-ELL kernel yet).
7. unstructured reference — ``unstructured_poisson(20, dim=3)`` (a DIA
   finest level under tile-ELL transfers and cluster correction) on the
   card against the CPU; K2 must launch.

The last lines are the nvidia-smi line, one JSON object describing the
kernels, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 1e-6
F64_TOL = 1e-13
HEADLINE_LEVELS = [9938375, 1259712, 157464, 19683, 2744, 343]
UNSTRUCT_DOFS = 1411632
UNSTRUCT_LEVELS = 7
UNSTRUCT_OC = 2.09  # the JAX package's operator complexity, to 2 places
UNSTRUCT_MAX_IT = 25
UNSTRUCT_FORMATS = {"TileELLStack", "TileELL", "DenseMatrix"}
KERNELS = {
    "stencil_matvec_f32": (
        "ngsamg_tpu_torch/csrc/stencil_matvec.cu",
        "ngsamg_tpu/ops/stencil_pallas.py:38",
    ),
    "stencil_matvec_f64": (
        "ngsamg_tpu_torch/csrc/stencil_matvec.cu",
        "ngsamg_tpu/ops/stencil_pallas.py:38",
    ),
    "dia_sym_matvec_f32": (
        "ngsamg_tpu_torch/csrc/dia_matvec.cu",
        "ngsamg_tpu/ops/dia_pallas.py:105",
    ),
    "dia_matvec_f32": (
        "ngsamg_tpu_torch/csrc/dia_matvec.cu",
        "ngsamg_tpu/ops/dia_pallas.py:31",
    ),
}


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _counts():
    from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda

    return {**stencil_cuda.LAUNCHES, **dia_cuda.LAUNCHES}


def _reset_counts():
    from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda

    for d in (stencil_cuda.LAUNCHES, dia_cuda.LAUNCHES):
        for k in d:
            d[k] = 0


def _time_ms(fn, reps: int = 25) -> float:
    """Median device time per call (CUDA events), after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def _rand_x(nrows, nrows_pad, dtype, seed):
    import torch

    rng = np.random.default_rng(seed)
    x = np.zeros((nrows_pad, 1))
    x[:nrows, 0] = rng.standard_normal(nrows)
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def _check_kernel(A, x, kernel, plain, tol, label):
    """Kernel vs plain version on one input; returns the relative error."""
    import torch

    y = kernel(A, x)
    y_ref = plain(A, x)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    scale = max(float(y_ref.abs().max()), 1e-300)
    tail = float(y[A.nrows:].abs().max()) if A.nrows < A.nrows_pad else 0.0
    rel = err / scale
    if not np.isfinite(rel) or rel > tol or tail != 0.0:
        raise AssertionError(
            f"{label}: kernel vs plain max|err|/max|y| = {rel:.3e} "
            f"(tol {tol:.0e}), pad tail max {tail}"
        )
    return err, rel


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{_nvidia_smi()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)


def phase_build():
    """Build the kernels, then check them on the CPU tests' small shapes."""
    import torch

    from ngsamg_tpu_torch.ops import cuda_lib, dia_cuda, stencil_cuda
    from ngsamg_tpu_torch.sparse import formats

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    tile = 8192
    for dims, offs in [
        ((7, 9, 11), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                      (0, -1, 0), (0, 0, 1), (0, 0, -1)]),
        ((5, 4, 38), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 2),
                      (1, 1, -1), (-1, -1, 1)]),
        ((33, 131), [(0, 0), (2, 0), (-2, 0), (0, 3), (0, -3), (1, 1),
                     (-1, -1)]),
    ]:
        n = int(np.prod(dims))
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            vals = np.random.default_rng(0).standard_normal(len(offs))
            A = formats.StencilDia(
                vals=torch.as_tensor(vals, dtype=dt, device="cuda"),
                offs=tuple(offs), dims=dims, nrows=n,
                nrows_pad=-(-n // 8) * 8,
            )
            x = _rand_x(n, A.nrows_pad, dt, 3)
            _check_kernel(A, x, stencil_cuda.stencil_matvec,
                          stencil_cuda._stencil_matvec_plain, tol,
                          f"K1 {dims} {dt}")
    for offsets, n, sym in [
        ((-200, -128, -3, 0, 3, 128, 200), tile - 77, False),
        ((-128, -1, 0, 1, 128), tile, False),
        ((-300, 0, 300), 2 * tile - 5, False),
        ((0, 1, 127, 128, 500), tile - 13, True),
        ((0, 128, tile + 37), 3 * tile - 9, True),
    ]:
        n_pad = -(-n // tile) * tile
        rng = np.random.default_rng(0)
        data = np.zeros((len(offsets), n_pad), dtype=np.float32)
        for d, off in enumerate(offsets):
            lo, hi = max(0, -off), min(n, n - off)
            data[d, lo:hi] = rng.standard_normal(hi - lo)
        A = formats.DiaMatrix(
            data=torch.from_numpy(data).cuda(), offsets=offsets, nrows=n,
            nrows_pad=n_pad, sym_half=sym,
        )
        x = _rand_x(n, n_pad, torch.float32, 1)
        _check_kernel(A, x, dia_cuda.dia_matvec, dia_cuda._dia_matvec_plain,
                      F32_TOL, f"K{3 if sym else 2} {offsets}")
    print("[build] small-shape kernel checks passed", flush=True)


def phase_main_path():
    import torch

    from ngsamg_tpu_torch import AMGOptions, AMGPreconditioner
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType
    from ngsamg_tpu_torch.utils import fem

    _reset_counts()
    t0 = time.perf_counter()
    p = fem.poisson_3d(216)
    t1 = time.perf_counter()
    opts = AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    pc = AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cuda"
    ).setup()
    t2 = time.perf_counter()
    x, info = pc.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _counts()

    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and tuple(x.shape) == (p.n,) and x.dtype == torch.float64):
        raise AssertionError(f"solution: {type(x)} {getattr(x, 'shape', '')}")
    xh = x.cpu().numpy()
    if not np.isfinite(xh).all():
        raise AssertionError("solution is not finite")
    relres = float(np.linalg.norm(p.b - p.A @ xh) / np.linalg.norm(p.b))
    sizes = [int(v) for v in pc.log_.nvs]
    out = {
        "dofs": int(p.n),
        "assembly_s": t1 - t0,
        "setup_s": t2 - t1,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
        "solve_s": t3 - t2,
        "iterations": int(info.iterations),
        "outer_iterations": int(info.outer_iterations),
        "relres_true": relres,
        "relres_device": float(info.relres),
        "num_levels": pc.num_levels,
        "operator_complexity": pc.operator_complexity,
        "level_sizes": sizes,
        "launches": launches,
    }
    print("[main] " + json.dumps(out), flush=True)
    if pc.num_levels != 6:
        raise AssertionError(f"num_levels {pc.num_levels} != 6")
    if round(pc.operator_complexity, 3) != 1.762:
        raise AssertionError(f"operator complexity {pc.operator_complexity}")
    if sizes != HEADLINE_LEVELS:
        raise AssertionError(f"level sizes {sizes}")
    if int(info.iterations) > 15:
        raise AssertionError(f"{info.iterations} iterations > 15")
    if not info.converged or relres > 1e-8:
        raise AssertionError(
            f"not converged: device relres {info.relres}, true {relres}"
        )
    on_path = _path_kernels(pc)
    if on_path != set(KERNELS):
        raise AssertionError(f"headline hierarchy runs {sorted(on_path)}")
    for k in sorted(on_path):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return p, pc, out


def _path_kernels(pc) -> set:
    """The kernels the staged hierarchy's matvecs dispatch to."""
    from ngsamg_tpu_torch.sparse import formats

    names = set()
    for lev in pc.op.levels:
        if isinstance(lev.A, formats.StencilDia):
            names.add("stencil_matvec_f32")
        elif isinstance(lev.A, formats.DiaMatrix):
            names.add("dia_sym_matvec_f32" if lev.A.sym_half
                      else "dia_matvec_f32")
    if pc._A64_dev is not None:
        names.add("stencil_matvec_f64")
    return names


def phase_kernels(p, pc, launches):
    """Each kernel vs its plain version on the staged main-path levels."""
    import torch

    from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda
    from ngsamg_tpu_torch.sparse import formats

    cases = []  # (kernel name, level, A, dtype)
    for lvl, lev in enumerate(pc.op.levels):
        A = lev.A
        if isinstance(A, formats.StencilDia):
            cases.append(("stencil_matvec_f32", lvl, A, torch.float32))
            cases.append(("stencil_matvec_f64", lvl, pc._A64_dev,
                          torch.float64))
        elif isinstance(A, formats.DiaMatrix):
            name = "dia_sym_matvec_f32" if A.sym_half else "dia_matvec_f32"
            cases.append((name, lvl, A, torch.float32))
    per_kernel = {}
    for name, lvl, A, dt in cases:
        if name.startswith("stencil"):
            kern, plain = stencil_cuda.stencil_matvec, \
                stencil_cuda._stencil_matvec_plain
        else:
            kern, plain = dia_cuda.dia_matvec, dia_cuda._dia_matvec_plain
        tol = F32_TOL if dt == torch.float32 else F64_TOL
        x = _rand_x(A.nrows, A.nrows_pad, dt, 100 + lvl)
        err, rel = _check_kernel(A, x, kern, plain, tol, f"{name} level {lvl}")
        ms = _time_ms(lambda: kern(A, x))
        plain_ms = _time_ms(lambda: plain(A, x))
        ndiag = len(getattr(A, "offsets", ()) or getattr(A, "offs", ()))
        print(f"[kernels] {name} level {lvl}: rows {A.nrows} terms {ndiag} "
              f"sym_half {getattr(A, 'sym_half', False)} max|err| {err:.3e} "
              f"rel {rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms",
              flush=True)
        best = per_kernel.get(name)
        entry = {"level": lvl, "rows": A.nrows, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms}
        if best is None:
            per_kernel[name] = {"levels": [entry]}
        else:
            best["levels"].append(entry)
    rows = []
    for name, (src, replaces) in KERNELS.items():
        levels = per_kernel[name]["levels"]
        big = max(levels, key=lambda e: e["rows"])
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": max(e["max_abs_err"] for e in levels),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
        })
    return rows


def phase_reference(p, pc):
    """Warm second solve; a small solve on the card vs the CPU."""
    import torch

    from ngsamg_tpu_torch import AMGOptions, AMGPreconditioner
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType
    from ngsamg_tpu_torch.utils import fem

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = pc.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"[reference] warm solve {warm:.4f} s, {info.iterations} "
          f"iterations, relres {info.relres:.3e}", flush=True)

    q = fem.poisson_3d(40)
    opts = AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    sols = {}
    for dev in ("cuda", "cpu"):
        pcs = AMGPreconditioner(q.A, coords=q.coords, options=opts,
                                device=dev).setup()
        xs, inf = pcs.solve(q.b, tol=1e-8)
        sols[dev] = (xs, inf)
    (xg, ig), (xc, ic) = sols["cuda"], sols["cpu"]
    diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    print(f"[reference] poisson_3d(40): card {ig.iterations} it relres "
          f"{ig.relres:.3e}; cpu {ic.iterations} it relres {ic.relres:.3e}; "
          f"|x_card - x_cpu|/|x_cpu| {diff:.3e}", flush=True)
    if abs(ig.iterations - ic.iterations) > 1 or not ig.converged:
        raise AssertionError("small solve on the card disagrees with the CPU")
    if diff > 1e-6:
        raise AssertionError(f"small solve differs from the CPU by {diff}")
    return warm


def _cheb_opts():
    from ngsamg_tpu_torch import AMGOptions
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType

    return AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))


def phase_unstructured():
    """The unstructured path at 1,411,632 DoF on the card."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.utils import fem

    _reset_counts()
    t0 = time.perf_counter()
    p = fem.unstructured_poisson(55, dim=3, refine=1)
    t1 = time.perf_counter()
    pc = AMGPreconditioner(
        p.A, coords=p.coords, options=_cheb_opts(), device="cuda"
    ).setup()
    t2 = time.perf_counter()
    x, info = pc.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _counts()
    x = np.asarray(x)  # a host array: the finest level has no f64 stencil
    if x.shape != (p.n,) or not np.isfinite(x).all():
        raise AssertionError(f"solution: shape {x.shape}, not all finite")
    relres = float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))
    t4 = time.perf_counter()
    _x2, info2 = pc.solve(p.b, tol=1e-8)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t4
    cc = pc.op.cluster_corr
    level_fmts = [type(lev.A).__name__ for lev in pc.op.levels]
    transfer_fmts = [
        [type(lev.P).__name__, type(lev.R).__name__]
        for lev in pc.op.levels[:-1]
    ]
    out = {
        "dofs": int(p.n),
        "assembly_s": t1 - t0,
        "setup_s": t2 - t1,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
        "solve_s": t3 - t2,
        "warm_solve_s": warm,
        "iterations": int(info.iterations),
        "outer_iterations": int(info.outer_iterations),
        "warm_iterations": int(info2.iterations),
        "relres_true": relres,
        "relres_solver": float(info.relres),
        "num_levels": pc.num_levels,
        "operator_complexity": pc.operator_complexity,
        "level_sizes": [int(v) for v in pc.log_.nvs],
        "level_formats": level_fmts,
        "transfer_formats": transfer_fmts,
        "clusters": None if cc is None else list(cc.idx.shape),
        "launches": launches,
    }
    print("[unstructured] " + json.dumps(out), flush=True)
    if int(p.n) != UNSTRUCT_DOFS:
        raise AssertionError(f"{p.n} DoF != {UNSTRUCT_DOFS}")
    if pc.num_levels != UNSTRUCT_LEVELS:
        raise AssertionError(f"num_levels {pc.num_levels} != {UNSTRUCT_LEVELS}")
    if round(pc.operator_complexity, 2) != UNSTRUCT_OC:
        raise AssertionError(f"operator complexity {pc.operator_complexity}")
    if int(info.iterations) > UNSTRUCT_MAX_IT:
        raise AssertionError(f"{info.iterations} iterations > {UNSTRUCT_MAX_IT}")
    if not info.converged or relres > 1e-8:
        raise AssertionError(
            f"not converged: solver relres {info.relres}, true {relres}"
        )
    bad = {f for f in level_fmts + sum(transfer_fmts, [])
           if f not in UNSTRUCT_FORMATS}
    if bad:
        raise AssertionError(f"formats outside {UNSTRUCT_FORMATS}: {bad}")
    if cc is None:
        raise AssertionError("no cluster correction staged")
    for k in sorted(_path_kernels(pc)):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on this path")
    return p, pc, out


def phase_tile_ell(pc):
    """Plain torch tile-ELL matvec per tile-ELL level and transfer."""
    import torch

    from ngsamg_tpu_torch.sparse import formats

    rows = []
    for lvl, lev in enumerate(pc.op.levels):
        for what, T in (("A", lev.A), ("P", lev.P), ("R", lev.R)):
            if not isinstance(T, (formats.TileELL, formats.TileELLStack)):
                continue
            blocks = T.blocks if isinstance(T, formats.TileELLStack) else (T,)
            slots = sum(int(b.cols.numel()) for b in blocks)
            nbytes = sum(b.data.numel() * b.data.element_size()
                         + b.cols.numel() * b.cols.element_size()
                         for b in blocks)
            x = _rand_x(T.ncols_pad, T.ncols_pad, torch.float32, 200 + lvl)
            ms = _time_ms(lambda: formats.matvec(T, x))
            row = {"level": lvl, "op": what, "format": type(T).__name__,
                   "rows": T.nrows, "cols_pad": T.ncols_pad,
                   "buckets": len(blocks), "slots": slots,
                   "chunk": blocks[0].chunk_c, "bytes": nbytes, "ms": ms}
            print("[tile_ell] " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


def phase_unstructured_reference():
    """unstructured_poisson(20, dim=3) on the card against the CPU, and
    each DIA level's kernel against its plain version at that shape.
    Returns the kernels' max|err| by name."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.ops import dia_cuda
    from ngsamg_tpu_torch.sparse import formats
    from ngsamg_tpu_torch.utils import fem

    q = fem.unstructured_poisson(20, dim=3)
    sols = {}
    for dev in ("cuda", "cpu"):
        _reset_counts()
        pcs = AMGPreconditioner(q.A, coords=q.coords, options=_cheb_opts(),
                                device=dev).setup()
        xs, inf = pcs.solve(q.b, tol=1e-8)
        sols[dev] = (pcs, xs, inf, _counts())
    (pg, xg, ig, lg), (_pcc, xc, ic, _lc) = sols["cuda"], sols["cpu"]
    diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    relg = float(np.linalg.norm(q.b - q.A @ xg) / np.linalg.norm(q.b))
    fmts = [type(lev.A).__name__ for lev in pg.op.levels]
    print(f"[unstructured-reference] unstructured_poisson(20, 3): "
          f"{q.n} DoF, formats {fmts}, clusters "
          f"{None if pg.op.cluster_corr is None else list(pg.op.cluster_corr.idx.shape)}; "
          f"card {ig.iterations} it relres {relg:.3e}; cpu {ic.iterations} "
          f"it relres {ic.relres:.3e}; |x_card - x_cpu|/|x_cpu| {diff:.3e}; "
          f"card launches {lg}", flush=True)
    if not isinstance(pg.op.levels[0].A, formats.DiaMatrix):
        raise AssertionError(f"finest level {fmts[0]}, expected DiaMatrix")
    errs = {}
    for lvl, lev in enumerate(pg.op.levels):
        A = lev.A
        if not isinstance(A, formats.DiaMatrix):
            continue
        name = "dia_sym_matvec_f32" if A.sym_half else "dia_matvec_f32"
        x = _rand_x(A.nrows, A.nrows_pad, torch.float32, 300 + lvl)
        err, rel = _check_kernel(A, x, dia_cuda.dia_matvec,
                                 dia_cuda._dia_matvec_plain, F32_TOL,
                                 f"{name} unstructured level {lvl}")
        print(f"[unstructured-reference] {name} level {lvl}: rows {A.nrows} "
              f"diagonals {len(A.offsets)} max|err| {err:.3e} rel {rel:.3e}",
              flush=True)
        errs[name] = max(errs.get(name, 0.0), err)
    if abs(ig.iterations - ic.iterations) > 1 or not ig.converged \
            or relg > 1e-8:
        raise AssertionError("unstructured solve on the card disagrees")
    if diff > 1e-6:
        raise AssertionError(f"unstructured solve differs from the CPU by {diff}")
    if lg["dia_matvec_f32"] <= 0:
        raise AssertionError("K2 never launched on the small unstructured solve")
    return errs


def main() -> int:
    import torch

    import ngsamg_tpu_torch  # noqa: F401  (fails outside the repository)

    phase_device()
    phase_build()
    p, pc, main_out = phase_main_path()
    rows = phase_kernels(p, pc, main_out["launches"])
    phase_reference(p, pc)
    del p, pc
    _up, upc, _uout = phase_unstructured()
    phase_tile_ell(upc)
    del _up, upc
    unstruct_errs = phase_unstructured_reference()
    for row in rows:  # fold in the checks at the small unstructured shapes
        err = unstruct_errs.get(row["name"])
        if err is not None:
            row["max_abs_err"] = max(row["max_abs_err"], err)
    print(_nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
