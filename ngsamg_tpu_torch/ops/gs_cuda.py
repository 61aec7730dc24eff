"""The multicolour Gauss-Seidel sweep: CUDA kernel wrapper and launch plan.

It replaces no TPU kernel: the JAX package runs the sweep in XLA, and the
port's plain version (``smoothers/core.py::_gs``) is about six launches a
colour step. The kernel is ``csrc/gs_sweep.cu``; it reads the level's
colour-sorted block-ELL operator ``A`` (``data`` (n, K, bs, bs), ``cols``
(n, K) int32, ``nslots`` (n,) int32 or None) and the smoother's ``Dinv``
(n, bs, bs) and ``bounds_dev`` (the colour bounds, int32 on the device),
and makes no copy of the matrix.

:func:`gs_plan` picks one of two launch shapes from the level's shape (rows,
colour sizes, stored slots a row K, bs and the element size):

- ``colour``: one launch a colour step across the card (``lanes`` threads
  or ``warps`` warps a row), for a level whose x does not fit in a block's
  shared memory or that has only a few colours;
- ``sweep``: one launch for the whole sweep, on a cluster of ``cluster``
  CTAs of ``threads`` threads, each CTA holding the whole x in its shared
  memory; a colour's rows are dealt to groups of ``lanes * warps`` threads,
  enough threads a row that each holds a row's slots in its registers
  (``SWEEP_SLOTS``), and more where the largest colour leaves room
  (poisson3d_101_gs's level 3, 24 rows at most: 256 threads a row, a
  sweep in 296 us against 346 on 64 threads and 551 on 32).

:func:`stage` makes the plan when a :class:`GSSmoother` is built;
:func:`gs_sweep` launches it for CUDA tensors (f32, f64 or bf16) and raises
if it cannot, its checks before the library is loaded. A shape the kernel
does not take (a bs outside 1, 2, 3, 6, another operator format) gets no
plan and stays on the plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import bell_cuda, cuda_lib

# kernel launches per route and dtype suffix (a plain count)
LAUNCHES = {f"gs_{route}_{sfx}": 0 for route in ("colour", "sweep")
            for sfx in cuda_lib.DTYPE_SUFFIXES}

STAGED_WIDTHS = (1, 2, 3, 6)  # bs the kernel is built for
COLOUR_THREADS = 256  # a colour launch's block (kColourThreads)
# a sweep launch's largest block and the slots a thread holds ahead in
# registers, by bs (Sweep<BS>::threads, Sweep<BS>::slots)
SWEEP_THREADS = {1: 512, 2: 512, 3: 512, 6: 256}
SWEEP_SLOTS = {1: 16, 2: 4, 3: 2, 6: 1}
SMEM_MAX = 232_448  # dynamic shared memory a block may use (kSmemMax)
MAX_CLUSTER = 16  # CTAs of a cluster (kMaxCluster; above 8 non-portable)
# a level with fewer non-empty colours takes one launch a colour step even
# where x fits: on an H100, fitting levels of 2 and 4 colours (3,376-50,656
# rows) ran a sweep 1.2-5.3x faster on colour launches after an L2 sweep
# (12.8-24.4 us against 24.7-84.3), 8 colours was the crossover (colour 38.2,
# 40.4, 48.7 us; sweep 30.5, 39.8, 105.5), 15-16 colours ran faster on the
# sweep launch (29-66 us against 63-74), 50 or more 2.4x faster
MIN_SWEEP_COLOURS = 5
# stored slots a CTA of the sweep's cluster: a level with fewer slots in
# all takes fewer CTAs, down to one (16 CTAs ran poisson3d_101_gs's levels
# 2 and 3, 2.8M and 1.7M stored slots, faster than 8 or 4; smaller levels
# are not measured)
SLOTS_PER_CTA = 65_536
# a colour launch's row takes a lane for each COLOUR_SLOTS_PER_LANE stored
# slots (a power of two, at least 1): poisson3d_101_gs's level 0 (K = 7)
# ran a sweep in 38 us on 1 lane a row against 61 on bell_cuda's 4, level
# 1 (K = 33) in 77 us on 8 (73 on 16, 100 on 4)
COLOUR_SLOTS_PER_LANE = 4


@dataclass(frozen=True)
class GSPlan:
    """One level's launches. ``route``: "colour" (``colour_steps`` launches
    a call, of ``threads`` threads with ``lanes`` lanes and ``warps`` warps
    a row over the ``max_rows`` rows of the largest colour) or "sweep" (one
    launch of ``cluster`` CTAs of ``threads`` threads, ``lanes * warps``
    threads a row). ``colour_steps``: the non-empty colours times the
    smoother's steps, the colour steps of one call."""

    route: str
    threads: int
    lanes: int
    warps: int
    cluster: int
    max_rows: int
    colour_steps: int

    @property
    def variant(self) -> str:
        if self.route == "colour":
            return f"colour-l{self.lanes}-w{self.warps}"
        return (f"sweep-c{self.cluster}-t{self.threads}"
                f"-g{self.lanes * self.warps}")


def sweep_smem_bytes(n_rows: int, bs: int, itemsize: int, threads: int,
                     ncolours: int) -> int:
    """A sweep launch's shared memory (sweep_smem in the kernel): x padded
    to 16 bytes, a partial sum a warp and component, the colour bounds."""
    acc = 4 if itemsize == 2 else itemsize  # bf16 sums in f32
    return (-(-n_rows * bs * itemsize // 16) * 16
            + (threads // 32) * bs * acc + 4 * (ncolours + 1))


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def _pow2_floor(v: int) -> int:
    return 1 << max(0, int(v).bit_length() - 1)


def gs_plan(n_rows: int, bs: int, itemsize: int, bounds, K: int,
            steps: int = 1, *, route: str | None = None,
            cluster: int | None = None, threads: int | None = None,
            tpr: int | None = None, lanes: int | None = None,
            warps: int | None = None) -> GSPlan | None:
    """The plan from the shape alone, None for a bs the kernel is not built
    for or a level with no rows to smooth. The sweep launch where x fits
    in a block's shared memory and the level has at least
    MIN_SWEEP_COLOURS non-empty colours, else the colour launch. A sweep
    takes a CTA for each SLOTS_PER_CTA stored slots of the level, at most
    MAX_CLUSTER, of SWEEP_THREADS threads; a row takes enough threads (a
    power of two, at least bs) to hold its K slots ahead, SWEEP_SLOTS each,
    and more while every row of the largest colour still has a group of
    its own. ``route``, ``cluster``, ``threads`` and ``tpr`` (sweep)
    or ``lanes`` and ``warps`` (colour) force a plan, to time others;
    raises for one the kernels do not take."""
    if bs not in STAGED_WIDTHS or K < 1:
        return None
    sizes = [int(hi) - int(lo) for lo, hi in zip(bounds[:-1], bounds[1:])]
    live = sum(1 for m in sizes if m > 0)
    if live == 0:
        return None
    max_rows = max(sizes)
    most = SWEEP_THREADS[bs]
    fits = sweep_smem_bytes(n_rows, bs, itemsize, most,
                            len(sizes)) <= SMEM_MAX
    if route is None:
        route = "sweep" if fits and live >= MIN_SWEEP_COLOURS else "colour"
    if route == "colour":
        if lanes is None:
            lanes = min(bell_cuda.WARP,
                        _pow2_floor(K // COLOUR_SLOTS_PER_LANE))
            while (lanes < bell_cuda.WARP and lanes < K
                   and max_rows * lanes < bell_cuda.TARGET_THREADS):
                lanes *= 2
        p = bell_cuda.bell_plan(K, bs, bs, max(max_rows, 1), lanes=lanes,
                                warps=warps)
        return GSPlan("colour", COLOUR_THREADS, p.lanes, p.warps, 1,
                      max_rows, live * steps)
    if route != "sweep" or not fits:
        raise ValueError(f"gs_sweep: route {route!r} for {n_rows} rows of "
                         f"bs {bs}, {itemsize}-byte values")
    if cluster is None:
        cluster = min(MAX_CLUSTER,
                      _pow2_ceil(-(-n_rows * K // SLOTS_PER_CTA)))
    if threads is None:
        threads = most
    if tpr is None:
        held = max(_pow2_ceil(bs), _pow2_ceil(-(-K // SWEEP_SLOTS[bs])))
        tpr = min(threads, held)
        while tpr < threads and cluster * (threads // (2 * tpr)) >= max_rows:
            tpr *= 2
    if not (1 <= cluster <= MAX_CLUSTER and tpr & (tpr - 1) == 0
            and bs <= tpr <= threads <= most and threads % 32 == 0
            and threads % tpr == 0):
        raise ValueError(f"gs_sweep: {cluster} CTAs of {threads} threads, "
                         f"{tpr} a row: at most {MAX_CLUSTER} CTAs of "
                         f"{most}, and a power of two from {bs} threads "
                         f"a row that divides a CTA's")
    ln = min(tpr, 32)
    return GSPlan("sweep", threads, ln, tpr // ln, cluster, max_rows,
                  live * steps)


def takes(A, n_rows: int, bs: int) -> bool:
    """Whether the kernel reads ``A`` (a block-ELL operator with col_chunk
    1, square bs blocks the kernel is built for and ``n_rows`` rows)."""
    data = getattr(A, "data", None)
    return (bs in STAGED_WIDTHS and getattr(A, "col_chunk", None) == 1
            and isinstance(data, torch.Tensor) and data.dim() == 4
            and data.shape[0] == n_rows and tuple(data.shape[2:]) == (bs, bs))


def stage(sm) -> GSPlan | None:
    """The plan of a staged GS smoother (None where the kernel does not
    take its level: no device bounds or no operator width staged)."""
    if sm.bounds_dev is None or not sm.ell_width:
        return None
    D = sm.Dinv
    return gs_plan(D.shape[0], D.shape[1], D.element_size(),
                   sm.color_bounds, sm.ell_width, sm.steps)


def gs_sweep(sm, A, x: torch.Tensor | None, b: torch.Tensor, *,
             reverse: bool, plan: GSPlan | None = None) -> torch.Tensor:
    """``sm.steps`` forward (or, with ``reverse``, backward) sweeps of the
    level: a new tensor, ``x`` (None: zero) is not written. ``plan``
    replaces the smoother's own (to time another)."""
    plan = sm.launch if plan is None else plan
    if plan is None:
        raise ValueError("gs_sweep: the smoother has no launch plan (stage "
                         "it with its operator: stage_smoother(..., A=))")
    data, cols, ns, D, bd = A.data, A.cols, A.nslots, sm.Dinv, sm.bounds_dev
    if data.dim() != 4 or data.shape[2] != data.shape[3]:
        raise ValueError(f"gs_sweep: data must be (n, K, bs, bs), got "
                         f"{tuple(data.shape)}")
    n, K, bs, _ = data.shape
    sfx = cuda_lib.suffix(data.dtype)  # raises for a dtype without a kernel
    if K != sm.ell_width or bs not in STAGED_WIDTHS:
        raise ValueError(f"gs_sweep: operator ({n}, {K}, {bs}, {bs}) is not "
                         f"the plan's (width {sm.ell_width})")
    if not data.is_contiguous():
        raise ValueError("gs_sweep: data must be contiguous")
    if (cols.dtype != torch.int32 or tuple(cols.shape) != (n, K)
            or not cols.is_contiguous()):
        raise ValueError(f"gs_sweep: cols must be contiguous int32 "
                         f"({n}, {K}), got {cols.dtype} {tuple(cols.shape)}")
    if ns is not None and (ns.dtype != torch.int32 or tuple(ns.shape) != (n,)
                           or not ns.is_contiguous()):
        raise ValueError(f"gs_sweep: nslots must be contiguous int32 "
                         f"({n},), got {ns.dtype} {tuple(ns.shape)}")
    ncol = len(sm.color_bounds) - 1
    if (bd is None or bd.dtype != torch.int32 or tuple(bd.shape) != (ncol + 1,)
            or not bd.is_contiguous()):
        raise ValueError(f"gs_sweep: bounds_dev must be contiguous int32 "
                         f"({ncol + 1},)")
    vecs = {"Dinv": (D, (n, bs, bs)), "b": (b, (n, bs))}
    if x is not None:
        vecs["x"] = (x, (n, bs))
    for name, (v, shape) in vecs.items():
        if (v.dtype != data.dtype or tuple(v.shape) != shape
                or not v.is_contiguous()):
            raise ValueError(f"gs_sweep: {name} must be contiguous "
                             f"{data.dtype} {shape}, got {v.dtype} "
                             f"{tuple(v.shape)}")
    devices = {t.device for t in (data, cols, D, bd, b)
               + tuple(t for t in (ns, x) if t is not None)}
    if len(devices) != 1 or b.device.type != "cuda":
        raise ValueError(f"gs_sweep: tensors on {sorted(map(str, devices))}"
                         f", the kernel takes one CUDA device")
    if data.data_ptr() % bell_cuda._load_bytes(bs * bs,
                                               data.element_size()):
        raise ValueError("gs_sweep: data misaligned for the kernel's vector "
                         "loads")
    y = torch.empty_like(b)
    name = f"ngsamg_gs_sweep_{sfx}"
    fn = getattr(cuda_lib.library(), name)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    sweep = plan.route == "sweep"
    rc = fn(data.data_ptr(), cols.data_ptr(),
            None if ns is None else ns.data_ptr(), D.data_ptr(),
            b.data_ptr(), bd.data_ptr(), ncol, K, bs, n, plan.max_rows,
            sm.steps, int(reverse), int(x is None), int(sweep), plan.cluster,
            plan.threads, plan.lanes, plan.warps,
            None if x is None else x.data_ptr(), y.data_ptr(), stream)
    cuda_lib.check(rc, name)
    LAUNCHES[f"gs_{plan.route}_{sfx}"] += 1 if sweep else ncol * sm.steps
    return y
