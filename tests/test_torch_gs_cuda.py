"""The multicolour Gauss-Seidel sweep kernel (ops/gs_cuda.py,
csrc/gs_sweep.cu) off the card.

The kernel runs only on the card (chip_smoke.py ``[gs-kernel]`` and
``[gs-reference]``); here:
- the plan follows the level's shape: the levels of ``poisson3d_101_gs``
  (levels 0-1 one launch a colour step, levels 2-3 one sweep launch),
  float64's doubled x, bs 3 and 6, shapes the kernel does not take;
- a numpy walk of both launch shapes, thread by thread as the kernel deals
  rows and slots: each real (row, slot) of a colour's rows is read exactly
  once a colour step and no padding slot at all, each row is written once,
  the colours run in the plan's order, and the result equals
  ``benchmark/reference/gs_sweep.py::dense_sweep`` at rtol 1e-12 in float64
  (bs 1), the block form of the same definition (bs 3 and 6) and the
  port's plain sweep, forward and backward, one and two steps, from zero
  and from a nonzero x;
- staging gives GS levels of a block-ELL hierarchy their plan, which a
  cast to bfloat16 makes anew and a pickle keeps, and so do a Hiptmair
  pair of GS smoothers and the JAX package's hierarchy converted by
  ``from_jax_operator``;
- the wrapper refuses bad inputs before it loads the library, the module
  imports without ``nvcc``, and the plain path counts no kernel steps.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import ngsamg_tpu_torch
import ngsamg_tpu_torch.smoothers.build as tbuild
import ngsamg_tpu_torch.smoothers.core as tcore
import ngsamg_tpu_torch.sparse.bell as tbell
from benchmark.reference import gs_sweep
from ngsamg_tpu_torch.config import options_from_flags
from ngsamg_tpu_torch.ops import gs_cuda
from ngsamg_tpu_torch.utils import fem as tfem
from ngsamg_tpu_torch.utils import timers

torch.set_num_threads(2)


def _bounds(sizes):
    return tuple(int(v) for v in np.concatenate([[0], np.cumsum(sizes)]))


def _sizes(n, ncol, lo, hi, big):
    """``ncol`` colour sizes over ``n`` rows: one of ``lo``, ``big`` of
    ``hi``, the rest spread between them."""
    rest = n - lo - big * hi
    mid = ncol - 1 - big
    sizes = [lo] + [hi] * big + [rest // mid + (i < rest % mid)
                                 for i in range(mid)]
    assert sum(sizes) == n and max(sizes) == hi and min(sizes) == lo
    return sizes


# poisson3d_101_gs's levels (rows, colours and their sizes min / max, the
# stored slots a row): rows padded to 8
LEVELS = {
    0: (1_000_000, _bounds([500_000, 500_000]), 7),
    1: (125_000, _bounds(_sizes(125_000, 16, 67, 10_734, 2)), 33),
    2: (15_632, _bounds(_sizes(15_625, 56, 2, 527, 3)), 179),
    3: (2_200, _bounds(_sizes(2_197, 199, 1, 24, 2)), 787),
}


def test_plan_of_the_gs_cell_levels():
    """Levels 0-1 (x of 4 MB and 500 KB) one launch a colour step, a lane
    for each four stored slots of a row (K = 7: one, K = 33: eight), levels
    2-3 (62.5 KB and 8.8 KB) one launch a sweep on a full cluster of 512
    threads a CTA: at K = 179 the 16 threads a row that hold its slots in
    registers (the largest colour's 527 rows then take two rounds), at
    24 rows the most threads a row that leave each a group (256)."""
    want = {0: ("colour", 1, 256, 1, 1), 1: ("colour", 1, 256, 8, 1),
            2: ("sweep", 16, 512, 16, 1), 3: ("sweep", 16, 512, 32, 8)}
    for lvl, (n, bounds, K) in LEVELS.items():
        p = gs_cuda.gs_plan(n, 1, 4, bounds, K, steps=1)
        assert (p.route, p.cluster, p.threads, p.lanes, p.warps) \
            == want[lvl], lvl
        live = sum(1 for a, c in zip(bounds[:-1], bounds[1:]) if c > a)
        assert p.colour_steps == live
        assert p.max_rows == max(np.diff(bounds))
        if p.route == "sweep":
            tpr = p.lanes * p.warps
            assert tpr * gs_cuda.SWEEP_SLOTS[1] >= K
    # the plan's steps count the colour steps of a call
    n, bounds, K = LEVELS[3]
    assert gs_cuda.gs_plan(n, 1, 4, bounds, K, steps=2).colour_steps == 398


def test_plan_follows_dtype_and_block_size():
    """f64's doubled x still fits on levels 2-3 and not on 1; the budget's
    edge at 50,000 scalar rows; bs 3 and 6 take smaller blocks; the kernel
    takes no other bs, and a level of a handful of colours or a handful of
    slots takes the colour launch or a smaller cluster."""
    for lvl, route in ((1, "colour"), (2, "sweep"), (3, "sweep")):
        n, bounds, K = LEVELS[lvl]
        assert gs_cuda.gs_plan(n, 1, 8, bounds, K).route == route
    b = _bounds([10_000] * 5)
    assert gs_cuda.gs_plan(50_000, 1, 4, b, 7).route == "sweep"
    assert gs_cuda.gs_plan(50_000, 1, 8, b, 7).route == "colour"
    assert gs_cuda.gs_plan(50_000, 1, 2, b, 7).route == "sweep"  # bf16
    assert gs_cuda.sweep_smem_bytes(50_000, 1, 4, 1024, 5) == \
        200_000 + 32 * 4 + 24
    b3 = _bounds([800] * 5)
    p3 = gs_cuda.gs_plan(4_000, 3, 4, b3, 27)
    assert (p3.route, p3.threads) == ("sweep", 512)
    assert p3.lanes * p3.warps >= 3
    p6 = gs_cuda.gs_plan(4_000, 6, 8, b3, 27)  # 192 KB of x
    assert (p6.route, p6.threads) == ("sweep", 256)
    assert p6.lanes * p6.warps >= 27  # one slot a thread held ahead
    assert gs_cuda.gs_plan(5_000, 6, 8, _bounds([1_000] * 5), 27).route \
        == "colour"  # 240 KB
    assert gs_cuda.gs_plan(3_000, 4, 4, _bounds([600] * 5), 9) is None
    assert gs_cuda.gs_plan(100, 1, 4, (0, 0, 0), 9) is None
    assert gs_cuda.gs_plan(1_000, 1, 4, _bounds([250] * 4), 9).route \
        == "colour"  # four colours
    small = gs_cuda.gs_plan(200, 1, 4, _bounds([20] * 10), 9)
    assert (small.route, small.cluster) == ("sweep", 1)
    with pytest.raises(ValueError):
        gs_cuda.gs_plan(50_000, 1, 8, b, 7, route="sweep")  # does not fit
    for bad in ({"tpr": 3}, {"tpr": 1024}, {"cluster": 17}, {"tpr": 2},
                {"threads": 1024}, {"threads": 48, "tpr": 16},
                {"threads": 96, "tpr": 64}):
        with pytest.raises(ValueError):
            gs_cuda.gs_plan(4_000, 3, 4, b3, 27, route="sweep", **bad)


def _random_spd(n=120, seed=5):
    """test_torch_gs_reference.py's seeded sparse SPD matrix."""
    S = sp.random(n, n, density=0.05, random_state=seed, format="csr")
    S = S + S.T
    d = np.asarray(abs(S).sum(axis=1)).ravel() + 1.0
    return (S + sp.diags(d)).tocsr()


MATRICES = {
    "poisson_3d_9": lambda: sp.csr_matrix(tfem.poisson_3d(9).A),
    "random_spd": _random_spd,
}


def _blocked(A, bs, seed=2):
    """``A`` with every entry a_rs made the bs x bs block a_rs M, M a fixed
    random SPD block: SPD, with the scalar matrix's graph."""
    if bs == 1:
        return A
    rng = np.random.default_rng(seed + bs)
    G = rng.standard_normal((bs, bs))
    M = G @ G.T + bs * np.eye(bs)
    return sp.kron(A, M, format="bsr").tocsr()


def _level(name, bs):
    """The colour-sorted float64 level of MATRICES[name] in bs blocks, its
    block-ELL operator and its staged smoother (split storage) with a
    launch plan."""
    A = _blocked(MATRICES[name](), bs)
    opts = ngsamg_tpu_torch.SmootherOptions()
    perm, bounds = tbuild.plan_row_order(A, bs, opts, 0)
    sperm = (perm[:, None] * bs + np.arange(bs)).ravel()
    A = A[sperm][:, sperm].tocsr()
    At = tbell.from_scipy(A, bs, bs, dtype=np.float64)
    sm = tbuild.build_smoother(A, bs, opts, 0, At.nrows_pad, np.float64,
                               color_bounds=bounds,
                               ell=(At.data.numpy(), At.cols.numpy()))
    return A, At, sm


def _with_steps(sm, steps):
    return tbuild.stage_smoother(dataclasses.replace(sm, steps=steps), "cpu",
                                 A=None)


def _walk(sm, At, plan, x0, b, reverse):
    """``sm.steps`` sweeps as the kernel's threads compute them (float64),
    and the colours in the order the launches ran them. Checks at every
    colour step that each real slot of the colour's rows is read once and
    nothing else, and that each row of x is written once in a launch that
    writes it (the colour's rows; in a sweep's first colour launch, every
    row)."""
    data, cols = At.data.numpy(), At.cols.numpy()
    n, K, bs, _ = data.shape
    ns = At.nslots.numpy()
    D = sm.Dinv.numpy()
    bounds = [int(v) for v in sm.color_bounds]
    ncol = len(bounds) - 1
    tpr = plan.lanes * plan.warps
    x = np.zeros((n, bs)) if x0 is None else x0.copy()
    ran = []
    for s in range(sm.steps * ncol):
        q = s % ncol
        c = ncol - 1 - q if reverse else q
        ran.append(c)
        lo, hi = bounds[c], bounds[c + 1]
        first = s == 0
        skipped = first and x0 is None
        if plan.route == "colour":
            rpb = gs_cuda.COLOUR_THREADS // tpr
            grid = -(-(n if first else plan.max_rows) // rpb)
            t = np.arange(grid * gs_cuda.COLOUR_THREADS)
            idx = (t // gs_cuda.COLOUR_THREADS) * rpb \
                + (t % gs_cuda.COLOUR_THREADS) // tpr
            rank = t % tpr
            row = idx if first else lo + idx
            live = row < (n if first else hi)
            rounds = [(row, rank, live)]
        else:
            gpc = plan.threads // tpr
            G = plan.cluster * gpc
            t = np.arange(plan.cluster * plan.threads)
            g = (t // plan.threads) * gpc + (t % plan.threads) // tpr
            rank = (t % plan.threads) % tpr
            rounds = [(lo + g + j * G, rank, lo + g + j * G < hi)
                      for j in range(-(-(hi - lo) // G))]
        taken = np.zeros((n, K), dtype=np.int64)
        written = np.zeros(n, dtype=np.int64)
        sums = np.zeros((n, bs))
        for row, rank, live in rounds:
            mine = live & (row >= lo) & (row < hi)
            finisher = live & (rank == 0)
            np.add.at(written, row[finisher], 1)
            if skipped:
                continue
            r, k0 = row[mine], rank[mine]
            for q_ in range(-(-K // tpr)):
                k = k0 + q_ * tpr
                m = k < ns[r]
                rr, kk = r[m], k[m]
                np.add.at(taken, (rr, kk), 1)
                np.add.at(sums, rr, np.einsum("mij,mj->mi", data[rr, kk],
                                               x[cols[rr, kk]]))
        want = np.zeros_like(taken)
        if not skipped:
            want[lo:hi][np.arange(K)[None, :] < ns[lo:hi, None]] = 1
        np.testing.assert_array_equal(taken, want)
        written_want = np.zeros(n, dtype=np.int64)
        if plan.route == "colour" and first:
            written_want[:] = 1
        else:
            written_want[lo:hi] = 1
        np.testing.assert_array_equal(written, written_want)
        x[lo:hi] += np.einsum("mij,mj->mi", D[lo:hi], b[lo:hi] - sums[lo:hi])
    return x, ran


def _block_definition(A, bs, x, b, reverse, steps):
    """The block form of the definition: x <- x + (D + L)^{-1} (b - A x)
    with D + L the block lower triangle (block upper backwards)."""
    nb = A.shape[0] // bs
    blk = np.repeat(np.arange(nb), bs)
    C = A.tocoo()
    keep = (blk[C.row] <= blk[C.col]) if reverse else \
        (blk[C.row] >= blk[C.col])
    T = sp.csc_matrix((C.data[keep], (C.row[keep], C.col[keep])),
                      shape=A.shape)
    lu = spla.splu(T)
    x = np.zeros(A.shape[0]) if x is None else x.copy()
    for _ in range(steps):
        x = x + lu.solve(b - A @ x)
    return x


def _plans(sm, At):
    """The plans the walk takes: each route on its own rule, and forced
    ones (one lane a row; four warps a row; one CTA whose groups are fewer
    than the rows of a colour; two CTAs of few threads a row; four CTAs of
    one warp)."""
    n, K, bs, _ = At.data.shape
    args = (n, bs, 8, sm.color_bounds, K, sm.steps)
    plans = [gs_cuda.gs_plan(*args, route="colour"),
             gs_cuda.gs_plan(*args, route="colour", lanes=1),
             gs_cuda.gs_plan(*args, route="colour", lanes=32, warps=4),
             gs_cuda.gs_plan(*args, route="sweep"),
             gs_cuda.gs_plan(*args, route="sweep", cluster=1,
                             threads=gs_cuda.SWEEP_THREADS[bs],
                             tpr=gs_cuda.SWEEP_THREADS[bs] // 2),
             gs_cuda.gs_plan(*args, route="sweep", cluster=4, threads=32,
                             tpr=8),
             gs_cuda.gs_plan(*args, route="sweep", cluster=2,
                             tpr=max(8, bs))]
    return plans


@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("bs", [1, 3, 6])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernel_walk_is_the_definition(name, bs, steps, start):
    A, At, sm0 = _level(name, bs)
    sm = _with_steps(sm0, steps)
    n_pad = At.nrows_pad
    nb = A.shape[0] // bs
    rng = np.random.default_rng(17)
    b = np.zeros((n_pad, bs))
    b[:nb] = rng.standard_normal((nb, bs))
    x0 = None
    if start == "nonzero":
        x0 = np.zeros((n_pad, bs))
        x0[:nb] = rng.standard_normal((nb, bs))
    bt = torch.from_numpy(b)
    xt = None if x0 is None else torch.from_numpy(x0)
    ncol = len(sm.color_bounds) - 1
    for reverse in (False, True):
        if bs == 1:
            ref = gs_sweep.dense_sweep(A.toarray(), None if x0 is None
                                       else x0[:nb, 0], b[:nb, 0],
                                       reverse=reverse, steps=steps)
            ref = ref.numpy().reshape(nb, 1)
        else:
            ref = _block_definition(
                A, bs, None if x0 is None else x0[:nb].ravel(),
                b[:nb].ravel(), reverse, steps).reshape(nb, bs)
        run = tcore.smooth_back if reverse else tcore.smooth
        plain = run(sm, At, xt, bt).numpy()
        tol = dict(rtol=1e-12, atol=1e-12 * np.abs(ref).max())
        np.testing.assert_allclose(plain[:nb], ref, **tol)
        for plan in _plans(sm, At):
            got, ran = _walk(sm, At, plan, x0, b, reverse)
            order = list(range(ncol))[::-1] if reverse else list(range(ncol))
            assert ran == order * steps, plan
            np.testing.assert_allclose(got[:nb], ref, **tol)
            np.testing.assert_allclose(got, plain, rtol=1e-12,
                                       atol=1e-12 * np.abs(plain).max())
            # padded rows keep their start
            assert np.array_equal(got[nb:], np.zeros((n_pad - nb, bs)) if
                                  x0 is None else x0[nb:])


def test_staging_gives_gs_levels_their_plan():
    """A GS hierarchy staged on the CPU: every smoothed level is a
    block-ELL level with its device bounds and a plan from its shape; the
    bfloat16 cast makes the plan anew, a pickle keeps it, and a smoother
    staged without its operator has none."""
    from ngsamg_tpu_torch.precond.amg import _cast_floats

    p = tfem.poisson_3d(13)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy="h1", coords=p.coords,
        options=options_from_flags({"sm_type": "gs"}), device="cpu",
    ).setup()
    levels = pc.op.levels[:-1]
    assert levels
    for lev in levels:
        sm, A = lev.smoother, lev.A
        assert isinstance(sm, tcore.GSSmoother)
        assert isinstance(A, tbell.BlockELL)
        assert sm.ell_width == A.ell_width and sm.bounds_dev.dtype == \
            torch.int32
        assert tuple(sm.bounds_dev.tolist()) == tuple(sm.color_bounds)
        n, K, bs, _ = A.data.shape
        assert sm.launch == gs_cuda.gs_plan(n, bs, 4, sm.color_bounds, K,
                                            sm.steps)
        half = _cast_floats(sm, torch.bfloat16, {})
        assert half.Dinv.dtype == torch.bfloat16
        assert half.bounds_dev is sm.bounds_dev
        assert half.launch == gs_cuda.gs_plan(n, bs, 2, sm.color_bounds, K,
                                              sm.steps)
        again = pickle.loads(pickle.dumps(sm))
        assert again.launch == sm.launch
    host = tbuild.build_smoother(
        sp.eye(16, format="csr"), 1, ngsamg_tpu_torch.SmootherOptions(), 0,
        16, np.float32, color_bounds=(0, 16))
    assert tbuild.stage_smoother(host, "cpu").launch is None


def test_hiptmair_gs_smoothers_take_the_kernel():
    """A Hiptmair pair of GS smoothers staged with the level's operator:
    the range smoother is planned from that operator and the potential
    smoother from the staged ``A_pot``; the walk of each plan equals the
    plain sweep of the staged smoother."""
    from ngsamg_tpu_torch.smoothers.hiptmair import HiptmairSmoother
    from ngsamg_tpu_torch.sparse import formats

    _, At, rsm = _level("random_spd", 1)
    _, Pt, psm = _level("poisson_3d_9", 1)
    C = sp.random(At.nrows, Pt.nrows, density=0.02, random_state=3,
                  format="csr")
    hip = HiptmairSmoother(
        range_sm=rsm, pot_sm=psm, A_pot=Pt,
        C=formats.tile_ell_from_scipy(C, np.float64, nr_pad=At.nrows_pad,
                                      nc_pad=Pt.nrows_pad),
        CT=formats.tile_ell_from_scipy(C.T.tocsr(), np.float64,
                                       nr_pad=Pt.nrows_pad,
                                       nc_pad=At.nrows_pad),
    )
    st = tbuild.stage_smoother(hip, "cpu", A=At)
    rng = np.random.default_rng(4)
    for sm, T in ((st.range_sm, At), (st.pot_sm, st.A_pot)):
        n, K, bs, _ = T.data.shape
        assert sm.ell_width == K
        assert sm.launch == gs_cuda.gs_plan(n, bs, 8, sm.color_bounds, K,
                                            sm.steps)
        x0 = rng.standard_normal((n, bs))
        b = rng.standard_normal((n, bs))
        got, _ = _walk(sm, T, sm.launch, x0, b, reverse=True)
        want = tcore.gs_plain(sm, T, torch.from_numpy(x0),
                              torch.from_numpy(b), reverse=True).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert tbuild.stage_smoother(hip, "cpu").range_sm.launch is None


def test_converted_gs_levels_take_the_kernel():
    """The JAX package's GS hierarchy through ``from_jax_operator``: each
    smoothed level is staged with its operator and has the plan of its
    shape, as the port's own setup gives it."""
    jax = pytest.importorskip("jax")
    import ngsamg_tpu
    from ngsamg_tpu_torch.precond.convert import from_jax_operator

    p = tfem.poisson_3d(9)
    pj = ngsamg_tpu.AMGPreconditioner(
        p.A, coords=p.coords,
        options=ngsamg_tpu.config.options_from_flags({"sm_type": "gs"}),
    ).setup()
    with jax.enable_x64(pj._x64_cycle):
        op_np = jax.tree_util.tree_map(np.asarray, pj.op)
    op = from_jax_operator(op_np)
    levels = op.levels[:-1]
    assert levels
    for lev in levels:
        sm, A = lev.smoother, lev.A
        assert isinstance(sm, tcore.GSSmoother)
        n, K, bs, _ = A.data.shape
        assert sm.launch == gs_cuda.gs_plan(n, bs, A.data.element_size(),
                                            sm.color_bounds, K, sm.steps)


def test_plain_path_counts_no_kernel_steps():
    """A CPU solve runs the plain sweep: its colour steps are counted, the
    kernel's are 0, though its levels carry plans."""
    p = tfem.poisson_3d(9)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy="h1", coords=p.coords,
        options=options_from_flags({"sm_type": "gs"}), device="cpu",
    ).setup()
    assert pc.op.levels[0].smoother.launch is not None
    b = np.random.default_rng(1).standard_normal(p.n)
    _x, info = pc.solve(b, tol=1e-8)
    assert info.colour_steps > 0 and info.gs_kernel_steps == 0
    rec = timers.Recorder()
    with timers.solving(rec) as scope:
        timers.count_gs_kernel_steps(5)
    assert scope.gs_kernel_steps == 5 and rec.gs_kernel_steps == 5
    timers.count_gs_kernel_steps(3)  # no recorder current: nothing counted
    assert rec.gs_kernel_steps == 5


def test_wrapper_refuses_bad_inputs_without_a_card():
    """The checks come before the library is loaded: CPU tensors that fail
    one raise ValueError or TypeError, never a build error."""
    A, At, sm = _level("random_spd", 3)
    sm = tbuild.stage_smoother(sm, "cpu", A=At)
    n = At.nrows_pad
    b = torch.zeros((n, 3), dtype=torch.float64)
    f = gs_cuda.gs_sweep
    with pytest.raises(ValueError, match="no launch plan"):
        f(dataclasses.replace(sm, bounds_dev=None), At, None, b,
          reverse=False)
    with pytest.raises(TypeError):  # a dtype without a kernel
        f(sm, dataclasses.replace(At, data=At.data.half()), None, b.half(),
          reverse=False)
    with pytest.raises(ValueError, match="Dinv"):
        f(sm, dataclasses.replace(At, data=At.data.float()), None, b.float(),
          reverse=False)
    with pytest.raises(ValueError, match="b must be"):
        f(sm, At, None, b[:-1], reverse=False)
    with pytest.raises(ValueError, match="x must be"):
        f(sm, At, b.t().contiguous().t(), b, reverse=False)
    with pytest.raises(ValueError, match="cols"):
        f(sm, dataclasses.replace(At, cols=At.cols.long()), None, b,
          reverse=False)
    with pytest.raises(ValueError, match="nslots"):
        f(sm, dataclasses.replace(At, nslots=At.nslots.long()), None, b,
          reverse=False)
    with pytest.raises(ValueError, match="not the plan's"):
        f(sm, dataclasses.replace(At, data=At.data[:, :-1].contiguous(),
                                  cols=At.cols[:, :-1].contiguous()),
          None, b, reverse=False)
    with pytest.raises(ValueError, match="bounds_dev"):
        f(dataclasses.replace(sm, bounds_dev=sm.bounds_dev.long()), At, None,
          b, reverse=False)
    with pytest.raises(ValueError, match="one CUDA device"):
        f(sm, At, None, b, reverse=False)  # every check passes: CPU tensors


def test_gs_cuda_imports_without_nvcc(tmp_path):
    """The wrapper and the smoothers import, plan and sweep CPU tensors
    with no nvcc on PATH and no CUDA_HOME: nothing builds at import."""
    code = (
        "import numpy as np, scipy.sparse as sp, torch\n"
        "from ngsamg_tpu_torch.ops import cuda_lib, gs_cuda\n"
        "from ngsamg_tpu_torch.smoothers import build, core\n"
        "from ngsamg_tpu_torch.sparse import bell\n"
        "from ngsamg_tpu_torch import SmootherOptions, native\n"
        "native.HAVE_NATIVE = False  # no compiler on PATH either\n"
        "A = sp.random(60, 60, density=0.1, random_state=0, format='csr')\n"
        "A = (A + A.T + 20 * sp.eye(60)).tocsr()\n"
        "o = SmootherOptions()\n"
        "perm, cb = build.plan_row_order(A, 1, o, 0)\n"
        "A = A[perm][:, perm].tocsr()\n"
        "B = bell.from_scipy(A, 1, 1)\n"
        "sm = build.stage_smoother(build.build_smoother(\n"
        "    A, 1, o, 0, B.nrows_pad, np.float32, color_bounds=cb), 'cpu',\n"
        "    A=B)\n"
        "b = torch.ones((B.nrows_pad, 1), dtype=torch.float32)\n"
        "y = core.smooth(sm, B, None, b)\n"
        "assert cuda_lib._lib is None and sm.launch is not None\n"
        "print('ok', sm.launch.variant, tuple(y.shape))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc on it
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().startswith("ok")
