"""Port parity for the Gauss-Seidel family and the Jacobi builds.

The same seeded inputs go through the JAX package and its counterpart in
ngsamg_tpu_torch:
- the coloring bit for bit against the JAX package's native greedy kernel
  (``ngsamg_tpu.native.greedy_color``), on seeded graphs and on one that
  needs more than 64 colors (where the JAX package's numpy rounds never
  finish), and the 256-color limit of the native kernel's mark array;
- ``color_row_lists``, ``plan_row_order`` permutations and bounds;
- the Jacobi, l1-Jacobi and GS builds on matrix and stencil levels: Dinv,
  the per-color split ``cdata``/``ccols``/``cdinv`` and their widths equal
  to 0.0;
- ``spmv_rows`` and the GS ``smooth``/``smooth_back`` at bs 1 and 3 in both
  storage modes at rtol 1e-5; split against sliced bit for bit;
- ``dyn_blocks``, ``aggregate_blocks``, ``build_block_gs`` and
  ``block_gs_smooth``;
- every smoother kind reduces the energy error (the JAX package's
  ``test_smoother_reduces_energy_error``).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu.smoothers.block as jblock
import ngsamg_tpu.smoothers.build as jbuild
import ngsamg_tpu.smoothers.coloring as jcoloring
import ngsamg_tpu.smoothers.core as jcore
import ngsamg_tpu.sparse.bell as jbell
import ngsamg_tpu_torch
import ngsamg_tpu_torch.smoothers.block as tblock
import ngsamg_tpu_torch.smoothers.build as tbuild
import ngsamg_tpu_torch.smoothers.coloring as tcoloring
import ngsamg_tpu_torch.smoothers.core as tcore
import ngsamg_tpu_torch.sparse.bell as tbell
from ngsamg_tpu.factory import levels as jlevels
from ngsamg_tpu_torch.factory import levels as tlevels
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

def native_color(indptr, indices):
    """The JAX package's native greedy kernel, whatever HAVE_NATIVE says."""
    if getattr(jnative, "_nat", None) is None:
        pytest.skip("the JAX package's native extension is not built")
    return np.asarray(
        jnative._nat.greedy_color(*jnative._csr_idx(indptr, indices))
    )


@contextlib.contextmanager
def native_coloring():
    """Keep the reference's coloring on its native kernel (the numpy rounds
    color differently, or never finish beyond 64 colors)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "greedy_color", native_color)
        yield


def _random_graph(n, deg, seed):
    """A symmetric random graph without self-loops, rows 3 and 7 empty."""
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    i, j = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = (i != j) & ~np.isin(i, [3, 7]) & ~np.isin(j, [3, 7])
    G = sp.coo_matrix((np.ones(keep.sum()), (i[keep], j[keep])), (n, n))
    G = (G + G.T).tocsr()
    G.data[:] = 1.0
    return G


def _check_valid(G, colors):
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    assert not np.any(colors[rows] == colors[G.indices])


@pytest.mark.parametrize(
    "n, deg, seed",
    [(50, 4, 0), (500, 8, 1), (2000, 14, 2), (300, 40, 3)],
)
def test_coloring_matches_native(n, deg, seed):
    G = _random_graph(n, deg, seed)
    ct = tcoloring.jones_plassmann_coloring(G)
    assert ct.dtype == np.int32
    np.testing.assert_array_equal(ct, native_color(G.indptr, G.indices))
    _check_valid(G, ct)


def test_coloring_beyond_64_colors():
    """A clique of 100 vertices with a random graph around it needs 100
    colors: the port gives the native kernel's coloring, while the JAX
    package's numpy rounds (uint64 color masks) cannot finish."""
    G = _random_graph(400, 6, 4).tolil()
    for a in range(100):
        for b in range(100):
            if a != b:
                G[a, b] = 1.0
    G = G.tocsr()
    ct = tcoloring.jones_plassmann_coloring(G)
    np.testing.assert_array_equal(ct, native_color(G.indptr, G.indices))
    assert ct.max() + 1 >= 100
    _check_valid(G, ct)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "HAVE_NATIVE", False)
        with pytest.raises(RuntimeError, match="did not converge"):
            jcoloring.jones_plassmann_coloring(G)


def test_coloring_limit_and_empty():
    K = sp.csr_matrix(np.ones((257, 257)) - np.eye(257))
    with pytest.raises(RuntimeError, match="256 colors"):
        tcoloring.jones_plassmann_coloring(K)
    K256 = sp.csr_matrix(np.ones((256, 256)) - np.eye(256))
    np.testing.assert_array_equal(
        tcoloring.jones_plassmann_coloring(K256), np.arange(256)
    )
    assert tcoloring.jones_plassmann_coloring(sp.csr_matrix((0, 0))).size == 0


@pytest.mark.parametrize("align", [1, 8])
def test_color_row_lists(align):
    colors = native_color(*(lambda G: (G.indptr, G.indices))(
        _random_graph(300, 8, 5)))
    lj = jcoloring.color_row_lists(colors, 299, align)
    lt = tcoloring.color_row_lists(colors, 299, align)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _problem(bs):
    if bs == 1:
        return tfem.poisson_2d(16).A
    return tfem.unstructured_elasticity(5, dim=3).A


def _opts(pkg, kind, **kw):
    return pkg.config.SmootherOptions(type=pkg.config.SmootherType(kind), **kw)


@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("kind", ["gs", "dyn_bgs", "jacobi"])
def test_plan_row_order(kind, bs):
    A = _problem(bs)
    with native_coloring():
        pj, bj = jbuild.plan_row_order(A, bs, _opts(ngsamg_tpu, kind), 0)
    pt, bt = tbuild.plan_row_order(A, bs, _opts(ngsamg_tpu_torch, kind), 0)
    assert bt == bj
    if pj is None:
        assert pt is None
        return
    np.testing.assert_array_equal(pt, pj)
    assert bt[0] == 0 and bt[-1] == A.shape[0] // bs
    # colors are independent sets of the block graph
    W, _ = tbuild.block_norm_graph(A, bs)
    colors = np.repeat(np.arange(len(bt) - 1), np.diff(bt))[np.argsort(pt)]
    _check_valid(W, colors)


def _permuted(A, bs, perm):
    sperm = (perm[:, None] * bs + np.arange(bs)).ravel()
    return A[sperm][:, sperm].tocsr()


def _build_pair(kind, bs, split=True, steps=1):
    """The same level built by both packages: (A, J smoother, T smoother,
    J BlockELL, T BlockELL)."""
    A = _problem(bs)
    oj = _opts(ngsamg_tpu, kind, steps=ngsamg_tpu.SpecOpt(steps))
    ot = _opts(ngsamg_tpu_torch, kind, steps=ngsamg_tpu_torch.SpecOpt(steps))
    with native_coloring():
        perm, cb = jbuild.plan_row_order(A, bs, oj, 0)
    if perm is not None:
        A = _permuted(A, bs, perm)
    Aj = jbell.from_scipy(A, bs, bs)
    At = tbell.from_scipy(A, bs, bs)
    ell_j = ell_t = None
    if split and kind == "gs":
        ell_j = (np.asarray(Aj.data), np.asarray(Aj.cols))
        ell_t = (At.data.numpy(), At.cols.numpy())
    with native_coloring():
        sj = jbuild.build_smoother(A, bs, oj, 0, Aj.nrows_pad, jnp.float32,
                                   color_bounds=cb, ell=ell_j)
    st = tbuild.build_smoother(A, bs, ot, 0, At.nrows_pad, np.float32,
                               color_bounds=cb, ell=ell_t)
    return A, sj, st, Aj, At


@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("kind", ["jacobi", "l1_jacobi", "gs"])
def test_matrix_build_matches(kind, bs):
    _A, sj, st, Aj, _At = _build_pair(kind, bs)
    assert type(st).__name__ == type(sj).__name__
    np.testing.assert_array_equal(st.Dinv, np.asarray(sj.Dinv))
    assert st.Dinv.dtype == np.float32 and st.steps == sj.steps
    if kind != "gs":
        assert st.omega == sj.omega
        return
    assert st.color_bounds == sj.color_bounds
    assert len(st.cdata) == len(sj.cdata) == len(st.color_bounds) - 1
    for dt, dj, ct, cj, it, ij in zip(st.cdata, sj.cdata, st.ccols,
                                      sj.ccols, st.cdinv, sj.cdinv):
        assert dt.shape == np.asarray(dj).shape  # the trimmed width
        np.testing.assert_array_equal(dt, np.asarray(dj))
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_array_equal(it, np.asarray(ij))
    assert max(d.shape[1] for d in st.cdata) <= Aj.ell_width
    assert sum(d.shape[0] for d in st.cdata) == st.color_bounds[-1]


@pytest.mark.parametrize("kind", ["jacobi", "l1_jacobi", "chebyshev"])
def test_stencil_build_matches(kind):
    """Stencil levels of the structured setup: level 0 (uniform: a
    broadcast scalar for Jacobi and Chebyshev) and level 1 (clamped)."""
    p = tfem.poisson_3d(40)
    levs = []
    for pkg, run in ((ngsamg_tpu, jlevels.setup_levels),
                     (ngsamg_tpu_torch, tlevels.setup_levels)):
        opts = pkg.AMGOptions(smoother=_opts(pkg, kind))
        levs.append((opts, run(p.A, pkg.precond.amg.H1Energy(), opts,
                               p.coords)[0]))
    (oj, lj), (ot, lt) = levs
    for i in (0, 1):
        assert lj[i].stencil is not None and lt[i].stencil is not None
        n_pad = -(-lt[i].stencil.n // 8) * 8
        sj = jbuild.build_smoother(None, 1, oj.smoother, i, n_pad,
                                   jnp.float32, stencil=lj[i].stencil)
        st = tbuild.build_smoother(None, 1, ot.smoother, i, n_pad,
                                   np.float32, stencil=lt[i].stencil)
        assert type(st).__name__ == type(sj).__name__
        np.testing.assert_array_equal(st.Dinv, np.asarray(sj.Dinv))
        if kind == "chebyshev":
            assert float(st.lam_max) == float(sj.lam_max)
        else:
            assert st.omega == sj.omega
        if kind != "l1_jacobi" and i == 0:
            assert st.Dinv.shape == (1, 1, 1)


def test_unported_smoother_raises():
    """The Hiptmair kind is no ``build_smoother`` smoother in either
    package (the Stokes preconditioners build it); GS needs a
    color-permuted level."""
    A = _problem(1)
    for pkg, build in ((ngsamg_tpu_torch, tbuild), (ngsamg_tpu, jbuild)):
        with pytest.raises(ValueError, match="unsupported smoother type"):
            build.build_smoother(A, 1, _opts(pkg, "hiptmair"), 0,
                                 A.shape[0], np.float32)
    with pytest.raises(ValueError, match="color-permuted"):
        tbuild.build_smoother(A, 1, _opts(ngsamg_tpu_torch, "gs"), 0,
                              A.shape[0], np.float32)


@pytest.mark.parametrize("bs", [1, 3, 6])
def test_spmv_rows(bs):
    rng = np.random.default_rng(7 + bs)
    S = sp.random(45, 45, density=0.15, random_state=bs, format="csr")
    S = S + sp.eye(45)
    B = sp.bsr_matrix(
        (rng.standard_normal((S.nnz, bs, bs)), S.indices, S.indptr),
        shape=(45 * bs, 45 * bs),
    )
    Aj, At = jbell.from_scipy(B, bs, bs), tbell.from_scipy(B, bs, bs)
    x = rng.standard_normal((At.nrows_pad, bs)).astype(np.float32)
    rows = np.array([3, 0, 44, 17, 17, 46, 8], dtype=np.int32)
    yj = np.asarray(jbell.spmv_rows(Aj, jnp.asarray(x), jnp.asarray(rows)))
    yt = tbell.spmv_rows(At, torch.from_numpy(x),
                         torch.from_numpy(rows.astype(np.int64))).numpy()
    assert yt.shape == (len(rows), bs)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())
    full = tbell.spmv(At, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, full[rows], rtol=1e-6, atol=1e-6)


def _tensor_smoother(st):
    """The port's host-built smoother with its arrays as CPU tensors."""
    return tbuild.stage_smoother(st, "cpu")


@pytest.mark.parametrize("split", [True, False], ids=["split", "sliced"])
@pytest.mark.parametrize("bs", [1, 3])
def test_gs_sweeps_match_jax(bs, split):
    A, sj, st, Aj, At = _build_pair("gs", bs, split=split, steps=2)
    assert bool(st.cdata) == split
    st = _tensor_smoother(st)
    assert all(c.dtype == torch.int64 for c in st.ccols)
    n = A.shape[0]
    rng = np.random.default_rng(3)
    b = np.zeros((At.nrows_pad, bs), np.float32)
    b[: n // bs] = rng.standard_normal((n // bs, bs))
    x0 = np.zeros_like(b)
    x0[: n // bs] = rng.standard_normal((n // bs, bs))
    for start in (None, x0):
        xj = jcore.smooth(sj, Aj, None if start is None else jnp.asarray(start),
                          jnp.asarray(b))
        xt_in = None if start is None else torch.from_numpy(start.copy())
        xt = tcore.smooth(st, At, xt_in, torch.from_numpy(b))
        if start is not None:  # the caller's x is never written
            np.testing.assert_array_equal(xt_in.numpy(), start)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(xj)).max())
        yj = jcore.smooth_back(sj, Aj, xj, jnp.asarray(b))
        yt = tcore.smooth_back(st, At, xt, torch.from_numpy(b))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(yj)).max())
        np.testing.assert_array_equal(yt.numpy()[n // bs:], 0.0)


@pytest.mark.parametrize("bs", [1, 3])
def test_gs_split_matches_sliced(bs):
    """The per-color split storage is the same sweep as the sliced one,
    bit for bit (trailing zero slots add nothing)."""
    _A, _sj, st_split, _Aj, At = _build_pair("gs", bs, split=True, steps=2)
    _A, _sj, st_slice, _Aj, _At = _build_pair("gs", bs, split=False, steps=2)
    st_split, st_slice = _tensor_smoother(st_split), _tensor_smoother(st_slice)
    rng = np.random.default_rng(9)
    b = torch.from_numpy(
        rng.standard_normal((At.nrows_pad, bs)).astype(np.float32))
    b[At.nrows:] = 0
    for x0 in (None, torch.from_numpy(
            rng.standard_normal((At.nrows_pad, bs)).astype(np.float32))):
        xa = tcore.smooth(st_slice, At, x0, b)
        xb = tcore.smooth(st_split, At, x0, b)
        assert torch.equal(xa, xb)
        assert torch.equal(tcore.smooth_back(st_slice, At, xa, b),
                           tcore.smooth_back(st_split, At, xb, b))


def test_dyn_blocks_and_aggregate_blocks():
    for A in (tfem.elasticity_2d(8, length=6).A, tfem.poisson_2d(12).A):
        bj = jblock.dyn_blocks(A, max_block=8)
        bt = tblock.dyn_blocks(A, max_block=8)
        assert len(bj) == len(bt)
        for a, b in zip(bj, bt):
            np.testing.assert_array_equal(a, b)
    assert max(len(b) for b in bt) >= 1
    v2agg = np.random.default_rng(2).integers(0, 40, 300)
    v2agg[v2agg == 11] = 12  # an empty aggregate
    aj = jblock.aggregate_blocks(v2agg, 40)
    at = tblock.aggregate_blocks(v2agg, 40)
    assert len(aj) == len(at) == 39
    for a, b in zip(aj, at):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("blocks", ["dyn", "aggregates"])
def test_block_gs_matches_jax(blocks):
    A = tfem.elasticity_2d(6, length=4).A.tocsr()
    n = A.shape[0]
    Aj, At = jbell.from_scipy(A, 1, 1), tbell.from_scipy(A, 1, 1)
    n_pad = At.nrows_pad  # as the level's staging sizes it
    if blocks == "dyn":
        blk = tblock.dyn_blocks(A)
    else:
        blk = tblock.aggregate_blocks(np.arange(n) // 5, -(-n // 5))
    with native_coloring():
        sj = jblock.build_block_gs(A, blk, n_pad, jnp.float32, steps=2)
    st = tblock.build_block_gs(A, blk, n_pad, np.float32, steps=2)
    assert st.color_bounds == sj.color_bounds
    np.testing.assert_array_equal(st.blocks.numpy(), np.asarray(sj.blocks))
    np.testing.assert_array_equal(st.Binv.numpy(), np.asarray(sj.Binv))
    rng = np.random.default_rng(4)
    b = np.zeros((n_pad, 1), np.float32)
    b[:n, 0] = rng.standard_normal(n)
    xj = jblock.block_gs_smooth(sj, Aj, None, jnp.asarray(b), reverse=False)
    xt = tblock.block_gs_smooth(st, At, None, torch.from_numpy(b),
                                reverse=False)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(xj)).max())
    keep = xt.clone()
    yj = jcore.smooth_back(sj, Aj, xj, jnp.asarray(b))
    yt = tcore.smooth_back(st, At, xt, torch.from_numpy(b))
    assert torch.equal(xt, keep)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(yj)).max())
    # one sweep on A x = 0 lowers the energy of x
    x0 = torch.from_numpy(b)
    x1 = tcore.smooth(st, At, x0, torch.zeros_like(x0))
    v0, v1 = (v[:n, 0].double().numpy() for v in (x0, x1))
    assert v1 @ (A @ v1) < 0.6 * (v0 @ (A @ v0))


@pytest.mark.parametrize("kind", ["gs", "jacobi", "l1_jacobi", "chebyshev"])
def test_smoother_reduces_energy_error(kind):
    """The JAX package's test, on the port: five symmetric sweep pairs on
    poisson_2d(16) lower the error of A x = b below 0.9 of its start."""
    p = tfem.poisson_2d(16)
    opts = _opts(ngsamg_tpu_torch, kind)
    A = p.A
    perm, cb = tbuild.plan_row_order(A, 1, opts, 0)
    if perm is not None:
        A = A[perm][:, perm].tocsr()
    Ad = tbell.from_scipy(A, 1, 1)
    sm = tbuild.build_smoother(A, 1, opts, 0, Ad.nrows_pad, np.float32,
                               color_bounds=cb)
    sm = tbuild.stage_smoother(sm, "cpu")
    rng = np.random.default_rng(0)
    xex = rng.standard_normal(p.n)
    b = A @ xex
    bd = torch.zeros((Ad.nrows_pad, 1), dtype=torch.float32)
    bd[: p.n, 0] = torch.from_numpy(b)
    x = tcore.smooth(sm, Ad, None, bd)
    for _ in range(5):
        x = tcore.smooth_back(sm, Ad, x, bd)
        x = tcore.smooth(sm, Ad, x, bd)
    err = np.linalg.norm(x[: p.n, 0].numpy() - xex)
    assert err < 0.9 * np.linalg.norm(xex)
