"""Port parity for the elasticity setup and staging (block energies).

`elasticity_2d(10, length=10)` (2,200 DoF), `elasticity_3d(4, length=10)`
(3,000 DoF) and `unstructured_elasticity(8, dim=3)` (1,944 DoF) go through
both packages' `AMGPreconditioner(A, energy="elasticity", block_size=dim,
coords=..., Chebyshev).setup()`, each package with an energy instance of
its own (the rotation scale is state on the energy object).

Which comparison is which:
- against the JAX package forced onto its NUMPY branches
  (`ngsamg_tpu.native.HAVE_NATIVE = False` while it sets up; every wrapper
  reads the flag at call time): the branches the port copies. The fem
  generators' output, the finest mesh, every level's aggregation, the
  level sizes and nnz are compared exactly; f64 host quantities (energy
  data, strengths, replacement matrix, P, coarse A, scaling vectors,
  lam_max, the coarse inverse) to 1e-12 relative; staged f32 data to one
  f32 ulp.
- against the JAX package with its NATIVE kernels (the robust SOC is then
  a Jacobi sweep, the RAP a fused block kernel, so near-ties may flip a
  pair): level count, operator complexity within 2%.
"""

import contextlib

import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu.apps.elasticity import ElasticityEnergy as JEl
from ngsamg_tpu.mesh import topo as jtopo
from ngsamg_tpu.utils import fem as jfem
from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy as TEl
from ngsamg_tpu_torch.mesh import topo as ttopo
from ngsamg_tpu_torch.sparse import bell as tbell
from ngsamg_tpu_torch.sparse import formats as tformats
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

F32_ULP = 2.0 ** -23
CASES = {
    "el2d": ("elasticity_2d", (10,), {"length": 10}),
    "el3d": ("elasticity_3d", (4,), {"length": 10}),
    "unstr3d": ("unstructured_elasticity", (8,), {"dim": 3}),
}


@pytest.fixture(autouse=True, scope="module")
def port_numpy_branches():
    """The port on the numpy branches of its host setup for this whole
    file: its hierarchies are held to the JAX package's numpy branches
    (``numpy_branches``), and where a test compares with the JAX package's
    native run it holds the port's numpy hierarchy to it. The native
    branches are held to the JAX package's native run by
    tests/test_torch_native.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "HAVE_NATIVE", False)
        yield


@contextlib.contextmanager
def numpy_branches():
    """The JAX package on the numpy branches of its host setup."""
    old = jnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = False
    try:
        yield
    finally:
        jnative.HAVE_NATIVE = old


def _cheb(pkg):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        )
    )


def _setup(pkg, p, **kw):
    return pkg.AMGPreconditioner(
        p.A, energy="elasticity", block_size=p.block_size, coords=p.coords,
        options=_cheb(pkg), **kw
    ).setup()


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    gen, args, kw = CASES[request.param]
    p = getattr(tfem, gen)(*args, **kw)
    with numpy_branches():
        pj = _setup(ngsamg_tpu, p)
    pt = _setup(ngsamg_tpu_torch, p, device="cpu")
    return request.param, p, pj, pt


def _rel_max(a, b):
    d = abs(a - b)
    return (d.max() if d.size else 0.0) / abs(b).max()


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(np.abs(b).max(), 1e-300)


def test_fem_matches_jax(pair):
    name, p, _, _ = pair
    gen, args, kw = CASES[name]
    q = getattr(jfem, gen)(*args, **kw)
    assert (p.A != q.A).nnz == 0 and p.A.nnz == q.A.nnz
    np.testing.assert_array_equal(p.b, q.b)
    np.testing.assert_array_equal(p.coords, q.coords)
    assert (p.dim, p.block_size) == (q.dim, q.block_size)


def test_finest_mesh_and_energy(pair):
    """Mesh, edge data, transport, both strengths, the replacement matrix
    and one level of mapped data, each package on its own energy."""
    _, p, _, _ = pair
    ej, et = JEl(p.dim), TEl(p.dim)
    with numpy_branches():
        mj = ej.build_finest_mesh(p.A.tocsr(), p.coords)
        socr_j = ej.soc_robust(mj)
        socmin_j = ej.soc_robust(mj, reduction="min", neib_boost=True)
        Rj = ej.replacement_matrix(mj)
        Dj = ej.aux_diagonal(mj)
    mt = et.build_finest_mesh(p.A.tocsr(), p.coords)
    assert et._s == ej._s and et.dpv == ej.dpv == (3 if p.dim == 2 else 6)
    assert (et.default_aaf, et.default_robust) == (
        ej.default_aaf, ej.default_robust
    )
    assert mt.nv == mj.nv
    np.testing.assert_array_equal(mt.edges, mj.edges)
    for k in ("mat", "wt"):
        np.testing.assert_array_equal(mt.edge_data[k], mj.edge_data[k])
    for k in ("l2wt", "pos"):
        np.testing.assert_array_equal(mt.vertex_data[k], mj.vertex_data[k])
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 7, p.dim))
    np.testing.assert_array_equal(et.transport(a, b), ej.transport(a, b))
    np.testing.assert_array_equal(et.embed_blocks(5), ej.embed_blocks(5))
    assert abs(et.embedding_matrix(mt) - ej.embedding_matrix(mj)).max() == 0
    _close(et.soc(mt), ej.soc(mj))
    _close(et.soc_robust(mt), socr_j)
    _close(et.soc_robust(mt, reduction="min", neib_boost=True), socmin_j,
           tol=1e-9)
    sub = np.arange(0, mt.ne, 3)
    _close(et.soc_robust(mt, edge_subset=sub)[sub], socr_j[sub])
    Rt = et.replacement_matrix(mt)
    assert Rt.nnz == Rj.nnz and _rel_max(Rt, Rj) <= 1e-12
    _close(et.aux_diagonal(mt), Dj)


def test_map_data_matches(pair):
    _, _, pj, pt = pair
    lj, lt = pj.setup_levels_[0], pt.setup_levels_[0]
    nj = int(lj.v2agg.max()) + 1
    cej, e2j = jtopo.map_edges(lj.mesh, lj.v2agg, nj)
    cet, e2t = ttopo.map_edges(lt.mesh, lt.v2agg, nj)
    np.testing.assert_array_equal(cet, cej)
    np.testing.assert_array_equal(e2t, e2j)
    for boost in (0.0, 0.5):
        with numpy_branches():
            cj = pj.energy.map_data(lj.mesh, lj.v2agg, nj, cej, e2j,
                                    diag_stab_boost=boost)
        ct = pt.energy.map_data(lt.mesh, lt.v2agg, nj, cet, e2t,
                                diag_stab_boost=boost)
        for k in cj.edge_data:
            _close(ct.edge_data[k], cj.edge_data[k])
        assert set(ct.vertex_data) == set(cj.vertex_data)
        for k in cj.vertex_data:
            _close(ct.vertex_data[k], cj.vertex_data[k])


def test_levels_match_exactly(pair):
    """Sizes, nnz, operator complexity, row block sizes and every level's
    aggregation (against the numpy branches)."""
    _, p, pj, pt = pair
    assert pt.log_.nvs == pj.log_.nvs
    assert pt.log_.nnzs == pj.log_.nnzs
    assert pt.operator_complexity == pj.operator_complexity
    assert pt.num_levels == pj.num_levels >= 2
    assert pt.energy._s == pj.energy._s
    aj, at = pj.options.coarsen.aaf, pt.options.coarsen.aaf
    assert (at.default, at.spec) == (aj.default, aj.spec)
    assert at.default == (0.08 if p.dim == 3 else None)
    for i, (lj, lt) in enumerate(zip(pj.setup_levels_, pt.setup_levels_)):
        assert lt.row_bs == lj.row_bs == (p.dim if i == 0 else pt.energy.dpv)
        if lj.v2agg is None:
            assert lt.v2agg is None
            continue
        np.testing.assert_array_equal(lt.v2agg, lj.v2agg)


def test_prolongations_and_coarse_matrices(pair):
    _, _, pj, pt = pair
    for lj, lt in zip(pj.setup_levels_, pt.setup_levels_):
        if lj.P is not None:
            assert lt.P.format == "bsr" and lt.P.blocksize == lj.P.blocksize
            Pj, Pt = lj.P.tocsr(), lt.P.tocsr()
            assert Pt.shape == Pj.shape and _rel_max(Pt, Pj) <= 1e-12
        assert lt.A.shape == lj.A.shape and lt.A.nnz == lj.A.nnz
        assert _rel_max(lt.A, lj.A) <= 1e-12
    Paj, Pat = pj.setup_levels_[0].P_amg, pt.setup_levels_[0].P_amg
    assert Pat.blocksize == Paj.blocksize == (pt.energy.dpv,) * 2
    assert _rel_max(Pat.tocsr(), Paj.tocsr()) <= 1e-12


def test_native_run_is_close(pair):
    """Against the native kernels: level count and operator complexity."""
    _, p, _, pt = pair
    pn = _setup(ngsamg_tpu, p)
    assert pt.num_levels == pn.num_levels
    assert abs(pt.operator_complexity / pn.operator_complexity - 1) <= 0.02


def test_scaling_and_staged_data(pair):
    """S_0, every staged level operator and transfer, Dinv, lam_max and the
    (f64) coarse inverse."""
    _, _, pj, pt = pair
    assert pt._perm0 is None and pj._perm0 is None
    _close(pt._scale0, pj._scale0)
    assert pt.op.coarse_inv.dtype == torch.float64
    ci_j = np.asarray(pj.op.coarse_inv)
    assert ci_j.dtype == np.float64
    _close(pt.op.coarse_inv.numpy(), ci_j, tol=1e-9)
    assert pt.op.cluster_corr is None and pj.op.cluster_corr is None

    def same(Tt, Tj):
        assert type(Tt).__name__ == type(Tj).__name__
        dj = np.asarray(Tj.data)
        assert Tt.data.numpy().dtype == np.float32 == dj.dtype
        assert np.abs(Tt.data.numpy() - dj).max() <= F32_ULP * np.abs(dj).max()
        assert Tt.nrows == Tj.nrows and Tt.nrows_pad == Tj.nrows_pad
        if isinstance(Tt, tbell.BlockELL):
            np.testing.assert_array_equal(Tt.cols.numpy(), np.asarray(Tj.cols))
            assert Tt.ncols == Tj.ncols and Tt.col_chunk == Tj.col_chunk

    for lj, lt in zip(pj.op.levels, pt.op.levels):
        same(lt.A, lj.A)
        assert isinstance(lt.A, (tbell.BlockELL, tformats.DenseMatrix))
        if lj.P is not None:
            same(lt.P, lj.P)
            same(lt.R, lj.R)
            assert isinstance(lt.P, tbell.BlockELL)
        if lj.smoother is not None:
            sj, st = lj.smoother, lt.smoother
            assert (st.order, st.steps) == (sj.order, sj.steps) == (5, 1)
            dj = np.asarray(sj.Dinv)
            assert st.Dinv.shape == dj.shape and dj.shape[1] > 1
            assert np.abs(st.Dinv.numpy() - dj).max() <= (
                F32_ULP * np.abs(dj).max()
            )
            np.testing.assert_allclose(
                float(st.lam_max), float(sj.lam_max), rtol=1e-6
            )
            np.testing.assert_allclose(
                float(st.lam_min), 0.25 * float(st.lam_max), rtol=1e-6
            )


def test_staged_operator_is_the_scaled_matrix(pair):
    """The staged finest operator is S A S of the host matrix."""
    _, p, _, pt = pair
    A0 = pt.op.levels[0].A
    bs = p.block_size
    x = np.random.default_rng(1).standard_normal(p.n)
    xd = tformats.block_vec(x, bs, A0.nrows_pad, torch.float32)
    y = tformats.flat_vec(tformats.matvec(A0, xd), A0.nrows).numpy()
    s = pt._scale0
    ref = s * (p.A @ (s * x))
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_rbm_preserved_through_hierarchy(pair):
    """Rigid-body modes prolongate exactly through the port's hierarchy,
    away from the clamped boundary (the JAX package's check_kvecs analog)."""
    _, p, _, pt = pair
    en, levels, dim = pt.energy, pt.setup_levels_, p.dim
    pos_c = levels[-1].mesh.vertex_data["pos"]
    ref = np.zeros(dim)
    rbm = np.array([0.3, -0.2, 0.7] if dim == 2
                   else [0.3, -0.2, 0.5, 0.7, -0.4, 0.1])
    rbm[dim:] /= en._s  # rotations are carried in units of 1/s
    v = np.einsum(
        "mij,j->mi", en.transport(np.tile(ref, (len(pos_c), 1)), pos_c), rbm
    ).ravel()
    for lev in reversed(levels[:-1]):
        v = lev.P @ v
    pos_f = levels[0].mesh.vertex_data["pos"]
    expect = np.einsum(
        "mij,j->mi", en.transport(np.tile(ref, (len(pos_f), 1)), pos_f), rbm
    )[:, :dim].ravel()
    interior = np.repeat(pos_f[:, 0] > 0.25 * pos_f[:, 0].max(), dim)
    assert interior.any()
    err = np.abs(v - expect)[interior]
    assert err.max() < 1e-8 * max(np.abs(expect).max(), 1.0)
