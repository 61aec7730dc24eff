"""Port parity for the reference-compatible API (`api.py`).

Mirrors tests/test_frontend.py's ``test_api_lifecycle_and_regularize``,
``test_utils_and_map_exports`` and ``test_get_rotation_of_bf``: the same
inputs go through ``ngsamg_tpu.api`` and ``ngsamg_tpu_torch.api``
(``device="cpu"``, the kernels' plain versions). Tolerances: ``GetBF``, the
``DOFMap`` transfers and ``GetRotationOfBF`` to rtol 1e-6 (host f64 products
of the same prolongations); ``RegularizeMatrix``, ``SparseMM`` and
``AMGBFCheck`` exactly (the same numpy code); ``ToSparseMatrix`` of staged
levels to one f32 ulp; the standalone smoothers' ``Smooth``/``SmoothBack``
to rtol 1e-5 (f32 sweeps); Stokes levels exactly and iterations within one.

Three answers of the JAX package are wrong and the port's differ, each with
a test here: ``ToSparseMatrix`` of a ``DiaMatrix`` (it reads the
row-indexed storage with scipy's column-indexed DIA convention, and drops
the mirrored diagonals of a symmetric-half level), ``GetBF``/``GetMap`` on
a level whose prolongation is implicit (it fails in a numpy matmul, or
returns a map with a step missing), and ``GetNDof`` of a stencil-domain
level, which keeps no host matrix (AttributeError).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu
import ngsamg_tpu.api as JA
import ngsamg_tpu_torch
import ngsamg_tpu_torch.api as TA
from ngsamg_tpu.sparse import formats as jformats
from ngsamg_tpu.utils import stokes_fem as jsf
from ngsamg_tpu_torch.sparse import formats as tformats
from ngsamg_tpu_torch.utils import fem as tfem
from ngsamg_tpu_torch.utils import stokes_fem as tsf

torch.set_num_threads(2)

F32_ULP = 2.0 ** -23
CPU = {"device": "cpu"}


def _relres(A, b, x):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


def test_api_lifecycle_and_regularize():
    """The two-phase InitLevel/FinalizeLevel lifecycle carries ``device``
    through, and RegularizeMatrix equals the JAX package's."""
    p = tfem.poisson_2d(24)
    its = []
    for mod, kw in ((JA, {}), (TA, CPU)):
        pc = mod.h1_scal(None, **kw)
        pc.InitLevel(freedofs=None)
        pc.FinalizeLevel(p.A)
        x, info = pc.solve(p.b, tol=1e-8)
        assert info.converged and _relres(p.A, p.b, x) < 1e-7
        its.append(info.iterations)
    assert pc.device.type == "cpu" and pc.A_dev.data.device.type == "cpu"
    assert abs(its[0] - its[1]) <= 1, its
    with pytest.raises(RuntimeError, match="already finalized"):
        pc.FinalizeLevel(p.A)

    pe = tfem.unstructured_elasticity(6, dim=2)
    A = pe.A.tolil()
    A[0, 0] = 0.0  # deficient diagonal block
    A = A.tocsr()
    for bs in (1, 2):
        R = TA.RegularizeMatrix(A, block_size=bs)
        Rj = JA.RegularizeMatrix(A, block_size=bs)
        assert (R != Rj).nnz == 0 and R.shape == Rj.shape
    assert abs(R - A).nnz <= 4  # only the deficient block touched


def test_device_passes_through_every_constructor():
    """``device`` reaches the staged tensors and never the option flags;
    the default is the card (which raises where there is none)."""
    p = tfem.poisson_2d(12)
    pc = TA.h1_scal(p.A, ngs_amg_sm_type="chebyshev", **CPU)
    assert pc.options == ngsamg_tpu_torch.options_from_flags(
        {"ngs_amg_sm_type": "chebyshev"}
    )
    if torch.cuda.is_available():
        assert TA.h1_scal(p.A).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TA.h1_scal(p.A)
    v2 = tfem.vector_poisson(p, 2)
    v3 = tfem.vector_poisson(p, 3)
    e2 = tfem.elasticity_2d(4, length=4)
    e3 = tfem.elasticity_3d(3, length=3)
    for pc in (
        TA.h1_2d(v2.A, coords=v2.coords, **CPU),
        TA.h1_3d(v3.A, coords=v3.coords, **CPU),
        TA.elast_2d(e2.A, e2.coords, **CPU),
        TA.elast_3d(e3.A, e3.coords, **CPU),
    ):
        assert pc.device.type == "cpu"
        assert pc.op.levels[0].A.data.device.type == "cpu"
    for sm in (
        TA.CreateHybridGSS(p.A, **CPU),
        TA.CreateJacobiSmoother(p.A, **CPU),
        TA.CreateChebyshevSmoother(p.A, **CPU),
        TA.CreateDynBlockSmoother(p.A, **CPU),
        TA.CreateHybridBlockGSS(p.A, [np.arange(4), np.arange(4, 9)], **CPU),
    ):
        assert sm.Ad.data.device.type == "cpu"


def _h1_pair(p, **flags):
    return (JA.h1_scal(p.A, coords=p.coords, **flags),
            TA.h1_scal(p.A, coords=p.coords, **flags, **CPU))


def _assert_f32_equal(Cj, Ct, what):
    assert Cj.shape == Ct.shape, what
    d = abs(Cj - Ct)
    assert d.nnz == 0 or d.max() <= F32_ULP * abs(Cj).max(), what


def test_utils_and_map_exports():
    """SparseMM / ToSparseMatrix / AMGBFCheck / GetBF / DOFMap against the
    JAX package on its default options (multicolor GS: every level has an
    explicit P)."""
    p = tfem.poisson_2d(24)
    pj, pt = _h1_pair(p, ngs_amg_max_coarse_size=40)
    assert pt.GetNLevels() == pj.GetNLevels() >= 3
    assert [pt.GetNDof(i) for i in range(pt.GetNLevels())] == [
        pj.GetNDof(i) for i in range(pj.GetNLevels())
    ]
    assert pt.GetOC() == pytest.approx(pj.GetOC(), rel=1e-12)
    M = TA.SparseMM(p.A, p.A)
    assert (M != JA.SparseMM(p.A, p.A)).nnz == 0
    for i, (lj, lt) in enumerate(zip(pj.op.levels, pt.op.levels)):
        assert type(lt.A).__name__ == type(lj.A).__name__
        _assert_f32_equal(
            JA.ToSparseMatrix(lj.A), TA.ToSparseMatrix(lt.A), f"level {i}"
        )
    A0 = TA.ToSparseMatrix(pt.op.levels[0].A)[: p.n, : p.n]
    perm = pt._perm0 if pt._perm0 is not None else np.arange(p.n)
    ref = p.A[perm][:, perm]
    x = np.ones(p.n)
    assert np.abs(A0 @ x - ref @ x).max() < 1e-4 * np.abs(ref @ x).max()
    assert TA.AMGBFCheck(p.A, 2.0 * p.A, verbose=False) == JA.AMGBFCheck(
        p.A, 2.0 * p.A, verbose=False
    )
    for level, dof in ((1, 3), (2, 0), (pt.GetNLevels() - 1, 1)):
        np.testing.assert_allclose(
            pt.GetBF(level=level, dof=dof), pj.GetBF(level=level, dof=dof),
            rtol=1e-6, atol=1e-12,
        )
    mj, mt = pj.GetMap(), pt.GetMap()
    assert mt.GetNSteps() == mj.GetNSteps() == pt.GetNLevels() - 1
    rng = np.random.default_rng(0)
    vf = rng.standard_normal(p.n)
    for k in range(mt.GetNSteps()):
        vc = mt.TransferF2C(k, vf)
        np.testing.assert_allclose(vc, mj.TransferF2C(k, vf), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(
            mt.GetStep(k).TransferC2F(vc), mj.GetStep(k).TransferC2F(vc),
            rtol=1e-6, atol=1e-12,
        )
        vf = vc
    c = rng.standard_normal(pt.GetNDof(pt.GetNLevels() - 1))
    np.testing.assert_allclose(pt.CINV(c), pj.CINV(c), rtol=1e-6)


def test_get_rotation_of_bf():
    """Coarse-BF rotations via the pre-embedding prolongation."""
    p = tfem.elasticity_2d(8, length=6)
    rots = []
    for mod, pkg, kw in ((JA, ngsamg_tpu, {}), (TA, ngsamg_tpu_torch, CPU)):
        o = pkg.AMGOptions(dtype="float64")
        o.levels.max_coarse_size = 60
        pc = mod.elast_2d(p.A, p.coords, options=o, **kw)
        rots.append(pc.GetRotationOfBF(level=1, dof=3, comp=2))
    nv = p.A.shape[0] // 2
    assert rots[1].shape == (nv, 1) and np.abs(rots[1]).max() > 0
    np.testing.assert_allclose(rots[1], rots[0], rtol=1e-6, atol=1e-14)


def test_lattice_hierarchy_to_sparse_and_implicit_transfers():
    """`poisson_3d(40)` with Chebyshev takes the structured setup: level 0
    is a `StencilDia` with an implicit (lattice) transfer, levels 1-2 full
    DIA. The port's ``ToSparseMatrix`` equals each level's matvec; the JAX
    package's is right on the stencil and dense levels but shifts the
    off-diagonals of a DIA level. ``GetBF``/``GetMap`` across the implicit
    transfer raise a ValueError that says so."""
    p = tfem.poisson_3d(40)
    pj, pt = _h1_pair(p, ngs_amg_sm_type="chebyshev")
    assert [type(lv.A).__name__ for lv in pt.op.levels] == [
        "StencilDia", "DiaMatrix", "DiaMatrix", "DenseMatrix"
    ]
    assert pt.setup_levels_[0].P is None
    assert pt.setup_levels_[0].lattice_transfer is not None
    rng = np.random.default_rng(1)
    for i, (lj, lt) in enumerate(zip(pj.op.levels, pt.op.levels)):
        C = TA.ToSparseMatrix(lt.A)
        v = rng.standard_normal(C.shape[0])
        y = tformats.flat_vec(
            tformats.matvec(lt.A, tformats.block_vec(
                v, 1, lt.A.nrows_pad, torch.float32)),
            lt.A.nrows,
        ).double().numpy()
        scale = np.abs(y).max()
        assert np.abs(C @ v - y).max() <= 1e-5 * scale, i
        Cj = JA.ToSparseMatrix(lj.A)
        if isinstance(lt.A, tformats.DiaMatrix):
            assert np.abs(Cj @ v - y).max() > 1e-3 * scale, i  # the fault
            np.testing.assert_array_equal(Cj.diagonal(), C.diagonal())
        else:
            _assert_f32_equal(Cj, C, f"level {i}")
    for level in (1, 2):
        with pytest.raises(ValueError, match="implicit \\(lattice"):
            pt.GetBF(level=level)
        with pytest.raises(ValueError):
            pj.GetBF(level=level)  # numpy's matmul shape error
    with pytest.raises(ValueError, match="level 0's prolongation is implicit"):
        pt.GetMap()
    assert pj.GetMap().GetNSteps() == 2  # one step short of 3
    np.testing.assert_array_equal(pt.GetBF(level=0, dof=5),
                                  pj.GetBF(level=0, dof=5))


def test_stencil_domain_levels_ndof():
    """`poisson_3d(72)` keeps a level of more than 40,000 rows in the
    stencil domain, with no host matrix (``SetupLevel.A is None``): the
    JAX package's ``GetNDof`` fails there (AttributeError), the port's
    reads the stencil; ``GetBF`` from below it meets the implicit
    transfer and raises the port's ValueError."""
    p = tfem.poisson_3d(72)
    pj, pt = _h1_pair(p, ngs_amg_sm_type="chebyshev")
    assert pt.setup_levels_[1].A is None and pj.setup_levels_[1].A is None
    ndof = [pt.GetNDof(i) for i in range(pt.GetNLevels())]
    assert ndof == list(pt.log_.nvs) == list(pj.log_.nvs)
    with pytest.raises(AttributeError):
        pj.GetNDof(1)
    with pytest.raises(ValueError, match="level 1's prolongation is impl"):
        pt.GetBF(level=2)


def _sym_half_pair(n=13):
    """A symmetric tridiagonal with varying coefficients, stored
    symmetric-half in both packages' DiaMatrix (data[d, i] = A[i, i + o])."""
    rng = np.random.default_rng(2)
    d0, d1 = 4.0 + rng.random(n), -rng.random(n - 1) - 0.5
    T = sp.diags([d1, d0, d1], [-1, 0, 1]).tocsr()
    n_pad = 16
    data = np.zeros((2, n_pad))
    data[0, :n] = d0
    data[1, : n - 1] = d1
    J = jformats.DiaMatrix(data=jnp.asarray(data, jnp.float32),
                           offsets=(0, 1), nrows=n, nrows_pad=n_pad,
                           sym_half=True)
    Tt = tformats.DiaMatrix(data=torch.tensor(data, dtype=torch.float32),
                            offsets=(0, 1), nrows=n, nrows_pad=n_pad,
                            sym_half=True)
    return T, J, Tt


def test_to_sparse_matrix_sym_half_repair():
    """On a symmetric-half DIA the JAX package returns no strict lower
    triangle (and reads the stored upper one shifted); the port returns
    the whole matrix, equal to its own matvec and to the full-storage
    equivalent."""
    T, J, Tt = _sym_half_pair()
    n = T.shape[0]
    Cj = JA.ToSparseMatrix(J)
    assert sp.tril(Cj, -1).nnz == 0 and abs(Cj - Cj.T).max() > 0.5
    C = TA.ToSparseMatrix(Tt)
    T32 = T.astype(np.float32).astype(np.float64)
    assert abs(C - T32).max() == 0.0
    np.testing.assert_array_equal(Cj.diagonal(), C.diagonal())
    v = np.random.default_rng(3).standard_normal(n)
    y = tformats.matvec(
        Tt, tformats.block_vec(v, 1, Tt.nrows_pad, torch.float32)
    )[:n, 0].double().numpy()
    np.testing.assert_allclose(C @ v, y, rtol=1e-5, atol=1e-6)
    full = tformats.dia_from_scipy(T32, np.float32)
    assert abs(TA.ToSparseMatrix(full) - C).max() == 0.0
    with pytest.raises(TypeError):
        TA.ToSparseMatrix(object())


SMOOTHERS = {
    "gs": lambda m, A, kw: m.CreateHybridGSS(A, **kw),
    "jacobi": lambda m, A, kw: m.CreateJacobiSmoother(A, **kw),
    "chebyshev": lambda m, A, kw: m.CreateChebyshevSmoother(A, **kw),
    "dyn_block": lambda m, A, kw: m.CreateDynBlockSmoother(A, **kw),
    "block_gs": lambda m, A, kw: m.CreateHybridBlockGSS(
        A, [np.arange(i, min(i + 5, A.shape[0]))
            for i in range(0, A.shape[0], 5)], **kw),
}


@pytest.mark.parametrize("name", sorted(SMOOTHERS))
def test_standalone_smoothers_match_jax(name):
    p = tfem.poisson_3d(12)
    rng = np.random.default_rng(4)
    x0, b = rng.standard_normal(p.n), rng.standard_normal(p.n)
    sj = SMOOTHERS[name](JA, p.A, {})
    st = SMOOTHERS[name](TA, p.A, CPU)
    for fn in ("Smooth", "SmoothBack"):
        xj = getattr(sj, fn)(x0, b)
        xt = getattr(st, fn)(x0, b)
        assert xt.shape == (p.n,) and xt.dtype == np.float64
        np.testing.assert_allclose(
            xt, xj, rtol=1e-5, atol=1e-5 * np.abs(xj).max()
        )


def _stokes_kw(p):
    return dict(cell_pos=p.cell_pos, cell_vol=p.cell_vol,
                facet_cells=p.facet_cells, facet_flow=p.facet_flow)


def _stokes_api(m, sf, name, o, d):
    """(preconditioner, A, b) of one Stokes class of ``m`` (an api
    module) on a small problem of ``sf`` (its stokes_fem)."""
    if name == "gg_2d":
        p, _normals = sf.stokes_tri(12, dim=2)
        return m.stokes_gg_2d(p.A, **_stokes_kw(p), options=o, **d), p.A, p.b
    if name == "hdiv_gg_2d":
        p, counts, V = sf.stokes_tri_hdiv(10)
        return m.stokes_hdiv_gg_2d(
            p.A, **_stokes_kw(p), facet_dof_counts=counts, preserved=V,
            options=o, **d,
        ), p.A, p.b
    S, b, E, geo = sf.stokes_hdg_p1(8)
    return m.stokes_hdg_gg_2d(S, E, **geo, options=o, **d), S, b


@pytest.mark.parametrize("name", ["gg_2d", "hdg_gg_2d", "hdiv_gg_2d"])
def test_stokes_classes_match_jax(name):
    res = []
    for m, sf, pkg, d in ((JA, jsf, ngsamg_tpu, {}),
                          (TA, tsf, ngsamg_tpu_torch, CPU)):
        o = pkg.AMGOptions()
        o.levels.max_coarse_size = 60
        pc, A, b = _stokes_api(m, sf, name, o, d)
        x, info = pc.solve(b, tol=1e-8, maxiter=300)
        assert info.converged and _relres(A, b, x) <= 1e-8, name
        levels = getattr(pc._pc, "aux", pc._pc).setup_levels_
        res.append((pc.GetNLevels(), [lv.A.shape[0] for lv in levels],
                    info.iterations))
    assert res[1][:2] == res[0][:2], res
    assert abs(res[1][2] - res[0][2]) <= 1, res
    assert pc._pc.device.type == "cpu"
