"""Port parity for vector-valued H1, the big-SOC check and the plate
coarsener.

- `vector_poisson(poisson_2d(32), bs)` for bs 2 and 3 (identity-block
  energies: `H1Energy(bs)`, `block_size > 1`) through both packages'
  `AMGPreconditioner(...).setup()` and both solves. Both packages run
  their native kernels here (the port its own build): `v2agg`, level
  sizes and nnz are compared exactly, P and coarse A to 1e-12.
- `coarsen.big_soc` on a block problem (`elasticity_2d(10, length=10)`)
  with both packages on their numpy branches: exactly; and on a scalar
  H1 problem, whose energy has no aux diagonal: both packages raise the
  same `AttributeError`.
- `coarsen.algo = PLATE` on `thin_plate_elasticity(n=10)`: one aggregate
  per (x, y) column in both packages.
Iteration counts within one of the JAX count, true relres <= 1e-8.
"""

import contextlib

import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu.apps.h1 import H1Energy as JH1
from ngsamg_tpu_torch.apps.h1 import H1Energy as TH1
from ngsamg_tpu_torch.coarsen import pairwise as tpw
from ngsamg_tpu_torch.sparse import formats as tformats
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)


@contextlib.contextmanager
def numpy_branches():
    """Both packages on the numpy branches of their host setup."""
    old = jnative.HAVE_NATIVE, tnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = tnative.HAVE_NATIVE = False
    try:
        yield
    finally:
        jnative.HAVE_NATIVE, tnative.HAVE_NATIVE = old


def _opts(pkg, **coarsen):
    o = pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        )
    )
    if coarsen:
        o = o.replace(coarsen=pkg.config.CoarsenOptions(**coarsen))
    return o


def _both(p, energy, coarsen=None, native=True):
    ctx = contextlib.nullcontext() if native else numpy_branches()
    with ctx:
        pj = ngsamg_tpu.AMGPreconditioner(
            p.A, energy=energy, block_size=p.block_size, coords=p.coords,
            options=_opts(ngsamg_tpu, **(coarsen or {})),
        ).setup()
        pt = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, energy=energy, block_size=p.block_size, coords=p.coords,
            options=_opts(ngsamg_tpu_torch, **(coarsen or {})),
            device="cpu",
        ).setup()
    return pj, pt


def _true_relres(p, x):
    return float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))


def _same_hierarchy(pj, pt, exact_nnz=True):
    assert pt.log_.nvs == pj.log_.nvs
    if exact_nnz:
        assert pt.log_.nnzs == pj.log_.nnzs
    for lj, lt in zip(pj.setup_levels_, pt.setup_levels_):
        assert lt.row_bs == lj.row_bs
        if lj.v2agg is not None:
            np.testing.assert_array_equal(lt.v2agg, lj.v2agg)
        if lj.P is not None:
            Pj, Pt = lj.P.tocsr(), lt.P.tocsr()
            assert abs(Pt - Pj).max() <= 1e-12 * abs(Pj).max()
        if exact_nnz:
            assert abs(lt.A - lj.A).max() <= 1e-12 * abs(lj.A).max()


def _same_solves(p, pj, pt):
    for mixed in (None, True):
        _xj, ij = pj.solve(p.b, tol=1e-8, mixed=mixed)
        xt, it = pt.solve(p.b, tol=1e-8, mixed=mixed)
        assert it.converged and _true_relres(p, xt) <= 1e-8, mixed
        assert abs(it.iterations - ij.iterations) <= 1, mixed


@pytest.fixture(scope="module", params=[2, 3], ids=["bs2", "bs3"])
def vec(request):
    p = fem.vector_poisson(fem.poisson_2d(32), request.param)
    return request.param, p, _both(p, "h1")


def test_vector_h1_finest_mesh(vec):
    bs, p, _ = vec
    mj = JH1(bs).build_finest_mesh(p.A.tocsr().copy(), p.coords)
    mt = TH1(bs).build_finest_mesh(p.A.tocsr().copy(), p.coords)
    assert mt.nv == mj.nv == p.n // bs
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(mt.edge_data["wt"], mj.edge_data["wt"])
    np.testing.assert_array_equal(mt.vertex_data["diag"], mj.vertex_data["diag"])
    np.testing.assert_allclose(
        mt.vertex_data["l2wt"], mj.vertex_data["l2wt"], rtol=0,
        atol=1e-12 * mj.vertex_data["diag"].max(),
    )
    Rt, Rj = TH1(bs).replacement_matrix(mt), JH1(bs).replacement_matrix(mj)
    assert Rt.format == Rj.format == "bsr" and Rt.shape == (p.n, p.n)
    assert abs(Rt - Rj).max() <= 1e-12 * abs(Rj).max()
    Q = TH1(bs).transport(None, np.zeros((4, 0)))
    np.testing.assert_array_equal(Q, np.broadcast_to(np.eye(bs), (4, bs, bs)))


def test_vector_h1_hierarchy(vec):
    bs, _, (pj, pt) = vec
    assert pt.num_levels == pj.num_levels >= 2
    _same_hierarchy(pj, pt)
    assert pt.operator_complexity == pj.operator_complexity
    assert pt.setup_levels_[0].row_bs == bs
    kinds = [type(lev.A).__name__ for lev in pt.op.levels]
    assert kinds == [type(lev.A).__name__ for lev in pj.op.levels]
    for lj, lt in zip(pj.op.levels, pt.op.levels):
        if lt.P is not None:
            assert lt.P.block_shape == (bs, bs) == lt.R.block_shape
            np.testing.assert_array_equal(
                lt.P.cols.numpy(), np.asarray(lj.P.cols)
            )


def test_vector_h1_solves(vec):
    _, p, (pj, pt) = vec
    _same_solves(p, pj, pt)
    assert isinstance(pt._A64_mixed, tformats.DenseMatrix)


def test_vector_h1_components_decouple(vec):
    """A block problem made of identical scalar ones: every component of
    one cycle's output equals the cycle applied to that component."""
    bs, p, (_, pt) = vec
    r = np.zeros(p.n)
    r[0::bs] = np.random.default_rng(0).standard_normal(p.n // bs)
    z = pt.apply(r)
    assert np.abs(z[0::bs]).max() > 0
    for c in range(1, bs):
        assert np.abs(z[c::bs]).max() <= 1e-6 * np.abs(z[0::bs]).max()


def test_big_soc_block_problem():
    p = fem.elasticity_2d(10, length=10)
    pj, pt = _both(p, "elasticity", {"big_soc": True}, native=False)
    _same_hierarchy(pj, pt)
    _same_solves(p, pj, pt)


def test_big_soc_rejects_an_unstable_pair():
    """`big_soc_vet` un-matches a pair whose union is not rho-dominated and
    keeps one that is; unions of fewer than 3 members pass."""
    import ngsamg_tpu.coarsen.pairwise as jpw
    from ngsamg_tpu.apps.elasticity import ElasticityEnergy as JEl
    from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy as TEl

    p = fem.elasticity_2d(6, length=6)
    et, ej = TEl(2), JEl(2)
    with numpy_branches():
        mt = et.build_finest_mesh(p.A, p.coords)
        mj = ej.build_finest_mesh(p.A, p.coords)
        v2c_j, n1 = jpw.spw_aggregate_energy(
            ej, mj, rounds=1, adopt_orphans=False)
        v2c_t, n1t = tpw.spw_aggregate_energy(
            et, mt, rounds=1, adopt_orphans=False)
    np.testing.assert_array_equal(v2c_t, v2c_j)
    # pair up neighbouring aggregates 0-1, 2-3, ... and vet them
    partner = np.full(n1, -1, dtype=np.int64)
    partner[0: n1 - n1 % 2: 2] = np.arange(1, n1, 2)[: n1 // 2]
    partner[1: n1: 2] = np.arange(0, n1 - 1, 2)[: n1 // 2]
    for rho in (0.05, 5.0):
        with numpy_branches():
            out_j = jpw.big_soc_vet(ej, mj, v2c_j, partner, rho)
            out_t = tpw.big_soc_vet(et, mt, v2c_t, partner, rho)
        np.testing.assert_array_equal(out_t, out_j)
    assert (out_t == -1).sum() > (partner == -1).sum()  # rho 5 rejects some


def test_big_soc_scalar_problem_raises_as_in_jax():
    """The scalar H1 energy has no aux diagonal for the check to read:
    both packages raise the same AttributeError (the JAX package's
    behaviour, kept; `big_soc` serves the block energies)."""
    p = fem.poisson_2d(24, jump=True)
    for pkg, kw in ((ngsamg_tpu, {}), (ngsamg_tpu_torch, {"device": "cpu"})):
        with pytest.raises(AttributeError, match="aux_diagonal"):
            pkg.AMGPreconditioner(
                p.A, coords=p.coords,
                options=_opts(pkg, big_soc=True, algo="spw"), **kw
            ).setup()


def test_plate_coarsener_on_thin_plate():
    p = fem.thin_plate_elasticity(n=10)
    pj, pt = _both(p, "elasticity", {"algo": "plate"}, native=False)
    _same_hierarchy(pj, pt)
    lt = pt.setup_levels_[0]
    if lt.v2agg is not None:
        pos = lt.mesh.vertex_data["pos"]
        for a in np.unique(lt.v2agg):
            col = pos[lt.v2agg == a][:, :2]
            assert np.ptp(col, axis=0).max() <= 1e-8  # one (x, y) column
    xj, ij = pj.solve(p.b, tol=1e-8, mixed=True)
    xt, it = pt.solve(p.b, tol=1e-8, mixed=True)
    assert it.converged and _true_relres(p, xt) <= 1e-8
    assert abs(it.iterations - ij.iterations) <= 1
    v2agg, n_agg = tpw.plate_test_aggregate(p.coords)
    assert n_agg == len(np.unique(np.round(p.coords[:, :2] * 1e8), axis=0))
