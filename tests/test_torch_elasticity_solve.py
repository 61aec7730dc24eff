"""The elasticity slice as a whole: one cycle, `solve` and `solve(mixed=True)`.

`elasticity_2d(10, length=10)` (2,200 DoF), `elasticity_3d(8)` (19,440 DoF:
a `BlockELL` finest level of 3x3 blocks under 3x6 / 6x3 block transfers)
and `unstructured_elasticity(8, dim=3)` (1,944 DoF) are set up by both
packages with the Chebyshev smoother, the JAX package on the numpy branches
of its host setup (`ngsamg_tpu.native.HAVE_NATIVE = False`), so both hold
the same hierarchy. Then:
- one V-cycle `apply` on the same vector agrees to rtol 1e-4 (2-norm) in
  f32 and 1e-10 with `dtype="float64"`;
- `solve(tol=1e-8)` (defect correction) and `solve(tol=1e-8, mixed=True)`
  (the mixed-precision PCG) converge to a true relative residual (host,
  f64, scipy) <= 1e-8 within one iteration of the JAX count, the mixed
  solve with the same number of restarts, and `_A64_mixed` is of the finest
  operator's own type;
- the JAX package's staged operator carried over by `from_jax_operator`
  gives the port's `amg_apply` the JAX cycle's output.
Against the JAX package with its native kernels only the level count, the
operator complexity (2%) and the mixed solve's iteration count (within one)
are compared.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
from ngsamg_tpu.solve import cycle as jcycle
from ngsamg_tpu_torch.precond.convert import from_jax_operator
from ngsamg_tpu_torch.solve import cycle as tcycle
from ngsamg_tpu_torch.sparse import bell as tbell
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)

F32_ULP = 2.0 ** -23
CASES = {
    "el2d": lambda: fem.elasticity_2d(10, length=10),
    "el3d8": lambda: fem.elasticity_3d(8),
    "unstr3d": lambda: fem.unstructured_elasticity(8, dim=3),
}


@contextlib.contextmanager
def numpy_branches():
    old = jnative.HAVE_NATIVE
    jnative.HAVE_NATIVE = False
    try:
        yield
    finally:
        jnative.HAVE_NATIVE = old


def _cheb(pkg, **kw):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        ),
        **kw,
    )


def _setup(pkg, p, opts=None, **kw):
    return pkg.AMGPreconditioner(
        p.A, energy="elasticity", block_size=p.block_size, coords=p.coords,
        options=_cheb(pkg) if opts is None else opts, **kw
    ).setup()


def _true_relres(p, x):
    return float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    p = CASES[request.param]()
    with numpy_branches():
        pj = _setup(ngsamg_tpu, p)
    pt = _setup(ngsamg_tpu_torch, p, device="cpu")
    return request.param, p, pj, pt


def test_same_hierarchy(pair):
    name, _, pj, pt = pair
    assert pt.log_.nvs == pj.log_.nvs and pt.log_.nnzs == pj.log_.nnzs
    kinds = [type(lev.A).__name__ for lev in pt.op.levels]
    assert kinds == [type(lev.A).__name__ for lev in pj.op.levels]
    assert kinds[0] == ("BlockELL" if name == "el3d8" else "DenseMatrix")
    for lj, lt in zip(pj.op.levels, pt.op.levels):
        for Tj, Tt in ((lj.A, lt.A), (lj.P, lt.P), (lj.R, lt.R)):
            if not isinstance(Tt, tbell.BlockELL):
                continue
            dj = np.asarray(Tj.data)
            assert Tt.data.shape == dj.shape
            np.testing.assert_array_equal(Tt.cols.numpy(), np.asarray(Tj.cols))
            assert np.abs(Tt.data.numpy() - dj).max() <= (
                F32_ULP * np.abs(dj).max()
            )
    P0 = pt.op.levels[0].P
    dim, dpv = pt.setup_levels_[0].row_bs, pt.energy.dpv
    assert P0.block_shape == (dim, dpv)
    assert pt.op.levels[0].R.block_shape == (dpv, dim)


def test_one_cycle_f32(pair):
    _, p, pj, pt = pair
    r = np.random.default_rng(7).standard_normal(p.n)
    zj, zt = pj.apply(r), pt.apply(r)
    assert zt.shape == (p.n,) and zt.dtype == np.float64
    assert np.linalg.norm(zt - zj) <= 1e-4 * np.linalg.norm(zj)


@pytest.mark.parametrize("name", ["el2d", "unstr3d"])
def test_one_cycle_f64(name):
    p = CASES[name]()
    with numpy_branches():
        pj = _setup(ngsamg_tpu, p, _cheb(ngsamg_tpu, dtype="float64"))
    pt = _setup(ngsamg_tpu_torch, p, _cheb(ngsamg_tpu_torch, dtype="float64"),
                device="cpu")
    assert pt._scale0 is None  # no scaling in f64
    r = np.random.default_rng(8).standard_normal(p.n)
    zj, zt = pj.apply(r), pt.apply(r)
    assert np.linalg.norm(zt - zj) <= 1e-10 * np.linalg.norm(zj)
    xj, ij = pj.solve(p.b, tol=1e-8)
    xt, it = pt.solve(p.b, tol=1e-8)
    assert it.converged and abs(it.iterations - ij.iterations) <= 1
    assert _true_relres(p, xt) <= 1e-8


@pytest.mark.parametrize("mixed", [None, True], ids=["defect", "mixed"])
def test_solve_matches(pair, mixed):
    _, p, pj, pt = pair
    xj, ij = pj.solve(p.b, tol=1e-8, mixed=mixed)
    xt, it = pt.solve(p.b, tol=1e-8, mixed=mixed)
    assert it.converged and ij.converged
    assert xt.shape == (p.n,) and xt.dtype == np.float64
    assert _true_relres(p, xt) <= 1e-8
    assert abs(it.relres - _true_relres(p, xt)) <= 1e-3 * it.relres
    assert abs(it.iterations - ij.iterations) <= 1
    assert it.outer_iterations == ij.outer_iterations
    assert np.linalg.norm(xt - xj) <= 1e-6 * np.linalg.norm(xj)
    if mixed:
        assert type(pt._A64_mixed) is type(pt.A_dev)
        assert type(pj._A64_mixed).__name__ == type(pt._A64_mixed).__name__
        assert pt._A64_mixed.data.dtype == torch.float64
        assert pt._A64_mixed.nrows_pad == pt.A_dev.nrows_pad
        assert len(it.history) == it.outer_iterations


def test_native_run_iterations(pair):
    """Against the JAX package's native setup kernels: the same level count
    and, for the mixed solve, iterations within one. (Its defect-correction
    count is not compared: on `elasticity_3d(8)` the JAX package itself
    takes 34 iterations on its native hierarchy and 37 on its numpy one.)"""
    _, p, _, pt = pair
    pn = _setup(ngsamg_tpu, p)
    assert pn.num_levels == pt.num_levels
    assert abs(pt.operator_complexity / pn.operator_complexity - 1) <= 0.02
    _xj, ij = pn.solve(p.b, tol=1e-8, mixed=True)
    _xt, it = pt.solve(p.b, tol=1e-8, mixed=True)
    assert abs(it.iterations - ij.iterations) <= 1


def test_carried_over_operator_runs_the_jax_cycle(pair):
    """`from_jax_operator` carries BlockELL levels, block transfers and
    block Dinv; the port's cycle on them gives the JAX cycle's output."""
    _, p, pj, _ = pair
    with jax.enable_x64(True):
        op_np = jax.tree_util.tree_map(np.asarray, pj.op)
    op_t = from_jax_operator(op_np)
    kinds = {type(lev.A).__name__ for lev in op_t.levels}
    assert kinds <= {"BlockELL", "DenseMatrix"}
    assert all(isinstance(lev.P, tbell.BlockELL) for lev in op_t.levels[:-1])
    assert op_t.coarse_inv.dtype == torch.float64
    bs = p.block_size
    A0 = op_t.levels[0].A
    r = np.random.default_rng(9).standard_normal((A0.nrows, bs))
    rp = np.zeros((A0.nrows_pad, bs), dtype=np.float32)
    rp[: A0.nrows] = r
    zt = tcycle.amg_apply(op_t, torch.from_numpy(rp)).numpy()
    with pj._cycle_scope():
        zj = np.asarray(jcycle.amg_apply(pj.op, jnp.asarray(rp)))
    assert zt.shape == zj.shape
    assert np.linalg.norm(zt - zj) <= 1e-5 * np.linalg.norm(zj)


def test_mixed_on_zero_rhs_and_budget(pair):
    _, p, _, pt = pair
    x, info = pt.solve(np.zeros(p.n), mixed=True)
    assert not x.any() and info.iterations == 0
    x, info = pt.solve(p.b, tol=1e-8, maxiter=2, mixed=True)
    assert info.iterations == 2 and not info.converged
    assert info.relres > 1e-8 and np.isfinite(x).all()
