"""Port parity for the W and BS cycles, the stationary AMG iteration and
whole solves on the JAX package's default options.

- The JAX package's staged hierarchy goes through
  ``precond.convert.from_jax_operator``, so both packages run one cycle on
  identical data: W and BS on the default GS hierarchy of
  ``poisson_2d(48)`` and on the lattice hierarchy of ``poisson_3d(24)``
  (Chebyshev, Jacobi, l1-Jacobi), relative 2-norm error <= 1e-5 in f32;
  ``AMGSmoother``; ``amg_iteration`` with equal iteration counts.
- Whole solves through both packages' ``AMGPreconditioner``: defaults
  (multicolor GS, V) on ``poisson_2d(48)``, ``poisson_3d(12)`` and
  ``unstructured_poisson(12, 3)``; W and BS on ``poisson_2d(48)``;
  Jacobi and l1-Jacobi on a lattice and on an unstructured mesh; dyn-block
  GS on ``poisson_2d(32)`` in f64; ``elasticity_3d(4)`` with block GS (both
  packages on their numpy branches, the reference's coloring on its native
  kernel).
  Level sizes and operator complexity equal, iterations within one, true
  relative residual <= tol.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
from ngsamg_tpu.solve import cycle as jcycle
from ngsamg_tpu.solve import pcg as jpcg
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu_torch.precond.convert import from_jax_operator
from ngsamg_tpu_torch.solve import cycle as tcycle
from ngsamg_tpu_torch.solve import pcg as tpcg
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

PROBLEMS = {
    "poisson_2d(48)": lambda: tfem.poisson_2d(48),
    "poisson_2d(32)": lambda: tfem.poisson_2d(32),
    "poisson_3d(12)": lambda: tfem.poisson_3d(12),
    "poisson_3d(24)": lambda: tfem.poisson_3d(24),
    "unstructured_poisson(12, 3)": lambda: tfem.unstructured_poisson(12, 3),
    "elasticity_3d(4)": lambda: tfem.elasticity_3d(4),
}


def _native_color(indptr, indices):
    return np.asarray(
        jnative._nat.greedy_color(*jnative._csr_idx(indptr, indices))
    )


@contextlib.contextmanager
def reference_branches(numpy_setup: bool):
    """Both packages' host setup on their numpy branches when asked, the
    reference's coloring always on its native greedy kernel."""
    if getattr(jnative, "_nat", None) is None:
        pytest.skip("the JAX package's native extension is not built")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "greedy_color", _native_color)
        if numpy_setup:
            mp.setattr(jnative, "HAVE_NATIVE", False)
            mp.setattr(tnative, "HAVE_NATIVE", False)
        yield


def _options(pkg, smoother=None, cycle="V", dtype="float32"):
    opts = pkg.AMGOptions(cycle=pkg.CycleType(cycle), dtype=dtype)
    if smoother is not None:
        opts.smoother = pkg.config.SmootherOptions(
            type=pkg.config.SmootherType(smoother)
        )
    return opts


def _pair(problem, smoother=None, cycle="V", dtype="float32", **kw):
    p = PROBLEMS[problem]()
    numpy_setup = kw.get("energy") == "elasticity"
    with reference_branches(numpy_setup):
        pj = ngsamg_tpu.AMGPreconditioner(
            p.A, coords=p.coords,
            options=_options(ngsamg_tpu, smoother, cycle, dtype), **kw
        ).setup()
        pt = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords,
            options=_options(ngsamg_tpu_torch, smoother, cycle, dtype),
            device="cpu", **kw
        ).setup()
    return p, pj, pt


def _converted(pj):
    with jax.enable_x64(pj._x64_cycle):
        op_np = jax.tree_util.tree_map(np.asarray, pj.op)
    return from_jax_operator(op_np)


def _vec(A, bs, seed):
    v = np.zeros((A.nrows_pad, bs), dtype=np.float32)
    v[: A.nrows] = np.random.default_rng(seed).standard_normal((A.nrows, bs))
    return v


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


APPLY_CASES = [
    ("poisson_2d(48)", None, "W"),
    ("poisson_2d(48)", None, "BS"),
    ("poisson_3d(24)", "chebyshev", "W"),
    ("poisson_3d(24)", "chebyshev", "BS"),
    ("poisson_3d(24)", "jacobi", "V"),
    ("poisson_3d(24)", "l1_jacobi", "BS"),
]


@pytest.mark.parametrize("problem, smoother, cycle", APPLY_CASES)
def test_cycle_apply_matches_jax(problem, smoother, cycle):
    _p, pj, pt = _pair(problem, smoother, cycle)
    opt = _converted(pj)
    assert opt.cycle == cycle
    assert [type(lt.A) for lt in opt.levels] == [
        type(lt.A) for lt in pt.op.levels
    ]
    assert [type(lt.smoother).__name__ for lt in opt.levels] == [
        type(lt.smoother).__name__ for lt in pt.op.levels
    ]
    r = _vec(opt.levels[0].A, 1, 5)
    with jax.enable_x64(pj._x64_cycle):
        yj = np.asarray(jcycle.amg_apply(pj.op, jnp.asarray(r)))
    yt = tcycle.amg_apply(opt, torch.from_numpy(r)).numpy()
    assert _rel(yt, yj) <= 1e-5
    # the port's own staging gives the same cycle
    yp = tcycle.amg_apply(pt.op, torch.from_numpy(r)).numpy()
    assert _rel(yp, yj) <= 1e-5


def test_amg_smoother_matches_jax():
    _p, pj, _pt = _pair("poisson_2d(48)")
    opt = _converted(pj)
    A0j, A0t = pj.op.levels[0].A, opt.levels[0].A
    b = _vec(A0t, 1, 6)
    x0 = _vec(A0t, 1, 7)
    smj = jcycle.AMGSmoother(op=pj.op, steps=2)
    smt = tcycle.AMGSmoother(op=opt, steps=2)
    from ngsamg_tpu.smoothers import core as jcore
    from ngsamg_tpu_torch.smoothers import core as tcore

    for start in (None, x0):
        xj = np.asarray(jcore.smooth(
            smj, A0j, None if start is None else jnp.asarray(start),
            jnp.asarray(b)))
        xs = None if start is None else torch.from_numpy(start)
        xt = tcore.smooth_back(smt, A0t, xs, torch.from_numpy(b)).numpy()
        assert _rel(xt, xj) <= 1e-5


@pytest.mark.parametrize("problem, smoother", [
    ("poisson_3d(12)", None), ("poisson_3d(24)", "chebyshev"),
])
def test_amg_iteration_matches_jax(problem, smoother):
    _p, pj, _pt = _pair(problem, smoother)
    opt = _converted(pj)
    b = _vec(opt.levels[0].A, 1, 8)
    rj = jpcg.amg_iteration(pj.op, pj.op.levels[0].A, jnp.asarray(b),
                            tol=1e-5, maxiter=60)
    rt = tpcg.amg_iteration(opt, opt.levels[0].A, torch.from_numpy(b),
                            tol=1e-5, maxiter=60)
    assert int(rt.iterations) == int(rj.iterations) < 60
    assert float(rt.relres) <= 1e-5
    assert _rel(rt.x.numpy(), np.asarray(rj.x)) <= 1e-4
    z = tpcg.amg_iteration(opt, opt.levels[0].A, torch.zeros_like(
        torch.from_numpy(b)))
    assert int(z.iterations) == 0 and float(z.x.abs().max()) == 0.0


SOLVES = {
    "defaults, poisson_2d(48)": ("poisson_2d(48)", {}),
    "defaults, poisson_3d(12)": ("poisson_3d(12)", {}),
    "defaults, unstructured_poisson(12, 3)":
        ("unstructured_poisson(12, 3)", {}),
    "W, poisson_2d(48)": ("poisson_2d(48)", {"cycle": "W"}),
    "BS, poisson_2d(48)": ("poisson_2d(48)", {"cycle": "BS"}),
    "jacobi, poisson_3d(24)": ("poisson_3d(24)", {"smoother": "jacobi"}),
    "l1_jacobi, poisson_3d(24)":
        ("poisson_3d(24)", {"smoother": "l1_jacobi"}),
    "jacobi, unstructured_poisson(12, 3)":
        ("unstructured_poisson(12, 3)", {"smoother": "jacobi"}),
    "l1_jacobi, unstructured_poisson(12, 3)":
        ("unstructured_poisson(12, 3)", {"smoother": "l1_jacobi"}),
    "dyn_bgs f64, poisson_2d(32)":
        ("poisson_2d(32)", {"smoother": "dyn_bgs", "dtype": "float64"}),
    "gs, elasticity_3d(4)":
        ("elasticity_3d(4)", {"energy": "elasticity", "block_size": 3}),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_matches_jax(case):
    problem, kw = SOLVES[case]
    p, pj, pt = _pair(problem, **kw)
    assert list(pt.log_.nvs) == list(pj.log_.nvs)
    assert pt.operator_complexity == pytest.approx(
        pj.operator_complexity, rel=1e-12)
    smj = [type(lv.smoother).__name__ for lv in pj.op.levels]
    assert [type(lv.smoother).__name__ for lv in pt.op.levels] == smj
    if kw.get("smoother") in (None, "gs"):
        assert smj[0] == "GSSmoother"
        assert [len(lv.smoother.color_bounds) for lv in pt.op.levels[:-1]] \
            == [len(lv.smoother.color_bounds) for lv in pj.op.levels[:-1]]
    xj, ij = pj.solve(p.b, tol=1e-8, maxiter=60)
    xt, it = pt.solve(p.b, tol=1e-8, maxiter=60)
    rel = np.linalg.norm(p.b - p.A @ xt) / np.linalg.norm(p.b)
    assert it.converged and rel <= 1e-8, (it, rel)
    assert abs(it.iterations - ij.iterations) <= 1, (
        it.iterations, ij.iterations)
    assert np.linalg.norm(xt - xj) <= 1e-6 * np.linalg.norm(xj)
