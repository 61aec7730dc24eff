"""Port parity for the self-tests of ``AMGPreconditioner``.

``test`` (eigenvalue bounds of M^-1 A by preconditioned Lanczos, in the
external space), ``test_levels`` (the bounds of every tail hierarchy on
its level's own matvec) and ``test_smoothers`` (the energy reduction of
symmetric sweeps per level) run on the same hierarchy in the JAX package
and in ngsamg_tpu_torch (``device="cpu"``), from the same seeds
(``default_rng(0)``, ``default_rng(l)``, ``default_rng(i)``). Bounds and
rates agree to 1e-6 relative under ``dtype="float64"`` and to 1e-2 under
f32 (the two packages round the f32 cycle differently). The cases mirror
the JAX package's ``test_h1.py::test_eig_bounds``,
``test_elasticity.py::test_elast_eig_bounds`` and
``test_frontend.py::test_per_level_two_grid_bounds``, with their bands;
``test`` in the external space of a partial-Dirichlet problem, and
``options.do_test``, besides. Both packages set up on the numpy branches
of their host setup (the JAX package's coloring on its native greedy
kernel).
"""

import contextlib

import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.native as jnative
import ngsamg_tpu_torch
import ngsamg_tpu_torch.native as tnative
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

TOL = {"float64": 1e-6, "float32": 1e-2}


def _native_color(indptr, indices):
    return np.asarray(
        jnative._nat.greedy_color(*jnative._csr_idx(indptr, indices))
    )


@contextlib.contextmanager
def numpy_branches():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "HAVE_NATIVE", False)
        mp.setattr(tnative, "HAVE_NATIVE", False)
        if getattr(jnative, "_nat", None) is not None:
            mp.setattr(jnative, "greedy_color", _native_color)
        yield


PROBLEMS = {
    # test_h1.py::test_eig_bounds: the default options (multicolor GS)
    "h1-2d": (lambda: tfem.poisson_2d(48), {}, None),
    # test_elasticity.py::test_elast_eig_bounds
    "elast-2d": (lambda: tfem.elasticity_2d(10, length=10),
                 dict(energy="elasticity", block_size=2), 60),
    # test_frontend.py::test_per_level_two_grid_bounds
    "h1-3d": (lambda: tfem.poisson_3d(12), {}, None),
}
SETUPS = [(name, dt) for name in PROBLEMS for dt in ("float64", "float32")]


def _build(name, dtype, **extra):
    make, kw, max_coarse = PROBLEMS[name]
    p = make()
    pcs = []
    for pkg, dev in ((ngsamg_tpu, {}), (ngsamg_tpu_torch, {"device": "cpu"})):
        opts = pkg.AMGOptions(dtype=dtype, **extra)
        if max_coarse is not None:
            opts.levels.max_coarse_size = max_coarse
        with numpy_branches():
            pcs.append(pkg.AMGPreconditioner(
                p.A, coords=p.coords, options=opts, **kw, **dev).setup())
    return p, *pcs


@pytest.fixture(scope="module", params=SETUPS, ids=lambda s: f"{s[0]}-{s[1]}")
def setup(request):
    name, dtype = request.param
    _p, pj, pt = _build(name, dtype)
    assert pt.log_.nvs == pj.log_.nvs
    return name, dtype, pj, pt


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=tol, atol=0)


def test_eig_bounds_match_jax(setup):
    name, dtype, pj, pt = setup
    lj, lt = pj.test(40), pt.test(40)
    _close(lt, lj, TOL[dtype])
    lmin, lmax = lt
    assert lmax < 1.05
    assert lmin > (0.02 if name == "elast-2d" else 0.05)
    assert lmax / max(lmin, 1e-12) < 50.0


def test_level_bounds_match_jax(setup):
    name, dtype, pj, pt = setup
    bj, bt = pj.test_levels(iters=25), pt.test_levels(iters=25)
    assert len(bt) == len(bj) == pt.num_levels
    _close(bt, bj, TOL[dtype])
    if name == "h1-3d":  # the JAX package's own band
        for lo, hi in bt:
            assert 0.15 < lo <= hi < 1.3, bt


def test_smoother_rates_match_jax(setup):
    _name, dtype, pj, pt = setup
    rj, rt = pj.test_smoothers(4), pt.test_smoothers(4)
    assert len(rt) == len(rj) == sum(
        lev.smoother is not None for lev in pt.op.levels)
    _close(rt, rj, TOL[dtype])
    assert all(0 <= r < 1 for r in rt), rt


def test_eig_bounds_external_space():
    """``test`` on a partial-Dirichlet problem: the Lanczos vectors live in
    the free-DOF space (``apply`` and ``matvec_free`` contract and expand),
    and the bounds are the JAX package's."""
    p = tfem.elasticity_2d(8, length=6)
    fd = np.ones(p.n, dtype=bool)
    fixed_v = np.random.default_rng(0).choice(p.n // 2, 10, replace=False)
    fd[fixed_v * 2 + 1] = False
    pcs = []
    for pkg, dev in ((ngsamg_tpu, {}), (ngsamg_tpu_torch, {"device": "cpu"})):
        opts = pkg.AMGOptions(dtype="float64")
        opts.levels.max_coarse_size = 60
        with numpy_branches():
            pcs.append(pkg.AMGPreconditioner(
                p.A, energy="elasticity", block_size=2, coords=p.coords,
                freedofs=fd, options=opts, **dev).setup())
    pj, pt = pcs
    assert pt._ext_free is not None and len(pt._ext_free) == fd.sum()
    lj, lt = pj.test(30), pt.test(30)
    _close(lt, lj, TOL["float64"])
    assert lt[1] < 1.1 and lt[0] > 0.01


@pytest.mark.parametrize("cheb", [False, True])
def test_do_test_prints_the_bounds(cheb, capsys):
    """``options.do_test`` runs ``test()`` at the end of ``setup()`` and
    prints the bounds; they are the ones ``test()`` returns, and the JAX
    package's."""
    p = tfem.poisson_3d(12)
    outs = []
    for pkg, dev in ((ngsamg_tpu, {}), (ngsamg_tpu_torch, {"device": "cpu"})):
        opts = pkg.AMGOptions(dtype="float64", do_test=True)
        if cheb:
            opts.smoother = pkg.config.SmootherOptions(
                type=pkg.config.SmootherType.CHEBYSHEV)
        with numpy_branches():
            pc = pkg.AMGPreconditioner(p.A, coords=p.coords, options=opts,
                                       **dev).setup()
        line = capsys.readouterr().out.strip().splitlines()[-1]
        outs.append((pc, line))
    (pj, line_j), (pt, line_t) = outs
    lmin, lmax = pt.test()
    assert line_t == f"eigenvalue bounds of M^-1 A: [{lmin:.4g}, {lmax:.4g}]"
    assert line_t == line_j
    _close((lmin, lmax), pj.test(), TOL["float64"])
