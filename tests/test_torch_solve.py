"""The slice as a whole: `fem.poisson_3d(40)` solved by both packages.

Both `AMGPreconditioner(A, coords=..., Chebyshev).solve(b, tol=1e-8)` runs
must converge to a true relative residual (host, f64, scipy) <= 1e-8, the
port within one PCG iteration of the JAX package (10 today), on a
hierarchy with the same number of levels and operator complexity. At this
size the setup takes the headline's branches: a clamp-compressed stencil
hierarchy with a uniform finest level and device f64 defect correction.
"""

import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu_torch
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)


def _cheb(pkg):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        )
    )


@pytest.fixture(scope="module")
def solved():
    p = fem.poisson_3d(40)
    out = {}
    for name, pkg, kw in (
        ("jax", ngsamg_tpu, {}),
        ("torch", ngsamg_tpu_torch, {"device": "cpu"}),
    ):
        pc = pkg.AMGPreconditioner(
            p.A, coords=p.coords, options=_cheb(pkg), **kw
        ).setup()
        x, info = pc.solve(p.b, tol=1e-8)
        out[name] = (pc, np.asarray(x), info)
    return p, out


def _true_relres(p, x):
    return float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))


def test_both_converge(solved):
    p, out = solved
    for name, (_pc, x, info) in out.items():
        assert info.converged, name
        assert x.shape == (p.n,) and x.dtype == np.float64
        assert _true_relres(p, x) <= 1e-8, name
        assert abs(info.relres - _true_relres(p, x)) <= 1e-10


def test_iterations_and_hierarchy_match(solved):
    _, out = solved
    (pj, _, ij), (pt, _, it) = out["jax"], out["torch"]
    assert abs(it.iterations - ij.iterations) <= 1
    assert it.outer_iterations == ij.outer_iterations
    assert pt.num_levels == pj.num_levels
    assert pt.operator_complexity == pj.operator_complexity


def test_solutions_agree(solved):
    _, out = solved
    xj, xt = out["jax"][1], out["torch"][1]
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-6


def test_return_device_matches_host(solved):
    p, out = solved
    pc, x_host, info = out["torch"]
    x_dev, info_dev = pc.solve(p.b, tol=1e-8, return_device=True)
    assert isinstance(x_dev, torch.Tensor)
    assert x_dev.dtype == torch.float64 and tuple(x_dev.shape) == (p.n,)
    assert x_dev.device == pc.device
    np.testing.assert_array_equal(x_dev.numpy(), x_host)
    assert info_dev.iterations == info.iterations


def test_apply_is_one_cycle(solved):
    """`apply` runs one V-cycle: symmetric positive on random vectors."""
    p, out = solved
    pc = out["torch"][0]
    rng = np.random.default_rng(7)
    u, v = rng.standard_normal(p.n), rng.standard_normal(p.n)
    Mu, Mv = pc.apply(u), pc.apply(v)
    assert Mu.shape == (p.n,) and Mu.dtype == np.float64
    assert abs(u @ Mv - v @ Mu) <= 1e-4 * abs(u @ Mv)
    assert u @ Mu > 0


def test_zero_rhs(solved):
    p, out = solved
    pc = out["torch"][0]
    x, info = pc.solve(np.zeros(p.n))
    assert info.iterations == 0 and not x.any()
