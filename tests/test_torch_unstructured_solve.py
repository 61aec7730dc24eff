"""The unstructured slice as a whole, and one cycle on carried-over data.

Perturbed-Delaunay P1 Poisson problems solved by both packages'
`AMGPreconditioner(A, coords=..., Chebyshev).solve(b, tol=1e-8)`:
- `unstructured_poisson(16, dim=3, refine=1)`, 32,720 DoF: tile-ELL
  levels, dense coarse levels, tile-ELL transfers, cluster correction;
- `unstructured_poisson(40, dim=2, refine=1)`, 6,241 DoF: the same in 2D;
- `unstructured_poisson(20, dim=3)`, 6,859 DoF: a DIA finest level (K2 on
  the card) under tile-ELL transfers and cluster correction.
Both must reach a true relative residual (host, f64, scipy) <= 1e-8 on a
hierarchy with the same level count and operator complexity, the port
within one PCG iteration of the JAX package, and the solutions within
1e-6 relative. The JAX package runs the host defect-correction loop; the
port packs an f64 twin of the finest level on the first solve and runs the
loop on the device, with no residual on the host.

One V-cycle (cluster correction, f32 tile-ELL cycle, f64 coarse inverse)
on the JAX package's staged hierarchy carried over with
`from_jax_operator` agrees with the JAX cycle to a relative 2-norm error
of 1e-5, with the JAX package's native tile-ELL packer and without it
(then it stages `SupernodeELL` transfers, which the port repacks).
"""

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
from ngsamg_tpu_torch.sparse import formats as tformats
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)

CASES = [(16, 3, 1), (40, 2, 1), (20, 3, 0)]


def _cheb(pkg):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        )
    )


def _true_relres(p, x):
    return float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "n%d_d%d_r%d" % c)
def solved(request):
    n, dim, refine = request.param
    p = fem.unstructured_poisson(n, dim=dim, refine=refine)
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
    return request.param, p, out


def test_both_converge(solved):
    _, p, out = solved
    for name, (_pc, x, info) in out.items():
        assert info.converged, name
        assert x.shape == (p.n,) and x.dtype == np.float64
        assert _true_relres(p, x) <= 1e-8, name
        assert abs(info.relres - _true_relres(p, x)) <= 1e-12


def test_iterations_and_hierarchy_match(solved):
    case, _, out = solved
    (pj, _, ij), (pt, _, it) = out["jax"], out["torch"]
    assert abs(it.iterations - ij.iterations) <= 1
    assert it.outer_iterations == ij.outer_iterations
    assert pt.num_levels == pj.num_levels
    assert pt.operator_complexity == pj.operator_complexity
    # the device refinement loop, on a twin of the finest level's format
    assert type(pt._A64_mixed) is type(pt.A_dev)
    assert it.host_residuals == 0
    assert pt.op.cluster_corr is not None
    kinds = [type(lev.A).__name__ for lev in pt.op.levels]
    assert kinds == [type(lev.A).__name__ for lev in pj.op.levels]
    assert kinds[0] == ("DiaMatrix" if case == (20, 3, 0) else "TileELLStack")


def test_solutions_agree(solved):
    _, _, out = solved
    xj, xt = out["jax"][1], out["torch"][1]
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-6


def test_return_device_gives_host_array(solved):
    """With the finest level's f64 twin the solution stays on the device:
    a float64 tensor of length n in the external order, the host answer of
    ``return_device=False``."""
    _, p, out = solved
    pc, x_host, info = out["torch"]
    x, info2 = pc.solve(p.b, tol=1e-8, return_device=True)
    assert isinstance(x, torch.Tensor)
    assert x.dtype == torch.float64 and x.shape == (p.n,)
    xd = x.numpy()
    assert np.linalg.norm(xd - x_host) <= 1e-12 * np.linalg.norm(x_host)
    assert info2.iterations == info.iterations


def test_apply_is_symmetric_positive(solved):
    """`apply` runs one cluster-corrected V-cycle on the scaled, permuted
    hierarchy: a symmetric positive operator in the user's ordering."""
    _, p, out = solved
    pc = out["torch"][0]
    rng = np.random.default_rng(7)
    u, v = rng.standard_normal(p.n), rng.standard_normal(p.n)
    Mu, Mv = pc.apply(u), pc.apply(v)
    assert Mu.shape == (p.n,) and Mu.dtype == np.float64
    assert abs(u @ Mv - v @ Mu) <= 1e-4 * abs(u @ Mv)
    assert u @ Mu > 0


def test_apply_products_in_full_f32(solved, monkeypatch):
    """`apply` runs every matrix product of the cycle (tile-ELL, cluster,
    dense, coarse inverse) at full f32 precision whatever the caller set,
    and gives the caller's setting back."""
    _, p, out = solved
    pc = out["torch"][0]
    seen = []
    for name in ("bmm", "matmul"):
        def spy(*args, _fn=getattr(torch, name)):
            seen.append(torch.get_float32_matmul_precision())
            return _fn(*args)

        monkeypatch.setattr(torch, name, spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        pc.apply(p.b)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}


def _jax_setup(p, native_packer: bool):
    with pytest.MonkeyPatch.context() as mp:
        if not native_packer:
            mp.setattr(jnative, "tile_ell_pack", lambda *a, **k: None)
        pc = ngsamg_tpu.AMGPreconditioner(
            p.A, coords=p.coords, options=_cheb(ngsamg_tpu)
        ).setup()
    return pc


@pytest.mark.parametrize("native_packer", [True, False])
def test_cycle_on_carried_over_hierarchy(native_packer):
    p = fem.unstructured_poisson(40, dim=2, refine=1)
    pc = _jax_setup(p, native_packer)
    with jax.enable_x64(True):
        op_np = jax.tree_util.tree_map(np.asarray, pc.op)
    opt = from_jax_operator(op_np)
    assert opt.coarse_inv.dtype == torch.float64
    assert opt.cluster_corr is not None
    P0 = pc.op.levels[0].P
    if not native_packer:
        assert type(P0).__name__ == "SupernodeELL"
    for lev in opt.levels[:-1]:
        assert isinstance(lev.P, tformats.TileELL)
        assert isinstance(lev.R, tformats.TileELL)
    A0 = opt.levels[0].A
    b = np.zeros((A0.nrows_pad, 1), dtype=np.float32)
    b[: A0.nrows, 0] = np.random.default_rng(60).standard_normal(A0.nrows)
    with pc._cycle_scope():
        xj = np.asarray(jcycle.amg_apply(pc.op, jnp.asarray(b)))
    xt = tcycle.amg_apply(opt, torch.from_numpy(b)).numpy()
    assert xt.shape == xj.shape and xt.dtype == np.float32
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-5
    np.testing.assert_array_equal(xt[A0.nrows:], 0.0)
