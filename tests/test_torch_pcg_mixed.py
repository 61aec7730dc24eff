"""Port parity for the mixed-precision PCG and the f64 twin it runs on.

- `pcg_mixed` step by step against the JAX `pcg_mixed` on one small staged
  operator (`elasticity_2d(10, length=10)`, the JAX package's hierarchy
  carried over by `from_jax_operator`, so both run identical data), with
  and without `weight`: with an f64 cycle as M the weighted residual norm
  after every step agrees to 1e-6 relative (1e-9 is asked), which holds
  the recurrence itself; with the f32 cycle to 1e-4 relative, the
  tolerance of one f32 cycle of another summation order. The accepted step
  count, and a frozen state once converged.
- The f64 twin of the finest operator for each format family, as
  `tests/test_regressions.py::test_mixed_device_pcg_paths` builds them: a
  DIA finest level, a tile-ELL finest level (`count_diagonals` patched in
  both packages), a uniform stencil (the f64 `StencilDia`), dense and
  block-ELL; every mixed solve within one iteration of the JAX count at a
  true relres <= 1e-8.
- The stagnation fallback on `elasticity_2d(24)` with `max_coarse_size =
  60`, where f32 defect correction stagnates and both packages fall back
  to the mixed PCG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngsamg_tpu
import ngsamg_tpu.sparse.formats as jformats
import ngsamg_tpu_torch
import ngsamg_tpu_torch.sparse.formats as tformats
from ngsamg_tpu.solve import pcg as jpcg
from ngsamg_tpu_torch.precond.convert import from_jax_operator
from ngsamg_tpu_torch.solve import pcg as tpcg
from ngsamg_tpu_torch.utils import fem

torch.set_num_threads(2)


def _cheb(pkg, **kw):
    return pkg.AMGOptions(
        smoother=pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV
        ),
        **kw,
    )


def _true_relres(p, x):
    return float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))


@pytest.fixture(scope="module", params=["float32", "float64"])
def staged(request):
    """The JAX package's staged elasticity operator, its f64 twin and a
    right-hand side, and the same data in the port's types."""
    p = fem.elasticity_2d(10, length=10)
    pj = ngsamg_tpu.AMGPreconditioner(
        p.A, energy="elasticity", block_size=2, coords=p.coords,
        options=_cheb(ngsamg_tpu, dtype=request.param),
    ).setup()
    with jax.enable_x64(True):
        A64j = pj._ensure_A64_mixed()
        op_np = jax.tree_util.tree_map(np.asarray, pj.op)
        A64_np = jax.tree_util.tree_map(np.asarray, A64j)
    op_t = from_jax_operator(op_np)
    A64t = from_jax_operator(
        type(op_np)(levels=(type(op_np.levels[0])(
            A=A64_np, smoother=None, P=None, R=None),),
            coarse_inv=None)
    ).levels[0].A
    n_pad = pj.A_dev.nrows_pad
    # the scaled hierarchy's weight S^-1; a made-up one where the f64
    # hierarchy is unscaled
    s0 = pj._scale0
    if s0 is None:
        s0 = 1.0 / (1.0 + 0.5 * np.sin(np.arange(p.n)))
    b = np.zeros((n_pad, 2))
    b[: p.n // 2] = (p.b * (1.0 if pj._scale0 is None else s0)).reshape(-1, 2)
    w = np.zeros((n_pad, 2))
    w[: p.n // 2] = (1.0 / s0).reshape(-1, 2)
    return pj, A64j, op_t, A64t, b, w, request.param


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weight"])
def test_pcg_mixed_step_by_step(staged, weighted):
    pj, A64j, op_t, A64t, b, w, dt = staged
    rtol = {"float32": 1e-4, "float64": 1e-9}[dt]
    cycle_dt = {"float32": torch.float32, "float64": torch.float64}[dt]
    assert A64t.data.dtype == torch.float64
    bt, wt = torch.from_numpy(b), torch.from_numpy(w)
    wb = b * w if weighted else b
    bnorm2 = float((wb * wb).sum())
    tol_abs2 = 1e-16 * bnorm2
    # compared while both run (the solve reaches 1e-8 in about 9 steps):
    # 5 steps under the f32 cycle, whose rounding differences add up
    checked = {"float32": 5, "float64": 8}[dt]
    steps = 14
    with jax.enable_x64(True), pj._cycle_scope():
        bj, wj = jnp.asarray(b), (jnp.asarray(w) if weighted else 1.0)
        sj = (jnp.zeros_like(bj), bj, jnp.zeros_like(bj),
              jnp.zeros((), jnp.float64), jnp.asarray(bnorm2, jnp.float64),
              jnp.int32(0))
        st = (torch.zeros_like(bt), bt, torch.zeros_like(bt),
              bt.new_zeros(()), torch.tensor(bnorm2, dtype=torch.float64),
              torch.zeros((), dtype=torch.int32))
        tol_t = torch.tensor(tol_abs2, dtype=torch.float64)
        for k in range(steps):
            sj = jpcg._pcg_mixed_chunk(
                pj.op, A64j, sj, jnp.asarray(tol_abs2, jnp.float64), wj,
                chunk=1, cycle_dt=dt,
            )
            st = tpcg._pcg_step(
                op_t, A64t, st, tol_t, cycle_dt=cycle_dt,
                weight=wt if weighted else None,
            )
            if k < checked:
                rnj, rnt = float(sj[4]) ** 0.5, float(st[4]) ** 0.5
                assert abs(rnt - rnj) <= rtol * rnj, (k, rnt, rnj)
                assert int(st[5]) == int(sj[5]) == k + 1
        # both froze before the last step, at the same count or one apart
        assert float(st[4]) <= tol_abs2 and float(sj[4]) <= tol_abs2
        assert int(st[5]) < steps and abs(int(st[5]) - int(sj[5])) <= 1
        xj = np.asarray(sj[0])
    xt = st[0].numpy()
    assert np.linalg.norm(xt - xj) <= 10 * rtol * np.linalg.norm(xj)


def test_pcg_mixed_freezes_and_counts_accepted_steps(staged):
    pj, A64j, op_t, A64t, b, w, dt = staged
    cycle_dt = {"float32": torch.float32, "float64": torch.float64}[dt]
    bt, wt = torch.from_numpy(b), torch.from_numpy(w)
    with jax.enable_x64(True), pj._cycle_scope():
        rj = jpcg.pcg_mixed(pj.op, A64j, jnp.asarray(b), tol=1e-6,
                            maxiter=64, weight=jnp.asarray(w), cycle_dt=dt)
        kj, relj = int(rj.iterations), float(rj.relres)
    rt = tpcg.pcg_mixed(op_t, A64t, bt, tol=1e-6, maxiter=64, weight=wt,
                        cycle_dt=cycle_dt)
    assert abs(int(rt.iterations) - kj) <= 1
    assert float(rt.relres) <= 1e-6 and relj <= 1e-6
    # a converged state stays frozen: another step changes nothing
    wb = b * w
    tol_abs2 = torch.tensor(1e-12 * float((wb * wb).sum()), dtype=torch.float64)
    state = (rt.x, bt - tformats.matvec(A64t, rt.x), torch.zeros_like(bt),
             bt.new_zeros(()), (rt.relres ** 2) * float((wb * wb).sum()),
             rt.iterations)
    again = tpcg._pcg_step(op_t, A64t, state, tol_abs2, cycle_dt=cycle_dt,
                           weight=wt)
    assert int(again[5]) == int(rt.iterations)
    np.testing.assert_array_equal(again[0].numpy(), rt.x.numpy())
    zero = tpcg.pcg_mixed(op_t, A64t, torch.zeros_like(bt), cycle_dt=cycle_dt)
    assert int(zero.iterations) == 0 and not zero.x.any()


def _mixed_pair(p, opts_j=None, opts_t=None, **kw):
    out = []
    for pkg, extra, opts in (
        (ngsamg_tpu, {}, opts_j), (ngsamg_tpu_torch, {"device": "cpu"}, opts_t)
    ):
        pc = pkg.AMGPreconditioner(
            p.A, coords=p.coords,
            options=_cheb(pkg) if opts is None else opts, **kw, **extra
        ).setup()
        x, info = pc.solve(p.b, tol=1e-8, mixed=True)
        out.append((pc, np.asarray(x), info))
    return out


def _check_mixed(p, out, kind):
    (pj, _xj, ij), (pt, xt, it) = out
    assert type(pt.A_dev).__name__ == kind
    assert type(pt._A64_mixed) is type(pt.A_dev)
    assert type(pj._A64_mixed).__name__ == kind
    assert it.converged and _true_relres(p, xt) <= 1e-8
    assert abs(it.iterations - ij.iterations) <= 1
    assert it.outer_iterations == ij.outer_iterations


def test_twin_dia_finest():
    p = fem.unstructured_poisson(12, dim=3)
    out = _mixed_pair(p)
    _check_mixed(p, out, "DiaMatrix")
    twin = out[1][0]._A64_mixed
    assert twin.data.dtype == torch.float64 and not twin.sym_half
    assert twin.offsets == out[1][0].A_dev.offsets


def test_twin_tile_ell_finest(monkeypatch):
    monkeypatch.setattr(jformats, "count_diagonals",
                        lambda A, limit=None: 10 ** 9)
    monkeypatch.setattr(tformats, "count_diagonals",
                        lambda A, limit=None: 10 ** 9)
    p = fem.unstructured_poisson(20, dim=3)
    out = _mixed_pair(p)
    _check_mixed(p, out, "TileELLStack")
    twin, A32 = out[1][0]._A64_mixed, out[1][0].A_dev
    assert len(twin.blocks) == len(A32.blocks)
    for b64, b32 in zip(twin.blocks, A32.blocks):
        assert b64.data.dtype == torch.float64
        np.testing.assert_array_equal(b64.cols.numpy(), b32.cols.numpy())


def test_twin_uniform_stencil():
    p = fem.poisson_3d(34)  # 35,937 DoF: a uniform clipped stencil
    out = _mixed_pair(p)
    _check_mixed(p, out, "StencilDia")
    pt = out[1][0]
    assert pt._A64_mixed is pt._A64_dev
    assert pt._A64_mixed.vals.dtype == torch.float64


def test_twin_block_ell_and_dense():
    p = fem.elasticity_3d(8)
    kw = dict(energy="elasticity", block_size=3)
    out = _mixed_pair(p, **kw)
    _check_mixed(p, out, "BlockELL")
    q = fem.elasticity_2d(8, length=8)
    out = _mixed_pair(q, energy="elasticity", block_size=2)
    _check_mixed(q, out, "DenseMatrix")
    assert out[1][0]._A64_mixed.data.dtype == torch.float64


def test_host_outer_loop_when_no_twin_fits(monkeypatch):
    """Without an f64 twin the mixed PCG runs with host Krylov vectors."""
    p = fem.elasticity_2d(8, length=8)
    pt = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy="elasticity", block_size=2, coords=p.coords,
        options=_cheb(ngsamg_tpu_torch), device="cpu",
    ).setup()
    pj = ngsamg_tpu.AMGPreconditioner(
        p.A, energy="elasticity", block_size=2, coords=p.coords,
        options=_cheb(ngsamg_tpu),
    ).setup()
    monkeypatch.setattr(pt, "_ensure_A64_mixed", lambda: None)
    monkeypatch.setattr(pj, "_ensure_A64_mixed", lambda: None)
    xt, it = pt.solve(p.b, tol=1e-8, mixed=True)
    _xj, ij = pj.solve(p.b, tol=1e-8, mixed=True)
    assert it.converged and _true_relres(p, xt) <= 1e-8
    assert abs(it.iterations - ij.iterations) <= 1
    assert it.outer_iterations == 1 and len(it.history) == it.iterations


def test_stagnation_falls_back_to_mixed():
    """`elasticity_2d(24)`, f32, max_coarse_size 60: defect correction
    stagnates and the mixed PCG finishes the solve, in both packages."""
    p = fem.elasticity_2d(24)
    res = []
    for pkg, extra in ((ngsamg_tpu, {}), (ngsamg_tpu_torch, {"device": "cpu"})):
        o = _cheb(pkg, dtype="float32")
        o.levels.max_coarse_size = 60
        pc = pkg.AMGPreconditioner(
            p.A, energy="elasticity", block_size=2, coords=p.coords,
            options=o, **extra
        ).setup()
        x, info = pc.solve(p.b, tol=1e-8, maxiter=80)
        res.append((pc, np.asarray(x), info))
    (pj, _xj, ij), (pt, xt, it) = res
    assert pt.num_levels == pj.num_levels
    assert it.converged and _true_relres(p, xt) <= 1e-8
    # the fallback ran: the history holds the stagnated passes and then
    # the mixed solve's verified residuals
    assert pt._A64_mixed is not None and pj._A64_mixed is not None
    assert it.outer_iterations == ij.outer_iterations
    assert abs(it.iterations - ij.iterations) <= 1
    assert max(it.history[1:-1]) > 0.5 * min(it.history[:-2])
