"""The port's multicolour Gauss-Seidel held to the definition of the sweep.

``benchmark/reference/gs_sweep.py`` gives the forward and backward sweep
by their definition, ``x <- x + (D + L)^{-1} (b - A x)`` and ``x <- x +
(D + U)^{-1} (b - A x)`` on the colour-sorted matrix, in plain float64
torch (``dense_sweep``), and colour by colour (``blocked_sweep``), which
equals it only for a valid colouring. Here:

- the port's ``smooth``/``smooth_back`` on staged float64 ``GSSmoother``s
  equal ``dense_sweep`` at rtol 1e-12, in both storage modes, with one
  and two steps, from zero and from a nonzero ``x``;
- ``blocked_sweep`` equals ``dense_sweep`` on valid colourings and refuses
  a colouring that puts two coupled rows in one colour;
- ``AMGOptions()`` with ``sm_type`` ``gs`` solves a small 3D Poisson
  problem to the dense solution.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu_torch
import ngsamg_tpu_torch.smoothers.build as tbuild
import ngsamg_tpu_torch.smoothers.core as tcore
import ngsamg_tpu_torch.sparse.bell as tbell
from benchmark.reference import gs_sweep
from ngsamg_tpu_torch.config import options_from_flags
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)


def _random_spd(n=120, seed=5):
    """A seeded sparse SPD matrix: a random symmetric pattern made
    diagonally dominant."""
    S = sp.random(n, n, density=0.05, random_state=seed, format="csr")
    S = S + S.T
    d = np.asarray(abs(S).sum(axis=1)).ravel() + 1.0
    return (S + sp.diags(d)).tocsr()


MATRICES = {
    "poisson_3d_9": lambda: sp.csr_matrix(tfem.poisson_3d(9).A),
    "random_spd": _random_spd,
}


def _colour_sorted(name):
    """The matrix permuted by the port's GS row order, and the colour
    bounds."""
    A = MATRICES[name]()
    opts = ngsamg_tpu_torch.SmootherOptions()
    perm, bounds = tbuild.plan_row_order(A, 1, opts, 0)
    return A[perm][:, perm].tocsr(), bounds


def _staged(A, bounds, split, steps):
    """A float64 GS smoother of ``A`` as the port stages it on the CPU,
    with its level's block-ELL operator."""
    opts = ngsamg_tpu_torch.SmootherOptions(
        steps=ngsamg_tpu_torch.SpecOpt(steps))
    At = tbell.from_scipy(A, 1, 1, dtype=np.float64)
    ell = (At.data.numpy(), At.cols.numpy()) if split else None
    sm = tbuild.build_smoother(A, 1, opts, 0, At.nrows_pad, np.float64,
                               color_bounds=bounds, ell=ell)
    return tbuild.stage_smoother(sm, "cpu"), At


def _vec(v, n_pad):
    out = torch.zeros((n_pad, 1), dtype=torch.float64)
    out[: len(v), 0] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("split", [True, False], ids=["split", "sliced"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_port_sweeps_are_the_definition(name, split, steps, start):
    A, bounds = _colour_sorted(name)
    sm, At = _staged(A, bounds, split, steps)
    assert bool(sm.cdata) == split and sm.steps == steps
    n = A.shape[0]
    rng = np.random.default_rng(11)
    b = rng.standard_normal(n)
    x0 = None if start == "zero" else rng.standard_normal(n)
    Ad = A.toarray()
    bt = _vec(b, At.nrows_pad)
    xt = None if x0 is None else _vec(x0, At.nrows_pad)
    fwd = tcore.smooth(sm, At, xt, bt)
    ref = gs_sweep.dense_sweep(Ad, x0, b, steps=steps)
    np.testing.assert_allclose(fwd[:n, 0].numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * ref.abs().max().item())
    back = tcore.smooth_back(sm, At, fwd, bt)
    ref_back = gs_sweep.dense_sweep(Ad, ref, b, reverse=True, steps=steps)
    np.testing.assert_allclose(back[:n, 0].numpy(), ref_back.numpy(),
                               rtol=1e-12,
                               atol=1e-12 * ref_back.abs().max().item())
    assert torch.all(back[n:] == 0)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_blocked_sweep_is_the_dense_one(name, steps):
    A, bounds = _colour_sorted(name)
    assert len(bounds) > 2  # more than one colour
    n = A.shape[0]
    rng = np.random.default_rng(3)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    x0_kept = x0.copy()
    csr = gs_sweep.Csr(A, "cpu")
    Ad = A.toarray()
    for x in (None, x0):
        for reverse in (False, True):
            got = gs_sweep.blocked_sweep(csr, bounds, x, b, reverse, steps)
            ref = gs_sweep.dense_sweep(Ad, x, b, reverse, steps)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                                       atol=1e-12 * ref.abs().max().item())
    assert np.array_equal(x0, x0_kept)  # the caller's x is not written


def test_blocked_sweep_refuses_coupled_rows_of_one_colour():
    A, bounds = _colour_sorted("poisson_3d_9")
    csr = gs_sweep.Csr(A, "cpu")
    b = np.ones(A.shape[0])
    # colours 0 and 1 merged: rows of both are coupled
    merged = (bounds[0],) + tuple(bounds[2:])
    with pytest.raises(ValueError, match="coupled"):
        gs_sweep.blocked_sweep(csr, merged, None, b)
    # one colour over the whole matrix
    with pytest.raises(ValueError, match="coupled"):
        gs_sweep.blocked_sweep(csr, (0, A.shape[0]), None, b)
    with pytest.raises(ValueError, match="cover"):
        gs_sweep.blocked_sweep(csr, (0, 3), None, b)


def test_gs_amg_solves_a_small_poisson_problem():
    """``AMGOptions()`` with ``sm_type`` ``gs`` through the normal path: a
    GS smoother on every level but the coarsest, and the answer within a
    relative 1e-7 of the dense float64 solution."""
    p = tfem.poisson_3d(13)
    assert p.n == 1728
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy="h1", coords=p.coords,
        options=options_from_flags({"sm_type": "gs"}), device="cpu",
    ).setup()
    levels = pc.op.levels
    assert len(levels) > 1
    assert all(isinstance(lev.smoother, tcore.GSSmoother)
               for lev in levels[:-1])
    b = np.random.default_rng(13).standard_normal(p.n)
    x, info = pc.solve(b, tol=1e-8, return_device=True)
    assert info.converged
    assert info.colour_steps > 0
    ref = torch.linalg.solve(torch.from_numpy(p.A.toarray()),
                             torch.from_numpy(b))
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64).reshape(-1)
    assert float((x - ref).norm() / ref.norm()) <= 1e-7
