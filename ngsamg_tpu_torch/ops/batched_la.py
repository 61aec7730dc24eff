"""Batched small-matrix dense linear algebra on the tensors' device.

Port of ngsamg_tpu/ops/batched_la.py: the eigendecomposition pseudo-inverse
(the reference's `CalcPseudoInverseWithTol`) and the generalized
eigenproblem of the robust elasticity coarsening (`CalcRobustPairSOC`),
as thousands of tiny Hermitian problems, shapes (batch, k, k) with k in
{1, 2, 3, 6, 8}, solved in one batched ``torch.linalg.eigh`` /
``eigvalsh`` call. The JAX package computes these in XLA (no Pallas
kernel), so ``torch.linalg`` is their counterpart here. They run where
their tensors are: the elasticity energy hands them tensors on the
preconditioner's device (apps/elasticity.py ``_pencil_extreme_eig``). The
zero thresholds take the tensor dtype's epsilon from ``torch.finfo``, as
the JAX package takes it from ``jnp.finfo``.
"""

from __future__ import annotations

import torch


def _rel_tol(rel_tol: float, dtype: torch.dtype) -> float:
    """The relative zero threshold: at least 64 epsilons of the dtype."""
    return max(rel_tol, 64.0 * float(torch.finfo(dtype).eps))


def pinv_batched(M: torch.Tensor, rel_tol: float = 1e-10) -> torch.Tensor:
    """Eigendecomposition pseudo-inverse of symmetric (b, k, k) blocks.

    Eigenvalues below rel_tol * lam_max are treated as kernel
    (CalcPseudoInverseWithTol).
    """
    lam, V = torch.linalg.eigh(M)
    tol = _rel_tol(rel_tol, M.dtype)
    lam_max = torch.clamp(lam.abs().amax(dim=-1, keepdim=True), min=1e-300)
    ok = lam.abs() > tol * lam_max
    inv = torch.where(ok, 1.0 / torch.where(ok, lam, torch.ones_like(lam)),
                      torch.zeros_like(lam))
    return torch.einsum("bik,bk,bjk->bij", V, inv, V)


def pencil_extreme_eig(
    E: torch.Tensor,
    C: torch.Tensor,
    rel_tol: float = 1e-10,
    reduction: str = "min",
) -> torch.Tensor:
    """Extreme eigenvalue of the pencil (E, C) restricted to range(C).

    Batched `CalcRobustPairSOC`: eigendecompose C, scale the above-threshold
    eigenvectors by 1/sqrt(lam), form W^T E W, and take its min (or max)
    eigenvalue, masking the null directions of C with a +/-1e30 sentinel on
    the diagonal so that they never win.
    """
    lam, V = torch.linalg.eigh(C)
    tol = _rel_tol(rel_tol, C.dtype)
    lam_max = torch.clamp(lam[..., -1:], min=1e-300)
    ok = lam > tol * lam_max
    isq = torch.where(
        ok, torch.rsqrt(torch.where(ok, lam, torch.ones_like(lam))),
        torch.zeros_like(lam),
    )
    W = V * isq[..., None, :]
    M = torch.einsum("bki,bkl,blj->bij", W, E, W)
    big = 1e30 if reduction == "min" else -1e30
    k = E.shape[-1]
    diag_pen = torch.where(ok, 0.0, big).to(M.dtype)  # null dirs never win
    M = M + torch.eye(k, dtype=M.dtype, device=M.device) * diag_pen[..., None, :]
    ev = torch.linalg.eigvalsh(M)
    out = ev[..., 0] if reduction == "min" else ev[..., -1]
    allnull = ~ok.any(dim=-1)
    return torch.where(allnull, torch.zeros_like(out), torch.clamp(out, min=0.0))


def harmonic_mean_batched(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """2 * A (A + B)^+ B symmetrized: the matrix harmonic mean of the robust
    SOC preparation (`PrepRobSOC`)."""
    S = pinv_batched(A + B)
    H = torch.einsum("bik,bkl,blj->bij", A, S, B)
    return H + H.transpose(-1, -2)
