"""Preconditioned conjugate gradients on the device.

Port of ngsamg_tpu/solve/pcg.py (`pcg`/`_pcg_chunk`) with a chunk of one
iteration: all state stays on the device, each step is masked (once the
residual drops below tolerance the state freezes and ``k`` counts accepted
steps only, as in the JAX package), and the host reads the residual scalar
after every step and stops early. A device-to-host read of one scalar
costs microseconds on the card, against a V-cycle of milliseconds, so a
longer chunk would only spend frozen iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sparse.formats import matvec
from .cycle import AMGOperator, amg_apply


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32, 0-d
    relres: torch.Tensor  # final ||r|| / ||b||


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _pcg_init(b: torch.Tensor):
    """Trivial PCG start state (the M-apply happens at the top of each
    iteration)."""
    x = torch.zeros_like(b)
    p = torch.zeros_like(b)
    rz = b.new_zeros(())
    rn = _dot(b, b)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return (x, b, p, rz, rn, k)


def _pcg_step(op: AMGOperator, A, state, tol_abs2: torch.Tensor):
    """One PCG iteration; converged state is frozen."""
    x, r, p, rz_prev, rn, k = state
    eps = torch.finfo(x.dtype).tiny
    zero = x.new_zeros(())
    active = rn > tol_abs2
    z = amg_apply(op, r)
    rz = _dot(r, z)
    first = k == 0
    beta = torch.where(
        first, zero, rz / torch.where(rz_prev == 0, eps, rz_prev)
    )
    p_new = z + beta * p
    q = matvec(A, p_new)
    pq = _dot(p_new, q)
    ok = active & (pq > 0) & (rz.abs() > 0)
    alpha = torch.where(ok, rz / torch.where(pq == 0, eps, pq), zero)
    x = x + alpha * p_new
    r = torch.where(ok, r - alpha * q, r)
    p = torch.where(ok, p_new, p)
    rz_prev = torch.where(ok, rz, rz_prev)
    rn = torch.where(ok, _dot(r, r), rn)
    k = k + ok.to(torch.int32)
    return (x, r, p, rz_prev, rn, k)


def pcg(
    op: AMGOperator,
    A,
    b: torch.Tensor,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
) -> SolveResult:
    """PCG with the AMG cycle as preconditioner. Zero initial guess."""
    bnorm2 = float(_dot(b, b))
    if bnorm2 == 0.0:
        z = torch.zeros_like(b)
        return SolveResult(
            z, torch.zeros((), dtype=torch.int32), b.new_zeros(())
        )
    tol_abs2 = torch.tensor(tol * tol * bnorm2, dtype=b.dtype, device=b.device)
    tol_abs2_host = float(tol_abs2)
    state = _pcg_init(b)
    for _ in range(maxiter):
        state = _pcg_step(op, A, state, tol_abs2)
        rn = float(state[4])
        if not np.isfinite(rn) or rn <= tol_abs2_host:
            break
    x, _r, _p, _rz, rn, k = state
    relres = torch.sqrt(torch.clamp(rn, min=0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)
