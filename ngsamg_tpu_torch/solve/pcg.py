"""Preconditioned conjugate gradients on the device.

Port of ngsamg_tpu/solve/pcg.py (`pcg`/`_pcg_chunk`, the mixed-precision
`pcg_mixed`/`_pcg_mixed_chunk` and the stationary `amg_iteration`/
`_si_chunk`) with a chunk of one iteration: all state stays on the device, each step is masked (once the
residual drops below tolerance the state freezes and ``k`` counts accepted
steps only, as in the JAX package), and the host reads the residual scalar
after every step and stops early. A device-to-host read of one scalar
costs microseconds on the card, against a V-cycle of milliseconds, so a
longer chunk would only spend frozen iterations. Every read goes through
``utils.timers.blocking``, and with tracing on each iteration is a
``pcg.iter`` span.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sparse.formats import matvec
from ..utils import timers
from .cycle import AMGOperator, amg_apply


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32, 0-d
    relres: torch.Tensor  # final ||r|| / ||b||


def _dot(a: torch.Tensor, b: torch.Tensor, A=None) -> torch.Tensor:
    """<a, b>; on a rank of the sharded solve (``A`` the rank's finest
    level, parallel/shard.py) the sum over the rows of one replica, the
    same value on every rank."""
    pl = getattr(A, "placement", None)
    if pl is not None:
        return pl.dot(a, b)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _pcg_init(b: torch.Tensor, A=None):
    """Trivial PCG start state (the M-apply happens at the top of each
    iteration)."""
    x = torch.zeros_like(b)
    p = torch.zeros_like(b)
    rz = b.new_zeros(())
    rn = _dot(b, b, A)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return (x, b, p, rz, rn, k)


def _pcg_step(op: AMGOperator, A, state, tol_abs2: torch.Tensor):
    """One PCG iteration; converged state is frozen."""
    x, r, p, rz_prev, rn, k = state
    eps = torch.finfo(x.dtype).tiny
    zero = x.new_zeros(())
    active = rn > tol_abs2
    z = amg_apply(op, r)
    rz = _dot(r, z, A)
    first = k == 0
    beta = torch.where(
        first, zero, rz / torch.where(rz_prev == 0, eps, rz_prev)
    )
    p_new = z + beta * p
    q = matvec(A, p_new)
    pq = _dot(p_new, q, A)
    ok = active & (pq > 0) & (rz.abs() > 0)
    alpha = torch.where(ok, rz / torch.where(pq == 0, eps, pq), zero)
    x = x + alpha * p_new
    r = torch.where(ok, r - alpha * q, r)
    p = torch.where(ok, p_new, p)
    rz_prev = torch.where(ok, rz, rz_prev)
    rn = torch.where(ok, _dot(r, r, A), rn)
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
    bnorm2 = timers.blocking(float, _dot(b, b, A))
    if bnorm2 == 0.0:
        z = torch.zeros_like(b)
        return SolveResult(
            z, torch.zeros((), dtype=torch.int32), b.new_zeros(())
        )
    tol_abs2 = torch.tensor(tol * tol * bnorm2, dtype=b.dtype, device=b.device)
    tol_abs2_host = timers.blocking(float, tol_abs2)
    state = _pcg_init(b, A)
    for it in range(maxiter):
        sp = timers.span("pcg.iter", index=it) if timers.ON else None
        state = _pcg_step(op, A, state, tol_abs2)
        rn = timers.blocking(float, state[4])
        if sp is not None:
            sp.close()
        if not np.isfinite(rn) or rn <= tol_abs2_host:
            break
    x, _r, _p, _rz, rn, k = state
    relres = torch.sqrt(torch.clamp(rn, min=0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)


def _pcg_mixed_step(
    op: AMGOperator, A64, state, tol_abs2: torch.Tensor, w, cycle_dt
):
    """One mixed-precision PCG iteration: f64 Krylov state and f64 finest
    matvec, the (f32) AMG cycle as M.

    M is applied to the unit-normalized residual (exact for a linear M),
    so the cast into the cycle dtype never leaves its dynamic range.

    ``w`` WEIGHTS the convergence norm only (the CG inner products stay in
    the solve space): on a symmetrically scaled hierarchy A-hat = SAS,
    w = S^-1 makes the stopping criterion the honest UNSCALED relative
    residual ||S^-1 r-hat|| / ||S^-1 b-hat|| = ||r||/||b|| (the
    scaled-space norm can sit an order of magnitude off it).
    """
    x, r, p, rz_prev, rn, k = state
    tiny = torch.finfo(torch.float64).tiny
    zero = x.new_zeros(())
    active = rn > tol_abs2
    rnorm = torch.sqrt(torch.clamp(_dot(r, r, A64), min=tiny))
    z32 = amg_apply(op, (r * (1.0 / rnorm)).to(cycle_dt))
    z = z32.to(torch.float64) * rnorm
    rz = _dot(r, z, A64)
    first = k == 0
    beta = torch.where(
        first, zero, rz / torch.where(rz_prev == 0, tiny, rz_prev)
    )
    p_new = z + beta * p
    q = matvec(A64, p_new)
    pq = _dot(p_new, q, A64)
    ok = active & (pq > 0) & (rz.abs() > 0)
    alpha = torch.where(ok, rz / torch.where(pq == 0, tiny, pq), zero)
    x = x + alpha * p_new
    r = torch.where(ok, r - alpha * q, r)
    p = torch.where(ok, p_new, p)
    rz_prev = torch.where(ok, rz, rz_prev)
    rw = r if w is None else w * r
    rn = torch.where(ok, _dot(rw, rw, A64), rn)
    k = k + ok.to(torch.int32)
    return (x, r, p, rz_prev, rn, k)


def pcg_mixed(
    op: AMGOperator,
    A64,
    b64: torch.Tensor,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    cycle_dt: torch.dtype = torch.float32,
    weight: torch.Tensor | None = None,
) -> SolveResult:
    """Device-resident mixed-precision PCG (f64 Krylov, low-precision M).

    ``A64`` is the exact f64 finest operator on the device, ``b64`` an f64
    block vector there. Iteration counts track the f64-quality cycle while
    the smoothing and transfer FLOPs stay in the fast dtype. ``weight``
    (same shape as ``b64``) weights the convergence norm, see
    :func:`_pcg_mixed_step`.
    """
    wb = b64 if weight is None else b64 * weight
    bnorm2 = timers.blocking(float, _dot(wb, wb, A64))
    if bnorm2 == 0.0:
        z = torch.zeros_like(b64)
        return SolveResult(
            z, torch.zeros((), dtype=torch.int32), b64.new_zeros(())
        )
    tol_abs2 = torch.tensor(
        tol * tol * bnorm2, dtype=torch.float64, device=b64.device
    )
    tol_abs2_host = timers.blocking(float, tol_abs2)
    state = (
        torch.zeros_like(b64),
        b64,
        torch.zeros_like(b64),
        b64.new_zeros(()),
        torch.tensor(bnorm2, dtype=torch.float64, device=b64.device),
        torch.zeros((), dtype=torch.int32, device=b64.device),
    )
    for it in range(maxiter):
        sp = timers.span("pcg.iter", index=it) if timers.ON else None
        state = _pcg_mixed_step(op, A64, state, tol_abs2, weight, cycle_dt)
        rn = timers.blocking(float, state[4])
        if sp is not None:
            sp.close()
        if not np.isfinite(rn) or rn <= tol_abs2_host:
            break
    x, _r, _p, _rz, rn, k = state
    relres = torch.sqrt(torch.clamp(rn, min=0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)


def _si_step(op: AMGOperator, A, state, tol_abs2: torch.Tensor):
    """One stationary AMG step; converged state is frozen."""
    x, r, rn, k = state
    active = rn > tol_abs2
    x_new = x + amg_apply(op, r)
    r_new = r - matvec(A, x_new - x)
    x = torch.where(active, x_new, x)
    r = torch.where(active, r_new, r)
    rn = torch.where(active, _dot(r, r, A), rn)
    k = k + active.to(torch.int32)
    return (x, r, rn, k)


def amg_iteration(
    op: AMGOperator,
    A,
    b: torch.Tensor,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
) -> SolveResult:
    """Stationary AMG iteration x <- x + M^-1 (b - A x) (the reference's
    `AMGAsLinearSolver` simple iteration). Zero initial guess."""
    bnorm2 = timers.blocking(float, _dot(b, b, A))
    if bnorm2 == 0.0:
        z = torch.zeros_like(b)
        return SolveResult(
            z, torch.zeros((), dtype=torch.int32), b.new_zeros(())
        )
    tol_abs2 = torch.tensor(tol * tol * bnorm2, dtype=b.dtype, device=b.device)
    tol_abs2_host = timers.blocking(float, tol_abs2)
    state = (
        torch.zeros_like(b),
        b,
        torch.tensor(bnorm2, dtype=b.dtype, device=b.device),
        torch.zeros((), dtype=torch.int32, device=b.device),
    )
    for _ in range(maxiter):
        state = _si_step(op, A, state, tol_abs2)
        rn = timers.blocking(float, state[2])
        if not np.isfinite(rn) or rn <= tol_abs2_host:
            break
    x, _r, rn, k = state
    relres = torch.sqrt(torch.clamp(rn, min=0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)
