"""Preconditioned conjugate gradients on the device.

Port of ngsamg_tpu/solve/pcg.py (`pcg`/`_pcg_chunk`, the mixed-precision
`pcg_mixed`/`_pcg_mixed_chunk` and the stationary `amg_iteration`/
`_si_chunk`) with a chunk of one iteration: all state stays on the device,
each step is masked (once the residual drops below tolerance the state
freezes and ``k`` counts accepted steps only, as in the JAX package), and
the host reads the residual scalar after every step and stops early. A
device-to-host read of one scalar costs microseconds on the card, against
a V-cycle of milliseconds, so a longer chunk would only spend frozen
iterations. Both PCG solvers run one step, :func:`_pcg_step`, and all
three one host loop, :func:`_run`. Every read goes through
``utils.timers.blocking``, and with tracing on each iteration is a
``pcg.iter`` span.
"""

from __future__ import annotations

from functools import partial
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


def _threshold(tol: float, bnorm2: float, dtype: torch.dtype, device):
    """tol^2 ||b||^2 as the device tensor the masked steps compare with,
    and its value rounded in ``dtype`` on the host, by a CPU tensor: the
    same bits, with no read back."""
    v = tol * tol * bnorm2
    host = torch.tensor(v, dtype=dtype).item()
    return torch.tensor(v, dtype=dtype, device=device), host


def _pcg_init(b: torch.Tensor, A=None, rn: torch.Tensor | None = None):
    """Trivial PCG start state (the M-apply happens at the top of each
    iteration); ``rn``: the start's residual norm, where the caller has
    it."""
    x = torch.zeros_like(b)
    p = torch.zeros_like(b)
    rz = b.new_zeros(())
    rn = _dot(b, b, A) if rn is None else rn
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return (x, b, p, rz, rn, k)


def _pcg_step(op: AMGOperator, A, state, tol_abs2: torch.Tensor, *,
              cycle_dt: torch.dtype | None = None,
              weight: torch.Tensor | None = None):
    """One PCG iteration; converged state is frozen.

    With ``cycle_dt`` the step is mixed-precision: the Krylov state and
    ``A`` in f64, the cycle in ``cycle_dt`` as M, applied to the
    unit-normalized residual (exact for a linear M), so the cast into the
    cycle dtype never leaves its dynamic range.

    ``weight`` WEIGHTS the convergence norm only (the CG inner products
    stay in the solve space): on a symmetrically scaled hierarchy
    A-hat = SAS, w = S^-1 makes the stopping criterion the honest UNSCALED
    relative residual ||S^-1 r-hat|| / ||S^-1 b-hat|| = ||r||/||b|| (the
    scaled-space norm can sit an order of magnitude off it).
    """
    x, r, p, rz_prev, rn, k = state
    eps = torch.finfo(x.dtype).tiny
    zero = x.new_zeros(())
    active = rn > tol_abs2
    if cycle_dt is None:
        z = amg_apply(op, r)
    else:
        rnorm = torch.sqrt(torch.clamp(_dot(r, r, A), min=eps))
        z = amg_apply(op, (r * (1.0 / rnorm)).to(cycle_dt))
        z = z.to(x.dtype) * rnorm
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
    rw = r if weight is None else weight * r
    rn = torch.where(ok, _dot(rw, rw, A), rn)
    k = k + ok.to(torch.int32)
    return (x, r, p, rz_prev, rn, k)


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


def _run(step, start, b: torch.Tensor, wb: torch.Tensor, A, tol: float,
         maxiter: int, irn: int) -> SolveResult:
    """The host side of every solver: ||wb||^2 read once (zero: x = 0),
    the state ``start(bnorm2)``, then ``step(state, tol_abs2)`` at most
    ``maxiter`` times, one blocking read of the residual norm
    ``state[irn]`` after each, stopping once it is within the threshold
    or not finite. A state starts with x and ends with the step count."""
    bnorm2 = timers.blocking(float, _dot(wb, wb, A))
    if bnorm2 == 0.0:
        return SolveResult(torch.zeros_like(b),
                           torch.zeros((), dtype=torch.int32),
                           b.new_zeros(()))
    state = start(bnorm2)
    tol_abs2, tol_host = _threshold(tol, bnorm2, b.dtype, b.device)
    for it in range(maxiter):
        sp = timers.span("pcg.iter", index=it) if timers.ON else None
        state = step(state, tol_abs2)
        rn = timers.blocking(float, state[irn])
        if sp is not None:
            sp.close()
        if not np.isfinite(rn) or rn <= tol_host:
            break
    relres = torch.sqrt(torch.clamp(state[irn], min=0.0) / bnorm2)
    return SolveResult(x=state[0], iterations=state[-1], relres=relres)


def pcg(
    op: AMGOperator,
    A,
    b: torch.Tensor,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
) -> SolveResult:
    """PCG with the AMG cycle as preconditioner. Zero initial guess."""
    return _run(partial(_pcg_step, op, A), lambda _: _pcg_init(b, A), b, b,
                A, tol, maxiter, 4)


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
    :func:`_pcg_step`.
    """
    def start(bnorm2):
        return _pcg_init(b64, rn=torch.tensor(bnorm2, dtype=torch.float64,
                                              device=b64.device))

    wb = b64 if weight is None else b64 * weight
    step = partial(_pcg_step, op, A64, cycle_dt=cycle_dt, weight=weight)
    return _run(step, start, b64, wb, A64, tol, maxiter, 4)


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
    def start(bnorm2):
        rn = torch.tensor(bnorm2, dtype=b.dtype, device=b.device)
        k = torch.zeros((), dtype=torch.int32, device=b.device)
        return (torch.zeros_like(b), b, rn, k)

    return _run(partial(_si_step, op, A), start, b, b, A, tol, maxiter, 2)
