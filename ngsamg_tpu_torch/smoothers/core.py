"""Device-side smoothers: Chebyshev and damped Jacobi on torch tensors.

Port of ngsamg_tpu/smoothers/core.py. Contract as there:
``smooth(sm, A, x, b)`` performs the forward sweep(s), ``smooth_back`` the
reverse; ``x=None`` means a zero initial guess. Both smoothers are
polynomials in Dinv A, so the backward sweep is the forward one. The
multicolor and block Gauss-Seidel smoothers are not ported yet (ROADMAP
queue 1 item 4). Block levels (bs 3 and 6) run Chebyshev with a block
Dinv, order 5 on the window [0.25, 1] lam_max (smoothers/build.py).

The Chebyshev recurrence scalars (theta, delta, sigma, rho) are computed
on the host in the level's dtype, as the JAX package computes them in its
0-d device arrays, so the two packages apply the same coefficients.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sparse.formats import matvec


def _block_mul(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(n, bs, bs) x (n, bs) batched block multiply.

    A leading dimension of 1 broadcasts one block over every row — the
    constant-diagonal fast path of uniform stencil levels.
    """
    if Dinv.shape[1] == 1:
        return Dinv[:, 0, :] * r  # bs == 1: a diagonal scale
    if Dinv.shape[0] == 1 and r.shape[0] != 1:
        return torch.einsum("ij,nj->ni", Dinv[0], r)
    return torch.einsum("nij,nj->ni", Dinv, r)


@dataclass(frozen=True)
class JacobiSmoother:
    """Damped (block-)Jacobi."""

    Dinv: torch.Tensor  # (n_pad, bs, bs) or (1, bs, bs)
    omega: float = 1.0
    steps: int = 1


@dataclass(frozen=True)
class ChebyshevSmoother:
    """Chebyshev polynomial smoother on the D^-1 A spectrum window.

    ``lam_max``/``lam_min`` are host 0-d numpy scalars in the level dtype
    (the recurrence reads them on the host; keeping them off the device
    avoids a device-to-host read per sweep)."""

    Dinv: torch.Tensor
    lam_max: np.ndarray
    lam_min: np.ndarray
    order: int = 3
    steps: int = 1


Smoother = JacobiSmoother | ChebyshevSmoother


def smooth(sm: Smoother, A, x: torch.Tensor | None, b: torch.Tensor):
    if isinstance(sm, ChebyshevSmoother):
        return _chebyshev(sm, A, x, b)
    if isinstance(sm, JacobiSmoother):
        return _jacobi(sm, A, x, b)
    raise NotImplementedError(
        f"smoother {type(sm).__name__} is not ported to ngsamg_tpu_torch "
        "(ROADMAP queue 1 item 4)"
    )


def smooth_back(sm: Smoother, A, x: torch.Tensor | None, b: torch.Tensor):
    # Jacobi and Chebyshev are symmetric: the backward sweep is the forward
    return smooth(sm, A, x, b)


def _jacobi(sm: JacobiSmoother, A, x, b):
    steps = sm.steps
    if x is None:
        x = sm.omega * _block_mul(sm.Dinv, b)
        steps -= 1
    for _ in range(steps):
        r = b - matvec(A, x)
        x = x + sm.omega * _block_mul(sm.Dinv, r)
    return x


def _chebyshev(sm: ChebyshevSmoother, A, x, b):
    """Three-term Chebyshev recurrence on [lam_min, lam_max] (Saad alg. 12.1).

    A polynomial in Dinv A applied to the residual — symmetric, so it serves
    as both forward and backward smoother.
    """
    dt = np.asarray(sm.lam_max).dtype.type  # the level dtype's scalar type
    one, two, half = dt(1.0), dt(2.0), dt(0.5)
    lmax, lmin = dt(sm.lam_max), dt(sm.lam_min)
    theta = half * (lmax + lmin)
    delta = half * (lmax - lmin)
    sigma = theta / delta
    for _step in range(max(int(sm.steps), 1)):
        rho = one / sigma
        if x is None:
            r = b
            x = torch.zeros_like(b)
        else:
            r = b - matvec(A, x)
        d = _block_mul(sm.Dinv, r) / float(theta)
        for _ in range(sm.order - 1):
            x = x + d
            r = r - matvec(A, d)
            rho_new = one / (two * sigma - rho)
            d = float(rho_new * rho) * d + float(
                two * rho_new / delta
            ) * _block_mul(sm.Dinv, r)
            rho = rho_new
        x = x + d
    return x
