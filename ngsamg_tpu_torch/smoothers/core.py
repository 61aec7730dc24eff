"""Device-side smoothers: multicolor block GS, (l1-)Jacobi, Chebyshev.

Port of ngsamg_tpu/smoothers/core.py. Contract as there:
``smooth(sm, A, x, b)`` performs the forward sweep(s), ``smooth_back`` the
reverse; ``x=None`` means a zero initial guess. Jacobi and Chebyshev are
polynomials in Dinv A, so their backward sweep is the forward one; the
multicolor GS runs its colors in reverse order backwards. Block levels
(bs 3 and 6) run Chebyshev with a block Dinv, order 5 on the window
[0.25, 1] lam_max (smoothers/build.py). Every smoother applies itself
through its ``sweep(A, x, b, reverse=...)`` method: the three here, the
Hiptmair pair (smoothers/hiptmair.py), the block GS (smoothers/block.py),
a multigrid operator used as a smoother (solve/cycle.py) and the sharded
sweeps of parallel/shard.py; ``smooth`` and ``smooth_back`` call it.

The multicolor GS sweep of a CUDA tensor on a level the kernel takes (a
block-ELL operator of bs 1, 2, 3 or 6 in the smoother's dtype,
``gs_cuda.takes``) is the hand-written kernel (ops/gs_cuda.py,
csrc/gs_sweep.cu): one launch a colour step, or one launch a sweep where
the level's x fits in shared memory. It raises if the smoother was staged
without its operator, and so without a launch plan. Its plain version,
``gs_plain``, for CPU tensors and any level the kernel does not take, is
plain torch, as it is XLA in the JAX package: per color, one gather of x by
the color's column indices, one block contraction, one block-Dinv product
and one in-place update of the color's rows. Both leave the caller's ``x``
unwritten (the cycle keeps ``x`` alive across the sweep and the residual).
Each sweep adds its colour steps (steps x non-empty colours) to the solve's
``SolveInfo.colour_steps`` (and those the kernel ran to
``gs_kernel_steps``) and, with tracing on, is a ``gs.sweep`` span
(utils/timers.py).

The Chebyshev recurrence scalars (theta, delta, sigma, rho) are computed
on the host in the level's dtype, as the JAX package computes them in its
0-d device arrays, so the two packages apply the same coefficients.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import gs_cuda
from ..sparse.bell import rows_product
from ..sparse.formats import matvec
from ..utils import timers


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

    def sweep(self, A, x, b, *, reverse: bool):
        steps = self.steps
        if x is None:
            x = self.omega * _block_mul(self.Dinv, b)
            steps -= 1
        for _ in range(steps):
            r = b - matvec(A, x)
            x = x + self.omega * _block_mul(self.Dinv, r)
        return x


@dataclass(frozen=True)
class GSSmoother:
    """Multicolor block Gauss-Seidel on *color-sorted* rows.

    The level's rows are permuted at setup so each color occupies a
    contiguous slice [bounds[c], bounds[c+1]); the sweep is then plain
    slicing, with no gather of matrix rows and no scatter of updates.

    Two storage modes, as in the JAX package:

    * **split** (``cdata`` non-empty; the single-device path): the matrix
      rows of every color are separate per-color tensors (``cdata[c]``:
      (m_c, K_c, bs, bs), ``ccols[c]``: (m_c, K_c), ``cdinv[c]``:
      (m_c, bs, bs)), each color's ELL width K_c trimmed to its last used
      slot;
    * **sliced** (``cdata == ()``; the row-sharded path of the JAX
      package): the sweep slices the level's BlockELL ``A.data``/``A.cols``
      per color.

    The kernel (ops/gs_cuda.py) reads neither copy but the level's
    block-ELL operator itself, with ``bounds_dev`` (the colour bounds as a
    device int32 tensor) and ``ell_width`` (the operator's stored slots a
    row), which ``stage_smoother`` sets for a level the kernel takes (on
    the card such a level carries no split copies); the launch plan is made
    from them and the shape here, anew whenever the smoother is rebuilt (a
    cast to bfloat16 halves x's bytes).
    """

    Dinv: torch.Tensor  # (n_pad, bs, bs)
    color_bounds: tuple  # (ncolors+1,) ints, ascending
    steps: int = 1
    cdata: tuple = ()  # per-color (m_c, K_c, bs, bs), or () for sliced mode
    # per-color (m_c, K_c): int32 as built on the host, int64 once staged
    # (torch converts an int32 index to int64 on every gather)
    ccols: tuple = ()
    cdinv: tuple = ()  # per-color (m_c, bs, bs)
    bounds_dev: torch.Tensor | None = None  # (ncolors+1,) int32
    ell_width: int = 0  # the level operator's K; 0: no kernel
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "launch", gs_cuda.stage(self))

    def sweep(self, A, x, b, *, reverse: bool):
        bounds = self.color_bounds
        ncol = len(bounds) - 1
        sp = timers.NULL
        if timers.ON:
            sp = timers.span(
                "gs.sweep", reverse=reverse,
                colours=sum(1 for c in range(ncol)
                            if bounds[c + 1] > bounds[c]),
            )
        # the kernel sweeps in one dtype: a smoother cast away from its
        # operator's takes the plain sweep
        if (b.is_cuda and gs_cuda.takes(A, *self.Dinv.shape[:2])
                and A.data.dtype == self.Dinv.dtype):
            x0 = None if x is None else x.contiguous()
            x = gs_cuda.gs_sweep(self, A, x0, b.contiguous(),
                                 reverse=reverse)
            timers.count_colour_steps(self.launch.colour_steps)
            timers.count_gs_kernel_steps(self.launch.colour_steps)
        else:
            x = gs_plain(self, A, x, b, reverse=reverse)
        sp.close()
        return x


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

    def sweep(self, A, x, b, *, reverse: bool):
        """Three-term Chebyshev recurrence on [lam_min, lam_max] (Saad
        alg. 12.1): a polynomial in Dinv A applied to the residual,
        symmetric, so the backward sweep is the forward one."""
        dt = np.asarray(self.lam_max).dtype.type  # the level dtype's scalar
        one, two, half = dt(1.0), dt(2.0), dt(0.5)
        lmax, lmin = dt(self.lam_max), dt(self.lam_min)
        theta = half * (lmax + lmin)
        delta = half * (lmax - lmin)
        sigma = theta / delta
        for _step in range(max(int(self.steps), 1)):
            rho = one / sigma
            if x is None:
                r = b
                x = torch.zeros_like(b)
            else:
                r = b - matvec(A, x)
            d = _block_mul(self.Dinv, r) / float(theta)
            for _ in range(self.order - 1):
                x = x + d
                r = r - matvec(A, d)
                rho_new = one / (two * sigma - rho)
                d = float(rho_new * rho) * d + float(
                    two * rho_new / delta
                ) * _block_mul(self.Dinv, r)
                rho = rho_new
            x = x + d
        return x


Smoother = JacobiSmoother | GSSmoother | ChebyshevSmoother


def smooth(sm: Smoother, A, x: torch.Tensor | None, b: torch.Tensor):
    return sm.sweep(A, x, b, reverse=False)


def smooth_back(sm: Smoother, A, x: torch.Tensor | None, b: torch.Tensor):
    return sm.sweep(A, x, b, reverse=True)


def gs_plain(sm: GSSmoother, A, x, b, *, reverse: bool):
    """``sm.steps`` forward (backward with ``reverse``) sweeps in plain
    torch, counting their colour steps: the CPU path, and the card's for a
    level the kernel does not take."""
    bounds = sm.color_bounds
    ncol = len(bounds) - 1
    zero_start = x is None
    # one copy per call, updated in place color by color; the caller's x
    # is never written
    x = torch.zeros_like(b) if zero_start else x.clone()
    order = range(ncol - 1, -1, -1) if reverse else range(ncol)
    split = bool(sm.cdata)
    done = 0  # colour steps run, counted on the host
    for step in range(sm.steps):
        for ci, c in enumerate(order):
            lo, hi = bounds[c], bounds[c + 1]
            if hi == lo:
                continue
            done += 1
            if zero_start and step == 0 and ci == 0:
                r = b[lo:hi]  # x == 0: skip the row product
            elif split:
                r = b[lo:hi] - rows_product(sm.cdata[c], x[sm.ccols[c]])
            else:
                r = b[lo:hi] - rows_product(
                    A.data[lo:hi], x[A.cols[lo:hi]]
                )
            Dc = sm.cdinv[c] if split else sm.Dinv[lo:hi]
            x[lo:hi] += _block_mul(Dc, r)
    timers.count_colour_steps(done)
    return x
