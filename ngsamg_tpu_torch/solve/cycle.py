"""Multigrid operator: the V-cycle over the level hierarchy.

Port of ngsamg_tpu/solve/cycle.py: pre-smooth (zero start) -> restrict the
residual -> coarse solve -> prolongate-add -> backward post-smooth. The
coarsest level applies a dense inverse with ``torch.matmul``. The coarse
inverse is staged in the level dtype. The W and BS cycles and the cluster
correction are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..smoothers.core import Smoother, smooth, smooth_back
from ..sparse.formats import matvec


@dataclass(frozen=True)
class DeviceLevel:
    """One AMG level on the device."""

    A: object  # StencilDia | DiaMatrix | DenseMatrix
    smoother: Smoother | None
    P: object | None  # prolongation: next-coarser -> this level
    R: object | None  # restriction (P^T)


@dataclass(frozen=True)
class AMGOperator:
    """The assembled multigrid preconditioner (plain data, no parameters)."""

    levels: tuple  # tuple[DeviceLevel, ...]
    coarse_inv: torch.Tensor | None  # ((nc_pad*bs), (nc_pad*bs)) dense
    cycle: str = "V"


def coarse_solve(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    lev = op.levels[-1]
    if op.coarse_inv is None:
        if lev.smoother is None:
            return torch.zeros_like(b)
        x = smooth(lev.smoother, lev.A, None, b)
        return smooth_back(lev.smoother, lev.A, x, b)
    n, bs = b.shape
    return torch.matmul(op.coarse_inv, b.reshape(-1)).reshape(n, bs)


def _cycle(op: AMGOperator, b: torch.Tensor, l: int) -> torch.Tensor:
    levels = op.levels
    if l == len(levels) - 1:
        return coarse_solve(op, b)
    lev = levels[l]
    x = smooth(lev.smoother, lev.A, None, b)
    r = b - matvec(lev.A, x)
    bc = matvec(lev.R, r)
    xc = _cycle(op, bc, l + 1)
    x = x + matvec(lev.P, xc)
    return smooth_back(lev.smoother, lev.A, x, b)


def amg_apply(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    """One multigrid V-cycle with zero initial guess (`AMGMatrix::Mult`)."""
    if op.cycle != "V":
        raise NotImplementedError(
            f"{op.cycle}-cycle: ngsamg_tpu_torch runs V-cycles only "
            "(W/BS are ROADMAP queue 1 item 4)"
        )
    return _cycle(op, b, 0)
