"""Multigrid operator: the V-cycle over the level hierarchy.

Port of ngsamg_tpu/solve/cycle.py: pre-smooth (zero start) -> restrict the
residual -> coarse solve -> prolongate-add -> backward post-smooth. The
coarsest level applies a dense inverse with ``torch.matmul``, staged in the
level dtype, or in f64 inside an f32 cycle (scaled unstructured
hierarchies, scalar or block; vectors are (nrows_pad, bs) and change
shape between levels of different block size). A cluster correction, when
the hierarchy carries one, wraps the cycle multiplicatively and
symmetrically. The W and BS cycles are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..smoothers.cluster_corr import ClusterCorrection, cluster_apply
from ..smoothers.core import Smoother, smooth, smooth_back
from ..sparse.formats import matvec


@dataclass(frozen=True)
class DeviceLevel:
    """One AMG level on the device."""

    A: object  # StencilDia | DiaMatrix | TileELLStack | BlockELL | DenseMatrix
    smoother: Smoother | None
    P: object | None  # prolongation: next-coarser -> this level
    R: object | None  # restriction (P^T)


@dataclass(frozen=True)
class AMGOperator:
    """The assembled multigrid preconditioner (plain data, no parameters)."""

    levels: tuple  # tuple[DeviceLevel, ...]
    coarse_inv: torch.Tensor | None  # ((nc_pad*bs), (nc_pad*bs)) dense
    cluster_corr: ClusterCorrection | None = None
    cycle: str = "V"


def coarse_solve(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    lev = op.levels[-1]
    if op.coarse_inv is None:
        if lev.smoother is None:
            return torch.zeros_like(b)
        x = smooth(lev.smoother, lev.A, None, b)
        return smooth_back(lev.smoother, lev.A, x, b)
    n, bs = b.shape
    ci = op.coarse_inv
    # an f64 inverse inside an f32 cycle: applying the explicit inverse
    # (norm ~1/lambda_min) in f32 would inject eps32*kappa-sized
    # indefinite noise into the coarse solve
    x = torch.matmul(ci, b.reshape(-1).to(ci.dtype))
    return x.to(b.dtype).reshape(n, bs)


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
    """One multigrid V-cycle with zero initial guess (`AMGMatrix::Mult`).

    With a cluster correction attached (near-singular sliver clusters on
    the finest level, see smoothers/cluster_corr.py) the cycle is wrapped
    multiplicatively and symmetrically: C, cycle, C.
    """
    if op.cycle != "V":
        raise NotImplementedError(
            f"{op.cycle}-cycle: ngsamg_tpu_torch runs V-cycles only "
            "(W/BS are ROADMAP queue 1 item 4)"
        )
    if op.cluster_corr is None:
        return _cycle(op, b, 0)
    A0 = op.levels[0].A
    z = cluster_apply(op.cluster_corr, b)
    z = z + _cycle(op, b - matvec(A0, z), 0)
    return z + cluster_apply(op.cluster_corr, b - matvec(A0, z))
