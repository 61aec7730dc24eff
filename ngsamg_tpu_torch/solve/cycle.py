"""Multigrid operator: V, W and BS cycles over the level hierarchy.

Port of ngsamg_tpu/solve/cycle.py. The V-cycle: pre-smooth (zero start) ->
restrict the residual -> coarse solve -> prolongate-add -> backward
post-smooth; the W-cycle visits every level but the coarsest twice; the BS
cycle cascades V-cycles rooted at successively coarser levels. The
coarsest level applies a dense inverse with ``torch.matmul``, staged in the
level dtype, or in f64 inside an f32 cycle (scaled unstructured
hierarchies, scalar or block; vectors are (nrows_pad, bs) and change
shape between levels of different block size). A cluster correction, when
the hierarchy carries one, wraps the cycle multiplicatively and
symmetrically. ``AMGSmoother`` uses a multigrid operator as a smoother.

On a rank of the sharded solve (parallel/shard.py) the same code runs on
the rank's rows: the sharded operators, transfers and smoothers carry
their own collectives in their ``matvec`` and ``sweep`` methods, the
coarse inverse, which is replicated, takes the gathered vector, and the
cluster correction's ``apply`` gathers its own.

With tracing on (utils/timers.py) each level's visit is a ``cycle.level``
span, whose self time is the level's smoothing, residual and transfers,
and the coarse solve a ``cycle.coarse`` span; each of the two cluster
applies that wrap a cycle is a ``cluster.apply`` span (attributes
``clusters`` and ``width``, host shapes).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..smoothers.cluster_corr import ClusterCorrection
from ..smoothers.core import Smoother, smooth, smooth_back
from ..sparse.formats import matvec
from ..utils import timers


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
    cycle: str = "V"  # V | W | BS


def coarse_solve(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    if not timers.ON:
        return _coarse_solve(op, b)
    with timers.span("cycle.coarse"):
        return _coarse_solve(op, b)


def _coarse_solve(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    lev = op.levels[-1]
    if op.coarse_inv is None:
        if lev.smoother is None:
            return torch.zeros_like(b)
        x = smooth(lev.smoother, lev.A, None, b)
        return smooth_back(lev.smoother, lev.A, x, b)
    # a sharded coarsest level (parallel/shard.py): the inverse is
    # replicated, so it is applied to the gathered vector
    pl = getattr(lev.A, "placement", None)
    if pl is not None:
        b = pl.gather(b)
    n, bs = b.shape
    ci = op.coarse_inv
    # an f64 inverse inside an f32 cycle: applying the explicit inverse
    # (norm ~1/lambda_min) in f32 would inject eps32*kappa-sized
    # indefinite noise into the coarse solve
    x = torch.matmul(ci, b.reshape(-1).to(ci.dtype))
    x = x.to(b.dtype).reshape(n, bs)
    return x if pl is None else pl.take(x)


def _cycle(op: AMGOperator, b: torch.Tensor, l: int) -> torch.Tensor:
    levels = op.levels
    if l == len(levels) - 1:
        return coarse_solve(op, b)
    sp = timers.span("cycle.level", level=l) if timers.ON else None
    lev = levels[l]
    x = smooth(lev.smoother, lev.A, None, b)
    r = b - matvec(lev.A, x)
    bc = matvec(lev.R, r)
    xc = _cycle(op, bc, l + 1)
    if op.cycle == "W" and l + 1 < len(levels) - 1:
        rc = bc - matvec(levels[l + 1].A, xc)
        xc = xc + _cycle(op, rc, l + 1)
    x = x + matvec(lev.P, xc)
    x = smooth_back(lev.smoother, lev.A, x, b)
    if sp is not None:
        sp.close()
    return x


def amg_apply(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    """One multigrid cycle with zero initial guess (`AMGMatrix::Mult`).

    With a cluster correction attached (near-singular sliver clusters on
    the finest level, see smoothers/cluster_corr.py) the cycle is wrapped
    multiplicatively and symmetrically: C, cycle, C.
    """
    core = _bs_cycle if op.cycle == "BS" else _cycle_from
    if op.cluster_corr is None:
        return core(op, b)
    A0 = op.levels[0].A
    cc = op.cluster_corr
    z = _cluster_apply(cc, b)
    z = z + core(op, b - matvec(A0, z))
    return z + _cluster_apply(cc, b - matvec(A0, z))


def _cluster_apply(cc: ClusterCorrection, r: torch.Tensor) -> torch.Tensor:
    if not timers.ON:
        return cc.apply(r)
    ncl, width = cc.shape
    with timers.span("cluster.apply", clusters=ncl, width=width):
        return cc.apply(r)


@dataclass(frozen=True)
class AMGSmoother:
    """A multigrid operator used as a smoother (`AMGSmoother`,
    amg_matrix.hpp:132-158): one sweep is ``steps`` stationary AMG
    iterations, symmetric."""

    op: AMGOperator
    steps: int = 1

    def sweep(self, A, x, b, *, reverse: bool):
        if x is None:
            x = torch.zeros_like(b)
        for _ in range(self.steps):
            x = x + amg_apply(self.op, b - matvec(A, x))
        return x


def _cycle_from(
    op: AMGOperator, b: torch.Tensor, l: int = 0
) -> torch.Tensor:
    """Full cycle rooted at level ``l`` (`SmoothVFromLevel`), zero initial
    guess."""
    return _cycle(op, b, l)


def _bs_cycle(op: AMGOperator, b: torch.Tensor) -> torch.Tensor:
    """The BS cascade (`SmoothBS`).

    Descending: each level runs a full V-cycle rooted there, then restricts
    its updated residual. Coarsest: exact solve. Ascending: prolongate the
    coarse correction and run another V-cycle rooted at each level (in
    correction form).
    """
    levels = op.levels
    L = len(levels)
    if L == 1:
        return coarse_solve(op, b)
    xs, bs_ = [], []
    bl = b
    for l in range(L - 1):
        xl = _cycle_from(op, bl, l)
        rl = bl - matvec(levels[l].A, xl)
        xs.append(xl)
        bs_.append(bl)
        bl = matvec(levels[l].R, rl)
    xc = coarse_solve(op, bl)
    for l in range(L - 2, -1, -1):
        xl = xs[l] + matvec(levels[l].P, xc)
        rl = bs_[l] - matvec(levels[l].A, xl)
        xc = xl + _cycle_from(op, rl, l)
    return xc
