"""Carry a staged ngsamg_tpu hierarchy over into this package's types.

``from_jax_operator(op_np)`` turns the JAX package's staged
``AMGOperator`` — with its leaves already read out as numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, pc.op)`` — into this package's
:class:`~ngsamg_tpu_torch.solve.cycle.AMGOperator`, so both packages can run
one cycle on identical data. The JAX classes are recognised by name; this
module imports neither JAX nor ngsamg_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..smoothers.core import ChebyshevSmoother
from ..solve.cycle import AMGOperator, DeviceLevel
from ..sparse import formats
from ..transfer.lattice_transfer import LatticeProlongation, LatticeRestriction


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _format(A, device):
    kind = type(A).__name__
    if kind == "StencilDia":
        return formats.StencilDia(
            vals=_t(A.vals, device),
            offs=tuple(tuple(int(v) for v in o) for o in A.offs),
            dims=tuple(int(v) for v in A.dims),
            nrows=int(A.nrows),
            nrows_pad=int(A.nrows_pad),
        )
    if kind == "DiaMatrix":
        return formats.DiaMatrix(
            data=_t(A.data, device),
            offsets=tuple(int(o) for o in A.offsets),
            nrows=int(A.nrows),
            nrows_pad=int(A.nrows_pad),
            sym_half=bool(A.sym_half),
        )
    if kind == "DenseMatrix":
        return formats.DenseMatrix(
            data=_t(A.data, device),
            nrows=int(A.nrows),
            nrows_pad=int(A.nrows_pad),
            bs=int(A.bs),
        )
    raise TypeError(f"level format {kind} has no port")


def _smoother(sm, device):
    if sm is None:
        return None
    kind = type(sm).__name__
    if kind == "ChebyshevSmoother":
        return ChebyshevSmoother(
            Dinv=_t(sm.Dinv, device),
            lam_max=np.asarray(sm.lam_max),
            lam_min=np.asarray(sm.lam_min),
            order=int(sm.order),
            steps=int(sm.steps),
        )
    raise TypeError(f"smoother {kind} has no port")


def _transfer(T, A, device):
    if T is None:
        return None
    kind = type(T).__name__
    cls = {
        "LatticeProlongation": LatticeProlongation,
        "LatticeRestriction": LatticeRestriction,
    }.get(kind)
    if cls is None:
        raise TypeError(f"transfer {kind} has no port")
    return cls(
        A=A,  # the level's own (converted) operator, as on the device
        Dinv=_t(T.Dinv, device),
        dims_f=tuple(int(v) for v in T.dims_f),
        dims_c=tuple(int(v) for v in T.dims_c),
        omega=float(T.omega),
        nf=int(T.nf),
        nf_pad=int(T.nf_pad),
        nc=int(T.nc),
        nc_pad=int(T.nc_pad),
    )


def from_jax_operator(op_np, device="cpu") -> AMGOperator:
    """This package's AMGOperator holding the same data as ``op_np``."""
    if getattr(op_np, "cluster_corr", None) is not None:
        raise TypeError("cluster correction has no port")
    levels = []
    for lev in op_np.levels:
        A = _format(lev.A, device)
        levels.append(
            DeviceLevel(
                A=A,
                smoother=_smoother(lev.smoother, device),
                P=_transfer(lev.P, A, device),
                R=_transfer(lev.R, A, device),
            )
        )
    ci = op_np.coarse_inv
    return AMGOperator(
        levels=tuple(levels),
        coarse_inv=None if ci is None else _t(ci, device),
        cycle=str(op_np.cycle),
    )
