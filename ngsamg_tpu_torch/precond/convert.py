"""Carry a staged ngsamg_tpu hierarchy over into this package's types.

``from_jax_operator(op_np)`` turns the JAX package's staged
``AMGOperator`` — with its leaves already read out as numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, pc.op)`` — into this package's
:class:`~ngsamg_tpu_torch.solve.cycle.AMGOperator`, so both packages can run
one cycle on identical data: stencil, DIA, dense, tile-ELL and block-ELL
levels, lattice, tile-ELL and block-ELL transfers (square or rectangular
blocks), the Chebyshev, (l1-)Jacobi, multicolor GS (split or sliced),
block GS and Hiptmair smoothers (the Stokes hierarchies), the cluster
correction and an f32 or f64 coarse
inverse. A ``SupernodeELL`` (what the JAX package stages for
tile-ELL when its native packer is not built) is rebuilt as a matrix from
its blocks and packed with this package's tile-ELL packer. The JAX classes
are recognised by name; this module imports neither JAX nor ngsamg_tpu.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..smoothers.cluster_corr import ClusterCorrection
from ..smoothers.block import BlockGSSmoother
from ..smoothers.build import stage_smoother
from ..smoothers.core import ChebyshevSmoother, GSSmoother, JacobiSmoother
from ..smoothers.hiptmair import HiptmairSmoother
from ..solve.cycle import AMGOperator, DeviceLevel
from ..sparse import bell, formats
from ..transfer.lattice_transfer import LatticeProlongation, LatticeRestriction


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _index(a, device) -> torch.Tensor:
    """An index array (int32 in the JAX layout) as this package's int64."""
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


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
    if kind == "TileELL":
        return _tile_ell(A, device)
    if kind == "TileELLStack":
        return formats.TileELLStack(
            blocks=tuple(_tile_ell(b, device, bucket=True)
                         for b in A.blocks),
            nrows=int(A.nrows),
            nrows_pad=int(A.nrows_pad),
            ncols_pad=int(A.ncols_pad),
            tile_m=int(A.tile_m),
        )
    if kind == "SupernodeELL":
        return _supernode_as_tile_ell(A, device)
    if kind == "BlockELL":
        return bell.BlockELL(
            data=_t(A.data, device),
            cols=torch.from_numpy(
                np.array(A.cols, dtype=np.int32, copy=True)
            ).to(device),
            nrows=int(A.nrows),
            ncols=int(A.ncols),
            nrows_pad=int(A.nrows_pad),
            col_chunk=int(A.col_chunk),
        )
    raise TypeError(f"level format {kind} has no port")


def _tile_ell(A, device, bucket=False) -> formats.TileELL:
    return formats.TileELL(
        data=_t(A.data, device),
        cols=_index(A.cols, device),
        nrows=int(A.nrows),
        nrows_pad=int(A.nrows_pad),
        ncols_pad=int(A.ncols_pad),
        tile_m=int(A.tile_m),
        chunk_c=int(A.chunk_c),
        bucket=bucket,
    )


def _supernode_as_tile_ell(S, device) -> formats.TileELL:
    """The matrix a SupernodeELL holds, repacked as a TileELL of the same
    row and column padding."""
    B = S.inner
    if int(B.col_chunk) != 1:
        raise TypeError("column-chunked supernode blocks have no port")
    data = np.asarray(B.data)  # (block rows, K, tile_r, tile_c)
    cols = np.asarray(B.cols, dtype=np.int64)  # (block rows, K)
    nb, K, tr, tc = data.shape
    rows = np.arange(nb)[:, None, None, None] * tr + np.arange(tr)[:, None]
    cc = cols[:, :, None, None] * tc + np.arange(tc)
    nz = data != 0
    ncols = int(B.ncols) * tc
    C = sp.coo_matrix(
        (
            data[nz],
            (np.broadcast_to(rows, data.shape)[nz],
             np.broadcast_to(cc, data.shape)[nz]),
        ),
        shape=(nb * tr, ncols),
    ).tocsr()[: int(S.nrows)]
    return formats.tile_ell_from_scipy(
        C, data.dtype, nr_pad=int(S.nrows_pad), nc_pad=ncols, device=device,
    )


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
    if kind == "JacobiSmoother":
        return JacobiSmoother(
            Dinv=_t(sm.Dinv, device),
            omega=float(sm.omega),
            steps=int(sm.steps),
        )
    if kind == "GSSmoother":
        return GSSmoother(
            Dinv=_t(sm.Dinv, device),
            color_bounds=tuple(int(v) for v in sm.color_bounds),
            steps=int(sm.steps),
            cdata=tuple(_t(a, device) for a in sm.cdata),
            ccols=tuple(_index(a, device) for a in sm.ccols),
            cdinv=tuple(_t(a, device) for a in sm.cdinv),
        )
    if kind == "BlockGSSmoother":
        return BlockGSSmoother(
            blocks=_index(sm.blocks, device),
            Binv=_t(sm.Binv, device),
            color_bounds=tuple(int(v) for v in sm.color_bounds),
            steps=int(sm.steps),
        )
    if kind == "HiptmairSmoother":
        return HiptmairSmoother(
            range_sm=_smoother(sm.range_sm, device),
            pot_sm=_smoother(sm.pot_sm, device),
            A_pot=_format(sm.A_pot, device),
            C=_format(sm.C, device),
            CT=_format(sm.CT, device),
        )
    raise TypeError(f"smoother {kind} has no port")


def _transfer(T, A, device):
    if T is None:
        return None
    kind = type(T).__name__
    if kind in ("TileELL", "TileELLStack", "SupernodeELL", "BlockELL"):
        return _format(T, device)
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
    levels = []
    for lev in op_np.levels:
        A = _format(lev.A, device)
        sm = _smoother(lev.smoother, device)
        levels.append(
            DeviceLevel(
                A=A,
                # staged with its operator, as the port's own levels are:
                # a GS level the sweep kernel takes gets its launch plan
                smoother=None if sm is None else stage_smoother(sm, device,
                                                                A=A),
                P=_transfer(lev.P, A, device),
                R=_transfer(lev.R, A, device),
            )
        )
    ci = op_np.coarse_inv
    cc = op_np.cluster_corr
    return AMGOperator(
        levels=tuple(levels),
        coarse_inv=None if ci is None else _t(ci, device),
        cluster_corr=None if cc is None else ClusterCorrection(
            idx=_index(cc.idx, device), inv=_t(cc.inv, device)
        ),
        cycle=str(op_np.cycle),
    )
