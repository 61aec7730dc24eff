"""Implicit lattice transfers: gather-free smoothed prolongation on device.

Port of ngsamg_tpu/transfer/lattice_transfer.py. For lattice-coarsened
scalar levels the tentative prolongation P_pw is a pure index map (fine
cell (i,j,k) -> coarse cell (i//2, j//2, k//2)), so the smoothed
prolongation

    P = (I - omega D^-1 A) P_pw

is applied implicitly: upsample, one matvec with the level's own operator
A (K1 or K2/K3 on the card), one diagonal scale. Restriction is the exact
transpose: diagonal scale + matvec + block-sum downsample. Pad rows stay
zero because A's matvec zeroes its tail and the up/downsamples slice to
the real rows and pad back.

The host factory builds the same P explicitly (``host_lattice_prol``) for
the Galerkin product, so the device applies exactly the operator that
produced the coarse matrices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..sparse.formats import matvec as _matvec


@dataclass(frozen=True)
class LatticeProlongation:
    """x_f = (I - omega Dinv A) . upsample(x_c)."""

    A: object  # the fine-level operator (StencilDia | DiaMatrix), shared
    Dinv: torch.Tensor  # (nf_pad, 1), or (1, 1) broadcast on uniform levels
    dims_f: tuple
    dims_c: tuple
    omega: float
    nf: int
    nf_pad: int
    nc: int
    nc_pad: int


@dataclass(frozen=True)
class LatticeRestriction:
    """x_c = downsample_sum((I - omega A Dinv) . r_f) — exact P^T."""

    A: object
    Dinv: torch.Tensor
    dims_f: tuple
    dims_c: tuple
    omega: float
    nf: int
    nf_pad: int
    nc: int
    nc_pad: int


def _upsample(xc: torch.Tensor, dims_c, dims_f) -> torch.Tensor:
    """coarse lattice vector -> fine lattice vector by index halving."""
    g = xc.reshape(dims_c)
    for ax, fc in enumerate(dims_f):
        g = torch.repeat_interleave(g, 2, dim=ax)
        if g.shape[ax] != fc:  # odd fine dimension
            g = g.narrow(ax, 0, fc)
    return g.reshape(-1)


def _downsample_sum(xf: torch.Tensor, dims_f, dims_c) -> torch.Tensor:
    """fine -> coarse by summing each 2^d index block (upsample^T)."""
    g = xf.reshape(dims_f)
    for ax, (fc, cc) in enumerate(zip(dims_f, dims_c)):
        if fc % 2:  # pad odd dims with a zero plane
            shape = list(g.shape)
            shape[ax] = 1
            g = torch.cat([g, g.new_zeros(shape)], dim=ax)
        shape = list(g.shape)
        shape[ax] = cc
        shape.insert(ax + 1, 2)
        g = g.reshape(shape).sum(dim=ax + 1)
    return g.reshape(-1)


def lattice_prol_apply(P: LatticeProlongation, xc: torch.Tensor):
    u = _upsample(xc[: P.nc, 0], P.dims_c, P.dims_f)
    u = F.pad(u, (0, P.nf_pad - P.nf))[:, None]
    return u - P.omega * P.Dinv * _matvec(P.A, u)


def lattice_restrict_apply(R: LatticeRestriction, rf: torch.Tensor):
    w = rf - R.omega * _matvec(R.A, R.Dinv * rf)
    wc = _downsample_sum(w[: R.nf, 0], R.dims_f, R.dims_c)
    return F.pad(wc, (0, R.nc_pad - R.nc))[:, None]


# ---------------------------------------------------------------------------
# host side: the matching explicit P for the Galerkin product
# ---------------------------------------------------------------------------


def host_lattice_prol(A: sp.spmatrix, idx_f, dims_f, idx_c_of_f, nc, omega):
    """Explicit scipy P = (I - omega Dinv A) P_pw (must mirror the device).

    Copied from ngsamg_tpu/transfer/lattice_transfer.py. idx_f: (nf, d)
    fine lattice indices; idx_c_of_f: (nf,) coarse cell id of each fine
    vertex (row-major coarse ravel). Returns (P, Dinv).
    """
    nf = A.shape[0]
    P_pw = sp.csr_matrix(
        (np.ones(nf), (np.arange(nf), idx_c_of_f)), shape=(nf, nc)
    )
    d = A.diagonal()
    dinv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    P = (P_pw - omega * sp.diags(dinv) @ (A @ P_pw)).tocsr()
    P.sum_duplicates()
    return P, dinv
