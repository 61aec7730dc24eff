"""Host-side smoother construction (the reference's `BuildSmoother`).

Copied from ngsamg_tpu/smoothers/build.py, Chebyshev branches only: the
broadcast-scalar branch for uniform stencil levels and the generic
diagonal branch (with its host power iteration for lambda_max). Jacobi,
l1-Jacobi and the Gauss-Seidel family wait for their slices. The result
holds numpy arrays; precond/amg.py moves them to the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..config import SmootherOptions, SmootherType
from ..sparse.host import block_diagonal_fast, to_bsr
from .core import ChebyshevSmoother


def _pinv_blocks(D: np.ndarray) -> np.ndarray:
    """Batched pseudo-inverse of small (bs, bs) diagonal blocks."""
    bs = D.shape[-1]
    if bs == 1:
        d = D[:, 0, 0]
        out = np.where(np.abs(d) > 1e-300, 1.0 / np.where(d == 0, 1, d), 0.0)
        return out.reshape(-1, 1, 1)
    return np.linalg.pinv(D, rcond=1e-12)


def _cheby_order(opts: SmootherOptions, level: int, bs: int) -> int:
    """Resolve the per-energy Chebyshev order default (3 scalar, 5 block)."""
    co = opts.cheby_order.get(level)
    if co is None:
        return 5 if bs > 1 else 3
    return int(co)


def _cheby_lower(opts: SmootherOptions, level: int, bs: int) -> float:
    """Resolve the per-energy Chebyshev window start (0.30 scalar, 0.25
    block)."""
    cl = opts.cheby_lower.get(level)
    if cl is None:
        return 0.25 if bs > 1 else 0.30
    return float(cl)


def _lam_max_estimate(A: sp.spmatrix, bs: int, Dinv: np.ndarray, iters=12):
    """Power-iteration estimate of lambda_max(D^-1 A) on the host."""
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    lam = 2.0
    # block levels iterate on the cached BSR view (~bs^2 less index work
    # per matvec than the scalar CSR, the same sums)
    Ac = to_bsr(A, bs) if bs > 1 else A.tocsr()
    for _ in range(iters):
        y = Ac @ x
        y = np.einsum("nij,nj->ni", Dinv, y.reshape(-1, bs)).ravel()
        nrm = np.linalg.norm(y)
        if nrm == 0:
            break
        lam = nrm
        x = y / nrm
    return float(lam) * 1.05  # safety margin


def build_smoother(
    A: sp.spmatrix | None,
    bs: int,
    opts: SmootherOptions,
    level: int,
    nrows_pad: int,
    dtype,
    stencil=None,
) -> ChebyshevSmoother:
    """Build the (host-staged) Chebyshev smoother for one level.

    ``stencil`` (a transfer/stencil LatticeOp or ClampedOp) replaces ``A``
    on structured levels: the diagonal and the lambda_max estimate come
    from the stencil arrays.
    """
    kind = SmootherType(opts.type.get(level))
    if kind != SmootherType.CHEBYSHEV:
        raise NotImplementedError(
            f"smoother {kind.value!r}: ngsamg_tpu_torch ports Chebyshev "
            "only; the Jacobi and GS families are ROADMAP queue 1 item 4"
        )
    steps = int(opts.steps.get(level))
    if stencil is not None:
        if bs != 1:
            raise ValueError("stencil levels are scalar")
        # uniform levels: broadcast-scalar Dinv (skips expanding the
        # full diagonal and all of its per-sweep memory traffic)
        cd = stencil.constant_diagonal()
        if cd is not None and cd > 0:
            Dinv1 = np.full((1, 1, 1), 1.0 / cd, dtype=np.dtype(dtype))
            lam_max = stencil.power_lam()
            lam_min = _cheby_lower(opts, level, bs) * lam_max
            return ChebyshevSmoother(
                Dinv=Dinv1,
                lam_max=np.asarray(lam_max, dtype=np.dtype(dtype)),
                lam_min=np.asarray(lam_min, dtype=np.dtype(dtype)),
                order=_cheby_order(opts, level, bs),
                steps=max(steps, 1),
            )
        nv = stencil.n
        D = stencil.diagonal().reshape(-1, 1, 1)
    else:
        nv = A.shape[0] // bs
        D = block_diagonal_fast(A, bs)

    Dinv = _pinv_blocks(D)
    if stencil is not None:
        lam_max = stencil.power_lam()
    else:
        lam_max = _lam_max_estimate(A, bs, Dinv)
    lam_min = _cheby_lower(opts, level, bs) * lam_max
    Dinv_pad = np.zeros((nrows_pad, bs, bs), dtype=np.dtype(dtype))
    Dinv_pad[:nv] = Dinv
    return ChebyshevSmoother(
        Dinv=Dinv_pad,
        lam_max=np.asarray(lam_max, dtype=np.dtype(dtype)),
        lam_min=np.asarray(lam_min, dtype=np.dtype(dtype)),
        order=_cheby_order(opts, level, bs),
        steps=max(steps, 1),
    )
