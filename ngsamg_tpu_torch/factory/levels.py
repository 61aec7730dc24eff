"""AMG factory: the setup-phase level loop (host side).

Copied from ngsamg_tpu/factory/levels.py: the level capsule, the setup log,
CSR pruning and the structured fast path ``_stencil_setup``, which builds
the whole hierarchy of a full-lattice scalar H1 problem in the stencil
domain (transfer/stencil.py) plus a short scipy CSR tail. The generic
(unstructured) level loop is not ported yet: ``setup_levels`` raises for
any problem the fast path declines. numpy/scipy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..config import (
    AMGOptions,
    CoarsenType,
    EnergyType,
    ProlType,
    SmootherType,
)
from ..mesh.topo import AlgebraicMesh
from ..transfer.galerkin import rap


@dataclass
class SetupLevel:
    """Host-side capsule for one level (cf. `AMGLevel`, base_factory.hpp)."""

    index: int
    A: sp.csr_matrix | None  # scalar CSR; None on pure-stencil levels
    row_bs: int  # matrix block size (FEM dofs/vertex at this level)
    mesh: AlgebraicMesh
    P: sp.bsr_matrix | None = None  # prolongation next-coarser -> this level
    v2agg: np.ndarray | None = None
    # set when P can be applied implicitly on device (lattice levels):
    # dict(dims_f, dims_c, omega) — see transfer/lattice_transfer.py
    lattice_transfer: dict | None = None
    # structured fast path: the level operator in stencil form
    # (transfer/stencil.LatticeOp); A may then be None except coarsest
    stencil: object | None = None


@dataclass
class FactoryLog:
    """Per-level setup statistics (`Logger`, base_factory.cpp:67-199)."""

    nvs: list = field(default_factory=list)
    nnzs: list = field(default_factory=list)

    @property
    def operator_complexity(self) -> float:
        return float(sum(self.nnzs) / max(self.nnzs[0], 1)) if self.nnzs else 0.0

    @property
    def vertex_complexity(self) -> float:
        return float(sum(self.nvs) / max(self.nvs[0], 1)) if self.nvs else 0.0

    def summary(self) -> str:
        lines = ["level     nv         nnz"]
        for i, (nv, nnz) in enumerate(zip(self.nvs, self.nnzs)):
            lines.append(f"{i:5d} {nv:10d} {nnz:11d}")
        lines.append(
            f"operator complexity {self.operator_complexity:.3f}, "
            f"vertex complexity {self.vertex_complexity:.3f}"
        )
        return "\n".join(lines)


def _stencil_setup(
    A: sp.csr_matrix, energy, opts: AMGOptions, coords
) -> tuple[list[SetupLevel], FactoryLog] | None:
    """Structured fast path: the whole hierarchy in stencil form.

    Eligible when the finest level is a full row-major lattice, the energy
    is scalar ALG H1, coarsening is AUTO/LATTICE, prolongation is smoothed,
    and no level asks for a GS smoother (GS needs color permutations that
    break implicit transfers). Returns None when ineligible.
    """
    from ..apps.h1 import H1Energy
    from ..coarsen.lattice import detect_lattice, detect_lattice_rowmajor
    from ..transfer import stencil as st

    if not opts.lattice_fast or opts.energy != EnergyType.ALG:
        return None
    if not isinstance(energy, H1Energy) or energy.dpv != 1:
        return None
    lc = opts.levels
    nprobe = lc.max_levels + 1
    if not all(
        CoarsenType(opts.coarsen.algo.get(l))
        in (CoarsenType.AUTO, CoarsenType.LATTICE)
        for l in range(nprobe)
    ):
        return None
    if not all(
        ProlType(opts.prol.type.get(l)) == ProlType.SMOOTHED
        for l in range(nprobe)
    ):
        return None
    fast_smoothers = {
        SmootherType.CHEBYSHEV,
        SmootherType.JACOBI,
        SmootherType.L1_JACOBI,
    }
    if not all(
        SmootherType(opts.smoother.type.get(l)) in fast_smoothers
        for l in range(nprobe)
    ):
        return None

    nv = A.shape[0]
    # O(n), sort-free check for the dominant case (full row-major lattice)
    dims = detect_lattice_rowmajor(coords) if coords is not None else None
    if dims is None:
        det = detect_lattice(coords) if coords is not None else None
        if det is None:
            return None
        idx, dims = det
        if int(np.prod(dims)) != nv:
            return None  # partial lattice
        key = np.zeros(nv, dtype=np.int64)
        for k in range(idx.shape[1]):
            key = key * dims[k] + idx[:, k]
        if not np.array_equal(key, np.arange(nv)):
            return None  # not row-major ordered
    if int(np.prod(dims)) != nv:
        return None
    op = None
    offs_u = vals = None
    if isinstance(A, sp.dia_matrix):
        # uniform fast path first: avoids materializing the (noffs, n)
        # LatticeOp
        uni = st.uniform_from_dia(A, dims)
        if uni is not None:
            offs_u, vals = uni
        else:
            op = st.from_dia(A, dims)
            if op is None:
                return None
    else:
        op = st.from_csr(A.tocsr(), dims)
        if op is None:
            return None
    # constant-coefficient detection: the whole hierarchy is then
    # clamp-structured and computed on small patches (stencil.ClampedOp)
    if op is not None:
        vals = st.detect_uniform(op)
        offs_u = op.offs
    if CoarsenType(opts.coarsen.algo.get(0)) == CoarsenType.AUTO:
        # AUTO requires near-uniform couplings (jump problems need
        # energy-driven matching)
        t0 = st._find_zero_offset(offs_u)
        if vals is not None:
            w = np.abs(np.delete(vals, t0))
        else:  # subsampled: statistically equivalent for a 30x criterion
            w = np.abs(
                np.concatenate(
                    [
                        op.data[t].ravel()[::17]
                        for t in range(len(op.offs))
                        if t != t0
                    ]
                )
            )
        w = w[w > 1e-8 * max(float(w.max(initial=0.0)), 1e-300)]
        if len(w) and float(np.quantile(w, 0.99)) > 30.0 * float(
            np.quantile(w, 0.01)
        ):
            return None
    if vals is not None and nv > 32768:
        cur = st.compress_uniform(tuple(int(x) for x in dims), offs_u, vals)
    elif op is not None:
        cur = op
    else:  # small uniform lattice: materialize (cheap at this size)
        cur = st.synth_uniform(tuple(int(x) for x in dims), offs_u, vals)

    def ph_mesh(n):
        return AlgebraicMesh(nv=n, edges=np.zeros((0, 2), dtype=np.int64))

    log = FactoryLog()
    levels = [
        SetupLevel(
            index=0, A=A, row_bs=1, mesh=ph_mesh(nv), stencil=cur
        )
    ]
    log.nvs.append(nv)
    log.nnzs.append(cur.nnz)
    lvl = 0
    # stencil-domain loop for the big levels; once patches stop compressing
    # and offset counts grow, scipy CSR products are cheaper
    SMALL = 40_000
    while (
        lvl + 1 < lc.max_levels
        and cur.n > lc.max_coarse_size
        and cur.n > SMALL
    ):
        rho = cur.gershgorin()
        omega = float(opts.prol.omega.get(lvl)) / max(rho, 1e-12)
        if isinstance(cur, st.ClampedOp):
            opc = st.rap_clamped(cur, omega, opts.stencil_prune_tol)
        else:
            opc, _dinv = st.smoothed_rap(cur, omega)
            opc = st.prune(opc, opts.stencil_prune_tol)
        levels[-1].lattice_transfer = {
            "dims_f": tuple(int(x) for x in cur.dims),
            "dims_c": tuple(int(x) for x in opc.dims),
            "omega": omega,
        }
        levels.append(
            SetupLevel(
                index=lvl + 1,
                A=None,
                row_bs=1,
                mesh=ph_mesh(opc.n),
                stencil=opc,
            )
        )
        log.nvs.append(opc.n)
        log.nnzs.append(opc.nnz)
        cur = opc
        lvl += 1

    # explicit CSR tail (scipy RAP + explicit/implicit lattice transfers)
    from ..transfer.lattice_transfer import host_lattice_prol

    cur_full = st.expand(cur) if isinstance(cur, st.ClampedOp) else cur
    A_cur = st.to_csr(cur_full)
    levels[-1].A = A_cur
    dims_cur = np.asarray(cur.dims, dtype=np.int64)
    while lvl + 1 < lc.max_levels and A_cur.shape[0] > lc.max_coarse_size:
        grids = np.meshgrid(
            *[np.arange(d) for d in dims_cur], indexing="ij"
        )
        idx = np.stack([g.ravel() for g in grids], axis=1)
        cdims = (dims_cur + 1) // 2
        cidx = idx // 2
        key = np.zeros(len(idx), dtype=np.int64)
        for k in range(idx.shape[1]):
            key = key * cdims[k] + cidx[:, k]
        nc = int(np.prod(cdims))
        diag = A_cur.diagonal()
        rowsum = np.asarray(abs(A_cur).sum(axis=1)).ravel()
        rho = float(
            (rowsum / np.where(diag > 0, diag, 1.0)).max(initial=1.0)
        )
        omega = float(opts.prol.omega.get(lvl)) / max(rho, 1e-12)
        P, _ = host_lattice_prol(A_cur, idx, dims_cur, key, nc, omega)
        Ac = rap(A_cur, P, dtype=np.float64)
        Ac = prune_csr(Ac, opts.stencil_prune_tol)
        levels[-1].P = P.tobsr(blocksize=(1, 1))
        levels[-1].lattice_transfer = {
            "dims_f": tuple(int(x) for x in dims_cur),
            "dims_c": tuple(int(x) for x in cdims),
            "omega": omega,
        }
        levels.append(
            SetupLevel(
                index=lvl + 1, A=Ac, row_bs=1, mesh=ph_mesh(nc)
            )
        )
        log.nvs.append(nc)
        log.nnzs.append(Ac.nnz)
        A_cur = Ac
        dims_cur = cdims
        lvl += 1
    return levels, log


def prune_csr(A: sp.csr_matrix, tol: float) -> sp.csr_matrix:
    """Row-sum-preserving weak-entry pruning of a CSR operator.

    CSR counterpart of stencil.prune: off-diagonal entries below
    ``tol * min(diag) / 256`` are lumped (signed) onto their row diagonal;
    row sums — the AMG near-kernel energies — are preserved exactly.
    """
    if tol <= 0:
        return A
    d = A.diagonal()
    pos = d[d > 0]
    if not len(pos):
        return A
    thr = tol * float(pos.min()) / 256.0
    coo = A.tocoo()
    off = coo.row != coo.col
    drop = off & (np.abs(coo.data) < thr)
    if not drop.any():
        return A
    n = A.shape[0]
    lump = np.bincount(coo.row[drop], weights=coo.data[drop], minlength=n)
    keep = ~drop
    out = sp.coo_matrix(
        (
            np.concatenate([coo.data[keep], lump]),
            (
                np.concatenate([coo.row[keep], np.arange(n)]),
                np.concatenate([coo.col[keep], np.arange(n)]),
            ),
        ),
        shape=A.shape,
    ).tocsr()
    out.sum_duplicates()
    return out


def setup_levels(
    A: sp.spmatrix,
    energy,
    opts: AMGOptions,
    coords: np.ndarray | None = None,
) -> tuple[list[SetupLevel], FactoryLog]:
    """Run the level loop; returns host levels (finest first) + log.

    Only the structured fast path is ported: a problem it declines (no
    full row-major lattice, non-H1 energy, GS smoothers, piecewise
    prolongation, ...) raises instead of running another algorithm.
    """
    res = _stencil_setup(A, energy, opts, coords)
    if res is None:
        raise NotImplementedError(
            "ngsamg_tpu_torch runs the structured stencil-domain setup only; "
            "the generic level loop is ROADMAP queue 1 item 2 (unstructured "
            "scalar levels with tile-ELL)"
        )
    return res
