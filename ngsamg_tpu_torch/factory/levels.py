"""AMG factory: the setup-phase level loop (host side).

Copied from ngsamg_tpu/factory/levels.py: the level capsule, the setup log,
CSR pruning, the structured fast path ``_stencil_levels`` (the whole
hierarchy of a full-lattice scalar H1 problem in the stencil domain,
transfer/stencil.py, plus a short scipy CSR tail), and the generic level
loop of ``setup_levels`` with its coarse-map and prolongation dispatch,
the reference's `BaseAMGFactory::SetUpLevels` / `VertexAMGFactory`
(base_factory.cpp:219-720, vertex_factory_impl.hpp). Per level:

  1. strength graph from mesh energy data,
  2. coarse map: lattice blocks (AUTO on lattice coordinates), pairwise
     agglomeration (SPW) or MIS-seeded aggregation (MIS),
  3. accept/reject by coarsening ratio,
  4. prolongation (piecewise or smoothed),
  5. Galerkin RAP -> next level matrix, mesh data mapped through the
     aggregation.

Block energies fold the finest-level embedding into P and take the block
RAP in the native fused kernel (``native.rap_bsr``), or with
``native.HAVE_NATIVE`` off on scipy's BSR products. Element-matrix (ELMAT) finest meshes are not
ported (the front-end rejects ``elmat_data``).
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
from .. import native
from ..apps.base import Energy
from ..coarsen import pairwise
from ..mesh.topo import AlgebraicMesh, map_edges
from ..sparse.host import to_bsr
from ..transfer.galerkin import rap
from ..transfer.prolongation import piecewise_prol, smoothed_prol
from ..utils import timers


@dataclass
class SetupLevel:
    """Host-side capsule for one level (cf. `AMGLevel`, base_factory.hpp)."""

    index: int
    A: sp.csr_matrix | None  # scalar CSR; None on pure-stencil levels
    row_bs: int  # matrix block size (FEM dofs/vertex at this level)
    mesh: AlgebraicMesh
    P: sp.bsr_matrix | None = None  # prolongation next-coarser -> this level
    P_amg: sp.bsr_matrix | None = None  # P before the finest embedding fold
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
    # distributed setup only (parallel/dist_setup.py): max resident bytes
    # of any ONE shard's level-loop state vs the finest global matrix
    peak_shard_bytes: int = 0
    finest_global_bytes: int = 0
    # distributed setup only: the level loop's redistribution decisions
    # (level, active_before, active_after, reason) and the ACTIVE shard
    # count per level
    contract_decisions: list = field(default_factory=list)
    shards_per_level: list = field(default_factory=list)
    # distributed setup only: max over tracking points of (largest shard's
    # state x n_shards / total state); 1.0 = perfectly balanced
    state_balance: float = 0.0
    # multi-process setup only (parallel/mp_runtime.py): each rank's log
    # and transport statistics
    mp_rank_stats: list = field(default_factory=list)

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


def build_coarse_map(
    energy: Energy, mesh: AlgebraicMesh, opts: AMGOptions, level: int
):
    """Dispatch the coarsening algorithm (`BuildCoarseMap`,
    vertex_factory_impl.hpp:503-530)."""
    c = opts.coarsen
    algo = CoarsenType(c.algo.get(level))
    if algo in (CoarsenType.AUTO, CoarsenType.LATTICE):
        from ..coarsen.lattice import lattice_aggregate

        pos = energy.vertex_positions(mesh)
        ok = pos is not None
        if ok and algo == CoarsenType.AUTO:
            # AUTO requires near-uniform connection strengths: lattice
            # blocks ignore coefficient jumps, which energy-driven matching
            # respects (jump tests regress otherwise)
            w = mesh.edge_data.get("wt")
            if w is not None and len(w):
                # ignore numerically-zero couplings (assembly roundoff)
                wpos = w[w > 1e-8 * max(float(w.max()), 1e-300)]
                ok = len(wpos) == 0 or (
                    float(np.quantile(wpos, 0.99))
                    <= 30.0 * float(np.quantile(wpos, 0.01))
                )
        res = lattice_aggregate(pos) if ok else None
        if res is not None:
            return res
        if algo == CoarsenType.LATTICE:
            raise ValueError("lattice coarsening: vertices are not a lattice")
        algo = CoarsenType.SPW  # AUTO fallback
    if algo == CoarsenType.PLATE:
        pos = energy.vertex_positions(mesh)
        return pairwise.plate_test_aggregate(pos)
    r = c.robust.get(level)
    robust = (
        getattr(energy, "default_robust", False) if r is None else bool(r)
    ) and hasattr(energy, "soc_robust")
    aaf = c.aaf.get(level)
    if algo == CoarsenType.SPW:
        # per-round re-evaluation against current coarse energies
        # (spw_agg_impl.hpp:1440-1831): every matching round rebuilds the
        # intermediate coarse mesh (SIGNED Galerkin weight sums — net-zero
        # couplings between sub-clusters stop looking strong) and
        # re-scores candidates; with `robust` the scoring is the
        # pencil-EVP SOC (default ON for elasticity)
        sred = c.soc_reduction.get(level)
        return pairwise.spw_aggregate_energy(
            energy,
            mesh,
            rounds=int(c.spw_rounds.get(level)),
            theta=float(c.theta.get(level)),
            adopt_orphans=bool(c.adopt_orphans.get(level)),
            aaf=None if aaf is None else float(aaf),
            robust=robust,
            neib_boost=bool(c.neib_boost.get(level)),
            scal_rel_thresh=float(c.scal_rel_thresh.get(level)),
            soc_reduction=None if sred is None else str(sred),
            diag_stab_boost=float(c.diag_stab_boost.get(level)),
            big_soc=bool(c.big_soc.get(level)),
            big_soc_rho=c.big_soc_rho.get(level),
        )
    from ..coarsen.mis import mis_aggregate

    soc = energy.soc_robust(mesh) if robust else energy.soc(mesh)
    S = mesh.edge_graph(weights=soc)
    return mis_aggregate(S, theta=float(c.theta.get(level)))


def build_prolongation(
    energy: Energy,
    mesh_f: AlgebraicMesh,
    mesh_c: AlgebraicMesh,
    v2agg: np.ndarray,
    opts: AMGOptions,
    level: int,
    A: sp.spmatrix | None = None,
    row_bs: int | None = None,
) -> sp.bsr_matrix:
    """Piecewise or smoothed prolongation in the AMG (dpv) space.

    ``A``/``row_bs`` enable the semi-aux classic-row choice (rows smoothed
    with the real level matrix where its coarse fan-out is bounded)."""
    P_pw = piecewise_prol(energy, mesh_f, mesh_c, v2agg)
    ptype = ProlType(opts.prol.type.get(level))
    if ptype == ProlType.PIECEWISE:
        return P_pw
    return smoothed_prol(
        energy,
        mesh_f,
        mesh_c,
        v2agg,
        P_pw,
        omega=float(opts.prol.omega.get(level)),
        max_per_row=int(opts.prol.max_per_row.get(level)),
        min_frac=float(opts.prol.min_frac.get(level)),
        A=A,
        row_bs=row_bs,
        max_classic=int(opts.prol.max_classic.get(level)),
    )


def _lattice_transfer_plan(energy, cur, mesh_c, v2agg, n_agg, opts, lvl):
    """Implicit-transfer plan for full-lattice scalar levels.

    Conditions: dpv == 1, smoothed prolongation requested, both levels are
    FULL row-major lattices, and the aggregation is exactly the 2^d index
    blocking — then P = (I - omega D^-1 A) P_pw with P_pw a pure
    reshape/upsample, applied implicitly on device (no stored transfer).
    Returns (P_explicit_for_RAP, meta) or None.
    """
    from ..coarsen.lattice import detect_lattice
    from ..transfer.lattice_transfer import host_lattice_prol
    from ..transfer.prolongation import _rho_estimate

    if energy.dpv != 1 or cur.row_bs != 1:
        return None
    if ProlType(opts.prol.type.get(lvl)) != ProlType.SMOOTHED:
        return None
    pos_f = energy.vertex_positions(cur.mesh)
    pos_c = energy.vertex_positions(mesh_c)
    det_f = detect_lattice(pos_f)
    det_c = detect_lattice(pos_c)
    if det_f is None or det_c is None:
        return None
    idx_f, dims_f = det_f
    idx_c, dims_c = det_c
    nf, nc = cur.mesh.nv, n_agg
    if np.prod(dims_f) != nf or np.prod(dims_c) != nc:
        return None  # partial lattice
    # vertices must be stored in row-major lattice order on both levels
    key_f = np.zeros(nf, dtype=np.int64)
    for k in range(idx_f.shape[1]):
        key_f = key_f * dims_f[k] + idx_f[:, k]
    if not np.array_equal(key_f, np.arange(nf)):
        return None
    key_c = np.zeros(nc, dtype=np.int64)
    for k in range(idx_c.shape[1]):
        key_c = key_c * dims_c[k] + idx_c[:, k]
    if not np.array_equal(key_c, np.arange(nc)):
        return None
    # aggregation must be the index blocking
    cidx = idx_f // 2
    agg_key = np.zeros(nf, dtype=np.int64)
    for k in range(idx_f.shape[1]):
        agg_key = agg_key * dims_c[k] + cidx[:, k]
    if not np.array_equal(agg_key, v2agg):
        return None
    A = cur.A
    d = A.diagonal()
    dinv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    rho = _rho_estimate(lambda x: dinv * x, A)
    omega = float(opts.prol.omega.get(lvl)) / max(rho, 1e-12)
    P, _ = host_lattice_prol(A, idx_f, dims_f, agg_key, nc, omega)
    meta = {
        "dims_f": tuple(int(x) for x in dims_f),
        "dims_c": tuple(int(x) for x in dims_c),
        "omega": omega,
    }
    return P.tobsr(blocksize=(1, 1)), meta


def _stencil_finest(A: sp.spmatrix, energy, opts: AMGOptions, coords):
    """The structured fast path's finest level in stencil form, or None
    where the path does not apply.

    Eligible when the finest level is a full row-major lattice, the energy
    is scalar ALG H1, coarsening is AUTO/LATTICE, prolongation is smoothed,
    and no level asks for a GS smoother (GS needs color permutations that
    break implicit transfers).
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
        return st.compress_uniform(tuple(int(x) for x in dims), offs_u, vals)
    if op is not None:
        return op
    # small uniform lattice: materialize (cheap at this size)
    return st.synth_uniform(tuple(int(x) for x in dims), offs_u, vals)


def _stencil_levels(A, cur, opts: AMGOptions, level):
    """Structured fast path: the whole hierarchy in stencil form from the
    finest stencil ``cur`` (:func:`_stencil_finest`). ``level`` is the
    finest level's open ``setup.level`` span; each level's span closes when
    its coarse level is made, and the coarsest one's at the end.

    Phases: ``setup.prol`` is the Gershgorin bound and omega; on stencil
    levels ``setup.rap`` is the fused smoothed RAP (``rap_clamped``, or
    ``smoothed_rap`` and ``prune``), which also builds the implicit
    prolongation, and the last stencil level's CSR form; on the CSR tail
    ``setup.coarsen`` is the index blocking, ``setup.prol`` the explicit
    lattice prolongation and ``setup.rap`` scipy's RAP and pruning.
    """
    from ..transfer import stencil as st

    lc = opts.levels

    def ph_mesh(n):
        return AlgebraicMesh(nv=n, edges=np.zeros((0, 2), dtype=np.int64))

    log = FactoryLog()
    levels = [
        SetupLevel(
            index=0, A=A, row_bs=1, mesh=ph_mesh(A.shape[0]), stencil=cur
        )
    ]
    log.nvs.append(A.shape[0])
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
        with timers.span("setup.prol"):
            rho = cur.gershgorin()
            omega = float(opts.prol.omega.get(lvl)) / max(rho, 1e-12)
        with timers.span("setup.rap"):
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
        level.close()
        level = timers.span("setup.level", level=lvl)

    # explicit CSR tail (scipy RAP + explicit/implicit lattice transfers)
    from ..transfer.lattice_transfer import host_lattice_prol

    with timers.span("setup.rap"):
        cur_full = st.expand(cur) if isinstance(cur, st.ClampedOp) else cur
        A_cur = st.to_csr(cur_full)
    levels[-1].A = A_cur
    dims_cur = np.asarray(cur.dims, dtype=np.int64)
    while lvl + 1 < lc.max_levels and A_cur.shape[0] > lc.max_coarse_size:
        with timers.span("setup.coarsen"):
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
        with timers.span("setup.prol"):
            diag = A_cur.diagonal()
            rowsum = np.asarray(abs(A_cur).sum(axis=1)).ravel()
            rho = float(
                (rowsum / np.where(diag > 0, diag, 1.0)).max(initial=1.0)
            )
            omega = float(opts.prol.omega.get(lvl)) / max(rho, 1e-12)
            P, _ = host_lattice_prol(A_cur, idx, dims_cur, key, nc, omega)
        with timers.span("setup.rap"):
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
        level.close()
        level = timers.span("setup.level", level=lvl)
    level.close()
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
    energy: Energy,
    opts: AMGOptions,
    coords: np.ndarray | None = None,
    finest_mesh: AlgebraicMesh | None = None,
) -> tuple[list[SetupLevel], FactoryLog]:
    """Run the level loop; returns host levels (finest first) + log.

    Full-lattice problems take the structured fast path; everything else
    runs the generic loop on the matrix-extracted (ALG) energy mesh.
    ``finest_mesh`` overrides that mesh: the ELMAT mode, where the mesh
    energies come from element matrices (apps/elmat.py), and which always
    takes the generic loop.

    In the current recorder (utils/timers.py) each level gets one
    ``setup.level`` span; its phases are ``setup.mesh`` (the finest
    level's: lattice detection and compression, or the energy's mesh),
    ``setup.coarsen`` (the coarse map, ``map_edges``, ``map_data``),
    ``setup.prol`` (the prolongation, with the finest embedding) and
    ``setup.rap`` (the Galerkin product).
    """
    lc = opts.levels
    # a level's span opens before its work and closes when its coarse
    # level is made; the coarsest level's closes at the end
    level = timers.span("setup.level", level=0)
    with timers.span("setup.mesh"):
        # the fast path accepts DIA input directly (no CSR conversion)
        cur = (_stencil_finest(A, energy, opts, coords)
               if finest_mesh is None else None)
        if cur is None:
            A = A.tocsr()
            if A.dtype != np.float64:
                A = A.astype(np.float64)
            mesh = finest_mesh or energy.build_finest_mesh(A, coords)
    if cur is not None:
        return _stencil_levels(A, cur, opts, level)
    log = FactoryLog()
    row_bs = A.shape[0] // mesh.nv
    levels = [SetupLevel(index=0, A=A, row_bs=row_bs, mesh=mesh)]
    log.nvs.append(mesh.nv)
    log.nnzs.append(A.nnz)

    lvl = 0
    while (
        lvl + 1 < lc.max_levels
        and levels[-1].mesh.nv > lc.max_coarse_size
    ):
        cur = levels[-1]
        with timers.span("setup.coarsen"):
            v2agg, n_agg = build_coarse_map(energy, cur.mesh, opts, lvl)
            if n_agg >= lc.min_coarsen_ratio * cur.mesh.nv or n_agg == 0:
                break  # coarsening stuck (TryCoarseStep rejection)
            coarse_edges, e2ce = map_edges(cur.mesh, v2agg, n_agg)
            mesh_c = energy.map_data(cur.mesh, v2agg, n_agg, coarse_edges,
                                     e2ce)
        with timers.span("setup.prol"):
            lat = _lattice_transfer_plan(
                energy, cur, mesh_c, v2agg, n_agg, opts, lvl
            )
            if lat is not None:
                P, meta = lat
                cur.lattice_transfer = meta
            else:
                P = build_prolongation(
                    energy, cur.mesh, mesh_c, v2agg, opts, lvl,
                    A=cur.A, row_bs=cur.row_bs,
                )
            E = energy.embedding_matrix(cur.mesh) if lvl == 0 else None
            if E is not None:
                cur.P_amg = P  # pre-embedding (dpv-space) prolongation
                P = (E @ P).tobsr(blocksize=(cur.row_bs, energy.dpv))
        # Galerkin products ALWAYS in f64 on the host: the device staging
        # casts to the solve dtype afterwards (an f32 RAP fuzzes exact
        # coarse null modes to ~1e-7, and the 3D-elasticity coarsest
        # matrix then takes a garbage Cholesky inverse)
        with timers.span("setup.rap"):
            Ac = None
            if energy.dpv > 1 and sp.issparse(P) and P.format == "bsr" \
                    and P.blocksize == (cur.row_bs, energy.dpv):
                # fused conversion-free block RAP on the cached BSR view of
                # A; the coarse BSR is seeded into the coarse CSR's cache,
                # so the block consumers downstream skip csr -> bsr
                A_b = to_bsr(cur.A, cur.row_bs)
                Ac_b = native.rap_bsr(A_b, P)
                if Ac_b is not None:
                    Ac = Ac_b.tocsr()
                    # block storage keeps explicit zeros inside blocks
                    # (e.g. the diagonal kron blocks of vector H1); the
                    # scalar route never stores them
                    Ac.eliminate_zeros()
                    Ac.has_canonical_format = True
                    Ac._amg_bsr_cache = (energy.dpv, Ac_b)
                else:
                    Ac = rap(
                        cur.A, P, dtype=np.float64, bs_r=cur.row_bs,
                        bs_c=energy.dpv,
                    )
            if Ac is None:
                Ac = rap(cur.A, P, dtype=np.float64)
        cur.P = P
        cur.v2agg = v2agg
        levels.append(
            SetupLevel(index=lvl + 1, A=Ac, row_bs=energy.dpv, mesh=mesh_c)
        )
        log.nvs.append(mesh_c.nv)
        log.nnzs.append(Ac.nnz)
        lvl += 1
        level.close()
        level = timers.span("setup.level", level=lvl)
    level.close()
    return levels, log
