"""Stokes AMG preconditioners (facet DOFs, Hiptmair smoothing) on PyTorch.

Port of ngsamg_tpu/precond/stokes.py, the reference's
`BaseStokesAMGPrecond`/`NCStokesAMGPC`/`HDivStokesAMGPC` front-ends
(stokes_pc.hpp:23+, stokes_pc.cpp:1300-1390 `BuildSmoothers`) over the
strict algebraic dual-mesh inputs of :mod:`ngsamg_tpu_torch.utils.stokes_fem`
(or any host discretization providing cell/facet geometry):

  setup: dual mesh -> per level {cell aggregation, flow/divergence
  preserving facet prolongation, Galerkin RAP, facet loops -> curl matrix}
  -> device hierarchy whose smoothers are Hiptmair pairs (range Chebyshev
  + potential-space Chebyshev through C).

The host level loops and ``_truncate_columns`` / ``_curl_smooth_prol`` are
numpy copies of the original. Staging follows it too: every level in the
shared format chooser with no row reordering, rectangular transfers and
curl matrices in tile-ELL with pinned interface pads, float32 on the
device, an f32 dense coarse inverse; the HDG and HDiv classes stage
block-ELL levels with a per-facet block GS. The solve is f64 defect
correction on the host around the f32 device PCG. Each class takes
``device`` ("cuda" by default: DIA levels run the hand-written DIA kernel;
"cpu" runs every plain version) and raises when CUDA is absent.

``options.dist_setup > 1`` off a lattice builds the hierarchy with the
distributed Stokes setup (parallel/dist_stokes.py), as in the JAX
package; a lattice dual mesh keeps the serial setup.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..apps import stokes as st
from ..apps.stokes_hdiv import (
    MeshDOFs,
    PreservedVectors,
    preserved_prolongation,
)
from ..coarsen.lattice import lattice_aggregate
from ..config import (
    AMGOptions,
    CoarseSolveType,
    ProlType,
    SmootherOptions,
    SmootherType,
)
from ..mesh.topo import map_edges
from ..smoothers.block import build_block_gs
from ..smoothers.build import build_smoother, stage_smoother
from ..smoothers.hiptmair import HiptmairSmoother
from ..solve.cycle import AMGOperator, DeviceLevel
from ..solve.pcg import pcg
from ..sparse import bell, formats
from ..transfer.galerkin import rap
from .amg import ROW_ALIGN, SolveInfo, _full_f32, _scalar_pad, _spd_inverse

# the device dtype of every Stokes hierarchy (the JAX package's float32)
_NP_DTYPE = np.float32
_DTYPE = torch.float32


def _truncate_columns(
    Y: sp.spmatrix, max_per_col: int, min_frac: float
) -> sp.csc_matrix:
    """Keep the ``max_per_col`` largest |entries| per column (and drop
    entries below ``min_frac`` of the column max). Vectorized rank-
    within-column via lexsort."""
    Y = Y.tocsc()
    if Y.nnz == 0:
        return Y
    ncol = Y.shape[1]
    col_of = np.repeat(np.arange(ncol), np.diff(Y.indptr))
    av = np.abs(Y.data)
    order = np.lexsort((-av, col_of))
    rank = np.arange(Y.nnz) - np.repeat(Y.indptr[:-1], np.diff(Y.indptr))
    keep_sorted = rank < max_per_col
    keep = np.zeros(Y.nnz, dtype=bool)
    keep[order] = keep_sorted
    if min_frac > 0:
        colmax = np.zeros(ncol)
        np.maximum.at(colmax, col_of, av)
        keep &= av >= min_frac * colmax[col_of]
    return sp.csc_matrix(
        (Y.data[keep], (Y.indices[keep], col_of[keep])), shape=Y.shape
    )


def _curl_smooth_prol(
    A: sp.spmatrix,
    C: sp.spmatrix,
    P: sp.spmatrix,
    omega: float,
    max_per_col: int = 8,
    min_frac: float = 0.02,
) -> sp.csr_matrix:
    """Divergence-compatible prolongation smoothing: P += C Y.

    One damped-Jacobi step restricted to the CURL (potential) space:
    P_s = (I - omega C D_pot^-1 C^T A) P. Corrections of the form C(.)
    are exactly divergence-free, so the flow/divergence preservation of
    the base prolongation survives untouched — the div-compatible
    counterpart of the reference's smoothed Stokes prolongations
    (stokes_factory.hpp:20-44). This removes the alpha-dependence of the
    grad-div penalty (measured 63 -> ~30 iterations at alpha=1e3): the
    penalty annihilates C-range components, so the un-smoothed P's curl
    error is exactly what stiffens with alpha.

    Y is TRUNCATED per coarse column (top ``max_per_col`` loops, sp_*
    truncation semantics) BEFORE forming C Y: truncating Y — unlike
    truncating P — cannot break divergence preservation, since any C(.)
    is div-free. Without it the smoothed support compounds level-over-
    level (measured colP 69 -> 716 -> 2212 on a 13k-DoF 3D problem,
    densifying every coarse operator).
    """
    A = A.tocsr()
    d = np.asarray((C.multiply(A @ C)).sum(axis=0)).ravel()  # diag(C^T A C)
    dinv = np.where(d > 0, 1.0 / np.maximum(d, 1e-300), 0.0)
    # rho(D^-1 A_pot) estimate via a few power iterations
    rng = np.random.default_rng(0)
    x = rng.standard_normal(C.shape[1])
    lam = 2.0
    CT = C.T.tocsr()
    for _ in range(8):
        y = dinv * (CT @ (A @ (C @ x)))
        nrm = np.linalg.norm(y)
        if nrm == 0:
            break
        lam = nrm
        x = y / nrm
    scale = omega / max(lam, 1e-12)
    Y = sp.diags(-scale * dinv) @ (CT @ (A @ P))
    Y = _truncate_columns(Y, max_per_col, min_frac)
    return (P + C @ Y).tocsr()


def _device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available")
    return dev


def _takes_dist_setup(options: AMGOptions, mesh) -> bool:
    """``dist_setup > 1`` takes the distributed Stokes setup
    (parallel/dist_stokes.py); a lattice dual mesh keeps the serial path,
    whose ``coarsen_cells`` takes the structured lattice coarsener (a
    different algorithm by design), as in the JAX package."""
    return (
        options.dist_setup > 1
        and lattice_aggregate(mesh.vertex_data["pos"]) is None
    )


def _coarse_inverse(A: sp.spmatrix, npad: int, device) -> torch.Tensor:
    """f32 dense (pseudo-)inverse of the coarsest matrix, padded."""
    inv = _spd_inverse(A.toarray())
    out = np.zeros((npad, npad), dtype=_NP_DTYPE)
    out[: inv.shape[0], : inv.shape[1]] = inv
    return torch.from_numpy(out).to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StokesSolve:
    """The solve phase shared by the three Stokes classes: f64 defect
    correction on the host, up to 8 passes of the f32 device PCG."""

    def _to_dev(self, v) -> torch.Tensor:
        return formats.block_vec(
            np.asarray(v), 1, self.A_dev.nrows_pad, _DTYPE, self.device
        )

    def _from_dev(self, v: torch.Tensor) -> np.ndarray:
        return (
            formats.flat_vec(v, self.A_dev.nrows)
            .to(torch.float64).cpu().numpy()
        )

    def solve(self, b, *, tol=1e-8, maxiter=300):
        b = np.asarray(b, np.float64)
        bnorm = np.linalg.norm(b)
        if bnorm == 0:
            return np.zeros_like(b), SolveInfo(0, 0.0)
        x = np.zeros(self.n)
        total = 0
        relres = 1.0
        with _full_f32():
            for outer in range(8):
                r = b - self.A_host @ x
                relres = np.linalg.norm(r) / bnorm
                if relres <= tol:
                    break
                res = pcg(
                    self.op, self.A_dev, self._to_dev(r),
                    tol=max(tol / relres, 2e-6), maxiter=maxiter,
                )
                x = x + self._from_dev(res.x)
                total += int(res.iterations)
        r = b - self.A_host @ x
        relres = float(np.linalg.norm(r) / bnorm)
        return x, SolveInfo(
            iterations=total,
            relres=relres,
            outer_iterations=outer + 1,
            converged=relres <= tol,
        )


class StokesAMG(_StokesSolve):
    """Facet-based AMG for grad-div-penalized (Stokes) velocity systems."""

    def __init__(
        self,
        A: sp.spmatrix,
        *,
        cell_pos: np.ndarray,
        cell_vol: np.ndarray,
        facet_cells: np.ndarray,
        facet_flow: np.ndarray,
        facet_verts: np.ndarray | None = None,
        vert_pos: np.ndarray | None = None,
        bnd_facet_verts: np.ndarray | None = None,
        curl_smooth: bool | None = None,
        options: AMGOptions | None = None,
        device: str | torch.device = "cuda",
    ):
        self.options = options or AMGOptions()
        self.device = _device_of(device)
        self.A_host = A.tocsr().astype(np.float64)
        self.n = A.shape[0]
        mesh, interior = st.build_dual_mesh(
            cell_pos, cell_vol, facet_cells, facet_flow
        )
        # primal facet->vertex incidence (optional, aligned with
        # facet_cells): enables SHORT geometric loops (CalcFacetLoops
        # analog) at the finest level, contracted level-to-level.
        # bnd_facet_verts lists the ELIMINATED boundary facets' vertices
        # so loops around boundary entities are skipped up front; without
        # it the boundary-operator check inside geometric_loops drops
        # their (open-fan) columns anyway.
        self._loops0 = None
        if facet_verts is not None and vert_pos is not None:
            fv = np.asarray(facet_verts)
            interior_mask = np.zeros(len(fv), dtype=bool)
            interior_mask[interior] = True
            bnd = fv[~interior_mask]
            if bnd_facet_verts is not None and len(bnd_facet_verts):
                bnd = (
                    np.concatenate([bnd, np.asarray(bnd_facet_verts)])
                    if len(bnd)
                    else np.asarray(bnd_facet_verts)
                )
            self._loops0 = st.geometric_loops(
                mesh, fv[interior], vert_pos, bnd
            )
        # curl-smoothing auto policy: with SHORT geometric loops the
        # potential space already absorbs the curl error (measured 3D
        # alpha=1e3: PW 19 iters at OC 2.5 vs smoothed 12 at OC 20), so
        # smoothing defaults OFF when loops0 exists; tree-loop levels
        # keep it (alpha-robustness needs it there: 51 -> 8 iters)
        self.curl_smooth = curl_smooth
        # scalar normal-flux dofs (MAC/RT0-like) vs VECTOR facet dofs
        # (NC/CR: facet_flow is the (nf, dim) area-normal, facet_bs = dim)
        self.facet_bs = (
            mesh.edge_data["flow"].shape[1]
            if mesh.edge_data["flow"].ndim == 2
            else 1
        )
        if mesh.ne * self.facet_bs != self.n:
            raise ValueError(
                f"matrix has {self.n} DOFs but the dual mesh has "
                f"{mesh.ne} interior facets x {self.facet_bs} dofs"
            )
        self.mesh0 = mesh
        self.dtype = _DTYPE
        self._is_setup = False

    def setup(self) -> "StokesAMG":
        t0 = time.perf_counter()
        opts = self.options
        lc = opts.levels
        bs = self.facet_bs
        if _takes_dist_setup(opts, self.mesh0):
            from ..parallel.dist_stokes import dist_stokes_levels

            self.setup_levels_, self.log_ = dist_stokes_levels(
                self.A_host, self.mesh0, bs, opts, opts.dist_setup,
                return_log=True,
            )
            return self._finish_setup(t0)
        levels: list[st.StokesLevel] = []
        A, mesh = self.A_host, self.mesh0
        Y = self._loops0  # incidence loops, contracted level-to-level
        lvl = 0
        while True:
            cap = st.StokesLevel(A=A, mesh=mesh)
            cap.C = (
                st.build_loops(mesh, incidence=Y)
                if bs == 1
                else st.build_loops_vec(mesh, incidence=Y)
            )
            levels.append(cap)
            if (
                lvl + 1 >= lc.max_levels
                or mesh.ne * bs <= lc.max_coarse_size
                or mesh.nv <= 8
            ):
                break
            v2agg, n_agg = st.coarsen_cells(mesh)
            if n_agg >= lc.min_coarsen_ratio * mesh.nv:
                break
            cedges, e2ce = map_edges(mesh, v2agg, n_agg)
            cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, cedges, e2ce)
            P = (
                st.flow_prolongation(mesh, cmesh, v2agg, e2ce)
                if bs == 1
                else st.flow_prolongation_vec(mesh, cmesh, v2agg, e2ce)
            )
            want_smooth = (
                ProlType(opts.prol.type.get(lvl)) == ProlType.SMOOTHED
                and cap.C is not None
            )
            if self.curl_smooth is not None:
                want_smooth = want_smooth and self.curl_smooth
            else:
                want_smooth = want_smooth and Y is None  # auto: see __init__
            if want_smooth:
                P = _curl_smooth_prol(
                    A, cap.C, P, float(opts.prol.omega.get(lvl)),
                    max_per_col=2 * int(opts.prol.max_per_row.get(lvl)),
                    min_frac=float(opts.prol.min_frac.get(lvl)),
                )
            cap.P = P
            cap.v2agg = v2agg
            A = rap(A, P, dtype=np.float32)
            if Y is not None:
                Y = st.contract_loops(Y, mesh, v2agg, cedges, e2ce)
            mesh = cmesh
            lvl += 1
        self.setup_levels_ = levels
        return self._finish_setup(t0)

    def _finish_setup(self, t0: float) -> "StokesAMG":
        t1 = time.perf_counter()
        self._compile_device()
        _sync(self.device)
        t2 = time.perf_counter()
        self.setup_time_host = t1 - t0
        self.setup_time_device = t2 - t1
        self.setup_time = t2 - t0
        self._is_setup = True
        return self

    # ------------------------------------------------------------------
    def _stage_transfer(self, M: sp.spmatrix, nr_pad: int, nc_pad: int,
                        device):
        """Scalar rectangular operator (P/R/C/CT) in tile-ELL with pinned
        interface pads."""
        return formats.tile_ell_from_scipy(
            M.tocsr(), _NP_DTYPE, nr_pad=nr_pad, nc_pad=nc_pad, device=device,
        )

    def _compile_device(self):
        """Stage the hierarchy in the shared per-level format chooser
        (DIA / tile-ELL / dense, as on the H1 path), levels in their
        natural row order."""
        opts = self.options
        nlev = len(self.setup_levels_)
        A_fmts = [
            formats.choose_format(
                cap.A.tocsr(), 1, _NP_DTYPE, ROW_ALIGN, device=self.device
            )
            for cap in self.setup_levels_
        ]
        pads = [_scalar_pad(f, 1) for f in A_fmts]
        dev_levels = []
        for i, cap in enumerate(self.setup_levels_):
            is_coarsest = i == nlev - 1
            sm = None
            if not is_coarsest or opts.coarse_solve != CoarseSolveType.INV:
                sm = stage_smoother(
                    self._build_hiptmair(cap, pads[i], i), self.device,
                    A=A_fmts[i],
                )
            P_fmt = R_fmt = None
            if cap.P is not None:
                P_fmt = self._stage_transfer(
                    cap.P, pads[i], pads[i + 1], self.device
                )
                R_fmt = self._stage_transfer(
                    cap.P.T.tocsr(), pads[i + 1], pads[i], self.device
                )
            dev_levels.append(
                DeviceLevel(A=A_fmts[i], smoother=sm, P=P_fmt, R=R_fmt)
            )
        coarse_inv = None
        if opts.coarse_solve == CoarseSolveType.INV:
            coarse_inv = _coarse_inverse(
                self.setup_levels_[-1].A, pads[-1], self.device
            )
        self.op = AMGOperator(
            levels=tuple(dev_levels),
            coarse_inv=coarse_inv,
            cycle=opts.cycle.value,
        )
        self.A_dev = self.op.levels[0].A

    def _build_hiptmair(self, cap: st.StokesLevel, nrows_pad: int, level):
        """Range smoother + potential smoother through the curl matrix.

        (`BuildSmoothers`, stokes_pc.cpp:1300-1390.) Falls back to the
        plain range smoother when the level has no loops. Built on the
        host, like every smoother; ``stage_smoother`` moves it.
        """
        sm_opts = self.options.smoother
        kind = SmootherType(sm_opts.type.get(level))
        if kind in (SmootherType.GS, SmootherType.HIPTMAIR):
            # range/potential parts default to Chebyshev: measured ~2x
            # fewer iterations than l1-Jacobi across the alpha sweep
            kind = SmootherType.CHEBYSHEV
        range_opts = SmootherOptions(
            type=kind,
            steps=sm_opts.steps,
            omega=sm_opts.omega,
            cheby_order=sm_opts.cheby_order,
            cheby_lower=sm_opts.cheby_lower,
        )
        range_sm = build_smoother(
            cap.A, 1, range_opts, level, nrows_pad, _NP_DTYPE
        )
        if cap.C is None:
            return range_sm
        C = cap.C
        A_pot = (C.T @ cap.A @ C).tocsr()
        A_pot = (A_pot + A_pot.T) * 0.5
        A_pot_fmt = formats.choose_format(A_pot, 1, _NP_DTYPE, ROW_ALIGN)
        pot_pad = _scalar_pad(A_pot_fmt, 1)
        Cp = self._stage_transfer(C, nrows_pad, pot_pad, "cpu")
        CTp = self._stage_transfer(C.T.tocsr(), pot_pad, nrows_pad, "cpu")
        pot_sm = build_smoother(
            A_pot, 1, range_opts, level, pot_pad, _NP_DTYPE
        )
        return HiptmairSmoother(
            range_sm=range_sm,
            pot_sm=pot_sm,
            A_pot=A_pot_fmt,
            C=Cp,
            CT=CTp,
        )

    @property
    def num_levels(self):
        return len(self.setup_levels_)


def _block_ell(A: sp.spmatrix, device):
    """A scalar operator as block-ELL with 1x1 blocks (HDG and HDiv levels
    and transfers)."""
    return bell.from_scipy(
        A.tocsr(), 1, 1, dtype=_NP_DTYPE, row_align=ROW_ALIGN, device=device
    )


class StokesHDGEmbeddedAMG(_StokesSolve):
    """Embedded HDG Stokes AMG: higher-order facet FE system + aux sequence.

    The reference's HDiv-HDG pattern (src/stokes/hdiv/
    hdiv_hdg_embedding.hpp:20-70 `CreateDOFEmbedding` + the secondary
    low-order sequence of stokes_factory.hpp:46-68): the assembled
    higher-order facet system S keeps only a finest-level smoother; the
    AMG hierarchy is built in the facet-constant AUX space reached through
    the embedding E (aux operator = E^T S E, Galerkin), i.e. the vector NC
    facet levels of :class:`StokesAMG`. The assembled cycle is the
    reference's `EmbeddedAMGMatrix` shape (amg_matrix.hpp:90): E is the
    level-0 transfer, with a dyn-block (per-facet) smoother on S.
    """

    def __init__(
        self,
        A: sp.spmatrix,
        E: sp.spmatrix,
        *,
        cell_pos,
        cell_vol,
        facet_cells,
        facet_flow,
        options: AMGOptions | None = None,
        device: str | torch.device = "cuda",
    ):
        self.options = options or AMGOptions()
        self.device = _device_of(device)
        self.A_host = A.tocsr().astype(np.float64)
        self.E = E.tocsr().astype(np.float64)
        self.n = A.shape[0]
        if self.E.shape[0] != self.n:
            raise ValueError("embedding rows must match the system size")
        A_aux = (self.E.T @ self.A_host @ self.E).tocsr()
        A_aux = (A_aux + A_aux.T) * 0.5
        self.aux = StokesAMG(
            A_aux,
            cell_pos=cell_pos,
            cell_vol=cell_vol,
            facet_cells=facet_cells,
            facet_flow=facet_flow,
            options=self.options,
            device=self.device,
        )
        self.dtype = _DTYPE
        self._is_setup = False

    def setup(self) -> "StokesHDGEmbeddedAMG":
        t0 = time.perf_counter()
        self.aux.setup()
        A_ell = _block_ell(self.A_host, self.device)
        # dyn-block smoother over the per-facet dof blocks of S
        if self.n % self.aux.mesh0.ne != 0:
            raise ValueError(
                "StokesHDGEmbeddedAMG: condensed facet space size "
                f"{self.n} is not a multiple of the facet count "
                f"{self.aux.mesh0.ne}; non-uniform per-facet dof counts "
                "need explicit per-facet blocks (use the HDiv variant's "
                "MeshDOFs path)"
            )
        nfd = self.n // self.aux.mesh0.ne
        blocks = [
            np.arange(e * nfd, (e + 1) * nfd)
            for e in range(self.aux.mesh0.ne)
        ]
        sm = stage_smoother(
            build_block_gs(self.A_host, blocks, A_ell.nrows_pad, _NP_DTYPE),
            self.device,
        )
        full = DeviceLevel(
            A=A_ell,
            smoother=sm,
            P=_block_ell(self.E, self.device),
            R=_block_ell(self.E.T, self.device),
        )
        self.op = AMGOperator(
            levels=(full,) + tuple(self.aux.op.levels),
            coarse_inv=self.aux.op.coarse_inv,
            cycle=self.options.cycle.value,
        )
        self.A_dev = self.op.levels[0].A
        _sync(self.device)
        self.setup_time = time.perf_counter() - t0
        self._is_setup = True
        return self

    @property
    def num_levels(self):
        return 1 + self.aux.num_levels


class StokesHDivAMG(_StokesSolve):
    """HDiv-variant Stokes AMG: variable facet DOFs + preserved vectors.

    The reference's `HDivStokesAMGPC` (src/stokes/hdiv/) re-created over
    the strict-algebraic facet inputs: per-facet DOF counts (`MeshDOFs`)
    and a set of preserved vectors (constants / RT0) that stay exactly
    representable on every coarse level (preserved_vectors.hpp). The
    smoother is dyn-block GS over the variable per-facet DOF blocks (the
    reference pairs HDiv with its dyn-block smoothers).
    """

    def __init__(
        self,
        A: sp.spmatrix,
        *,
        cell_pos,
        cell_vol,
        facet_cells,
        facet_flow,
        facet_dof_counts,
        preserved,
        options: AMGOptions | None = None,
        device: str | torch.device = "cuda",
    ):
        self.options = options or AMGOptions()
        self.device = _device_of(device)
        self.A_host = A.tocsr().astype(np.float64)
        self.n = A.shape[0]
        mesh, interior = st.build_dual_mesh(
            cell_pos, cell_vol, facet_cells, facet_flow
        )
        self.mesh0 = mesh
        counts_all = np.asarray(facet_dof_counts, dtype=np.int64)
        pres_all = np.asarray(preserved, dtype=np.float64)
        if len(interior) != len(counts_all):
            # boundary facets present in the input: dofs/preserved are
            # indexed over ALL facets but the dual mesh keeps interior
            # facets only — re-index both (a silent misalignment would
            # corrupt every subsequent facet's DOF block)
            all_dofs = MeshDOFs.from_counts(counts_all)
            sel = np.concatenate(
                [all_dofs.dofs(int(e)) for e in interior]
            ) if len(interior) else np.zeros(0, dtype=np.int64)
            counts_all = counts_all[interior]
            pres_all = pres_all[sel]
        self.dofs0 = MeshDOFs.from_counts(counts_all)
        if self.dofs0.ndof != self.n:
            raise ValueError(
                f"matrix has {self.n} dofs, interior facet counts sum "
                f"to {self.dofs0.ndof}"
            )
        self.pres0 = PreservedVectors(n_special=1, vectors=pres_all)
        self.dtype = _DTYPE
        self._is_setup = False

    def setup(self) -> "StokesHDivAMG":
        t0 = time.perf_counter()
        lc = self.options.levels
        if _takes_dist_setup(self.options, self.mesh0):
            from ..parallel.dist_stokes import dist_stokes_hdiv_levels

            self.setup_levels_ = dist_stokes_hdiv_levels(
                self.A_host, self.mesh0, self.dofs0, self.pres0,
                self.options, self.options.dist_setup,
            )
            return self._finish_setup(t0)
        levels = []
        A, mesh, dofs, pres = self.A_host, self.mesh0, self.dofs0, self.pres0
        lvl = 0
        while True:
            cap = st.StokesLevel(A=A, mesh=mesh)
            cap.dofs = dofs
            cap.pres = pres
            levels.append(cap)
            if (
                lvl + 1 >= lc.max_levels
                or dofs.ndof <= lc.max_coarse_size
                or mesh.nv <= 8
            ):
                break
            v2agg, n_agg = st.coarsen_cells(mesh)
            if n_agg >= lc.min_coarsen_ratio * mesh.nv:
                break
            cedges, e2ce = map_edges(mesh, v2agg, n_agg)
            cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, cedges, e2ce)
            P_flux = st.flow_prolongation(mesh, cmesh, v2agg, e2ce)
            P, dofs_c, pres_c = preserved_prolongation(
                mesh, cmesh, v2agg, e2ce, dofs, pres, P_flux
            )
            cap.P = P
            cap.v2agg = v2agg
            A = rap(A, P, dtype=np.float64)
            mesh, dofs, pres = cmesh, dofs_c, pres_c
            lvl += 1
        self.setup_levels_ = levels
        return self._finish_setup(t0)

    def _finish_setup(self, t0: float) -> "StokesHDivAMG":
        self._compile_device()
        _sync(self.device)
        self.setup_time = time.perf_counter() - t0
        self._is_setup = True
        return self

    def _compile_device(self):
        opts = self.options
        nlev = len(self.setup_levels_)
        dev_levels = []
        for i, cap in enumerate(self.setup_levels_):
            A_ell = _block_ell(cap.A, self.device)
            sm = None
            if i < nlev - 1 or opts.coarse_solve != CoarseSolveType.INV:
                # dyn-block GS over the variable per-facet dof blocks
                off = cap.dofs.offsets
                blocks = [
                    np.arange(off[e], off[e + 1])
                    for e in range(cap.dofs.ne)
                    if off[e + 1] > off[e]
                ]
                sm = stage_smoother(
                    build_block_gs(cap.A, blocks, A_ell.nrows_pad, _NP_DTYPE),
                    self.device,
                )
            P_ell = R_ell = None
            if cap.P is not None:
                P_ell = _block_ell(cap.P, self.device)
                R_ell = _block_ell(cap.P.T, self.device)
            dev_levels.append(
                DeviceLevel(A=A_ell, smoother=sm, P=P_ell, R=R_ell)
            )
        coarse_inv = None
        if opts.coarse_solve == CoarseSolveType.INV:
            coarse_inv = _coarse_inverse(
                self.setup_levels_[-1].A, dev_levels[-1].A.nrows_pad,
                self.device,
            )
        self.op = AMGOperator(
            levels=tuple(dev_levels),
            coarse_inv=coarse_inv,
            cycle=opts.cycle.value,
        )
        self.A_dev = self.op.levels[0].A

    @property
    def num_levels(self):
        return len(self.setup_levels_)
