"""AMG preconditioner front-end (strict algebraic mode) on PyTorch.

Port of ngsamg_tpu/precond/amg.py for H1 (scalar and vector) and
elasticity problems:

  AMGPreconditioner(A, energy=..., block_size=..., coords=..., device=...)
      -> .setup()
      host level loop -> row orders + scaling -> formats, smoothers,
      transfers, coarse inverse, cluster correction -> device staging
      -> .solve(b) / .apply(r) / .test() / .test_levels() / .test_smoothers()

The front-end inputs are the JAX package's: ``freedofs`` (a DOF subset, or
partial Dirichlet constraints projected on the kept vertices, with ``b``,
``x`` and ``apply`` in the external free-DOF space), the compound
(component-major) DOF layout, element matrices (``elmat_data``, the ELMAT
energy mesh) and nodal-P2 midnode embeddings (``nodalp2``).

Setup runs on the host in numpy/scipy and the port's native C++ extension
(``ngsamg_tpu_torch.native``, built on first use; ``native.HAVE_NATIVE =
False`` selects the numpy branches) (factory/levels.py): the stencil
domain for full lattices, the generic (unstructured) level loop otherwise.
It stages the hierarchy as torch tensors on ``device``. The solve is
float64 defect correction around the f32 device PCG. On uniform-stencil
finest levels the f64 residual is computed on the device by the f64 twin
of the stencil, so only scalars cross to the host until the final
solution; otherwise the residual is computed on the host with scipy.
``solve(b, mixed=True)`` runs the mixed-precision PCG instead (f64 Krylov
state and f64 finest matvec on the device, the f32 cycle as M), which is
also what a stagnated defect correction falls back to.
There is no fallback: a CUDA device runs the hand-written kernels or
raises.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from .. import native
from ..apps.elasticity import ElasticityEnergy
from ..apps.h1 import H1Energy
from ..config import (
    AMGOptions,
    CoarseSolveType,
    SpecOpt,
    options_from_flags,
)
from ..factory.levels import SetupLevel, setup_levels
from ..mesh.topo import AlgebraicMesh
from ..smoothers.build import build_smoother, plan_row_order, stage_smoother
from ..smoothers.cluster_corr import detect_clusters
from ..smoothers.core import smooth, smooth_back
from ..solve.cycle import AMGOperator, DeviceLevel, _cycle, amg_apply
from ..solve.pcg import pcg, pcg_mixed
from ..sparse import bell, formats
from ..sparse.host import bsr_permute, to_bsr
from ..transfer.lattice_transfer import LatticeProlongation, LatticeRestriction

ROW_ALIGN = 8

# device dtypes; bfloat16 levels are staged through f32 numpy (numpy has no
# bfloat16) and cast once on the device (``_cast_floats``)
_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}
# inner accuracy floor of the device dtype: the inner PCG asks for no less,
# and f64 defect correction bridges the gap to the requested tolerance
_FLOORS = {torch.float64: 0.0, torch.float32: 2e-6, torch.bfloat16: 3e-2}


def _cast_floats(obj, dtype: torch.dtype, memo: dict):
    """A staged operator tree with every float32 tensor cast to ``dtype``
    on its device. Objects shared in the tree (a level's operator and its
    lattice transfers) stay shared; the formats make their launch plans
    anew for the new element size. f64 tensors (an f64 coarse inverse)
    and index tensors are kept."""
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, torch.Tensor):
        out = obj.to(dtype) if obj.dtype == torch.float32 else obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = dataclasses.replace(obj, **{
            f.name: _cast_floats(getattr(obj, f.name), dtype, memo)
            for f in dataclasses.fields(obj) if f.init
        })
    elif isinstance(obj, tuple):
        out = tuple(_cast_floats(v, dtype, memo) for v in obj)
    else:
        out = obj
    memo[key] = out
    return out


def _scalar_pad(fmt, bs: int) -> int:
    """Padded scalar length of a level's vectors: block formats pad block
    rows, the scalar formats (bs == 1) scalar rows."""
    if isinstance(fmt, (bell.BlockELL, formats.DenseMatrix)):
        return fmt.nrows_pad * bs
    return fmt.nrows_pad


def _block_rows(B: sp.bsr_matrix) -> np.ndarray:
    """Block-row index of every stored block of a BSR."""
    return np.repeat(
        np.arange(B.shape[0] // B.blocksize[0]), np.diff(B.indptr)
    )


def _sym_scale(A: sp.spmatrix):
    """Scale a matrix (CSR or BSR, already permuted) to unit diagonal:
    returns (S A S, s) with S = diag(s), s = 1/sqrt(diag(A)). A BSR stays
    BSR, scaled on its blocks by the native ``bsr_sym_scale`` (numpy with
    ``native.HAVE_NATIVE`` off); a CSR is scaled in numpy (the original's
    native ``csr_sym_scale`` is item 10c)."""
    d = A.diagonal()
    s = np.where(d > 0, 1.0 / np.sqrt(np.where(d > 0, d, 1.0)), 1.0)
    if A.format == "bsr":
        data = native.bsr_sym_scale(A, s)
        if data is None:
            R, C = A.blocksize
            sr = s[_block_rows(A)[:, None] * R + np.arange(R)]
            scl = s[A.indices[:, None] * C + np.arange(C)]
            data = A.data * sr[:, :, None] * scl[:, None, :]
        out = sp.bsr_matrix((data, A.indices, A.indptr), shape=A.shape)
        out.has_sorted_indices = A.has_sorted_indices
        return out, s
    A = A.tocsr()
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    dat = A.data * (s[rows] * s[A.indices])
    return sp.csr_matrix((dat, A.indices, A.indptr), shape=A.shape), s


def _stage_prolongation(P, perm_f, perm_c, s_f, s_c) -> sp.csr_matrix:
    """A level's host prolongation in the device row orders of both levels
    and, on scaled hierarchies, as P' = S_f^-1 P S_c."""
    P = P.tocsr()
    if perm_f is not None:
        P = P[perm_f]
    if perm_c is not None:
        P = P[:, perm_c]
    if s_f is None and s_c is None:
        return P
    dat = P.data.copy()
    if s_c is not None:
        dat *= s_c[P.indices]
    if s_f is not None:
        dat /= s_f[np.repeat(np.arange(P.shape[0]), np.diff(P.indptr))]
    return sp.csr_matrix((dat, P.indices, P.indptr), shape=P.shape)


def _stage_block_prolongation(
    Pb: sp.bsr_matrix, perm_f, perm_c, s_f, s_c
) -> sp.bsr_matrix:
    """:func:`_stage_prolongation` in the block domain: the BLOCK
    permutations and P' = S_f^-1 P S_c applied on the BSR blocks
    (*= s_c[col], then /= s_f[row], the scalar path's operation order)."""
    R, C = Pb.blocksize
    if perm_f is not None or perm_c is not None:
        rp = np.arange(Pb.shape[0] // R) if perm_f is None else perm_f
        cp = np.arange(Pb.shape[1] // C) if perm_c is None else perm_c
        Pb = bsr_permute(Pb, rp, col_perm=cp)
    if s_f is None and s_c is None:
        return Pb
    dat = Pb.data.copy()
    if s_c is not None:
        dat *= s_c[Pb.indices[:, None] * C + np.arange(C)][:, None, :]
    if s_f is not None:
        dat /= s_f[_block_rows(Pb)[:, None] * R + np.arange(R)][:, :, None]
    return sp.bsr_matrix((dat, Pb.indices, Pb.indptr), shape=Pb.shape)


def _refine_residual(A64, b64, x64):
    r = b64 - formats.matvec(A64, x64)
    return r, torch.dot(r[:, 0], r[:, 0])


def _refine_scale(r64, inv_rn: float, dt: torch.dtype):
    return (r64 * inv_rn).to(dt)


def _refine_accumulate(x64, dx32, rn: float):
    return x64 + dx32.to(torch.float64) * rn


@contextlib.contextmanager
def _full_f32():
    """Full-f32 matrix products for one solve or apply, whatever the
    caller's TF32 setting: the tile-ELL, block, cluster and dense products
    of the cycle go through cuBLAS, and the cycle must stay a true f32
    operator for parity with the JAX package (the ill-conditioned block
    energies lose their convergence otherwise)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _spd_inverse(Ad: np.ndarray) -> np.ndarray:
    """Dense inverse of an SPD matrix: Cholesky, verified on a random
    vector, pseudo-inverse fallback for singular or inaccurate cases."""
    try:
        import scipy.linalg as sla

        cf = sla.cho_factor(Ad, lower=True, check_finite=False)
        inv = sla.cho_solve(
            cf, np.eye(Ad.shape[0]), check_finite=False
        )
        v = np.random.default_rng(0).standard_normal(Ad.shape[0])
        err = np.linalg.norm(Ad @ (inv @ v) - v) / np.linalg.norm(v)
        if not np.isfinite(err) or err > 1e-8:
            raise np.linalg.LinAlgError(f"cho inverse off by {err:.1e}")
        return inv
    except Exception:
        return np.linalg.pinv(Ad, rcond=1e-10, hermitian=True)


@dataclass
class SolveInfo:
    iterations: int
    relres: float
    outer_iterations: int = 1
    converged: bool = True
    history: list = field(default_factory=list)


class AMGPreconditioner:
    """Algebraic multigrid preconditioner, device-resident solve phase.

    ``energy``: "h1" (scalar, or vector-valued with ``block_size > 1``),
    "elasticity" (``block_size = dim``, needs ``coords``), or an
    :class:`~ngsamg_tpu_torch.apps.base.Energy` instance.
    ``device``: where the hierarchy is staged and the solve runs, "cuda"
    (the default: the hand-written kernels) or "cpu" (their plain
    versions, which callers ask for explicitly); an elasticity energy's
    batched pencil solver runs there too. The smoothers (multicolor GS,
    the default; Jacobi, l1-Jacobi, Chebyshev, dyn-block GS), the V, W and
    BS cycles and the device dtypes (float32, float64, bfloat16) are those
    of the JAX package. ``dist_setup > 1`` builds an H1 or elasticity
    hierarchy with the host-distributed setup (parallel/dist_setup.py) and
    stages it as any other. ``shards = s > 1`` stages the hierarchy
    that the sharded solve places (parallel/shard.py ``shard_operator``),
    on this one device, as the JAX package does: every level padded to a
    multiple of ``8 s`` rows, plain (not bucketed) tile-ELL, and the
    multicolor GS in its sliced storage. The Hiptmair smoother raises the
    JAX package's ``ValueError`` (only the Stokes preconditioners,
    precond/stokes.py, build it). The local cluster
    correction (``options.cluster_corr``) is staged on unstructured scalar
    finest levels, as in the JAX package.
    """

    def __init__(
        self,
        A: sp.spmatrix,
        *,
        energy="h1",
        block_size: int = 1,
        coords: np.ndarray | None = None,
        freedofs: np.ndarray | None = None,
        options: AMGOptions | None = None,
        elmat_data: tuple | None = None,
        nodalp2: np.ndarray | None = None,
        dof_layout: str = "interleaved",
        device: str | torch.device = "cuda",
        **flags,
    ):
        if options is None:
            options = options_from_flags(flags) if flags else AMGOptions()
        self.options = options
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: CUDA is not available")
        self.freedofs = None if freedofs is None else np.asarray(freedofs, bool)
        self._ext_free = None  # external -> internal dof map (perm/subset)
        if dof_layout == "compound":
            # component-major user layout [x0..xn, y0..yn, ...] permuted to
            # the interleaved internal layout (the reference's compound
            # FESpace tests)
            if self.freedofs is not None:
                raise ValueError("compound layout: pre-eliminate freedofs")
            A = A.tocsr()
            nv = A.shape[0] // block_size
            p = (
                np.arange(block_size)[None, :] * nv
                + np.arange(nv)[:, None]
            ).ravel()  # internal = external[p]
            A = A[p][:, p].tocsr()
            self._ext_free = np.argsort(p)
        elif dof_layout != "interleaved":
            raise ValueError(f"unknown dof_layout {dof_layout!r}")
        if not (isinstance(A, sp.dia_matrix) and self.freedofs is None):
            # DIA input feeds the structured fast path without a CSR detour
            A = A.tocsr()
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"matrix must be square, got {A.shape}")
        if A.shape[0] % block_size:
            raise ValueError(
                f"matrix size {A.shape[0]} not divisible by "
                f"block_size {block_size}"
            )
        if self.freedofs is not None:
            fd = self.freedofs
            vany = fd.reshape(-1, block_size).any(axis=1)
            vall = fd.reshape(-1, block_size).all(axis=1)
            if block_size > 1 and (vany & ~vall).any():
                # partial Dirichlet (some components of a vertex fixed):
                # keep ALL dofs of touched vertices and project the
                # constrained components, rows and columns zeroed and the
                # diagonal kept (the reference's scalFreeRows projection).
                # Externally the preconditioner exposes only the free dofs.
                kept = np.flatnonzero(np.repeat(vany, block_size))
                A = A[kept][:, kept].tocsr()
                sub_free = fd[kept]
                coo = A.tocoo()
                keep_e = (sub_free[coo.row] & sub_free[coo.col]) | (
                    coo.row == coo.col
                )
                A = sp.coo_matrix(
                    (coo.data[keep_e], (coo.row[keep_e], coo.col[keep_e])),
                    shape=A.shape,
                ).tocsr()
                self._ext_free = np.flatnonzero(sub_free)
            else:
                # subset selection (DOF subsets): b and x have the free size
                idx = np.flatnonzero(self.freedofs)
                A = A[idx][:, idx].tocsr()
            if coords is not None:
                coords = np.asarray(coords)[vany]
        # nodal-P2 two-parent embedding: AMG coarsens the vertex subset;
        # midnodes embed as the average of their two parents. ``nodalp2``:
        # (m, 3) int (midnode, parent1, parent2) in BLOCK-node numbering;
        # ``coords`` then holds the VERTEX (parent) coordinates only
        self._nodalp2 = None
        if nodalp2 is not None:
            if self.freedofs is not None:
                raise ValueError("nodalp2 with freedofs: eliminate first")
            self._nodalp2 = np.asarray(nodalp2, dtype=np.int64)
        self.A_host = A if A.dtype == np.float64 else A.astype(np.float64)
        self.n = A.shape[0]
        self.coords = None if coords is None else np.asarray(coords, float)
        if isinstance(energy, str):
            if energy == "h1":
                energy = H1Energy(bs=block_size)
            elif energy in ("elasticity", "elast"):
                if self.coords is None:
                    raise ValueError("elasticity energy requires coords")
                energy = ElasticityEnergy(
                    dim=self.coords.shape[1], device=self.device
                )
            else:
                raise ValueError(f"unknown energy '{energy}'")
        elif getattr(energy, "device", False) is None:
            energy.device = self.device  # an energy made without one
        self.energy = energy
        # energy-specific coarsening default: block energies need
        # goal-driven aggregate sizes (fixed 2-round pairs give an operator
        # complexity near 5 at 1M DoF with 3x3-block smoothed prolongations)
        default_aaf = getattr(self.energy, "default_aaf", None)
        if (
            default_aaf is not None
            and self.options.coarsen.aaf.default is None
            and not self.options.coarsen.aaf.spec
        ):
            co = copy.copy(self.options.coarsen)
            co.aaf = SpecOpt(float(default_aaf))
            self.options = self.options.replace(coarsen=co)
        if self.options.dtype not in _DTYPES:
            raise ValueError(f"device dtype {self.options.dtype!r}")
        self.dtype = _DTYPES[self.options.dtype]
        # the numpy dtype the levels are packed in (bf16 through f32)
        self.np_dtype = (
            np.dtype(np.float32) if self.dtype == torch.bfloat16
            else np.dtype(self.options.dtype)
        )
        # ELMAT energy mode: the finest mesh from element matrices
        # (the reference's AddElementMatrix)
        self._finest_mesh = None
        if elmat_data is not None:
            from ..apps.elmat import ElmatAccumulator

            dnums, elmats = elmat_data
            acc = ElmatAccumulator(self.n // self.energy.dpv)
            acc.add_batch(np.asarray(dnums), np.asarray(elmats))
            self._finest_mesh = acc.finalize(self.coords)
        self._is_setup = False

    # ------------------------------------------------------------------
    # setup (BuildAMGMat)
    # ------------------------------------------------------------------
    def setup(self) -> "AMGPreconditioner":
        t0 = time.perf_counter()
        if self._nodalp2 is not None:
            self._setup_nodalp2_levels()
        elif (
            self.options.dist_setup > 1
            and isinstance(self.energy, (H1Energy, ElasticityEnergy))
            and self._finest_mesh is None
        ):
            from ..parallel.dist_setup import dist_setup_levels

            self.setup_levels_, self.log_ = dist_setup_levels(
                self.A_host, self.energy, self.options,
                self.options.dist_setup, coords=self.coords,
            )
        else:
            self.setup_levels_, self.log_ = setup_levels(
                self.A_host, self.energy, self.options, self.coords,
                finest_mesh=self._finest_mesh,
            )
        t1 = time.perf_counter()
        self._compile_device()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.setup_time_host = t1 - t0
        self.setup_time_device = t2 - t1
        self._is_setup = True
        if self.options.log_level >= 1:
            print(self.log_.summary())
            print(
                f"setup: host {self.setup_time_host:.3f}s, "
                f"device staging {self.setup_time_device:.3f}s"
            )
        if self.options.do_test:
            lmin, lmax = self.test()
            print(f"eigenvalue bounds of M^-1 A: [{lmin:.4g}, {lmax:.4g}]")
        return self

    def _setup_nodalp2_levels(self):
        """Nodal-P2 hierarchy: midnodes embed into their parent vertices.

        The full matrix stays the finest (smoothed) level; the AMG runs on
        the vertex-subspace operator E^T A E with the two-parent embedding
        E as the level-0 transfer (the reference's nodalp2 subset and
        smooth_lo_only pattern). Level 0 has a mesh without edges and
        ``P = E`` as BSR."""
        bs = self._bs_guess()
        A_full = self.A_host.tocsr()
        E = self._nodalp2_embedding(bs)
        A1 = (E.T @ A_full @ E).tocsr()
        A1 = ((A1 + A1.T) * 0.5).tocsr()
        levels1, log1 = setup_levels(
            A1, self.energy, self.options, self.coords
        )
        for lev in levels1:
            lev.index += 1
        n_nodes = self.n // bs
        lev0 = SetupLevel(
            index=0,
            A=A_full,
            row_bs=bs,
            mesh=AlgebraicMesh(
                nv=n_nodes, edges=np.zeros((0, 2), dtype=np.int64)
            ),
            P=E.tobsr(blocksize=(bs, bs)),
        )
        self.setup_levels_ = [lev0] + levels1
        log1.nvs.insert(0, n_nodes)
        log1.nnzs.insert(0, int(A_full.nnz))
        self.log_ = log1

    def _bs_guess(self) -> int:
        dpv = getattr(self.energy, "bs", None)
        if dpv is not None:
            return int(dpv)  # H1 scalar/vector
        return int(getattr(self.energy, "dim", 1))  # elasticity: disp dofs

    def _nodalp2_embedding(self, bs: int) -> sp.csr_matrix:
        """E: vertex-space dofs -> full dofs; midnode = mean of parents."""
        n_nodes = self.n // bs
        trip = self._nodalp2
        is_mid = np.zeros(n_nodes, dtype=bool)
        is_mid[trip[:, 0]] = True
        vnum = np.full(n_nodes, -1, dtype=np.int64)
        verts = np.flatnonzero(~is_mid)
        vnum[verts] = np.arange(len(verts))
        if (vnum[trip[:, 1]] < 0).any() or (vnum[trip[:, 2]] < 0).any():
            raise ValueError("nodalp2 parents must be vertex nodes")
        k = np.arange(bs)
        rows = [
            (verts[:, None] * bs + k).ravel(),
            (trip[:, :1] * bs + k).ravel(),
            (trip[:, :1] * bs + k).ravel(),
        ]
        cols = [
            (vnum[verts][:, None] * bs + k).ravel(),
            (vnum[trip[:, 1]][:, None] * bs + k).ravel(),
            (vnum[trip[:, 2]][:, None] * bs + k).ravel(),
        ]
        vals = [
            np.ones(len(verts) * bs),
            np.full(len(trip) * bs, 0.5),
            np.full(len(trip) * bs, 0.5),
        ]
        return sp.coo_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(self.n, len(verts) * bs),
        ).tocsr()

    @property
    def _row_align(self) -> int:
        return ROW_ALIGN * max(int(self.options.shards), 1)

    def _compile_device(self):
        """Stage the hierarchy: row orders, symmetric scaling, formats,
        smoothers, transfers, coarse inverse, cluster correction and the
        f64 finest stencil. Host seconds per stage, under the JAX
        package's stage names, go to ``_device_stage_times``."""
        opts = self.options
        levels = self.setup_levels_
        nlev = len(levels)
        dev, npdt = self.device, self.np_dtype
        align = self._row_align
        # bucketed tile-ELL and the per-color split GS storage only on
        # single-device placements: the row sharding (parallel/shard.py,
        # parallel/halo.py) cuts uniform per-level arrays
        stack = int(opts.shards) <= 1
        stages = self._device_stage_times = {}
        t_last = time.perf_counter()

        def _mark(name):
            nonlocal t_last
            t = time.perf_counter()
            stages[name] = stages.get(name, 0.0) + (t - t_last)
            t_last = t

        def _need_smoother(i):
            return i < nlev - 1 or opts.coarse_solve != CoarseSolveType.INV

        # 1) per-level row order: stencil levels stay in natural (lattice)
        # order; GS levels are sorted by color so each color is a
        # contiguous row slice (``bounds``: the color offsets; () marks a
        # dyn-block GS level, which keeps its order but must stay
        # block-ELL); every other level gets RCM plus a tile sort, so the
        # bucketed tile-ELL packs contiguous runs
        perms, bounds = [], []
        for i, lev in enumerate(levels):
            perm = cb = None
            if lev.stencil is None:
                if _need_smoother(i):
                    perm, cb = plan_row_order(
                        lev.A, lev.row_bs, opts.smoother, i
                    )
                if perm is None:
                    perm = formats.plan_reorder(
                        lev.A, lev.row_bs, tile_sort=stack
                    )
            perms.append(perm)
            bounds.append(cb)
        # scalar view of the finest level's block-row order
        bs0 = levels[0].row_bs
        self._perm0 = (
            None
            if perms[0] is None
            else (perms[0][:, None] * bs0 + np.arange(bs0)).ravel()
        )
        self._iperm0 = (
            None if self._perm0 is None else np.argsort(self._perm0)
        )
        _mark("row_order")

        # 2) per-level symmetric diagonal scaling for sub-f64 device dtypes
        # on fully explicit hierarchies: stage A'_l = S_l A_l S_l (unit
        # diagonal) and P'_l = S_l^-1 P_l S_{l+1}, so every Galerkin
        # identity holds on the scaled hierarchy and the solve boundary
        # maps x = S_0 y, r' = S_0 r. The hierarchy itself is still built
        # in f64 on the unscaled operator.
        use_scaling = self.dtype != torch.float64 and all(
            lev.stencil is None and lev.lattice_transfer is None
            for lev in levels
        )
        svecs: list = [None] * nlev

        A_fmts, A_perm, sms = [], [], []
        for i, lev in enumerate(levels):
            A = lev.A
            if (
                A is not None
                and lev.row_bs > 1
                and getattr(A, "_amg_bsr_cache", None) is not None
            ):
                # block levels with a cached BSR view (the finest level's,
                # made by the energy's mesh extraction) stay in the BLOCK
                # domain through permute + scaling + packing: one data
                # gather instead of a csr permute and a csr -> bsr pass
                A = to_bsr(A, lev.row_bs)
                if perms[i] is not None:
                    A = bsr_permute(A, perms[i])
            elif perms[i] is not None:
                p = (
                    perms[i][:, None] * lev.row_bs + np.arange(lev.row_bs)
                ).ravel()
                A = A[p][:, p].tocsr()
            if use_scaling:
                A, svecs[i] = _sym_scale(A)
            _mark("permute")
            A_perm.append(A)
            gs_ell = None
            if lev.stencil is not None:
                A_fmt = formats.format_from_stencil(
                    lev.stencil, npdt, align, device=dev
                )
            elif bounds[i] is not None:
                # GS levels stay block-ELL whatever choose_format would
                # pick: the colored sweep slices their rows. A GS level's
                # smoother stores its rows split per color, cut from the
                # same host arrays (scaled and permuted)
                data, cols, nb = bell.pack(
                    A, lev.row_bs, lev.row_bs, npdt, align
                )
                A_fmt = bell.from_packed(
                    data, cols, nb, A.shape[1] // lev.row_bs, device=dev
                )
                if bounds[i] and stack:
                    gs_ell = (data, cols)
            else:
                A_fmt = formats.choose_format(
                    A, lev.row_bs, npdt, align, device=dev, stack=stack
                )
            A_fmts.append(A_fmt)
            _mark("pack_A")
            sms.append(
                stage_smoother(
                    build_smoother(
                        A, lev.row_bs, opts.smoother, i,
                        A_fmt.nrows_pad, npdt, color_bounds=bounds[i],
                        stencil=lev.stencil, ell=gs_ell,
                    ),
                    dev,
                )
                if _need_smoother(i)
                else None
            )
            _mark("smoothers")

        dev_levels = []
        for i, lev in enumerate(levels):
            P_fmt = R_fmt = None
            if lev.P is not None or lev.lattice_transfer is not None:
                # column block size = the NEXT level's dofs per vertex
                dpv = levels[i + 1].row_bs
                nf_pad = _scalar_pad(A_fmts[i], lev.row_bs)
                nc_pad = _scalar_pad(A_fmts[i + 1], dpv)
                if (
                    lev.lattice_transfer is not None
                    and isinstance(
                        A_fmts[i], (formats.DiaMatrix, formats.StencilDia)
                    )
                    and perms[i] is None
                    and perms[i + 1] is None
                ):
                    P_fmt, R_fmt = self._lattice_transfers(
                        lev, A_fmts[i], nf_pad, levels[i + 1].mesh.nv, nc_pad
                    )
                elif lev.row_bs * dpv > 1:
                    # block transfers: P in (row_bs, dpv) blocks, R its
                    # transpose in (dpv, row_bs) blocks, both block-ELL
                    P = lev.P
                    if not (
                        P.format == "bsr"
                        and P.blocksize == (lev.row_bs, dpv)
                    ):
                        P = P.tobsr(blocksize=(lev.row_bs, dpv))
                    Pb = _stage_block_prolongation(
                        P, perms[i], perms[i + 1], svecs[i], svecs[i + 1]
                    )
                    P_fmt = bell.from_scipy(
                        Pb, lev.row_bs, dpv, dtype=npdt,
                        row_align=align, device=dev,
                    )
                    R_fmt = bell.from_scipy(
                        Pb.T.tobsr(blocksize=(dpv, lev.row_bs)),
                        dpv, lev.row_bs, dtype=npdt,
                        row_align=align, device=dev,
                    )
                else:
                    # explicit scalar transfers as tile-ELL (one gathered
                    # x scalar per distinct coarse column of an 8-row tile)
                    P = _stage_prolongation(
                        lev.P, perms[i], perms[i + 1], svecs[i],
                        svecs[i + 1],
                    )
                    P_fmt = formats.tile_ell_from_scipy(
                        P, npdt, nr_pad=nf_pad, nc_pad=nc_pad,
                        device=dev,
                    )
                    R_fmt = formats.tile_ell_from_scipy(
                        P.T.tocsr(), npdt, nr_pad=nc_pad,
                        nc_pad=nf_pad, device=dev,
                    )
            dev_levels.append(
                DeviceLevel(A=A_fmts[i], smoother=sms[i], P=P_fmt, R=R_fmt)
            )
            _mark("pack_PR")
        self._scale0 = None
        if use_scaling:
            # solve-boundary scale in UNPERMUTED internal order:
            # x = S_0 y and r' = S_0 r both multiply by S_0
            self._scale0 = (
                svecs[0] if self._iperm0 is None else svecs[0][self._iperm0]
            )
        coarse_inv = None
        if opts.coarse_solve == CoarseSolveType.INV:
            # invert the PERMUTED (and scaled) coarsest matrix, in the row
            # order the device format and the restriction into it use; an
            # f64 inverse on scaled hierarchies (see solve/cycle.py)
            coarse_inv = torch.from_numpy(
                self._build_coarse_inv(
                    A_fmts[-1], A_perm[-1], keep_f64=use_scaling
                )
            ).to(dev)
        _mark("coarse_inv")
        # local cluster correction (smoothers/cluster_corr.py): batched
        # exact solves on near-singular sliver clusters of the finest
        # level, in the permuted row order of the device operator. Skipped
        # on stencil levels (translation-invariant couplings cannot be
        # locally defective) and on non-scalar problems.
        cluster_corr = None
        cc = opts.cluster_corr
        if (
            cc.enabled
            and levels[0].stencil is None
            and levels[0].row_bs == 1
        ):
            cluster_corr = detect_clusters(
                A_perm[0], beta=cc.beta, eig_ratio=cc.eig_ratio,
                max_size=cc.max_size, dtype=npdt, device=dev,
            )
        _mark("cluster_corr")
        op = AMGOperator(
            levels=tuple(dev_levels),
            coarse_inv=coarse_inv,
            cluster_corr=cluster_corr,
            cycle=opts.cycle.value,
        )
        if self.dtype == torch.bfloat16:
            # staged in f32 (numpy has no bfloat16): one cast on the device
            op = _cast_floats(op, self.dtype, {})
        if dev.type == "cuda":
            # the tensors were made on the device as they were packed; this
            # waits for the copies and casts still in flight
            torch.cuda.synchronize(dev)
        _mark("device_put")
        self.op = op
        self.A_dev = self.op.levels[0].A
        # f64 device twin of the finest operator for the mixed-precision
        # PCG (built lazily on the first mixed solve); _A0_perm keeps the
        # permuted + scaled f64 host matrix it packs from
        self._A64_mixed = None
        self._A0_perm = A_perm[0]
        # exact f64 finest operator for DEVICE-RESIDENT defect correction:
        # uniform stencils carry their (tiny, exact) f64 values on the
        # device, so the f64 residual never leaves it; every other finest
        # level takes the host refinement loop of ``solve``
        self._A64_dev = None
        if isinstance(self.A_dev, formats.StencilDia) and self._perm0 is None:
            from ..transfer.stencil import ClampedOp, detect_uniform

            st0 = levels[0].stencil
            vals64 = (
                detect_uniform(st0.patch)
                if isinstance(st0, ClampedOp)
                else None
            )
            if vals64 is not None:
                self._A64_dev = formats.StencilDia(
                    vals=torch.as_tensor(
                        vals64, dtype=torch.float64, device=dev
                    ),
                    offs=self.A_dev.offs,
                    dims=self.A_dev.dims,
                    nrows=self.A_dev.nrows,
                    nrows_pad=self.A_dev.nrows_pad,
                )

    def _lattice_transfers(self, lev, A_fmt, nf_pad, nc, nc_pad):
        """Implicit gather-free transfers of a lattice level: the smoothing
        matrix is the level's own (shared) device operator."""
        npdt = self.np_dtype
        meta = lev.lattice_transfer
        cd = (
            lev.stencil.constant_diagonal()
            if lev.stencil is not None
            else None
        )
        if cd is not None and cd > 0:
            # broadcast scalar: uniform level (pad rows stay zero because
            # A's matvec zeroes its tail)
            dinv = np.full(1, 1.0 / cd, dtype=npdt)
        else:
            d = (
                lev.stencil.diagonal()
                if lev.stencil is not None
                else lev.A.diagonal()
            )
            dinv = np.zeros(nf_pad, dtype=npdt)
            dinv[: len(d)] = np.where(
                d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0
            )
        common = dict(
            A=A_fmt,  # shared with the level: no copy
            Dinv=torch.from_numpy(dinv[:, None]).to(self.device),
            dims_f=meta["dims_f"],
            dims_c=meta["dims_c"],
            omega=meta["omega"],
            nf=lev.mesh.nv,
            nf_pad=nf_pad,
            nc=nc,
            nc_pad=nc_pad,
        )
        return LatticeProlongation(**common), LatticeRestriction(**common)

    def _build_coarse_inv(
        self, fmt_coarsest, A_coarsest, keep_f64=False
    ) -> np.ndarray:
        """Dense (pseudo-)inverse of the coarsest matrix (in the device row
        order), computed in f64 on the host and padded to the level's
        vector length; ``keep_f64`` keeps it in f64 for an f64 coarse solve
        inside an f32 cycle."""
        inv = _spd_inverse(A_coarsest.toarray())
        npad = _scalar_pad(fmt_coarsest, self.setup_levels_[-1].row_bs)
        out = np.zeros(
            (npad, npad), dtype=np.float64 if keep_f64 else self.np_dtype
        )
        out[: inv.shape[0], : inv.shape[1]] = inv
        return out

    # ------------------------------------------------------------------
    # apply / solve
    # ------------------------------------------------------------------
    @property
    def operator_complexity(self) -> float:
        return self.log_.operator_complexity

    @property
    def num_levels(self) -> int:
        return len(self.setup_levels_)

    def _to_dev(self, v: np.ndarray) -> torch.Tensor:
        bs = self.setup_levels_[0].row_bs
        v = np.asarray(v)
        if self._scale0 is not None:
            v = v * self._scale0  # r' = S_0 r (scaled hierarchy boundary)
        if self._perm0 is not None:
            v = v[self._perm0]
        return formats.block_vec(
            v, bs, self.A_dev.nrows_pad, self.dtype, self.device
        )

    def _from_dev(self, v: torch.Tensor) -> np.ndarray:
        out = (
            formats.flat_vec(v, self.A_dev.nrows)
            .to(torch.float64)
            .cpu()
            .numpy()
        )
        if self._iperm0 is not None:
            out = out[self._iperm0]
        if self._scale0 is not None:
            out = out * self._scale0  # x = S_0 y
        return out

    # external <-> internal vector views (partial Dirichlet, compound)
    def _expand_ext(self, b: np.ndarray) -> np.ndarray:
        if self._ext_free is None:
            return b
        out = np.zeros(self.n, dtype=np.float64)
        out[self._ext_free] = b
        return out

    def _contract_ext(self, x: np.ndarray) -> np.ndarray:
        return x if self._ext_free is None else x[self._ext_free]

    def matvec_free(self, p: np.ndarray) -> np.ndarray:
        """A @ p in the external (free-dof) space."""
        return self._contract_ext(self.A_host @ self._expand_ext(p))

    def apply(self, r: np.ndarray) -> np.ndarray:
        """x = M^-1 r — one AMG cycle (the reference `Mult`), in the
        external space."""
        self._require_setup()
        r = self._expand_ext(np.asarray(r, dtype=np.float64))
        with _full_f32():
            out = self._from_dev(amg_apply(self.op, self._to_dev(r)))
        return self._contract_ext(out)

    def solve(
        self,
        b: np.ndarray,
        *,
        tol: float = 1e-8,
        maxiter: int = 300,
        use_refinement: bool | None = None,
        return_device: bool = False,
        mixed: bool | None = None,
    ) -> tuple[np.ndarray | torch.Tensor, SolveInfo]:
        """AMG-PCG solve to relative residual ``tol``.

        float64 defect correction around the device PCG (inner tolerance
        bounded by the device dtype's accuracy). The f64 residual is
        computed on the device when the finest level is a uniform stencil,
        and on the host with scipy otherwise. ``return_device=True``
        returns the solution as a device tensor (f64, length n) on the
        device-residual path without an external DOF map (``freedofs``
        with partial constraints, the compound layout); otherwise a host
        array, as the JAX package does. ``b`` and the solution are in the
        external space.

        ``use_refinement``: ``None`` or ``True`` verifies against the true
        f64 residual with up to 8 defect-correction passes (4 in f64);
        ``False`` runs one unverified inner PCG (on the host-residual path,
        with no stagnation fallback).

        ``mixed=True`` goes straight to the mixed-precision PCG (f64 Krylov
        state and finest matvec, the f32 device cycle as M) instead of
        defect correction: iteration counts then track the f64-quality
        cycle, which matters on ill-conditioned block energies where each
        f32 inner pass stalls at its accuracy floor. ``None`` keeps the
        automatic behavior (defect correction, with the mixed PCG as the
        fallback when it stagnates).
        """
        self._require_setup()
        b = self._expand_ext(np.asarray(b, dtype=np.float64))
        bnorm = np.linalg.norm(b)
        device_path = self._A64_dev is not None
        on_device = return_device and self._ext_free is None
        if bnorm == 0:
            x = self._contract_ext(np.zeros_like(b))
            if on_device and device_path:
                x = torch.zeros(self.n, dtype=torch.float64, device=self.device)
            return x, SolveInfo(0, 0.0)
        floor = _FLOORS[self.dtype]
        if use_refinement is None:
            # always verify against the TRUE residual: PCG's recursive
            # residual drifts on ill-conditioned problems even in f64
            use_refinement = True
        inner_tol = max(tol, floor)
        max_outer = (
            (30 if floor > 1e-3 else (8 if floor > 0 else 4))
            if use_refinement
            else 1
        )
        with _full_f32():
            if mixed and self.dtype != torch.float64:
                x, info = self._solve_mixed(b, bnorm, tol, maxiter)
            elif device_path and use_refinement:
                x, info = self._solve_device_refined(
                    b, bnorm, tol, inner_tol, max_outer, maxiter,
                    return_device=on_device,
                )
                if on_device:
                    return x, info
            else:
                x, info = self._solve_host_refined(
                    b, bnorm, tol, inner_tol, max_outer, maxiter,
                    fallback=use_refinement,
                )
        return self._contract_ext(x), info

    def _solve_host_refined(self, b, bnorm, tol, inner_tol, max_outer,
                            maxiter, fallback: bool = True):
        """f64 defect correction with the residual computed on the host
        (scipy): one device PCG per outer pass, one solution read-back."""
        x = np.zeros(self.n)
        total_it = 0
        history = []
        stagnated = False
        for outer in range(max_outer):
            r = b - self.A_host @ x
            relres = np.linalg.norm(r) / bnorm
            history.append(relres)
            if relres <= tol:
                break
            if len(history) >= 2 and relres > 0.5 * history[-2]:
                stagnated = True
                break  # refinement stagnated (f32 accuracy floor)
            res = pcg(
                self.op,
                self.A_dev,
                self._to_dev(r),
                # ask only for the reachable reduction (see
                # _solve_device_refined)
                tol=float(max(inner_tol, 0.5 * tol / relres)),
                maxiter=maxiter,
            )
            x = x + self._from_dev(res.x)
            total_it += int(res.iterations)
        r = b - self.A_host @ x
        relres = float(np.linalg.norm(r) / bnorm)
        history.append(relres)
        if stagnated and relres > tol and fallback:
            # Defect correction is structurally dead when the f32 finest
            # matvec cannot resolve the residual (ill-scaled problems:
            # eps32 * ||A|| ||x|| >> ||b||, e.g. slender-beam elasticity,
            # where the inner f32 PCG's recursive residual collapses to
            # noise while the true residual grows). The mixed-precision
            # PCG is immune: f32 error enters only through M.
            x, mixed_info = self._solve_mixed(b, bnorm, tol, maxiter)
            return x, SolveInfo(
                iterations=total_it + mixed_info.iterations,
                relres=mixed_info.relres,
                outer_iterations=outer + 1 + mixed_info.outer_iterations,
                converged=mixed_info.converged,
                history=history + mixed_info.history,
            )
        info = SolveInfo(
            iterations=total_it,
            relres=relres,
            outer_iterations=outer + 1,
            converged=relres <= tol,
            history=history,
        )
        return x, info

    def _solve_mixed(self, b, bnorm, tol, maxiter):
        """The mixed-precision PCG: on the device when the finest operator
        has an f64 twin there, else with host Krylov vectors."""
        A64 = self._ensure_A64_mixed()
        if A64 is not None:
            return self._solve_mixed_device(b, bnorm, tol, maxiter, A64)
        return self._solve_mixed_outer(b, bnorm, tol, maxiter)

    def _ensure_A64_mixed(self):
        """f64 DEVICE twin of the finest operator (lazy, cached).

        Packs the permuted + scaled f64 host matrix into the same format
        (and padding) as the f32 device operator, so the mixed-precision
        Krylov state shares the hierarchy's vector layout.
        """
        if self._A64_mixed is not None:
            return self._A64_mixed
        if self._A64_dev is not None:  # exact f64 stencil already there
            self._A64_mixed = self._A64_dev
            return self._A64_mixed
        A0, Af = self._A0_perm, self.A_dev
        if A0 is None:
            return None
        bs = self.setup_levels_[0].row_bs
        dev = self.device
        fmt = None
        if isinstance(Af, formats.TileELLStack):
            fmt = formats.tile_ell_stack_from_scipy(
                A0, np.float64, device=dev
            )
        elif isinstance(Af, formats.TileELL):
            fmt = formats.tile_ell_from_scipy(
                A0, np.float64, nr_pad=Af.nrows_pad, nc_pad=Af.ncols_pad,
                device=dev,
            )
        elif isinstance(Af, formats.DiaMatrix):
            fmt = formats.dia_from_scipy(
                A0, np.float64, row_align=Af.nrows_pad, device=dev
            )
        elif isinstance(Af, formats.DenseMatrix):
            fmt = formats.dense_from_scipy(
                A0, bs, np.float64, row_align=Af.nrows_pad, device=dev
            )
        elif isinstance(Af, bell.BlockELL):
            fmt = bell.from_scipy(
                A0, bs, bs, dtype=np.float64, row_align=self._row_align,
                col_chunk=Af.col_chunk, device=dev,
            )
        if fmt is not None and _scalar_pad(fmt, bs) == _scalar_pad(Af, bs):
            self._A64_mixed = fmt
        return self._A64_mixed

    def _solve_mixed_device(self, b, bnorm, tol, maxiter, A64):
        """Device-resident mixed-precision PCG (solve/pcg.py ``pcg_mixed``):
        f64 Krylov vectors and finest matvec on the device, the f32
        hierarchy as M, no per-iteration host traffic but the residual
        scalar."""
        bs = self.setup_levels_[0].row_bs
        dev = self.device
        n_pad = self.A_dev.nrows_pad
        v = np.asarray(b, dtype=np.float64)
        if self._scale0 is not None:
            v = v * self._scale0
        if self._perm0 is not None:
            v = v[self._perm0]
        b64 = formats.block_vec(v, bs, n_pad, torch.float64, dev)
        # stopping criterion in the UNSCALED space: the hierarchy solves
        # A-hat = SAS, whose residual norm can sit an order of magnitude
        # off the honest ||r||/||b||; weight = S^-1 makes the recurrence
        # track the unscaled norm, so the solve stops at the right
        # iteration
        sinv_dev = None
        if self._scale0 is not None:
            s_perm = (
                self._scale0[self._perm0]
                if self._perm0 is not None
                else self._scale0
            )
            sinv = np.zeros(_scalar_pad(self.A_dev, bs), dtype=np.float64)
            sinv[: len(s_perm)] = 1.0 / s_perm
            sinv_dev = torch.from_numpy(sinv.reshape(-1, bs)).to(dev)
        res = pcg_mixed(
            self.op, A64, b64, tol=tol, maxiter=maxiter,
            cycle_dt=self.dtype, weight=sinv_dev,
        )
        # true-residual verification on the device (recursive residuals
        # drift; one extra f64 matvec), in the UNSCALED space, with
        # DEFECT-CORRECTION RESTARTS when the drift leaves the true
        # residual marginally above tol (the recurrence estimate runs
        # ~1-2x under the true residual at 1e-8; a restart costs 1-2 extra
        # iterations and makes ``converged`` trustworthy)
        x64 = res.x
        total_iters = int(res.iterations)
        outer = 1
        relres = np.inf
        history = []
        for _restart in range(3):
            r_true = b64 - formats.matvec(A64, x64)
            r_ver = r_true if sinv_dev is None else r_true * sinv_dev
            relres = float(torch.linalg.vector_norm(r_ver)) / bnorm
            history.append(relres)
            if relres <= tol or total_iters >= maxiter:
                break
            sub = pcg_mixed(
                self.op, A64, r_true,
                tol=min(0.8 * tol / relres, 0.5),
                maxiter=maxiter - total_iters,
                cycle_dt=self.dtype, weight=sinv_dev,
            )
            x64 = x64 + sub.x
            total_iters += int(sub.iterations)
            outer += 1
        x = formats.flat_vec(x64, self.A_dev.nrows).cpu().numpy()
        if self._iperm0 is not None:
            x = x[self._iperm0]
        if self._scale0 is not None:
            x = x * self._scale0
        return x, SolveInfo(
            iterations=total_iters,
            relres=relres,
            outer_iterations=outer,
            converged=relres <= tol,
            history=history,
        )

    def _solve_mixed_outer(self, b, bnorm, tol, maxiter):
        """Mixed-precision PCG with host-resident f64 vectors and finest
        matvec (scipy); the device applies only the preconditioner. Used
        when the finest operator has no f64 device twin."""
        A = self.A_host
        x = np.zeros(self.n)
        r = b.copy()
        history = []
        z = self._expand_ext(self.apply(self._contract_ext(r)))
        p = z.copy()
        rz = float(r @ z)
        it = 0
        relres = 1.0
        while it < maxiter:
            q = A @ p
            pq = float(p @ q)
            if pq <= 0 or rz == 0:
                break
            alpha = rz / pq
            x += alpha * p
            r -= alpha * q
            it += 1
            relres = float(np.linalg.norm(r) / bnorm)
            history.append(relres)
            if relres <= tol:
                break
            z = self._expand_ext(self.apply(self._contract_ext(r)))
            rz2 = float(r @ z)
            p = z + (rz2 / rz) * p
            rz = rz2
        return x, SolveInfo(
            iterations=it,
            relres=relres,
            outer_iterations=1,
            converged=relres <= tol,
            history=history,
        )

    def _solve_device_refined(
        self, b, bnorm, tol, inner_tol, max_outer, maxiter,
        return_device: bool = False,
    ):
        """f64 defect correction with the residual computed ON DEVICE."""
        A64 = self._A64_dev
        n, n_pad = A64.nrows, A64.nrows_pad
        b64 = torch.zeros((n_pad, 1), dtype=torch.float64, device=self.device)
        b64[:n, 0] = torch.from_numpy(b).to(self.device)
        x64 = torch.zeros_like(b64)
        total_it = 0
        history = []
        relres = 1.0
        for outer in range(max_outer):
            r64, rn2 = _refine_residual(A64, b64, x64)
            rn = float(torch.sqrt(rn2))
            relres = rn / bnorm
            history.append(relres)
            if relres <= tol or not np.isfinite(relres):
                break
            if len(history) >= 2 and relres > 0.5 * history[-2]:
                break  # stagnated at the f32 accuracy floor
            r32 = _refine_scale(r64, 1.0 / rn, self.dtype)
            res = pcg(
                self.op,
                self.A_dev,
                r32,
                # ask only for the reachable reduction: the f32 floor caps
                # what one inner pass delivers, and near convergence only
                # tol/relres is needed
                tol=float(max(inner_tol, 0.5 * tol / relres)),
                maxiter=maxiter,
            )
            x64 = _refine_accumulate(x64, res.x, rn)
            total_it += int(res.iterations)
        _r64, rn2 = _refine_residual(A64, b64, x64)
        relres = float(torch.sqrt(rn2)) / bnorm
        history.append(relres)
        x = x64[:n, 0]
        if not return_device:
            x = x.cpu().numpy()
        info = SolveInfo(
            iterations=total_it,
            relres=relres,
            outer_iterations=outer + 1,
            converged=relres <= tol,
            history=history,
        )
        return x, info

    # ------------------------------------------------------------------
    # self-tests (the reference's `Preconditioner::Test`, ngs_amg_do_test)
    # ------------------------------------------------------------------
    def test(self, iters: int = 60) -> tuple[float, float]:
        """Eigenvalue bounds of M^-1 A by preconditioned Lanczos (host
        loop): the extreme Ritz values of a CG recurrence through ``apply``
        and ``matvec_free``, so in the external space."""
        self._require_setup()
        rng = np.random.default_rng(0)
        n_ext = self.n if self._ext_free is None else len(self._ext_free)
        r = rng.standard_normal(n_ext)
        alphas, betas = [], []
        z = self.apply(r)
        rz = r @ z
        p = z.copy()
        for _ in range(min(iters, self.n)):
            q = self.matvec_free(p)
            pq = p @ q
            if pq <= 0 or rz == 0:
                break
            alpha = rz / pq
            r = r - alpha * q
            z = self.apply(r)
            rz_new = r @ z
            beta = rz_new / rz
            alphas.append(alpha)
            betas.append(beta)
            if np.sqrt(abs(rz_new)) < 1e-14:
                break
            p = z + beta * p
            rz = rz_new
        return _lanczos_bounds(alphas, betas)

    def test_levels(self, iters: int = 30) -> list[tuple[float, float]]:
        """Per-level hierarchy self-test (the reference's `test_levels` /
        `test_2level`): eigenvalue bounds of every TAIL hierarchy, level
        l's operator preconditioned by the cycle rooted at l, through the
        level's own device matvec. A bad level pair shows up as a collapsed
        lambda_min at its index. Returns (lo, hi) per level (the coarsest
        level solves exactly: bounds ~(1, 1))."""
        self._require_setup()
        out = []
        for l, lev in enumerate(self.op.levels):
            bs = self.setup_levels_[l].row_bs
            nb = lev.A.nrows_pad
            bsv = _scalar_pad(lev.A, bs) // nb
            nreal = lev.A.nrows * (bsv if bs == 1 else 1)

            def apply_l(r, l=l):
                with _full_f32():
                    return self._host(_cycle(self.op, self._dev(r), l))

            def matvec_l(p, lev=lev):
                with _full_f32():
                    return self._host(formats.matvec(lev.A, self._dev(p)))

            rng = np.random.default_rng(l)
            r = np.zeros((nb, bsv))
            r[: lev.A.nrows] = rng.standard_normal((lev.A.nrows, bsv))
            alphas, betas = [], []
            z = apply_l(r)
            rz = float((r * z).sum())
            p = z.copy()
            for _ in range(min(iters, max(nreal, 1))):
                q = matvec_l(p)
                pq = float((p * q).sum())
                if pq <= 0 or rz == 0:
                    break
                alpha = rz / pq
                r = r - alpha * q
                z = apply_l(r)
                rz_new = float((r * z).sum())
                alphas.append(alpha)
                betas.append(rz_new / rz)
                if np.sqrt(abs(rz_new)) < 1e-14:
                    break
                p = z + (rz_new / rz) * p
                rz = rz_new
            out.append(_lanczos_bounds(alphas, betas))
        return out

    def test_smoothers(self, sweeps: int = 4) -> list[float]:
        """Per-level smoother check (the reference's `test_smoothers`):
        ``sweeps`` symmetric sweeps on the homogeneous system must reduce
        the energy of a random start on every smoothed level. Returns the
        energy reduction factor per smoothed level."""
        self._require_setup()
        rates = []
        with _full_f32():
            for i, lev in enumerate(self.op.levels):
                if lev.smoother is None:
                    continue
                A = lev.A
                bs = self.setup_levels_[i].row_bs
                nb = A.nrows_pad
                bsv = _scalar_pad(A, bs) // nb
                rng = np.random.default_rng(i)
                x = self._dev(rng.standard_normal((nb, bsv)))
                e0 = float(torch.dot(x.reshape(-1),
                                     formats.matvec(A, x).reshape(-1)))
                b0 = torch.zeros_like(x)
                for _ in range(sweeps):
                    x = smooth(lev.smoother, A, x, b0)
                    x = smooth_back(lev.smoother, A, x, b0)
                e1 = float(torch.dot(x.reshape(-1),
                                     formats.matvec(A, x).reshape(-1)))
                rates.append(e1 / max(e0, 1e-300))
        return rates

    def _dev(self, v: np.ndarray) -> torch.Tensor:
        """A host (n, bs) array as a device tensor in the level dtype."""
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    @staticmethod
    def _host(v: torch.Tensor) -> np.ndarray:
        return v.to(torch.float64).cpu().numpy()

    def _require_setup(self):
        if not self._is_setup:
            raise RuntimeError("call .setup() first")


def _lanczos_bounds(alphas: list, betas: list) -> tuple[float, float]:
    """Extreme eigenvalues of the Lanczos tridiagonal of a CG run (the
    standard CG -> Lanczos relations); (1, 1) when no step was taken."""
    k = len(alphas)
    if k == 0:
        return 1.0, 1.0
    diag = np.zeros(k)
    off = np.zeros(max(k - 1, 0))
    for i in range(k):
        diag[i] = 1.0 / alphas[i]
        if i > 0:
            diag[i] += betas[i - 1] / alphas[i - 1]
        if i < k - 1:
            off[i] = np.sqrt(max(betas[i], 0.0)) / alphas[i]
    T = np.diag(diag)
    if k > 1:
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])



def amg_preconditioner(A, **kw) -> AMGPreconditioner:
    """Convenience: construct + setup in one call."""
    return AMGPreconditioner(A, **kw).setup()
