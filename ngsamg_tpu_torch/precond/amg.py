"""AMG preconditioner front-end (strict algebraic mode) on PyTorch.

Port of ngsamg_tpu/precond/amg.py for the structured main path:

  AMGPreconditioner(A, coords=..., device=...) -> .setup()
      host stencil-domain level loop -> smoothers -> coarse inverse ->
      device staging                     -> .solve(b) / .apply(r)

Setup runs on the host in numpy/scipy (factory/levels.py) and stages the
hierarchy as torch tensors on ``device``. The solve is float64 defect
correction around the f32 device PCG, with the f64 residual computed on
the device by the f64 twin of the finest-level stencil, so only scalars
cross to the host until the final solution. There is no fallback: a CUDA
device runs the hand-written kernels or raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from ..apps.h1 import H1Energy
from ..config import AMGOptions, CoarseSolveType, CycleType, options_from_flags
from ..factory.levels import setup_levels
from ..smoothers.build import build_smoother
from ..smoothers.core import ChebyshevSmoother
from ..solve.cycle import AMGOperator, DeviceLevel, amg_apply
from ..solve.pcg import pcg
from ..sparse import formats
from ..transfer.lattice_transfer import LatticeProlongation, LatticeRestriction

ROW_ALIGN = 8

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _refine_residual(A64, b64, x64):
    r = b64 - formats.matvec(A64, x64)
    return r, torch.dot(r[:, 0], r[:, 0])


def _refine_scale(r64, inv_rn: float, dt: torch.dtype):
    return (r64 * inv_rn).to(dt)


def _refine_accumulate(x64, dx32, rn: float):
    return x64 + dx32.to(torch.float64) * rn


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

    ``device`` is required: the hierarchy is staged there and the solve
    runs there ("cuda" for the hand-written kernels, "cpu" for their plain
    versions). Options of the JAX package that this port does not run
    raise: ``shards != 1``, ``dist_setup > 1`` and ``do_test``. Cluster
    correction (``options.cluster_corr``) is not ported: the JAX package
    skips it when the finest level is a stencil, which is the only finest
    level this port sets up, so it has no effect here.
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
        device: str | torch.device,
        **flags,
    ):
        if options is None:
            options = options_from_flags(flags) if flags else AMGOptions()
        self.options = options
        for unported, item in (
            (options.shards != 1, "shards: ROADMAP queue 1 item 8"),
            (options.dist_setup > 1, "dist_setup: ROADMAP queue 1 item 8"),
            (options.do_test, "do_test: ROADMAP queue 1 item 7"),
        ):
            if unported:
                raise NotImplementedError(
                    f"{item} (not ported to ngsamg_tpu_torch yet)"
                )
        for name, val in (
            ("freedofs", freedofs),
            ("elmat_data", elmat_data),
            ("nodalp2", nodalp2),
        ):
            if val is not None:
                raise NotImplementedError(
                    f"{name}: not ported to ngsamg_tpu_torch yet"
                )
        if dof_layout != "interleaved":
            raise NotImplementedError(
                f"dof_layout {dof_layout!r}: not ported to ngsamg_tpu_torch"
            )
        if self.options.cycle != CycleType.V:
            raise NotImplementedError(
                f"{self.options.cycle.value}-cycle: ngsamg_tpu_torch runs "
                "V-cycles only (ROADMAP queue 1 item 4)"
            )
        if not isinstance(A, sp.dia_matrix):
            # DIA input feeds the structured fast path without a CSR detour
            A = A.tocsr()
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"matrix must be square, got {A.shape}")
        if A.shape[0] % block_size:
            raise ValueError(
                f"matrix size {A.shape[0]} not divisible by "
                f"block_size {block_size}"
            )
        self.A_host = A if A.dtype == np.float64 else A.astype(np.float64)
        self.n = A.shape[0]
        self.coords = None if coords is None else np.asarray(coords, float)
        if isinstance(energy, str):
            if energy != "h1":
                raise NotImplementedError(
                    f"energy {energy!r}: ngsamg_tpu_torch ports H1 only"
                )
            energy = H1Energy(bs=block_size)
        self.energy = energy
        if self.options.dtype not in _DTYPES:
            raise ValueError(f"device dtype {self.options.dtype!r}")
        self.dtype = _DTYPES[self.options.dtype]
        self.np_dtype = np.dtype(self.options.dtype)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: CUDA is not available")
        self._is_setup = False

    # ------------------------------------------------------------------
    # setup (BuildAMGMat)
    # ------------------------------------------------------------------
    def setup(self) -> "AMGPreconditioner":
        t0 = time.perf_counter()
        self.setup_levels_, self.log_ = setup_levels(
            self.A_host, self.energy, self.options, self.coords
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
        return self

    def _compile_device(self):
        """Stage the hierarchy: formats, smoothers, implicit lattice
        transfers, coarse inverse, and the f64 finest stencil."""
        opts = self.options
        levels = self.setup_levels_
        nlev = len(levels)
        dev, npdt = self.device, self.np_dtype

        A_fmts, sms = [], []
        for i, lev in enumerate(levels):
            # stencil levels stay in natural (lattice) order; CSR-tail
            # levels are DIA or dense, which need no reordering either
            if lev.stencil is not None:
                A_fmt = formats.format_from_stencil(
                    lev.stencil, npdt, ROW_ALIGN, device=dev
                )
            else:
                A_fmt = formats.choose_format(
                    lev.A, lev.row_bs, npdt, ROW_ALIGN, device=dev
                )
            A_fmts.append(A_fmt)
            is_coarsest = i == nlev - 1
            need_smoother = (not is_coarsest) or (
                opts.coarse_solve != CoarseSolveType.INV
            )
            sms.append(
                self._stage_smoother(
                    build_smoother(
                        lev.A, lev.row_bs, opts.smoother, i,
                        A_fmt.nrows_pad, npdt, stencil=lev.stencil,
                    )
                )
                if need_smoother
                else None
            )

        dev_levels = []
        for i, lev in enumerate(levels):
            P_fmt = R_fmt = None
            if lev.P is not None or lev.lattice_transfer is not None:
                if lev.lattice_transfer is None or not isinstance(
                    A_fmts[i], (formats.DiaMatrix, formats.StencilDia)
                ):
                    raise NotImplementedError(
                        "explicit (tile-ELL) transfers are not ported to "
                        "ngsamg_tpu_torch (ROADMAP queue 1 item 2)"
                    )
                meta = lev.lattice_transfer
                nf_pad = A_fmts[i].nrows_pad
                cd = (
                    lev.stencil.constant_diagonal()
                    if lev.stencil is not None
                    else None
                )
                if cd is not None and cd > 0:
                    # broadcast scalar: uniform level (pad rows stay zero
                    # because A's matvec zeroes its tail)
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
                    A=A_fmts[i],  # shared with the level: no copy
                    Dinv=torch.from_numpy(dinv[:, None]).to(dev),
                    dims_f=meta["dims_f"],
                    dims_c=meta["dims_c"],
                    omega=meta["omega"],
                    nf=lev.mesh.nv,
                    nf_pad=nf_pad,
                    nc=levels[i + 1].mesh.nv,
                    nc_pad=A_fmts[i + 1].nrows_pad,
                )
                P_fmt = LatticeProlongation(**common)
                R_fmt = LatticeRestriction(**common)
            dev_levels.append(
                DeviceLevel(A=A_fmts[i], smoother=sms[i], P=P_fmt, R=R_fmt)
            )
        coarse_inv = None
        if opts.coarse_solve == CoarseSolveType.INV:
            coarse_inv = torch.from_numpy(
                self._build_coarse_inv(A_fmts[-1])
            ).to(dev)
        self.op = AMGOperator(
            levels=tuple(dev_levels),
            coarse_inv=coarse_inv,
            cycle=opts.cycle.value,
        )
        self.A_dev = self.op.levels[0].A
        # exact f64 finest operator for DEVICE-RESIDENT defect correction:
        # uniform stencils carry their (tiny, exact) f64 values on the
        # device, so the f64 residual never leaves it
        self._A64_dev = None
        if isinstance(self.A_dev, formats.StencilDia):
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

    def _stage_smoother(self, sm: ChebyshevSmoother) -> ChebyshevSmoother:
        """Host-built smoother -> device Dinv (scalars stay on the host)."""
        return ChebyshevSmoother(
            Dinv=torch.from_numpy(sm.Dinv).to(self.device),
            lam_max=sm.lam_max,
            lam_min=sm.lam_min,
            order=sm.order,
            steps=sm.steps,
        )

    def _build_coarse_inv(self, fmt_coarsest) -> np.ndarray:
        """Dense (pseudo-)inverse of the coarsest matrix, computed in f64
        on the host and padded to the level's vector length."""
        lev = self.setup_levels_[-1]
        inv = _spd_inverse(lev.A.toarray())
        npad = fmt_coarsest.nrows_pad * lev.row_bs
        out = np.zeros((npad, npad), dtype=self.np_dtype)
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
        return formats.block_vec(
            np.asarray(v), bs, self.A_dev.nrows_pad, self.dtype, self.device
        )

    def _from_dev(self, v: torch.Tensor) -> np.ndarray:
        return (
            formats.flat_vec(v, self.A_dev.nrows)
            .cpu()
            .numpy()
            .astype(np.float64)
        )

    def apply(self, r: np.ndarray) -> np.ndarray:
        """x = M^-1 r — one AMG cycle (the reference `Mult`)."""
        self._require_setup()
        r = np.asarray(r, dtype=np.float64)
        return self._from_dev(amg_apply(self.op, self._to_dev(r)))

    def solve(
        self,
        b: np.ndarray,
        *,
        tol: float = 1e-8,
        maxiter: int = 300,
        return_device: bool = False,
    ) -> tuple[np.ndarray | torch.Tensor, SolveInfo]:
        """AMG-PCG solve to relative residual ``tol``.

        float64 defect correction around the device PCG (inner tolerance
        bounded by the device dtype's accuracy), with the f64 residual
        computed on the device. ``return_device=True`` returns the solution
        as a device tensor (f64, length n) instead of a host array.
        """
        self._require_setup()
        b = np.asarray(b, dtype=np.float64)
        bnorm = np.linalg.norm(b)
        if bnorm == 0:
            x = np.zeros_like(b)
            if return_device:
                x = torch.zeros(self.n, dtype=torch.float64, device=self.device)
            return x, SolveInfo(0, 0.0)
        if self._A64_dev is None:
            raise NotImplementedError(
                "ngsamg_tpu_torch solves only problems whose finest level is "
                "a uniform stencil (device f64 defect correction); the host "
                "refinement loop arrives with the generic level loop"
            )
        # inner accuracy floor of the device dtype (defect correction
        # bridges the gap to the requested tolerance)
        floor = 0.0 if self.dtype == torch.float64 else 2e-6
        inner_tol = max(tol, floor)
        max_outer = 8 if floor > 0 else 4
        return self._solve_device_refined(
            b, bnorm, tol, inner_tol, max_outer, maxiter,
            return_device=return_device,
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

    def _require_setup(self):
        if not self._is_setup:
            raise RuntimeError("call .setup() first")

