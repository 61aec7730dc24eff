"""Port parity for the bfloat16 device dtype (``AMGOptions(dtype="bfloat16")``).

The port stages bf16 levels through f32 numpy (numpy has no bfloat16) and
casts them once on the device; the JAX package rounds f64 to bf16 directly.
K1-K3's plain bf16 versions (the CPU side of their bf16 builds) sum in f32
and round once. Held to the JAX package on the CPU:

- the staged bf16 values of every level within one bf16 ulp of the JAX
  package's; launch plans made for the 2-byte elements; the lattice
  transfers still share their level's operator;
- the plain bf16 matvecs of K1 (``StencilDia``), K3 (symmetric-half DIA)
  and K2 (full DIA) at the JAX package's staged values: within one bf16
  rounding of the exact product of those values, and against the JAX
  package's bf16 ``formats.matvec`` to 1e-2 of max |y| beyond the JAX
  package's own distance from the exact product (it rounds every product
  and partial sum to bf16, 1-3% of max |y| at these shapes);
- the solves of ``poisson_3d(12)`` with the default options (block-ELL,
  the JAX package's ``test_h1.py::test_bf16_device_dtype``) and of
  ``poisson_3d(24)`` with Chebyshev (DIA levels): converged, true relres at
  most 1e-8, the JAX package's iterations within 10% (or 2);
- ``poisson_3d(40)`` with Chebyshev (a ``StencilDia`` finest level): both
  packages stop unconverged after the same passes, their first-pass relres
  within a factor 1.5; and the cause, which is the problem's conditioning.

Where the port differs: the JAX package's XLA CPU path rounds every product
and every partial sum of the DIA matvec to bf16, where the port's K2/K3
(and their plain versions) sum in f32. On ``poisson_3d(24)`` that makes the
port's defect correction converge in fewer iterations; with the reference's
rounding put into the port's plain DIA matvec
(``_dia_matvec_reference_rounding`` below) the port takes the JAX package's
iterations and passes. Both runs are tested.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch
import torch.nn.functional as F

import ngsamg_tpu
import ngsamg_tpu.sparse.formats as jformats
import ngsamg_tpu_torch
import ngsamg_tpu_torch.ops.dia_cuda as dia_cuda
import ngsamg_tpu_torch.ops.stencil_cuda as stencil_cuda
import ngsamg_tpu_torch.sparse.formats as tformats
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
BF16_UNIT_ROUNDOFF = 2.0 ** -8  # 2^-(p) with 8 significand bits (p = 8)


def _opts(pkg, cheb):
    o = pkg.AMGOptions(dtype="bfloat16")
    if cheb:
        o.smoother = pkg.config.SmootherOptions(
            type=pkg.config.SmootherType.CHEBYSHEV)
    return o


def _values(a) -> np.ndarray:
    """Staged values of either package as f64 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(a).astype(np.float64)


def _solve(pkg, p, cheb, **kw):
    pc = pkg.AMGPreconditioner(p.A, coords=p.coords,
                               options=_opts(pkg, cheb), **kw).setup()
    x, info = pc.solve(p.b, tol=1e-8)
    rel = float(np.linalg.norm(p.b - p.A @ np.asarray(x))
                / np.linalg.norm(p.b))
    return pc, info, rel


@pytest.fixture(scope="module")
def lattice_pair():
    """poisson_3d(40), Chebyshev, bf16, the symmetric-half storage from
    1,000 rows: levels StencilDia (K1), sym-half DIA (K3), DIA (K2),
    dense."""
    p = tfem.poisson_3d(40)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jformats, "_DIA_SYM_MIN_ROWS", 1000)
        mp.setattr(tformats, "_DIA_SYM_MIN_ROWS", 1000)
        pj = ngsamg_tpu.AMGPreconditioner(
            p.A, coords=p.coords, options=_opts(ngsamg_tpu, True)).setup()
        pt = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, coords=p.coords, options=_opts(ngsamg_tpu_torch, True),
            device="cpu").setup()
    return p, pj, pt


def _within_one_ulp(a, b):
    """|a - b| <= one bf16 ulp of b, elementwise."""
    ulp = np.where(b == 0, 0.0,
                   2.0 ** np.floor(np.log2(np.abs(np.where(b == 0, 1, b))))
                   * BF16_ULP)
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


def test_staged_levels_within_one_ulp(lattice_pair):
    _p, pj, pt = lattice_pair
    kinds = [type(lev.A).__name__ for lev in pt.op.levels]
    assert kinds == [type(lev.A).__name__ for lev in pj.op.levels]
    assert kinds == ["StencilDia", "DiaMatrix", "DiaMatrix", "DenseMatrix"]
    assert pt.op.levels[1].A.sym_half and not pt.op.levels[2].A.sym_half
    for dj, dt in zip(pj.op.levels, pt.op.levels):
        Aj, At = dj.A, dt.A
        data_t = At.vals if hasattr(At, "vals") else At.data
        data_j = Aj.vals if hasattr(Aj, "vals") else Aj.data
        assert data_t.dtype == torch.bfloat16
        _within_one_ulp(_values(data_t), _values(data_j))
        if dt.smoother is not None:
            assert dt.smoother.Dinv.dtype == torch.bfloat16
            _within_one_ulp(_values(dt.smoother.Dinv),
                            _values(dj.smoother.Dinv))
        if dt.P is not None:  # the lattice transfers share the level's A
            assert dt.P.A is dt.A and dt.R.A is dt.A
            assert dt.P.Dinv.dtype == torch.bfloat16
    assert pt.op.coarse_inv.dtype == torch.bfloat16
    _within_one_ulp(_values(pt.op.coarse_inv), _values(pj.op.coarse_inv))
    # the launch plans are made for 2-byte values
    A0, A1, A2 = (pt.op.levels[i].A for i in range(3))
    assert A0.launch.plan == stencil_cuda.stencil_plan(A0.offs, A0.dims, 2)
    assert A1.launch.plan == dia_cuda.dia_sym_plan(A1.offsets,
                                                   A1.nrows_pad, 2)
    assert A2.launch.plan == dia_cuda.dia_plan(A2.offsets, A2.nrows_pad, 2)
    assert pt._A64_dev.vals.dtype == torch.float64  # the residual stays f64


@pytest.mark.parametrize("level", [0, 1, 2], ids=["K1", "K3", "K2"])
def test_plain_bf16_matvec_matches_jax(lattice_pair, level):
    """The port's plain bf16 matvec against the JAX package's bf16
    ``formats.matvec``, both on the JAX package's staged values."""
    import jax.numpy as jnp

    _p, pj, pt = lattice_pair
    Aj, At = pj.op.levels[level].A, pt.op.levels[level].A
    if isinstance(At, tformats.StencilDia):
        A = tformats.StencilDia(
            vals=torch.from_numpy(_values(Aj.vals)).to(torch.bfloat16),
            offs=At.offs, dims=At.dims, nrows=At.nrows,
            nrows_pad=At.nrows_pad)
        plain = stencil_cuda._stencil_matvec_plain
    else:
        A = tformats.DiaMatrix(
            data=torch.from_numpy(_values(Aj.data)).to(torch.bfloat16),
            offsets=At.offsets, nrows=At.nrows, nrows_pad=At.nrows_pad,
            sym_half=At.sym_half)
        plain = dia_cuda._dia_matvec_plain
    rng = np.random.default_rng(level)
    x = np.zeros((A.nrows_pad, 1))
    x[: A.nrows, 0] = rng.standard_normal(A.nrows)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    yt = plain(A, xt)
    assert yt.dtype == torch.bfloat16
    yj = jformats.matvec(Aj, jnp.asarray(_values(xt), jnp.bfloat16))
    A64 = (dataclasses.replace(A, vals=A.vals.double())
           if hasattr(A, "vals") else
           dataclasses.replace(A, data=A.data.double()))
    y_ex = _values(plain(A64, xt.double()))  # the exact product, in f64
    yt, yj = _values(yt), _values(yj)
    scale = np.abs(y_ex).max()
    # one rounding of an f32 sum: half a bf16 ulp, and f32 noise
    assert (np.abs(yt - y_ex) <= BF16_UNIT_ROUNDOFF * np.abs(y_ex)
            + 1e-6 * scale).all()
    ref_err = np.abs(yj - y_ex).max()
    assert np.abs(yt - yj).max() <= 1e-2 * scale + ref_err
    assert np.abs(yt - y_ex).max() <= ref_err
    np.testing.assert_array_equal(yt[A.nrows:], 0.0)


def test_bf16_device_dtype():
    """The JAX package's test_bf16_device_dtype: bf16 device compute and
    f64 defect correction reach 1e-8 on poisson_3d(12) (default options:
    multicolor GS on block-ELL levels, the f64 coarse inverse), in the JAX
    package's iterations within 10% (or 2)."""
    p = tfem.poisson_3d(12)
    pj, ij, rj = _solve(ngsamg_tpu, p, False)
    pt, it, rt = _solve(ngsamg_tpu_torch, p, False, device="cpu")
    assert [type(lev.A).__name__ for lev in pt.op.levels] == \
        ["BlockELL", "DenseMatrix"]
    assert pt.op.levels[0].A.data.dtype == torch.bfloat16
    assert str(pt.op.coarse_inv.dtype) == f"torch.{pj.op.coarse_inv.dtype}"
    assert it.converged == ij.converged is True
    assert rt <= 1e-8 and it.iterations < 100
    assert abs(it.iterations - ij.iterations) <= max(2, 0.1 * ij.iterations)


def _dia_matvec_reference_rounding(A, x):
    """The JAX package's XLA CPU arithmetic of a bf16 DIA matvec: every
    product and every partial sum rounded to bf16 (full storage)."""
    assert not A.sym_half
    n = A.nrows_pad
    lo, hi = -min(A.offsets[0], 0), max(A.offsets[-1], 0)
    xp = F.pad(x[:, 0], (lo, hi))
    y = torch.zeros_like(x[:, 0])
    for d, off in enumerate(A.offsets):
        y = y + A.data[d] * xp[lo + off: lo + off + n]
    return y[:, None]


def test_reference_rounding_model_is_exact():
    """The model above reproduces the JAX package's bf16 DIA matvec bit
    for bit, where the port's plain version (f32 sums) does not."""
    import jax.numpy as jnp

    p = tfem.poisson_3d(24)
    A64 = p.A.tocsr()
    Aj = jformats.dia_from_scipy(A64, jnp.bfloat16, row_align=8,
                                 use_pallas=False)
    At = tformats.DiaMatrix(
        data=torch.from_numpy(_values(Aj.data)).to(torch.bfloat16),
        offsets=tuple(Aj.offsets), nrows=Aj.nrows, nrows_pad=Aj.nrows_pad)
    x = np.zeros((At.nrows_pad, 1))
    x[: At.nrows, 0] = np.random.default_rng(0).standard_normal(At.nrows)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    yj = _values(jformats.matvec(Aj, jnp.asarray(_values(xt), jnp.bfloat16)))
    np.testing.assert_array_equal(
        _values(_dia_matvec_reference_rounding(At, xt)), yj)
    y_plain = _values(dia_cuda._dia_matvec_plain(At, xt))
    assert not np.array_equal(y_plain, yj)


@pytest.mark.parametrize("rounding", ["port", "reference"])
def test_bf16_dia_path_solve(rounding):
    """poisson_3d(24), Chebyshev: DIA levels (K2's path). With the port's
    arithmetic (f32 sums) it converges to 1e-8 in at most the JAX
    package's iterations; with the reference's rounding in the plain DIA
    matvec, in the JAX package's iterations within 10% (or 2) and passes
    within one."""
    p = tfem.poisson_3d(24)
    pj, ij, rj = _solve(ngsamg_tpu, p, True)
    with pytest.MonkeyPatch.context() as mp:
        if rounding == "reference":
            mp.setattr(dia_cuda, "_dia_matvec_plain",
                       _dia_matvec_reference_rounding)
        pt, it, rt = _solve(ngsamg_tpu_torch, p, True, device="cpu")
    assert [type(lev.A).__name__ for lev in pt.op.levels] == \
        ["DiaMatrix", "DiaMatrix", "DenseMatrix"]
    assert ij.converged and rj <= 1e-8
    assert it.converged and rt <= 1e-8
    if rounding == "port":
        assert it.iterations <= ij.iterations
    else:
        assert abs(it.iterations - ij.iterations) <= \
            max(2, 0.1 * ij.iterations)
        assert abs(it.outer_iterations - ij.outer_iterations) <= 1


def test_bf16_stencil_path_stagnates_as_the_reference(lattice_pair):
    """poisson_3d(40), Chebyshev: neither package converges; the same
    passes, the first pass's relres within a factor 1.5."""
    p = tfem.poisson_3d(40)
    _pj, ij, rj = _solve(ngsamg_tpu, p, True)
    pt, it, rt = _solve(ngsamg_tpu_torch, p, True, device="cpu")
    assert type(pt.op.levels[0].A).__name__ == "StencilDia"
    assert not ij.converged and not it.converged
    assert it.outer_iterations == ij.outer_iterations
    h1j, h1t = ij.history[1], it.history[1]
    assert max(h1j, h1t) / min(h1j, h1t) <= 1.5, (ij.history, it.history)
    assert rt > 0.1 and rj > 0.1


def _kappa(n: int) -> float:
    """Condition number of poisson_3d(n): h times the 7-point Laplacian on
    (n - 1)^3 interior nodes (the Kuhn-tet P1 stiffness has no other
    couplings), eigenvalues h sum_k 4 sin^2(pi j_k / 2n): cot^2(pi / 2n)."""
    return 1.0 / np.tan(np.pi / (2 * n)) ** 2


def test_bf16_stagnation_follows_the_condition_number():
    """Why poisson_3d(40) stagnates: the inner PCG keeps its iterate in
    bf16, and the rounding of an iterate x (unit roundoff u = 2^-8 of |x|)
    puts a residual of up to lambda_max * u * |x| <= kappa * u * |b| into
    A x, a floor that a defect-correction pass cannot get under. kappa * u
    is 0.23 on poisson_3d(12) and 0.91 on (24), which converge, and 2.5 on
    poisson_3d(40) (6.5 on (64)), which stagnate, whatever the finest
    format."""
    A = tfem.poisson_3d(12).A.tocsc()
    lmax = sla.eigsh(A, k=1, which="LA", return_eigenvectors=False)[0]
    lmin = sla.eigsh(A, k=1, sigma=0, which="LM",
                     return_eigenvectors=False)[0]
    assert lmax / lmin == pytest.approx(_kappa(12), rel=1e-8)
    floors = {n: _kappa(n) * BF16_UNIT_ROUNDOFF for n in (12, 24, 40, 64)}
    assert [round(floors[n], 2) for n in (12, 24, 40, 64)] == \
        [0.23, 0.91, 2.53, 6.48]
    assert floors[12] < floors[24] < 1.0 < floors[40] < floors[64]
