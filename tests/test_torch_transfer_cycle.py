"""Port parity for the lattice transfers, the smoothers and one V-cycle.

The JAX package's staged hierarchy of `fem.poisson_3d(40)` (Chebyshev) is
carried over leaf by leaf with `precond.convert.from_jax_operator`, so
both packages apply their transfers, smoothers and cycle to identical
data and inputs. Transfers: rtol 1e-5. One smooth and one full
`amg_apply`: relative 2-norm error <= 1e-5 in f32 (some 40 matvecs whose
sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngsamg_tpu
from ngsamg_tpu.smoothers import core as jcore
from ngsamg_tpu.solve import cycle as jcycle
from ngsamg_tpu.transfer import lattice_transfer as jlt
from ngsamg_tpu.utils import fem as jfem
from ngsamg_tpu_torch.precond.convert import from_jax_operator
from ngsamg_tpu_torch.smoothers import core as tcore
from ngsamg_tpu_torch.solve import cycle as tcycle
from ngsamg_tpu_torch.transfer import lattice_transfer as tlt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hier():
    p = jfem.poisson_3d(40)
    opts = ngsamg_tpu.AMGOptions(
        smoother=ngsamg_tpu.config.SmootherOptions(
            type=ngsamg_tpu.config.SmootherType.CHEBYSHEV
        )
    )
    pc = ngsamg_tpu.AMGPreconditioner(p.A, coords=p.coords, options=opts)
    pc.setup()
    op_np = jax.tree_util.tree_map(np.asarray, pc.op)
    return pc.op, from_jax_operator(op_np)


def _vec(n, n_pad, seed):
    x = np.zeros((n_pad, 1), dtype=np.float32)
    x[:n, 0] = np.random.default_rng(seed).standard_normal(n)
    return x


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_converted_operator_shape(hier):
    opj, opt = hier
    assert len(opt.levels) == len(opj.levels) == 4
    assert opt.cycle == "V"
    for lj, lt in zip(opj.levels, opt.levels):
        assert type(lt.A).__name__ == type(lj.A).__name__
        if lt.P is not None:
            assert lt.P.A is lt.A and lt.R.A is lt.A


@pytest.mark.parametrize("level", [0, 1, 2])
def test_lattice_transfers_match_jax(hier, level):
    opj, opt = hier
    Pj, Rj = opj.levels[level].P, opj.levels[level].R
    Pt, Rt = opt.levels[level].P, opt.levels[level].R
    xc = _vec(Pt.nc, Pt.nc_pad, 10 + level)
    yj = np.asarray(jlt.lattice_prol_apply(Pj, jnp.asarray(xc)))
    yt = tlt.lattice_prol_apply(Pt, torch.from_numpy(xc)).numpy()
    assert yt.shape == (Pt.nf_pad, 1)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())
    np.testing.assert_array_equal(yt[Pt.nf:], 0.0)
    rf = _vec(Rt.nf, Rt.nf_pad, 20 + level)
    zj = np.asarray(jlt.lattice_restrict_apply(Rj, jnp.asarray(rf)))
    zt = tlt.lattice_restrict_apply(Rt, torch.from_numpy(rf)).numpy()
    assert zt.shape == (Rt.nc_pad, 1)
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5 * np.abs(zj).max())
    np.testing.assert_array_equal(zt[Rt.nc:], 0.0)


@pytest.mark.parametrize("dims_f", [(7, 4, 5), (6, 9), (11,)])
def test_up_down_sample_odd_dims(dims_f):
    dims_c = tuple((d + 1) // 2 for d in dims_f)
    rng = np.random.default_rng(0)
    xc = rng.standard_normal(int(np.prod(dims_c))).astype(np.float32)
    xf = rng.standard_normal(int(np.prod(dims_f))).astype(np.float32)
    np.testing.assert_array_equal(
        tlt._upsample(torch.from_numpy(xc), dims_c, dims_f).numpy(),
        np.asarray(jlt._upsample(jnp.asarray(xc), dims_c, dims_f)),
    )
    np.testing.assert_allclose(
        tlt._downsample_sum(torch.from_numpy(xf), dims_f, dims_c).numpy(),
        np.asarray(jlt._downsample_sum(jnp.asarray(xf), dims_f, dims_c)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("level", [0, 1, 2])
def test_chebyshev_smooth_matches_jax(hier, level):
    opj, opt = hier
    lj, lt = opj.levels[level], opt.levels[level]
    b = _vec(lt.A.nrows, lt.A.nrows_pad, 30 + level)
    x0 = _vec(lt.A.nrows, lt.A.nrows_pad, 40 + level)
    for start in (None, x0):
        xj = np.asarray(jcore.smooth(
            lj.smoother, lj.A, None if start is None else jnp.asarray(start),
            jnp.asarray(b),
        ))
        xt = tcore.smooth(
            lt.smoother, lt.A,
            None if start is None else torch.from_numpy(start),
            torch.from_numpy(b),
        ).numpy()
        assert _rel(xt, xj) <= 1e-5


def test_jacobi_smooth_matches_jax(hier):
    """The damped-Jacobi smoother on level 1's operator and diagonal."""
    opj, opt = hier
    lj, lt = opj.levels[1], opt.levels[1]
    sj = jcore.JacobiSmoother(Dinv=lj.smoother.Dinv, omega=0.5, steps=3)
    st = tcore.JacobiSmoother(Dinv=lt.smoother.Dinv, omega=0.5, steps=3)
    b = _vec(lt.A.nrows, lt.A.nrows_pad, 50)
    xj = np.asarray(jcore.smooth(sj, lj.A, None, jnp.asarray(b)))
    xt = tcore.smooth(st, lt.A, None, torch.from_numpy(b)).numpy()
    assert _rel(xt, xj) <= 1e-5


def test_amg_apply_matches_jax(hier):
    opj, opt = hier
    A0 = opt.levels[0].A
    b = _vec(A0.nrows, A0.nrows_pad, 60)
    xj = np.asarray(jcycle.amg_apply(opj, jnp.asarray(b)))
    xt = tcycle.amg_apply(opt, torch.from_numpy(b)).numpy()
    assert xt.shape == xj.shape
    assert _rel(xt, xj) <= 1e-5
    np.testing.assert_array_equal(xt[A0.nrows:], 0.0)
