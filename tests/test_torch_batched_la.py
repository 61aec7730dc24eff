"""Port parity for batched device linear algebra (ops/batched_la.py) and
the device branch of the elasticity energy's pencil solver.

- ``pinv_batched``, ``pencil_extreme_eig`` (min and max) and
  ``harmonic_mean_batched`` against the JAX package's ``batched_la`` on the
  same seeded f32 inputs: rtol 1e-4 (the two call different eigensolvers).
- ``pencil_extreme_eig`` against the f64 numpy branch of
  ``apps/elasticity.py::_pencil_extreme_eig`` on well-conditioned pencils:
  rtol 5e-3, atol 1e-4, the JAX package's
  ``test_components.py::test_batched_pencil_matches_numpy``.
- ``soc_robust`` with ``DEVICE_SOC_MIN_EDGES = 1`` (the device branch, on
  the energy's device, here the CPU) against the default numpy branch, as
  ``test_elasticity.py::test_robust_matching_default_and_device_wiring``;
  and the preconditioner threads its device into the energy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngsamg_tpu_torch
import ngsamg_tpu_torch.apps.elasticity as tel
from ngsamg_tpu.ops import batched_la as jbla
from ngsamg_tpu_torch.ops import batched_la as tbla
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)


def _spectral(rng, b, k, rank=None):
    """Symmetric (b, k, k) blocks with eigenvalues in [1, 4] on a random
    basis and exact zeros beyond ``rank``: conditioned so that f32 keeps
    the rank decisions and four digits."""
    Q, _ = np.linalg.qr(rng.standard_normal((b, k, k)))
    lam = rng.uniform(1.0, 4.0, (b, k))
    if rank is not None:
        lam[:, rank:] = 0.0
    return np.einsum("bik,bk,bjk->bij", Q, lam, Q)


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("k", [1, 2, 3, 6, 8])
def test_pinv_matches_jax(k):
    rng = np.random.default_rng(k)
    M = _spectral(rng, 40, k, rank=max(k - 1, 1))  # singular for k > 1
    yt = tbla.pinv_batched(_f32(M)).numpy()
    yj = np.asarray(jbla.pinv_batched(jnp.asarray(M, jnp.float32)))
    np.testing.assert_allclose(yt, yj, rtol=1e-4,
                               atol=1e-4 * np.abs(yj).max())
    # a pseudo-inverse: M M^+ M = M
    Mt = M.astype(np.float32)
    np.testing.assert_allclose(Mt @ yt @ Mt, Mt, rtol=0,
                               atol=1e-3 * np.abs(Mt).max())


@pytest.mark.parametrize("reduction", ["min", "max"])
@pytest.mark.parametrize("k", [3, 6])
def test_pencil_matches_jax(k, reduction):
    rng = np.random.default_rng(10 + k)
    C = _spectral(rng, 64, k)
    C[::7] = _spectral(rng, len(C[::7]), k, rank=k - 2)  # rank-deficient C
    C[5] = 0.0  # an all-null pencil
    E = _spectral(rng, 64, k, rank=None if reduction == "min" else 2)
    yt = tbla.pencil_extreme_eig(_f32(E), _f32(C), rel_tol=1e-6,
                                 reduction=reduction).numpy()
    yj = np.asarray(jbla.pencil_extreme_eig(
        jnp.asarray(E, jnp.float32), jnp.asarray(C, jnp.float32),
        rel_tol=1e-6, reduction=reduction))
    assert yt[5] == yj[5] == 0.0
    np.testing.assert_allclose(yt, yj, rtol=1e-4,
                               atol=1e-4 * np.abs(yj).max())


def test_harmonic_mean_matches_jax():
    rng = np.random.default_rng(3)
    A, B = _spectral(rng, 30, 6), _spectral(rng, 30, 6, rank=4)
    yt = tbla.harmonic_mean_batched(_f32(A), _f32(B)).numpy()
    yj = np.asarray(jbla.harmonic_mean_batched(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32)))
    np.testing.assert_allclose(yt, yj, rtol=1e-4,
                               atol=1e-4 * np.abs(yj).max())
    np.testing.assert_array_equal(yt, np.swapaxes(yt, -1, -2))


def test_pencil_matches_numpy_branch():
    """The JAX package's test_batched_pencil_matches_numpy: well-conditioned
    C, so that the f32 and f64 rank decisions agree."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((20, 6, 6))
    C = np.einsum("bik,bjk->bij", X, X) + 0.5 * np.eye(6)
    Y = rng.standard_normal((20, 6, 2))
    E = np.einsum("bik,bjk->bij", Y, Y)
    ref = tel._pencil_extreme_eig(E, C, reduction="max")
    dev = tbla.pencil_extreme_eig(_f32(E), _f32(C), reduction="max").numpy()
    np.testing.assert_allclose(dev, ref, rtol=5e-3, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tel, "DEVICE_SOC_MIN_EDGES", 1)
        routed = tel._pencil_extreme_eig(E, C, reduction="max",
                                         device="cpu")
        assert routed.dtype == np.float64
        np.testing.assert_array_equal(routed, dev.astype(np.float64))
        with pytest.raises(ValueError, match="device"):
            tel._pencil_extreme_eig(E, C, reduction="max")


def test_robust_soc_device_branch():
    """soc_robust through the device branch against the numpy branch
    (the JAX package's test_robust_matching_default_and_device_wiring)."""
    assert tel.ElasticityEnergy(2).default_robust
    assert tel.DEVICE_SOC_MIN_EDGES == 10**9  # off by default
    p = tfem.elasticity_2d(6, length=6)
    en = tel.ElasticityEnergy(2, device="cpu")
    mesh = en.build_finest_mesh(p.A, p.coords)
    ref = en.soc_robust(mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tel, "DEVICE_SOC_MIN_EDGES", 1)
        dev = en.soc_robust(mesh)
    scale = max(float(ref.max()), 1e-30)
    np.testing.assert_allclose(dev / scale, ref / scale, atol=2e-5)


def test_preconditioner_threads_its_device():
    """The preconditioner's device reaches the energy: an energy made by
    name gets it, one made without a device gets it, one made with a device
    keeps its own; a setup on the device branch solves."""
    p = tfem.elasticity_2d(8, length=6)
    kw = dict(block_size=2, coords=p.coords, device="cpu")
    opts = ngsamg_tpu_torch.AMGOptions(dtype="float64")
    opts.levels.max_coarse_size = 60
    pc = ngsamg_tpu_torch.AMGPreconditioner(p.A, energy="elasticity", **kw)
    assert pc.energy.device == torch.device("cpu")
    en = tel.ElasticityEnergy(2)
    assert ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy=en, **kw).energy.device == torch.device("cpu")
    en = tel.ElasticityEnergy(2, device="meta")
    assert ngsamg_tpu_torch.AMGPreconditioner(
        p.A, energy=en, **kw).energy.device == "meta"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tel, "DEVICE_SOC_MIN_EDGES", 1)
        pc = ngsamg_tpu_torch.AMGPreconditioner(
            p.A, energy="elasticity", options=opts, **kw).setup()
    x, info = pc.solve(p.b, tol=1e-8)
    rel = np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b)
    assert pc.num_levels >= 2 and info.converged and rel <= 1e-8
