"""Port parity for the main-path matvecs (K1 stencil, K2/K3 DIA) on CPU.

The same inputs, made with numpy from fixed seeds, go through the port's
plain PyTorch versions (the CPU side of the kernel wrappers) and through
the JAX package: its XLA lowering (`formats.matvec` /
`formats._dia_matvec_xla`), its Pallas kernels in interpret mode, and a
dense oracle. Cases mirror tests/test_pallas_interpret.py. Tolerances:
f32 rtol = atol = 1e-5 (that file's), f64 stencil rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsamg_tpu.ops.dia_pallas import dia_matvec_pallas
from ngsamg_tpu.ops.stencil_pallas import stencil_matvec_pallas
from ngsamg_tpu.sparse import formats as jf
from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda
from ngsamg_tpu_torch.sparse import formats as tf

torch.set_num_threads(2)

TILE = 8192  # the JAX DIA kernel's row tile (LANES * ROWS_PER_TILE)

STENCIL_CASES = [
    # odd dims, 7-point Laplacian-like stencil (negative offsets)
    ((7, 9, 11), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                  (0, -1, 0), (0, 0, 1), (0, 0, -1)]),
    # axis-0 stride (4*38=152) crosses the 128-lane boundary
    ((5, 4, 38), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 2),
                  (1, 1, -1), (-1, -1, 1)]),
    # 2-d lattice with pad tail and long diagonals
    ((33, 131), [(0, 0), (2, 0), (-2, 0), (0, 3), (0, -3), (1, 1),
                 (-1, -1)]),
]


def _dia_dense(offsets, data, n, sym_half):
    A = np.zeros((n, n))
    for d, off in enumerate(offsets):
        for i in range(n):
            j = i + off
            if 0 <= j < n:
                A[i, j] = data[d, i]
            if sym_half and off > 0 and 0 <= i - off:
                A[i, i - off] = data[d, i - off]
    return A


def _dia_pair(offsets, n, sym_half, seed=0):
    n_pad = -(-n // TILE) * TILE
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n_pad), dtype=np.float32)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = rng.standard_normal(hi - lo).astype(np.float32)
    offsets = tuple(int(o) for o in offsets)
    A_j = jf.DiaMatrix(
        data=jnp.asarray(data), offsets=offsets, nrows=n, nrows_pad=n_pad,
        use_pallas=False, sym_half=sym_half,
    )
    A_t = tf.DiaMatrix(
        data=torch.from_numpy(data), offsets=offsets, nrows=n,
        nrows_pad=n_pad, sym_half=sym_half,
    )
    return A_j, A_t, data


def _check_dia(offsets, n, sym_half, seed_x):
    A_j, A_t, data = _dia_pair(offsets, n, sym_half)
    rng = np.random.default_rng(seed_x)
    x = np.zeros((A_t.nrows_pad, 1), dtype=np.float32)
    x[:n, 0] = rng.standard_normal(n).astype(np.float32)
    before = dict(dia_cuda.LAUNCHES)
    y_t = tf.matvec(A_t, torch.from_numpy(x)).numpy()[:, 0]
    assert dia_cuda.LAUNCHES == before  # CPU tensors never launch a kernel
    y_xla = np.asarray(jf._dia_matvec_xla(A_j, jnp.asarray(x)))[:, 0]
    y_pl = np.asarray(
        dia_matvec_pallas(A_j, jnp.asarray(x), interpret=True)
    )[:, 0]
    np.testing.assert_allclose(y_t[:n], y_xla[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_t[:n], y_pl[:n], rtol=1e-5, atol=1e-5)
    dense = _dia_dense(offsets, data, n, sym_half)
    np.testing.assert_allclose(
        y_t[:n], dense @ x[:n, 0], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(y_t[n:], 0.0)


@pytest.mark.parametrize(
    "offsets,n",
    [
        ((-200, -128, -3, 0, 3, 128, 200), TILE - 77),  # pad tail
        ((-128, -1, 0, 1, 128), TILE),  # lane-boundary offsets
        ((-300, 0, 300), 2 * TILE - 5),  # multi-tile
    ],
)
def test_dia_general_matches_jax(offsets, n):
    _check_dia(offsets, n, sym_half=False, seed_x=1)


@pytest.mark.parametrize(
    "offsets,n",
    [
        ((0, 1, 127, 128, 500), TILE - 13),  # within one halo tile
        ((0, 128, TILE + 37), 3 * TILE - 9),  # K=2 deep data halo
    ],
)
def test_dia_sym_half_matches_jax(offsets, n):
    _check_dia(offsets, n, sym_half=True, seed_x=2)


def _stencil_pair(dims, offs, dtype_np, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    vals = rng.standard_normal(len(offs)).astype(dtype_np)
    n_pad = -(-n // 8) * 8
    offs = tuple(tuple(int(v) for v in o) for o in offs)
    dims = tuple(int(d) for d in dims)
    A_j = jf.StencilDia(
        vals=jnp.asarray(vals), offs=offs, dims=dims, nrows=n,
        nrows_pad=n_pad,
    )
    A_t = tf.StencilDia(
        vals=torch.from_numpy(vals), offs=offs, dims=dims, nrows=n,
        nrows_pad=n_pad,
    )
    return A_j, A_t, vals


def _stencil_dense(dims, offs, vals):
    d = len(dims)
    n = int(np.prod(dims))
    idx = np.stack(
        np.meshgrid(*[np.arange(s) for s in dims], indexing="ij"), axis=-1
    ).reshape(n, d)
    strides = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * dims[k + 1]
    M = np.zeros((n, n))
    for t, off in enumerate(offs):
        tgt = idx + np.asarray(off)
        ok = np.all((tgt >= 0) & (tgt < np.asarray(dims)), axis=1)
        M[np.flatnonzero(ok), (tgt[ok] * strides).sum(axis=1)] += vals[t]
    return M


@pytest.mark.parametrize("dims,offs", STENCIL_CASES)
def test_stencil_f32_matches_jax(dims, offs):
    A_j, A_t, vals = _stencil_pair(dims, offs, np.float32)
    n = A_t.nrows
    rng = np.random.default_rng(3)
    x = np.zeros((A_t.nrows_pad, 1), dtype=np.float32)
    x[:n, 0] = rng.standard_normal(n).astype(np.float32)
    before = dict(stencil_cuda.LAUNCHES)
    y_t = tf.matvec(A_t, torch.from_numpy(x)).numpy()[:, 0]
    assert stencil_cuda.LAUNCHES == before
    # CPU backend: the JAX formats.matvec takes its XLA shift path
    y_xla = np.asarray(jf.matvec(A_j, jnp.asarray(x)))[:, 0]
    y_pl = np.asarray(
        stencil_matvec_pallas(A_j, jnp.asarray(x), interpret=True)
    )[:, 0]
    np.testing.assert_allclose(y_t[:n], y_xla[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_t[:n], y_pl[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y_t[n:], 0.0)
    dense = _stencil_dense(A_t.dims, A_t.offs, vals.astype(np.float64))
    np.testing.assert_allclose(
        y_t[:n], dense @ x[:n, 0], rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("dims,offs", STENCIL_CASES)
def test_stencil_f64_matches_jax(dims, offs):
    """The defect-correction residual's f64 instance of K1."""
    with jax.enable_x64(True):
        A_j, A_t, vals = _stencil_pair(dims, offs, np.float64)
        n = A_t.nrows
        rng = np.random.default_rng(4)
        x = np.zeros((A_t.nrows_pad, 1))
        x[:n, 0] = rng.standard_normal(n)
        y_t = tf.matvec(A_t, torch.from_numpy(x)).numpy()[:, 0]
        y_xla = np.asarray(jf.matvec(A_j, jnp.asarray(x)))[:, 0]
    assert y_t.dtype == np.float64
    np.testing.assert_allclose(y_t[:n], y_xla[:n], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(y_t[n:], 0.0)
    dense = _stencil_dense(A_t.dims, A_t.offs, vals)
    np.testing.assert_allclose(
        y_t[:n], dense @ x[:n, 0], rtol=1e-12, atol=1e-12
    )


def test_dense_matvec_matches_jax():
    rng = np.random.default_rng(5)
    M = rng.standard_normal((16, 16)).astype(np.float32)
    x = rng.standard_normal((16, 1)).astype(np.float32)
    y_t = tf.matvec(
        tf.DenseMatrix(data=torch.from_numpy(M), nrows=13, nrows_pad=16,
                       bs=1),
        torch.from_numpy(x),
    ).numpy()
    y_j = np.asarray(jf.matvec(
        jf.DenseMatrix(data=jnp.asarray(M), nrows=13, nrows_pad=16, bs=1),
        jnp.asarray(x),
    ))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain version; anything else is the
    kernel's or an error."""
    _, A_t, _ = _stencil_pair(*STENCIL_CASES[0], np.float32)
    x = torch.zeros((A_t.nrows_pad, 1), device="meta")
    with pytest.raises(ValueError):
        stencil_cuda.stencil_matvec(A_t, x)
    _, D_t, _ = _dia_pair((-1, 0, 1), 100, sym_half=False)
    with pytest.raises(ValueError):
        dia_cuda.dia_matvec(D_t, torch.zeros((D_t.nrows_pad, 1),
                                             device="meta"))


def test_block_vec_roundtrip():
    v = np.arange(10.0)
    bv = tf.block_vec(v, 1, 16, torch.float32)
    assert tuple(bv.shape) == (16, 1) and bv.dtype == torch.float32
    np.testing.assert_array_equal(bv[10:].numpy(), 0.0)
    np.testing.assert_array_equal(tf.flat_vec(bv, 10).numpy(), v)


def test_stencil_kernel_meta_layout():
    """The int64 array K1 reads: linear offsets, vector offsets, reach."""
    offs = ((0, 0, 0), (1, 0, 0), (0, -1, 2))
    meta = stencil_cuda._device_meta(offs, (5, 4, 38), torch.device("cpu"))
    strides = (4 * 38, 38, 1)
    lin = [sum(o[k] * strides[k] for k in range(3)) for o in offs]
    flat = [v for o in offs for v in o]
    assert meta.dtype == torch.int64
    assert meta.tolist() == lin + flat + [1, 1, 2]
