"""Port parity for the block-ELL format (ngsamg_tpu_torch/sparse/bell.py).

Random block-sparse matrices made from a numpy seed, with blocks (1,1),
(3,3), (6,6), (3,6) and (6,3), go through both packages' `from_scipy`:
- `data` and `cols` must equal the JAX package's arrays bit for bit, with
  `col_chunk` 1 and 2 (square blocks) and with a forced ELL `width`;
- `spmv` agrees with scipy and with `ngsamg_tpu.sparse.bell.spmv` to rtol
  1e-5 in f32 and 1e-12 in f64 (relative to the largest entry of y);
- `to_scipy` gives back the matrix;
- a JAX `BlockELL` carried over by `from_jax_operator`'s format converter
  holds the same arrays and multiplies alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu.sparse.bell as jbell
import ngsamg_tpu_torch.sparse.bell as tbell
from ngsamg_tpu_torch.precond import convert
from ngsamg_tpu_torch.sparse import formats as tformats
from ngsamg_tpu_torch.sparse import host as thost

torch.set_num_threads(2)

BLOCKS = [(1, 1), (3, 3), (6, 6), (3, 6), (6, 3)]
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _random_bsr(br, bc, nbr=37, nbc=29, seed=0):
    """A random block-sparse matrix with 1-7 blocks a row (row 5 empty)."""
    rng = np.random.default_rng(seed + 10 * br + bc)
    if br == bc:
        nbc = nbr
    rows, cols = [], []
    for r in range(nbr):
        k = 0 if r == 5 else int(rng.integers(1, 8))
        c = np.sort(rng.choice(nbc, size=k, replace=False))
        rows += [r] * k
        cols += list(c)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=nbr))])
    data = rng.standard_normal((len(cols), br, bc))
    return sp.bsr_matrix(
        (data, np.asarray(cols, dtype=np.int32), indptr),
        shape=(nbr * br, nbc * bc),
    )


def _x(A, bc, dtype, row_align=8, chunk=1):
    n = A.shape[1] // bc
    n_pad = -(-n // row_align) * row_align
    x = np.zeros((n_pad, bc), dtype=dtype)
    x[:n] = np.random.default_rng(3).standard_normal((n, bc))
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("blk", BLOCKS, ids=lambda b: "%dx%d" % b)
def test_from_scipy_and_spmv(blk, dtype):
    br, bc = blk
    A = _random_bsr(br, bc)
    Ain = A.tocsr() if blk == (1, 1) else A
    with jax.enable_x64(True):
        Bj = jbell.from_scipy(Ain, br, bc, dtype=dtype, stage=True)
        Bt = tbell.from_scipy(Ain, br, bc, dtype=dtype)
        assert Bt.data.numpy().dtype == dtype
        assert Bt.cols.dtype == torch.int32
        np.testing.assert_array_equal(Bt.data.numpy(), Bj.data)
        np.testing.assert_array_equal(Bt.cols.numpy(), Bj.cols)
        assert (Bt.nrows, Bt.ncols, Bt.nrows_pad, Bt.col_chunk) == (
            Bj.nrows, Bj.ncols, Bj.nrows_pad, Bj.col_chunk
        )
        assert Bt.shape == A.shape and Bt.block_shape == (br, bc)
        x = _x(A, bc, dtype)
        yt = tbell.spmv(Bt, torch.from_numpy(x)).numpy()
        yj = np.asarray(jbell.spmv(
            jbell.from_scipy(Ain, br, bc, dtype=dtype), jnp.asarray(x)
        ))
    assert yt.dtype == dtype and yt.shape == (Bt.nrows_pad, br)
    ys = (A @ x[: A.shape[1] // bc].reshape(-1).astype(np.float64)).reshape(
        -1, br
    )
    scale = np.abs(ys).max()
    assert np.abs(yt[: Bt.nrows] - ys).max() <= TOL[dtype] * scale
    assert np.abs(yt - yj).max() <= TOL[dtype] * scale
    assert not yt[Bt.nrows:].any()
    # the dispatch in formats.matvec and the @ operator reach the same spmv
    np.testing.assert_array_equal(
        tformats.matvec(Bt, torch.from_numpy(x)).numpy(), yt
    )
    np.testing.assert_array_equal((Bt @ torch.from_numpy(x)).numpy(), yt)


@pytest.mark.parametrize("blk", [(1, 1), (3, 3), (6, 6)],
                         ids=lambda b: "%dx%d" % b)
def test_col_chunk_2(blk):
    br, bc = blk
    A = _random_bsr(br, bc, seed=1)
    Ain = A.tocsr() if blk == (1, 1) else A
    with jax.enable_x64(True):
        Bj = jbell.from_scipy(
            Ain, br, bc, dtype=np.float64, stage=True, col_chunk=2
        )
    Bt = tbell.from_scipy(Ain, br, bc, dtype=np.float64, col_chunk=2)
    np.testing.assert_array_equal(Bt.data.numpy(), Bj.data)
    np.testing.assert_array_equal(Bt.cols.numpy(), Bj.cols)
    assert Bt.col_chunk == 2 and Bt.block_shape == (br, 2 * bc)
    x = _x(A, bc, np.float64)
    yt = tbell.spmv(Bt, torch.from_numpy(x)).numpy()
    ys = (A @ x[: A.shape[1] // bc].reshape(-1)).reshape(-1, br)
    assert np.abs(yt[: Bt.nrows] - ys).max() <= 1e-12 * np.abs(ys).max()
    back = tbell.to_scipy(Bt)
    assert abs(back - A.tocsr()).max() == 0.0


@pytest.mark.parametrize("blk", BLOCKS, ids=lambda b: "%dx%d" % b)
def test_forced_width_and_to_scipy(blk):
    br, bc = blk
    A = _random_bsr(br, bc, seed=2)
    Ain = A.tocsr() if blk == (1, 1) else A
    with jax.enable_x64(True):
        Bj = jbell.from_scipy(
            Ain, br, bc, dtype=np.float64, stage=True, width=11, row_align=16
        )
    Bt = tbell.from_scipy(
        Ain, br, bc, dtype=np.float64, width=11, row_align=16
    )
    assert Bt.ell_width == 11 and Bt.nrows_pad % 16 == 0
    np.testing.assert_array_equal(Bt.data.numpy(), Bj.data)
    np.testing.assert_array_equal(Bt.cols.numpy(), Bj.cols)
    back = tbell.to_scipy(Bt)
    assert back.shape == A.shape and abs(back - A.tocsr()).max() == 0.0
    assert abs(jbell.to_scipy(Bj) - back).max() == 0.0
    with pytest.raises(ValueError, match="ELL width"):
        tbell.from_scipy(Ain, br, bc, dtype=np.float64, width=2)


@pytest.mark.parametrize("blk", [(3, 3), (3, 6), (6, 3)],
                         ids=lambda b: "%dx%d" % b)
def test_from_jax_operator_carries_block_ell(blk):
    br, bc = blk
    A = _random_bsr(br, bc, seed=4)
    Bj = jbell.from_scipy(A, br, bc, dtype=np.float32, stage=True)
    Bt = convert._format(Bj, "cpu")
    assert isinstance(Bt, tbell.BlockELL)
    np.testing.assert_array_equal(Bt.data.numpy(), Bj.data)
    np.testing.assert_array_equal(Bt.cols.numpy(), Bj.cols)
    assert convert._transfer(Bj, None, "cpu").data.shape == Bj.data.shape
    x = _x(A, bc, np.float32)
    yt = tbell.spmv(Bt, torch.from_numpy(x)).numpy()
    yj = np.asarray(jbell.spmv(
        jbell.from_scipy(A, br, bc, dtype=np.float32), jnp.asarray(x)
    ))
    assert np.abs(yt - yj).max() <= 1e-5 * np.abs(yj).max()


def test_host_block_helpers():
    """`to_bsr` caches its view on the matrix, `bsr_permute` is the block
    permutation, `block_diagonal_fast` and `block_norm_graph` read the
    blocks."""
    import ngsamg_tpu.sparse.host as jhost

    A = _random_bsr(3, 3, seed=5)
    A = (A + A.T + sp.eye(A.shape[0]) * 10).tocsr()
    B = thost.to_bsr(A, 3)
    assert thost.to_bsr(A, 3) is B and A._amg_bsr_cache[0] == 3
    assert thost.to_bsr(B, 3) is B
    perm = np.random.default_rng(0).permutation(A.shape[0] // 3)
    Bp = thost.bsr_permute(B, perm)
    sperm = (perm[:, None] * 3 + np.arange(3)).ravel()
    assert abs(Bp.tocsr() - A[sperm][:, sperm]).max() == 0.0
    assert Bp.has_sorted_indices
    assert abs(Bp - jhost.bsr_permute(jhost.to_bsr(A.copy(), 3), perm)).max() == 0
    np.testing.assert_array_equal(
        thost.block_diagonal_fast(A, 3), jhost.block_diagonal_fast(A.copy(), 3)
    )
    Wt, dt = thost.block_norm_graph(A, 3)
    Wj, dj = jhost.block_norm_graph(A.copy(), 3)
    assert abs(Wt - Wj).max() == 0.0
    np.testing.assert_array_equal(dt, dj)
