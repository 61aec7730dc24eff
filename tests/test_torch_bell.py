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

The kernel of a CUDA tensor (ops/bell_cuda.py, csrc/bell_matvec.cu) runs
only on the card (chip_smoke.py `[block_ell]`); here:
- the plain path of a CPU tensor is still the `rows_product` contraction,
  bit for bit, at every staged block shape (br, bc in {1, 2, 3, 6}) and
  with `col_chunk` 2, and a `BlockELL` without `nslots` multiplies alike;
- `nslots` from `pack` / `from_scipy` is each row's BSR degree (explicit
  zero blocks counted, padded rows 0), and every slot past it is padding;
- the launch plans take every slot and row once: a numpy walk of the
  kernel's threads over the real slots gives the plain product;
- the wrapper refuses wrong inputs before it loads the library, and the
  module imports without `nvcc`.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu.sparse.bell as jbell
import ngsamg_tpu_torch.sparse.bell as tbell
from ngsamg_tpu_torch.ops import bell_cuda
from ngsamg_tpu_torch.precond import convert
from ngsamg_tpu_torch.sparse import formats as tformats
from ngsamg_tpu_torch.sparse import host as thost

torch.set_num_threads(2)

BLOCKS = [(1, 1), (3, 3), (6, 6), (3, 6), (6, 3)]
# every block shape the kernel has a build of (br, bc in {1, 2, 3, 6})
STAGED = [(br, bc) for br in (1, 2, 3, 6) for bc in (1, 2, 3, 6)]
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


def _plain(B, x):
    """The plain contraction, written out: gather, then rows_product."""
    xt = torch.from_numpy(x)
    if B.col_chunk > 1:
        xt = xt.reshape(-1, B.col_chunk * xt.shape[1])
    return tbell.rows_product(B.data, xt[B.cols])


def _degrees(A, br, bc):
    """Stored blocks a row of the BSR view pack reads."""
    if br == bc == 1:
        return np.diff(A.tocsr().indptr)
    return np.diff(sp.bsr_matrix(A, blocksize=(br, bc)).indptr)


def _chunk_cases(blocks):
    """(block, col_chunk): every block with 1, the square ones also with 2
    (col_chunk packs square operators only)."""
    return [pytest.param(b, c, id="%dx%d-c%d" % (*b, c))
            for b in blocks for c in (1, 2) if c == 1 or b[0] == b[1]]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("blk,chunk", _chunk_cases(STAGED))
def test_plain_spmv_is_rows_product(blk, chunk, dtype):
    """A CPU tensor keeps the plain path: spmv is the gather and the
    rows_product contraction bit for bit, with and without nslots."""
    br, bc = blk
    A = _random_bsr(br, bc, seed=6)
    B = tbell.from_scipy(A, br, bc, dtype=dtype, col_chunk=chunk)
    x = _x(A, bc, dtype)
    y = tbell.spmv(B, torch.from_numpy(x))
    assert torch.equal(y, _plain(B, x))
    assert B.nslots is not None
    bare = tbell.BlockELL(data=B.data, cols=B.cols, nrows=B.nrows,
                          ncols=B.ncols, nrows_pad=B.nrows_pad,
                          col_chunk=B.col_chunk)
    assert bare.nslots is None and bare.launch == B.launch
    assert torch.equal(tbell.spmv(bare, torch.from_numpy(x)), y)
    ys = (A @ x[: A.shape[1] // bc].reshape(-1).astype(np.float64))
    scale = np.abs(ys).max()
    assert np.abs(y.numpy()[: B.nrows].ravel() - ys).max() <= (
        TOL[dtype] * scale)


def _with_zero_block(br, bc):
    """_random_bsr with an explicit zero block stored in row 3."""
    A = _random_bsr(br, bc, seed=7)
    data = A.data.copy()
    data[A.indptr[3]] = 0.0  # row 3 keeps its first block, all zero
    out = sp.bsr_matrix((data, A.indices, A.indptr), shape=A.shape)
    assert out.indptr[4] > out.indptr[3] and not out.data[out.indptr[3]].any()
    return out


@pytest.mark.parametrize("blk,chunk", _chunk_cases(BLOCKS))
def test_nslots_counts_real_slots(blk, chunk):
    """nslots is each row's stored-block count (chunks with col_chunk 2),
    explicit zero blocks included; padded rows 0; every slot past it is
    padding (column 0, a zero block)."""
    br, bc = blk
    A = _with_zero_block(br, bc)
    data, cols, n, nslots = tbell.pack(A, br, bc, np.float64, 16,
                                       col_chunk=chunk)
    assert nslots.dtype == np.int32 and nslots.shape == (data.shape[0],)
    assert n == A.shape[0] // br and data.shape[0] % 16 == 0
    assert not nslots[n:].any()
    if chunk == 1:
        np.testing.assert_array_equal(nslots[:n], _degrees(A, br, bc))
        assert nslots[3] >= 1  # the explicit zero block counts
    else:
        B = sp.bsr_matrix(A, blocksize=(br, bc))
        rows = np.repeat(np.arange(n), np.diff(B.indptr))
        pairs = {(r, c // chunk) for r, c in zip(rows, B.indices)}
        want = np.bincount([r for r, _ in pairs], minlength=n)
        np.testing.assert_array_equal(nslots[:n], want)
    assert nslots[5] == 0  # _random_bsr leaves row 5 empty
    k = np.arange(data.shape[1])[None, :]
    pad = k >= nslots[:, None]
    assert not cols[pad].any() and not data[pad].any()
    T = tbell.from_scipy(A, br, bc, dtype=np.float64, row_align=16,
                         col_chunk=chunk)
    assert T.nslots.dtype == torch.int32
    np.testing.assert_array_equal(T.nslots.numpy(), nslots)
    W = tbell.from_scipy(A, br, bc, dtype=np.float64, width=11,
                         col_chunk=chunk) if chunk == 1 else None
    if W is not None:
        assert W.ell_width == 11
        np.testing.assert_array_equal(W.nslots.numpy()[:n], nslots[:n])


def test_nslots_ride_along_copies():
    """The counts and a fresh plan survive a pickle, a dtype cast of the
    staged tree and a rank's row slice."""
    from ngsamg_tpu_torch.parallel import shard
    from ngsamg_tpu_torch.precond.amg import _cast_floats

    A = _random_bsr(3, 3, seed=8)
    B = tbell.from_scipy(A, 3, 3, dtype=np.float32)
    C = pickle.loads(pickle.dumps(B))
    assert torch.equal(C.nslots, B.nslots) and C.launch == B.launch
    D = _cast_floats(B, torch.float64, {})
    assert D.data.dtype == torch.float64 and D.nslots is B.nslots
    assert D.launch == bell_cuda.stage(D)

    class _Pl:
        r0, local = 8, 16

    R = shard._rows_of(B, _Pl, "cpu")
    assert torch.equal(R.nslots, B.nslots[8:24]) and R.nrows_pad == 16
    x = torch.from_numpy(_x(A, 3, np.float32))
    assert torch.equal(tbell.spmv(R, x), tbell.spmv(B, x)[8:24])


def _walk(B, x, plan):
    """y as the kernel computes it: block b, thread t owns row
    b * rows + t // (lanes * warps) and takes its slots rank, rank + tpr,
    ... below nslots; every (row, slot) must be taken exactly once."""
    n, K, br, bcw = B.data.shape
    tpr = plan.lanes * plan.warps
    rows = bell_cuda.THREADS // tpr
    assert plan.blocks == -(-n // rows)
    ns = B.nslots.numpy() if B.nslots is not None else np.full(n, K)
    data, cols = B.data.numpy(), B.cols.numpy()
    xr = x.reshape(-1, bcw)
    y = np.zeros((n, br))
    taken = np.zeros((n, K), dtype=np.int64)
    for b in range(plan.blocks):
        for t in range(bell_cuda.THREADS):
            row, rank = b * rows + t // tpr, t % tpr
            if row >= n:
                continue
            for k in range(rank, int(ns[row]), tpr):
                taken[row, k] += 1
                y[row] += data[row, k] @ xr[cols[row, k]]
    want = np.zeros_like(taken)
    want[np.arange(K)[None, :] < ns[:, None]] = 1
    np.testing.assert_array_equal(taken, want)
    return y


@pytest.mark.parametrize("plan_kw", [{}, {"lanes": 1}, {"lanes": 4},
                                     {"lanes": 32}, {"lanes": 32, "warps": 4}],
                         ids=["own", "l1", "l4", "l32", "l32w4"])
@pytest.mark.parametrize("blk", [(1, 1), (3, 3), (3, 6), (6, 3)],
                         ids=lambda b: "%dx%d" % b)
def test_kernel_walk_matches_plain(blk, plan_kw):
    br, bc = blk
    A = _random_bsr(br, bc, nbr=61, nbc=43, seed=9)
    B = tbell.from_scipy(A, br, bc, dtype=np.float64)
    n, K = B.cols.shape
    plan = bell_cuda.bell_plan(K, br, bc, n, **plan_kw)
    x = _x(A, bc, np.float64)
    y = _walk(B, x, plan)
    np.testing.assert_allclose(y, tbell.spmv(B, torch.from_numpy(x)).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_bell_plan_from_shape():
    """The plan follows the shape: about K / 4 lanes a row, at least 4,
    more lanes and then warps while the grid is small; the plans of
    elasticity3d_36's levels and transfers."""
    p = bell_cuda.bell_plan
    # (K, br, bcw, rows) -> (lanes, warps)
    cases = {
        (37, 3, 3, 416_736): (8, 1),  # level 0 A (and its f64 twin)
        (4, 3, 6, 416_736): (4, 1),  # level 0 P
        (89, 6, 3, 32_520): (16, 1),  # level 0 R
        (100, 6, 6, 32_520): (32, 1),  # level 1 A
        (4, 6, 6, 32_520): (4, 1),  # level 1 P
        (88, 6, 6, 2_560): (16, 1),  # level 1 R
        (144, 6, 6, 2_560): (32, 1),  # level 2 A
        (4, 6, 6, 2_560): (4, 1),  # level 2 P: few rows, but K = 4
        (80, 6, 6, 198): (32, 4),  # level 2 R: few rows, four warps
        (27, 1, 1, 1_000_000): (8, 1),  # a scalar 27-point GS level
        (7, 1, 1, 1_000_000): (4, 1),  # a scalar 7-point GS level
        (2, 1, 1, 100): (2, 1),  # K below the floor of 4 lanes
        (300, 2, 2, 10): (32, 8),  # a handful of wide rows: the block
    }
    for (K, br, bcw, n), (lanes, warps) in cases.items():
        plan = p(K, br, bcw, n)
        assert (plan.lanes, plan.warps) == (lanes, warps), (K, br, bcw, n)
        assert plan.staged
        assert plan.blocks == -(-n // (bell_cuda.THREADS // (lanes * warps)))
    g = p(144, 6, 12, 2_560)  # col_chunk 2 of 6x6: the generic kernel
    assert not g.staged and g.warps == 1 and g.variant.endswith("generic")
    for bad in ({"lanes": 3}, {"lanes": 64}, {"lanes": 16, "warps": 2},
                {"lanes": 32, "warps": 3}, {"lanes": 32, "warps": 16}):
        with pytest.raises(ValueError):
            p(100, 6, 6, 1000, **bad)
    with pytest.raises(ValueError):
        p(100, 6, 12, 1000, lanes=32, warps=2)
    # the wrapper's alignment rule mirrors the kernel's LoadBytes
    assert [bell_cuda._load_bytes(n, 4) for n in (1, 2, 3, 4, 6, 9, 18, 36)] \
        == [4, 8, 4, 16, 8, 4, 8, 16]
    assert bell_cuda._load_bytes(9, 8) == 8 and bell_cuda._load_bytes(3, 2) == 2


def test_wrapper_refuses_bad_inputs_without_a_card():
    """The checks come before the library is loaded: CPU tensors that fail
    one raise ValueError or TypeError, never a build error."""
    A = _random_bsr(3, 3, seed=10)
    B = tbell.from_scipy(A, 3, 3, dtype=np.float32)
    x = torch.from_numpy(_x(A, 3, np.float32))
    f = bell_cuda.bell_matvec
    with pytest.raises(TypeError):  # a dtype without a kernel
        f(dataclasses.replace(B, data=B.data.to(torch.float16)),
          x.to(torch.float16))
    with pytest.raises(ValueError, match="data .* vs x"):
        f(B, x.double())
    nc = B.data.transpose(2, 3)
    assert not nc.is_contiguous()
    with pytest.raises(ValueError, match="data must be contiguous"):
        f(dataclasses.replace(B, data=nc), x)
    with pytest.raises(ValueError, match="x must be"):
        f(B, x[:, :2])
    with pytest.raises(ValueError, match="x must be"):
        f(B, x[: B.ncols - 1])
    with pytest.raises(ValueError, match="x must be"):
        f(B, x.t().contiguous().t())
    with pytest.raises(ValueError, match="nslots"):
        f(dataclasses.replace(B, nslots=B.nslots.long()), x)
    with pytest.raises(ValueError, match="cols"):
        f(dataclasses.replace(B, cols=B.cols.long()), x)
    with pytest.raises(ValueError, match="one CUDA device"):
        f(B, x)  # every check passes: CPU tensors are not the kernel's


def test_bell_cuda_imports_without_nvcc(tmp_path):
    """The wrapper and the format import, plan and multiply CPU tensors
    with no nvcc on PATH and no CUDA_HOME: nothing builds at import."""
    code = (
        "import numpy as np, scipy.sparse as sp, torch\n"
        "from ngsamg_tpu_torch.ops import bell_cuda, cuda_lib\n"
        "from ngsamg_tpu_torch.sparse import bell\n"
        "A = sp.random(40, 40, density=0.2, random_state=0, format='csr')\n"
        "B = bell.from_scipy(A, 1, 1)\n"
        "y = bell.spmv(B, torch.ones((B.nrows_pad, 1), dtype=torch.float32))\n"
        "assert cuda_lib._lib is None and B.launch.blocks >= 1\n"
        "print('ok', tuple(y.shape))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc on it
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().startswith("ok")
