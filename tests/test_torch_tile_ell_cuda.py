"""The tile-ELL matvec kernel (ops/tile_ell_cuda.py, csrc/tile_ell_matvec.cu)
off the card.

The kernel runs only on the card (chip_smoke.py ``[tile-ell-kernel]``);
here:
- the compact copy that ``stage`` makes in plain torch, walked as the
  kernel walks it (each row's lanes over its nonzeros, up to its count),
  reproduces ``TileELL.product`` on random plain and bucketed operators:
  chunk 1 and 8, several buckets, padded rows and columns, rectangular
  transfers, explicit zeros, f32 and f64, and the hierarchy of a small
  unstructured problem; each stored nonzero is read once and no padding
  slot at all, and structural zeros are dropped;
- the plan follows the operator's shape alone, and a plan the kernel does
  not take is refused;
- operators on the CPU, and the buckets of a stack, carry no copy; the
  bucket flag survives a pickle and the bf16 cast;
- the wrapper refuses bad inputs before it loads the library, the module
  imports without ``nvcc``, and ``tile_ell_kernel_matvecs`` counts a
  kernel launch, a stack once.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ngsamg_tpu_torch
from ngsamg_tpu_torch.config import options_from_flags
from ngsamg_tpu_torch.ops import cuda_lib, tile_ell_cuda
from ngsamg_tpu_torch.precond.amg import _cast_floats
from ngsamg_tpu_torch.sparse import formats
from ngsamg_tpu_torch.utils import fem as tfem
from ngsamg_tpu_torch.utils import timers

torch.set_num_threads(2)


def _walk(L, x: np.ndarray, lanes: int):
    """y from the compact copy as the kernel computes it: lane l of row r
    sums its nonzeros j = l, l + lanes, ... below counts[r], and the lanes
    are added. Returns y and the number of reads of each stored entry."""
    vals = L.vals.double().numpy()
    cols = L.cols.numpy().astype(np.int64)
    ptr = L.tile_ptr.numpy()
    cnt = L.counts.numpy().astype(np.int64)
    n = cnt.size
    rows = np.arange(n)
    reads = np.zeros(vals.size, dtype=np.int64)
    part = np.zeros((lanes, n))
    for j in range(int(cnt.max(initial=0))):
        on = cnt > j
        e = ptr[rows[on] // 8] + rows[on] % 8 + 8 * j
        np.add.at(reads, e, 1)
        part[j % lanes, on] += vals[e] * x[cols[e]]
    return part.sum(0), reads


def _random_tile_ell(T, K, C, ncols_pad, nrows, dtype, seed, bucket=False):
    """A TileELL of T tiles of K slots of C columns, distinct column
    chunks a tile, a fifth of the slots' values zero and rows past
    ``nrows`` empty."""
    g = np.random.default_rng(seed)
    cols = np.stack([np.sort(g.choice(ncols_pad // C, K, replace=False))
                     for _ in range(T)])
    data = g.standard_normal((T, K, C, 8))
    data[g.random(data.shape) < 0.2] = 0.0
    data *= (np.arange(T * 8) < nrows).reshape(T, 1, 1, 8)
    return formats.TileELL(
        data=torch.as_tensor(data if C > 1 else data[:, :, 0], dtype=dtype),
        cols=torch.as_tensor(cols, dtype=torch.int64), nrows=nrows,
        nrows_pad=T * 8, ncols_pad=ncols_pad, tile_m=8, chunk_c=C,
        bucket=bucket)


def _random_stack(dtype, seed):
    """Three buckets of 37, 20 and 9 tiles with 12, 6 and 2 slots of 8
    columns; the last bucket's last rows are padding."""
    shapes = ((37, 12), (20, 6), (9, 2))
    nrows = sum(t for t, _ in shapes) * 8 - 5
    blocks, r0 = [], 0
    for k, (T, K) in enumerate(shapes):
        rows = min(max(nrows - r0, 0), T * 8)
        blocks.append(_random_tile_ell(T, K, 8, 400, rows, dtype, seed + k,
                                       bucket=True))
        r0 += T * 8
    return formats.TileELLStack(blocks=tuple(blocks), nrows=nrows,
                                nrows_pad=r0, ncols_pad=400, tile_m=8)


def _random_csr(n, m, seed, zeros=0.1):
    """A random sparse matrix with explicit zeros among its stored
    entries."""
    A = sp.random(n, m, density=min(1.0, 12 / m), random_state=seed,
                  format="csr")
    A.data[np.random.default_rng(seed).random(A.nnz) < zeros] = 0.0
    return A


def _check(A, dtype, seed):
    """The copy reproduces the plain product under every lane split; each
    stored nonzero is read once, each padding slot never; the counts are
    the rows' nonzeros of the dense tiles."""
    L = tile_ell_cuda.stage(A)
    assert A.launch is None  # CPU operators stage nothing themselves
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (A.ncols_pad, 1)), dtype=dtype)
    want = A.product(x)[:, 0].double().numpy()
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    scale = max(np.abs(want).max(), 1e-300)
    for lanes in (1, 2, 4, 32):
        y, reads = _walk(L, x[:, 0].double().numpy(), lanes)
        assert np.abs(y - want).max() <= tol * scale
    assert reads.sum() == L.nnz == int((L.vals != 0).sum())
    stored = np.zeros(L.vals.numel(), dtype=bool)
    cnt = L.counts.numpy()
    ptr = L.tile_ptr.numpy()
    for r in range(cnt.size):
        e = ptr[r // 8] + r % 8 + 8 * np.arange(cnt[r])
        stored[e] = True
        c = L.cols.numpy()[e]
        assert np.all(np.diff(c) > 0)  # column order, no repeat
    assert np.array_equal(reads, stored.astype(np.int64))
    assert np.all(ptr[1:] - ptr[:-1] == 8 * cnt.reshape(-1, 8).max(1))
    assert cnt.size == A.nrows_pad and not cnt[A.nrows:].any()
    return L


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [1, 8])
def test_copy_reproduces_a_plain_tile_ell(dtype, chunk):
    A = _random_tile_ell(13, 7, chunk, 96, 13 * 8 - 3, dtype, 5 + chunk)
    L = _check(A, dtype, 1)
    assert L.vals.dtype == dtype and L.cols.dtype == torch.int32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_copy_of_a_stack_spans_its_buckets(dtype):
    S = _random_stack(dtype, 11)
    L = _check(S, dtype, 2)
    assert L.counts.numel() == S.nrows_pad == sum(b.nrows_pad
                                                  for b in S.blocks)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_copy_of_the_packers_rectangular_and_stacked(dtype):
    """The packers' operators: a rectangular transfer and its transpose
    with padded rows and columns (chunk 1), and a stack of several buckets
    (chunk 8), with explicit zeros in the matrix."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    P = _random_csr(301, 77, 3)
    Pt = formats.tile_ell_from_scipy(P, dtype, nr_pad=320, nc_pad=88)
    Rt = formats.tile_ell_from_scipy(P.T.tocsr(), dtype, nr_pad=88,
                                     nc_pad=320)
    for T in (Pt, Rt):
        L = _check(T, tdt, 4)
        M = (P if T is Pt else P.T).tocsr()
        M.eliminate_zeros()
        assert L.nnz == M.nnz and L.longest == np.diff(M.indptr).max()
    g = np.random.default_rng(8)
    blocks = []
    for width in (90, 30, 6):  # three runs of tiles of their own widths
        rows = 8 * 600
        cols = (np.arange(rows)[:, None]
                + g.integers(-width, width + 1, (rows, 4))) % (3 * rows)
        blocks.append(sp.csr_matrix(
            (g.standard_normal(cols.size), cols.ravel(),
             np.arange(0, cols.size + 1, 4)), shape=(rows, 3 * rows)))
    M = sp.vstack(blocks).tocsr()
    M.sum_duplicates()
    M.data[g.random(M.nnz) < 0.05] = 0.0
    S = formats.tile_ell_stack_from_scipy(M, dtype)
    assert len(S.blocks) >= 2
    L = _check(S, tdt, 6)
    M.eliminate_zeros()
    assert L.nnz == M.nnz


def test_copy_of_an_unstructured_hierarchy():
    """Every tile-ELL level, transfer and the f64 twin of a small
    unstructured hierarchy."""
    p = tfem.unstructured_poisson(10, dim=3, refine=1)
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords,
        options=options_from_flags({"sm_type": "chebyshev"}),
        device="cpu").setup()
    tile = (formats.TileELL, formats.TileELLStack)
    ops = [T for lev in pc.op.levels for T in (lev.A, lev.P, lev.R)
           if isinstance(T, tile)]
    A64 = pc._ensure_A64_mixed()
    assert isinstance(A64, formats.TileELLStack) and len(ops) >= 4
    for k, T in enumerate(ops + [A64]):
        dt = T.blocks[0].data.dtype if isinstance(T, formats.TileELLStack) \
            else T.data.dtype
        _check(T, dt, 20 + k)


def test_plan_follows_the_shape():
    """The power of two nearest the square root of a row's mean nonzeros
    in lanes: 4 for a level-0-like stack (rows of ~15), 2 for the
    transfers' rows of 4, 8 and 16 for the coarse levels' 60 and 180; the
    fewest threads a block that hold a tile; a small level more lanes, up
    to its longest row, so that it fills more of the card."""
    p = tile_ell_cuda.tile_ell_plan(176_454, 14.9, 30)
    assert (p.lanes, p.threads, p.blocks) == (4, 64, 176_454 // 2)
    assert tile_ell_cuda.tile_ell_plan(176_454, 4.2, 8).lanes == 2
    assert tile_ell_cuda.tile_ell_plan(25_872, 60.0, 110).variant == "l8-t64"
    assert tile_ell_cuda.tile_ell_plan(1_866, 182.0, 400).variant == \
        "l16-t128"
    small = tile_ell_cuda.tile_ell_plan(40, 20.0, 30)
    assert (small.lanes, small.threads, small.blocks) == (32, 256, 40)
    few = tile_ell_cuda.tile_ell_plan(100, 1.0, 2)
    assert (few.lanes, few.threads, few.blocks) == (2, 64, 25)
    assert tile_ell_cuda.tile_ell_plan(600, 4.0, 6).lanes == 8
    assert tile_ell_cuda.tile_ell_plan(0, 0.0, 0).blocks == 0


@pytest.mark.parametrize("bad", [{"lanes": 3}, {"lanes": 64},
                                 {"lanes": 0}, {"threads": 32},
                                 {"threads": 512}, {"threads": 96},
                                 {"lanes": 16, "threads": 64}])
def test_refused_plans(bad):
    with pytest.raises(ValueError):
        tile_ell_cuda.tile_ell_plan(1_000, 15.0, 30, **bad)


def test_refused_operators():
    A = _random_tile_ell(4, 3, 1, 40, 32, torch.float32, 0)
    bad = formats.TileELL(data=A.data, cols=A.cols, nrows=32, nrows_pad=40,
                          ncols_pad=40, tile_m=8)
    with pytest.raises(ValueError, match="tiles"):
        tile_ell_cuda.stage(bad)
    short = formats.TileELL(data=A.data, cols=A.cols, nrows=32, nrows_pad=32,
                            ncols_pad=16, tile_m=8)
    with pytest.raises(ValueError, match="column past"):
        tile_ell_cuda.stage(short)


def test_cpu_operators_and_buckets_carry_no_copy():
    S = _random_stack(torch.float32, 3)
    assert S.launch is None and all(b.bucket and b.launch is None
                                    for b in S.blocks)
    M = _random_csr(900, 900, 1)
    St = formats.tile_ell_stack_from_scipy(M, np.float32)
    assert all(b.bucket for b in St.blocks)
    assert not formats.tile_ell_from_scipy(M, np.float32).bucket
    back = pickle.loads(pickle.dumps(S))
    assert all(b.bucket for b in back.blocks) and back.launch is None
    cast = _cast_floats(S, torch.bfloat16, {})
    assert all(b.bucket and b.data.dtype == torch.bfloat16
               for b in cast.blocks)


def _staged(A):
    """A CPU operator with the copy attached, as a CUDA one holds it."""
    object.__setattr__(A, "launch", tile_ell_cuda.stage(A))
    return A


def test_wrapper_refuses_bad_inputs_without_a_card():
    """The checks come before the library is loaded: CPU tensors that fail
    one raise ValueError or TypeError, never a build error."""
    A = _staged(_random_tile_ell(6, 4, 1, 56, 45, torch.float32, 2))
    x = torch.zeros((56, 1), dtype=torch.float32)
    f = tile_ell_cuda.tile_ell_matvec
    with pytest.raises(ValueError, match="no compact copy"):
        f(_random_tile_ell(6, 4, 1, 56, 45, torch.float32, 2), x)
    half = _staged(_random_tile_ell(6, 4, 1, 56, 45, torch.float16, 2))
    with pytest.raises(TypeError):  # a dtype without a kernel
        f(half, x.half())
    with pytest.raises(ValueError, match="vs x"):
        f(A, x.double())
    with pytest.raises(ValueError, match="x must be"):
        f(A, x[:-8])
    with pytest.raises(ValueError, match="x must be"):
        f(A, torch.zeros((56, 2)))
    with pytest.raises(ValueError, match="x must be"):
        f(A, torch.zeros((2, 56)).t())
    with pytest.raises(ValueError, match="one CUDA device"):
        f(A, x)  # every other check passes: CPU tensors
    assert cuda_lib._lib is None


class _OnCard:
    """Stands for a CUDA tensor: the matvec dispatches on its device."""

    device = torch.device("cuda")

    def __init__(self, t):
        self.t = t


def test_kernel_matvecs_count_a_stack_once(monkeypatch):
    """A stack's matvec on the card is one launch, counted once in both
    counters, and runs no bucket's plain product; a plain TileELL the
    same; the CPU runs the plain product and counts no kernel matvec."""
    launched = []

    def fake(A, x):
        launched.append(A)
        y, _ = _walk(A.launch, x.t[:, 0].double().numpy(), 1)
        return torch.as_tensor(y)[:, None]

    monkeypatch.setattr(tile_ell_cuda, "tile_ell_matvec", fake)
    S = _staged(_random_stack(torch.float64, 7))
    P = _staged(_random_tile_ell(5, 3, 1, 48, 40, torch.float64, 9))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((400, 1)))
    want = S.product(x)
    products = []
    orig = formats.TileELL.product
    monkeypatch.setattr(formats.TileELL, "product",
                        lambda self, x: products.append(self) or orig(self, x))
    rec = timers.Recorder()
    with timers.solving(rec) as scope:
        y = S.matvec(_OnCard(x))
        P.matvec(_OnCard(x[:48]))
    assert launched == [S, P] and not products
    assert scope.tile_ell_matvecs == scope.tile_ell_kernel_matvecs == 2
    assert rec.tile_ell_kernel_matvecs == 2
    assert torch.allclose(y, want, rtol=1e-12, atol=1e-12)
    with timers.solving(rec) as scope:
        S.matvec(x)
    assert len(products) == len(S.blocks) and len(launched) == 2
    assert scope.tile_ell_matvecs == 1 and scope.tile_ell_kernel_matvecs == 0


def test_tile_ell_cuda_imports_without_nvcc(tmp_path):
    """The wrapper and the formats import, pack, stage and apply CPU
    operators with no nvcc on PATH and no CUDA_HOME: nothing builds."""
    code = (
        "import numpy as np, scipy.sparse as sp, torch\n"
        "from ngsamg_tpu_torch.ops import cuda_lib, tile_ell_cuda\n"
        "from ngsamg_tpu_torch.sparse import formats\n"
        "from ngsamg_tpu_torch import native\n"
        "native.HAVE_NATIVE = False  # no compiler on PATH either\n"
        "A = sp.random(90, 90, density=0.1, random_state=0, format='csr')\n"
        "S = formats.tile_ell_stack_from_scipy(A, np.float32)\n"
        "L = tile_ell_cuda.stage(S)\n"
        "y = S.matvec(torch.ones((S.ncols_pad, 1)))\n"
        "assert cuda_lib._lib is None and S.launch is None\n"
        "print('ok', L.plan.variant, tuple(y.shape))\n"
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
