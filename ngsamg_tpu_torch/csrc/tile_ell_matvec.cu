// The tile-ELL matvec for Hopper (sm_90a): y = A x for every tile-ELL
// operator (sparse/formats.py `TileELL` and `TileELLStack`), read from the
// compact copy of its nonzeros that ops/tile_ell_cuda.py `stage` makes once,
// when the operator is built:
//
//   y[r] = sum_{j < counts[r]} vals[e(r, j)] * x[cols[e(r, j)]],
//   e(r, j) = tile_ptr[r / 8] + 8 j + r % 8.
//
// Rows are taken in tiles of 8 (the format's TILE_M). A tile stores its
// rows' nonzeros slot-major: the j-th nonzero of each of its 8 rows lie
// side by side, padded to the tile's longest row; `counts[r]` is row r's
// number of nonzeros, so the padding is never read. cols are 32-bit scalar
// column indices, vals in the operator's type. A stack's buckets are one
// copy in row order, so a stack is one launch.
//
// It replaces no TPU kernel: the JAX package leaves this matvec to XLA
// (ngsamg_tpu/sparse/formats.py `_tile_ell_matvec`, a gather of x chunks and
// an einsum over dense 8-row tiles), and the port computed it in plain
// torch the same way, two launches a bucket and a `cat`. Those dense tiles
// of the TPU's matrix unit are 5.6% full on an unstructured level, 8.9
// times the bytes of its CSR. The matvec is bound by bytes: 2 operations
// for each value and its 4-byte column (8 bytes in f32), x (a few MB) read
// from the 50 MB L2. So each stored value and column is read once, no
// padding, and y written once, with no temporary in device memory.
//
// Each row is owned by `lanes` threads (a power of two up to 32): lane l of
// row r takes its nonzeros j = l, l + lanes, ... A tile's 8 * lanes threads
// are numbered lane-major (thread u of the tile holds row u % 8, lane
// u / 8), so at each step they read 8 * lanes adjacent values and columns:
// every sector a warp loads is whole, except where a row of the tile has
// ended. Four nonzeros are loaded ahead of their products. x is read
// through the read-only path. A row's lanes are summed by shuffles within a
// warp (xor 8, 16) and, for more than 4 lanes, across the tile's warps in
// shared memory in warp order. No atomics: the same input gives the same
// bits. Sums are in the tensor's type (f32 for f32, f64 for f64) and in
// f32 for bf16 (precision.cuh), rounded once at the store, as the plain
// version's batched product sums. All `n_tiles * 8` rows are written;
// rows with no nonzero get 0.
//
// The wrapper makes the launch plan (lanes a row, threads a block) from
// the operator's shape when the copy is staged; the launch refuses a plan
// that does not match the kernel's layout.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "precision.cuh"

namespace {

constexpr int kTile = 8;  // rows of a tile
constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;  // threads of a block at most
constexpr int kAhead = 4;  // nonzeros a thread loads ahead

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tile_ell_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                    const long long* __restrict__ tile_ptr,
                    const int* __restrict__ counts, long long n_tiles,
                    int lanes, const T* __restrict__ x, T* __restrict__ y) {
  using Acc = typename AccOf<T>::type;
  const int group = kTile * lanes;  // threads of a tile
  const int t = threadIdx.x;
  const long long tile =
      (long long)blockIdx.x * (blockDim.x / group) + t / group;
  const int u = t % group;
  const int m = u % kTile;  // the row in its tile
  const int l = u / kTile;  // the lane in its row
  Acc acc = Acc(0);
  if (tile < n_tiles) {
    const int n = __ldg(counts + tile * kTile + m);
    const long long base = __ldg(tile_ptr + tile) + m;
    const T* v = vals + base;
    const int* c = cols + base;
    const int step = kTile * lanes;
    int j = l;
    for (; j + (kAhead - 1) * lanes < n; j += kAhead * lanes) {
      T a[kAhead];
      int k[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const long long e = (long long)j * kTile + (long long)q * step;
        a[q] = __ldg(v + e);
        k[q] = __ldg(c + e);
      }
      T xv[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) xv[q] = __ldg(x + k[q]);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) acc += to_acc(a[q]) * to_acc(xv[q]);
    }
    for (; j < n; j += lanes) {
      const long long e = (long long)j * kTile;
      acc += to_acc(__ldg(v + e)) * to_acc(__ldg(x + __ldg(c + e)));
    }
  }
  // the lanes of a row within a warp; every thread of the block gets here
  for (int off = kTile; off < group && off < kWarp; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (group <= kWarp) {
    if (l == 0 && tile < n_tiles) y[tile * kTile + m] = from_acc<T>(acc);
    return;
  }
  __shared__ Acc part[kMaxThreads / kWarp][kTile];
  if (t % kWarp < kTile) part[t / kWarp][m] = acc;
  __syncthreads();
  if (l == 0 && tile < n_tiles) {
    const int warps = group / kWarp;
    const int w0 = (t / group) * warps;
    Acc s = Acc(0);
    for (int q = 0; q < warps; ++q) s += part[w0 + q][m];
    y[tile * kTile + m] = from_acc<T>(s);
  }
}

// The plan: `lanes` (a power of two up to 32) threads a row, `threads` (64,
// 128 or 256, at least a tile's 8 * lanes) threads a block, and
// blocks = ceil(n_tiles / (threads / (8 * lanes))).
template <typename T>
int launch(const T* vals, const int* cols, const long long* tile_ptr,
           const int* counts, long long n_tiles, int lanes, int threads,
           long long blocks, const T* x, T* y, void* stream) {
  const bool lanes_ok = lanes >= 1 && lanes <= kWarp && !(lanes & (lanes - 1));
  const bool threads_ok = (threads == 64 || threads == 128 || threads == 256) &&
                          lanes_ok && threads >= kTile * lanes;
  if (n_tiles < 0 || !lanes_ok || !threads_ok)
    return (int)cudaErrorInvalidValue;
  const long long per_block = threads / (kTile * lanes);
  if (blocks != (n_tiles + per_block - 1) / per_block || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  tile_ell_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      vals, cols, tile_ptr, counts, n_tiles, lanes, x, y);
  return (int)cudaGetLastError();
}

}  // namespace

#define NGSAMG_TILE_ELL_MATVEC(SFX, T)                                       \
  extern "C" int ngsamg_tile_ell_matvec_##SFX(                               \
      const T* vals, const int* cols, const long long* tile_ptr,             \
      const int* counts, long long n_tiles, int lanes, int threads,          \
      long long blocks, const T* x, T* y, void* stream) {                    \
    return launch<T>(vals, cols, tile_ptr, counts, n_tiles, lanes, threads,  \
                     blocks, x, y, stream);                                  \
  }
NGSAMG_TILE_ELL_MATVEC(f32, float)
NGSAMG_TILE_ELL_MATVEC(f64, double)
NGSAMG_TILE_ELL_MATVEC(bf16, __nv_bfloat16)
