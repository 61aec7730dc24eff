// K2 and K3: diagonal-storage (DIA) matvecs for Hopper (sm_90a).
//
// K2 `dia_matvec` replaces the Pallas TPU kernel
// ngsamg_tpu/ops/dia_pallas.py `_dia_kernel` (launched by
// `_dia_matvec_call`): full storage,
//
//   y[i] = sum_d data[d, i] * x[i + off_d],   x zero outside [0, n_pad).
//
// K3 `dia_sym_matvec` replaces `_dia_sym_kernel` (launched by
// `_dia_sym_matvec_call`) in the same file: symmetric half storage, only
// offsets o >= 0 stored,
//
//   y[g] = sum_o data_o[g] * x[g + o] + sum_{o > 0, g >= o} data_o[g - o] * x[g - o].
//
// K2 runs on the small coarse levels (a few thousand to a few ten thousand
// rows, 81-251 diagonals), whose data, a few MB, sits in L2: it is bound by
// latency, not bytes. One thread per row (its first design) filled 11
// blocks at 2,744 rows and ran a serial chain of 251 offset, data and x
// loads per thread. So the diagonals are split across threads instead
// (`dia_tiled_kernel`): a block takes a tile of 32 rows (one row per lane)
// and `groups` warps; warp g sums a contiguous run of `per_group`
// diagonals for the tile, each read of data[d, r0 .. r0+31] one coalesced
// 128-byte line. The block stages the offsets in shared memory, and, on
// the "smem" path, x's window [r0 + lo, r0 + 32 + hi) for the tile, zero
// outside [0, n_pad); where that window would not fit the shared-memory
// budget (the "ldg" path), x is read through the read-only cache with a
// bounds check. The warps' partial sums are reduced in shared memory in
// group order. The wrapper (ops/dia_cuda.py) computes this launch plan
// (groups, per_group, window, lo, path) when the level is staged; the
// launch derives the shared-memory size from it and the kernel's own
// layout. The offsets and partial sums always sit in shared memory, so
// K2 takes at most about 5,600 diagonals: the plan refuses a level with
// more when it is staged. The sum order differs from the plain version's
// (diagonal by diagonal): within a group in diagonal order, then across
// groups.
//
// K3 is bound by bytes: it streams its (ndiag, n_pad) half-storage data
// once from device memory (86 MB at 1,259,712 rows x 17 diagonals; the
// 21 MB of 157,464 x 34 stay in the L2 between launches) and re-reads each
// entry once, o rows back, for the minus-direction term, out of L2. One
// thread per row with a rolled loop over a runtime diagonal count (its
// first design) loaded and summed diagonal by diagonal behind
// data-dependent tests: a thread stalls at the first use of a load in
// flight, so it kept one diagonal's loads in flight, a long chain for the
// single wave of blocks on the small level. `dia_sym_tiled_kernel` gives a
// block a tile of `tpg * 2` rows instead: a thread owns two consecutive
// rows (n_pad is even: a level with an odd padding is refused at staging),
// reads the aligned plus-direction data of a diagonal as one vector load,
// starts the loads of U diagonals together, none behind a branch, and
// keeps two independent sums; the shifted reads (x[g + o], x[g - o],
// data[d, g - o]) go through the read-only cache (data loads that bypass
// L1 ran slower: 46.0 against 42.3 us and 14.4 against 9.2, the short
// offsets' re-reads hit there). The offsets sit in shared memory. A tile
// whose rows all lie at least the largest offset inside [0, n_pad) skips
// every bounds test (a block-uniform branch). Where the level has too few
// rows to fill the card, the diagonals are split over `groups` thread
// groups of the block (group g sums diagonals [g * per_group, (g + 1) *
// per_group)) and the partial sums are reduced in shared memory in group
// order, as K2 does. No atomics: the same input gives the same bits. With
// one group the terms are summed in the plain version's order (diagonal by
// diagonal, + term before - term). The wrapper makes the whole plan (U,
// tpg, groups, per_group, tile, shared-memory size, blocks) from the
// level's shape at staging: U is 2 with one group (a level that streams
// from device memory) and 4 with several (a level that stays in the L2);
// these two are the batches the library is built for.
// The launch refuses a plan that does not match the kernel's own layout.
// The offsets and the partial sums must fit 48 KB, about 6,000 diagonals:
// a level with more is refused at staging. On the large level the kernel
// sits 7.8 us above a flat read of the same bytes (41.3 against 33.5 us in
// one call, NVIDIA H100 80GB HBM3, 700 W). Timed with the minus-direction
// re-read, the shifted x reads or both compiled out it ran 39.5, 40.5 and
// 38.9 us: the L2-to-SM traffic of those reads explains 2.4 us, and what
// holds the rest is not known.
// The TPU kernels' K-tile data halo only staged data in VMEM and is not
// carried over.
//
// Both kernels are built for f32, f64 and bf16 (the TPU kernels follow the
// data's dtype, bf16 included). The bf16 builds load bfloat16 data and x,
// sum in f32 and round once at the store (precision.cuh); their partial
// sums in shared memory are f32, so the plans size them by the
// accumulation type and x's window by the storage type.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "precision.cuh"

namespace {

constexpr int kTileRows = 32;  // rows of a K2 tile: one per lane
constexpr int kSmemBudget = 48 * 1024;  // a block's shared memory, no opt-in
constexpr int kSymRows = 2;  // consecutive rows of a K3 thread

// Shared memory: offsets (ndiag int64), the groups' partial sums
// (groups x 32, accumulation type), then x's window (window values; 0 on
// the ldg path).
//
// The kernel runs on a window: a block of n_rows rows (n_pad here) whose x
// may be a longer vector: y[i] = sum_d data[d, i] * x[x_base + i + off_d],
// x zero outside [0, x_len). A whole level is the window n_rows = x_len =
// n_pad, x_base = 0. A rank of the sharded solve (parallel/shard.py) holds
// its rows [r0, r0 + n_rows) of a row-sharded level and the gathered x; it
// passes x_base = r0.
template <typename T>
__global__ void dia_tiled_kernel(const T* __restrict__ data,
                                 const long long* __restrict__ offs,
                                 int ndiag, long long n_pad, int per_group,
                                 int window, long long lo, long long x_len,
                                 long long x_base,
                                 const T* __restrict__ x,
                                 T* __restrict__ y) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_offs = reinterpret_cast<long long*>(smem);
  Acc* s_part = reinterpret_cast<Acc*>(s_offs + ndiag);
  const int groups = blockDim.x / kTileRows;
  T* s_x = reinterpret_cast<T*>(s_part + groups * kTileRows);
  const int lane = threadIdx.x % kTileRows, g = threadIdx.x / kTileRows;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) s_offs[d] = offs[d];
  const long long w0 = x_base + r0 + lo;
#pragma unroll 4
  for (int k = threadIdx.x; k < window; k += blockDim.x) {
    const long long j = w0 + k;
    s_x[k] = (j >= 0 && j < x_len) ? x[j] : from_acc<T>(Acc(0));
  }
  __syncthreads();
  const long long row = r0 + lane;
  const int d0 = g * per_group, d1 = min(d0 + per_group, ndiag);
  Acc acc = Acc(0);
  if (row < n_pad) {
    const T* dp = data + row;
    if (window > 0) {
      const T* xw = s_x + (lane - lo);  // x[row + off] = xw[off]
#pragma unroll 4
      for (int d = d0; d < d1; ++d)
        acc += to_acc(dp[(long long)d * n_pad]) * to_acc(xw[s_offs[d]]);
    } else {
#pragma unroll 4
      for (int d = d0; d < d1; ++d) {
        const long long j = x_base + row + s_offs[d];
        if (j >= 0 && j < x_len)
          acc += to_acc(dp[(long long)d * n_pad]) * to_acc(__ldg(x + j));
      }
    }
  }
  s_part[g * kTileRows + lane] = acc;
  __syncthreads();
  if (g == 0 && row < n_pad) {
    Acc sum = s_part[lane];
    for (int k = 1; k < groups; ++k) sum += s_part[k * kTileRows + lane];
    y[row] = from_acc<T>(sum);
  }
}

// R values that load and store as one vector access (two for 32 bytes).
template <typename T, int R>
struct alignas(sizeof(T) * R <= 16 ? sizeof(T) * R : 16) Pack {
  T v[R];
};

// U diagonals from d on for one thread's R rows from g0 on. All 4 * U * R
// loads are started before the first sum uses one: a thread stalls at the
// first use of a load in flight, so a loop that loads and sums diagonal by
// diagonal keeps one diagonal's few loads in flight per thread, and the
// card's memory latency then caps the rate far below its bandwidth. No
// load sits behind a branch: CHECK clamps an index outside [0, n_pad) to
// the thread's own row and zeroes that term's data; a tile far enough
// inside skips the tests. The minus term of offset 0 is zeroed likewise.
template <typename T, int R, int U, bool CHECK>
__device__ __forceinline__ void sym_terms(
    const T* __restrict__ data, const T* __restrict__ x,
    const long long* __restrict__ s_offs, int d, long long n_pad,
    long long g0, typename AccOf<T>::type (&acc)[R]) {
  using Acc = typename AccOf<T>::type;
  Acc ap[U][R], xp[U][R], am[U][R], xm[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long o = s_offs[d + u];
    const T* row = data + (long long)(d + u) * n_pad;
    const Pack<T, R> a = *reinterpret_cast<const Pack<T, R>*>(row + g0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long own = g0 + i, jp = own + o, jm = own - o;
      const bool okp = !CHECK || jp < n_pad;
      const bool okm = o > 0 && (!CHECK || jm >= 0);
      const long long cm = (CHECK && jm < 0) ? own : jm;
      xp[u][i] = to_acc(__ldg(x + (okp ? jp : own)));
      xm[u][i] = to_acc(__ldg(x + cm));
      const Acc m = to_acc(__ldg(row + cm));
      ap[u][i] = okp ? to_acc(a.v[i]) : Acc(0);
      am[u][i] = okm ? m : Acc(0);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i] += ap[u][i] * xp[u][i];
      acc[i] += am[u][i] * xm[u][i];
    }
  }
}

// Diagonals [d0, d1) in batches of U, the rest one by one.
template <typename T, int R, int U, bool CHECK>
__device__ __forceinline__ void sym_accumulate(
    const T* __restrict__ data, const T* __restrict__ x,
    const long long* __restrict__ s_offs, int d0, int d1, long long n_pad,
    long long g0, typename AccOf<T>::type (&acc)[R]) {
  int d = d0;
  for (; d + U <= d1; d += U)
    sym_terms<T, R, U, CHECK>(data, x, s_offs, d, n_pad, g0, acc);
  for (; d < d1; ++d)
    sym_terms<T, R, 1, CHECK>(data, x, s_offs, d, n_pad, g0, acc);
}

// Shared memory: with more than one group the groups' partial sums
// (groups x tile in the accumulation type, a multiple of 16 bytes), then
// the offsets (ndiag int64).
template <typename T, int R, int U>
__global__ void dia_sym_tiled_kernel(const T* __restrict__ data,
                                     const long long* __restrict__ offs,
                                     int ndiag, long long n_pad, int tpg,
                                     int per_group, long long reach,
                                     const T* __restrict__ x,
                                     T* __restrict__ y) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / tpg;
  const int t = threadIdx.x % tpg, g = threadIdx.x / tpg;
  const long long tile = (long long)tpg * R;
  Acc* s_part = reinterpret_cast<Acc*>(smem);
  long long* s_offs =
      reinterpret_cast<long long*>(s_part + (groups > 1 ? groups * tile : 0));
  const long long r0 = (long long)blockIdx.x * tile;
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) s_offs[d] = offs[d];
  __syncthreads();
  const long long g0 = r0 + (long long)t * R;
  const bool live = g0 < n_pad;  // n_pad is a multiple of R
  const int d0 = g * per_group, d1 = min(d0 + per_group, ndiag);
  Acc acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = Acc(0);
  if (live) {
    if (r0 >= reach && r0 + tile + reach <= n_pad)
      sym_accumulate<T, R, U, false>(data, x, s_offs, d0, d1, n_pad, g0, acc);
    else
      sym_accumulate<T, R, U, true>(data, x, s_offs, d0, d1, n_pad, g0, acc);
  }
  if (groups > 1) {
    Pack<Acc, R> p;
#pragma unroll
    for (int i = 0; i < R; ++i) p.v[i] = acc[i];
    *reinterpret_cast<Pack<Acc, R>*>(s_part + (long long)g * tile + t * R) = p;
    __syncthreads();
    if (g != 0) return;
    for (int k = 1; k < groups; ++k) {
      p = *reinterpret_cast<const Pack<Acc, R>*>(s_part + (long long)k * tile +
                                                 t * R);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += p.v[i];
    }
  }
  if (live) {
    Pack<T, R> out;
#pragma unroll
    for (int i = 0; i < R; ++i) out.v[i] = from_acc<T>(acc[i]);
    *reinterpret_cast<Pack<T, R>*>(y + g0) = out;
  }
}

// K3's plan (diagonals per batch, threads per group tpg, groups, per_group,
// tile, shared-memory size, blocks) comes from the wrapper; `reach` is the
// largest offset. A plan that does not match the kernel's layout is refused.
template <typename T, int U>
int launch_sym_u(const T* data, const long long* offs, int ndiag,
                 long long n_pad, int tpg, int groups, int per_group,
                 long long reach, int smem_bytes, long long blocks,
                 const T* x, T* y, void* stream) {
  dia_sym_tiled_kernel<T, kSymRows, U>
      <<<(unsigned)blocks, tpg * groups, (size_t)smem_bytes,
         (cudaStream_t)stream>>>(data, offs, ndiag, n_pad, tpg, per_group,
                                 reach, x, y);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym(const T* data, const long long* offs, int ndiag,
               long long n_pad, int batch, int tpg, int groups,
               int per_group, int tile, long long reach, int smem_bytes,
               long long blocks, const T* x, T* y, void* stream) {
  if (n_pad <= 0) return 0;
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(y);
  if (tpg < 32 || tpg % 32 || groups < 1 || tpg * groups > 1024 ||
      (long long)groups * per_group < ndiag || reach < 0 ||
      n_pad % kSymRows || ptrs % (sizeof(T) * kSymRows) ||
      tile != tpg * kSymRows || (batch != 2 && batch != 4))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      (long long)ndiag * sizeof(long long) +
      (groups > 1
           ? (long long)groups * tile * sizeof(typename AccOf<T>::type)
           : 0);
  if (smem != smem_bytes || smem > kSmemBudget ||
      blocks != (n_pad + tile - 1) / tile || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return batch == 4
             ? launch_sym_u<T, 4>(data, offs, ndiag, n_pad, tpg, groups,
                                  per_group, reach, smem_bytes, blocks, x, y,
                                  stream)
             : launch_sym_u<T, 2>(data, offs, ndiag, n_pad, tpg, groups,
                                  per_group, reach, smem_bytes, blocks, x, y,
                                  stream);
}

// The plan (groups, per_group, window, lo) comes from the wrapper; the
// shared-memory size follows from it and the kernel's layout.
template <typename T>
int launch_tiled(const T* data, const long long* offs, int ndiag,
                 long long n_pad, int groups, int per_group, int window,
                 long long lo, long long x_len, long long x_base,
                 const T* x, T* y, void* stream) {
  if (n_pad <= 0) return 0;
  if (x_len < 0 || x_base < 0) return (int)cudaErrorInvalidValue;
  const long long smem =
      (long long)ndiag * sizeof(long long) +
      (long long)groups * kTileRows * sizeof(typename AccOf<T>::type) +
      (long long)window * sizeof(T);
  if (groups < 1 || groups > 32 || window < 0 || smem > kSmemBudget ||
      (long long)groups * per_group < ndiag)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pad + kTileRows - 1) / kTileRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dia_tiled_kernel<T><<<(unsigned)blocks, groups * kTileRows, (size_t)smem,
                        (cudaStream_t)stream>>>(data, offs, ndiag, n_pad,
                                                per_group, window, lo, x_len,
                                                x_base, x, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngsamg_dia_sym_matvec_f32(const float* data,
                                         const long long* offs, int ndiag,
                                         long long n_pad, int batch, int tpg,
                                         int groups, int per_group, int tile,
                                         long long reach, int smem_bytes,
                                         long long blocks, const float* x,
                                         float* y, void* stream) {
  return launch_sym<float>(data, offs, ndiag, n_pad, batch, tpg, groups,
                           per_group, tile, reach, smem_bytes, blocks, x, y,
                           stream);
}

extern "C" int ngsamg_dia_sym_matvec_f64(const double* data,
                                         const long long* offs, int ndiag,
                                         long long n_pad, int batch, int tpg,
                                         int groups, int per_group, int tile,
                                         long long reach, int smem_bytes,
                                         long long blocks, const double* x,
                                         double* y, void* stream) {
  return launch_sym<double>(data, offs, ndiag, n_pad, batch, tpg, groups,
                            per_group, tile, reach, smem_bytes, blocks, x, y,
                            stream);
}

extern "C" int ngsamg_dia_sym_matvec_bf16(const __nv_bfloat16* data,
                                          const long long* offs, int ndiag,
                                          long long n_pad, int batch, int tpg,
                                          int groups, int per_group, int tile,
                                          long long reach, int smem_bytes,
                                          long long blocks,
                                          const __nv_bfloat16* x,
                                          __nv_bfloat16* y, void* stream) {
  return launch_sym<__nv_bfloat16>(data, offs, ndiag, n_pad, batch, tpg,
                                   groups, per_group, tile, reach, smem_bytes,
                                   blocks, x, y, stream);
}

// K2 (see dia_tiled_kernel): n_rows rows of data (row stride n_rows), x of
// x_len values read from x_base on. A whole level is the window
// (n_pad, n_pad, 0); a rank's row block of a sharded level is
// (n_rows, x_len, r0).
#define NGSAMG_DIA_MATVEC(SFX, T)                                            \
  extern "C" int ngsamg_dia_matvec_##SFX(                                    \
      const T* data, const long long* offs, int ndiag, long long n_rows,     \
      long long x_len, long long x_base, int groups, int per_group,          \
      int window, long long lo, const T* x, T* y, void* stream) {            \
    return launch_tiled<T>(data, offs, ndiag, n_rows, groups, per_group,     \
                           window, lo, x_len, x_base, x, y, stream);         \
  }
NGSAMG_DIA_MATVEC(f32, float)
NGSAMG_DIA_MATVEC(f64, double)
NGSAMG_DIA_MATVEC(bf16, __nv_bfloat16)
