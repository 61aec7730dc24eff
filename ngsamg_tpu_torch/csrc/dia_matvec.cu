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
// K3 streams its (ndiag, n_pad) half-storage data once, coalesced (thread
// g reads data[d, g]), one thread per row in a grid-stride loop; the
// ndiag shifted reads of x per row are served by L1/L2, and the
// minus-direction term re-reads data[d, g - o], o rows back, from L2. Its
// terms are summed in the plain version's order (diagonal by diagonal,
// + term before - term). The TPU kernels' K-tile data halo only staged
// data in VMEM and is not carried over. Offsets live in a device int64
// array, so K3 has no diagonal cap.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 32;  // rows of a K2 tile: one per lane
constexpr int kSmemBudget = 48 * 1024;  // a block's shared memory, no opt-in

// Shared memory: offsets (ndiag int64), the groups' partial sums
// (groups x 32), then x's window (window values; 0 on the ldg path).
template <typename T>
__global__ void dia_tiled_kernel(const T* __restrict__ data,
                                 const long long* __restrict__ offs,
                                 int ndiag, long long n_pad, int per_group,
                                 int window, long long lo,
                                 const T* __restrict__ x,
                                 T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_offs = reinterpret_cast<long long*>(smem);
  T* s_part = reinterpret_cast<T*>(s_offs + ndiag);
  const int groups = blockDim.x / kTileRows;
  T* s_x = s_part + groups * kTileRows;
  const int lane = threadIdx.x % kTileRows, g = threadIdx.x / kTileRows;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) s_offs[d] = offs[d];
  const long long w0 = r0 + lo;
#pragma unroll 4
  for (int k = threadIdx.x; k < window; k += blockDim.x) {
    const long long j = w0 + k;
    s_x[k] = (j >= 0 && j < n_pad) ? x[j] : T(0);
  }
  __syncthreads();
  const long long row = r0 + lane;
  const int d0 = g * per_group, d1 = min(d0 + per_group, ndiag);
  T acc = T(0);
  if (row < n_pad) {
    const T* dp = data + row;
    if (window > 0) {
      const T* xw = s_x + (lane - lo);  // x[row + off] = xw[off]
#pragma unroll 4
      for (int d = d0; d < d1; ++d)
        acc += dp[(long long)d * n_pad] * xw[s_offs[d]];
    } else {
#pragma unroll 4
      for (int d = d0; d < d1; ++d) {
        const long long j = row + s_offs[d];
        if (j >= 0 && j < n_pad) acc += dp[(long long)d * n_pad] * __ldg(x + j);
      }
    }
  }
  s_part[g * kTileRows + lane] = acc;
  __syncthreads();
  if (g == 0 && row < n_pad) {
    T sum = s_part[lane];
    for (int k = 1; k < groups; ++k) sum += s_part[k * kTileRows + lane];
    y[row] = sum;
  }
}

template <typename T>
__global__ void dia_sym_matvec_kernel(const T* __restrict__ data,
                                      const long long* __restrict__ offs,
                                      int ndiag, long long n_pad,
                                      const T* __restrict__ x,
                                      T* __restrict__ y) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < n_pad; g += step) {
    T acc = T(0);
    for (int d = 0; d < ndiag; ++d) {
      const long long o = offs[d];
      const T* row = data + (long long)d * n_pad;
      if (g + o < n_pad) acc += row[g] * x[g + o];
      if (o > 0 && g >= o) acc += row[g - o] * x[g - o];
    }
    y[g] = acc;
  }
}

inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  return (unsigned)blocks;
}

template <typename T>
int launch_sym(const T* data, const long long* offs, int ndiag,
               long long n_pad, const T* x, T* y, void* stream) {
  if (n_pad <= 0) return 0;
  const int threads = 256;
  dia_sym_matvec_kernel<T><<<grid_for(n_pad, threads), threads, 0,
                             (cudaStream_t)stream>>>(data, offs, ndiag, n_pad,
                                                     x, y);
  return (int)cudaGetLastError();
}

// The plan (groups, per_group, window, lo) comes from the wrapper; the
// shared-memory size follows from it and the kernel's layout.
template <typename T>
int launch_tiled(const T* data, const long long* offs, int ndiag,
                 long long n_pad, int groups, int per_group, int window,
                 long long lo, const T* x, T* y, void* stream) {
  if (n_pad <= 0) return 0;
  const long long smem = (long long)ndiag * sizeof(long long) +
                         ((long long)groups * kTileRows + window) * sizeof(T);
  if (groups < 1 || groups > 32 || window < 0 || smem > kSmemBudget ||
      (long long)groups * per_group < ndiag)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pad + kTileRows - 1) / kTileRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dia_tiled_kernel<T><<<(unsigned)blocks, groups * kTileRows, (size_t)smem,
                        (cudaStream_t)stream>>>(data, offs, ndiag, n_pad,
                                                per_group, window, lo, x, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngsamg_dia_matvec_f32(const float* data, const long long* offs,
                                     int ndiag, long long n_pad, int groups,
                                     int per_group, int window, long long lo,
                                     const float* x, float* y, void* stream) {
  return launch_tiled<float>(data, offs, ndiag, n_pad, groups, per_group,
                             window, lo, x, y, stream);
}

extern "C" int ngsamg_dia_matvec_f64(const double* data,
                                     const long long* offs, int ndiag,
                                     long long n_pad, int groups,
                                     int per_group, int window, long long lo,
                                     const double* x, double* y,
                                     void* stream) {
  return launch_tiled<double>(data, offs, ndiag, n_pad, groups, per_group,
                              window, lo, x, y, stream);
}

extern "C" int ngsamg_dia_sym_matvec_f32(const float* data,
                                         const long long* offs, int ndiag,
                                         long long n_pad, const float* x,
                                         float* y, void* stream) {
  return launch_sym<float>(data, offs, ndiag, n_pad, x, y, stream);
}

extern "C" int ngsamg_dia_sym_matvec_f64(const double* data,
                                         const long long* offs, int ndiag,
                                         long long n_pad, const double* x,
                                         double* y, void* stream) {
  return launch_sym<double>(data, offs, ndiag, n_pad, x, y, stream);
}
