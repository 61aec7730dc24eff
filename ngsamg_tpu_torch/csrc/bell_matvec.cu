// The block-ELL matvec for Hopper (sm_90a): y = A x for a BlockELL
// (sparse/bell.py),
//
//   y[r, i] = sum_{k < nslots[r]} sum_j data[r, k, i, j] * x[cols[r, k] * bcw + j],
//
// data (n, K, br, bcw) and cols (n, K) int32, bcw = col_chunk * bc, x the
// block vector read as rows of bcw values.
//
// It replaces no TPU kernel: the JAX package leaves this contraction to XLA
// (ngsamg_tpu/sparse/bell.py `spmv`, a gather and an einsum), and the port
// computed it in plain torch as a gather into an (n, K, bcw) temporary, a
// broadcast product into an (n, K, br, bcw) temporary the size of the
// padded matrix and a sum: three launches and about three passes over the
// padded storage a matvec. It is bound by bytes (2 operations for each
// 4-byte f32 value of the matrix, 0.43 a byte with the column indices, x
// and y), so it reads the real blocks once, skips the padding and writes y
// once, with no temporary in device memory.
//
// Each block row is owned by `lanes` consecutive threads of a warp (a
// power of two up to 32), or by `warps` whole warps of the block for a
// level with too few rows to fill the card. The threads of a row take its
// slots in turn (slot k to thread k mod (lanes * warps)) and stop at the
// row's count of real slots, `nslots[r]`: the pack puts a row's real
// blocks first, so the padding after them is never read (with no counts,
// all K slots are read; the padding is zero). A thread reads a slot's
// br * bcw values, which are contiguous, with the widest aligned loads
// their size allows (neighbouring threads read neighbouring slots), the
// slot's column once, and x's bcw values through the read-only path (x is
// a few MB, in the 50 MB L2). It sums br partial results in registers; a
// butterfly of shuffles within the row's lanes finishes them, and with
// several warps their partial sums are added in shared memory in warp
// order. One store writes each y row. No atomics: the same input gives the
// same bits. The sums are in the tensor's type (f32 for f32, f64 for f64)
// and in f32 for bf16, rounded once at the store (precision.cuh); a bf16
// product is rounded to bf16 before it is summed, as the plain version
// forms it (torch multiplies bf16 tensors into a bf16 temporary, then sums
// in f32), so the card's bf16 solves follow the CPU's.
//
// br and bcw are template parameters for the shapes the port stages,
// br, bcw in {1, 2, 3, 6} (square levels, the 3x6 / 6x3 transfers, scalar
// GS levels); any other shape (col_chunk > 1 from a carried-over hierarchy)
// takes `bell_generic_kernel`, with the shape at run time, one row
// component at a time and one warp at most a row. The wrapper
// (ops/bell_cuda.py) makes the launch plan (lanes, warps, blocks) from the
// level's shape when the operator is built; the launch refuses a plan that
// does not match the kernel's layout.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "precision.cuh"

namespace {

constexpr int kThreads = 256;  // threads of a block
constexpr int kWarp = 32;
constexpr int kMaxWarps = kThreads / kWarp;  // warps of one row at most

// Bytes of the widest aligned load of N values of T that start at a
// multiple of N * sizeof(T) from a base aligned to 16 bytes. The wrapper
// checks the base pointers against the same rule.
template <typename T, int N>
struct LoadBytes {
  static constexpr int total = N * (int)sizeof(T);
  static constexpr int value = total % 16 == 0   ? 16
                               : total % 8 == 0  ? 8
                               : total % 4 == 0  ? 4
                                                 : (int)sizeof(T);
};

template <int B>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

// v[0 .. N) = p[0 .. N) through the read-only path, in loads of
// LoadBytes<T, N> bytes.
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ p, T* v) {
  constexpr int B = LoadBytes<T, N>::value;
  using W = typename Word<B>::type;
  const W* q = reinterpret_cast<const W*>(p);
  W* w = reinterpret_cast<W*>(v);
#pragma unroll
  for (int m = 0; m < N * (int)sizeof(T) / B; ++m) w[m] = __ldg(q + m);
}

// a * b in the accumulation type; for bf16 rounded to bf16 first (the
// product of two bf16 values is exact in f32, so this is the bf16 product)
template <typename T>
__device__ __forceinline__ typename AccOf<T>::type product(T a, T b) {
  return to_acc(a) * to_acc(b);
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16>(__nv_bfloat16 a,
                                                        __nv_bfloat16 b) {
  return __bfloat162float(__float2bfloat16(to_acc(a) * to_acc(b)));
}

template <typename Acc>
__device__ __forceinline__ Acc lanes_sum(Acc v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows of a block: kThreads / (lanes * warps); row r's threads are
// [(r % rows) * lanes * warps, ...) of block r / rows. Every thread of the
// block reaches the shuffles and the barrier (rows past n_rows read no
// slot).
template <typename T, int BR, int BCW>
__global__ void __launch_bounds__(kThreads)
    bell_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const int* __restrict__ nslots, int K, long long n_rows,
                int lanes, int warps, const T* __restrict__ x,
                T* __restrict__ y) {
  using Acc = typename AccOf<T>::type;
  constexpr int S = BR * BCW;
  const int tpr = lanes * warps;
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * (kThreads / tpr) + t / tpr;
  const int rank = t % tpr;
  int ns = 0;
  if (row < n_rows) ns = nslots ? __ldg(nslots + row) : K;
  Acc acc[BR];
#pragma unroll
  for (int i = 0; i < BR; ++i) acc[i] = Acc(0);
  const long long base = row * K;
  for (int k = rank; k < ns; k += tpr) {
    const long long slot = base + k;
    const int c = __ldg(cols + slot);
    alignas(16) T a[S];
    alignas(16) T xv[BCW];
    load_run<T, S>(data + slot * S, a);
    load_run<T, BCW>(x + (long long)c * BCW, xv);
#pragma unroll
    for (int i = 0; i < BR; ++i)
#pragma unroll
      for (int j = 0; j < BCW; ++j)
        acc[i] += product(a[i * BCW + j], xv[j]);
  }
#pragma unroll
  for (int i = 0; i < BR; ++i) acc[i] = lanes_sum(acc[i], lanes);
  if (warps == 1) {
    if (row < n_rows) {
#pragma unroll
      for (int i = 0; i < BR; ++i)
        if ((i & (lanes - 1)) == rank) y[row * BR + i] = from_acc<T>(acc[i]);
    }
    return;
  }
  __shared__ Acc part[kMaxWarps][BR];
  const int w = t / kWarp;
  if (t % kWarp == 0) {
#pragma unroll
    for (int i = 0; i < BR; ++i) part[w][i] = acc[i];
  }
  __syncthreads();
  if (rank < BR && row < n_rows) {
    const int w0 = (t / tpr) * warps;
    Acc s = Acc(0);
    for (int q = 0; q < warps; ++q) s += part[w0 + q][rank];
    y[row * BR + rank] = from_acc<T>(s);
  }
}

// Any other shape: br and bcw at run time, one row component at a time
// (data read once, cols and x once a component), one warp at most a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bell_generic_kernel(const T* __restrict__ data,
                        const int* __restrict__ cols,
                        const int* __restrict__ nslots, int K, int br,
                        int bcw, long long n_rows, int lanes,
                        const T* __restrict__ x, T* __restrict__ y) {
  using Acc = typename AccOf<T>::type;
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * (kThreads / lanes) + t / lanes;
  const int rank = t % lanes;
  int ns = 0;
  if (row < n_rows) ns = nslots ? __ldg(nslots + row) : K;
  const long long base = row * K;
  for (int i = 0; i < br; ++i) {
    Acc acc = Acc(0);
    for (int k = rank; k < ns; k += lanes) {
      const long long slot = base + k;
      const T* a = data + (slot * br + i) * bcw;
      const T* xr = x + (long long)__ldg(cols + slot) * bcw;
      for (int j = 0; j < bcw; ++j)
        acc += product(__ldg(a + j), __ldg(xr + j));
    }
    acc = lanes_sum(acc, lanes);
    if (rank == 0 && row < n_rows) y[row * br + i] = from_acc<T>(acc);
  }
}

__host__ __device__ constexpr bool staged_width(int v) {
  return v == 1 || v == 2 || v == 3 || v == 6;
}

template <typename T, int BR>
bool launch_br(int bcw, unsigned blocks, cudaStream_t s, const T* data,
               const int* cols, const int* nslots, int K, long long n_rows,
               int lanes, int warps, const T* x, T* y) {
#define NGSAMG_BELL_CASE(BCW)                                              \
  case BCW:                                                                \
    bell_kernel<T, BR, BCW><<<blocks, kThreads, 0, s>>>(                   \
        data, cols, nslots, K, n_rows, lanes, warps, x, y);                \
    return true;
  switch (bcw) {
    NGSAMG_BELL_CASE(1)
    NGSAMG_BELL_CASE(2)
    NGSAMG_BELL_CASE(3)
    NGSAMG_BELL_CASE(6)
  }
#undef NGSAMG_BELL_CASE
  return false;
}

// The plan: `lanes` (a power of two up to 32) threads a row, `warps` warps
// a row (more than one only with lanes == 32 and a staged shape), and
// blocks = ceil(n_rows / (kThreads / (lanes * warps))).
template <typename T>
int launch(const T* data, const int* cols, const int* nslots, int K, int br,
           int bcw, long long n_rows, int lanes, int warps, long long blocks,
           const T* x, T* y, void* stream) {
  const bool staged = staged_width(br) && staged_width(bcw);
  const bool lanes_ok = lanes >= 1 && lanes <= kWarp && !(lanes & (lanes - 1));
  const bool warps_ok =
      warps == 1 || (staged && lanes == kWarp && warps <= kMaxWarps &&
                     warps > 1 && !(warps & (warps - 1)));
  if (K < 1 || br < 1 || bcw < 1 || n_rows < 0 || !lanes_ok || !warps_ok)
    return (int)cudaErrorInvalidValue;
  const int rows = kThreads / (lanes * warps);
  if (blocks != (n_rows + rows - 1) / rows || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
  bool done = false;
  if (staged) {
    switch (br) {
      case 1:
        done = launch_br<T, 1>(bcw, g, s, data, cols, nslots, K, n_rows,
                               lanes, warps, x, y);
        break;
      case 2:
        done = launch_br<T, 2>(bcw, g, s, data, cols, nslots, K, n_rows,
                               lanes, warps, x, y);
        break;
      case 3:
        done = launch_br<T, 3>(bcw, g, s, data, cols, nslots, K, n_rows,
                               lanes, warps, x, y);
        break;
      case 6:
        done = launch_br<T, 6>(bcw, g, s, data, cols, nslots, K, n_rows,
                               lanes, warps, x, y);
        break;
    }
  }
  if (!done)
    bell_generic_kernel<T><<<g, kThreads, 0, s>>>(data, cols, nslots, K, br,
                                                  bcw, n_rows, lanes, x, y);
  return (int)cudaGetLastError();
}

}  // namespace

#define NGSAMG_BELL_MATVEC(SFX, T)                                          \
  extern "C" int ngsamg_bell_matvec_##SFX(                                  \
      const T* data, const int* cols, const int* nslots, int K, int br,     \
      int bcw, long long n_rows, int lanes, int warps, long long blocks,    \
      const T* x, T* y, void* stream) {                                     \
    return launch<T>(data, cols, nslots, K, br, bcw, n_rows, lanes, warps,  \
                     blocks, x, y, stream);                                 \
  }
NGSAMG_BELL_MATVEC(f32, float)
NGSAMG_BELL_MATVEC(f64, double)
NGSAMG_BELL_MATVEC(bf16, __nv_bfloat16)
