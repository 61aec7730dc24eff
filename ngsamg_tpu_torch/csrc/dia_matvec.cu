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
// Bound: device-memory bandwidth. Both stream the (ndiag, n_pad) data
// array once, coalesced (thread g reads data[d, g], neighbouring threads
// neighbouring addresses), and read x and write y once from DRAM; the
// ndiag shifted reads of x per row are served by L1/L2, since a block's
// window of x for one diagonal overlaps its window for the next. K3's
// minus-direction term re-reads data[d, g - o]: it is the same array,
// o rows back, so for the offsets of a coarse lattice (a few hundred to a
// few ten thousand rows) it is an L2 hit, and the half storage halves the
// DRAM bytes of the operator. The TPU kernel's K-tile data halo only
// staged that data in VMEM and is not carried over. On the small coarse
// levels (a few thousand rows, hundreds of diagonals) one thread per row
// fills only a few blocks and the call is bound by latency instead;
// splitting the diagonals across threads is the known next step there.
//
// Design: one thread per row in a grid-stride loop, 64-bit indices; the
// offsets live in a device int64 array, so there is no diagonal cap (a
// 251-diagonal coarse level runs here too). Terms are summed in the order
// of the plain PyTorch version (diagonal by diagonal, + term before - term).
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void dia_matvec_kernel(const T* __restrict__ data,
                                  const long long* __restrict__ offs,
                                  int ndiag, long long n_pad,
                                  const T* __restrict__ x, T* __restrict__ y) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < n_pad; g += step) {
    T acc = T(0);
    for (int d = 0; d < ndiag; ++d) {
      const long long j = g + offs[d];
      if (j >= 0 && j < n_pad) acc += data[(long long)d * n_pad + g] * x[j];
    }
    y[g] = acc;
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
int launch(bool sym_half, const T* data, const long long* offs, int ndiag,
           long long n_pad, const T* x, T* y, void* stream) {
  if (n_pad <= 0) return 0;
  const int threads = 256;
  if (sym_half) {
    dia_sym_matvec_kernel<T><<<grid_for(n_pad, threads), threads, 0,
                               (cudaStream_t)stream>>>(data, offs, ndiag,
                                                       n_pad, x, y);
  } else {
    dia_matvec_kernel<T><<<grid_for(n_pad, threads), threads, 0,
                           (cudaStream_t)stream>>>(data, offs, ndiag, n_pad,
                                                   x, y);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngsamg_dia_matvec_f32(const float* data, const long long* offs,
                                     int ndiag, long long n_pad,
                                     const float* x, float* y, void* stream) {
  return launch<float>(false, data, offs, ndiag, n_pad, x, y, stream);
}

extern "C" int ngsamg_dia_matvec_f64(const double* data,
                                     const long long* offs, int ndiag,
                                     long long n_pad, const double* x,
                                     double* y, void* stream) {
  return launch<double>(false, data, offs, ndiag, n_pad, x, y, stream);
}

extern "C" int ngsamg_dia_sym_matvec_f32(const float* data,
                                         const long long* offs, int ndiag,
                                         long long n_pad, const float* x,
                                         float* y, void* stream) {
  return launch<float>(true, data, offs, ndiag, n_pad, x, y, stream);
}

extern "C" int ngsamg_dia_sym_matvec_f64(const double* data,
                                         const long long* offs, int ndiag,
                                         long long n_pad, const double* x,
                                         double* y, void* stream) {
  return launch<double>(true, data, offs, ndiag, n_pad, x, y, stream);
}
