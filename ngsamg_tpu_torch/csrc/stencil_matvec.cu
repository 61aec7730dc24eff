// K1: uniform clipped n-d stencil matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngsamg_tpu/ops/stencil_pallas.py
// `_stencil_kernel` (launched by `_stencil_matvec_call`), the finest-level
// matvec of a constant-coefficient lattice problem:
//
//   y[g] = sum_t vals[t] * x[g + off_lin_t] * [g + off_t inside dims]
//   y[g] = 0 for g in [nrows, nrows_pad)
//
// Bound: memory traffic. Per row the kernel reads x once from DRAM and
// writes y once; the m values and offsets are a few hundred bytes that
// stay in cache. So the DRAM traffic is ~2 vectors per call, against the
// ~m/2-plus padded copies of the plain PyTorch version. The m neighbour
// reads of a row come from the caches: along the last axis they share a
// cache line, along the leading axes they sit whole lattice rows or
// planes back. At a 215^3 lattice the planes are 185 KB apart, so those
// reads are served by L2, not L1, and L2 rather than DRAM limits this
// simple form. Tiling x in shared memory is the known next step. The TPU
// kernel's three-tile x window and lane roll existed only to stage x in
// VMEM and are not carried over.
//
// Design: one thread per output row in a grid-stride loop, 64-bit row
// indices; lattice coordinates decoded from the flat row index (in 32-bit
// divisions while every index fits, in 64-bit ones beyond, so a larger
// lattice cannot overflow); each term masked by the per-axis bounds check
// instead of relying on a zero-filled x tail. Offsets are read from a
// small device array: there is no cap on their number. The lattice
// dimension d <= 4 is a template parameter, and rows away from the
// lattice faces skip the per-term bounds checks (see the kernel).
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 4;

struct Dims {
  long long v[kMaxDim];
};

// Lattice coordinates of flat row g (row-major, last axis fastest). The
// last coordinate needs no division; the others divide by the row-major
// strides, in 32 bits when every index fits (one hardware-friendly
// division instead of a 64-bit division subroutine), else in 64 bits.
template <int D>
__device__ __forceinline__ void decode(long long g, const long long* stride,
                                       bool narrow, long long* c) {
  if (narrow) {
    unsigned rem = (unsigned)g;
#pragma unroll
    for (int k = 0; k < D - 1; ++k) {
      const unsigned s = (unsigned)stride[k];
      const unsigned q = rem / s;
      c[k] = q;
      rem -= q * s;
    }
    c[D - 1] = rem;
  } else {
    long long rem = g;
#pragma unroll
    for (int k = 0; k < D - 1; ++k) {
      c[k] = rem / stride[k];
      rem -= c[k] * stride[k];
    }
    c[D - 1] = rem;
  }
}

// meta layout: [off_lin_0 .. off_lin_{m-1}, off_0[0..D), off_1[0..D), ...,
//               reach[0..D)], reach[k] = max_t |off_t[k]|.
// D is a template parameter so that the per-axis loops unroll and the
// coordinates, strides and extents live in registers. Rows at least
// reach[k] away from both faces of every axis (all but a thin boundary
// shell) see every term inside the lattice and skip the bounds checks;
// both branches sum the same terms in the same order.
template <typename T, int D>
__global__ void stencil_matvec_kernel(const T* __restrict__ vals,
                                      const long long* __restrict__ meta,
                                      int m, Dims dims, long long nrows,
                                      long long nrows_pad,
                                      const T* __restrict__ x,
                                      T* __restrict__ y) {
  long long stride[D], reach[D];
  stride[D - 1] = 1;
#pragma unroll
  for (int k = D - 2; k >= 0; --k) stride[k] = stride[k + 1] * dims.v[k + 1];
#pragma unroll
  for (int k = 0; k < D; ++k) reach[k] = meta[m + (long long)m * D + k];
  const bool narrow = nrows_pad <= 0x7fffffffLL;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < nrows_pad; g += step) {
    if (g >= nrows) {
      y[g] = T(0);
      continue;
    }
    long long c[D];
    decode<D>(g, stride, narrow, c);
    bool interior = true;
#pragma unroll
    for (int k = 0; k < D; ++k)
      interior = interior && c[k] >= reach[k] && c[k] < dims.v[k] - reach[k];
    T acc = T(0);
    if (interior) {
      for (int t = 0; t < m; ++t) acc += vals[t] * x[g + meta[t]];
    } else {
      for (int t = 0; t < m; ++t) {
        const long long* off = meta + m + (long long)t * D;
        bool inside = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const long long ck = c[k] + off[k];
          inside = inside && ck >= 0 && ck < dims.v[k];
        }
        if (inside) acc += vals[t] * x[g + meta[t]];
      }
    }
    y[g] = acc;
  }
}

template <typename T, int D>
void launch_d(unsigned blocks, int threads, cudaStream_t stream,
              const T* vals, const long long* meta, int m, const Dims& dims,
              long long nrows, long long nrows_pad, const T* x, T* y) {
  stencil_matvec_kernel<T, D><<<blocks, threads, 0, stream>>>(
      vals, meta, m, dims, nrows, nrows_pad, x, y);
}

template <typename T>
int launch(const T* vals, const long long* meta, int m, int d, long long d0,
           long long d1, long long d2, long long d3, long long nrows,
           long long nrows_pad, const T* x, T* y, void* stream) {
  if (d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  if (nrows_pad <= 0) return 0;
  Dims dims = {{d0, d1, d2, d3}};
  const int threads = 256;
  long long blocks = (nrows_pad + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  const unsigned nb = (unsigned)blocks;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: launch_d<T, 1>(nb, threads, s, vals, meta, m, dims, nrows,
                           nrows_pad, x, y); break;
    case 2: launch_d<T, 2>(nb, threads, s, vals, meta, m, dims, nrows,
                           nrows_pad, x, y); break;
    case 3: launch_d<T, 3>(nb, threads, s, vals, meta, m, dims, nrows,
                           nrows_pad, x, y); break;
    default: launch_d<T, 4>(nb, threads, s, vals, meta, m, dims, nrows,
                            nrows_pad, x, y); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngsamg_stencil_matvec_f32(const float* vals,
                                         const long long* meta, int m, int d,
                                         long long d0, long long d1,
                                         long long d2, long long d3,
                                         long long nrows, long long nrows_pad,
                                         const float* x, float* y,
                                         void* stream) {
  return launch<float>(vals, meta, m, d, d0, d1, d2, d3, nrows, nrows_pad, x,
                       y, stream);
}

extern "C" int ngsamg_stencil_matvec_f64(const double* vals,
                                         const long long* meta, int m, int d,
                                         long long d0, long long d1,
                                         long long d2, long long d3,
                                         long long nrows, long long nrows_pad,
                                         const double* x, double* y,
                                         void* stream) {
  return launch<double>(vals, meta, m, d, d0, d1, d2, d3, nrows, nrows_pad, x,
                        y, stream);
}
