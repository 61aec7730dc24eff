// K1: uniform clipped n-d stencil matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngsamg_tpu/ops/stencil_pallas.py
// `_stencil_kernel` (launched by `_stencil_matvec_call`), the finest-level
// matvec of a constant-coefficient lattice problem:
//
//   y[g] = sum_t vals[t] * x[g + off_lin_t] * [g + off_t inside dims]
//   y[g] = 0 for g in [nrows, nrows_pad)
//
// Bound: memory traffic. A call must read x once and write y once; the m
// values and offsets are a few hundred bytes. Two kernels compute it; the
// wrapper (ops/stencil_cuda.py) picks one from the shape alone.
//
// `stencil3d_kernel`, the tiled variant, for d == 3 and reach <= 1 per axis
// (the headline's 15-point stencil on a 215^3 lattice). A block of 256
// threads owns a kTY x kTX = 16 x 32 tile of the two fast axes (two output
// cells per thread, 8 rows apart) and marches along the slow axis over a
// chunk of planes. The x planes of the tile, with a one-cell halo, stream
// through a ring of kSlots = 8 planes in shared memory by cp.async: three
// in use and five in flight, so that a block keeps ~12 KB (f32) of loads
// outstanding while it sums a plane. Halo cells outside the lattice are
// zero-filled by the copy, which is the clip. The ring's first two slots
// are mirrored after its end, so the three planes z - 1 .. z + 1 are
// always contiguous and each tap has one fixed shared-memory offset. The
// taps are kernel parameters (the weights and those offsets, in A.offs
// order, zero-weight padded to NT = 7, 15 or 27; the launch turns each
// tap's (dz, dy, dx) into its offset), and the tap loop is unrolled, so a
// tap costs one address add, two shared loads and two FMAs for the
// thread's two cells: no per-row division, no per-tap global load, no
// bounds check, one barrier per plane. The padded taps add exact zeros,
// so the sum order is that of the general kernel. What remains is the
// shared-memory pipe: 15 loads per output, about as long as the DRAM
// stream itself, and the two only partly overlap (PERF.md).
//
// `stencil_matvec_kernel`, the general variant, for every other shape
// (d != 3, reach > 1): one thread per output row in a grid-stride loop,
// 64-bit row indices; lattice coordinates decoded from the flat row index
// (in 32-bit divisions while every index fits, in 64-bit ones beyond, so a
// larger lattice cannot overflow); each term masked by the per-axis bounds
// check instead of relying on a zero-filled x tail. Offsets are read from a
// small device array: there is no cap on their number. The lattice
// dimension d <= 4 is a template parameter, and rows away from the lattice
// faces skip the per-term bounds checks. Its neighbour reads span three
// lattice planes and are served by L2, not L1; on the headline it reaches
// about 16% of the DRAM bound, which is why the tiled variant exists.
//
// The TPU kernel's three-tile x window and lane roll existed only to stage
// x in VMEM and are not carried over.
//
// Both variants are built for f32, f64 and bf16 (the TPU kernel follows
// x's dtype, bf16 included). The bf16 builds load bfloat16 values and x,
// sum in f32 and round once at the store (precision.cuh); the tiled one
// passes its weights as f32 (the bf16 values, exactly). cp.async copies 4,
// 8 or 16 bytes, not 2, so the bf16 ring is filled by plain loads and
// shared-memory stores instead, with the same slots and barriers.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "precision.cuh"

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
  using Acc = typename AccOf<T>::type;
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
      y[g] = from_acc<T>(Acc(0));
      continue;
    }
    long long c[D];
    decode<D>(g, stride, narrow, c);
    bool interior = true;
#pragma unroll
    for (int k = 0; k < D; ++k)
      interior = interior && c[k] >= reach[k] && c[k] < dims.v[k] - reach[k];
    Acc acc = Acc(0);
    if (interior) {
      for (int t = 0; t < m; ++t)
        acc += to_acc(vals[t]) * to_acc(x[g + meta[t]]);
    } else {
      for (int t = 0; t < m; ++t) {
        const long long* off = meta + m + (long long)t * D;
        bool inside = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const long long ck = c[k] + off[k];
          inside = inside && ck >= 0 && ck < dims.v[k];
        }
        if (inside) acc += to_acc(vals[t]) * to_acc(x[g + meta[t]]);
      }
    }
    y[g] = from_acc<T>(acc);
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

// ---------------------------------------------------------------------------
// tiled variant: d == 3, reach <= 1 per axis
// ---------------------------------------------------------------------------

constexpr int kTX = 32;                   // fast-axis cells of a tile (a warp)
constexpr int kTY = 16;                   // middle-axis cells of a tile
constexpr int kRows = 2;                  // output cells of a thread, kTY / kRows apart
constexpr int kHalo = 1;                  // the stencil's reach per axis
constexpr int kHX = kTX + 2 * kHalo;      // with the halo
constexpr int kHY = kTY + 2 * kHalo;
constexpr int kPlane = kHX * kHY;         // shared cells per ring plane
constexpr int kThreads3d = kTX * kTY / kRows;
constexpr int kLoads = (kPlane + kThreads3d - 1) / kThreads3d;
constexpr int kSlots = 8;                 // ring planes: 3 in use, 5 in flight
constexpr int kMirror = 2;                // slots 0, 1 repeated after the ring
constexpr int kMaxTaps = 27;

// w: the weights in A.offs order, zero-padded, in the accumulation type.
// off: each tap's offset in the three-plane window [z - 1, z + 1] of the
// ring, relative to the thread's cell: (dz + 1) * kPlane + (dy + 1) * kHX +
// (dx + 1) (launch3d computes it).
template <typename W>
struct Taps {
  W w[kMaxTaps];
  int off[kMaxTaps];
};

// cp.async of one value (4 or 8 bytes) into shared memory; src_bytes 0
// writes a zero without reading.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Ring {
  T* s;                    // (kSlots + kMirror) * kPlane shared cells
  const T* __restrict__ x;
  long long plane;         // n1 * n2
  int n0;
  int soff[kLoads];        // this thread's cells in a ring plane (-1: none)
  int goff[kLoads];        // their in-plane lattice index (-1: outside)

  // start copying this thread's cells of lattice plane z into a slot, and
  // into its mirror for slots 0 and 1 (zeros outside the lattice), as one
  // commit group. A 2-byte value has no cp.async: it is loaded and stored
  // here, and the group stays empty (the slot is free when fetch is called
  // and is read only after a later barrier either way).
  __device__ __forceinline__ void fetch(int z, int slot) const {
    const bool zin = z >= 0 && z < n0;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (soff[k] < 0) continue;
      const bool ok = zin && goff[k] >= 0;
      const T* src = ok ? x + (long long)z * plane + goff[k] : x;
      if constexpr (sizeof(T) >= 4) {
        const int bytes = ok ? (int)sizeof(T) : 0;
        cp_async<sizeof(T)>(s + slot * kPlane + soff[k], src, bytes);
        if (slot < kMirror)
          cp_async<sizeof(T)>(s + (slot + kSlots) * kPlane + soff[k], src,
                              bytes);
      } else {
        const T v = ok ? *src : from_acc<T>(0.0f);
        s[slot * kPlane + soff[k]] = v;
        if (slot < kMirror) s[(slot + kSlots) * kPlane + soff[k]] = v;
      }
    }
    cp_async_commit();
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads3d, 4)
    stencil3d_kernel(const Taps<typename AccOf<T>::type> taps, int n0,
                     int n1, int n2,
                     int tiles_x, int tiles_y, int chunk, long long nrows,
                     long long nrows_pad, const T* __restrict__ x,
                     T* __restrict__ y) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem3d[];
  T* s = reinterpret_cast<T*>(smem3d);
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;  // cells ty + r * kTY / kRows
  const int tiles = tiles_x * tiles_y;
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % tiles_x) * kTX, y0 = (tile / tiles_x) * kTY;
  const int z0 = (blockIdx.x / tiles) * chunk;
  const int z1 = min(z0 + chunk, n0);
  if (blockIdx.x == 0)
    for (long long g = nrows + tid; g < nrows_pad; g += kThreads3d)
      y[g] = from_acc<T>(Acc(0));

  Ring<T> ring;
  ring.s = s;
  ring.x = x;
  ring.plane = (long long)n1 * n2;
  ring.n0 = n0;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int e = tid + k * kThreads3d;
    const int r = e / kHX, c = e % kHX;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool cell = e < kPlane;
    ring.soff[k] = cell ? e : -1;
    ring.goff[k] = (cell && gy >= 0 && gy < n1 && gx >= 0 && gx < n2)
                       ? gy * n2 + gx
                       : -1;
  }
  // plane p sits in slot (p - z0 + 1) % kSlots (slots 0 and 1 also in
  // their mirrors), so the planes z - 1, z, z + 1 are the three contiguous
  // slots from (z - z0) % kSlots on. The chunk reads the planes z0 - 1 ..
  // z1. Prologue: the first kSlots - 1 of them.
#pragma unroll
  for (int i = 0; i < kSlots - 1; ++i) {
    const int p = z0 - 1 + i;
    if (p <= z1) ring.fetch(p, i);
    else cp_async_commit();
  }
  constexpr int kRowStep = kTY / kRows;
  bool out[kRows];
  long long gout[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gy = y0 + ty + r * kRowStep;
    out[r] = gy < n1 && x0 + tx < n2;
    gout[r] = (long long)gy * n2 + x0 + tx;
  }
  const T* cell = s + ty * kHX + tx;
  for (int z = z0; z < z1; ++z) {
    // planes up to z + 1 have landed (this thread's copies; the barrier
    // makes every thread's visible and frees the slot of plane z - 2)
    cp_async_wait<kSlots - 4>();
    __syncthreads();
    const int p = z + kSlots - 2;
    if (p <= z1) ring.fetch(p, (p - z0 + 1) % kSlots);
    else cp_async_commit();
    const T* win = cell + ((z - z0) % kSlots) * kPlane;
    Acc acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = Acc(0);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const T* v = win + taps.off[t];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] += taps.w[t] * to_acc(v[r * kRowStep * kHX]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (out[r])
        y[(long long)z * ring.plane + gout[r]] = from_acc<T>(acc[r]);
  }
  cp_async_wait<0>();
}

// w_host: kMaxTaps weights (in the accumulation type); taps_host: kMaxTaps
// (dz, dy, dx) shifts, in A.offs order, padded with zero-weight taps. The rest is the wrapper's
// plan (ops/stencil_cuda.py `stencil_plan`), passed whole and checked
// against this kernel's geometry, so that the two cannot disagree: a plan
// built for another tile, halo, ring or grid is refused, not run.
template <typename T>
int launch3d(const typename AccOf<T>::type* w_host, const int* taps_host,
             int ntaps, int n0, int n1,
             int n2, int tile_y, int tile_x, int halo, int tiles_y,
             int tiles_x, int chunk, long long blocks, long long smem_bytes,
             long long nrows, long long nrows_pad, const T* x, T* y,
             void* stream) {
  // <= 48 KB in bf16, f32 and f64: no opt-in
  const long long smem = (long long)sizeof(T) * (kSlots + kMirror) * kPlane;
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || chunk <= 0 || tile_y != kTY ||
      tile_x != kTX || halo != kHalo || tiles_y != (n1 + kTY - 1) / kTY ||
      tiles_x != (n2 + kTX - 1) / kTX ||
      blocks != (long long)tiles_x * tiles_y * ((n0 + chunk - 1) / chunk) ||
      blocks > 0x7fffffffLL || smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  Taps<typename AccOf<T>::type> taps;
  for (int t = 0; t < kMaxTaps; ++t) {
    const int* d = taps_host + 3 * t;
    for (int k = 0; k < 3; ++k)
      if (d[k] < -kHalo || d[k] > kHalo) return (int)cudaErrorInvalidValue;
    taps.w[t] = w_host[t];
    taps.off[t] =
        (d[0] + kHalo) * kPlane + (d[1] + kHalo) * kHX + d[2] + kHalo;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  const size_t smem_sz = (size_t)smem_bytes;
  switch (ntaps) {
    case 7: stencil3d_kernel<T, 7><<<nb, kThreads3d, smem_sz, s>>>(
        taps, n0, n1, n2, tiles_x, tiles_y, chunk, nrows, nrows_pad, x, y);
      break;
    case 15: stencil3d_kernel<T, 15><<<nb, kThreads3d, smem_sz, s>>>(
        taps, n0, n1, n2, tiles_x, tiles_y, chunk, nrows, nrows_pad, x, y);
      break;
    case 27: stencil3d_kernel<T, 27><<<nb, kThreads3d, smem_sz, s>>>(
        taps, n0, n1, n2, tiles_x, tiles_y, chunk, nrows, nrows_pad, x, y);
      break;
    default: return (int)cudaErrorInvalidValue;
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

extern "C" int ngsamg_stencil3d_f32(const float* w_host, const int* taps_host,
                                    int ntaps, int n0, int n1, int n2,
                                    int tile_y, int tile_x, int halo,
                                    int tiles_y, int tiles_x, int chunk,
                                    long long blocks, long long smem_bytes,
                                    long long nrows, long long nrows_pad,
                                    const float* x, float* y, void* stream) {
  return launch3d<float>(w_host, taps_host, ntaps, n0, n1, n2, tile_y, tile_x,
                         halo, tiles_y, tiles_x, chunk, blocks, smem_bytes,
                         nrows, nrows_pad, x, y, stream);
}

extern "C" int ngsamg_stencil3d_f64(const double* w_host,
                                    const int* taps_host, int ntaps, int n0,
                                    int n1, int n2, int tile_y, int tile_x,
                                    int halo, int tiles_y, int tiles_x,
                                    int chunk, long long blocks,
                                    long long smem_bytes, long long nrows,
                                    long long nrows_pad, const double* x,
                                    double* y, void* stream) {
  return launch3d<double>(w_host, taps_host, ntaps, n0, n1, n2, tile_y,
                          tile_x, halo, tiles_y, tiles_x, chunk, blocks,
                          smem_bytes, nrows, nrows_pad, x, y, stream);
}

extern "C" int ngsamg_stencil_matvec_bf16(const __nv_bfloat16* vals,
                                          const long long* meta, int m, int d,
                                          long long d0, long long d1,
                                          long long d2, long long d3,
                                          long long nrows, long long nrows_pad,
                                          const __nv_bfloat16* x,
                                          __nv_bfloat16* y, void* stream) {
  return launch<__nv_bfloat16>(vals, meta, m, d, d0, d1, d2, d3, nrows,
                               nrows_pad, x, y, stream);
}

extern "C" int ngsamg_stencil3d_bf16(const float* w_host, const int* taps_host,
                                     int ntaps, int n0, int n1, int n2,
                                     int tile_y, int tile_x, int halo,
                                     int tiles_y, int tiles_x, int chunk,
                                     long long blocks, long long smem_bytes,
                                     long long nrows, long long nrows_pad,
                                     const __nv_bfloat16* x, __nv_bfloat16* y,
                                     void* stream) {
  return launch3d<__nv_bfloat16>(w_host, taps_host, ntaps, n0, n1, n2, tile_y,
                                 tile_x, halo, tiles_y, tiles_x, chunk, blocks,
                                 smem_bytes, nrows, nrows_pad, x, y, stream);
}
