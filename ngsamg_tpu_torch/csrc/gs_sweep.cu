// The multicolour Gauss-Seidel sweep for Hopper (sm_90a), on a level whose
// block rows are sorted by colour (smoothers/core.py `_gs`): for each colour
// c in turn (in reverse order backwards), every block row r of the colour,
// rows bounds[c] .. bounds[c+1], is updated from the latest x,
//
//   x[r] += Dinv[r] (b[r] - sum_{k < nslots[r]} data[r, k] x[cols[r, k]]),
//
// data (n, K, bs, bs) and cols (n, K) int32 of the level's block-ELL
// operator, Dinv (n, bs, bs). No two rows of a colour are coupled, so a
// colour's rows are independent and the colours are the sweep's only order.
//
// It replaces no TPU kernel: the JAX package leaves the sweep to XLA, and
// the port ran it as plain torch, about six launches a colour step (a
// gather of x, a product and a sum, a subtraction, the Dinv product, an
// in-place add). On the 1M-DoF Poisson's levels that is 546 colour steps a
// V-cycle and ~36,000 launches a solve: the host's dispatch and, on the
// card, the colour steps' latency set the time, not bytes (2 operations for
// each 8 bytes of a value and its column). So a colour step here is one
// pass: a row's threads take its real slots (up to `nslots[r]`: the pack
// puts them first, the padding after them is never read), gather x, sum,
// form b - A x, apply the row's Dinv block and write x in place.
//
// Two launch shapes of that body, chosen by the plan (ops/gs_cuda.py) from
// the level's shape:
//
// - colour launch (`gs_colour_kernel`): one launch a colour step over the
//   whole card, x in device memory. A row is owned by `lanes` threads of a
//   warp or `warps` whole warps (bell_matvec.cu's rule). The first launch
//   of a sweep covers every row and writes all of x_out: rows of its colour
//   updated, the others copied from x_in (or zero for a zero start), so the
//   caller's x is never written and needs no copy. The entry loops over
//   the colour steps on the host: one ctypes call a sweep.
// - sweep launch (`gs_sweep_kernel`): one launch for the whole sweep, on
//   one thread block cluster of `cluster` CTAs (1 to 16), where the level's
//   x fits in a block's shared memory. Each CTA keeps the whole x in its
//   shared memory; a colour's rows are dealt to the groups of `lanes *
//   warps` threads across the cluster, and a finished row is written into
//   every CTA's copy through distributed shared memory (the lanes of the
//   row's group each storing to some of the CTAs) before the cluster
//   barrier that separates the colours. A step's slots do not depend on x,
//   so each thread loads those of its row two colour steps ahead (up to
//   `Sweep<bs>::slots` of them, its b and its Dinv row) into one of two
//   register buffers between the barrier's arrive and its wait: the loads
//   are in flight for a whole step, and a colour step waits on shared
//   memory and the barrier, not on device memory. The last barrier is
//   followed by one write of x to x_out.
//
// Sums are in the tensor's type (f32 for f32, f64 for f64) and in f32 for
// bf16, rounded where the plain version rounds: the row's product with x
// (a bf16 product rounded to bf16 before it is summed, as bell_matvec.cu
// forms it), b minus it, the Dinv product and the update of x. No atomics:
// the same input gives the same bits. bs is a template parameter, 1 and
// the square widths the port stages (2, 3, 6); a level of any other shape
// gets no launch plan and stays on the plain version.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns a cudaError_t as an int (cudaErrorInvalidValue for a
// plan that does not match the kernels' layout).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "precision.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kColourThreads = 256;  // a colour launch's block
constexpr int kColourMaxWarps = kColourThreads / kWarp;
constexpr int kMaxCluster = 16;  // CTAs of a cluster (8 portable)
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// A sweep launch's largest block and the slots a thread holds ahead in
// each of its two buffers, by bs: the buffers take 2 S (bs * bs + 1)
// registers, and a block of 512 threads leaves each 128.
template <int BS>
struct Sweep;
template <>
struct Sweep<1> {
  static constexpr int threads = 512, slots = 16;
};
template <>
struct Sweep<2> {
  static constexpr int threads = 512, slots = 4;
};
template <>
struct Sweep<3> {
  static constexpr int threads = 512, slots = 2;
};
template <>
struct Sweep<6> {
  static constexpr int threads = 256, slots = 1;
};

// The widest aligned load of N values of T (as bell_matvec.cu's).
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

template <typename T, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ p, T* v) {
  constexpr int B = LoadBytes<T, N>::value;
  using W = typename Word<B>::type;
  const W* q = reinterpret_cast<const W*>(p);
  W* w = reinterpret_cast<W*>(v);
#pragma unroll
  for (int m = 0; m < N * (int)sizeof(T) / B; ++m) w[m] = __ldg(q + m);
}

// a * b in the accumulation type; for bf16 rounded to bf16 first
template <typename T>
__device__ __forceinline__ typename AccOf<T>::type product(T a, T b) {
  return to_acc(a) * to_acc(b);
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16>(__nv_bfloat16 a,
                                                        __nv_bfloat16 b) {
  return __bfloat162float(__float2bfloat16(to_acc(a) * to_acc(b)));
}

template <typename T>
__device__ __forceinline__ T zero() {
  return from_acc<T>(typename AccOf<T>::type(0));
}

// The cluster barrier in its two halves: the arrive releases this thread's
// writes (the rows it published into every CTA's x); loads issued between
// the two are not held by it, so the next step's slots load across the
// wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <typename Acc>
__device__ __forceinline__ Acc lanes_sum(Acc v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Component i of the row's new x: x + Dinv[i, :] (b - s), s the row's
// product with x, rounded where the plain version rounds.
template <typename T, int BS>
__device__ __forceinline__ T updated(T xi, const typename AccOf<T>::type* s,
                                     const T* bv, const T* dv) {
  using Acc = typename AccOf<T>::type;
  Acc dx = Acc(0);
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    const T res = from_acc<T>(to_acc(bv[j]) - to_acc(from_acc<T>(s[j])));
    dx += to_acc(dv[j]) * to_acc(res);
  }
  return from_acc<T>(to_acc(xi) + to_acc(from_acc<T>(dx)));
}

// ---------------------------------------------------------------------------
// colour launch

// Row of a thread: block rows (kColourThreads / tpr a block) counted from
// row 0 in the first launch of a sweep (`fill`: every row of the level,
// those outside the colour copied) and from bounds[c] in the others. Every
// thread reaches the shuffles and the barrier.
template <typename T, int BS>
__global__ void __launch_bounds__(kColourThreads)
    gs_colour_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                     const int* __restrict__ nslots,
                     const T* __restrict__ dinv, const T* __restrict__ b,
                     const int* __restrict__ bounds, int c, int K,
                     long long n, int lanes, int warps, int fill, int skip,
                     const T* xin, T* xout) {
  using Acc = typename AccOf<T>::type;
  const int tpr = lanes * warps;
  const int t = threadIdx.x;
  const long long lo = bounds[c], hi = bounds[c + 1];
  const long long idx =
      (long long)blockIdx.x * (kColourThreads / tpr) + t / tpr;
  const long long row = fill ? idx : lo + idx;
  const bool live = row < (fill ? n : hi);
  const bool mine = live && row >= lo && row < hi;
  const int rank = t % tpr;
  Acc acc[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) acc[i] = Acc(0);
  if (mine && !skip && xin) {
    const int ns = nslots ? __ldg(nslots + row) : K;
    const long long base = row * K;
    for (int k = rank; k < ns; k += tpr) {
      const long long slot = base + k;
      const T* xr = xin + (long long)__ldg(cols + slot) * BS;
      alignas(16) T a[BS * BS];
      load_run<T, BS * BS>(data + slot * BS * BS, a);
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        const T xv = xr[j];
#pragma unroll
        for (int i = 0; i < BS; ++i) acc[i] += product(a[i * BS + j], xv);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BS; ++i) acc[i] = lanes_sum(acc[i], lanes);
  if (warps > 1) {
    __shared__ Acc part[kColourMaxWarps][BS];
    const int w = t / kWarp;
    if (t % kWarp == 0) {
#pragma unroll
      for (int i = 0; i < BS; ++i) part[w][i] = acc[i];
    }
    __syncthreads();
    if (rank < BS) {
      const int w0 = (t / tpr) * warps;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        Acc s = Acc(0);
        for (int q = 0; q < warps; ++q) s += part[w0 + q][i];
        acc[i] = s;
      }
    }
  }
  if (!live) return;
  for (int i = rank; i < BS; i += tpr) {
    const long long at = row * BS + i;
    const T xi = xin ? xin[at] : zero<T>();
    if (!mine) {
      xout[at] = xi;
      continue;
    }
    T bv[BS], dv[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      bv[j] = __ldg(b + row * BS + j);
      dv[j] = __ldg(dinv + at * BS + j);
    }
    xout[at] = updated<T, BS>(xi, acc, bv, dv);
  }
}

// ---------------------------------------------------------------------------
// sweep launch

// What a thread holds of its first row in a colour step: the row, its real
// slots, the first S of its own slots (rank, rank + tpr, ...), and b and
// Dinv row `rank` of the row where rank < BS.
template <typename T, int BS, int S>
struct Held {
  int row;
  bool live;
  int ns;
  int col[S];
  alignas(16) T a[S][BS * BS];
  T bv[BS], dv[BS];
};

template <typename T, int BS>
__global__ void __launch_bounds__(Sweep<BS>::threads)
    gs_sweep_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                    const int* __restrict__ nslots, const T* __restrict__ dinv,
                    const T* __restrict__ b, const int* __restrict__ bounds,
                    int ncolours, int K, long long n, int lanes, int warps,
                    int steps, int reverse, int skip,
                    const T* __restrict__ xin, T* __restrict__ xout) {
  using Acc = typename AccOf<T>::type;
  constexpr int S = Sweep<BS>::slots;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int tpr = lanes * warps;
  // shared memory: x (n * BS values), then the warps' partial sums, then
  // the colour bounds (the layout of gs_cuda.sweep_smem_bytes)
  T* xs = reinterpret_cast<T*>(smem);
  const long long xbytes = (n * BS * (long long)sizeof(T) + 15) / 16 * 16;
  Acc* part = reinterpret_cast<Acc*>(smem + xbytes);
  int* cb = reinterpret_cast<int*>(smem + xbytes +
                                   (threads / kWarp) * BS * sizeof(Acc));
  for (long long i = t; i < n * BS; i += threads)
    xs[i] = xin ? xin[i] : zero<T>();
  for (int i = t; i <= ncolours; i += threads) cb[i] = bounds[i];
  // every copy of x is whole before any CTA writes into another's
  cluster.sync();

  const int gpc = threads / tpr;  // groups of a CTA
  const int G = csize * gpc;
  const int g = crank * gpc + t / tpr;
  const int rank = t % tpr;
  const int w = t / kWarp;
  const int nsteps = steps * ncolours;
  auto colour = [&](int s) {
    int q = s;  // s % ncolours, steps being few
    while (q >= ncolours) q -= ncolours;
    return reverse ? ncolours - 1 - q : q;
  };
  // the real slots of the group's first row in step s (0 past the end)
  auto first_ns = [&](int s) {
    if (s >= nsteps) return 0;
    const int c = colour(s);
    const int row = cb[c] + g;
    if (row >= cb[c + 1]) return 0;
    return nslots ? __ldg(nslots + row) : K;
  };
  // loads the group's first row of step s: its slots are read up to ns
  auto hold = [&](Held<T, BS, S>& h, int s, int ns) {
    const int c = colour(s);
    h.row = cb[c] + g;
    h.live = h.row < cb[c + 1];
    h.ns = ns;
    if (!h.live) return;
    const int* cr = cols + (long long)h.row * K;
    const T* dr = data + (long long)h.row * K * BS * BS;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int k = rank + q * tpr;
      if (k >= ns) break;
      h.col[q] = __ldg(cr + k);
      load_run<T, BS * BS>(dr + k * BS * BS, h.a[q]);
    }
    if (rank < BS) {
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        h.bv[j] = __ldg(b + (long long)h.row * BS + j);
        h.dv[j] = __ldg(dinv + ((long long)h.row * BS + rank) * BS + j);
      }
    }
  };
  // slots k0, k0 + tpr, ... below ns of `row`, loaded now
  auto gather = [&](Acc* acc, int row, int k0, int ns) {
    const int* cr = cols + (long long)row * K;
    const T* dr = data + (long long)row * K * BS * BS;
    for (int k = k0; k < ns; k += tpr) {
      const T* xr = xs + __ldg(cr + k) * BS;
      alignas(16) T a[BS * BS];
      load_run<T, BS * BS>(dr + k * BS * BS, a);
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        const T xv = xr[j];
#pragma unroll
        for (int i = 0; i < BS; ++i) acc[i] += product(a[i * BS + j], xv);
      }
    }
  };
  // the group's sum in the threads rank < BS (every thread takes part);
  // `again`: not the step's first row, whose readers of part the barrier
  // between the steps has already waited for
  auto reduce = [&](Acc* acc, bool again) {
    const int l = tpr < kWarp ? tpr : kWarp;
#pragma unroll
    for (int i = 0; i < BS; ++i) acc[i] = lanes_sum(acc[i], l);
    if (warps > 1) {
      if (again) __syncthreads();  // the last row's readers of part are done
      if (t % kWarp == 0) {
#pragma unroll
        for (int i = 0; i < BS; ++i) part[w * BS + i] = acc[i];
      }
      __syncthreads();
      if (rank < BS) {
        const int w0 = (t / tpr) * warps;
#pragma unroll
        for (int i = 0; i < BS; ++i) {
          Acc s = Acc(0);
          for (int q = 0; q < warps; ++q) s += part[(w0 + q) * BS + i];
          acc[i] = s;
        }
      }
    }
  };
  // the row's new x into every CTA's copy: component i is computed by the
  // thread rank i and stored by the lanes of the group's first warp, each
  // to its share of the CTAs (every thread takes part in the shuffle)
  const int l = tpr < kWarp ? tpr : kWarp;  // the group's lanes in a warp
  const int per = l / BS;  // CTAs a round of the lanes stores to
  const int lane0 = t % kWarp - rank % kWarp;  // the group's first lane
  auto publish = [&](bool live, int row, const Acc* acc, const T* bv,
                     const T* dv) {
    T v = zero<T>();
    if (live && rank < BS)
      v = updated<T, BS>(xs[row * BS + rank], acc, bv, dv);
    const int i = rank % kWarp % BS;
    const T vi = __shfl_sync(0xffffffffu, v, lane0 + i);
    if (live && rank < per * BS) {
      for (int q = rank / BS; q < csize; q += per)
        cluster.map_shared_rank(xs, q)[row * BS + i] = vi;
    }
  };

  // one colour step on the slots held in h (loaded two steps before); the
  // step two ahead is loaded into h between the halves of its barrier, its
  // row's count read two steps before that (ns_ahead)
  auto step = [&](int s, Held<T, BS, S>& h, int& ns_ahead) {
    const int c = colour(s);
    const int lo = cb[c], hi = cb[c + 1];
    const bool product_skipped = skip && s == 0;
    Acc acc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) acc[i] = Acc(0);
    if (h.live) {
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (rank + q * tpr >= h.ns) break;
        const T* xr = xs + h.col[q] * BS;
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          const T xv = xr[j];
#pragma unroll
          for (int i = 0; i < BS; ++i)
            acc[i] += product(h.a[q][i * BS + j], xv);
        }
      }
      if (rank + S * tpr < h.ns) gather(acc, h.row, rank + S * tpr, h.ns);
    }
    reduce(acc, false);
    publish(h.live, h.row, acc, h.bv, h.dv);
    // rows past the cluster's groups: loaded when they are reached
    for (int first = lo + G; first < hi; first += G) {
      const int row = first + g;
      const bool live = row < hi;
#pragma unroll
      for (int i = 0; i < BS; ++i) acc[i] = Acc(0);
      if (live && !product_skipped)
        gather(acc, row, rank, nslots ? __ldg(nslots + row) : K);
      reduce(acc, true);
      T bv[BS], dv[BS];
      if (live && rank < BS) {
#pragma unroll
        for (int jj = 0; jj < BS; ++jj) {
          bv[jj] = __ldg(b + (long long)row * BS + jj);
          dv[jj] = __ldg(dinv + ((long long)row * BS + rank) * BS + jj);
        }
      }
      publish(live, row, acc, bv, dv);
    }
    // the barrier between the colours, the slots of the step after next
    // loaded between its halves
    cluster_arrive();
    if (s + 2 < nsteps) {
      hold(h, s + 2, ns_ahead);
      ns_ahead = first_ns(s + 4);
    }
    cluster_wait();
  };

  Held<T, BS, S> h0, h1;
  hold(h0, 0, skip ? 0 : first_ns(0));
  if (nsteps > 1) hold(h1, 1, first_ns(1));
  int ns0 = first_ns(2), ns1 = first_ns(3);
  for (int s = 0; s < nsteps; s += 2) {
    step(s, h0, ns0);
    if (s + 1 < nsteps) step(s + 1, h1, ns1);
  }
  for (long long i = (long long)crank * threads + t; i < n * BS;
       i += (long long)csize * threads)
    xout[i] = xs[i];
}

// ---------------------------------------------------------------------------
// launches

bool pow2(int v) { return v > 0 && !(v & (v - 1)); }

// the layout of the sweep launch's shared memory (gs_cuda.sweep_smem_bytes)
template <typename T>
long long sweep_smem(long long n, int bs, int threads, int ncolours) {
  using Acc = typename AccOf<T>::type;
  return (n * bs * (long long)sizeof(T) + 15) / 16 * 16 +
         (long long)(threads / kWarp) * bs * (long long)sizeof(Acc) +
         4LL * (ncolours + 1);
}

template <typename T, int BS>
int colour_launches(const T* data, const int* cols, const int* nslots,
                    const T* dinv, const T* b, const int* bounds,
                    int ncolours, int K, long long n, long long max_rows,
                    int steps, int reverse, int skip, int lanes, int warps,
                    const T* xin, T* xout, cudaStream_t s) {
  if (!pow2(lanes) || lanes > kWarp || !pow2(warps) ||
      warps > kColourMaxWarps || (warps > 1 && lanes != kWarp))
    return (int)cudaErrorInvalidValue;
  const long long rpb = kColourThreads / (lanes * warps);
  const long long all = (n + rpb - 1) / rpb, most = (max_rows + rpb - 1) / rpb;
  if (all > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (int st = 0; st < steps; ++st) {
    for (int q = 0; q < ncolours; ++q) {
      const int c = reverse ? ncolours - 1 - q : q;
      const bool first = st == 0 && q == 0;
      const long long grid = first ? all : most;
      if (grid == 0) continue;
      gs_colour_kernel<T, BS><<<(unsigned)grid, kColourThreads, 0, s>>>(
          data, cols, nslots, dinv, b, bounds, c, K, n, lanes, warps,
          first ? 1 : 0, first && skip ? 1 : 0, first ? xin : xout, xout);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaSuccess;
}

template <typename T, int BS>
int sweep_launch(const T* data, const int* cols, const int* nslots,
                 const T* dinv, const T* b, const int* bounds, int ncolours,
                 int K, long long n, int steps, int reverse, int skip,
                 int cluster, int threads, int lanes, int warps,
                 const T* xin, T* xout, cudaStream_t s) {
  const int tpr = lanes * warps;
  if (cluster < 1 || cluster > kMaxCluster || threads < kWarp ||
      threads > Sweep<BS>::threads || threads % kWarp || !pow2(lanes) ||
      lanes > kWarp || !pow2(warps) || (warps > 1 && lanes != kWarp) ||
      tpr > threads || tpr < BS || threads % tpr)
    return (int)cudaErrorInvalidValue;
  const long long bytes = sweep_smem<T>(n, BS, threads, ncolours);
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = gs_sweep_kernel<T, BS>;
  static bool attributes = false;  // set once a kernel (under the GIL)
  if (!attributes) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attributes = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, data, cols, nslots, dinv, b, bounds,
                         ncolours, K, n, lanes, warps, steps, reverse, skip,
                         xin, xout);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// route 0: one colour launch a colour step; 1: one sweep launch.
template <typename T, int BS>
int launch_bs(const T* data, const int* cols, const int* nslots,
              const T* dinv, const T* b, const int* bounds, int ncolours,
              int K, long long n, long long max_rows, int steps, int reverse,
              int skip, int route, int cluster, int threads, int lanes,
              int warps, const T* xin, T* xout, cudaStream_t s) {
  if (route == 0)
    return colour_launches<T, BS>(data, cols, nslots, dinv, b, bounds,
                                  ncolours, K, n, max_rows, steps, reverse,
                                  skip, lanes, warps, xin, xout, s);
  if (route == 1)
    return sweep_launch<T, BS>(data, cols, nslots, dinv, b, bounds,
                               ncolours, K, n, steps, reverse, skip, cluster,
                               threads, lanes, warps, xin, xout, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const T* data, const int* cols, const int* nslots, const T* dinv,
           const T* b, const int* bounds, int ncolours, int K, int bs,
           long long n, long long max_rows, int steps, int reverse, int skip,
           int route, int cluster, int threads, int lanes, int warps,
           const T* xin, T* xout, void* stream) {
  if (ncolours < 1 || K < 1 || n < 1 || max_rows < 0 || max_rows > n ||
      steps < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define NGSAMG_GS_CASE(BS)                                                  \
  case BS:                                                                  \
    return launch_bs<T, BS>(data, cols, nslots, dinv, b, bounds, ncolours, \
                            K, n, max_rows, steps, reverse, skip, route,    \
                            cluster, threads, lanes, warps, xin, xout, s);
  switch (bs) {
    NGSAMG_GS_CASE(1)
    NGSAMG_GS_CASE(2)
    NGSAMG_GS_CASE(3)
    NGSAMG_GS_CASE(6)
  }
#undef NGSAMG_GS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define NGSAMG_GS_SWEEP(SFX, T)                                              \
  extern "C" int ngsamg_gs_sweep_##SFX(                                      \
      const T* data, const int* cols, const int* nslots, const T* dinv,      \
      const T* b, const int* bounds, int ncolours, int K, int bs,            \
      long long n, long long max_rows, int steps, int reverse, int skip,     \
      int route, int cluster, int threads, int lanes, int warps,             \
      const T* xin, T* xout, void* stream) {                                 \
    return launch<T>(data, cols, nslots, dinv, b, bounds, ncolours, K, bs,   \
                     n, max_rows, steps, reverse, skip, route, cluster,      \
                     threads, lanes, warps, xin, xout, stream);              \
  }
NGSAMG_GS_SWEEP(f32, float)
NGSAMG_GS_SWEEP(f64, double)
NGSAMG_GS_SWEEP(bf16, __nv_bfloat16)
