// The symmetric-half DIA matvec as K3 first was: one thread per row in a
// grid-stride loop, a rolled loop over the diagonals, every load a 4-byte
// scalar load behind its bounds test. The package never calls it (ops/cuda_lib.py builds
// csrc/*.cu only); chip_smoke.py builds it to time K3's "before" number
// beside the tiled kernel of csrc/dia_matvec.cu on the same input.
//
// C interface: launches on the given stream, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void dia_sym_row_kernel(const float* __restrict__ data,
                                   const long long* __restrict__ offs,
                                   int ndiag, long long n_pad,
                                   const float* __restrict__ x,
                                   float* __restrict__ y) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < n_pad; g += step) {
    float acc = 0.f;
    for (int d = 0; d < ndiag; ++d) {
      const long long o = offs[d];
      const float* row = data + (long long)d * n_pad;
      if (g + o < n_pad) acc += row[g] * x[g + o];
      if (o > 0 && g >= o) acc += row[g - o] * x[g - o];
    }
    y[g] = acc;
  }
}

}  // namespace

extern "C" int ngsamg_dia_sym_row_f32(const float* data, const long long* offs,
                                      int ndiag, long long n_pad,
                                      const float* x, float* y, void* stream) {
  if (n_pad <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_pad + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  dia_sym_row_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      data, offs, ndiag, n_pad, x, y);
  return (int)cudaGetLastError();
}
