// §7.6 sliding template match (sum of absolute differences) over every
// (R, N) row (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:496 (template_match,
// pallas_call at :501, body _template_kernel at :492 over _sad_vals).
//
// What it computes: out[r, p] = sum_j |x[r, (p + j) mod N] - t[j]| for
// j = 0 .. M-1 in that order, in float32 (the row and the template cast
// to float32 first), every difference and sum rounded as written — the
// lane rule cpm_sad of cpm_ops.cuh, the one fused_stream.cu's template
// branch uses, so every result equals the plain twin and the fused
// stream bit for bit.  The tail wraps (jnp.roll(x, -j)); CPMArray masks
// it.  The template comes as an (M,) float32 tensor on the device; the
// row takes any dtype of the CPM kernels (cpm_ops.cuh's codes).
//
// What bounds it on the H100: at M = 64 and chip_smoke's (64, 1,048,576)
// int32 rows, the 3·M operations a lane (a subtraction, an absolute value,
// an add), 12.9 G at 67e12/s the float32 rate outside the tensor cores:
// 0.192 ms; the bytes (268.4 MB in, 268.4 MB out) take 0.160 ms.
//
// What the design does about it: one thread per output lane, a block per
// tile of TM_TILE lanes of one row.  The block stages its tile plus the
// M - 1 lanes after it (wrapping at the row end), converted to float32,
// and the template in shared memory, so each row element is read from
// device memory about (TM_TILE + M - 1) / TM_TILE times and the M-step
// loop reads only shared memory (neighbouring threads read neighbouring
// words, the template item is a broadcast).  Dynamic shared memory of
// (TM_TILE + 2M - 1) floats: M is at most 28,928 (TEMPLATE_MAX_M of the
// wrapper), the most whose halo and template fit the H100's 232,448
// bytes a block; the wrapper raises above it, this file refuses it.

#include "cpm_ops.cuh"

#define TM_TILE 256
#define TM_MAX_SMEM 232448

namespace {

template <class Tr>
__global__ void __launch_bounds__(TM_TILE)
template_match_kernel(const typename Tr::S* __restrict__ x,
                      const float* __restrict__ t, float* __restrict__ out,
                      int R, int n, int m) {
  extern __shared__ float smem[];
  float* xs = smem;                                // [TM_TILE + m - 1]
  float* ts = smem + TM_TILE + (m > 0 ? m - 1 : 0); // [m]
  const int span = TM_TILE + (m > 0 ? m - 1 : 0);
  const long long b0 = (long long)blockIdx.x * TM_TILE;
  for (int j = threadIdx.x; j < m; j += TM_TILE) ts[j] = t[j];
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const typename Tr::S* xr = x + (long long)row * n;
    for (int k = threadIdx.x; k < span; k += TM_TILE)
      xs[k] = (float)Tr::acc(xr[(b0 + k) % n]);
    __syncthreads();
    const long long p = b0 + threadIdx.x;
    if (p < n)
      out[(long long)row * n + p] = cpm_sad(
          m, [&](int j) { return xs[threadIdx.x + j]; },
          [&](int j) { return ts[j]; });
    __syncthreads();                               // xs is reused
  }
}

template <class Tr>
int launch(const void* x, const float* t, float* out, int R, int n, int m,
           cudaStream_t s) {
  const size_t smem =
      (size_t)(TM_TILE + (m > 0 ? 2 * m - 1 : 0)) * sizeof(float);
  if (smem > TM_MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;              // the default limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        template_match_kernel<Tr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long bx = ((long long)n + TM_TILE - 1) / TM_TILE;
  const int by = R < 65535 ? R : 65535;            // rows stride beyond
  template_match_kernel<Tr><<<dim3((unsigned)bx, (unsigned)by), TM_TILE,
                              smem, s>>>(
      static_cast<const typename Tr::S*>(x), t, out, R, n, m);
  return 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int template_match_launch(const void* x, const float* t, float* out, int R,
                          int n, int m, int dtype, void* stream) {
  if (R == 0 || n == 0) return 0;
  if (R < 0 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  CPM_DISPATCH_DTYPE(dtype, { rc = launch<Tr>(x, t, out, R, n, m, s); });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
