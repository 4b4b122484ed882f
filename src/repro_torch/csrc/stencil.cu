// §7.3 tap stencil over every (R, N) row (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:585 (stencil, pallas_call at
// :594, body _stencil_kernel at :563 over _stencil_vals).
//
// What it computes: out[r, i] = sum over the taps k, in the order of the
// tuple and skipping zero taps, of w_k * x[r, i - (k - c)] (c = taps / 2,
// the index wrapping at the row ends), over the row cast to float32; with
// wrap = False a lane that wrapped around reads 0 (zero padding).  Every
// product and sum is rounded as written — the lane rule cpm_stencil of
// cpm_ops.cuh, the one fused_stream.cu's stencil branch uses — and this
// file is built with -fmad=false, so no multiply-add contracts and every
// result equals the plain twin and the fused stream bit for bit.  The
// taps come as float32 values by value in the launch (at most
// ST_MAX_TAPS); the row takes any dtype of the CPM kernels.
//
// What bounds it on the H100: device-memory bytes — each element is read
// once and each float32 result written once; the 2 operations a nonzero
// tap a lane (a multiply, an add) are fewer.  At chip_smoke's (64,
// 1,048,576) float32 rows and three taps that is 268.4 MB in and 268.4 MB
// out, 0.160 ms at 3.35 TB/s (0.012 ms of operations at 67e12/s).
//
// What the design does about it: one thread per output lane, a grid over
// the lanes of a row times the rows; a warp's tap reads are 32
// neighbouring elements a few lanes apart, which the L1 cache serves
// after the first tap, so device memory sees each element about once.
// No shared memory.

#include "cpm_ops.cuh"

#define ST_THREADS 256
#define ST_MAX_TAPS 64

// Layout mirrored by ctypes in repro_torch/kernels/cpm_kernels.py.
struct StTaps {
  int ntaps, wrap;
  float w[ST_MAX_TAPS];
};

namespace {

template <class Tr>
__global__ void __launch_bounds__(ST_THREADS)
stencil_kernel(const typename Tr::S* __restrict__ x, float* __restrict__ out,
               int R, int n, const __grid_constant__ StTaps taps) {
  const long long lane_stride = (long long)gridDim.x * ST_THREADS;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const typename Tr::S* xr = x + (long long)row * n;
    float* orow = out + (long long)row * n;
    for (long long i = (long long)blockIdx.x * ST_THREADS + threadIdx.x;
         i < n; i += lane_stride)
      orow[i] = cpm_stencil((int)i, n, taps.w, taps.ntaps, taps.wrap != 0,
                            [&](int j) { return (float)Tr::acc(xr[j]); });
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int stencil_launch(const void* x, float* out, int R, int n, int dtype,
                   const StTaps* taps, void* stream) {
  if (R == 0 || n == 0) return 0;
  if (R < 0 || n < 0 || taps->ntaps < 0 || taps->ntaps > ST_MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long bx = ((long long)n + ST_THREADS - 1) / ST_THREADS;
  if (bx > 132 * 16) bx = 132 * 16;              // grid-stride beyond
  const int by = R < 65535 ? R : 65535;          // rows stride beyond
  CPM_DISPATCH_DTYPE(dtype, {
    stencil_kernel<Tr><<<dim3((unsigned)bx, (unsigned)by), ST_THREADS, 0,
                         s>>>(static_cast<const typename Tr::S*>(x), out, R,
                              n, *taps);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
