// §3.3 Rule 4, the general decoder: an (N,) activation mask (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:89 (activate, pallas_call at
// :94, body _activate_kernel at :83).
//
// What it computes: out[i] = start <= i <= end and (i - start) mod
// max(carry, 1) == 0, for i in [0, N), written as a bool (one byte, 0 or
// 1) — the TPU kernel's int8 mask already cast to bool.  The predicate is
// cpm_activate of cpm_ops.cuh (int32 difference, floor modulo), the one
// fused_stream.cu's activate branch uses, so fused and eager masks are
// one body.  start, end and carry are an int32 (3,) tensor read on the
// device, as the TPU kernel reads p_ref: a mask whose bounds come from an
// earlier kernel needs no host read, so a call never synchronizes.
//
// What bounds it on the H100: device-memory bytes, N one-byte writes and
// nothing read but 12 bytes of bounds; at N = 1,048,576 that is 1 MB,
// 0.0003 ms at 3.35 TB/s, far under a launch's few microseconds.  So a
// call costs its launch.
//
// What the design does about it: the simplest right shape — one launch,
// a grid-stride loop of one lane a thread, the bounds loaded once a
// thread.  No shared memory.

#include "cpm_ops.cuh"

#define ACT_THREADS 256

namespace {

__global__ void __launch_bounds__(ACT_THREADS)
activate_kernel(const int* __restrict__ params, uint8_t* __restrict__ out,
                int n) {
  const int start = params[0], end = params[1], carry = params[2];
  const long long stride = (long long)gridDim.x * ACT_THREADS;
  for (long long i = (long long)blockIdx.x * ACT_THREADS + threadIdx.x;
       i < n; i += stride)
    out[i] = cpm_activate((int)i, start, end, carry) ? 1 : 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int activate_launch(const int* params, void* out, int n, void* stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  long long blocks = ((long long)n + ACT_THREADS - 1) / ACT_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;      // grid-stride beyond
  activate_kernel<<<(int)blocks, ACT_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      params, static_cast<uint8_t*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
