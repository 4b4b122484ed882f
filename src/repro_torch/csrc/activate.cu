// §3.3 Rule 4, the general decoder: an (N,) activation mask (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:89 (activate, pallas_call at
// :94, body _activate_kernel at :83).
//
// What it computes: out[i] = start <= i <= end and (i - start) mod
// max(carry, 1) == 0, for i in [0, N), written as a bool (one byte, 0 or
// 1) — the TPU kernel's int8 mask already cast to bool.  The predicate is
// cpm_activate of cpm_ops.cuh (int32 difference, floor modulo), taken over
// runs of adjacent lanes by cpm_activate_lanes, the form fused_stream.cu's
// activate branch uses, so fused and eager masks are one body.
//
// What bounds it on the H100: device-memory bytes, N one-byte writes and
// nothing read but 12 bytes of bounds; at N = 1,048,576 that is 1 MB,
// 0.0003 ms at 3.35 TB/s, under a launch's few microseconds.  So a call
// costs its launch and its stores.
//
// What the design does about it:
//  * 16 lanes a thread, written with one 16-byte store (scalar stores only
//    on a ragged tail or a misaligned output).
//  * No modulo a lane: cpm_activate_lanes takes (i - start) mod carry once
//    for a thread's first lane and steps it; a run wholly outside [start,
//    end] writes zeros, and with carry 1 a run wholly inside writes ones.
//  * start, end and carry reach the kernel by value when the caller knows
//    them on the host (no stack of scalars on the device first), or as an
//    int32 (3,) tensor read on the device, as the TPU kernel reads p_ref:
//    a mask whose bounds come from an earlier kernel needs no host read,
//    so a call never synchronizes.

#include "cpm_ops.cuh"

#define ACT_THREADS 256
#define ACT_LANES 16

namespace {

__global__ void __launch_bounds__(ACT_THREADS)
activate_kernel(const int* __restrict__ params, int start, int end,
                int carry, uint8_t* __restrict__ out, int n) {
  if (params != nullptr) {
    start = params[0];
    end = params[1];
    carry = params[2];
  }
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long groups = ((long long)n + ACT_LANES - 1) / ACT_LANES;
  const long long stride = (long long)gridDim.x * ACT_THREADS;
  for (long long g = (long long)blockIdx.x * ACT_THREADS + threadIdx.x;
       g < groups; g += stride) {
    const int i0 = (int)(g * ACT_LANES);
    const uint32_t bits =
        cpm_activate_lanes<ACT_LANES>(i0, start, end, carry);
    if (vec && (long long)i0 + ACT_LANES <= n) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t b = bits >> (4 * k);
        w[k] = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) |
               ((b & 8u) << 21);
      }
      *reinterpret_cast<uint4*>(out + i0) = make_uint4(w[0], w[1], w[2],
                                                       w[3]);
    } else {
      for (int m = 0; m < ACT_LANES && (long long)i0 + m < n; ++m)
        out[i0 + m] = (bits >> m) & 1u;
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// `params`: an int32 (3,) tensor on the device, or null to take start,
// end and carry as given.
int activate_launch(const int* params, int start, int end, int carry,
                    void* out, int n, void* stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const long long groups = ((long long)n + ACT_LANES - 1) / ACT_LANES;
  long long blocks = (groups + ACT_THREADS - 1) / ACT_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;      // grid-stride beyond
  activate_kernel<<<(int)blocks, ACT_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      params, start, end, carry, static_cast<uint8_t*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
