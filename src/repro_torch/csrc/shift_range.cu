// §4.1 concurrent range move of every (R, N) row (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:133 (shift_range,
// pallas_call at :145, body _shift_range_kernel at :127).
//
// What it computes: a new (R, N) array whose lane i of each row is
// x[i - shift] where i - shift lies in [start, end] (and i inside the
// row); where lane i lay in [start, end] but received nothing it takes
// `fill` when one is given; every other lane keeps x[i].  Content moved
// past either row end is dropped; `shift` is static and may be 0 or reach
// |shift| >= N.  The lane rule is cpm_shift_src of cpm_ops.cuh, the one
// fused_stream.cu's shift / insert / delete branches use, so fused and
// eager moves are one body.  Elements move as 1-, 2-, 4- or 8-byte words
// (rows.cu's rule), so every dtype moves bit for bit, bool and bfloat16
// included; `fill` comes already cast to the row's dtype (the JAX kernel's
// jnp.asarray(fill, x.dtype)).  start and end are int32 pairs read on
// the device, as the TPU kernel reads p_ref: one (1, 2) pair for every
// row (se_stride 0), or an (R, 2) pair a row (se_stride 2), which is how
// a batched device with per-row lengths moves all its rows in one launch
// where the JAX package vmaps the kernel.  CPMArray.insert passes
// used_len - 1, a device value, so an eager commit on the generate path
// never synchronizes with the host.
//
// What bounds it on the H100: device-memory bytes — each row is read once
// and written once.  At chip_smoke's (64, 1,048,576) int32 rows that is
// 268.4 MB in and 268.4 MB out, 0.160 ms at 3.35 TB/s.
//
// What the design does about it: out of place, one thread per output lane
// (a grid over the lanes of a row times the rows), so a warp writes 32
// neighbouring words and reads 32 neighbouring words `shift` lanes away:
// both coalesced, each byte read and written once.  No shared memory;
// the bounds and the fill are loaded once a thread.

#include "cpm_ops.cuh"

#define SHIFT_THREADS 256

namespace {

template <typename W>
__global__ void __launch_bounds__(SHIFT_THREADS)
shift_range_kernel(const W* __restrict__ x, W* __restrict__ out,
                   const int* __restrict__ se, int se_stride,
                   const W* __restrict__ fill, int R, int n, int shift) {
  const bool has_fill = fill != nullptr;
  const W f = has_fill ? *fill : W(0);
  const long long lane_stride = (long long)gridDim.x * SHIFT_THREADS;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const int start = se[(long long)row * se_stride];
    const int end = se[(long long)row * se_stride + 1];
    const W* xr = x + (long long)row * n;
    W* orow = out + (long long)row * n;
    for (long long i = (long long)blockIdx.x * SHIFT_THREADS + threadIdx.x;
         i < n; i += lane_stride) {
      const int src = cpm_shift_src((int)i, n, start, end, shift, has_fill);
      orow[i] = src < 0 ? f : xr[src];
    }
  }
}

template <typename W>
void launch(const void* x, void* out, const int* se, int se_stride,
            const void* fill, int R, int n, int shift, cudaStream_t s) {
  long long bx = ((long long)n + SHIFT_THREADS - 1) / SHIFT_THREADS;
  if (bx > 132 * 16) bx = 132 * 16;              // grid-stride beyond
  const int by = R < 65535 ? R : 65535;          // rows stride beyond
  shift_range_kernel<W><<<dim3((unsigned)bx, (unsigned)by), SHIFT_THREADS,
                          0, s>>>(
      static_cast<const W*>(x), static_cast<W*>(out), se, se_stride,
      static_cast<const W*>(fill), R, n, shift);
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// `fill` is null for no fill, else one element of the row's dtype;
// `se_stride` is 0 (one start/end pair) or 2 (a pair a row).
int shift_range_launch(const void* x, void* out, const int* se,
                       int se_stride, const void* fill, int R, int n,
                       int shift, int itemsize, void* stream) {
  if (R == 0 || n == 0) return 0;
  if (R < 0 || n < 0 || (se_stride != 0 && se_stride != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1:
      launch<uint8_t>(x, out, se, se_stride, fill, R, n, shift, s);
      break;
    case 2:
      launch<uint16_t>(x, out, se, se_stride, fill, R, n, shift, s);
      break;
    case 4:
      launch<uint32_t>(x, out, se, se_stride, fill, R, n, shift, s);
      break;
    case 8:
      launch<uint64_t>(x, out, se, se_stride, fill, R, n, shift, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
