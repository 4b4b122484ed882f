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
// What the design does about it: a block owns a tile of one row,
// SHIFT_TILE_BYTES of output (4,096 int32 lanes), and decides once, from
// the row's bounds and the shift clamped to [-N, N], which of three cases
// the whole tile is (shift_tile_cases in kernels/cpm_kernels.py is the
// same rule in Python):
//   (a) no lane of the tile receives moved content or the fill: a copy,
//       out[i] = x[i];
//   (b) every lane receives moved content: out[i] = x[i - shift];
//   (c) a boundary of the moved range, the fill range or the row: every
//       lane runs cpm_shift_src.
// (a) and (b) are one offset copy out[i] = x[i - d].  Its output is
// written as aligned 16-byte vectors, four a thread in flight; the lanes
// before the row's first 16-byte boundary and after its last one (rows
// whose byte length is not a multiple of 16) go lane by lane.  Where the
// source is as aligned as the output (d = 0 on equally aligned rows, or
// d a multiple of 16 bytes) the vectors go straight from device memory to
// device memory.  Otherwise the source span, the tile plus one vector, is
// staged in shared memory with aligned 16-byte loads, and each output
// vector is funnel-shifted out of two aligned shared-memory vectors by
// the block's one byte offset.  No lane takes a modulo; the per-block
// decision is a few 64-bit compares.

#include "cpm_ops.cuh"

#define SHIFT_THREADS 256
// must equal SHIFT_TILE_BYTES in repro_torch/kernels/cpm_kernels.py
#define SHIFT_TILE_BYTES 16384
#define SHIFT_VECS (SHIFT_TILE_BYTES / 16)
#define SHIFT_UNROLL (SHIFT_VECS / SHIFT_THREADS)

namespace {

template <int O>
__device__ __forceinline__ uint4 funnel4(const uint32_t (&w)[8], int sh) {
  return make_uint4(__funnelshift_r(w[O], w[O + 1], sh),
                    __funnelshift_r(w[O + 1], w[O + 2], sh),
                    __funnelshift_r(w[O + 2], w[O + 3], sh),
                    __funnelshift_r(w[O + 3], w[O + 4], sh));
}

// The 16 bytes at byte `off` (0 <= off < 16) of the 32 bytes a, then b.
__device__ __forceinline__ uint4 bytes_at(uint4 a, uint4 b, int off) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int sh = (off & 3) * 8;
  switch (off >> 2) {
    case 0: return funnel4<0>(w, sh);
    case 1: return funnel4<1>(w, sh);
    case 2: return funnel4<2>(w, sh);
    default: return funnel4<3>(w, sh);
  }
}

// out[i] = x[i - d] for the lanes [lo, hi) of one row, every source lane
// inside the row; `a` is the tile's first lane at a 16-byte boundary of
// the output.
template <typename W>
__device__ __forceinline__ void offset_copy(const W* __restrict__ xr,
                                            W* __restrict__ orow,
                                            long long lo, long long hi,
                                            long long a, long long d,
                                            uint4* stage) {
  constexpr int V = 16 / sizeof(W);
  const int t = threadIdx.x;
  const int J = (int)((hi - a) / V);             // whole output vectors
  const long long e = a + (long long)J * V;
  if (t < a - lo) orow[lo + t] = xr[lo + t - d];  // head lanes
  if (t < hi - e) orow[e + t] = xr[e + t - d];    // tail lanes
  if (J <= 0) return;
  const long long p = a - d;                     // first source lane
  const int off = (int)(((uintptr_t)(xr + p) & 15) / sizeof(W));
  uint4* ov = reinterpret_cast<uint4*>(orow + a);
  if (off == 0) {                                // source as aligned
    const uint4* xv = reinterpret_cast<const uint4*>(xr + p);
    uint4 v[SHIFT_UNROLL];
#pragma unroll
    for (int u = 0; u < SHIFT_UNROLL; ++u) {
      const int j = t + u * SHIFT_THREADS;
      if (j < J) v[u] = xv[j];
    }
#pragma unroll
    for (int u = 0; u < SHIFT_UNROLL; ++u) {
      const int j = t + u * SHIFT_THREADS;
      if (j < J) ov[j] = v[u];
    }
    return;
  }
  // stage chunks 0 .. J of the source: chunk k holds lanes p0 + kV ..
  // p0 + kV + V - 1, p0 = p - off at a 16-byte boundary of x.  Chunks
  // 1 .. J-1 are whole aligned loads; of chunk 0 only the lanes from p,
  // of chunk J only those before p + JV are in the row's span and read.
  const long long p0 = p - off;
  uint4 v[SHIFT_UNROLL + 1];
#pragma unroll
  for (int u = 0; u <= SHIFT_UNROLL; ++u) {
    const int k = t + u * SHIFT_THREADS;
    if (k > 0 && k < J)
      v[u] = *reinterpret_cast<const uint4*>(xr + (p0 + (long long)k * V));
  }
#pragma unroll
  for (int u = 0; u <= SHIFT_UNROLL; ++u) {
    const int k = t + u * SHIFT_THREADS;
    if (k > 0 && k < J) stage[k] = v[u];
  }
  W* sw = reinterpret_cast<W*>(stage);
  if (t < V) {
    if (t >= off) sw[t] = xr[p0 + t];
    else sw[(long long)J * V + t] = xr[p0 + (long long)J * V + t];
  }
  __syncthreads();
  const int boff = off * (int)sizeof(W);
#pragma unroll
  for (int u = 0; u < SHIFT_UNROLL; ++u) {
    const int j = t + u * SHIFT_THREADS;
    if (j < J) ov[j] = bytes_at(stage[j], stage[j + 1], boff);
  }
}

template <typename W>
__global__ void __launch_bounds__(SHIFT_THREADS)
shift_range_kernel(const W* __restrict__ x, W* __restrict__ out,
                   const int* __restrict__ se, int se_stride,
                   const W* __restrict__ fill, int R, int n, int shift) {
  constexpr int T = SHIFT_TILE_BYTES / sizeof(W);      // lanes a tile
  __shared__ uint4 stage[SHIFT_VECS + 1];
  const bool has_fill = fill != nullptr;
  const W f = has_fill ? *fill : W(0);
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const int start = se[(long long)row * se_stride];
    const int end = se[(long long)row * se_stride + 1];
    const W* xr = x + (long long)row * n;
    W* orow = out + (long long)row * n;
    // tile b covers lanes [lo, hi): tile 0 from lane 0 through the first
    // whole tile after the head (the lanes before the row's first 16-byte
    // boundary), tile b > 0 the b-th whole tile after the head
    const int head = (int)(((16 - ((uintptr_t)orow & 15)) & 15) / sizeof(W));
    const long long lo = blockIdx.x == 0
        ? 0 : head + (long long)blockIdx.x * T;
    const long long hi = min((long long)n,
                             head + ((long long)blockIdx.x + 1) * T);
    if (lo >= hi) continue;                      // uniform in the block
    const long long a = blockIdx.x == 0 ? min((long long)head, hi) : lo;
    // the block's case: the lanes that receive moved content [dlo, dhi]
    // and the lanes that take the fill [slo, shi] \ [dlo, dhi]
    const long long slo = max(start, 0), shi = min(end, n - 1);
    const long long dlo = max(slo + shift, 0LL);
    const long long dhi = min(shi + shift, (long long)n - 1);
    if (dlo <= lo && hi - 1 <= dhi) {            // (b) all moved
      offset_copy<W>(xr, orow, lo, hi, a, shift, stage);
    } else if ((hi - 1 < dlo || lo > dhi) &&
               (!has_fill || hi - 1 < slo || lo > shi)) {
      offset_copy<W>(xr, orow, lo, hi, a, 0, stage);   // (a) a copy
    } else {                                     // (c) lane by lane
      for (long long i = lo + threadIdx.x; i < hi; i += SHIFT_THREADS) {
        const int src = cpm_shift_src((int)i, n, start, end, shift,
                                      has_fill);
        orow[i] = src < 0 ? f : xr[src];
      }
    }
    __syncthreads();                             // `stage` is reused
  }
}

template <typename W>
void launch(const void* x, void* out, const int* se, int se_stride,
            const void* fill, int R, int n, int shift, cudaStream_t s) {
  constexpr int T = SHIFT_TILE_BYTES / sizeof(W);
  // a row of n lanes spans at most ceil(n / T) tiles, whatever its head
  const long long bx = ((long long)n + T - 1) / T;
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
  // |shift| >= n moves nothing into the row, as shift = +-n does; after
  // the clamp every index of the kernel fits its arithmetic
  shift = shift > n ? n : (shift < -n ? -n : shift);
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
