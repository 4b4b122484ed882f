// §7.3 tap stencil over every (R, N) row (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:585 (stencil, pallas_call at
// :594, body _stencil_kernel at :563 over _stencil_vals).
//
// What it computes: out[r, i] = sum over the taps k, in the order of the
// tuple and skipping zero taps, of w_k * x[r, i - (k - c)] (c = taps / 2,
// the index wrapping at the row ends), over the row cast to float32; with
// wrap = False a lane that wrapped around reads 0 (zero padding).  Every
// product and sum is rounded as written — cpm_stencil_lanes of
// cpm_ops.cuh, the accumulation fused_stream.cu's stencil branch runs
// through cpm_stencil, with the same lane rule cpm_stencil_lane — and
// this file is built with -fmad=false, so no multiply-add contracts and
// every result equals the plain twin and the fused stream bit for bit.
// The taps come as float32 values by value in the launch (at most
// ST_MAX_TAPS); the row takes any dtype of the CPM kernels.
//
// What bounds it on the H100: device-memory bytes — each element is read
// once and each float32 result written once; the 2 operations a nonzero
// tap a lane (a multiply, an add) are fewer up to some forty taps.  At
// chip_smoke's (64, 1,048,576) float32 rows and three taps that is 268.4
// MB in and 268.4 MB out, 0.160 ms at 3.35 TB/s (0.012 ms of operations
// at 67e12/s).
//
// What the design does about it: a block owns a tile of ST_TILE outputs
// of one row and stages, converted to float32, the positions the tile
// reads — the tile plus ntaps - 1 - c lanes of halo before it and c after
// it — in shared memory, each element loaded once: the part inside the
// row in aligned 16-byte loads, the rest lane by lane.  The wrap or the
// zero padding is applied once a staged position (cpm_stencil_lane: one
// add or subtract of N, a floor modulo only for rows shorter than the
// taps), not once a tap a lane.  Each thread then computes ST_OUT
// adjacent outputs from shared memory, one read a tap through a sliding
// window of registers, and writes them as one 16-byte vector (lane by
// lane where the row's outputs are not 16-byte aligned).

#include "cpm_ops.cuh"

#define ST_THREADS 256
#define ST_OUT 4                           // adjacent outputs a thread
#define ST_GROUPS 2                        // groups of them a thread
// must equal STENCIL_TILE in repro_torch/kernels/cpm_kernels.py
#define ST_TILE (ST_THREADS * ST_OUT * ST_GROUPS)
#define ST_MAX_TAPS 64
// the tile, its halo (at most ST_MAX_TAPS - 1) and an alignment pad of < 4
#define ST_STAGE (ST_TILE + ST_MAX_TAPS + 4)

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
  using S = typename Tr::S;
  constexpr int V = 16 / sizeof(S);                    // 4, 8 or 16 lanes
  struct alignas(16) Chunk { S e[V]; };
  constexpr int U = (ST_TILE + ST_MAX_TAPS) / V / ST_THREADS + 1;
  __shared__ __align__(16) float st[ST_STAGE];
  const int t = threadIdx.x;
  const int ntaps = taps.ntaps, c = ntaps / 2;
  const int L = ntaps > 0 ? ntaps - 1 - c : 0;         // halo before
  const bool wrap = taps.wrap != 0;
  const long long t0 = (long long)blockIdx.x * ST_TILE;
  const long long base = t0 - L;             // position of staged slot 0
  const long long stop = t0 + ST_TILE + c;   // staged positions end
  // positions from `live` on are read by no output inside the row
  const long long live = min(t0 + ST_TILE, (long long)n) + c;
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const S* xr = x + (long long)row * n;
    float* orow = out + (long long)row * n;
    // the whole 16-byte chunks of x among the staged positions inside the
    // row: [vlo, vhi), vlo at the first 16-byte boundary from max(base, 0)
    const long long in_lo = max(base, 0LL), in_hi = min(live, (long long)n);
    const int ax = (int)(((16 - ((uintptr_t)(xr + in_lo) & 15)) & 15)
                         / sizeof(S));
    const long long vlo = min(in_lo + ax, in_hi);
    const int nch = (int)((in_hi - vlo) / V);
    const long long vhi = vlo + (long long)nch * V;
    // position q sits in st[pad + (q - base)]; pad puts every chunk on a
    // 16-byte slot of st (V is a multiple of 4)
    const int pad = (4 - (int)((vlo - base) & 3)) & 3;
    auto slot = [&](long long q) { return pad + (int)(q - base); };
    {
      const Chunk* xv = reinterpret_cast<const Chunk*>(xr + vlo);
      Chunk v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = t + u * ST_THREADS;
        if (k < nch) v[u] = xv[k];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = t + u * ST_THREADS;
        if (k < nch) {
          float4* dst = reinterpret_cast<float4*>(
              st + slot(vlo + (long long)k * V));
#pragma unroll
          for (int g = 0; g < V / 4; ++g)
            dst[g] = make_float4(Tr::acc(v[u].e[4 * g]),
                                 Tr::acc(v[u].e[4 * g + 1]),
                                 Tr::acc(v[u].e[4 * g + 2]),
                                 Tr::acc(v[u].e[4 * g + 3]));
        }
      }
    }
    // the other staged positions, lane by lane: the halo outside the row
    // (wrapped or zero), the unaligned ends, and nothing past `live`
    auto put = [&](long long q) {
      float val = 0.f;
      if (q < live) {
        const int j = cpm_stencil_lane(q, n, wrap);
        if (j >= 0) val = (float)Tr::acc(xr[j]);
      }
      st[slot(q)] = val;
    };
    for (long long q = base + t; q < vlo; q += ST_THREADS) put(q);
    for (long long q = vhi + t; q < stop; q += ST_THREADS) put(q);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < ST_GROUPS; ++g) {
      const long long i0 = t0 + (long long)ST_OUT * (t + g * ST_THREADS);
      if (i0 >= n) break;
      float acc[ST_OUT];
      const float* s0 = st + slot(i0);
      cpm_stencil_lanes<ST_OUT>(acc, taps.w, ntaps,
                                [&](int d) { return s0[d]; });
      if (i0 + ST_OUT <= n && ((uintptr_t)(orow + i0) & 15) == 0) {
#pragma unroll
        for (int v = 0; v < ST_OUT; v += 4)
          *reinterpret_cast<float4*>(orow + i0 + v) =
              make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
      } else {
#pragma unroll
        for (int m = 0; m < ST_OUT; ++m)
          if (i0 + m < n) orow[i0 + m] = acc[m];
      }
    }
    __syncthreads();                         // `st` is restaged
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
  const long long bx = ((long long)n + ST_TILE - 1) / ST_TILE;
  const int by = R < 65535 ? R : 65535;          // rows stride beyond
  CPM_DISPATCH_DTYPE(dtype, {
    stencil_kernel<Tr><<<dim3((unsigned)bx, (unsigned)by), ST_THREADS, 0,
                         s>>>(static_cast<const typename Tr::S*>(x), out, R,
                              n, *taps);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
