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
// int32 rows, issuing the float32 instructions: SAD has no multiply-add to
// pair, so each (lane, j) is two instructions (a subtraction, and an add
// that takes the absolute value as an operand modifier), 8.6 G at the
// 33.5e12 a second that the 67e12/s peak implies: 0.256 ms.  (The 3·M
// operations a lane at 67e12/s give 0.192 ms; the bytes, 268.4 MB in and
// 268.4 MB out, 0.160 ms, which bound M = 4 and 16.)
//
// What the design does about it: a block owns a tile of TM_TILE outputs
// of every gridDim.y-th row (about TM_ROWS rows) and stages, converted to
// float32, the positions a row's tile reads — the tile and the M + 3
// lanes after it, rounded up to 4 — in shared memory, each element loaded
// once: the part inside the row in aligned 16-byte loads (the next row's
// in flight while this row's outputs are computed), the rest lane by
// lane.  A staged position past the row end wraps with one subtraction
// of N; the floor modulo is kept for rows shorter than the staged span (a
// block-uniform test).  Each thread then computes TM_OUT adjacent
// outputs: the j loop runs in chunks of 4 items, a window of TM_OUT + 4
// staged values sliding through registers (one 16-byte shared read of 4
// new values a chunk) and the chunk's 4 template items read as one
// broadcast 16-byte shared read, so each (lane, j) costs its two float32
// instructions and 1/(2 TM_OUT) of a shared read.  The template is staged
// in chunks of TM_TCH items (once a block when M <= TM_TCH).  The outputs
// leave through shared memory, so that a warp stores 512 contiguous bytes
// an instruction.

#include "cpm_ops.cuh"

#define TM_THREADS 256
#define TM_OUT 8                              // adjacent outputs a thread
// must equal TEMPLATE_TILE / TEMPLATE_CHUNK in
// repro_torch/kernels/cpm_kernels.py
#define TM_TILE (TM_THREADS * TM_OUT)
#define TM_TCH 2048                           // template items staged
#define TM_ROWS 4                             // rows a block, about
#define TM_MAX_SMEM 232448

namespace {

// staged x positions of a tile: the tile, then M + 3, rounded up to 4
__host__ __device__ __forceinline__ int tm_span(int m) {
  return (TM_TILE + m + 3 + 3) & ~3;
}
__host__ __device__ __forceinline__ int tm_tch(int m) {
  return m < TM_TCH ? (m + 3) & ~3 : TM_TCH;
}
// shared floats of a block: the staged span, then the template chunk
__host__ __device__ __forceinline__ int tm_smem_floats(int m) {
  return tm_span(m) + tm_tch(m);
}

// acc[i] += |win[i + q] - t[q]| for the q < nq items of a chunk, in order
template <int K>
__device__ __forceinline__ void tm_chunk(float (&acc)[K],
                                         const float (&win)[K + 4],
                                         float4 t4, int nq) {
  const float tq[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= nq) break;
#pragma unroll
    for (int i = 0; i < K; ++i)
      acc[i] = __fadd_rn(acc[i], fabsf(__fsub_rn(win[i + q], tq[q])));
  }
}

template <class Tr>
__global__ void __launch_bounds__(TM_THREADS)
template_match_kernel(const typename Tr::S* __restrict__ x,
                      const float* __restrict__ t, float* __restrict__ out,
                      int R, int n, int m) {
  using S = typename Tr::S;
  constexpr int V = 16 / sizeof(S);                    // 4, 8 or 16 lanes
  constexpr int K = TM_OUT;
  // 16-byte chunks a thread holds in flight: a tile with a halo of up to
  // 128 lanes; a longer halo's chunks load when they are staged
  constexpr int UP = (TM_TILE + 128) / V / TM_THREADS + 1;
  struct alignas(16) Chunk { S e[V]; };
  extern __shared__ __align__(16) float smem[];
  const int span = tm_span(m), tch = tm_tch(m);
  float* xs = smem;                                    // [span]
  float* ts = smem + span;                             // [tch]
  const int tid = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * TM_TILE;
  const bool short_row = n < span;                     // block-uniform
  const bool one_chunk = m <= TM_TCH;
  const long long in_hi = min(b0 + span, (long long)n);

  auto stage_t = [&](int jc) {
    for (int j = tid; j < tch; j += TM_THREADS)
      ts[j] = jc + j < m && j < TM_TCH ? t[jc + j] : 0.f;
  };
  if (one_chunk) stage_t(0);

  // a row's whole 16-byte chunks among the staged positions inside it:
  // [vlo, vlo + nch * V), vlo at the first 16-byte boundary from b0
  struct Span { long long vlo; int nch; int ax; };
  auto span_of = [&](int row) {
    const S* xr = x + (long long)row * n;
    Span sp;
    sp.ax = (int)(((16 - ((uintptr_t)(xr + b0) & 15)) & 15) / sizeof(S));
    sp.vlo = min(b0 + sp.ax, in_hi);
    sp.nch = (int)((in_hi - sp.vlo) / V);
    return sp;
  };
  // the next row's first UP chunks a thread stages load while this row's
  // outputs are computed
  Chunk pf[UP];
  auto prefetch = [&](int row, const Span& sp) {
    const Chunk* xv =
        reinterpret_cast<const Chunk*>(x + (long long)row * n + sp.vlo);
#pragma unroll
    for (int u = 0; u < UP; ++u)
      if (tid + u * TM_THREADS < sp.nch) pf[u] = xv[tid + u * TM_THREADS];
  };
  // chunk c holds staged positions rel .. rel + V - 1 (from b0)
  auto put_chunk = [&](const Chunk& c, int rel, bool vec_st) {
    if (vec_st) {
#pragma unroll
      for (int g = 0; g < V / 4; ++g)
        *reinterpret_cast<float4*>(xs + rel + 4 * g) = make_float4(
            Tr::acc(c.e[4 * g]), Tr::acc(c.e[4 * g + 1]),
            Tr::acc(c.e[4 * g + 2]), Tr::acc(c.e[4 * g + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) xs[rel + e] = Tr::acc(c.e[e]);
    }
  };

  int row = blockIdx.y;
  Span sp = span_of(row < R ? row : 0);
  if (row < R) prefetch(row, sp);
  for (; row < R; row += gridDim.y) {
    const S* xr = x + (long long)row * n;
    float* orow = out + (long long)row * n;
    const bool vec_st = (sp.ax & 3) == 0;  // chunks land on 16-byte slots
    {
      const int rel0 = (int)(sp.vlo - b0);
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        const int k = tid + u * TM_THREADS;
        if (k < sp.nch) put_chunk(pf[u], rel0 + k * V, vec_st);
      }
      const Chunk* xv = reinterpret_cast<const Chunk*>(xr + sp.vlo);
      for (int k = tid + UP * TM_THREADS; k < sp.nch; k += TM_THREADS)
        put_chunk(xv[k], rel0 + k * V, vec_st);
    }
    // the other staged positions, lane by lane: the unaligned ends inside
    // the row and the positions past its end, wrapped
    auto put = [&](long long q) {
      long long j = q;
      if (j >= n) j = short_row ? q % n : q - n;
      xs[q - b0] = (float)Tr::acc(xr[j]);
    };
    const long long vhi = sp.vlo + (long long)sp.nch * V;
    for (long long q = b0 + tid; q < sp.vlo; q += TM_THREADS) put(q);
    for (long long q = vhi + tid; q < b0 + span; q += TM_THREADS) put(q);
    __syncthreads();
    const int next = row + gridDim.y;
    if (next < R) {
      sp = span_of(next);
      prefetch(next, sp);
    }

    // the 4 staged values at rel (a multiple of 4) from this thread's first
    auto win4 = [&](int rel) {
      return *reinterpret_cast<const float4*>(xs + tid * K + rel);
    };
    float acc[K], win[K + 4];
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = 0.f;
#pragma unroll
    for (int g = 0; g < K / 4; ++g) {
      const float4 w = win4(4 * g);
      win[4 * g] = w.x, win[4 * g + 1] = w.y;
      win[4 * g + 2] = w.z, win[4 * g + 3] = w.w;
    }
    for (int jc = 0; jc < m; jc += TM_TCH) {
      if (!one_chunk) {
        __syncthreads();                       // the last chunk is read
        stage_t(jc);
        __syncthreads();
      }
      const int je = min(m - jc, TM_TCH);
      // whole chunks of 4 items (unrolled by the window's period of
      // (K + 4) / 4 chunks, so it slides without moves), then the rest
      auto step = [&](int j, int nq) {
        const float4 w = win4(jc + j + K);
        win[K] = w.x, win[K + 1] = w.y, win[K + 2] = w.z, win[K + 3] = w.w;
        tm_chunk<K>(acc, win, *reinterpret_cast<const float4*>(ts + j), nq);
#pragma unroll
        for (int i = 0; i < K; ++i) win[i] = win[i + 4];
      };
      const int jw = je & ~3;
#pragma unroll 3
      for (int j = 0; j < jw; j += 4) step(j, 4);
      if (jw < je) step(jw, je - jw);
    }

    // the outputs leave through shared memory, so that a warp writes 512
    // contiguous bytes an instruction
    __syncthreads();                           // xs is read
#pragma unroll
    for (int g = 0; g < K / 4; ++g)
      reinterpret_cast<float4*>(xs + tid * K)[g] = make_float4(
          acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
    __syncthreads();
    if (b0 + TM_TILE <= n && ((uintptr_t)(orow + b0) & 15) == 0) {
#pragma unroll
      for (int g = 0; g < K / 4; ++g) {
        const int o = 4 * (tid + g * TM_THREADS);
        *reinterpret_cast<float4*>(orow + b0 + o) =
            *reinterpret_cast<const float4*>(xs + o);
      }
    } else {
      for (int o = tid; o < TM_TILE; o += TM_THREADS)
        if (b0 + o < n) orow[b0 + o] = xs[o];
    }
    __syncthreads();                           // xs is restaged
  }
}

template <class Tr>
int launch(const void* x, const float* t, float* out, int R, int n, int m,
           cudaStream_t s) {
  const size_t smem = (size_t)tm_smem_floats(m) * sizeof(float);
  if (smem > TM_MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;              // the default limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        template_match_kernel<Tr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  // a block takes every gridDim.y-th row of its tile, about TM_ROWS rows
  const long long bx = ((long long)n + TM_TILE - 1) / TM_TILE;
  const int by = min((R + TM_ROWS - 1) / TM_ROWS, 65535);
  template_match_kernel<Tr><<<dim3((unsigned)bx, (unsigned)by),
                              TM_THREADS, smem, s>>>(
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
