// §6.3 histogram of (R, N) rows against M+1 edges (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:315 (histogram, pallas_call
// at :331, body _histogram_kernel at :299).
//
// What it computes: per row, bins[i] = C(e[i+1]) - C(e[i]) for i < M,
// where C(e) counts the row's lanes v with v < e, the row padded to whole
// `section`s with the top edge e[M], in int32.  Rows and edges arrive in
// one dtype (the wrapper promotes them, as the TPU wrapper does); the
// compare widens both exactly (cpm_ops.cuh traits).  This is the
// difference-of-counts form of the TPU kernel (M+1 broadcast compares and
// counts, then differences), which fixes what NaN values (counted under
// no edge) and edges out of order give; a bin search would change both.
// The pad lanes are not read: each counts under the edges above e[M],
// so pad * (e[M] < e[j]) is added to C(e[j]).
//
// The TPU kernel accumulates its (1, M) bins across the in-order section
// axis (pl.when(j == 0) ... the last step).  CUDA blocks run in no order,
// so this is a split pass with no atomics: pass 1 gives each block a run
// of whole sections of one row and writes its int32 counts C_p(e[j]);
// pass 2 (one thread per output bin) adds the row's parts in order, the
// pad, and takes the difference.  The counts are exact in any order.
//
// What bounds it on the H100: the compares at M >= 8 — R * N * (M+1)
// compare-and-count pairs against R * N * elem bytes.  At chip_smoke's
// (64, 1,048,576) int32 rows with M = 64: 4.4e9 compares (0.13 ms at 67e12
// operations/s, counting two a lane-edge) against 268 MB (0.080 ms).
//
// What the design does about it: a block stages a tile of HIST_TILE
// lanes in shared memory with coalesced loads, the next tile waiting in
// registers while the current one is counted; its threads split into
// G = blockDim / (M+1) groups of M+1 (one edge each, edge and count in
// registers), group g counting a contiguous run of the tile with 16-byte
// shared-memory reads (a broadcast within a group), so a compare costs
// about a quarter of a read, a compare and an add.  With M+1 > blockDim
// each thread keeps up to HIST_MAX_EPT edges.  The group counts are
// combined in shared memory in a fixed order.

#include <type_traits>

#include "cpm_ops.cuh"

#define HIST_THREADS 512
#define HIST_TILE 4096
#define HIST_MAX_EPT 8                    // edges a thread keeps
#define HIST_MAX_EDGES (HIST_THREADS * HIST_MAX_EPT)

namespace {

// Pass 1: block b counts run p = b % parts of row r = b / parts.
// counts: (R * parts, E) int32; smem: E edges + HIST_TILE lanes (as A)
// + G * E int counts.
template <class Tr>
__global__ void __launch_bounds__(HIST_THREADS)
hist_count(const typename Tr::S* __restrict__ x,
           const typename Tr::S* __restrict__ edges,
           int* __restrict__ counts, long long n, long long part_len,
           int parts, int E) {
  using A = typename Tr::A;
  using V4 = typename std::conditional<std::is_same<A, float>::value,
                                       float4, int4>::type;
  constexpr int T = HIST_THREADS, PER = HIST_TILE / HIST_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* tile = reinterpret_cast<A*>(smem_raw);
  A* es = tile + HIST_TILE;
  int* red = reinterpret_cast<int*>(es + E);

  const int tid = threadIdx.x;
  const long long r = blockIdx.x / parts, p = blockIdx.x % parts;
  const long long lo = p * part_len;
  const long long len = (lo + part_len < n ? lo + part_len : n) - lo;
  const typename Tr::S* run = x + r * n + lo;

  for (int j = tid; j < E; j += T) es[j] = Tr::acc(edges[j]);
  // groups of E threads, one edge each; or one group, EPT edges each
  const int G = E <= T ? T / E : 1;
  const int ept = E <= T ? 1 : (E + T - 1) / T;
  const bool active = E <= T ? tid < G * E : true;
  const int g = E <= T ? tid / E : 0;
  const int j0 = E <= T ? tid % E : tid;
  __syncthreads();
  A e[HIST_MAX_EPT];
  int c[HIST_MAX_EPT], c2 = 0;
#pragma unroll
  for (int k = 0; k < HIST_MAX_EPT; ++k) {
    const int j = j0 + k * T;
    e[k] = (k < ept && j < E) ? es[j] : es[0];
    c[k] = 0;
  }

  // the next tile waits in registers while the current one is counted
  A nxt[PER];
  auto fetch = [&](long long t0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const long long i = t0 + tid + k * T;
      nxt[k] = i < len ? Tr::acc(run[i]) : A(0);
    }
  };
  fetch(0);
  for (long long t0 = 0; t0 < len; t0 += HIST_TILE) {
    const int tl = (int)(len - t0 < HIST_TILE ? len - t0 : HIST_TILE);
#pragma unroll
    for (int k = 0; k < PER; ++k) tile[tid + k * T] = nxt[k];
    __syncthreads();
    if (t0 + HIST_TILE < len) fetch(t0 + HIST_TILE);
    // group g counts a contiguous run of q lanes (16-byte reads), then
    // the groups share the remainder
    const int q = (tl / G) & ~3;
    const A* mine = tile + g * q;
    if (active && ept == 1) {
      const A e0 = e[0];
      for (int i = 0; i < q; i += 4) {
        const V4 v = *reinterpret_cast<const V4*>(mine + i);
        c[0] += (v.x < e0) + (v.y < e0);
        c2 += (v.z < e0) + (v.w < e0);
      }
      for (int i = G * q + g; i < tl; i += G) c[0] += tile[i] < e0;
    } else if (active) {
      for (int i = 0; i < q; ++i) {
        const A v = mine[i];
#pragma unroll
        for (int k = 0; k < HIST_MAX_EPT; ++k)
          if (k < ept) c[k] += v < e[k];
      }
      for (int i = G * q + g; i < tl; i += G) {
        const A v = tile[i];
#pragma unroll
        for (int k = 0; k < HIST_MAX_EPT; ++k)
          if (k < ept) c[k] += v < e[k];
      }
    }
    __syncthreads();
  }
  c[0] += c2;

  // combine the groups in a fixed order
#pragma unroll
  for (int k = 0; k < HIST_MAX_EPT; ++k) {
    const int j = j0 + k * T;
    if (active && k < ept && j < E) red[g * E + j] = c[k];
  }
  __syncthreads();
  int* dst = counts + (long long)blockIdx.x * E;
  for (int j = tid; j < E; j += T) {
    int s = 0;
    for (int q = 0; q < G; ++q) s += red[q * E + j];
    dst[j] = s;
  }
}

// Pass 2: one thread per (row, bin): C(e) over the row's parts in order,
// plus the pad lanes (valued e[M]), then C(e[i+1]) - C(e[i]).
template <class Tr>
__global__ void hist_finish(const int* __restrict__ counts,
                            const typename Tr::S* __restrict__ edges,
                            int* __restrict__ out, int R, int parts, int E,
                            long long pad) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int M = E - 1;
  if (t >= (long long)R * M) return;
  const long long r = t / M;
  const int i = (int)(t % M);
  const typename Tr::A top = Tr::acc(edges[M]);
  int cum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = i + h;
    unsigned s = 0;                        // wraps as the int32 sums do
    for (int q = 0; q < parts; ++q)
      s += (unsigned)counts[(r * parts + q) * E + j];
    if (top < Tr::acc(edges[j])) s += (unsigned)pad;
    cum[h] = (int)s;
  }
  out[t] = (int)((unsigned)cum[1] - (unsigned)cum[0]);
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x: (R, n) rows, edges: (E,) in the same dtype (code `dtype`), E = M+1
// >= 2; counts: (R, parts, E) int32 scratch; out: (R, M) int32.  Each of
// the `parts` runs of a row is part_len lanes (the last one shorter);
// pad = lanes padding the row to whole sections.
int histogram_launch(const void* x, const void* edges, void* counts,
                     void* out, int R, long long n, int parts,
                     long long part_len, int E, long long pad, int dtype,
                     void* stream) {
  if (R <= 0 || n <= 0 || parts < 1 || part_len < 1 || E < 2 ||
      E > HIST_MAX_EDGES || (long long)(parts - 1) * part_len >= n ||
      (long long)parts * part_len < n || (long long)R * parts > 0x7fffffffLL
      || pad < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    using S = typename Tr::S;
    using A = typename Tr::A;
    const int G = E <= HIST_THREADS ? HIST_THREADS / E : 1;
    const size_t smem = (size_t)(E + HIST_TILE) * sizeof(A) +
                        (size_t)G * E * sizeof(int);
    auto kern = hist_count<Tr>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<(unsigned)((long long)R * parts), HIST_THREADS, smem, s>>>(
        static_cast<const S*>(x), static_cast<const S*>(edges),
        static_cast<int*>(counts), n, part_len, parts, E);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long bins = (long long)R * (E - 1);
    hist_finish<Tr><<<(unsigned)((bins + 255) / 256), 256, 0, s>>>(
        static_cast<const int*>(counts), static_cast<const S*>(edges),
        static_cast<int*>(out), R, parts, E, pad);
    return (int)cudaGetLastError();
  });
  return 0;
}

}  // extern "C"
