// §6.3 histogram of (R, N) rows against M+1 edges (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:315 (histogram, pallas_call
// at :331, body _histogram_kernel at :299).
//
// What it computes: per row, bins[i] = C(e[i+1]) - C(e[i]) for i < M,
// where C(e) counts the row's lanes v with v < e, the row padded to whole
// `section`s with the top edge e[M], in int32.  Rows and edges arrive in
// one dtype (the wrapper promotes them, as the TPU wrapper does); the
// compare widens both exactly (cpm_ops.cuh traits).  The difference-of-
// counts form of the TPU kernel fixes what NaN values (counted under no
// edge) and edges out of order give; both forms below keep it.  The pad
// lanes are not read: each counts under the edges above e[M], so
// pad * (e[M] < e[j]) is added to C(e[j]).
//
// The TPU kernel accumulates its (1, M) bins across the in-order section
// axis (pl.when(j == 0) ... the last step).  CUDA blocks run in no order,
// so this is a split pass with no atomics: pass 1 gives each block a run
// of at most HIST_MAX_PART lanes of one row (the wrapper's plan aims at
// 16 blocks an SM, so the last wave of resident blocks is small) and
// writes its int32 counts C_p(e[j]); pass 2 (one thread per output bin)
// adds the row's parts in order, the pad, and takes the difference.  The
// counts are exact in any order.
//
// What bounds it on the H100: the bytes, R * N * elem read once (0.080 ms
// at chip_smoke's (64, 1,048,576) int32 rows).  The counts form's M+1
// compare-and-counts a lane take 0.13 ms at M = 64 (two operations a
// lane-edge at 67e12/s); a bin search takes ceil(log2(E+1)) steps a lane.
//
// What the design does about it: pass 1 stages the E = M+1 edges and each
// block decides, block-uniformly and on the device, between two forms
// that give the same C_p(e[j]):
//
//  * The search form, for edges that are non-decreasing and free of NaN
//    (e[j] <= e[j+1] for every j, which no NaN passes) and E <=
//    HIST_SEARCH_MAX_EDGES.  Then v < e[j] holds exactly for j >= k(v),
//    k(v) = #{j : !(v < e[j])}, so C(e[j]) = #{lanes with k(v) <= j}:
//    NaN lanes and lanes at or above e[M] have k = E and count nowhere.
//    A lane finds k(v) by a branchless descent of ceil(log2(E+1)) steps
//    through the edges in Eytzinger (breadth-first) order in shared
//    memory, padded with the compare type's largest value, each step the
//    predicate v < node: a shared load, a compare, a select and a
//    shift-add on the node's shared address.  A level of up to 32 nodes
//    sits in distinct banks.  The lane then adds one to its thread's own
//    16-bit counter of bin k, thread t's counter of bin k at half-word
//    k * T + t (bin-major, thread-minor), so a warp's 32 counters of a bin
//    lie in 16 words of 16 banks: no bank conflict and no atomics.  A part
//    holds at most HIST_MAX_PART = 2^24 lanes, so a thread counts at most
//    32,770 lanes and no counter wraps.  Lanes arrive as aligned 16-byte
//    loads (the ends of an unaligned run lane by lane), the next loads in
//    flight while the current lanes descend side by side (8 lanes a thread
//    for 4-byte types).  The block then sums each bin over its threads
//    (warps over bins, a shuffle tree, exact in any order) and one warp
//    prefix-sums the bins into C_p(e[j]).  The counters take E KB of
//    shared memory: E <= 129.
//  * The counts form otherwise (edges out of order, a NaN edge, E > 129):
//    the block stages a tile of HIST_TILE lanes in shared memory with
//    coalesced loads, the next tile waiting in registers while the current
//    one is counted; its threads split into G = blockDim / E groups of E
//    (one edge each, edge and count in registers), group g counting a
//    contiguous run of the tile with 16-byte shared-memory reads (a
//    broadcast within a group).  With E > blockDim each thread keeps up to
//    HIST_MAX_EPT edges.  The group counts are combined in a fixed order.
//
// The launch sets the larger of the two forms' shared memory, since a
// block picks its form from the edges' values.

#include <limits.h>
#include <math.h>
#include <type_traits>

#include "cpm_ops.cuh"

#define HIST_THREADS 512
#define HIST_TILE 4096
#define HIST_MAX_EPT 8                    // edges a thread keeps
#define HIST_MAX_EDGES (HIST_THREADS * HIST_MAX_EPT)
// must equal HISTOGRAM_SEARCH_MAX_EDGES / HISTOGRAM_MAX_PART in
// repro_torch/kernels/cpm_kernels.py
#define HIST_SEARCH_MAX_EDGES 129
#define HIST_MAX_PART (1LL << 24)
#define HIST_MAX_LEVELS 8                 // ceil(log2(129 + 1))
#define HIST_TREE (1 << HIST_MAX_LEVELS)  // tree nodes, padded

namespace {

// The largest value of the compare type: the tree's padding nodes, which
// no lane below the top edge reaches.
__device__ __forceinline__ int hist_top(int) { return INT_MAX; }
__device__ __forceinline__ float hist_top(float) { return INFINITY; }

__device__ __forceinline__ int hist_levels(int E) {   // ceil(log2(E + 1))
  return 32 - __clz(E);
}

// Shared memory of pass 1, in 4-byte words after the E staged edges
// (rounded up to 4): the counts form's tile and group counts, or the
// search form's tree, bin totals and counters.
__host__ __device__ __forceinline__ int hist_edge_words(int E) {
  return (E + 3) & ~3;
}
__host__ __device__ __forceinline__ int hist_counts_words(int E) {
  const int G = E <= HIST_THREADS ? HIST_THREADS / E : 1;
  return HIST_TILE + G * E;
}
__host__ __device__ __forceinline__ int hist_search_words(int E) {
  return HIST_TREE + HIST_TREE + (E * HIST_THREADS + 1) / 2;
}

// Shared-memory access by 32-bit shared address (the descent keeps each
// lane's node as its address, so a step is a load, a compare, a select
// and a shift-add).
__device__ __forceinline__ unsigned hist_lds(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void hist_bump(unsigned a) {  // a 16-bit += 1
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
  v = (unsigned short)(v + 1);
  asm volatile("st.shared.u16 [%0], %1;" :: "r"(a), "h"(v));
}
__device__ __forceinline__ bool hist_lt(int v, unsigned node) {
  return v < (int)node;
}
__device__ __forceinline__ bool hist_lt(float v, unsigned node) {
  return v < __uint_as_float(node);
}

// The search form: block-local C_p(e[j]) of the run into dst.
template <class Tr>
__device__ __forceinline__ void hist_search(
    const typename Tr::S* __restrict__ run, long long len,
    const typename Tr::A* es, unsigned char* region, int* __restrict__ dst,
    int E) {
  using S = typename Tr::S;
  using A = typename Tr::A;
  constexpr int T = HIST_THREADS;
  constexpr int V = 16 / sizeof(S);                   // 4, 8 or 16 lanes
  constexpr int U = V == 4 ? 2 : 1;                   // loads in flight
  struct alignas(16) Chunk { S e[V]; };
  A* tree = reinterpret_cast<A*>(region);             // [HIST_TREE]
  int* tot = reinterpret_cast<int*>(tree + HIST_TREE); // [HIST_TREE]
  unsigned short* cnt = reinterpret_cast<unsigned short*>(tot + HIST_TREE);
  const int tid = threadIdx.x;
  const int L = hist_levels(E), P = 1 << L;

  // node nd of the breadth-first tree over the sorted edges padded to
  // P - 1; thread t's counter of bin k is cnt[k * T + t]
  for (int nd = tid; nd < P - 1; nd += T) {
    const int d = 31 - __clz(nd + 1), p = nd + 1 - (1 << d);
    const int j = ((2 * p + 1) << (L - 1 - d)) - 1;
    tree[nd] = j < E ? es[j] : hist_top(A(0));
  }
  for (int k = 0; k < E; ++k) cnt[k * T + tid] = 0;   // own counters only
  __syncthreads();

  // node i sits at address base + 4 i: from there the step to child
  // 2 i + 1 (v < node) or 2 i + 2 is a = 2 a + 4 - base or 2 a + 8 - base;
  // the lane's bin k = i - (P - 1) leaves a - leaf = 4 k
  const unsigned base = (unsigned)__cvta_generic_to_shared(tree);
  const unsigned go_lt = 4u - base, go_ge = 8u - base;
  const unsigned leaf = base + 4u * (unsigned)(P - 1);
  const unsigned mine = (unsigned)__cvta_generic_to_shared(cnt + tid);
  const unsigned top = 4u * (unsigned)E;
  auto bump = [&](unsigned a) {
    const unsigned r = a - leaf;
    if (r < top) hist_bump(mine + r * (T / 2));           // + 2 k T bytes
  };
  auto count = [&](A v) {
    unsigned a = base;
#pragma unroll
    for (int d = 0; d < HIST_MAX_LEVELS; ++d)
      if (d < L) a = 2u * a + (hist_lt(v, hist_lds(a)) ? go_lt : go_ge);
    bump(a);
  };

  // the ends of the run outside whole aligned chunks go lane by lane
  const int ax = (int)(((16 - ((uintptr_t)run & 15)) & 15) / sizeof(S));
  const long long vlo = ax < len ? ax : len;
  const long long nch = (len - vlo) / V;
  const long long vhi = vlo + nch * V;
  if (tid < vlo) count(Tr::acc(run[tid]));
  if (vhi + tid < len) count(Tr::acc(run[vhi + tid]));

  const Chunk* xv = reinterpret_cast<const Chunk*>(run + vlo);
  // the next U chunks load while these U are counted
  Chunk nx[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tid + (long long)u * T < nch) nx[u] = xv[tid + (long long)u * T];
  for (long long k0 = tid; k0 < nch; k0 += (long long)U * T) {
    Chunk c[U];
    bool has[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      has[u] = k0 + (long long)u * T < nch;
      c[u] = nx[u];
      const long long kn = k0 + (long long)(U + u) * T;
      if (kn < nch) nx[u] = xv[kn];
    }
    // the U * V lanes' descents side by side (a lane of a missing chunk
    // descends too, and is not counted)
    A v[U * V];
    unsigned a[U * V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int m = 0; m < V; ++m) {
        v[u * V + m] = has[u] ? Tr::acc(c[u].e[m]) : A(0);
        a[u * V + m] = base;
      }
#pragma unroll
    for (int d = 0; d < HIST_MAX_LEVELS; ++d) {
      if (d >= L) break;
#pragma unroll
      for (int m = 0; m < U * V; ++m)
        a[m] = 2u * a[m] + (hist_lt(v[m], hist_lds(a[m])) ? go_lt : go_ge);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (has[u]) {
#pragma unroll
        for (int m = 0; m < V; ++m) bump(a[u * V + m]);
      }
  }
  __syncthreads();

  // each bin over the threads (warps over bins, lanes over pairs of
  // threads), then its prefix sum by warp 0
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned* cw = reinterpret_cast<const unsigned*>(cnt);
  for (int k = warp; k < E; k += T / 32) {
    unsigned s = 0;
    for (int w = lane; w < T / 2; w += 32) {
      const unsigned c2 = cw[k * (T / 2) + w];
      s += (c2 & 0xffffu) + (c2 >> 16);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) tot[k] = (int)s;
  }
  __syncthreads();
  if (warp == 0) {
    const int per = (E + 31) / 32, j0 = lane * per;
    int s = 0;
    for (int j = j0; j < j0 + per && j < E; ++j) s += tot[j];
    int inc = s;                                   // inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    s = inc - s;                                   // exclusive
    for (int j = j0; j < j0 + per && j < E; ++j) {
      s += tot[j];
      dst[j] = s;
    }
  }
}

// The counts form: block-local C_p(e[j]) of the run into dst.
template <class Tr>
__device__ __forceinline__ void hist_counts(
    const typename Tr::S* __restrict__ run, long long len,
    const typename Tr::A* es, unsigned char* region, int* __restrict__ dst,
    int E) {
  using A = typename Tr::A;
  using V4 = typename std::conditional<std::is_same<A, float>::value,
                                       float4, int4>::type;
  constexpr int T = HIST_THREADS, PER = HIST_TILE / HIST_THREADS;
  A* tile = reinterpret_cast<A*>(region);
  int* red = reinterpret_cast<int*>(tile + HIST_TILE);

  const int tid = threadIdx.x;
  // groups of E threads, one edge each; or one group, EPT edges each
  const int G = E <= T ? T / E : 1;
  const int ept = E <= T ? 1 : (E + T - 1) / T;
  const bool active = E <= T ? tid < G * E : true;
  const int g = E <= T ? tid / E : 0;
  const int j0 = E <= T ? tid % E : tid;
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
  for (int j = tid; j < E; j += T) {
    int s = 0;
    for (int q = 0; q < G; ++q) s += red[q * E + j];
    dst[j] = s;
  }
}

// Pass 1: block b counts run p = b % parts of row r = b / parts.
// counts: (R * parts, E) int32.
template <class Tr>
__global__ void __launch_bounds__(HIST_THREADS)
hist_count(const typename Tr::S* __restrict__ x,
           const typename Tr::S* __restrict__ edges,
           int* __restrict__ counts, long long n, long long part_len,
           int parts, int E) {
  using A = typename Tr::A;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* es = reinterpret_cast<A*>(smem_raw);
  unsigned char* region = smem_raw + hist_edge_words(E) * 4;

  const int tid = threadIdx.x;
  const long long r = blockIdx.x / parts, p = blockIdx.x % parts;
  const long long lo = p * part_len;
  const long long len = (lo + part_len < n ? lo + part_len : n) - lo;
  const typename Tr::S* run = x + r * n + lo;
  int* dst = counts + (long long)blockIdx.x * E;

  for (int j = tid; j < E; j += HIST_THREADS) es[j] = Tr::acc(edges[j]);
  __syncthreads();
  // the form, block-uniform: ordered edges free of NaN take the search
  bool ordered = true;
  for (int j = tid; j + 1 < E; j += HIST_THREADS)
    ordered = ordered && es[j] <= es[j + 1];
  const bool search = __syncthreads_and(ordered) &&
                      E <= HIST_SEARCH_MAX_EDGES;
  if (search)
    hist_search<Tr>(run, len, es, region, dst, E);
  else
    hist_counts<Tr>(run, len, es, region, dst, E);
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
// the `parts` runs of a row is part_len <= HIST_MAX_PART lanes (the last
// one shorter); pad = lanes padding the row to whole sections.
int histogram_launch(const void* x, const void* edges, void* counts,
                     void* out, int R, long long n, int parts,
                     long long part_len, int E, long long pad, int dtype,
                     void* stream) {
  if (R <= 0 || n <= 0 || parts < 1 || part_len < 1 ||
      part_len > HIST_MAX_PART || E < 2 || E > HIST_MAX_EDGES ||
      (long long)(parts - 1) * part_len >= n ||
      (long long)parts * part_len < n || (long long)R * parts > 0x7fffffffLL
      || pad < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the larger of the two forms' shared memory: a block picks its form
  // from the edges' values, on the device
  int words = hist_counts_words(E);
  if (E <= HIST_SEARCH_MAX_EDGES && hist_search_words(E) > words)
    words = hist_search_words(E);
  const size_t smem = (size_t)(hist_edge_words(E) + words) * 4;
  CPM_DISPATCH_DTYPE(dtype, {
    using S = typename Tr::S;
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
