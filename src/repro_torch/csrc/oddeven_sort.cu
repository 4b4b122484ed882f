// §7.7 odd-even transposition sort of (R, N) rows (sm_90a), with a
// bitonic network for the full sorts whose result it cannot change.
//
// Replaces: src/repro/kernels/cpm_kernels.py:177 (oddeven_sort,
// pallas_call at :182, body _oddeven_kernel at :165).
//
// What it computes: `steps` exchange cycles over every row.  Cycle c
// (counted from 0 over the whole call) pairs lane a with lane a + 1 for
// every a with a % 2 == c % 2; the left lane takes jnp.minimum(left,
// right), the right lane jnp.maximum(right, left): NaN wins and spreads
// through its pair (the first NaN operand is kept), and -0.0 < +0.0.  A
// lane without a partner (lane 0 at odd cycles, lane N-1 when it is a
// left lane) keeps its value.  A value moves by the bits of one of its
// two operands, so the result is bit for bit the plain twin's for any
// `steps`, cycle for cycle.
//
// Keys: every dtype is sorted as int32 keys whose integer order is the
// values' order: integers widen; float bits keep their sign bit and, when
// it is set, flip the others, which puts -0.0 just below +0.0 and makes
// equal keys equal bits (the key maps back to the same bits).
//
// Two routes, chosen per row on the device (the wrapper never reads a
// row on the host, and a call's launches depend on shape, dtype and
// `steps` only):
//  * The bitonic route.  N cycles sort a row under a total order, and
//    more change nothing; the keys are totally ordered, so for
//    steps >= N and a row with no NaN the result is the sorted row, bit
//    for bit, whatever network computes it.  Integer and bool rows take
//    it whenever steps >= N.  Float rows first go through nan_rows, which
//    sets flag[r] for a row holding a NaN key; every bitonic block of a
//    flagged row returns at entry, before any barrier.  The network: a
//    row is padded to P = 2^p >= N lanes with INT_MAX keys (never written
//    back; equal keys are equal bits, so a tie with a real INT_MAX is
//    harmless) and sorted by stages k = 2 .. P, each a run of
//    compare-exchange steps at strides j = k/2 .. 1, lane i ascending
//    where (i & k) == 0.  Tiles of T lanes (kernels/cpm_kernels.py
//    bitonic_plan: T at most 16,384 keys = 64 KB of shared memory, small
//    enough that a group's rows in tiles fill the 132 SMs) sort in shared
//    memory (bitonic_tile): E keys a thread (8; 32 in 16,384-key tiles),
//    strides below E in its registers, strides E .. 16 E by warp
//    shuffles, larger ones a shared-memory step with one __syncthreads.
//    A stride >= T runs in device memory (bitonic_stride, up to three
//    strides a pass, 2^3 keys a thread in registers), each stage's
//    strides below T in one more tile pass.  Rows run in groups of at
//    most 16 MiB of keys, every pass of a group before the next, so the
//    keys stay in the 50 MB L2 between passes.  The plan hands the pass
//    list to oddeven_sort_launch, which launches it as it stands; the CPU
//    tests replay the same list in PyTorch (bitonic_sort_plain).
//  * The odd-even route: the cycles themselves, for bounded sorts
//    (steps < N) and for float rows with a NaN in a full sort, where NaN
//    spreading makes the result depend on the network (in a full sort the
//    odd-even blocks of unflagged rows return at entry).  A block holds a
//    tile of one row, SORT_K consecutive lanes a thread, in registers.  A
//    cycle whose pairs start at even lanes of the tile (the tile starts at
//    a lane of the same parity for every thread, SORT_K being even) is
//    SORT_K / 2 min/max pairs in registers; the other parity also trades
//    each thread's end lanes with its neighbours through shared memory
//    (ping-pong buffers, one __syncthreads).  Float keys check each pair
//    for NaN; integer keys need not.
// Why one barrier a cross cycle is enough: every thread runs the same
// cycles (the count is uniform), and at a cross cycle it writes its
// slots of buffer `use`, waits at the barrier, then reads its
// neighbours' slots of `use`.  The next write to `use` comes two cross
// cycles later, after the barrier of the cross cycle between, which no
// thread passes before every thread has finished its reads of `use`.  So
// no read sees a stale or a later value, and no write lands under a
// read.  (A float fast path for tiles without NaN, picked by a
// block-wide vote between two copies of this loop, gave wrong exchanges
// across threads when built with -O3 and right ones with -Xptxas -O0;
// its cause is not established: one loop per dtype is kept, and the
// bitonic route is chosen per row by a flag in device memory read at a
// block's entry, never by a vote.)
// A row of up to SORT_TILE lanes is one tile, and the odd-even route is
// one launch.  A longer row is cut into tiles of `interior` lanes, each
// loaded with `halo` lanes more on either side: a cycle moves
// information one lane, so after h <= halo cycles the interior is exact
// (the halo lanes, whose partners may lie outside the tile, are not
// written back).  Such a call runs ceil(steps / halo) passes of at most
// `halo` cycles, ping-ponging between the output and a scratch row
// buffer, the parity following the absolute lane index and the global
// cycle number.  The TPU kernel keeps a whole row in VMEM for all its
// cycles; the wrapper plans the tiles (kernels/cpm_kernels.py
// oddeven_plan).
//
// What bounds it on the H100: a sort moves 2 * R * N * elem bytes; the
// odd-even network adds R * steps * ~N/2 compare-exchanges (8.6e9 for a
// full sort of (64, 16,384) rows, 0.26 ms at 67e12 operations/s, and a
// barrier every other cycle), the bitonic one R * P/2 * p(p+1)/2 (55e6
// there).  At (64, 16,384) int32 the bitonic route is five launches (a
// tile sort of 4,096-key tiles, two device-memory stride passes, two
// tile merges) over 4 MB that stay in L2; at (64, 1,048,576) it is
// sixteen passes for each of 16 groups of 4 rows.  Measured there, the
// tile passes' shared-memory and shuffle steps take most of the time,
// not the bytes (PERF.md §6, row 3b).

#include <climits>

#include "cpm_ops.cuh"

#define SORT_THREADS 1024
#define SORT_K 16                               // lanes a thread holds
#define SORT_TILE (SORT_THREADS * SORT_K)

namespace {

// Order-preserving int32 keys of each storage type.  MASK flips the
// magnitude bits of a negative float; INF is the bits of +inf (NaN: a
// magnitude above it).
template <class Tr>
struct Key {                                    // integers and bool
  using S = typename Tr::S;
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ int of(S v) { return (int)v; }
  static __device__ __forceinline__ S back(int k) { return (S)k; }
  static __device__ __forceinline__ bool nan(int) { return false; }
};
template <int MASK, int INF>
struct FloatKey {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ int flip(int b) {
    return b >= 0 ? b : b ^ MASK;               // an involution
  }
  static __device__ __forceinline__ bool nan(int k) {
    return (flip(k) & MASK) > INF;
  }
};
template <>
struct Key<F32T> : FloatKey<0x7fffffff, 0x7f800000> {
  static __device__ __forceinline__ int of(float v) {
    return flip(__float_as_int(v));
  }
  static __device__ __forceinline__ float back(int k) {
    return __int_as_float(flip(k));
  }
};
template <>
struct Key<F16T> : FloatKey<0x7fff, 0x7c00> {
  static __device__ __forceinline__ int of(uint16_t v) {
    return flip((int)(int16_t)v);
  }
  static __device__ __forceinline__ uint16_t back(int k) {
    return (uint16_t)flip(k);
  }
};
template <>
struct Key<BF16T> : FloatKey<0x7fff, 0x7f80> {
  static __device__ __forceinline__ int of(uint16_t v) {
    return flip((int)(int16_t)v);
  }
  static __device__ __forceinline__ uint16_t back(int k) {
    return (uint16_t)flip(k);
  }
};

// One compare-exchange of the pair (a left, b right): a takes
// jnp.minimum(a, b), b takes jnp.maximum(b, a).
template <class Kt>
__device__ __forceinline__ void exchange(int& a, int& b) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  if (Kt::kFloat) {
    const bool na = Kt::nan(a), nb = Kt::nan(b);
    const int l = na ? a : (nb ? b : lo), h = nb ? b : (na ? a : hi);
    a = l;
    b = h;
  } else {
    a = lo;
    b = hi;
  }
}

template <class Kt>
__device__ __forceinline__ void cycles_of(int (&v)[SORT_K], int valid,
                                          int w, int tid, int cycles,
                                          long long phase,
                                          int (*first)[SORT_THREADS],
                                          int (*last)[SORT_THREADS]) {
  int use = 0;
  const bool right_cross = valid == SORT_K && (tid + 1) * SORT_K < w;
  const bool left_cross = tid > 0 && valid >= 1;
  for (int c = 0; c < cycles; ++c) {
    if (((phase + c) & 1) == 0) {               // pairs (0,1), (2,3), ...
#pragma unroll
      for (int j = 0; j + 1 < SORT_K; j += 2)
        if (j + 1 < valid) exchange<Kt>(v[j], v[j + 1]);
    } else {                                    // (1,2), ... and the ends
      first[use][tid] = v[0];
      last[use][tid] = v[SORT_K - 1];
      __syncthreads();
      int self0 = v[0], selfk = v[SORT_K - 1];
#pragma unroll
      for (int j = 1; j + 1 < SORT_K - 1; j += 2)
        if (j + 1 < valid) exchange<Kt>(v[j], v[j + 1]);
      if (left_cross) {
        int l = last[use][tid - 1];
        exchange<Kt>(l, self0);
        v[0] = self0;
      }
      if (right_cross) {
        int rt = first[use][tid + 1];
        exchange<Kt>(selfk, rt);
        v[SORT_K - 1] = selfk;
      }
      use ^= 1;
    }
  }
}

// One odd-even pass.  `only` (a full sort of float rows) names the rows
// that take the cycles, those holding a NaN: a block of another row
// returns at entry, before any barrier; the flag is uniform over the block.
template <class Tr>
__global__ void __launch_bounds__(SORT_THREADS)
oddeven_pass(const typename Tr::S* __restrict__ src,
             typename Tr::S* __restrict__ dst, long long n,
             long long interior, long long halo, int tiles, int cycles,
             long long cycle0, const int* __restrict__ only) {
  using Kt = Key<Tr>;
  __shared__ int first[2][SORT_THREADS], last[2][SORT_THREADS];
  const long long r = blockIdx.x / tiles, t = blockIdx.x % tiles;
  if (only != nullptr && only[r] == 0) return;
  const long long i0 = t * interior;                 // first interior lane
  const long long i1 = i0 + interior < n ? i0 + interior : n;
  const long long lo = i0 - halo > 0 ? i0 - halo : 0;
  const long long hi = i1 + halo < n ? i1 + halo : n;
  const int w = (int)(hi - lo);
  const int tid = threadIdx.x;
  const int own = w - tid * SORT_K;
  const int valid = own < 0 ? 0 : (own > SORT_K ? SORT_K : own);
  const long long base = lo + (long long)tid * SORT_K;
  const typename Tr::S* row = src + r * n;
  int v[SORT_K];
#pragma unroll
  for (int k = 0; k < SORT_K; ++k)
    v[k] = k < valid ? Kt::of(row[base + k]) : 0;
  // pairs of cycle c start at lanes of parity (cycle0 + c) % 2: at even
  // register slots when that equals lo's parity
  cycles_of<Kt>(v, valid, w, tid, cycles, cycle0 + (lo & 1), first, last);
  typename Tr::S* out = dst + r * n;
#pragma unroll
  for (int k = 0; k < SORT_K; ++k) {
    const long long g = base + k;
    if (k < valid && g >= i0 && g < i1) out[g] = Kt::back(v[k]);
  }
}

template <class Tr>
int run(const void* x, void* out, void* scratch, int R, long long n,
        long long steps, long long interior, long long halo, int passes,
        const int* only, cudaStream_t s) {
  using S = typename Tr::S;
  if (interior < 1 || halo < 0 || passes < 1 ||
      (passes == 1 && interior < n && halo < steps) ||
      (passes > 1 && (halo < 1 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + interior - 1) / interior;
  const long long wmax = interior + 2 * halo < n ? interior + 2 * halo : n;
  if (wmax > SORT_TILE || (long long)R * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int threads = (int)((wmax + SORT_K - 1) / SORT_K);
  threads = (threads + 31) / 32 * 32;
  const S* src = static_cast<const S*>(x);
  long long done = 0;
  for (int p = 0; p < passes; ++p) {
    // the last pass writes `out`; the ones before alternate with scratch
    S* dst = static_cast<S*>((passes - 1 - p) % 2 == 0 ? out : scratch);
    const long long left = steps - done;
    const int cycles = (int)(passes == 1 ? left : (left < halo ? left
                                                               : halo));
    oddeven_pass<Tr><<<(unsigned)((long long)R * tiles), threads, 0, s>>>(
        src, dst, n, interior, halo, (int)tiles, cycles, done, only);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    done += cycles;
    src = dst;
  }
  return done == steps ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the bitonic route (full sorts of rows without NaN)
// ---------------------------------------------------------------------------

#define BITONIC_MAX_TILE 16384                  // keys: 64 KB of shared memory
#define PAD(i) ((i) + ((i) >> 5))               // bitonic_tile's key slots
#define BITONIC_STRIDE_THREADS 256
#define NAN_CHUNK 8192                          // lanes a nan_rows block reads

// Keys of the bitonic route hold no NaN: a plain ordered exchange.
__device__ __forceinline__ void order(int& a, int& b, bool asc) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// flag[r] |= 1 where row r holds a NaN key (flag zeroed before the launch);
// `chunks` blocks a row, a warp vote and one atomicOr a warp that saw one.
template <class Tr>
__global__ void __launch_bounds__(256)
nan_rows(const typename Tr::S* __restrict__ x, int* __restrict__ flag,
         long long n, int chunks) {
  using Kt = Key<Tr>;
  const long long r = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const long long lo = c * NAN_CHUNK;
  const long long hi = lo + NAN_CHUNK < n ? lo + NAN_CHUNK : n;
  const typename Tr::S* row = x + r * n;
  bool any = false;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    any = any || Kt::nan(Kt::of(row[i]));
  if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0)
    atomicOr(flag + r, 1);
}

// One tile of T keys of a padded row in shared memory: stages k0 .. k1,
// each from stride min(k/2, T/2) down to 1.  A thread holds E = 2^LOG_E
// consecutive keys; strides >= 32 E are one shared-memory step each (a pair a thread
// per turn, one __syncthreads), strides E .. 16 E pair a key with the same
// register of lane ^ (j / E) through a warp shuffle, and strides below E
// run inside the thread's registers.  `first` reads the row itself (keys
// past n are INT_MAX padding), else the key buffer; `last` writes the
// row's first n lanes back in its dtype, else the key buffer.  A row
// flagged in `skip` returns at entry.  Shared memory holds key i at
// PAD(i), a word of padding every 32 keys, so the E consecutive keys of
// the 32 threads of a warp lie in 32 different banks.
template <class Tr, int LOG_E>
__global__ void __launch_bounds__(1024)
bitonic_tile(const typename Tr::S* __restrict__ x,
             typename Tr::S* __restrict__ out, int* __restrict__ keys,
             const int* __restrict__ skip, long long n, long long P, int T,
             long long k0, long long k1, int first, int last) {
  using Kt = Key<Tr>;
  constexpr int E = 1 << LOG_E;
  extern __shared__ int sk[];
  const long long tiles = P / T;
  const long long r = blockIdx.x / tiles;
  if (skip != nullptr && skip[r] != 0) return;
  const long long base = (blockIdx.x % tiles) * T;   // in the padded row
  const int tid = threadIdx.x, nt = blockDim.x;
  // the lanes a shuffle may read: every lane of a whole warp, the first
  // nt of a lone partial one (a partner lane tid ^ (j / E) is below nt)
  const unsigned lanes = nt >= 32 ? 0xffffffffu : (1u << nt) - 1u;
  if (first) {
    const typename Tr::S* row = x + r * n;
    for (int i = tid; i < T; i += nt) {
      const long long g = base + i;
      sk[PAD(i)] = g < n ? Kt::of(row[g]) : INT_MAX;
    }
  } else {
    const int* row = keys + r * P + base;
    for (int i = tid; i < T; i += nt) sk[PAD(i)] = row[i];
  }
  __syncthreads();
  const int i0 = tid * E;                      // this thread's register lanes
  for (long long k = k0; k <= k1; k <<= 1) {
    int j = (int)(k / 2 < T / 2 ? k / 2 : T / 2);
    for (; j >= 32 * E; j >>= 1) {
      for (int q = tid; q < T / 2; q += nt) {
        const int p = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        int a = sk[PAD(p)], b = sk[PAD(p + j)];
        order(a, b, ((base + p) & k) == 0);
        sk[PAD(p)] = a;
        sk[PAD(p + j)] = b;
      }
      __syncthreads();
    }
    int v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = sk[PAD(i0 + e)];
    // a shuffle step has k > j >= E: bit k, the direction, is the same
    // for the thread's E keys
    const bool asc = ((base + i0) & k) == 0;
    for (; j >= E; j >>= 1) {
      const int m = j >> LOG_E;                  // partner lane: tid ^ m
      const bool keep_min = ((tid & m) == 0) == asc;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int o = __shfl_xor_sync(lanes, v[e], m);
        v[e] = keep_min ? min(v[e], o) : max(v[e], o);
      }
    }
#pragma unroll
    for (int b = LOG_E - 1; b >= 0; --b) {
      const int jj = 1 << b;
      if (jj <= j) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if ((e & jj) == 0)
            order(v[e], v[e | jj], ((base + i0 + e) & k) == 0);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sk[PAD(i0 + e)] = v[e];
    __syncthreads();
  }
  if (last) {
    typename Tr::S* row = out + r * n;
    for (int i = tid; i < T; i += nt) {
      const long long g = base + i;
      if (g < n) row[g] = Kt::back(sk[PAD(i)]);
    }
  } else {
    int* row = keys + r * P + base;
    for (int i = tid; i < T; i += nt) row[i] = sk[PAD(i)];
  }
}

// L strides of stage k in device memory, j, j/2, ..., j/2^(L-1) (all >= the
// tile): a thread holds the 2^L keys base + c * (j >> (L-1)) in registers,
// base having zeros at the strides' bits, so bit k (above j) and with it
// the direction is the same for all of them.
template <int L>
__global__ void __launch_bounds__(BITONIC_STRIDE_THREADS)
bitonic_stride(int* __restrict__ keys, const int* __restrict__ skip,
               long long P, long long k, long long j) {
  constexpr int M = 1 << L;
  const long long groups = P >> L;             // per row
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = g / groups;
  if (skip != nullptr && skip[r] != 0) return;
  const long long q = g - r * groups;
  const long long jl = j >> (L - 1);
  const long long base = (q / jl) * (jl << L) + q % jl;
  int* row = keys + r * P;
  int v[M];
#pragma unroll
  for (int c = 0; c < M; ++c) v[c] = row[base + c * jl];
  const bool asc = (base & k) == 0;
#pragma unroll
  for (int b = L - 1; b >= 0; --b)
#pragma unroll
    for (int c = 0; c < M; ++c)
      if ((c & (1 << b)) == 0) order(v[c], v[c | (1 << b)], asc);
#pragma unroll
  for (int c = 0; c < M; ++c) row[base + c * jl] = v[c];
}

template <class Tr, int LOG_E>
int tile_pass(const void* x, void* out, int* keys, const int* skip, int R,
              long long n, long long P, int T, long long k0, long long k1,
              int first, int last, cudaStream_t s) {
  using S = typename Tr::S;
  auto kern = bitonic_tile<Tr, LOG_E>;
  static bool smem_set = false;                // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PAD(BITONIC_MAX_TILE) * (int)sizeof(int));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const long long blocks = (long long)R * (P / T);
  const int threads = T >> LOG_E;
  const size_t smem = (size_t)PAD(T) * sizeof(int);
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const S*>(x), static_cast<S*>(out), keys, skip, n, P, T,
      k0, k1, first, last);
  return (int)cudaGetLastError();
}

template <int L>
int stride_launch(int* keys, const int* skip, int R, long long P,
                  long long k, long long j, cudaStream_t s) {
  const long long groups = P >> L;
  const int threads = groups < BITONIC_STRIDE_THREADS
                          ? (int)groups : BITONIC_STRIDE_THREADS;
  const long long blocks = (long long)R * groups / threads;
  bitonic_stride<L><<<(unsigned)blocks, threads, 0, s>>>(keys, skip, P, k,
                                                         j);
  return (int)cudaGetLastError();
}

// The plan's passes, 4 numbers each: (0, k0, k1, 0) a tile pass over
// stages k0 .. k1, (1, k, j, L) a device-memory pass of L strides from j.
// The first pass reads the rows, the last writes `out`.  Rows run in
// groups of G, every pass of a group before the next group, so a group's
// keys stay in L2 between passes.
template <class Tr>
int run_bitonic(const void* x, void* out, int* keys, const int* skip, int R,
                long long n, long long P, int T, int G, int nplan,
                const long long* plan, cudaStream_t s) {
  using S = typename Tr::S;
  if (T < 16 || T > BITONIC_MAX_TILE || (T & (T - 1)) || P < T || P % T ||
      P < n || (P & (P - 1)) || G < 1 ||
      (long long)G * (P / T) > 0x7fffffffLL ||
      (P > T && keys == nullptr) || plan[0] != 0 || plan[4 * (nplan - 1)])
    return (int)cudaErrorInvalidValue;
  for (int g0 = 0; g0 < R; g0 += G) {
    const int rg = R - g0 < G ? R - g0 : G;
    const S* xg = static_cast<const S*>(x) + g0 * n;
    S* og = static_cast<S*>(out) + g0 * n;
    int* kg = keys == nullptr ? nullptr : keys + g0 * P;
    const int* sg = skip == nullptr ? nullptr : skip + g0;
    for (int i = 0; i < nplan; ++i) {
      const long long* p = plan + 4 * i;
      int e;
      if (p[0] == 0) {
        const int first = i == 0, last = i == nplan - 1;
        e = T == BITONIC_MAX_TILE
                ? tile_pass<Tr, 5>(xg, og, kg, sg, rg, n, P, T, p[1], p[2],
                                   first, last, s)
                : tile_pass<Tr, 3>(xg, og, kg, sg, rg, n, P, T, p[1], p[2],
                                   first, last, s);
      } else {
        const long long k = p[1], j = p[2];
        const int L = (int)p[3];
        if (j < T || (j >> (L - 1)) < T || k <= j || L < 1 || L > 3)
          return (int)cudaErrorInvalidValue;
        e = L == 1 ? stride_launch<1>(kg, sg, rg, P, k, j, s)
            : L == 2 ? stride_launch<2>(kg, sg, rg, P, k, j, s)
                     : stride_launch<3>(kg, sg, rg, P, k, j, s);
      }
      if (e != 0) return e;
    }
  }
  return 0;
}

// A full sort: the bitonic route for every row, or (float dtypes) for the
// rows nan_rows leaves unflagged and the odd-even cycles for the others.
template <class Tr>
int run_full(const void* x, void* out, void* scratch, int R, long long n,
             long long steps, long long interior, long long halo,
             int passes, int* keys, int* flag, long long P, int T, int G,
             int nplan, const long long* plan, cudaStream_t s) {
  using Kt = Key<Tr>;
  if (!Kt::kFloat)
    return run_bitonic<Tr>(x, out, keys, nullptr, R, n, P, T, G, nplan,
                           plan, s);
  if (flag == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(flag, 0, (size_t)R * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + NAN_CHUNK - 1) / NAN_CHUNK;
  if ((long long)R * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  nan_rows<Tr><<<(unsigned)(R * chunks), 256, 0, s>>>(
      static_cast<const typename Tr::S*>(x), flag, n, (int)chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int rc = run_bitonic<Tr>(x, out, keys, flag, R, n, P, T, G, nplan, plan,
                           s);
  if (rc != 0) return rc;
  return run<Tr>(x, out, scratch, R, n, steps, interior, halo, passes, flag,
                 s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, out: (R, n) rows of dtype code `dtype`; scratch: (R, n) of the same,
// used only when passes > 1.  The odd-even cycles: one pass (passes == 1)
// is one tile per row (interior == n, halo == 0) running all `steps`
// cycles, or tiles whose halo covers all `steps`; otherwise
// ceil(steps / halo) == passes passes of at most `halo` cycles each.  A
// tile is at most SORT_TILE lanes.
// nplan == 0: every row takes the cycles (a bounded sort, steps < n).
// nplan > 0 (steps >= n): the bitonic route's `plan` (nplan passes of 4
// numbers, host memory) over rows padded to P lanes in tiles of T keys,
// in groups of G rows, with `keys` an (R, P) int32 buffer when P > T;
// float dtypes first flag their NaN rows in `flag` ((R,) int32), which
// then take the cycles.
int oddeven_sort_launch(const void* x, void* out, void* scratch, int R,
                        long long n, long long steps, long long interior,
                        long long halo, int passes, int* keys, int* flag,
                        long long P, int T, int G, int nplan,
                        const long long* plan, int dtype, void* stream) {
  if (R <= 0 || n <= 0 || steps < 0 || steps > 0x7fffffffLL ||
      nplan < 0 || (nplan > 0 && (steps < n || plan == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    if (nplan > 0)
      return run_full<Tr>(x, out, scratch, R, n, steps, interior, halo,
                          passes, keys, flag, P, T, G, nplan, plan, s);
    return run<Tr>(x, out, scratch, R, n, steps, interior, halo, passes,
                   nullptr, s);
  });
  return 0;
}

}  // extern "C"
