// §7.7 odd-even transposition sort of (R, N) rows (sm_90a).
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
// `steps`, cycle for cycle.  N cycles sort a row.
//
// Design: a block holds a tile of one row, SORT_K consecutive lanes a
// thread, in registers, as int32 keys whose integer order is the
// values' order: integers widen; float bits keep their sign bit and,
// when it is set, flip the others, which puts -0.0 just below +0.0 and
// makes equal keys equal bits (the key maps back to the same bits).  A
// cycle whose pairs start at even lanes of the tile (the tile starts at
// a lane of the same parity for every thread, SORT_K being even) is
// SORT_K / 2 min/max pairs in registers; the other parity also trades
// each thread's end lanes with its neighbours through shared memory
// (ping-pong buffers, one __syncthreads).  Float keys check each pair
// for NaN; integer keys need not.
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
// its cause is not established: one loop per dtype is kept.)
// A row of up to SORT_TILE lanes is one tile, and the call is one launch.
// A longer row is cut into tiles of `interior` lanes, each loaded with
// `halo` lanes more on either side: a cycle moves information one lane,
// so after h <= halo cycles the interior is exact (the halo lanes, whose
// partners may lie outside the tile, are not written back).  Such a call
// runs ceil(steps / halo) passes of at most `halo` cycles, ping-ponging
// between the output and a scratch row buffer, the parity following the
// absolute lane index and the global cycle number.  The TPU kernel keeps
// a whole row in VMEM for all its cycles; the wrapper plans the tiles
// (kernels/cpm_kernels.py oddeven_plan).
//
// What bounds it on the H100: the network's compare-exchanges, R * steps
// * ~N/2 min/max pairs (two operations each), against 2 * R * N * elem
// bytes.  At chip_smoke's full sort of (64, 16,384) int32 rows: 8.6e9
// compare-exchanges, 0.26 ms at 67e12 operations/s.  A block a row leaves
// half of the 132 SMs idle there, and a barrier every other cycle costs
// more than the pairs; a bitonic network would do far less work (ROADMAP
// Queue 2, gaps).

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

template <class Tr>
__global__ void __launch_bounds__(SORT_THREADS)
oddeven_pass(const typename Tr::S* __restrict__ src,
             typename Tr::S* __restrict__ dst, long long n,
             long long interior, long long halo, int tiles, int cycles,
             long long cycle0) {
  using Kt = Key<Tr>;
  __shared__ int first[2][SORT_THREADS], last[2][SORT_THREADS];
  const long long r = blockIdx.x / tiles, t = blockIdx.x % tiles;
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
        cudaStream_t s) {
  using S = typename Tr::S;
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
        src, dst, n, interior, halo, (int)tiles, cycles, done);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    done += cycles;
    src = dst;
  }
  return done == steps ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, out: (R, n) rows of dtype code `dtype`; scratch: (R, n) of the same,
// used only when passes > 1.  One pass (passes == 1) is one tile per row
// (interior == n, halo == 0) running all `steps` cycles, or tiles whose
// halo covers all `steps`; otherwise ceil(steps / halo) == passes passes
// of at most `halo` cycles each.  A tile is at most SORT_TILE lanes.
int oddeven_sort_launch(const void* x, void* out, void* scratch, int R,
                        long long n, long long steps, long long interior,
                        long long halo, int passes, int dtype, void* stream) {
  if (R <= 0 || n <= 0 || steps < 0 || steps > 0x7fffffffLL ||
      interior < 1 || halo < 0 || passes < 1 ||
      (passes == 1 && interior < n && halo < steps) ||
      (passes > 1 && (halo < 1 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    return run<Tr>(x, out, scratch, R, n, steps, interior, halo, passes, s);
  });
  return 0;
}

}  // extern "C"
