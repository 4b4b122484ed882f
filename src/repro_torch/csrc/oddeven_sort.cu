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
//    odd-even blocks of unflagged rows skip their tiles).
//
// The odd-even route (oddeven_tiles; plan: kernels/cpm_kernels.py
// oddeven_plan, replayed on the CPU by oddeven_tiled_plain).
//  * Halo tiles.  A cycle moves information one lane, so lanes that are
//    exact at the start of c cycles leave, c lanes in from either edge of
//    their span, lanes that are exact at the end.  A block takes a tile
//    of `interior` lanes with `halo` lanes more on either side (lanes
//    outside the row are pads, below) and writes back only the interior,
//    after at most `halo` cycles.  A row is cut into as many tiles as the
//    plan chooses, so short rows run many blocks and a long run of cycles
//    is spread over every tile of its row.
//  * Warp segments.  A thread holds OE_K = 16 consecutive lanes in
//    registers; a warp's 32 threads a segment of 512 lanes.  Segments
//    overlap by two threads: the first and last thread of a warp hold the
//    16 lanes next to its 480 interior lanes, copies of the neighbouring
//    warps' end lanes.  A warp runs OE_HALO = 16 cycles (a round) on its
//    segment with no block barrier: pairs inside a thread in registers,
//    pairs across two threads through __shfl_up_sync / __shfl_down_sync
//    (full masks; a warp's end threads pair their outer lane with their
//    own other end, values that never reach the interior in a round).
//    Then the second and second-last thread of every warp publish their
//    lanes to a shared-memory halo buffer, one __syncthreads, and the end
//    threads copy their neighbours' lanes in.  Two halo buffers are used
//    in turn, so one barrier a round is enough (a buffer is written again
//    two rounds later, after the barrier between, which no thread passes
//    before all have read it).  So a 16-cycle round costs one barrier,
//    not eight.
//  * Pads.  A lane left of the row holds the key of -inf (INT_MIN for
//    integers), a lane right of it the key of +inf (INT_MAX): the row's
//    end lanes take them as partners and keep their own value, as a lane
//    without a partner does.  A pad changes only into a NaN that its row
//    end already holds and keeps (a NaN lane never changes), so a pad
//    never changes a lane of the row.  The window's own end lanes (and a
//    segment's, paired with their own thread's other end) go wrong from
//    their first cycle, and a wrong value reaches at most one lane more a
//    cycle: never a tile's interior within `halo` cycles, never a
//    segment's interior within a round.
//  * Keys in a tile: the key plus kShift, compared unsigned, which puts
//    every NaN above +inf.  Then max(a, b) of a pair is its NaN where it
//    has one, and the NaN-aware exchange is two compares, a min, a max
//    and three selects a pair (NaN lanes keep their own bits).
//  * The NaN test only where a NaN can be.  A tile whose lanes hold no
//    NaN key exchanges by integer min and max, which is exact there and
//    cannot make a NaN; half its pairs take the max as a + b - min (two
//    IMADs on the FMA pipe), the other half as a max, which shares the
//    min / max issue between two pipes.  Float rows are first scanned
//    (nan_chunks: one flag in device memory for every OE_CHUNK lanes).  A
//    NaN spreads one lane a cycle, so after `done` cycles of the call a
//    lane can hold one only within `done` lanes of a flagged chunk: every
//    thread of a block reads the same flags covering its window widened
//    by `done` and takes the same loop (no vote); both loops are in the
//    same kernel, behind a branch that is uniform over the block.
//  * Passes.  More cycles than one halo allows run in passes of at most
//    `per_pass` cycles, ping-ponging between `out` and `scratch` (the
//    last pass writes `out`).  A one-pass plan is one plain launch, a
//    tile a block.  A plan of several passes is one cooperative launch
//    (cudaLaunchCooperativeKernel: every block resident, or the launch is
//    refused): the blocks stride over the tiles and meet at a grid-wide
//    barrier between passes (an arrival count in device memory, zeroed
//    before the launch; a block that waits about a minute traps instead
//    of hanging).  Tiles read a pass's input through L2 (__ldcg), so no
//    block reads a stale L1 line of the previous pass's output.
//
// What bounds it on the H100: a compare-exchange is two operations, a min
// and a max; min and max issue on the ALU pipe (64 lanes a clock per SM).
// 1,024 cycles of (64, 1,048,576) rows are 6.9e10 min or max, 4.1 ms at
// that rate and 1.98 GHz; the integer loop moves a quarter of them to the
// FMA pipe.  The segment halos add 512 / 480 and the tile halos (interior
// + 2 halo) / interior of work, each pass one more read and write of the
// rows (a window's loads all in flight at once); the plan weighs them.  A
// float row with a NaN runs the NaN loop on the tiles the NaN can reach,
// 3.5 ALU instructions a lane a cycle; a full sort spreads such a row
// over many blocks and passes (PERF.md §6, row 3).

#include <climits>

#include "cpm_ops.cuh"

#define OE_K 16                                 // lanes a thread holds
#define OE_HALO OE_K                            // a segment's lanes of each
                                                // neighbour
#define OE_ROUND 16                             // cycles a round, <= OE_HALO
#define OE_STEP (32 * OE_K - 2 * OE_HALO)       // a segment's interior: 480
#define OE_MAX_WARPS (512 / OE_K)               // windows of <= 15,360 lanes
#define OE_VEC (OE_K / 4)                       // 16-byte vectors a thread
#define OE_CHUNK 1024                           // lanes a NaN flag covers
#define OE_LOADS OE_K               // window lanes a thread loads: a window
                                   // of nw warps is 30 nw + 2 <= 32 nw OE_K
#define OE_FULL 0xffffffffu

namespace {

// Order-preserving int32 keys of each storage type.  MASK flips the
// magnitude bits of a negative float; INF is the bits of +inf (NaN: a
// magnitude above it).  The odd-even route adds kShift to a key, modulo
// 2^32, so that unsigned order is the key order and every NaN key lies
// above kTop, the largest non-NaN key (+inf); 0 is the smallest (-inf):
// integers add 2^31, floats INF + 1 (the NaN keys of negative sign wrap
// round to just above those of positive sign).
template <class Tr>
struct Key {                                    // integers and bool
  using S = typename Tr::S;
  static constexpr bool kFloat = false;
  static constexpr unsigned kShift = 0x80000000u, kTop = 0xffffffffu;
  static __device__ __forceinline__ int of(S v) { return (int)v; }
  static __device__ __forceinline__ S back(int k) { return (S)k; }
  static __device__ __forceinline__ bool nan(int) { return false; }
};
template <int MASK, int INF>
struct FloatKey {
  static constexpr bool kFloat = true;
  static constexpr unsigned kShift = (unsigned)INF + 1u;
  static constexpr unsigned kTop = 2u * (unsigned)INF + 1u;
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

// ---------------------------------------------------------------------------
// the odd-even route
// ---------------------------------------------------------------------------

// Keys of a tile: Kt's key plus Kt::kShift (unsigned order, NaN above
// kTop).
template <class Kt>
__device__ __forceinline__ unsigned oe_key(int k) {
  return (unsigned)k + Kt::kShift;
}
template <class Kt>
__device__ __forceinline__ int oe_unkey(unsigned u) {
  return (int)(u - Kt::kShift);
}

// 1 and -1 the compiler cannot see, so that max(a, b) = a + b - min(a, b)
// (modulo 2^32) is two IMADs on the FMA pipe, off the ALU pipe that takes
// every min and max: half the pairs of the integer loop take this form
__constant__ unsigned oe_one = 1u, oe_minus_one = 0xffffffffu;

// The new value of a left lane `a` whose right partner holds `b`
// (jnp.minimum(a, b)), and of a right lane `b` whose left partner holds
// `a` (jnp.maximum(b, a)).  WITH_NAN false: keys without NaN.  With NaN
// keys above every other, max(a, b) is the NaN of a pair with one, so
// the right lane keeps a NaN of its own or takes the max, and the left
// lane keeps a NaN of its own, else takes the max where the right one is
// a NaN, else the min.
template <bool WITH_NAN, class Kt>
__device__ __forceinline__ unsigned left_lane(unsigned a, unsigned b) {
  const unsigned lo = min(a, b);
  if (!WITH_NAN) return lo;
  return a > Kt::kTop ? a : (b > Kt::kTop ? b : lo);
}
template <bool WITH_NAN, class Kt>
__device__ __forceinline__ unsigned right_lane(unsigned a, unsigned b) {
  const unsigned hi = max(a, b);
  if (!WITH_NAN) return hi;
  return b > Kt::kTop ? b : hi;
}
template <bool WITH_NAN, class Kt>
__device__ __forceinline__ void pair(unsigned& a, unsigned& b,
                                     bool sum = false) {
  const unsigned lo = min(a, b);
  const unsigned hi = sum && !WITH_NAN
                          ? lo * oe_minus_one + (a * oe_one + b)
                          : max(a, b);
  if (WITH_NAN) {
    const bool na = a > Kt::kTop, nb = b > Kt::kTop;
    const unsigned l = na ? a : (nb ? hi : lo), h = nb ? b : hi;
    a = l;
    b = h;
  } else {
    a = lo;
    b = hi;
  }
}

// A cycle whose pairs start at a thread's first lane: (0,1), (2,3), ...
template <bool WITH_NAN, class Kt>
__device__ __forceinline__ void cycle_in(unsigned (&v)[OE_K]) {
#pragma unroll
  for (int j = 0; j < OE_K; j += 2)
    pair<WITH_NAN, Kt>(v[j], v[j + 1], (j & 2) == 0);
}

// The other parity: (1,2), ..., (K-3,K-2) in registers, and each end lane
// with the neighbouring thread's (lane 31 of a warp pairs its last lane
// with its own first, lane 0 its first with its own last: halo values).
template <bool WITH_NAN, class Kt>
__device__ __forceinline__ void cycle_across(unsigned (&v)[OE_K]) {
  const unsigned right = __shfl_down_sync(OE_FULL, v[0], 1);
  const unsigned left = __shfl_up_sync(OE_FULL, v[OE_K - 1], 1);
#pragma unroll
  for (int j = 1; j + 1 < OE_K; j += 2)
    pair<WITH_NAN, Kt>(v[j], v[j + 1], (j & 2) == 0);
  v[OE_K - 1] = left_lane<WITH_NAN, Kt>(v[OE_K - 1], right);
  v[0] = right_lane<WITH_NAN, Kt>(left, v[0]);
}

// `cycles` cycles of a warp segment, the first pairing inside a thread
// when `in`, in rounds of at most OE_ROUND cycles with the end threads
// refreshed from the neighbouring warps between rounds.  `halo`: two
// buffers of (warps, 2, OE_K) keys.  The round count is the same for
// every thread of the block, so every __syncthreads is reached by all.
template <bool WITH_NAN, class Kt>
__device__ __forceinline__ void rounds(unsigned (&v)[OE_K], int cycles,
                                       bool in, unsigned* halo, int w,
                                       int lane, int nw) {
  int use = 0;
  for (int done = 0; done < cycles;) {
    const int s = cycles - done < OE_ROUND ? cycles - done : OE_ROUND;
    if (s == OE_ROUND) {                        // an even count: `in` stays
      if (in) {
#pragma unroll
        for (int c = 0; c < OE_ROUND; c += 2) {
          cycle_in<WITH_NAN, Kt>(v);
          cycle_across<WITH_NAN, Kt>(v);
        }
      } else {
#pragma unroll
        for (int c = 0; c < OE_ROUND; c += 2) {
          cycle_across<WITH_NAN, Kt>(v);
          cycle_in<WITH_NAN, Kt>(v);
        }
      }
    } else {
      for (int c = 0; c < s; ++c) {
        if (in)
          cycle_in<WITH_NAN, Kt>(v);
        else
          cycle_across<WITH_NAN, Kt>(v);
        in = !in;
      }
    }
    done += s;
    if (done < cycles) {
      unsigned* buf = halo + use * nw * 2 * OE_K;
      if (lane == 1 || lane == 30) {
        unsigned* dst = buf + (w * 2 + (lane == 30)) * OE_K;
#pragma unroll
        for (int j = 0; j < OE_K; ++j) dst[j] = v[j];
      }
      __syncthreads();
      if ((lane == 0 && w > 0) || (lane == 31 && w + 1 < nw)) {
        const unsigned* src = lane == 0 ? buf + ((w - 1) * 2 + 1) * OE_K
                                   : buf + ((w + 1) * 2) * OE_K;
#pragma unroll
        for (int j = 0; j < OE_K; ++j) v[j] = src[j];
      }
      use ^= 1;
    }
  }
}

// The shared-memory word of tile slot i: each thread's OE_K keys are
// OE_VEC 16-byte vectors, their order rotated by bits of the thread's
// group b, so the vectors of 8 consecutive threads that a warp reads in
// one 128-byte phase fall in different banks.
#define OE_SWZ_SHIFT (OE_VEC >= 8 ? 0 : OE_VEC == 4 ? 1 : 2)
__device__ __forceinline__ int oe_slot(int i) {
  const int b = i / OE_K, j = (i % OE_K) >> 2;
  return b * OE_K + ((j ^ ((b >> OE_SWZ_SHIFT) & (OE_VEC - 1))) << 2) +
         (i & 3);
}

// The tiles of every row, `passes` passes of at most `per_pass` cycles
// (see above).  A block of nw warps holds a window of nw * OE_STEP lanes
// (a tile's interior and its halo on either side) plus OE_HALO slots on
// either side for the end warps' outer threads.  `only` (a full sort of
// float rows) names the rows that take the cycles; `nanf` holds the NaN
// flags of each row's OE_CHUNK-lane chunks (float dtypes).
template <class Tr>
__global__ void __launch_bounds__(OE_MAX_WARPS * 32)
oddeven_tiles(const typename Tr::S* __restrict__ x,
              typename Tr::S* __restrict__ out,
              typename Tr::S* __restrict__ scratch,
              const int* __restrict__ only,
              const unsigned char* __restrict__ nanf, unsigned* bar,
              long long n, int rows, int interior, int halo, int tiles,
              int steps, int per_pass, int passes, int chunks) {
  using Kt = Key<Tr>;
  using S = typename Tr::S;
  extern __shared__ int4 oe_smem[];
  unsigned* tile = reinterpret_cast<unsigned*>(oe_smem);
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wt = nw * OE_STEP + 2 * OE_HALO;    // tile slots
  unsigned* hbuf = tile + wt;
  const int items = rows * tiles;              // < 2^31 (run)
  const int first = w * OE_STEP + lane * OE_K;  // slot of v[0]
  if (only != nullptr) {             // no row flagged: the whole grid
    int any = 0;                     // returns here, before any barrier
    for (int i = threadIdx.x; i < rows; i += blockDim.x) any |= only[i];
    if (!__syncthreads_or(any)) return;
  }
  const S* src = x;
  int done = 0;
  for (int p = 0; p < passes; ++p) {
    S* dst = ((passes - 1 - p) & 1) == 0 ? out : scratch;
    const int cycles = steps - done < per_pass ? steps - done : per_pass;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int r = it / tiles, t = it % tiles;
      if (only != nullptr && only[r] == 0) continue;
      const long long i0 = (long long)t * interior;
      const long long base = i0 - halo - OE_HALO;   // lane of slot 0
      bool with_nan = false;
      if (Kt::kFloat) {             // flags of the window widened by `done`
        const long long a = base - done > 0 ? base - done : 0;
        const long long b = base + wt + done < n ? base + wt + done : n;
        for (long long c = a / OE_CHUNK; a < b && c <= (b - 1) / OE_CHUNK;
             ++c)
          with_nan = with_nan || nanf[(long long)r * chunks + c] != 0;
      }
      __syncthreads();              // the last tile's reads of `tile` done
      // the window: OE_LOADS lanes a thread (wt <= 16 * 32 * nw), every
      // load in flight at once (a clamped lane, so none waits on a branch)
      const S* row = src + (long long)r * n;
      unsigned raw[OE_LOADS];
#pragma unroll
      for (int q = 0; q < OE_LOADS; ++q) {
        const long long g = base + threadIdx.x + q * blockDim.x;
        const long long c = g < 0 ? 0 : (g < n ? g : n - 1);
        const unsigned k = oe_key<Kt>(Kt::of(__ldcg(row + c)));
        raw[q] = g < 0 ? 0u : (g < n ? k : Kt::kTop);
      }
#pragma unroll
      for (int q = 0; q < OE_LOADS; ++q) {
        const int i = threadIdx.x + q * blockDim.x;
        if (i < wt) tile[oe_slot(i)] = raw[q];
      }
      __syncthreads();
      unsigned v[OE_K];
#pragma unroll
      for (int q = 0; q < OE_VEC; ++q) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            tile + oe_slot(first + 4 * q));
        v[4 * q] = u.x;
        v[4 * q + 1] = u.y;
        v[4 * q + 2] = u.z;
        v[4 * q + 3] = u.w;
      }
      // cycle `done` pairs lanes from the parity of `done`; a thread's
      // first lane has the parity of `base` (OE_K and OE_STEP are even)
      const bool in = ((done ^ base) & 1) == 0;
      if (with_nan)
        rounds<true, Kt>(v, cycles, in, hbuf, w, lane, nw);
      else
        rounds<false, Kt>(v, cycles, in, hbuf, w, lane, nw);
      __syncthreads();              // every segment and halo read is done
      if (lane >= 1 && lane < 31) {
#pragma unroll
        for (int q = 0; q < OE_VEC; ++q)
          *reinterpret_cast<uint4*>(tile + oe_slot(first + 4 * q)) =
              make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
      __syncthreads();
      S* orow = dst + (long long)r * n + i0;
      const int m = n - i0 < interior ? (int)(n - i0) : interior;
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        orow[i] = Kt::back(oe_unkey<Kt>(tile[oe_slot(OE_HALO + halo + i)]));
    }
    done += cycles;
    if (p + 1 < passes) cpm_grid_barrier(bar, (unsigned)(p + 1) * gridDim.x);
    src = dst;
  }
}

// nanf[r * chunks + c] = 1 where lanes [c, c + 1) * OE_CHUNK of row r hold
// a NaN key, else 0 (a block a chunk).
template <class Tr>
__global__ void __launch_bounds__(256)
nan_chunks(const typename Tr::S* __restrict__ x,
           unsigned char* __restrict__ nanf, long long n, long long chunks) {
  using Kt = Key<Tr>;
  const long long r = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const long long lo = c * OE_CHUNK;
  const long long hi = lo + OE_CHUNK < n ? lo + OE_CHUNK : n;
  const typename Tr::S* row = x + r * n;
  bool any = false;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    any = any || oe_key<Kt>(Kt::of(row[i])) > Kt::kTop;
  const int found = __syncthreads_or(any);
  if (threadIdx.x == 0) nanf[blockIdx.x] = (unsigned char)(found != 0);
}

// The odd-even route of a call (kernels/cpm_kernels.py oddeven_plan):
// `warps` warps a block, tiles of `interior` lanes and `halo` more on
// either side, `passes` passes of at most `per_pass` cycles.
template <class Tr>
int run(const void* x, void* out, void* scratch, unsigned char* nanf,
        unsigned* bar, int R, long long n, long long steps, int warps,
        long long interior, long long halo, long long per_pass, int passes,
        const int* only, cudaStream_t s) {
  using S = typename Tr::S;
  using Kt = Key<Tr>;
  if (warps < 1 || warps > OE_MAX_WARPS || interior < 1 || halo < 0 ||
      interior + 2 * halo > (long long)warps * OE_STEP || passes < 1 ||
      per_pass < 0 || per_pass > steps ||
      (steps == 0 ? passes != 1
                  : ((long long)(passes - 1) * per_pass >= steps ||
                     (long long)passes * per_pass < steps)) ||
      (passes > 1 && (scratch == nullptr || bar == nullptr)) ||
      (Kt::kFloat && nanf == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + interior - 1) / interior;
  if (tiles > 1 && per_pass > halo) return (int)cudaErrorInvalidValue;
  const long long items = (long long)R * tiles;
  const long long chunks = (n + OE_CHUNK - 1) / OE_CHUNK;
  if (items > 0x7fffffffLL || (long long)R * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = warps * 32;
  const size_t smem =
      (size_t)(warps * OE_STEP + 2 * OE_HALO + 4 * warps * OE_K) * sizeof(int);
  auto kern = oddeven_tiles<Tr>;
  static bool smem_set = false;                 // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (OE_MAX_WARPS * OE_STEP + 2 * OE_HALO + 4 * OE_MAX_WARPS * OE_K) *
            (int)sizeof(int));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const S* xs = static_cast<const S*>(x);
  if (Kt::kFloat) {
    nan_chunks<Tr><<<(unsigned)(R * chunks), 256, 0, s>>>(xs, nanf, n,
                                                          chunks);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  S* o = static_cast<S*>(out);
  S* sc = static_cast<S*>(scratch);
  int in_ = (int)interior, h_ = (int)halo, t_ = (int)tiles, st_ = (int)steps,
      pp_ = (int)per_pass, ch_ = (int)chunks;
  if (passes == 1) {
    kern<<<(unsigned)items, threads, smem, s>>>(xs, o, sc, only, nanf, bar,
                                                n, R, in_, h_, t_, st_, pp_,
                                                passes, ch_);
    return (int)cudaGetLastError();
  }
  // several passes: one cooperative launch, every block resident
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // at most 16 warps an SM (one block of more): enough to fill the ALU
  // pipes, and few blocks at each barrier
  int cap = 16 / warps > 1 ? 16 / warps : 1;
  if (per_sm < cap) cap = per_sm;
  long long grid = (long long)cap * sms;
  if (grid > items) grid = items;
  e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&xs, (void*)&o, (void*)&sc, (void*)&only,
                  (void*)&nanf, (void*)&bar, (void*)&n, (void*)&R,
                  (void*)&in_, (void*)&h_, (void*)&t_, (void*)&st_,
                  (void*)&pp_, (void*)&passes, (void*)&ch_};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)grid),
                                  dim3(threads), args, smem, s);
  return (int)e;
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
int run_full(const void* x, void* out, void* scratch, unsigned char* nanf,
             unsigned* bar, int R, long long n, long long steps, int warps,
             long long interior, long long halo, long long per_pass,
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
  return run<Tr>(x, out, scratch, nanf, bar, R, n, steps, warps, interior,
                 halo, per_pass, passes, flag, s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, out: (R, n) rows of dtype code `dtype`; scratch: (R, n) of the same,
// used only when passes > 1, and then `bar` one unsigned word.  The
// odd-even cycles (kernels/cpm_kernels.py oddeven_plan): blocks of
// `warps` warps, tiles of `interior` lanes and `halo` lanes more on
// either side, `passes` passes of at most `per_pass` cycles (at most
// `halo` where a row has more than one tile); float dtypes scan for NaN
// into `nanf` ((R, ceil(n / 1024)) bytes) first.
// nplan == 0: every row takes the cycles (a bounded sort, steps < n).
// nplan > 0 (steps >= n): the bitonic route's `plan` (nplan passes of 4
// numbers, host memory) over rows padded to P lanes in tiles of T keys,
// in groups of G rows, with `keys` an (R, P) int32 buffer when P > T;
// float dtypes first flag their NaN rows in `flag` ((R,) int32), which
// then take the cycles.
int oddeven_sort_launch(const void* x, void* out, void* scratch, int R,
                        long long n, long long steps, int warps,
                        long long interior, long long halo,
                        long long per_pass, int passes, unsigned char* nanf,
                        unsigned* bar, int* keys, int* flag, long long P,
                        int T, int G, int nplan, const long long* plan,
                        int dtype, void* stream) {
  if (R <= 0 || n <= 0 || steps < 0 || steps > 0x7fffffffLL ||
      nplan < 0 || (nplan > 0 && (steps < n || plan == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    if (nplan > 0)
      return run_full<Tr>(x, out, scratch, nanf, bar, R, n, steps, warps,
                          interior, halo, per_pass, passes, keys, flag, P, T,
                          G, nplan, plan, s);
    return run<Tr>(x, out, scratch, nanf, bar, R, n, steps, warps, interior,
                   halo, per_pass, passes, nullptr, s);
  });
  return 0;
}

}  // extern "C"
