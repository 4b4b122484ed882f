// One launch for a fused group of CPM broadcast instructions (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:809 (fused_stream,
// pallas_call at :882; per-instruction body _fused_apply at :742).
//
// What it computes: for every (N,) row of an (R, N) int32 or float32
// buffer and its §4.2 used-length register, the instruction stream
// activate / shift / insert / delete / truncate / compare /
// substring_match / template_match / stencil, in order; buffer transforms
// update the row and the register, producers write an (R, N) int8 flag
// row or float32 value row.  Every branch equals the JAX body bit for
// bit: moves are word selects, compares are exact, and the float
// producers (template SAD, stencil) round each product and sum in the JAX
// order (this file is built with -fmad=false; the adds and products are
// spelled __fadd_rn / __fmul_rn besides).
//
// What bounds it on the H100: device-memory bytes — each row is read once
// and written once, plus its operands and producer outputs; the work per
// element is a few integer compares.  At the serving commit (R = 4 rows of
// N = 320 tokens, insert -> truncate) that is ~10 KB, so a launch costs its
// fixed latency; on the paper's (64, 1,048,576) rows the probe stream
// (shift, compare, activate, stencil) moves 14 bytes a lane, 0.28 ms at
// 3.35 TB/s.
//
// What the design does about it (the plan is fused_plan in
// kernels/cpm_kernels.py, which reads nothing on the device):
//  * Tiles with halos.  Every row is cut into tiles of `tile` lanes; a
//    block stages a tile with `halo_l` lanes before it and `halo_r` after
//    it (its window) in shared memory and runs the whole stream there, so
//    the grid is R x tiles blocks (block_r rows a block, looped) and a
//    group is one launch however long the rows.  A block writes only its
//    interior lanes and their producer outputs.  The halos are what the
//    stream reaches: each move adds its reach on its side (shift |shift|,
//    insert k from the left, delete k from the right), each producer its
//    own reach at its point in the stream.  A move at slot s reads slot s
//    and the slot of its source lane, into a second buffer (one barrier a
//    move); slots whose source lies outside the window hold garbage that
//    no interior lane reaches.  A halo lane outside [0, N) is never a
//    move's source: cpm_shift_src drops content moved past the row ends.
//    A window inside the row takes a move in one of three forms, the same
//    for the whole block (move_form): untouched (the buffer stays, no
//    barrier), wholly moved (a copy from slot s - shift), or lane by lane.
//  * Reads that wrap after a move — the hard part.  template_match reads
//    lane (i + j) mod N, a wrapping stencil (i + d) mod N; at a row's last
//    tile those are the row's head lanes AFTER the moves before them.  So
//    the window is circular: slot s holds lane (base + s) mod N, where
//    base is the tile's first lane less halo_l, and every move computes
//    slot s from the lane index that slot holds.  The first tile's window
//    holds the row's tail before lane 0 and the last tile's the row's head
//    after lane N - 1, each moved like any other lane, so a wrapped read
//    finds the moved head (or tail) in the window.  (substring_match's
//    start flags read lanes i .. i + m - 1 only where i <= N - m, which
//    never wraps.)  Rows shorter than a window hold a lane more than once;
//    each copy moves alike.
//  * Wide moves: the pass form.  An instruction whose reach would take a
//    pass's halo past the plan's cap (a shift by thousands of lanes, a
//    template of thousands of items) starts a new pass and reads device
//    memory: a move while its window is staged (each slot gathered from
//    its source lane), a producer at its interior lanes.  The passes of a
//    group run in one cooperative launch (every block resident or the
//    launch refused), the rows ping-ponging between `out` and `scratch`,
//    read through L2 (__ldcg), and a grid barrier between passes
//    (cpm_grid_barrier: a block that waits about a minute traps).  A
//    plan of one pass is a plain launch.
//  * The §4.2 length register stays a per-row value: each block replays
//    the scalar updates of the instructions before its pass, so every
//    tile of a row computes it alike; a row's first tile writes it.
//  * Staging in 16-byte vectors where aligned (a window's first slot is
//    put on a 16-byte boundary of the row), FS_STAGE of them a thread in
//    flight, scalar loads on the wrapped and ragged edges.  Outputs leave
//    16 lanes a thread: flags as one 16-byte store, floats and the row as
//    float4 / uint4, on groups of 16 lanes aligned to the row's 16-lane
//    boundaries (scalar stores at a tile's ragged ends).  A thread reading
//    its own 16-lane group would put a warp's reads in two banks, so the
//    window's 4-word chunks are permuted inside 32-word blocks (fs_slot).
//  * Registers capped so that three blocks share an SM: a block's phases
//    (staging, each instruction, the stores) run one after another behind
//    barriers, and the other blocks fill the gaps.
//  * The static instruction tuple and the plan are a by-value
//    __grid_constant__ kernel parameter: opcode, static ints (k, shift,
//    m), flags, operand pointers with a row stride (0 for a broadcast
//    (1, k) operand), stencil taps, tile, halos and passes — no
//    descriptor copy to the device before a launch.
//  * One body with the eager kernels: the compare branch calls cpm_cmp,
//    activate cpm_activate_lanes (the modulo once for 16 lanes, then
//    stepped), the moves cpm_shift_src, template cpm_sad and the stencil
//    cpm_stencil_lanes over 16 adjacent outputs (cpm_ops.cuh).
//  * Rows the plan holds in one tile (n <= tile: the serving commit's)
//    run fused_resident_kernel instead, the kernel's first design: a
//    block per block_r rows, the whole row twice in shared memory.  There
//    a tile buys nothing, and the tiled kernel's fixed work costs: its
//    prologue (the plan's index arithmetic, two integer divisions, about
//    170 dependent instructions on the uniform datapath), its window
//    staging and store bookkeeping take about 1,700 cycles more a block,
//    and at (4, 320) it ran 0.0036 ms against 0.0027 (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cpm_ops.cuh"     // cpm_cmp and the shared lane rules

#define FS_MAX_INSTR 16
#define FS_MAX_TAPS 64
#define FS_THREADS 256
#define FS_GROUP 16        // lanes a thread writes at once
#define FS_PAD 16          // slots either side of a window's buffer
#define FS_STAGE 4         // staging loads a thread keeps in flight
#define FS_BLOCKS_PER_SM 3 // registers capped so that 3 blocks fit an SM

namespace {

enum Op { ACTIVATE, SHIFT, INSERT, DELETE, TRUNCATE, COMPARE, SUBSTRING,
          TEMPLATE, STENCIL };
enum Flag { F_FILL = 1, F_MASK = 2, F_START = 4, F_TAIL = 8, F_WRAP = 16,
            F_CTF = 32 };

}  // namespace

// Layout mirrored by ctypes in repro_torch/kernels/cpm_kernels.py.
struct FsInstr {
  int op, k, shift, m;
  int flags, cmp, ntaps, tap_off;
  int odt0, odt1, ostride0, ostride1;  // dtype 0 int32 / 1 float32
  const void* o0;
  const void* o1;
  void* out;
};

struct FsProgram {
  int n_instr, x_float;
  int tile, halo_l, halo_r, n_pass;    // the plan (fused_plan)
  int lead_mask;                       // bit p: pass p's first instruction
                                       // reads device memory
  int pass_end[FS_MAX_INSTR];          // pass p: [pass_end[p-1], pass_end[p])
  FsInstr ins[FS_MAX_INSTR];
  float taps[FS_MAX_TAPS];
};

namespace {

__device__ __forceinline__ float as_f(uint32_t w) { return __uint_as_float(w); }

__device__ __forceinline__ const uint32_t* opnd(const FsInstr& I, int which,
                                                int row) {
  const uint32_t* base = static_cast<const uint32_t*>(which ? I.o1 : I.o0);
  return base + (long long)row * (which ? I.ostride1 : I.ostride0);
}
__device__ __forceinline__ int opnd_i(const FsInstr& I, int which, int row,
                                      int j) {
  return (int)opnd(I, which, row)[j];
}
__device__ __forceinline__ float opnd_f32(const FsInstr& I, int which,
                                          int row, int j) {
  const uint32_t w = opnd(I, which, row)[j];
  const int dt = which ? I.odt1 : I.odt0;
  return dt ? as_f(w) : __int2float_rn((int)w);
}

__device__ __forceinline__ bool word_eq(uint32_t a, uint32_t b, bool fl) {
  return fl ? as_f(a) == as_f(b) : a == b;
}

__device__ __forceinline__ float word_f32(uint32_t w, bool fl) {
  return fl ? as_f(w) : __int2float_rn((int)w);
}

__device__ __forceinline__ bool is_move(int op) {
  return op == SHIFT || op == INSERT || op == DELETE;
}

// A window of W slots lives in a buffer of fs_buffer(W) words: FS_PAD
// slots either side (reads of the lanes of a 16-lane group beyond the tile
// land there) and 32-word blocks inside which fs_slot permutes the 4-word
// chunks (the chunk index XOR the block index), so that the threads of a
// warp, each reading its own 16-lane group, spread over the banks (a
// uint4 a thread: no conflict; a word a thread: 4-way, not 16-way), while
// a chunk stays 16 contiguous, aligned bytes.
__host__ __device__ __forceinline__ int fs_buffer(int W) {
  return (W + 2 * FS_PAD + 31) / 32 * 32;
}
__device__ __forceinline__ int fs_slot(int s) {
  const int x = s + FS_PAD;
  return x ^ (((x >> 5) & 7) << 2);
}

// the lane window position p holds (p taken modulo n)
__device__ __forceinline__ int fs_lane(long long p, int n) {
  return cpm_stencil_lane(p, n, true);
}

// the §4.2 length register after instruction I
__device__ __forceinline__ int ul_after(const FsInstr& I, int row, int ul,
                                        int n) {
  if (I.op == INSERT) return min(cpm_wadd(ul, I.k), n);
  if (I.op == DELETE) return max(cpm_wsub(ul, I.k), 0);
  if (I.op == TRUNCATE) return min(ul, opnd_i(I, 0, row, 0));
  return ul;
}

// The offset a move reads from: lane q takes lane q - move_shift or its
// own (nothing moves where that is N or more).
__device__ __forceinline__ int move_shift(const FsInstr& I, int n) {
  const int sh = I.op == SHIFT ? I.shift : (I.op == INSERT ? I.k : -I.k);
  return (sh >= n || sh <= -n) ? 0 : sh;
}

// One move of one row, its operands read once: _shift_vals over [start,
// end] by `shift`, then insert's broadcast write (lanes [put_lo, put_lo +
// put_k) take put[q - put_lo]) and delete's fill of [dead_lo, dead_hi).
struct Move {
  int start, end, shift, put_lo, dead_lo, dead_hi;
  unsigned put_k;
  bool has_fill;
  uint32_t fill;
  const uint32_t* put;
};

__device__ __forceinline__ Move make_move(const FsInstr& I, int row,
                                          int ul) {
  Move m;
  m.put_lo = m.dead_lo = m.dead_hi = 0;
  m.put_k = 0u;
  m.has_fill = false;
  m.fill = 0u;
  m.put = nullptr;
  if (I.op == SHIFT) {
    m.start = opnd_i(I, 0, row, 0);
    m.end = opnd_i(I, 0, row, 1);
    m.shift = I.shift;
    m.has_fill = I.flags & F_FILL;
    if (m.has_fill) m.fill = opnd(I, 1, row)[0];
    return m;
  }
  const int pos = opnd_i(I, 0, row, 0);
  m.end = cpm_wsub(ul, 1);
  if (I.op == INSERT) {
    m.start = pos;
    m.shift = I.k;
    m.put_lo = pos;
    m.put_k = (unsigned)I.k;
    m.put = opnd(I, 1, row);
  } else {
    m.start = cpm_wadd(pos, I.k);
    m.shift = -I.k;
    m.fill = opnd(I, 1, row)[0];
    m.dead_lo = cpm_wsub(ul, I.k);
    m.dead_hi = ul;
  }
  return m;
}

// The word lane q holds after the move; rd(j) reads lane j before it.
template <class Rd>
__device__ __forceinline__ uint32_t move_word(const Move& m, int q, int n,
                                              Rd rd) {
  const int src = cpm_shift_src(q, n, m.start, m.end, m.shift, m.has_fill);
  uint32_t w = src < 0 ? m.fill : rd(src);
  const unsigned d = (unsigned)cpm_wsub(q, m.put_lo);
  if (d < m.put_k) w = m.put[d];
  if (q >= m.dead_lo && q < m.dead_hi) w = m.fill;
  return w;
}

// The form a move takes on the window lanes [a, b) of a tile inside the
// row, the same for every thread of the block: 0 where it changes none of
// them, 1 where each takes its source lane (lane - shift) and no write
// overrides it, 2 otherwise (lane by lane, move_word).
__device__ __forceinline__ int move_form(const Move& m, int sh, int n,
                                         long long a, long long b) {
  const long long src_lo = max(m.start, 0), src_hi = min(m.end, n - 1);
  long long dst_lo = 1, dst_hi = 0;              // the lanes sources land on
  if (sh != 0 && src_lo <= src_hi) {
    dst_lo = max(src_lo + sh, 0LL);
    dst_hi = min(src_hi + sh, (long long)n - 1);
  }
  auto meets = [&](long long lo, long long hi) {   // [lo, hi] meets [a, b)
    return lo <= hi && lo < b && hi >= a;
  };
  const bool put = meets(m.put_lo, (long long)m.put_lo + m.put_k - 1) ||
                   meets(m.dead_lo, (long long)m.dead_hi - 1);
  if (!put && !meets(dst_lo, dst_hi) &&
      !(m.has_fill && meets(src_lo, src_hi)))
    return 0;
  if (!put && dst_lo <= a && b - 1 <= dst_hi) return 1;
  return 2;
}

// 16 flags, bit u for lane i0 + u, to out[i0 ..] of a 16-lane-aligned
// group: one 16-byte store where the group is whole, else lanes [a, b).
__device__ __forceinline__ void store_flags(int8_t* out, int i0, int a,
                                            int b, uint32_t bits) {
  if (a == i0 && b == i0 + FS_GROUP &&
      (reinterpret_cast<uintptr_t>(out + i0) & 15) == 0) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = bits >> (4 * k);
      w[k] = (v & 1u) | ((v & 2u) << 7) | ((v & 4u) << 14) |
             ((v & 8u) << 21);
    }
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = a; i < b; ++i) out[i] = (bits >> (i - i0)) & 1u;
  }
}

// M floats (a multiple of 4), v[u] for lane j0 + u, to out[j0 ..]: float4
// stores where all M lanes lie in [a, b), else lane by lane.
template <int M>
__device__ __forceinline__ void store_floats(float* out, int j0, int a,
                                             int b, const float (&v)[M]) {
  if (j0 >= a && j0 + M <= b &&
      (reinterpret_cast<uintptr_t>(out + j0) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < M / 4; ++k)
      reinterpret_cast<float4*>(out + j0)[k] = make_float4(
          v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int u = 0; u < M; ++u)
      if (j0 + u >= a && j0 + u < b) out[j0 + u] = v[u];
  }
}

// One producer's outputs at the 16-lane group i0 .. i0 + 15 of `row`, of
// which lanes [a, b) are the tile's; rd(p) is the word at row position p
// (taken modulo n): the window, or device memory for a pass's lead.
template <class Rd>
__device__ __forceinline__ void produce(const FsProgram& prog,
                                        const FsInstr& I, int row,
                                        long long rowoff, int i0, int a,
                                        int b, int n, int ul, Rd rd) {
  const bool xf = prog.x_float != 0;
  switch (I.op) {
    case ACTIVATE: {
      const uint32_t bits = cpm_activate_lanes<FS_GROUP>(
          i0, opnd_i(I, 0, row, 0), opnd_i(I, 0, row, 1),
          opnd_i(I, 0, row, 2));
      store_flags(static_cast<int8_t*>(I.out) + rowoff, i0, a, b, bits);
      break;
    }
    case COMPARE: {
      uint32_t bits = 0u;
      if (I.flags & F_MASK) {
        const int m = opnd_i(I, 1, row, 0);
        const int d = opnd_i(I, 0, row, 0) & m;
        for (int i = a; i < b; ++i)
          if (cpm_cmp<int>(I.cmp, (int)rd(i) & m, d) && i < ul)
            bits |= 1u << (i - i0);
      } else if (I.flags & F_CTF) {
        const float d = as_f(opnd(I, 0, row)[0]);
        for (int i = a; i < b; ++i)
          if (cpm_cmp<float>(I.cmp, word_f32(rd(i), xf), d) && i < ul)
            bits |= 1u << (i - i0);
      } else {
        const int d = opnd_i(I, 0, row, 0);
        for (int i = a; i < b; ++i)
          if (cpm_cmp<int>(I.cmp, (int)rd(i), d) && i < ul)
            bits |= 1u << (i - i0);
      }
      store_flags(static_cast<int8_t*>(I.out) + rowoff, i0, a, b, bits);
      break;
    }
    case SUBSTRING: {
      // the M-step carry chain of _substring_ends_vals in closed form:
      // lane e ends a match iff e >= m-1, e < ul and the m lanes ending at
      // e equal the needle; start flags read the end flag m-1 lanes on,
      // only where i <= n - m (so nothing wraps)
      const uint32_t* nee = opnd(I, 0, row);
      const int m = I.m;
      const bool start = I.flags & F_START;
      uint32_t bits = 0u;
      for (int i = a; i < b; ++i) {
        const long long e = start ? (long long)i + m - 1 : i;
        bool ok = m >= 1 && e >= m - 1 && e < ul &&
                  (!start || (long long)i <= (long long)n - m);
        for (int t = 0; ok && t < m; ++t)
          ok = word_eq(rd(e - m + 1 + t), nee[t], xf);
        if (ok) bits |= 1u << (i - i0);
      }
      store_flags(static_cast<int8_t*>(I.out) + rowoff, i0, a, b, bits);
      break;
    }
    case TEMPLATE: {
      const int m = I.m;
      float v[FS_GROUP];
#pragma unroll
      for (int u = 0; u < FS_GROUP; ++u) {
        const int i = i0 + u;
        v[u] = 0.f;
        if (i < a || i >= b) continue;
        float acc = cpm_sad(
            m, [&](int j) { return word_f32(rd((long long)i + j), xf); },
            [&](int j) { return opnd_f32(I, 0, row, j); });
        if ((I.flags & F_TAIL) && !((long long)i + m <= ul))
          acc = __int_as_float(0x7f800000);      // +inf
        v[u] = acc;
      }
      store_floats(static_cast<float*>(I.out) + rowoff, i0, a, b, v);
      break;
    }
    case STENCIL: {
      // without wrap, lanes outside the row and the dead tail read 0: lane
      // p reads itself only below lim (one unsigned compare)
      // (two runs of 8 outputs, each a window of 8 registers)
      const bool wrap = I.flags & F_WRAP;
      const unsigned lim = (unsigned)max(0, min(n, ul));
#pragma unroll
      for (int h = 0; h < FS_GROUP; h += FS_GROUP / 2) {
        const int j0 = i0 + h;
        float v[FS_GROUP / 2];
        cpm_stencil_lanes<FS_GROUP / 2>(
            v, prog.taps + I.tap_off, I.ntaps, [&](int d) {
              const int p = j0 + d;
              return wrap || (unsigned)p < lim ? word_f32(rd(p), xf) : 0.f;
            });
        store_floats(static_cast<float*>(I.out) + rowoff, j0, a, b, v);
      }
      break;
    }
    default:
      break;
  }
}

// The groups of 16 lanes, aligned to the row's 16-lane boundaries, that
// cover lanes [t0, hi) of `row`: body(i0, a, b) for each (thread-strided).
template <class Body>
__device__ __forceinline__ void for_groups(long long rowoff, int t0, int hi,
                                           Body body) {
  const int g0 = t0 - (int)((rowoff + t0) & (FS_GROUP - 1));
  const int ng = (hi - g0 + FS_GROUP - 1) / FS_GROUP;
  for (int g = threadIdx.x; g < ng; g += FS_THREADS) {
    const int i0 = g0 + g * FS_GROUP;
    body(i0, max(i0, t0), min(i0 + FS_GROUP, hi));
  }
}

// Instructions [first, end) of the stream on the tile of `row` at lane t0:
// stage the window from `in`, run them, write the interior to `out`.
__device__ void run_tile(const FsProgram& prog, const uint32_t* in,
                         uint32_t* out, const int* __restrict__ ul_in,
                         int* __restrict__ ul_out, int row, int t0,
                         int first, int end, bool lead, bool last,
                         bool coherent, int n, int W, uint32_t* buf0,
                         uint32_t* buf1) {
  const long long rowoff = (long long)row * n;
  const uint32_t* rin = in + rowoff;
  int ul = ul_in[row];
  for (int s = 0; s < first; ++s) ul = ul_after(prog.ins[s], row, ul, n);
  // slot s holds lane (base + s) mod n; slot 0 on a 16-byte boundary
  const int align = (int)((rowoff + t0 - prog.halo_l) & 3);
  const long long base = (long long)t0 - prog.halo_l - align;
  const int hi = (int)min((long long)t0 + prog.tile, (long long)n);
  // a window inside the row: slot k holds lane base + k, no modulo
  const bool inside = base >= 0 && base + W <= n;
  uint32_t* cur = buf0;
  uint32_t* nxt = buf1;
  int s = first;
  // several passes read what other blocks wrote in this launch: through
  // L2 (__ldcg), never a stale L1 line; one pass reads through L1
  auto mem = [&](int j) { return coherent ? __ldcg(rin + j) : rin[j]; };
  if (lead && is_move(prog.ins[first].op)) {      // a wide move, staged
    const Move mv = make_move(prog.ins[first], row, ul);
    for (int k = threadIdx.x; k < W; k += FS_THREADS)
      cur[fs_slot(k)] = move_word(mv, fs_lane(base + k, n), n, mem);
    ul = ul_after(prog.ins[first], row, ul, n);
    ++s;
  } else {
    // FS_STAGE 16-byte loads of a thread in flight at once
    const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
    for (int c0 = threadIdx.x; c0 < W / 4; c0 += FS_THREADS * FS_STAGE) {
      uint4 v[FS_STAGE];
#pragma unroll
      for (int u = 0; u < FS_STAGE; ++u) {
        const int c = c0 + u * FS_THREADS;
        const long long p0 = base + 4 * c;
        if (c < W / 4 && vec && p0 >= 0 && p0 + 4 <= n) {
          const uint4* src = reinterpret_cast<const uint4*>(rin + p0);
          v[u] = coherent ? __ldcg(src) : *src;
        }
      }
#pragma unroll
      for (int u = 0; u < FS_STAGE; ++u) {
        const int c = c0 + u * FS_THREADS;
        const long long p0 = base + 4 * c;
        if (c >= W / 4) break;
        if (vec && p0 >= 0 && p0 + 4 <= n) {
          *reinterpret_cast<uint4*>(cur + fs_slot(4 * c)) = v[u];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cur[fs_slot(4 * c) + j] = mem(fs_lane(p0 + j, n));
        }
      }
    }
  }
  __syncthreads();
  if (lead && s == first) {                       // a wide producer
    for_groups(rowoff, t0, hi, [&](int i0, int a, int b) {
      produce(prog, prog.ins[first], row, rowoff, i0, a, b, n, ul,
              [&](long long p) { return mem(fs_lane(p, n)); });
    });
    ++s;
  }
  for (; s < end; ++s) {
    const FsInstr& I = prog.ins[s];
    if (is_move(I.op)) {
      const Move mv = make_move(I, row, ul);
      const int sh = move_shift(I, n);
      const int lo = max(0, sh), top = min(W, W + sh);
      // a block-uniform form where the window lies inside the row: an
      // untouched window keeps its buffer, a wholly moved one copies
      const int form =
          inside ? move_form(mv, sh, n, base + lo, base + top) : 2;
      if (form == 1) {
        for (int k = lo + threadIdx.x; k < top; k += FS_THREADS)
          nxt[fs_slot(k)] = cur[fs_slot(k - sh)];
      } else if (form == 2) {
        for (int k = lo + threadIdx.x; k < top; k += FS_THREADS) {
          const int q = inside ? (int)base + k : fs_lane(base + k, n);
          nxt[fs_slot(k)] = move_word(
              mv, q, n, [&](int j) { return cur[fs_slot(k + (j - q))]; });
        }
      }
      if (form != 0) {
        __syncthreads();                          // nxt complete
        uint32_t* t = cur;
        cur = nxt;
        nxt = t;
      }
    } else if (I.op != TRUNCATE) {
      for_groups(rowoff, t0, hi, [&](int i0, int a, int b) {
        produce(prog, I, row, rowoff, i0, a, b, n, ul,
                [&](long long p) {
                  return cur[fs_slot((int)p - (int)base)];
                });
      });
    }
    ul = ul_after(I, row, ul, n);
  }
  // the interior, in 4-lane chunks aligned to the row (slot 4c holds an
  // aligned lane)
  uint32_t* rout = out + rowoff;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int c0 = (int)((t0 - base) / 4), c1 = (int)((hi - 1 - base) / 4);
  for (int c = c0 + threadIdx.x; c <= c1; c += FS_THREADS) {
    const long long p0 = base + 4 * c;
    if (vec && p0 >= t0 && p0 + 4 <= hi) {
      *reinterpret_cast<uint4*>(rout + p0) =
          *reinterpret_cast<const uint4*>(cur + fs_slot(4 * c));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j >= t0 && p0 + j < hi)
          rout[p0 + j] = cur[fs_slot(4 * c) + j];
    }
  }
  if (last && t0 == 0 && threadIdx.x == 0) ul_out[row] = ul;
  __syncthreads();                                // buffers reused
}

__global__ void __launch_bounds__(FS_THREADS, FS_BLOCKS_PER_SM)
fused_tiles_kernel(const uint32_t* __restrict__ x, uint32_t* xo,
                   uint32_t* scratch, const int* __restrict__ ul_in,
                   int* __restrict__ ul_out, unsigned* bar, int R, int n,
                   int block_r, int tiles,
                   const __grid_constant__ FsProgram prog) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = (prog.halo_l + prog.tile + prog.halo_r + 6) / 4 * 4;
  uint32_t* const buf0 = smem;
  uint32_t* const buf1 = smem + fs_buffer(W);
  const int items = (R + block_r - 1) / block_r * tiles;
  const int P = prog.n_pass;
  int first = 0;
  for (int p = 0; p < P; ++p) {
    const int end = prog.pass_end[p];
    // pass p reads what pass p - 1 wrote; the last pass writes xo
    const uint32_t* in = p == 0 ? x : ((P - p) % 2 == 0 ? xo : scratch);
    uint32_t* out = (P - 1 - p) % 2 == 0 ? xo : scratch;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int rb = it / tiles;
      const int t0 = (it - rb * tiles) * prog.tile;
      const int r_end = min(R, (rb + 1) * block_r);
      for (int row = rb * block_r; row < r_end; ++row)
        run_tile(prog, in, out, ul_in, ul_out, row, t0, first, end,
                 (prog.lead_mask >> p & 1) != 0, p + 1 == P, P > 1, n, W,
                 buf0, buf1);
    }
    if (p + 1 < P) cpm_grid_barrier(bar, (unsigned)(p + 1) * gridDim.x);
    first = end;
  }
}

// _shift_vals: the word at lane i after moving [start, end] by `shift`
__device__ __forceinline__ uint32_t shift_val(const uint32_t* cur, int i,
                                              int n, int start, int end,
                                              int shift, bool has_fill,
                                              uint32_t fill) {
  const int src = cpm_shift_src(i, n, start, end, shift, has_fill);
  return src < 0 ? fill : cur[src];
}

// Rows held in one tile: a block per block_r rows, each row resident
// twice in shared memory, a lane a thread-stride, one barrier a move (see
// fused_stream_launch).
__global__ void __launch_bounds__(FS_THREADS)
fused_resident_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ xo,
                      const int* __restrict__ ul_in,
                      int* __restrict__ ul_out, int R, int n, int block_r,
                      const __grid_constant__ FsProgram prog) {
  extern __shared__ uint32_t rowbuf[];                 // [2][n]
  const bool xf = prog.x_float != 0;
  const int r_end = min(R, (blockIdx.x + 1) * block_r);
  for (int row = blockIdx.x * block_r; row < r_end; ++row) {
    uint32_t* cur = rowbuf;
    uint32_t* nxt = rowbuf + n;
    const uint32_t* xr = x + (long long)row * n;
    for (int i = threadIdx.x; i < n; i += FS_THREADS) cur[i] = xr[i];
    int ul = ul_in[row];                               // length register
    __syncthreads();

    for (int s = 0; s < prog.n_instr; ++s) {
      const FsInstr& I = prog.ins[s];
      const long long orow = (long long)row * n;
      switch (I.op) {
        case ACTIVATE: {
          const int st = opnd_i(I, 0, row, 0), en = opnd_i(I, 0, row, 1);
          const int carry = opnd_i(I, 0, row, 2);
          int8_t* out = static_cast<int8_t*>(I.out) + orow;
          // 16 lanes a thread, the modulo stepped (as the tiled kernel)
          for (int i0 = threadIdx.x * FS_GROUP; i0 < n;
               i0 += FS_THREADS * FS_GROUP)
            store_flags(out, i0, i0, min(i0 + FS_GROUP, n),
                        cpm_activate_lanes<FS_GROUP>(i0, st, en, carry));
          break;
        }
        case SHIFT: {
          const int st = opnd_i(I, 0, row, 0), en = opnd_i(I, 0, row, 1);
          const bool hf = I.flags & F_FILL;
          const uint32_t fill = hf ? opnd(I, 1, row)[0] : 0u;
          for (int i = threadIdx.x; i < n; i += FS_THREADS)
            nxt[i] = shift_val(cur, i, n, st, en, I.shift, hf, fill);
          break;
        }
        case INSERT: {
          const int pos = opnd_i(I, 0, row, 0);
          const uint32_t* v = opnd(I, 1, row);
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            uint32_t w = shift_val(cur, i, n, pos, cpm_wsub(ul, 1), I.k,
                                   false, 0u);
            for (int j = 0; j < I.k; ++j)            // broadcast write
              if (i == cpm_wadd(pos, j)) w = v[j];
            nxt[i] = w;
          }
          break;
        }
        case DELETE: {
          const int pos = opnd_i(I, 0, row, 0);
          const uint32_t fill = opnd(I, 1, row)[0];
          const int lo = cpm_wsub(ul, I.k);
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            uint32_t w = shift_val(cur, i, n, cpm_wadd(pos, I.k),
                                   cpm_wsub(ul, 1), -I.k, false, 0u);
            if (i >= lo && i < ul) w = fill;
            nxt[i] = w;
          }
          break;
        }
        case TRUNCATE:
          ul = min(ul, opnd_i(I, 0, row, 0));
          break;
        case COMPARE: {
          int8_t* out = static_cast<int8_t*>(I.out) + orow;
          if (I.flags & F_MASK) {
            const int m = opnd_i(I, 1, row, 0);
            const int b = opnd_i(I, 0, row, 0) & m;
            for (int i = threadIdx.x; i < n; i += FS_THREADS)
              out[i] = (cpm_cmp<int>(I.cmp, (int)cur[i] & m, b) && i < ul)
                           ? 1 : 0;
          } else if (I.flags & F_CTF) {
            const float b = as_f(opnd(I, 0, row)[0]);
            for (int i = threadIdx.x; i < n; i += FS_THREADS) {
              const float a = xf ? as_f(cur[i]) : __int2float_rn((int)cur[i]);
              out[i] = (cpm_cmp<float>(I.cmp, a, b) && i < ul) ? 1 : 0;
            }
          } else {
            const int b = opnd_i(I, 0, row, 0);
            for (int i = threadIdx.x; i < n; i += FS_THREADS)
              out[i] = (cpm_cmp<int>(I.cmp, (int)cur[i], b) && i < ul)
                           ? 1 : 0;
          }
          break;
        }
        case SUBSTRING: {
          const uint32_t* nee = opnd(I, 0, row);
          const int m = I.m;
          int8_t* out = static_cast<int8_t*>(I.out) + orow;
          const bool start = I.flags & F_START;
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            int e = i;
            bool ok = true;
            if (start) {
              ok = (long long)i <= (long long)n - m;
              e = cpm_fmod_floor((long long)i + m - 1, n);
            }
            bool end_ok = m >= 1 && e >= m - 1 && e < ul;
            for (int t = 0; end_ok && t < m; ++t)
              end_ok = word_eq(cur[e - m + 1 + t], nee[t], xf);
            out[i] = (ok && end_ok) ? 1 : 0;
          }
          break;
        }
        case TEMPLATE: {
          const int m = I.m;
          float* out = static_cast<float*>(I.out) + orow;
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            float acc = cpm_sad(
                m,
                [&](int j) {
                  const uint32_t w =
                      cur[cpm_fmod_floor((long long)i + j, n)];
                  return xf ? as_f(w) : __int2float_rn((int)w);
                },
                [&](int j) { return opnd_f32(I, 0, row, j); });
            if ((I.flags & F_TAIL) && !((long long)i + m <= ul))
              acc = __int_as_float(0x7f800000);      // +inf
            out[i] = acc;
          }
          break;
        }
        case STENCIL: {
          const bool wrap = I.flags & F_WRAP;
          float* out = static_cast<float*>(I.out) + orow;
          for (int i = threadIdx.x; i < n; i += FS_THREADS)
            out[i] = cpm_stencil(
                i, n, prog.taps + I.tap_off, I.ntaps, wrap, [&](int j) {
                  // without wrap the dead tail is zero-padded
                  const uint32_t w = (!wrap && !(j < ul)) ? 0u : cur[j];
                  return xf ? as_f(w) : __int2float_rn((int)w);
                });
          break;
        }
      }
      if (I.op == SHIFT || I.op == INSERT || I.op == DELETE) {
        __syncthreads();                               // nxt complete
        uint32_t* t = cur; cur = nxt; nxt = t;
        if (I.op == INSERT) ul = min(cpm_wadd(ul, I.k), n);
        if (I.op == DELETE) ul = max(cpm_wsub(ul, I.k), 0);
      }
    }
    uint32_t* out_row = xo + (long long)row * n;
    for (int i = threadIdx.x; i < n; i += FS_THREADS) out_row[i] = cur[i];
    if (threadIdx.x == 0) ul_out[row] = ul;
    __syncthreads();                                   // buffers reused
  }
}

// Opt `kern` in to `smem` bytes of dynamic shared memory (above the
// default 48 KB), once for each larger size.
cudaError_t smem_opt_in(const void* kern, size_t smem, size_t* set) {
  if (smem <= *set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *set = smem;
  return e;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The group on rows of n lanes: the resident-row kernel where the plan
// holds a row in one tile, else the tiled kernel (see above).  `scratch`
// (R x n words) and `bar` (one unsigned) are needed only by a tiled plan
// of several passes.
int fused_stream_launch(const void* x, void* xo, void* scratch,
                        const int* ul, int* ulo, unsigned* bar, int R, int n,
                        int block_r, const FsProgram* prog, void* stream) {
  if (R == 0 || n == 0) return 0;
  const int P = prog->n_pass;
  if (block_r < 1 || prog->n_instr < 0 || prog->n_instr > FS_MAX_INSTR ||
      prog->tile < 1 || prog->halo_l < 0 || prog->halo_r < 0 || P < 1 ||
      P > FS_MAX_INSTR || prog->pass_end[P - 1] != prog->n_instr ||
      (P > 1 && (scratch == nullptr || bar == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* xos = static_cast<uint32_t*>(xo);
  if ((long long)n <= prog->tile && 8LL * n <= 232448) {
    // a row held in one tile: the resident-row kernel, whatever the
    // passes (the whole row is in shared memory, so no move needs one)
    const size_t smem = 8 * (size_t)n;
    static size_t smem_set = 48 * 1024;
    const cudaError_t e = smem_opt_in((const void*)fused_resident_kernel,
                                      smem, &smem_set);
    if (e != cudaSuccess) return (int)e;
    fused_resident_kernel<<<(R + block_r - 1) / block_r, FS_THREADS, smem,
                            s>>>(xs, xos, ul, ulo, R, n, block_r, *prog);
    return (int)cudaGetLastError();
  }
  const long long W =
      ((long long)prog->halo_l + prog->tile + prog->halo_r + 6) / 4 * 4;
  if (W > 232448 / 8) return (int)cudaErrorInvalidValue;
  const size_t smem = 8 * (size_t)fs_buffer((int)W);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;
  cudaError_t e = smem_opt_in((const void*)fused_tiles_kernel, smem,
                              &smem_set);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (int)(((long long)n + prog->tile - 1) / prog->tile);
  const long long items = ((long long)R + block_r - 1) / block_r * tiles;
  if (items + block_r >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  if (P == 1) {
    const long long grid = items < 0x7fffffffLL ? items : 0x7fffffffLL;
    fused_tiles_kernel<<<(unsigned)grid, FS_THREADS, smem, s>>>(
        xs, xos, sc, ul, ulo, bar, R, n, block_r, tiles, *prog);
    return (int)cudaGetLastError();
  }
  // several passes: one cooperative launch, every block resident
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_tiles_kernel, FS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long grid = (long long)per_sm * sms;
  if (grid > items) grid = items;
  e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  FsProgram p = *prog;
  void* args[] = {(void*)&xs, (void*)&xos, (void*)&sc, (void*)&ul,
                  (void*)&ulo, (void*)&bar, (void*)&R, (void*)&n,
                  (void*)&block_r, (void*)&tiles, (void*)&p};
  return (int)cudaLaunchCooperativeKernel((const void*)fused_tiles_kernel,
                                          dim3((unsigned)grid),
                                          dim3(FS_THREADS), args, smem, s);
}

}  // extern "C"
