// Blocked online-softmax attention for Hopper (sm_90a), forward only.
//
// Replaces: src/repro/kernels/flash_attention.py:73 (flash_attention,
// pallas_call at :97, body _attn_kernel at :26).
//
// What it computes: o = softmax(q k^T * D^-0.5 + mask) v per (batch, head),
// GQA head h reading kv head h / (H / KVH); causal keeps cols <= rows, the
// window keeps cols > rows - window (absolute indices); masked scores are
// NEG_INF = -1e30, exactly as the TPU kernel sets them.  Scores, running
// max m, denominator l and accumulator are float32; the denominator is
// floored at 1e-30; the output is cast to the input type.
//
// What bounds it on the H100: at the prefill shapes of the main path
// (granite-8b, B=4, H=32, KVH=8, S=256, D=128, bf16) the work is ~2.2
// GFLOP of causal products against ~21 MB of q/k/v/o, so the roofline
// floor is the bytes (~6 us at 3.35 TB/s) rather than the tensor cores
// (~2 us at 989 TFLOP/s bf16).
//
// What the design does about it:
//  * The TPU kernel carries m, l and acc across the kv grid axis in VMEM
//    scratch, which is sound only because TPU grid steps run in order.
//    Here one block owns one (batch, head or heads, q tile) and loops over
//    the kv tiles itself, so nothing crosses blocks and no atomics are
//    needed;
//    q, k, v and o cross device memory once per block.
//  * Each kv tile (64 keys) is staged once in shared memory and reused by
//    every query row of the block (of every head, in the wgmma kernel).
//  * bf16 inputs with D = 64, 128 or 256 (the serving paths: granite-8b's
//    D = 128, recurrentgemma-9b's 256) run on Hopper's warpgroup
//    products: wgmma m64n64k16 with float32 accumulation, S = Q K^T from
//    shared memory and O += P V with P from registers, fed by TMA tile
//    loads that a producer warp keeps one K/V tile ahead on mbarriers, a
//    block serving two q heads of a GQA group where H / KVH is even (one
//    at D = 256; flash_fwd_wgmma_kernel below).
//    Products of bf16 values are exact in float32, so S is the TPU
//    kernel's float32 dot up to summation order; P stays near float32 by
//    entering the P V product as two bf16 halves (hi + lo), two products
//    on the same V tile.
//  * bf16 inputs with D = 16 or 32 take the mma.sync m16n8k16 kernel
//    (flash_fwd_mma_kernel), a route by shape: their rows are shorter
//    than the 128-byte swizzled boxes the wgmma kernel is built on.  One
//    warp per 16 query rows, Q held in registers as A-fragments, K/V
//    tiles staged with plain loads in rows padded by 8 bf16 so fragment
//    loads hit distinct banks.
//  * float32 inputs run on the FP32 pipes (67 TFLOP/s; TF32 would drop
//    the float32 contract): one warp per row at a time, lane j scoring
//    keys j and j+32, K rows padded to D+1 floats for distinct banks.
//  * D = 256 (recurrentgemma-9b: H = 16 q heads over one kv head) doubles
//    what a query row carries.  In bf16 it runs the same wgmma kernel with
//    one consumer warpgroup a block (HPB = 1): its 64 x 256 float32 O
//    accumulator is 128 registers a thread, Q is four 64-column boxes
//    (32 KB) and each K or V tile four more (32 KB), double-buffered: 160
//    KB of the 227 KB of shared memory.  Two heads a block would take 193
//    KB and cap 288 threads at 227 registers each.  In float32 it
//    runs the FP32 kernel, whose 64-key tile at D = 256 takes 138 KB.
//  * Causal tiles that lie wholly after the q tile, and window tiles that
//    lie wholly before it, are skipped: their contributions are exactly
//    zero (exp(-1e30 - m) == 0, alpha == 1; or erased by alpha == 0)
//    whenever every row of the tile sees an unmasked key, which the skip
//    condition checks.  Work follows the mask, not Skv.  Two traps:
//     - the window mask cols > rows - window is on absolute indices (as
//       in the TPU kernel), not aligned to the end of the keys: with
//       Sq = Skv = 2,304 and window 2,048, rows 0 .. 2,047 keep every
//       causal key and rows from 2,048 on lose their first keys (row r
//       keeps r - 2,047 .. r);
//     - the first tile kept is the one holding key q0 - window + 1, the
//       earliest key any row of the q tile keeps; every row keeps its own
//       diagonal key (window >= 1), so no row's only live tile is
//       skipped, and a row whose first kept tile is all masked for it
//       (p = exp(0) on -1e30 scores) has that erased by the live tile
//       after it (alpha = exp(-1e30 - m) == 0), as on the TPU.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;          // keys per staged kv tile
constexpr int kMaxRowsPerWarp = 16; // block_q <= 128
constexpr float kNegInf = -1e30f;        // the TPU kernel's NEG_INF
#define kNegInfinity (-__int_as_float(0x7f800000))

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  int B, H, KVH, Sq, Skv;
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2;
  int causal, has_window, window;
  float scale;
  int block_q;
};

// ---------------------------------------------------------------------------
// float32 inputs: FP32 FMAs, one warp per query row at a time
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Args a) {
  constexpr int DL = (D + 31) / 32;       // output columns per lane
  extern __shared__ float smem[];
  float* Ks = smem;                        // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);        // [kTile][D]
  float* Qs = Vs + kTile * D;              // [kWarps][D]
  float* Ps = Qs + kWarps * D;             // [kWarps][kTile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * a.block_q;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (a.H / a.KVH);
  const float* qb = q + bb * a.qs0 + hh * a.qs1;
  const float* kb = k + bb * a.ks0 + kvh * a.ks1;
  const float* vb = v + bb * a.vs0 + kvh * a.vs1;
  float* ob = o + (((long long)bb * a.H + hh) * a.Sq) * D;

  // kv tiles this q tile needs (see the header on exactness)
  const int q_last = min(q0 + a.block_q, a.Sq) - 1;
  int t_lo = 0, t_hi = (a.Skv + kTile - 1) / kTile;
  const bool every_row_live = a.causal && (!a.has_window || a.window >= 1)
                              && q_last < a.Skv;
  if (every_row_live) {
    t_hi = min(t_hi, q_last / kTile + 1);
    if (a.has_window) t_lo = max(0, q0 - a.window + 1) / kTile;
  }

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][DL];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kTile;
    __syncthreads();                       // previous tile fully consumed
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int j = e / D, d = e - j * D, key = key0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < a.Skv) {
        kv = kb[key * a.ks2 + d];
        vv = vb[key * a.vs2 + d];
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;     // row inside the q tile
      const int row = q0 + r;
      if (r < a.block_q && row < a.Sq) {   // warp-uniform
        float* qs = Qs + warp * D;
        for (int d = lane; d < D; d += 32)
          qs[d] = qb[row * a.qs2 + d];
        __syncwarp();

        float s[2];
        bool valid[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = lane + 32 * jj, col = key0 + j;
          valid[jj] = col < a.Skv;
          const float* kr = Ks + j * (D + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot = fmaf(qs[d], kr[d], dot);
          float sc = dot * a.scale;
          bool keep = true;
          if (a.causal) keep = keep && col <= row;
          if (a.has_window) keep = keep && col > row - a.window;
          s[jj] = keep ? sc : kNegInf;
        }
        float tile_max = fmaxf(valid[0] ? s[0] : kNegInfinity,
                               valid[1] ? s[1] : kNegInfinity);
        tile_max = warp_max(tile_max);
        const float m_new = fmaxf(m[i], tile_max);
        const float p0 = valid[0] ? expf(s[0] - m_new) : 0.f;
        const float p1 = valid[1] ? expf(s[1] - m_new) : 0.f;
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + warp_sum(p0 + p1);
        float* ps = Ps + warp * kTile;
        ps[lane] = p0;
        ps[lane + 32] = p1;
        __syncwarp();
        const int nj = min(kTile, a.Skv - key0);
#pragma unroll
        for (int c = 0; c < DL; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            float x = acc[i][c] * alpha;
            for (int j = 0; j < nj; ++j)
              x = fmaf(ps[j], Vs[j * D + d], x);
            acc[i][c] = x;
          }
        }
        m[i] = m_new;
        __syncwarp();                    // qs / ps reused by the next row
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int r = warp + kWarps * i, row = q0 + r;
    if (r >= a.block_q || row >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * D + d] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor-core tiles (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;               // 16 query rows per warp
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows per block

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// P as two bf16 A-fragments whose sum carries ~16 significant bits: the
// TPU kernel multiplies the float32 probabilities by v, so P is not
// rounded to bf16's 8 bits; hi + lo keeps the product near float32.
__device__ __forceinline__ void split_p(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// One warp owns 16 query rows of a 64-row tile; the block stages 64-key
// K/V tiles in shared memory (rows padded by 8 bf16 so the fragment loads
// are free of bank conflicts).  Fragment layout of m16n8k16 (g = lane / 4,
// t = lane % 4): A rows g and g+8, columns 2t, 2t+1 (+8); B column g, rows
// 2t, 2t+1 (+8); C rows g and g+8, columns 2t, 2t+1.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, Args a) {
  constexpr int KC = D / 16;               // k-chunks of D (for S = Q K^T)
  constexpr int NB = D / 8;                // n-blocks of D (for O = P V)
  constexpr int SN = kTile / 8;            // n-blocks of the key tile
  constexpr int PK = kTile / 16;           // k-chunks of the key tile
  constexpr int LD = D + 8;                // padded smem row (bf16)
  __shared__ __align__(16) __nv_bfloat16 Ks[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kTile * LD];
  const uint32_t* Kw = reinterpret_cast<const uint32_t*>(Ks);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (a.H / a.KVH);
  const __nv_bfloat16* qb = q + bb * a.qs0 + hh * a.qs1;
  const __nv_bfloat16* kb = k + bb * a.ks0 + kvh * a.ks1;
  const __nv_bfloat16* vb = v + bb * a.vs0 + kvh * a.vs1;
  __nv_bfloat16* ob = o + (((long long)bb * a.H + hh) * a.Sq) * D;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // this warp's Q rows as A-fragments, resident for the whole kv loop
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e & 1], col = 16 * kc + 2 * t + 8 * (e >> 1);
      qa[kc][e] = r < a.Sq ? *reinterpret_cast<const uint32_t*>(
                                 qb + r * a.qs2 + col)
                           : 0u;
    }

  const int q_last = min(q0 + kMmaRows, a.Sq) - 1;
  int t_lo = 0, t_hi = (a.Skv + kTile - 1) / kTile;
  const bool every_row_live = a.causal && (!a.has_window || a.window >= 1)
                              && q_last < a.Skv;
  if (every_row_live) {
    t_hi = min(t_hi, q_last / kTile + 1);
    if (a.has_window) t_lo = max(0, q0 - a.window + 1) / kTile;
  }

  float oacc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int key0 = tile * kTile;
    __syncthreads();                       // previous tile fully consumed
    for (int w = threadIdx.x; w < kTile * D / 2; w += 32 * kMmaWarps) {
      const int j = w / (D / 2), d = 2 * (w - j * (D / 2)), key = key0 + j;
      uint32_t kw = 0u, vw = 0u;
      if (key < a.Skv) {
        kw = *reinterpret_cast<const uint32_t*>(kb + key * a.ks2 + d);
        vw = *reinterpret_cast<const uint32_t*>(vb + key * a.vs2 + d);
      }
      *reinterpret_cast<uint32_t*>(Ks + j * LD + d) = kw;
      *reinterpret_cast<uint32_t*>(Vs + j * LD + d) = vw;
    }
    __syncthreads();

    float s[SN][4];
#pragma unroll
    for (int nb = 0; nb < SN; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const uint32_t* kr = Kw + (8 * nb + g) * (LD / 2) + t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[nb], qa[kc], kr[8 * kc], kr[8 * kc + 4]);
    }

    float mx[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
#pragma unroll
    for (int nb = 0; nb < SN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1], col = key0 + 8 * nb + 2 * t + (e & 1);
        bool keep = true;
        if (a.causal) keep = keep && col <= r;
        if (a.has_window) keep = keep && col > r - a.window;
        const float x = keep ? s[nb][e] * a.scale : kNegInf;
        // keys past Skv do not exist: -inf leaves max and sum untouched
        s[nb][e] = col < a.Skv ? x : -__int_as_float(0x7f800000);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < SN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        sum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nb][e] *= alpha[e >> 1];

#pragma unroll
    for (int kc = 0; kc < PK; ++kc) {
      uint32_t hi[4], lo[4];
      split_p(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      split_p(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      split_p(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      split_p(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
      const __nv_bfloat16* v0 = Vs + (16 * kc + 2 * t) * LD + g;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const __nv_bfloat16* vc = v0 + 8 * nb;
        const uint32_t b0 = pack_halves(vc[0], vc[LD]);
        const uint32_t b1 = pack_halves(vc[8 * LD], vc[9 * LD]);
        mma_bf16(oacc[nb], hi, b0, b1);
        mma_bf16(oacc[nb], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(ob + (long long)row[h] * D + 8 * nb +
                                   2 * t) =
          pack_bf16(oacc[nb][2 * h] / denom, oacc[nb][2 * h + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16, D = 64 and 128: wgmma fed by TMA tile loads (Hopper)
// ---------------------------------------------------------------------------
//
// A block serves HPB q heads of one GQA group (HPB = 2 where H / KVH is
// even, else 1) over 64 query rows: one consumer warpgroup a head, and
// one producer warp that issues every TMA load.  Q (HPB heads) is loaded
// once; K and V tiles of 64 keys run through a two-stage ring in shared
// memory, `full` mbarriers completed by the TMA's byte count and `empty`
// ones by one arrival of each consumer warp, so the load of tile i + 1
// overlaps the math of tile i and a K/V tile crosses from memory once for
// the HPB heads.  Every box is [64 rows][64 bf16] = 128-byte rows in
// TMA's 128-byte swizzle, the layout wgmma's SW128 descriptors read:
// K-major for Q and K (S = Q K^T, both operands in shared memory), and
// MN-major for V (O += P V, the B operand's transpose bit), with P from
// registers as the A operand (the m16n8k16 fragment each warp's 16 rows
// of the S accumulator already hold).  D = 128 is two 64-column boxes,
// D = 256 four.
// TMA's 4-D maps (D, S, heads, B) take the strided views of the main
// path as they are (byte strides multiples of 16) and zero-fill rows past
// Sq / Skv; keys past Skv are masked to -inf as in the mma.sync kernel.

constexpr int kWgRows = 64;                // query rows of a consumer warpgroup
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kBoxBytes = 64 * 64 * 2;     // one [64][64] bf16 box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// A wait that has not completed after ~2^34 cycles (seconds: a fault of
// the load protocol, never a slow load) traps, so the launch fails where
// it would hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// one [64][64] box of a 4-D map at (c0, c1, c2, c3), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors of a 128-byte-swizzled box: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SW128.  The stride offset steps 8 rows (1,024 bytes) along M/N (K-major)
// or along K (MN-major); the leading offset is unused by a K-major SW128
// operand (CUTLASS sets 1) and, for an MN-major one, steps between
// 64-column atoms, which a 64-column operand never crosses.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, float32) += A (64 x 16, shared memory) * B (16 x 64, shared
// memory), both K-major: S = Q K^T.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) * B (16 x 64, shared memory, MN-major: the
// transpose bit): O += P V.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct WgArgs {
  int H, KVH, Sq, Skv;
  int causal, has_window, window;
  float scale;
};

template <int D, int HPB>
__global__ void __launch_bounds__(128 * HPB + 32, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, WgArgs a) {
  constexpr int DB = D / 64;               // 64-column boxes of a row
  constexpr int kTileBytes = DB * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  // SW128 boxes sit on 1,024-byte boundaries
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;                                  // [HPB][DB] boxes
  uint8_t* Ks = Qs + HPB * kTileBytes;                 // [kStages][DB]
  uint8_t* Vs = Ks + kStages * kTileBytes;             // [kStages][DB]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * kTileBytes);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  // the q tiles that see the most keys start first (grid z is the slowest)
  const int nq = (a.Sq + kWgRows - 1) / kWgRows;
  const int q0 = (nq - 1 - (int)blockIdx.z) * kWgRows;
  const int h0 = blockIdx.x * HPB, bb = blockIdx.y;
  const int kvh = h0 / (a.H / a.KVH);

  // kv tiles this q tile needs (see the header on exactness)
  const int q_last = min(q0 + kWgRows, a.Sq) - 1;
  int t_lo = 0, t_hi = (a.Skv + kTile - 1) / kTile;
  const bool every_row_live = a.causal && (!a.has_window || a.window >= 1)
                              && q_last < a.Skv;
  if (every_row_live) {
    t_hi = min(t_hi, q_last / kTile + 1);
    if (a.has_window) t_lo = max(0, q0 - a.window + 1) / kTile;
  }

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * HPB);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * HPB) {                   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, HPB * kTileBytes);
      for (int j = 0; j < HPB; ++j)
        for (int db = 0; db < DB; ++db)
          tma_load(Qs + (j * DB + db) * kBoxBytes, &qmap, qbar, 64 * db, q0,
                   h0 + j, bb);
      for (int i = 0, t = t_lo; t < t_hi; ++i, ++t) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + s, (i / kStages - 1) & 1);
        mbar_expect_tx(full + s, 2 * kTileBytes);
        for (int db = 0; db < DB; ++db) {
          tma_load(Ks + s * kTileBytes + db * kBoxBytes, &kmap, full + s,
                   64 * db, t * kTile, kvh, bb);
          tma_load(Vs + s * kTileBytes + db * kBoxBytes, &vmap, full + s,
                   64 * db, t * kTile, kvh, bb);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: head h0 + wg, rows q0 + 16 wl + g (+ 8)
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int hh = h0 + wg;
  const int row[2] = {q0 + 16 * wl + g, q0 + 16 * wl + g + 8};
  const uint8_t* Qh = Qs + wg * kTileBytes;

  float oacc[DB][32];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[db][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int i = 0, tile = t_lo; tile < t_hi; ++i, ++tile) {
    const int s = i % kStages;
    const int key0 = tile * kTile;
    mbar_wait(full + s, (i / kStages) & 1);
    const uint8_t* Kt = Ks + s * kTileBytes;
    const uint8_t* Vt = Vs + s * kTileBytes;

    // S = Q K^T: D / 16 k-steps, 32 bytes apart inside a 128-byte row
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss(sc, desc_sw128(Qh + off, 1), desc_sw128(Kt + off, 1));
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);

    // sc[4 nb + e]: row row[e >> 1], key key0 + 8 nb + 2 t4 + (e & 1)
    float mx[2] = {kNegInfinity, kNegInfinity};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1], col = key0 + 8 * nb + 2 * t4 + (e & 1);
        bool keep = true;
        if (a.causal) keep = keep && col <= r;
        if (a.has_window) keep = keep && col > r - a.window;
        const float x = keep ? sc[4 * nb + e] * a.scale : kNegInf;
        // keys past Skv do not exist: -inf leaves max and sum untouched
        sc[4 * nb + e] = col < a.Skv ? x : kNegInfinity;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * nb + e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = expf(sc[e] - m[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += sc[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[db][e] *= alpha[(e >> 1) & 1];

    // P as hi + lo bf16 A fragments, 16 keys a k-step
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {     // n-blocks 2 kc and 2 kc + 1
      split_p(sc[8 * kc], sc[8 * kc + 1], hi[kc][0], lo[kc][0]);
      split_p(sc[8 * kc + 2], sc[8 * kc + 3], hi[kc][1], lo[kc][1]);
      split_p(sc[8 * kc + 4], sc[8 * kc + 5], hi[kc][2], lo[kc][2]);
      split_p(sc[8 * kc + 6], sc[8 * kc + 7], hi[kc][3], lo[kc][3]);
    }
#pragma unroll
    for (int db = 0; db < DB; ++db) reg_fence(oacc[db]);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        // keys 16 kc .. 16 kc + 15 of the box: 16 rows of 128 bytes
        const uint64_t dv = desc_sw128(Vt + db * kBoxBytes + kc * 2048, 64);
        wgmma_rs(oacc[db], hi[kc], dv);
        wgmma_rs(oacc[db], lo[kc], dv);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int db = 0; db < DB; ++db) reg_fence(oacc[db]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with stage s
  }

  __nv_bfloat16* ob = o + (((long long)bb * a.H + hh) * a.Sq) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<uint32_t*>(ob + (long long)row[h] * D + 64 * db +
                                     8 * nb + 2 * t4) =
            pack_bf16(oacc[db][4 * nb + 2 * h] / denom,
                      oacc[db][4 * nb + 2 * h + 1] / denom);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 4-D map (D, S, heads, B) of a bf16 (B, heads, S, D) view with element
// strides (sb, sh, ss) and unit stride on D, in [64][64] boxes, 128-byte
// swizzle, zero fill past each extent.
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
             int B, long long sb, long long sh, long long ss) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int HPB>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Args& a, cudaStream_t stream) {
  constexpr int kTileBytes = (D / 64) * kBoxBytes;
  const int smem = 1024 + (HPB + 2 * kStages) * kTileBytes +
                   (1 + 2 * kStages) * (int)sizeof(uint64_t);
  auto kern = flash_fwd_wgmma_kernel<D, HPB>;
  static bool smem_set = false;            // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap qm, km, vm;
  int rc = make_map(&qm, q, D, a.Sq, a.H, a.B, a.qs0, a.qs1, a.qs2);
  if (rc == 0) rc = make_map(&km, k, D, a.Skv, a.KVH, a.B, a.ks0, a.ks1,
                             a.ks2);
  if (rc == 0) rc = make_map(&vm, v, D, a.Skv, a.KVH, a.B, a.vs0, a.vs1,
                             a.vs2);
  if (rc != 0) return rc;
  const WgArgs w{a.H, a.KVH, a.Sq, a.Skv, a.causal, a.has_window, a.window,
                 a.scale};
  dim3 grid(a.H / HPB, a.B, (a.Sq + kWgRows - 1) / kWgRows);
  kern<<<grid, 128 * HPB + 32, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), w);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, Args a,
               cudaStream_t stream) {
  dim3 grid((a.Sq + kMmaRows - 1) / kMmaRows, a.H, a.B);
  flash_fwd_mma_kernel<D><<<grid, 32 * kMmaWarps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, Args a,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kTile * (D + 1) + kTile * D + kWarps * D +
                       kWarps * kTile);
  auto kern = flash_fwd_f32_kernel<D>;
  static bool smem_set = false;            // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((a.Sq + a.block_q - 1) / a.block_q, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return (int)cudaGetLastError();
}

// dtype 0: float32 (FP32 kernel); 1: bfloat16: the wgmma + TMA kernel for
// D = 64, 128 and 256, the mma.sync one for D = 16 and 32 (a route by shape:
// a 32- or 64-byte row is below the 128-byte swizzled box the wgmma
// kernel's TMA loads and descriptors are built on)
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           Args a, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, a, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if constexpr (D == 256) {
    return launch_wgmma<D, 1>(q, k, v, o, a, s);   // see the header
  } else if constexpr (D >= 64) {
    return (a.H / a.KVH) % 2 == 0 ? launch_wgmma<D, 2>(q, k, v, o, a, s)
                                  : launch_wgmma<D, 1>(q, k, v, o, a, s);
  } else {
    return launch_mma<D>(q, k, v, o, a, s);
  }
}

int dispatch(int D, int dtype, const void* q, const void* k, const void* v,
             void* o, Args a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, a, s);
    case 32: return launch<32>(dtype, q, k, v, o, a, s);
    case 64: return launch<64>(dtype, q, k, v, o, a, s);
    case 128: return launch<128>(dtype, q, k, v, o, a, s);
    case 256: return launch<256>(dtype, q, k, v, o, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; D is unit-stride.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KVH, int Sq, int Skv, int D,
                        long long qs0, long long qs1, long long qs2,
                        long long ks0, long long ks1, long long ks2,
                        long long vs0, long long vs1, long long vs2,
                        int causal, int has_window, int window, float scale,
                        int block_q, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (block_q < 1 || Skv < 1 || KVH < 1 || H % KVH)
    return (int)cudaErrorInvalidValue;
  // rows are independent: the float32 kernel tiles a larger q block by
  // at most 128 rows (16 per warp), the bf16 kernel by 64
  block_q = min(block_q, kWarps * kMaxRowsPerWarp);
  Args a{B, H, KVH, Sq, Skv, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,
         causal, has_window, window, scale, block_q};
  return dispatch(D, dtype, q, k, v, o, a,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
