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
//    Here one block owns one (batch, head, q tile) and loops over the kv
//    tiles itself, so nothing crosses blocks and no atomics are needed;
//    q, k, v and o cross device memory once per block.
//  * Each kv tile (64 keys) is staged once in shared memory and reused by
//    every query row of the block.
//  * bf16 inputs (the serving path) run on the tensor cores: mma.sync
//    m16n8k16 with float32 accumulation, one warp per 16 query rows, Q
//    held in registers as A-fragments, S = Q K^T and O += P V fragment to
//    fragment.  Products of bf16 values are exact in float32, so S is the
//    TPU kernel's float32 dot up to summation order; P stays near float32
//    by entering the P V product as two bf16 halves (hi + lo).  Rows of
//    the K/V tiles are padded by 8 bf16 so fragment loads hit distinct
//    banks.
//  * float32 inputs run on the FP32 pipes (67 TFLOP/s; TF32 would drop
//    the float32 contract): one warp per row at a time, lane j scoring
//    keys j and j+32, K rows padded to D+1 floats for distinct banks.
//  * Causal tiles that lie wholly after the q tile, and window tiles that
//    lie wholly before it, are skipped: their contributions are exactly
//    zero (exp(-1e30 - m) == 0, alpha == 1; or erased by alpha == 0)
//    whenever every row of the tile sees an unmasked key, which the skip
//    condition checks.  Work follows the mask, not Skv.
// The tiles load with plain loads, one stage at a time; TMA, cp.async
// pipelining and wgmma are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

// dtype 0: float32 (FP32 kernel); 1: bfloat16 (tensor-core kernel)
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           Args a, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, a, s);
  if (dtype == 1) return launch_mma<D>(q, k, v, o, a, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int D, int dtype, const void* q, const void* k, const void* v,
             void* o, Args a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, a, s);
    case 32: return launch<32>(dtype, q, k, v, o, a, s);
    case 64: return launch<64>(dtype, q, k, v, o, a, s);
    case 128: return launch<128>(dtype, q, k, v, o, a, s);
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
