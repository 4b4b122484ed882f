// Shared device code of the per-op CPM kernels (compare.cu, reduce.cu,
// compact.cu, histogram.cu, super_reduce.cu, oddeven_sort.cu,
// activate.cu, shift_range.cu, template_match.cu, stencil.cu) and of
// fused_stream.cu.
//
//  * cpm_cmp: the §6.1 broadcast-compare predicate, one definition for the
//    eager compare kernel and the fused stream, so the two stay bit
//    identical (ROADMAP, "Shared bodies").
//  * The lane rules of the JAX value bodies that the per-op kernels share
//    with fused_stream.cu, so fused and eager groups stay bit identical:
//    cpm_activate (_activate_vals), cpm_shift_src (_shift_vals),
//    cpm_sad (_sad_vals) and cpm_stencil (_stencil_vals).
//  * cpm_min_takes_a / cpm_max_takes_a and SumOp / MaxOp / MinOp: the
//    combines of the reductions and of the odd-even exchange, with
//    jnp.minimum / jnp.maximum semantics (the port's
//    cpm.semantics.minimum / maximum): NaN wins, the first NaN operand
//    being returned, and -0.0 < +0.0, so a max or min of any multiset is
//    the same whatever the order of combining (CUDA's fmaxf / fminf
//    return the other operand for a NaN).
//  * Element traits, one per storage dtype the kernels take, by the code
//    the Python wrappers pass (kernels/cpm_kernels.py _DTYPE_CODE):
//      0 bool, 1 int8, 2 uint8, 3 int16, 4 int32, 5 float16, 6 bfloat16,
//      7 float32.
//    S is the storage type, A the accumulator of the §7.4/§7.5 reductions
//    as the TPU kernels choose it (_acc_dtype: int32 for integer types,
//    float32 for bool and the floats); acc() widens exactly, store()
//    narrows a value that came from an element back to its bits.
//  * The reductions' run reducer (reduce_strided: threads striding a run
//    of lanes, 16-byte loads in flight) and output conversion (Out), one
//    definition for reduce.cu and super_reduce.cu.
//  * Block-wide reduction and exclusive scan in a fixed order: a warp
//    shuffle tree, then warp 0 over the warp totals.  No atomics, so a
//    float result is the same on every run.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum CpmDtype { DT_BOOL, DT_I8, DT_U8, DT_I16, DT_I32, DT_F16, DT_BF16,
                DT_F32 };

template <typename A>
__device__ __forceinline__ bool cpm_cmp(int c, A a, A b) {
  switch (c) {                       // eq ne lt gt le ge (_CMPCODE)
    case 0: return a == b; case 1: return a != b; case 2: return a < b;
    case 3: return a > b; case 4: return a <= b; default: return a >= b;
  }
}

// int32 arithmetic that wraps like the JAX int32 ops it mirrors
__device__ __forceinline__ int cpm_wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int cpm_wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// Python / jnp floor modulo for b >= 1
__device__ __forceinline__ int cpm_fmod_floor(long long a, int b) {
  long long r = a % b;
  return (int)(r < 0 ? r + b : r);
}

// §3.3 Rule 4, _activate_vals at lane i: start <= i <= end and
// (i - start) mod max(carry, 1) == 0 (int32 difference, floor modulo).
__device__ __forceinline__ bool cpm_activate(int i, int start, int end,
                                             int carry) {
  return i >= start && i <= end &&
         cpm_fmod_floor(cpm_wsub(i, start), max(carry, 1)) == 0;
}

// §4.1 _shift_vals at lane i of an n-lane row whose lanes [start, end]
// move by `shift`: the lane whose value lane i holds afterwards (the
// jnp.roll source where the moved range lands inside the row, lane i
// itself elsewhere), or -1 where lane i was vacated and `has_fill` asks
// for the fill.  Content moved past either row end is dropped.
__device__ __forceinline__ int cpm_shift_src(int i, int n, int start,
                                             int end, int shift,
                                             bool has_fill) {
  const int j = cpm_fmod_floor((long long)i - shift, n);   // roll source
  bool dst = j >= start && j <= end;
  if (shift > 0) dst = dst && i >= shift;
  else if (shift < 0) dst = dst && (long long)i < (long long)n + shift;
  if (dst) return j;
  return (has_fill && i >= start && i <= end) ? -1 : i;
}

// §7.6 _sad_vals at one lane: sum_j |x(j) - t(j)| for j = 0 .. m-1 in
// that order, every difference and sum rounded as written; x(j) is the
// lane j places on (wrapping), t(j) the template's item j, both float32.
template <class X, class T>
__device__ __forceinline__ float cpm_sad(int m, X x, T t) {
  float acc = 0.f;
  for (int j = 0; j < m; ++j)
    acc = __fadd_rn(acc, fabsf(__fsub_rn(x(j), t(j))));
  return acc;
}

// §7.3 _stencil_vals at lane i of an n-lane row: sum over the taps k in
// their order, zero taps skipped, of w_k * x[i - (k - c)] (c = ntaps / 2,
// the index wrapping), every product and sum rounded as written; without
// `wrap` a lane that wrapped around reads 0.  x(j) is lane j as float32.
template <class X>
__device__ __forceinline__ float cpm_stencil(int i, int n, const float* w,
                                             int ntaps, bool wrap, X x) {
  const int c = ntaps / 2;
  float acc = 0.f;
  for (int k = 0; k < ntaps; ++k) {
    if (w[k] == 0.f) continue;
    const int sh = k - c;
    float v = x(cpm_fmod_floor((long long)i - sh, n));
    if (!wrap && ((sh > 0 && i < sh) ||
                  (sh < 0 && (long long)i >= (long long)n + sh)))
      v = 0.f;
    acc = __fadd_rn(acc, __fmul_rn(w[k], v));
  }
  return acc;
}

// Whether min(a, b) is a (else b); a tie of equal integers takes a.
__device__ __forceinline__ bool cpm_min_takes_a(int a, int b) {
  return a <= b;
}
__device__ __forceinline__ bool cpm_min_takes_a(float a, float b) {
  const bool neg = __float_as_uint(a) >> 31;
  return a != a || (b == b && (a < b || (a == b && neg)));
}
// Whether max(a, b) is a (else b).
__device__ __forceinline__ bool cpm_max_takes_a(int a, int b) {
  return a >= b;
}
__device__ __forceinline__ bool cpm_max_takes_a(float a, float b) {
  const bool neg = __float_as_uint(a) >> 31;
  return a != a || (b == b && (a > b || (a == b && !neg)));
}

struct SumOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return (int)((unsigned)a + (unsigned)b);        // two's complement wrap
  }
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct MaxOp {
  template <typename A>
  __device__ __forceinline__ A operator()(A a, A b) const {
    return cpm_max_takes_a(a, b) ? a : b;
  }
};
struct MinOp {
  template <typename A>
  __device__ __forceinline__ A operator()(A a, A b) const {
    return cpm_min_takes_a(a, b) ? a : b;
  }
};

template <typename S_, typename A_>
struct IntTraits {
  using S = S_;
  using A = A_;
  static __device__ __forceinline__ A acc(S v) { return (A)v; }
  static __device__ __forceinline__ S store(A a) { return (S)a; }
};

struct BoolT {
  using S = uint8_t;
  using A = float;
  static __device__ __forceinline__ A acc(S v) { return v ? 1.f : 0.f; }
  static __device__ __forceinline__ S store(A a) { return a != 0.f; }
};
struct I8T : IntTraits<int8_t, int> {};
struct U8T : IntTraits<uint8_t, int> {};
struct I16T : IntTraits<int16_t, int> {};
struct I32T : IntTraits<int, int> {};
struct F16T {
  using S = uint16_t;                // the bits of a __half
  using A = float;
  static __device__ __forceinline__ A acc(S v) {
    return __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ S store(A a) {
    return __half_as_ushort(__float2half_rn(a));
  }
};
struct BF16T {
  using S = uint16_t;                // the bits of a __nv_bfloat16
  using A = float;
  static __device__ __forceinline__ A acc(S v) {
    return __uint_as_float((uint32_t)v << 16);
  }
  static __device__ __forceinline__ S store(A a) {
    return (S)(__float_as_uint(a) >> 16);     // exact: a was an element
  }
};
struct F32T {
  using S = float;
  using A = float;
  static __device__ __forceinline__ A acc(S v) { return v; }
  static __device__ __forceinline__ S store(A a) { return a; }
};

// Run `body` with the traits of dtype code `dt`; unknown codes return
// cudaErrorInvalidValue from the enclosing launch function.
#define CPM_DISPATCH_DTYPE(dt, ...)                                  \
  switch (dt) {                                                      \
    case DT_BOOL: { using Tr = BoolT; __VA_ARGS__; } break;          \
    case DT_I8: { using Tr = I8T; __VA_ARGS__; } break;              \
    case DT_U8: { using Tr = U8T; __VA_ARGS__; } break;              \
    case DT_I16: { using Tr = I16T; __VA_ARGS__; } break;            \
    case DT_I32: { using Tr = I32T; __VA_ARGS__; } break;            \
    case DT_F16: { using Tr = F16T; __VA_ARGS__; } break;            \
    case DT_BF16: { using Tr = BF16T; __VA_ARGS__; } break;          \
    case DT_F32: { using Tr = F32T; __VA_ARGS__; } break;            \
    default: return (int)cudaErrorInvalidValue;                      \
  }

// Output conversion of the reductions: sums keep the accumulator (the TPU
// kernels' output dtype promote(x, acc) is acc for every dtype taken),
// limits store back in x.dtype.
template <class Tr, bool STORE>
struct Out {
  using T = typename Tr::A;
  static __device__ __forceinline__ T put(typename Tr::A a) { return a; }
};
template <class Tr>
struct Out<Tr, true> {
  using T = typename Tr::S;
  static __device__ __forceinline__ T put(typename Tr::A a) {
    return Tr::store(a);
  }
};

// Combine lanes [0, len) of p into `acc` with `op`: thread t of T strides
// the run, in 16-byte loads when `vec` (p 16-byte aligned), UNROLL of
// them in flight, then the tail lane by lane.  A thread combines its
// lanes in increasing order whatever UNROLL is.
template <class Tr, int T, int UNROLL, class Op>
__device__ __forceinline__ typename Tr::A reduce_strided(
    const typename Tr::S* __restrict__ p, long long len, Op op,
    typename Tr::A acc, bool vec, int t) {
  using S = typename Tr::S;
  long long done = 0;
  if (vec) {
    constexpr int V = 16 / sizeof(S);
    struct alignas(16) Chunk { S e[V]; };
    const Chunk* pv = reinterpret_cast<const Chunk*>(p);
    const long long nv = len / V;
    for (long long i = t; i < nv; i += (long long)T * UNROLL) {
      Chunk c[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + (long long)u * T < nv) c[u] = pv[i + (long long)u * T];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + (long long)u * T < nv)
#pragma unroll
          for (int k = 0; k < V; ++k) acc = op(acc, Tr::acc(c[u].e[k]));
    }
    done = nv * V;
  }
  for (long long i = done + t; i < len; i += T) acc = op(acc, Tr::acc(p[i]));
  return acc;
}

// Block-wide reduction with `op`, in a fixed order; the result is valid
// in thread 0.  `red` is __shared__ scratch of 32 elements.
template <typename A, typename Op>
__device__ __forceinline__ A block_reduce(A v, Op op, A* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane < nwarps ? lane : 0];
    for (int off = 16; off > 0; off >>= 1) {
      const A o = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < nwarps) v = op(v, o);
    }
  }
  __syncthreads();                   // `red` may be reused
  return v;
}

// Block-wide exclusive prefix sum of one int per thread (thread order);
// `*total` gets the block's sum.  `red` is __shared__ scratch of 33 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* red,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? red[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    if (lane < nwarps) red[lane] = w;            // inclusive warp prefixes
    if (lane == 31) red[32] = w;
  }
  __syncthreads();
  const int before = warp ? red[warp - 1] : 0;
  *total = red[32];
  __syncthreads();                   // `red` may be reused
  return before + inc - v;
}
