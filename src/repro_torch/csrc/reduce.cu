// §7.4 section_sum and §7.5 section_limit of (R, N) rows (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:230 (section_sum,
// pallas_call at :242, body _section_sum_kernel at :212) and :367
// (section_limit, pallas_call at :383, body _section_limit_kernel at
// :348).
//
// What it computes: per row, the sum (int32 accumulator for integer
// types, wrapping as int32 jnp.sum does; float32 for bool and the
// floats) or the max / min (in the same accumulators, stored back in
// x.dtype) of its N lanes.  Limits propagate NaN and order -0.0 below
// +0.0, as jnp.max / jnp.min do: CUDA's fmaxf / fminf return the other
// operand for a NaN, so the combine (MaxOp / MinOp of cpm_ops.cuh) is
// written out.  The TPU kernels pad the
// ragged last section with the reduction's identity (0, or
// limit_identity); out-of-range lanes are skipped here, which is the
// same, except for bool rows under "max", whose limit_identity (-inf)
// pads as True: that one pad value is folded in at the end.
//
// The TPU kernels carry their accumulator across the section grid axis
// (pl.when(j == 0) ... the last step), sound only because TPU grid steps
// run in order.  CUDA blocks run in no order, so this is a split pass
// with a fixed combine order and no atomics:
//  1. `parts` blocks per row each reduce a contiguous run of whole
//     sections (threads stride the run, then a fixed shuffle tree);
//  2. one thread per row combines its `parts` partials in order 0..P-1.
// With parts == 1 pass 1 writes the result and there is no pass 2: one
// or two device launches per call.  Integer results are exact (any
// order); float sums differ from the plain twin's order by rounding only
// and are the same on every run.
//
// What bounds it on the H100: device-memory bytes — every element read
// once, one add or compare each.  At chip_smoke's (64, 1,048,576) int32
// or float32 rows: 268.4 MB, 0.080 ms at 3.35 TB/s.
//
// What the design does about it: the wrapper picks `parts` so that about
// two blocks per SM run (64 rows x 5 parts at that shape), since one
// block per row would leave half of the 132 SMs idle; each thread keeps
// four 16-byte loads in flight (element loads when the row or the part is
// not 16-byte aligned).

#include <cmath>
#include <limits>
#include <type_traits>

#include "cpm_ops.cuh"

#define RED_THREADS 512
#define RED_UNROLL 4

namespace {

// Pass 1: block b reduces lanes [p * part_len, min(n, (p+1) * part_len))
// of row r = b / parts, p = b % parts.  FINAL (parts == 1): write the
// row's result, else its partial.
template <class Tr, class Op, bool STORE, bool FINAL>
__global__ void __launch_bounds__(RED_THREADS)
reduce_parts(const typename Tr::S* __restrict__ x, void* __restrict__ dst,
             long long n, long long part_len, int parts,
             typename Tr::A ident, bool pad_true, bool vec) {
  using A = typename Tr::A;
  __shared__ A red[32];
  const long long r = blockIdx.x / parts;
  const long long p = blockIdx.x % parts;
  const long long lo = p * part_len;
  const long long len = (lo + part_len < n ? lo + part_len : n) - lo;
  const typename Tr::S* run = x + r * n + lo;
  Op op;
  A acc = reduce_strided<Tr, RED_THREADS, RED_UNROLL>(run, len, op, ident,
                                                     vec, threadIdx.x);
  acc = block_reduce(acc, op, red);
  if (threadIdx.x != 0) return;
  if (FINAL) {
    if (pad_true) acc = op(acc, Tr::acc(1));
    using O = Out<Tr, STORE>;
    static_cast<typename O::T*>(dst)[r] = O::put(acc);
  } else {
    static_cast<A*>(dst)[r * parts + p] = acc;
  }
}

// Pass 2: one thread per row combines its partials in order.
template <class Tr, class Op, bool STORE>
__global__ void combine_parts(const typename Tr::A* __restrict__ partials,
                              typename Out<Tr, STORE>::T* __restrict__ out,
                              int R, int parts, bool pad_true) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Op op;
  const typename Tr::A* pr = partials + (long long)r * parts;
  typename Tr::A acc = pr[0];
  for (int p = 1; p < parts; ++p) acc = op(acc, pr[p]);
  if (pad_true) acc = op(acc, Tr::acc(1));
  out[r] = Out<Tr, STORE>::put(acc);
}

template <class Tr, class Op, bool STORE>
int launch(const void* x, void* out, void* partials, int R, long long n,
           int parts, long long part_len, typename Tr::A ident,
           bool pad_true, cudaStream_t s) {
  using S = typename Tr::S;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (n * (long long)sizeof(S)) % 16 == 0 &&
                   (part_len * (long long)sizeof(S)) % 16 == 0;
  const long long blocks = (long long)R * parts;
  if (parts == 1) {
    reduce_parts<Tr, Op, STORE, true><<<(unsigned)blocks, RED_THREADS, 0,
                                        s>>>(
        static_cast<const S*>(x), out, n, part_len, 1, ident, pad_true, vec);
    return (int)cudaGetLastError();
  }
  reduce_parts<Tr, Op, STORE, false><<<(unsigned)blocks, RED_THREADS, 0, s>>>(
      static_cast<const S*>(x), partials, n, part_len, parts, ident, false,
      vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_parts<Tr, Op, STORE><<<(R + 127) / 128, 128, 0, s>>>(
      static_cast<const typename Tr::A*>(partials),
      static_cast<typename Out<Tr, STORE>::T*>(out), R, parts, pad_true);
  return (int)cudaGetLastError();
}

bool bad_plan(int R, long long n, int parts, long long part_len) {
  return R <= 0 || n <= 0 || parts < 1 || part_len < 1 ||
         (long long)(parts - 1) * part_len >= n ||
         (long long)parts * part_len < n ||
         (long long)R * parts > 0x7fffffffLL;
}

template <class Tr>
typename Tr::A limit_ident(int mode) {          // mode 0 max, 1 min
  using A = typename Tr::A;
  using S = typename Tr::S;
  if constexpr (std::is_same<A, float>::value)
    return mode == 0 ? -INFINITY : INFINITY;
  else
    return mode == 0 ? (A)std::numeric_limits<S>::lowest()
                     : (A)std::numeric_limits<S>::max();
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// out: (R,) accumulator dtype (int32 or float32); partials: (R, parts)
// of the same, unused when parts == 1.
int section_sum_launch(const void* x, void* out, void* partials, int R,
                       long long n, int parts, long long part_len, int dtype,
                       void* stream) {
  if (bad_plan(R, n, parts, part_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    return launch<Tr, SumOp, false>(x, out, partials, R, n, parts, part_len,
                                    (typename Tr::A)0, false, s);
  });
  return 0;
}

// out: (R,) x.dtype; partials: (R, parts) accumulator dtype.  mode 0
// max, 1 min; section: the TPU kernel's section width, which decides
// whether the row has pad lanes (only bool under max pads with a value
// that is not the identity: True).
int section_limit_launch(const void* x, void* out, void* partials, int R,
                         long long n, int parts, long long part_len,
                         int dtype, int section, int mode, void* stream) {
  if (bad_plan(R, n, parts, part_len) || section < 1 || mode < 0 ||
      mode > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bool_pad = dtype == DT_BOOL && mode == 0 && n % section != 0;
  CPM_DISPATCH_DTYPE(dtype, {
    const typename Tr::A id = limit_ident<Tr>(mode);
    if (mode == 0)
      return launch<Tr, MaxOp, true>(x, out, partials, R, n, parts, part_len,
                                     id, bool_pad, s);
    return launch<Tr, MinOp, true>(x, out, partials, R, n, parts, part_len,
                                   id, bool_pad, s);
  });
  return 0;
}

}  // extern "C"
