// §8 super_sum and super_limit of (R, N) rows (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:456 (super_sum) and :466
// (super_limit), one body _super_reduce at :431 (pallas_call at :442,
// kernel _super_kernel, tree _tree_combine_block at :399).
//
// What it computes: per row, the sum (int32 accumulator for integer
// types, wrapping; float32 for bool and the floats) or the max / min (in
// the same accumulators, stored back in x.dtype) of its N lanes, in the
// paper's two §8 phases:
//  1. one partial per `section`-lane section.  The TPU kernel pads the
//     ragged last section with the reduction's pad (0, or
//     limit_identity(x.dtype)); here the section's real lanes reduce and
//     the pad value is combined once when the section is ragged, which
//     is the same (it turns a -0.0 sum into +0.0, and a bool row's max
//     into True, as the pad does);
//  2. the log-depth tree over the row's nsec partials with exactly
//     _tree_combine_block's bracketing: level j combines lane i with lane
//     i + 2^j, a partner at or past nsec reads the identity
//     (limit_identity of the accumulator; 0 for sums).  Only the lanes
//     that reach lane 0 (multiples of 2^(j+1) at level j) are computed,
//     in place, one __syncthreads per level.
// Phase 2 adds no rounding difference from the plain twin; a float sum
// differs from it only by phase 1's order inside a section, and a limit
// not at all (MaxOp / MinOp of cpm_ops.cuh are order-free).
//
// The TPU kernel parks the partials in a VMEM scratch line across its
// in-order section axis and runs the tree at the last step.  CUDA blocks
// run in no order, so phase 1 and phase 2 are two launches (no atomics):
// phase 1 writes the (R, nsec) partials, phase 2 runs one block per row
// over them in shared memory (nsec <= SUPER_MAX_NSEC, which any section
// of at least sqrt(N) lanes meets for N < 2^31).
//
// What bounds it on the H100: device-memory bytes, every element read
// once.  At chip_smoke's (64, 1,048,576) int32 or float32 rows with
// section 1024: 268.4 MB, 0.080 ms at 3.35 TB/s.
//
// What the design does about it: in phase 1 a warp reduces one section
// at a time (16-byte loads when the row and the section are 16-byte
// aligned), warps walking the R x nsec sections grid-stride so that the
// whole card streams the rows; the tree is ~nsec * 4 bytes a row.

#include <cmath>
#include <limits>
#include <type_traits>

#include "cpm_ops.cuh"

#define SUPER_THREADS 256
#define SUPER_TREE_THREADS 256
#define SUPER_MAX_NSEC 58112          // 232,448 bytes of 4-byte partials

namespace {

// One section's reduction by one warp; valid in lane 0.
template <class Tr, class Op>
__device__ __forceinline__ typename Tr::A warp_section(
    const typename Tr::S* __restrict__ p, long long len, Op op,
    typename Tr::A acc, bool vec) {
  acc = reduce_strided<Tr, 32, 1>(p, len, op, acc, vec, threadIdx.x & 31);
  for (int off = 16; off > 0; off >>= 1)
    acc = op(acc, __shfl_down_sync(0xffffffffu, acc, off));
  return acc;
}

// Phase 1: warp w of the grid reduces sections w, w + W, ... of the
// R x nsec sections; partials[s] for s = row * nsec + k.
template <class Tr, class Op>
__global__ void __launch_bounds__(SUPER_THREADS)
super_parts(const typename Tr::S* __restrict__ x,
            typename Tr::A* __restrict__ partials, long long n,
            long long section, long long nsec, long long total,
            typename Tr::A ident, typename Tr::A pad, bool vec) {
  Op op;
  const long long nwarps = (long long)gridDim.x * (SUPER_THREADS / 32);
  const long long w0 =
      (long long)blockIdx.x * (SUPER_THREADS / 32) + (threadIdx.x >> 5);
  for (long long s = w0; s < total; s += nwarps) {
    const long long r = s / nsec, k = s % nsec;
    const long long lo = k * section;
    const long long len = lo + section <= n ? section : n - lo;
    typename Tr::A acc =
        warp_section<Tr, Op>(x + r * n + lo, len, op, ident, vec);
    if ((threadIdx.x & 31) == 0) {
      if (len < section) acc = op(acc, pad);    // the ragged section's pad
      partials[s] = acc;
    }
  }
}

// Phase 2: one block per row, the §8 tree over its nsec partials.
template <class Tr, class Op, bool STORE>
__global__ void __launch_bounds__(SUPER_TREE_THREADS)
super_tree(const typename Tr::A* __restrict__ partials,
           typename Out<Tr, STORE>::T* __restrict__ out, int nsec,
           typename Tr::A ident) {
  using A = typename Tr::A;
  extern __shared__ unsigned char smem_raw[];
  A* v = reinterpret_cast<A*>(smem_raw);
  const A* pr = partials + (long long)blockIdx.x * nsec;
  for (int i = threadIdx.x; i < nsec; i += blockDim.x) v[i] = pr[i];
  __syncthreads();
  Op op;
  for (int s = 1; s < nsec; s <<= 1) {         // level j: stride s = 2^j
    const int step = s << 1;
    for (long long i = (long long)threadIdx.x * step; i < nsec;
         i += (long long)blockDim.x * step)
      v[i] = op(v[i], i + s < nsec ? v[i + s] : ident);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = Out<Tr, STORE>::put(v[0]);
}

template <class Tr, class Op, bool STORE>
int launch(const void* x, void* out, void* partials, int R, long long n,
           long long section, int nsec, typename Tr::A ident,
           typename Tr::A pad, cudaStream_t s) {
  using S = typename Tr::S;
  using A = typename Tr::A;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (n * (long long)sizeof(S)) % 16 == 0 &&
                   (section * (long long)sizeof(S)) % 16 == 0;
  const long long total = (long long)R * nsec;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (total + SUPER_THREADS / 32 - 1) /
                         (SUPER_THREADS / 32);
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  super_parts<Tr, Op><<<blocks, SUPER_THREADS, 0, s>>>(
      static_cast<const S*>(x), static_cast<A*>(partials), n, section, nsec,
      total, ident, pad, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)nsec * sizeof(A);
  auto kern = super_tree<Tr, Op, STORE>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<R, SUPER_TREE_THREADS, smem, s>>>(
      static_cast<const A*>(partials),
      static_cast<typename Out<Tr, STORE>::T*>(out), nsec, ident);
  return (int)cudaGetLastError();
}

template <class Tr>
typename Tr::A limit_ident(int mode) {          // mode 0 max, 1 min
  using A = typename Tr::A;
  if constexpr (std::is_same<A, float>::value)
    return mode == 0 ? -INFINITY : INFINITY;
  else
    return mode == 0 ? std::numeric_limits<int>::lowest()
                     : std::numeric_limits<int>::max();
}

// limit_identity(x.dtype, mode) as an element, then widened: the pad of
// a ragged section (bool takes the float identity, which is True).
template <class Tr>
typename Tr::A limit_pad(int mode) {
  using A = typename Tr::A;
  using S = typename Tr::S;
  if constexpr (std::is_same<Tr, BoolT>::value)
    return (A)1;
  else if constexpr (std::is_same<A, float>::value)
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

// x: (R, n) rows of dtype code `dtype`; partials: (R, nsec) accumulator
// dtype scratch; out: (R,) accumulator dtype (op 0, sum) or x.dtype
// (op 1 max, op 2 min).  nsec = ceil(n / section).
int super_reduce_launch(const void* x, void* out, void* partials, int R,
                        long long n, long long section, int nsec, int dtype,
                        int op, void* stream) {
  if (R <= 0 || n <= 0 || section < 1 || nsec < 1 ||
      nsec > SUPER_MAX_NSEC || (long long)nsec != (n + section - 1) / section
      || op < 0 || op > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    using A = typename Tr::A;
    if (op == 0)
      return launch<Tr, SumOp, false>(x, out, partials, R, n, section, nsec,
                                      (A)0, (A)0, s);
    if (op == 1)
      return launch<Tr, MaxOp, true>(x, out, partials, R, n, section, nsec,
                                     limit_ident<Tr>(0), limit_pad<Tr>(0),
                                     s);
    return launch<Tr, MinOp, true>(x, out, partials, R, n, section, nsec,
                                   limit_ident<Tr>(1), limit_pad<Tr>(1), s);
  });
  return 0;
}

}  // extern "C"
