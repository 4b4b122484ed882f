// §6.1 broadcast compare of (R, N) rows against one datum (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:273 (compare, pallas_call at
// :284, body _compare_kernel at :269).
//
// What it computes: out[i] = x[i] <op> datum for every element of a
// contiguous (R, N) tensor, op one of eq/ne/lt/gt/le/ge, written as a
// bool (one byte, 0 or 1) — the TPU kernel's int8 flags already cast to
// bool.  x and the datum have one dtype (the caller promotes first, as
// the TPU wrapper does before its pallas_call); bool, int8, uint8, int16
// and int32 compare as ints, float16/bfloat16 widen exactly to float32,
// so every flag equals the plain twin's bit for bit, NaN included (a
// NaN compares unequal to everything).  The predicate is cpm_cmp of
// cpm_ops.cuh, the one fused_stream.cu's compare branch uses.
//
// The datum is read through a device pointer, as the TPU kernel reads
// d_ref: a datum that is the output of an earlier kernel (the allocator's
// LRU victim compares against global_limit's result) needs no host read,
// so a call never synchronizes.
//
// What bounds it on the H100: device-memory bytes — each element is read
// once and each flag written once, one compare per element.  At
// chip_smoke's (64, 1,048,576) int32 rows that is 268.4 MB in and
// 67.1 MB out, 0.100 ms at 3.35 TB/s.
//
// What the design does about it: one launch, a grid-stride loop over the
// flat tensor in 16-byte loads (16 / sizeof(S) elements a thread per
// step, the flags stored as one 4-, 8- or 16-byte word) when x is 16-byte
// aligned, element by element otherwise; a few blocks per SM keep loads
// in flight.  No shared memory.

#include "cpm_ops.cuh"

#define CMP_THREADS 256

namespace {

template <int N>
struct alignas(N) Bytes {
  uint8_t b[N];
};

template <class Tr>
__global__ void __launch_bounds__(CMP_THREADS)
compare_kernel(const typename Tr::S* __restrict__ x,
               const typename Tr::S* __restrict__ datum,
               uint8_t* __restrict__ out, long long total, int op,
               bool vec) {
  using S = typename Tr::S;
  using A = typename Tr::A;
  constexpr int V = 16 / sizeof(S);
  const A d = Tr::acc(*datum);
  const long long stride = (long long)gridDim.x * CMP_THREADS;
  long long start = (long long)blockIdx.x * CMP_THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    struct alignas(16) Chunk { S e[V]; };
    const Chunk* xv = reinterpret_cast<const Chunk*>(x);
    Bytes<V>* ov = reinterpret_cast<Bytes<V>*>(out);
    const long long nv = total / V;
    for (long long i = start; i < nv; i += stride) {
      const Chunk c = xv[i];
      Bytes<V> f;
#pragma unroll
      for (int k = 0; k < V; ++k) f.b[k] = cpm_cmp(op, Tr::acc(c.e[k]), d);
      ov[i] = f;
    }
    done = nv * V;
  }
  for (long long i = done + start; i < total; i += stride)
    out[i] = cpm_cmp(op, Tr::acc(x[i]), d);
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int compare_launch(const void* x, const void* datum, void* out,
                   long long total, int dtype, int op, void* stream) {
  if (total == 0) return 0;
  if (op < 0 || op > 5) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CPM_DISPATCH_DTYPE(dtype, {
    constexpr int V = 16 / sizeof(typename Tr::S);
    const long long work = vec ? (total + V - 1) / V : total;
    long long blocks = (work + CMP_THREADS - 1) / CMP_THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond
    compare_kernel<Tr><<<(int)blocks, CMP_THREADS, 0, s>>>(
        static_cast<const typename Tr::S*>(x),
        static_cast<const typename Tr::S*>(datum),
        static_cast<uint8_t*>(out), total, op, vec);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
