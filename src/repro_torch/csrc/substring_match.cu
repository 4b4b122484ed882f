// §5 substring match of (R, N) rows against one M-item needle (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:540 (substring_match,
// pallas_call at :545, body _substring_kernel at :533, carry chain
// _substring_ends_vals at :516).
//
// What it computes: match-END flags, int8 0/1.  The TPU kernel runs the
// paper's M-step carry chain over a resident row: step 0 sets lane p to
// hay[p] == needle[0], step i > 0 to hay[p] == needle[i] AND lane p-1 of
// the previous step, lane 0 reading 0 (nothing wraps).  After M steps
// lane p is set iff p >= M-1 and hay[p-M+1+t] == needle[t] for every t
// in [0, M): that closed form is computed here, the same flags bit for
// bit.  M == 0 gives all zeros (the TPU loop runs no step), and so does
// M > N.  hay and needle have one dtype (the wrapper promotes first, as
// the twin's == does); bool, int8, uint8, int16 and int32 compare as
// ints, float16/bfloat16 widen exactly to float32, so a NaN matches
// nothing and -0.0 matches +0.0, as in the twin.
//
// What bounds it on the H100: device-memory bytes — each element read
// once, each flag written once.  At chip_smoke's (64, 1,048,576) int32
// rows that is 268.4 MB in and 67.1 MB out, 0.100 ms at 3.35 TB/s.
//
// What the design does about it: the TPU kernel does M compares a lane;
// here a lane compares its own element with needle[M-1] first and, only
// where that holds, the rest of its window from needle[0] on, stopping
// at the first miss: the same flag.  On the paper benchmark's
// four-symbol rows three lanes in four stop after the first compare, and
// the window reads of the others hit L1 lines their neighbours loaded.
// A block takes SUB_THREADS * SUB_LPT lanes of a row, thread t the lanes
// t, t + SUB_THREADS, ..., so that a warp's loads and its one-byte
// stores are contiguous, and a thread issues the loads of its SUB_LPT
// own elements together before it compares (a first design that walked
// each lane's window in turn kept one load in flight a thread, 2.3x the
// bound); the needle's items are read at one address a warp (a broadcast
// from L1).  One launch.

#include "cpm_ops.cuh"

#define SUB_THREADS 256
#define SUB_LPT 8                                // lanes a thread

namespace {

template <class Tr>
__global__ void __launch_bounds__(SUB_THREADS)
substring_kernel(const typename Tr::S* __restrict__ hay,
                 const typename Tr::S* __restrict__ needle,
                 int8_t* __restrict__ out, long long n, int m, int tiles) {
  using A = typename Tr::A;
  const long long r = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const typename Tr::S* row = hay + r * n;
  int8_t* orow = out + r * n;
  const long long lo = t * (long long)(SUB_THREADS * SUB_LPT);
  // each lane's own element first, SUB_LPT independent loads in flight
  A own[SUB_LPT];
#pragma unroll
  for (int k = 0; k < SUB_LPT; ++k) {
    const long long p = lo + (long long)k * SUB_THREADS + threadIdx.x;
    own[k] = p < n ? Tr::acc(row[p]) : A(0);
  }
  const A last = m >= 1 ? Tr::acc(needle[m - 1]) : A(0);
#pragma unroll
  for (int k = 0; k < SUB_LPT; ++k) {
    const long long p = lo + (long long)k * SUB_THREADS + threadIdx.x;
    if (p < n) {
      const long long start = p - m + 1;         // the window's first lane
      bool hit = m >= 1 && start >= 0 && own[k] == last;
      for (int i = 0; hit && i < m - 1; ++i)
        hit = Tr::acc(row[start + i]) == Tr::acc(needle[i]);
      orow[p] = hit ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// hay: (R, n) rows of dtype code `dtype`; needle: (m,) of the same;
// out: (R, n) int8 match-end flags.
int substring_match_launch(const void* hay, const void* needle, void* out,
                           int R, long long n, int m, int dtype,
                           void* stream) {
  if (R < 0 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return 0;
  const long long tiles =
      (n + SUB_THREADS * SUB_LPT - 1) / (SUB_THREADS * SUB_LPT);
  if ((long long)R * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CPM_DISPATCH_DTYPE(dtype, {
    using S = typename Tr::S;
    substring_kernel<Tr><<<(unsigned)(R * tiles), SUB_THREADS, 0, s>>>(
        static_cast<const S*>(hay), static_cast<const S*>(needle),
        static_cast<int8_t*>(out), n, m, (int)tiles);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
