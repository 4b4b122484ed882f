// Paged-row movement for the session pool's banks (sm_90a): gather_rows
// and scatter_rows.
//
// Replaces: src/repro/kernels/cpm_kernels.py:670 (gather_rows,
// pallas_call at :684, body _copy_row_kernel at :664) and :698
// (scatter_rows, pallas_call at :718, body _scatter_row_kernel at :692).
//
// What it computes:
//  * gather_rows: out[i] = x[clamp(idx[i], 0, R-1)] for an (R, N) bank and
//    (K,) int32 page ids — K row copies.  The pool clips its ids before
//    the call; the clamp here only keeps a stray id inside the bank.
//  * scatter_rows: a new (R, N) array whose row r is src[i] when
//    idx[i] == r for some i (ids unique) and dst[r] otherwise.  Ids
//    outside [0, R) drop: the pool passes R as the sentinel of a clean
//    page that must not be written back.
//  Rows are copied as bytes, so every dtype moves bit for bit (jnp.take
//  and .at[].set move values the same way).
//
// What bounds it on the H100: launch latency.  On the pool's path a call
// moves a few KB (K = rows_per_bank * C pages of page_size int32 tokens
// per chunk); the 3.35 TB/s floor for that is nanoseconds, the launch
// several microseconds.
//
// What the design does about it: the simplest right shape, one launch per
// call and no scratch memory.
//  * One block per OUTPUT row, in both kernels.  Each block copies its row
//    in 16-byte words when the row length in bytes allows it (every row
//    then starts 16-byte aligned, as tensor storage is 256-byte aligned),
//    else 4-byte words, else bytes.
//  * scatter_rows is the TPU kernel's inverse map, built per block: block
//    r scans the K ids for the one that names r (the Pallas version
//    builds inv = full(R, -1).at[idx].set(arange(K)) before its grid), so
//    every output row is written exactly once, by one block, with no
//    atomics and no read-modify-write of dst.  K is small on this path
//    (tens of pages), so the scan costs less than the row copy.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS_THREADS 128

namespace {

template <typename W>
__device__ __forceinline__ void copy_row(const W* __restrict__ from,
                                         W* __restrict__ to, long long words) {
  for (long long w = threadIdx.x; w < words; w += ROWS_THREADS) to[w] = from[w];
}

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ x,
                                   const int* __restrict__ idx,
                                   W* __restrict__ out, int R,
                                   long long words) {
  const long long i = blockIdx.x;
  int r = idx[i];
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  copy_row(x + (long long)r * words, out + i * words, words);
}

template <typename W>
__global__ void scatter_rows_kernel(const W* __restrict__ dst,
                                    const int* __restrict__ idx,
                                    const W* __restrict__ src,
                                    W* __restrict__ out, int K,
                                    long long words) {
  __shared__ int from;                       // src row landing here, or -1
  const int r = blockIdx.x;
  if (threadIdx.x == 0) from = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += ROWS_THREADS)
    if (idx[i] == r) from = i;               // ids are unique: one writer
  __syncthreads();
  const W* row = from >= 0 ? src + (long long)from * words
                           : dst + (long long)r * words;
  copy_row(row, out + (long long)r * words, words);
}

// the widest word that divides a row (every row then starts aligned)
int word_bytes(long long row_bytes) {
  if (row_bytes % 16 == 0) return 16;
  if (row_bytes % 4 == 0) return 4;
  return 1;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int gather_rows_launch(const void* x, const int* idx, void* out, int R,
                       int K, long long row_bytes, void* stream) {
  if (K == 0 || row_bytes == 0) return 0;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wb = word_bytes(row_bytes);
  const long long words = row_bytes / wb;
  if (wb == 16)
    gather_rows_kernel<<<K, ROWS_THREADS, 0, s>>>(
        static_cast<const uint4*>(x), idx, static_cast<uint4*>(out), R, words);
  else if (wb == 4)
    gather_rows_kernel<<<K, ROWS_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), idx, static_cast<uint32_t*>(out), R,
        words);
  else
    gather_rows_kernel<<<K, ROWS_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), idx, static_cast<uint8_t*>(out), R,
        words);
  return (int)cudaGetLastError();
}

int scatter_rows_launch(const void* dst, const int* idx, const void* src,
                        void* out, int R, int K, long long row_bytes,
                        void* stream) {
  if (R == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wb = word_bytes(row_bytes);
  const long long words = row_bytes / wb;
  if (wb == 16)
    scatter_rows_kernel<<<R, ROWS_THREADS, 0, s>>>(
        static_cast<const uint4*>(dst), idx, static_cast<const uint4*>(src),
        static_cast<uint4*>(out), K, words);
  else if (wb == 4)
    scatter_rows_kernel<<<R, ROWS_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(dst), idx,
        static_cast<const uint32_t*>(src), static_cast<uint32_t*>(out), K,
        words);
  else
    scatter_rows_kernel<<<R, ROWS_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(dst), idx,
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), K,
        words);
  return (int)cudaGetLastError();
}

}  // extern "C"
