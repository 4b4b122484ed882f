// §4.2 compact: stable pack of the kept lanes of (R, N) rows (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:637 (compact, pallas_call at
// :645, body _compact_kernel at :603).
//
// What it computes: per row, the kept lanes (keep != 0) move to the front
// in their order, the vacated lanes take `fill`, and new_len is the
// number kept.  Elements move as 1-, 2- or 4-byte words, so every dtype
// of those widths packs bit for bit, as the TPU kernel's gather does.
//
// The TPU kernel holds a whole row in VMEM and ranks its lanes with a
// Hillis-Steele cumsum and a lower-bound gather.  At N = 1,048,576 a row
// does not fit in a block's shared memory, and blocks run in no order, so
// the running count is carried by a split pass with a fixed order:
//  1. count:   one warp per (row, tile of 2048 lanes) counts its kept
//              flags -> tile_counts;
//  2. scan:    one block per row takes the exclusive prefix sum of its
//              tile counts in tile order -> tile_offsets, new_len;
//  3. scatter: one block per (row, tile) ranks its kept lanes (a block
//              exclusive scan of per-thread counts over 8 consecutive
//              lanes a thread), packs them in shared memory and writes
//              the packed run to out[tile_offset ...]; lanes at or past
//              new_len take `fill`.  Kept elements land below new_len
//              and fill at or past it, so every output lane is written
//              exactly once.
// Three device launches per call, no atomics: the pack is the stable one,
// bit for bit, on every run.
//
// What bounds it on the H100: device-memory bytes — the keep flags
// (1 byte a lane), the kept elements of x and the whole output.  At
// chip_smoke's (64, 1,048,576) int32 rows with half the lanes kept:
// 67.1 + 134.2 + 268.4 MB, 0.140 ms at 3.35 TB/s.
//
// What the design does about it: the count pass has R x N / 2048 warps,
// the scatter as many blocks, the scan R blocks; every global load and
// store is coalesced (the scatter stages its tile in 8 + 2 + 8 KB of
// shared memory for 4-byte elements); the flags are read twice (count
// and scatter, 2 x 67.1 MB), which keeps the passes independent.  The
// scan pass reads R x N / 2048 counts only.

#include "cpm_ops.cuh"

#define CT_THREADS 256
#define CT_ITEMS 8
#define CT_TILE (CT_THREADS * CT_ITEMS)
#define SCAN_THREADS 1024

namespace {

// nonzero bytes of a 4-byte word
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return __popc(w & 0x01010101u);
}

// One warp per (row, tile): many small tiles per block, no block-wide
// barrier.  WORDS: the flags are read as 4-byte words (every row starts
// 4-byte aligned), else byte by byte; both coalesced.
template <bool WORDS>
__global__ void __launch_bounds__(CT_THREADS)
compact_count(const uint8_t* __restrict__ keep, int* __restrict__ counts,
              long long n, int tiles, long long n_tiles) {
  const long long g = (long long)blockIdx.x * (CT_THREADS / 32) +
                      (threadIdx.x >> 5);           // r * tiles + t
  if (g >= n_tiles) return;                         // the whole warp
  const int lane = threadIdx.x & 31;
  const long long r = g / tiles, lo = (g % tiles) * CT_TILE;
  const int len = (int)(n - lo < CT_TILE ? n - lo : CT_TILE);
  const uint8_t* krow = keep + r * n + lo;
  int c = 0;
  if (WORDS) {
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(krow);
#pragma unroll 4
    for (int j = lane; j < len / 4; j += 32) c += nonzero_bytes(kw[j]);
  } else {
    for (int j = lane; j < len; j += 32) c += krow[j] != 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if (lane == 0) counts[g] = c;
}

__global__ void __launch_bounds__(SCAN_THREADS)
compact_scan(const int* __restrict__ counts, int* __restrict__ offsets,
             int* __restrict__ new_len, int tiles) {
  __shared__ int red[33];
  const long long base = (long long)blockIdx.x * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += SCAN_THREADS) {     // tile order
    const int t = t0 + threadIdx.x;
    const int c = t < tiles ? counts[base + t] : 0;
    int chunk;
    const int ex = block_exclusive_scan(c, red, &chunk);
    if (t < tiles) offsets[base + t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) new_len[blockIdx.x] = carry;
}

// The tile goes through shared memory so that every global access is
// coalesced: flags and elements load thread-strided, each thread ranks
// its CT_ITEMS consecutive lanes (a block exclusive scan of their
// counts) and packs its kept elements into a second buffer at those
// ranks, then the packed run and the fill lanes store thread-strided.
template <typename W>
__global__ void __launch_bounds__(CT_THREADS)
compact_scatter(const W* __restrict__ x, const uint8_t* __restrict__ keep,
                const int* __restrict__ offsets,
                const int* __restrict__ new_len, const W* __restrict__ fill,
                W* __restrict__ out, long long n, int tiles) {
  __shared__ int red[33];
  __shared__ uint8_t ks[CT_TILE];
  __shared__ W xs[CT_TILE];
  __shared__ W packed[CT_TILE];
  const long long r = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const long long lo = t * CT_TILE;
  const int len = (int)(n - lo < CT_TILE ? n - lo : CT_TILE);
  const uint8_t* krow = keep + r * n + lo;
  const W* xrow = x + r * n + lo;
  for (int j = threadIdx.x; j < len; j += CT_THREADS) {
    ks[j] = krow[j] != 0;
    xs[j] = xrow[j];
  }
  for (int j = len + threadIdx.x; j < CT_TILE; j += CT_THREADS) ks[j] = 0;
  __syncthreads();
  const int j0 = threadIdx.x * CT_ITEMS;
  int c = 0;
#pragma unroll
  for (int k = 0; k < CT_ITEMS; ++k) c += ks[j0 + k];
  int kept;
  int rank = block_exclusive_scan(c, red, &kept);
#pragma unroll
  for (int k = 0; k < CT_ITEMS; ++k)
    if (ks[j0 + k]) packed[rank++] = xs[j0 + k];
  __syncthreads();
  W* orow = out + r * n;
  const long long dst = offsets[blockIdx.x];
  for (int j = threadIdx.x; j < kept; j += CT_THREADS)
    orow[dst + j] = packed[j];
  const long long nl = new_len[r];
  const W fv = *fill;
  for (int j = threadIdx.x; j < len; j += CT_THREADS)
    if (lo + j >= nl) orow[lo + j] = fv;
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int compact_tile() { return CT_TILE; }

// x, out: (R, n) elements of `elem_bytes` (1, 2 or 4); keep: (R, n)
// bytes; fill: one element; new_len: (R,) int32; scratch: 2 x R x tiles
// int32 (tile counts, then tile offsets), tiles = ceil(n / compact_tile()).
int compact_launch(const void* x, const uint8_t* keep, const void* fill,
                   void* out, int* new_len, int* scratch, int R, long long n,
                   int elem_bytes, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || n <= 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + CT_TILE - 1) / CT_TILE;
  if ((long long)R * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int* counts = scratch;
  int* offsets = scratch + (long long)R * tiles;
  const unsigned grid = (unsigned)(R * tiles);
  const long long n_tiles = (long long)R * tiles;
  const unsigned count_grid =
      (unsigned)((n_tiles + CT_THREADS / 32 - 1) / (CT_THREADS / 32));
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(keep) % 4 == 0)
    compact_count<true><<<count_grid, CT_THREADS, 0, s>>>(
        keep, counts, n, (int)tiles, n_tiles);
  else
    compact_count<false><<<count_grid, CT_THREADS, 0, s>>>(
        keep, counts, n, (int)tiles, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_scan<<<R, SCAN_THREADS, 0, s>>>(counts, offsets, new_len,
                                          (int)tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (elem_bytes) {
    case 1:
      compact_scatter<<<grid, CT_THREADS, 0, s>>>(
          static_cast<const uint8_t*>(x), keep, offsets, new_len,
          static_cast<const uint8_t*>(fill), static_cast<uint8_t*>(out), n,
          (int)tiles);
      break;
    case 2:
      compact_scatter<<<grid, CT_THREADS, 0, s>>>(
          static_cast<const uint16_t*>(x), keep, offsets, new_len,
          static_cast<const uint16_t*>(fill), static_cast<uint16_t*>(out), n,
          (int)tiles);
      break;
    case 4:
      compact_scatter<<<grid, CT_THREADS, 0, s>>>(
          static_cast<const uint32_t*>(x), keep, offsets, new_len,
          static_cast<const uint32_t*>(fill), static_cast<uint32_t*>(out), n,
          (int)tiles);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
