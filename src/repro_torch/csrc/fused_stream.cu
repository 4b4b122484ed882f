// One launch for a fused group of CPM broadcast instructions (sm_90a).
//
// Replaces: src/repro/kernels/cpm_kernels.py:809 (fused_stream,
// pallas_call at :882; per-instruction body _fused_apply at :742).
//
// What it computes: for every (N,) row of an (R, N) int32 or float32
// buffer and its §4.2 used-length register, the instruction stream
// activate / shift / insert / delete / truncate / compare /
// substring_match / template_match / stencil, in order; buffer transforms
// update the resident row and the register, producers write an (R, N)
// int8 flag row or float32 value row.  Every branch equals the JAX body
// bit for bit: moves are word selects, compares are exact, and the float
// producers (template SAD, stencil) round each product and sum in the JAX
// order (this file is built with -fmad=false; the adds and products are
// spelled __fadd_rn / __fmul_rn besides).
//
// What bounds it on the H100: device-memory bytes — each row is read once
// and written once, plus its operands and producer outputs; the work per
// element is a few integer compares.  At the serving commit (R = 4 rows of
// N = 320 tokens, insert -> truncate) that is ~10 KB, so a launch costs its
// fixed launch latency, orders of magnitude above the 3.35 TB/s floor.
//
// What the design does about it:
//  * One block per block_r rows (rows looped inside the block; a ragged
//    last block is bounds-checked), so the whole group is one launch and
//    the row makes one round trip to device memory however long the
//    stream is — the point of the TPU mega-kernel too.
//  * The row stays resident in shared memory, double-buffered: shift,
//    insert and delete read other lanes (the jnp.roll of the TPU body),
//    so each transform reads one buffer and writes the other, with one
//    barrier per transform.
//  * The length register lives in a register of every thread (all
//    threads of a block work on the same row and update it alike).
//  * The static instruction tuple becomes a by-value __grid_constant__
//    kernel parameter:
//    opcode, static ints (k, shift, m), flags, operand pointers with a
//    row stride (0 for a broadcast (1, k) operand) and stencil taps — no
//    descriptor copy to the device before a launch.
//  * The compare branch calls cpm_cmp (cpm_ops.cuh), the predicate of the
//    eager compare kernel, so fused and eager compares are one body.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cpm_ops.cuh"     // cpm_cmp, the compare predicate of compare.cu

#define FS_MAX_INSTR 16
#define FS_MAX_TAPS 64
#define FS_THREADS 256

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
  FsInstr ins[FS_MAX_INSTR];
  float taps[FS_MAX_TAPS];
};

namespace {

// int32 arithmetic that wraps like the JAX int32 ops it mirrors
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// Python / jnp floor modulo for b >= 1
__device__ __forceinline__ int fmod_floor(long long a, int b) {
  long long r = a % b;
  return (int)(r < 0 ? r + b : r);
}
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

// _shift_vals: the word at lane i after moving [start, end] by `shift`
__device__ __forceinline__ uint32_t shift_val(const uint32_t* cur, int i,
                                              int n, int start, int end,
                                              int shift, bool has_fill,
                                              uint32_t fill) {
  const int j = fmod_floor((long long)i - shift, n);   // roll source lane
  const bool src_i = i >= start && i <= end;
  bool dst = j >= start && j <= end;
  if (shift > 0) dst = dst && i >= shift;
  else if (shift < 0) dst = dst && (long long)i < (long long)n + shift;
  uint32_t out = dst ? cur[j] : cur[i];
  if (has_fill && src_i && !dst) out = fill;
  return out;
}

__device__ __forceinline__ bool word_eq(uint32_t a, uint32_t b, bool fl) {
  return fl ? as_f(a) == as_f(b) : a == b;
}

__global__ void __launch_bounds__(FS_THREADS)
fused_stream_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ xo,
                    const int* __restrict__ ul_in, int* __restrict__ ul_out,
                    int R, int n, int block_r,
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
          const int carry = max(opnd_i(I, 0, row, 2), 1);
          int8_t* out = static_cast<int8_t*>(I.out) + orow;
          for (int i = threadIdx.x; i < n; i += FS_THREADS)
            out[i] = (i >= st && i <= en &&
                      fmod_floor(wsub(i, st), carry) == 0) ? 1 : 0;
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
            uint32_t w = shift_val(cur, i, n, pos, wsub(ul, 1), I.k, false,
                                   0u);
            for (int j = 0; j < I.k; ++j)            // broadcast write
              if (i == wadd(pos, j)) w = v[j];
            nxt[i] = w;
          }
          break;
        }
        case DELETE: {
          const int pos = opnd_i(I, 0, row, 0);
          const uint32_t fill = opnd(I, 1, row)[0];
          const int lo = wsub(ul, I.k);
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            uint32_t w = shift_val(cur, i, n, wadd(pos, I.k), wsub(ul, 1),
                                   -I.k, false, 0u);
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
          // the M-step carry chain of _substring_ends_vals in closed form:
          // lane e ends a match iff e >= m-1 and the m lanes ending at e
          // equal the needle (the roll's lane 0 is zeroed every step, so
          // nothing wraps); start flags read the end flag m-1 lanes on
          const uint32_t* nee = opnd(I, 0, row);
          const int m = I.m;
          int8_t* out = static_cast<int8_t*>(I.out) + orow;
          const bool start = I.flags & F_START;
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            int e = i;
            bool ok = true;
            if (start) {
              ok = (long long)i <= (long long)n - m;
              e = fmod_floor((long long)i + m - 1, n);
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
            float acc = 0.f;
            for (int j = 0; j < m; ++j) {            // j = 0 .. m-1 in order
              const uint32_t w = cur[fmod_floor((long long)i + j, n)];
              const float xv = xf ? as_f(w) : __int2float_rn((int)w);
              acc = __fadd_rn(acc, fabsf(__fsub_rn(xv, opnd_f32(I, 0, row,
                                                                j))));
            }
            if ((I.flags & F_TAIL) && !((long long)i + m <= ul))
              acc = __int_as_float(0x7f800000);      // +inf
            out[i] = acc;
          }
          break;
        }
        case STENCIL: {
          const bool wrap = I.flags & F_WRAP;
          const int c = I.ntaps / 2;
          float* out = static_cast<float*>(I.out) + orow;
          for (int i = threadIdx.x; i < n; i += FS_THREADS) {
            float acc = 0.f;
            for (int k = 0; k < I.ntaps; ++k) {      // fixed tap order
              const float w = prog.taps[I.tap_off + k];
              if (w == 0.f) continue;
              const int sh = k - c;
              const int j = fmod_floor((long long)i - sh, n);
              uint32_t word = cur[j];
              if (!wrap && !(j < ul)) word = 0u;     // zero-padded tail
              float v = xf ? as_f(word) : __int2float_rn((int)word);
              if (!wrap) {
                if (sh > 0 && i < sh) v = 0.f;
                else if (sh < 0 && (long long)i >= (long long)n + sh) v = 0.f;
              }
              acc = __fadd_rn(acc, __fmul_rn(w, v));
            }
            out[i] = acc;
          }
          break;
        }
      }
      if (I.op == SHIFT || I.op == INSERT || I.op == DELETE) {
        __syncthreads();                               // nxt complete
        uint32_t* t = cur; cur = nxt; nxt = t;
        if (I.op == INSERT) ul = min(wadd(ul, I.k), n);
        if (I.op == DELETE) ul = max(wsub(ul, I.k), 0);
      }
    }
    uint32_t* out_row = xo + (long long)row * n;
    for (int i = threadIdx.x; i < n; i += FS_THREADS) out_row[i] = cur[i];
    if (threadIdx.x == 0) ul_out[row] = ul;
    __syncthreads();                                   // buffers reused
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int fused_stream_launch(const void* x, void* xo, const int* ul, int* ulo,
                        int R, int n, int block_r, const FsProgram* prog,
                        void* stream) {
  if (R == 0 || n == 0) return 0;
  if (block_r < 1 || prog->n_instr > FS_MAX_INSTR) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)n * sizeof(uint32_t);
  static size_t smem_set = 48 * 1024;      // the default opt-in limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = (R + block_r - 1) / block_r;
  fused_stream_kernel<<<grid, FS_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(xo), ul, ulo,
      R, n, block_r, *prog);
  return (int)cudaGetLastError();
}

}  // extern "C"
