// Fused scalar-expression evaluation (H17), built for Hopper (sm_90a) with
// the other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it).
//
// H17 px_scalar_eval  replaces the reference's device scalar evaluation
//    (K19: pixie_tpu/exec/expression_evaluator.py:219 device_eval and the jnp
//    scalar UDFs it traces, e.g. bin at udf/builtins/time_ops.py:21, select
//    at conditionals.py:29, the math unaries at math_ops.py:75-96), which XLA
//    fuses into each jitted fold. The host compiles every tree a block needs
//    (predicates ANDed into the validity mask, the UDA arguments that are not
//    bare columns, a LUT key's gids, the scan's output columns) into one
//    register program (ops/scalar.py, ExpressionEvaluator.compile_program);
//    one launch runs it for every row of the block and stores one output per
//    result.
//
//    Program: n_instr lowered instructions of eight int32 (op, dst, a, b, c,
//    mode, 0, 0; mode holds each operand's source and kWriteRf) and a pool
//    of 8-byte constants, both in device memory, loaded into shared memory
//    once per CTA. Registers: at most kMaxRegs 8-byte words per row (a bool
//    as 0 or 1, which AND, OR and NOT rely on; an int64; an f64's bits); the
//    compiler assigns them, raises on a deeper tree and records the
//    program's n_regs. Inputs: up to kMaxCols columns (bool, uint8,
//    uint16, int32, int64, f32, f64, each widened on load, a narrowed int
//    column plus its frame-of-reference offset, so the staged block is read
//    as it is) and kMaxLuts LUTs (bool, int32, int64, f64), passed by value
//    in ScalarArgs.
//
//    Semantics are the reference's (ops/scalar.py states them per op): f64
//    add/sub/mul/div/sqrt through __dadd_rn, __dsub_rn, __dmul_rn, __ddiv_rn
//    and __dsqrt_rn, so nvcc contracts nothing into an FMA and each op rounds
//    as torch's does; int64 add/sub/mul/neg/abs wrap (unsigned arithmetic);
//    MOD_I is a floor modulo with 0 for a divisor of 0 or -1; MOD_F is
//    jnp.remainder's form; F2I saturates with NaN -> 0 (Fault-11); RINT_F is
//    rint (half to even), not round; comparisons with NaN are false except
//    NE_F; a LUT index is clamped into [0, len - 1].
//
//    Design: the host lowers the program once per upload
//    (ops/scalar.py ``lower``): every CONST becomes an operand mode (its
//    pool index), an operand that the previous value-writing instruction
//    produced is read from ``acc`` (registers), and only a value that some
//    later instruction reads from the file is written to it (kWriteRf). Each
//    thread runs the program over R contiguous rows at once (R lanes), so an
//    instruction's fetch, its op switch and a LOAD's kind are decoded once
//    per R rows; a warp's rows are contiguous, and a column or output is
//    read or written as R elements in 16-, 8-, 4- or 2-byte vectors when its
//    pointer is aligned (the ragged tail and an unaligned pointer go a lane
//    at a time). The register file sits in shared memory, [reg][lane][thread]
//    8-byte words, sized to the program's n_regs: R is 8, or 4 for a program
//    that calls long_op (the f64 division, modulo and transcendentals and
//    the int64 modulo, out of line per lane: more warps hide those calls),
//    halved while the file overflows kFileBytes at kEvalThreads threads, so
//    several CTAs share an SM even at 32 registers.
//
//    What bounds it on an H100: it must read each input column once and
//    write each output once (the LUTs and the program are tiny and cached):
//    bytes-bound, e.g. 10 bytes a row for service_stats.pxl's LET filter
//    (three code columns and the status as staged, uint8/uint16, and the
//    mask in; the mask and `failure` out). What remains above that is the
//    interpreter's own work, a fetch, a dispatch and R 64-bit lane ops an
//    instruction (chip_smoke.py measures it: by_instruction_ms), and a
//    LOAD's latency once a tile. Staging a tile's columns in shared memory
//    with cp.async (double-buffered) and prefetching the next tile into L2
//    were tried and measured no faster: both cost CTAs an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kMaxRegs = 32;
constexpr int kMaxInstrs = 512;
constexpr int kMaxConsts = 256;
constexpr int kMaxCols = 64;
constexpr int kMaxLuts = 32;
constexpr int kMaxOuts = 64;
constexpr int kInsWords = 8;            // a lowered instruction: two int4
constexpr int kEvalThreads = 128;
constexpr int kFileBytes = 48 * 1024;   // the register file's budget per CTA

// Opcodes: numbered as OPS in ops/scalar.py.
enum Op : int {
  LOAD = 0, CONST, STORE,
  ADD_I, SUB_I, MUL_I, MOD_I, NEG_I, ABS_I, MAX_I,
  ADD_F, SUB_F, MUL_F, DIV_F, MOD_F, NEG_F, ABS_F,
  EQ_I, NE_I, LT_I, LE_I, GT_I, GE_I,
  EQ_F, NE_F, LT_F, LE_F, GT_F, GE_F,
  AND, OR, NOT, B2I, I2F, F2I,
  FLOOR_F, CEIL_F, RINT_F, LN, LOG2, LOG10, EXP, SQRT,
  POW, LOGB, SELECT, LUT,
};

// Storage kinds: numbered as KINDS in ops/scalar.py.
enum Kind : int { K_BOOL = 0, K_U8, K_U16, K_I32, K_I64, K_F32, K_F64 };
// A column's or output's kind | kVec: its pointer is aligned for R-row vectors.
constexpr int kVec = 8;

// Operand sources of a lowered instruction (ops/scalar.py M_*): two bits per
// operand, a in bits 0-1, b in 2-3, c in 4-5.
enum Mode : int { M_RF = 0, M_ACC, M_CONST, M_NONE };
constexpr int kWriteRf = 1 << 6;  // ops/scalar.py W_RF

struct ScalarArgs {
  const void* cols[kMaxCols];
  int col_kind[kMaxCols];
  long long col_off[kMaxCols];  // frame-of-reference offset of a narrowed int column
  const void* luts[kMaxLuts];
  int lut_kind[kMaxLuts];
  long long lut_len[kMaxLuts];
  void* outs[kMaxOuts];
  int out_kind[kMaxOuts];
};

inline int kind_bytes(int kind) {
  switch (kind) {
    case K_BOOL: case K_U8: return 1;
    case K_U16: return 2;
    case K_I32: case K_F32: return 4;
    default: return 8;
  }
}

__device__ __forceinline__ double as_f(u64 v) { return __longlong_as_double((long long)v); }
__device__ __forceinline__ u64 of_f(double d) { return (u64)__double_as_longlong(d); }

// An element of a column or LUT as a register: ints widened to int64, f32
// to f64, bools to 0/1.
__device__ __forceinline__ u64 load(const void* p, int kind, long long i) {
  switch (kind) {
    case K_BOOL: return static_cast<const unsigned char*>(p)[i] != 0;
    case K_U8: return static_cast<const unsigned char*>(p)[i];
    case K_U16: return static_cast<const unsigned short*>(p)[i];
    case K_I32: return (u64)(long long)static_cast<const int*>(p)[i];
    case K_I64: return (u64)static_cast<const long long*>(p)[i];
    case K_F32: return of_f((double)static_cast<const float*>(p)[i]);
    default: return (u64)static_cast<const long long*>(p)[i];  // K_F64 bits
  }
}

// R elements of type T from row r0 on, in the widest aligned vectors.
template <int R, typename T>
__device__ __forceinline__ void ld_vec(const void* p, long long r0, T (&e)[R]) {
  const T* q = static_cast<const T*>(p) + r0;
  constexpr int kB = R * (int)sizeof(T);
  if constexpr (kB >= 16) {
    union { uint4 v[kB / 16]; T e[R]; } u;
#pragma unroll
    for (int k = 0; k < kB / 16; ++k) u.v[k] = reinterpret_cast<const uint4*>(q)[k];
#pragma unroll
    for (int l = 0; l < R; ++l) e[l] = u.e[l];
  } else if constexpr (kB == 8) {
    union { uint2 v; T e[R]; } u;
    u.v = *reinterpret_cast<const uint2*>(q);
#pragma unroll
    for (int l = 0; l < R; ++l) e[l] = u.e[l];
  } else if constexpr (kB == 4) {
    union { unsigned int v; T e[R]; } u;
    u.v = *reinterpret_cast<const unsigned int*>(q);
#pragma unroll
    for (int l = 0; l < R; ++l) e[l] = u.e[l];
  } else if constexpr (kB == 2) {
    union { unsigned short v; T e[R]; } u;
    u.v = *reinterpret_cast<const unsigned short*>(q);
#pragma unroll
    for (int l = 0; l < R; ++l) e[l] = u.e[l];
  } else {
    e[0] = q[0];
  }
}

template <int R, typename T>
__device__ __forceinline__ void st_vec(void* p, long long r0, const T (&e)[R]) {
  T* q = static_cast<T*>(p) + r0;
  constexpr int kB = R * (int)sizeof(T);
  if constexpr (kB >= 16) {
    union { uint4 v[kB / 16]; T e[R]; } u;
#pragma unroll
    for (int l = 0; l < R; ++l) u.e[l] = e[l];
#pragma unroll
    for (int k = 0; k < kB / 16; ++k) reinterpret_cast<uint4*>(q)[k] = u.v[k];
  } else if constexpr (kB == 8) {
    union { uint2 v; T e[R]; } u;
#pragma unroll
    for (int l = 0; l < R; ++l) u.e[l] = e[l];
    *reinterpret_cast<uint2*>(q) = u.v;
  } else if constexpr (kB == 4) {
    union { unsigned int v; T e[R]; } u;
#pragma unroll
    for (int l = 0; l < R; ++l) u.e[l] = e[l];
    *reinterpret_cast<unsigned int*>(q) = u.v;
  } else if constexpr (kB == 2) {
    union { unsigned short v; T e[R]; } u;
#pragma unroll
    for (int l = 0; l < R; ++l) u.e[l] = e[l];
    *reinterpret_cast<unsigned short*>(q) = u.v;
  } else {
    q[0] = e[0];
  }
}

// The R lanes of a LOAD: the column's rows r0 .. r0 + R - 1 widened (an int
// plus its offset; 0 past n).
template <int R, typename T>
__device__ __forceinline__ void widen_ints(const void* p, long long r0, u64 off, u64 (&v)[R]) {
  T e[R];
  ld_vec<R, T>(p, r0, e);
#pragma unroll
  for (int l = 0; l < R; ++l) v[l] = (u64)(long long)e[l] + off;
}

template <int R>
__device__ __forceinline__ void load_rows(const void* p, int kind, long long off, long long r0,
                                          long long n, bool full, u64 (&v)[R]) {
  const int k = kind & 7;
  const u64 uoff = (u64)off;
  if (full && (kind & kVec)) {
    switch (k) {
      case K_BOOL: {
        unsigned char e[R];
        ld_vec<R, unsigned char>(p, r0, e);
#pragma unroll
        for (int l = 0; l < R; ++l) v[l] = e[l] != 0;
        break;
      }
      case K_U8: widen_ints<R, unsigned char>(p, r0, uoff, v); break;
      case K_U16: widen_ints<R, unsigned short>(p, r0, uoff, v); break;
      case K_I32: widen_ints<R, int>(p, r0, uoff, v); break;
      case K_I64: widen_ints<R, long long>(p, r0, uoff, v); break;
      case K_F32: {
        float e[R];
        ld_vec<R, float>(p, r0, e);
#pragma unroll
        for (int l = 0; l < R; ++l) v[l] = of_f((double)e[l]);
        break;
      }
      default: {  // K_F64 bits
        long long e[R];
        ld_vec<R, long long>(p, r0, e);
#pragma unroll
        for (int l = 0; l < R; ++l) v[l] = (u64)e[l];
        break;
      }
    }
    return;
  }
  const bool is_int = k != K_BOOL && k != K_F32 && k != K_F64;
#pragma unroll
  for (int l = 0; l < R; ++l) {
    v[l] = r0 + l < n ? load(p, k, r0 + l) : 0ull;
    if (is_int) v[l] += uoff;
  }
}

// The R lanes of a STORE: bool, int32 or 8-byte (int64, f64 bits) output;
// nothing past n.
template <int R>
__device__ __forceinline__ void store_rows(void* p, int kind, long long r0, long long n,
                                           bool full, const u64 (&v)[R]) {
  const int k = kind & 7;
  if (full && (kind & kVec)) {
    if (k == K_BOOL) {
      unsigned char e[R];
#pragma unroll
      for (int l = 0; l < R; ++l) e[l] = v[l] != 0;
      st_vec<R, unsigned char>(p, r0, e);
    } else if (k == K_I32) {
      int e[R];
#pragma unroll
      for (int l = 0; l < R; ++l) e[l] = (int)(long long)v[l];
      st_vec<R, int>(p, r0, e);
    } else {
      st_vec<R, u64>(p, r0, v);
    }
    return;
  }
#pragma unroll
  for (int l = 0; l < R; ++l) {
    if (r0 + l >= n) break;
    if (k == K_BOOL) static_cast<unsigned char*>(p)[r0 + l] = v[l] != 0;
    else if (k == K_I32) static_cast<int*>(p)[r0 + l] = (int)(long long)v[l];
    else static_cast<u64*>(p)[r0 + l] = v[l];
  }
}

// Float -> int64 as JAX converts (Fault-11).
__device__ __forceinline__ long long f2i_sat(double x) {
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0) return 9223372036854775807LL;
  if (x <= -9223372036854775808.0) return (long long)(-9223372036854775807LL - 1);
  return (long long)x;  // truncation toward zero
}

__device__ __forceinline__ long long floor_mod_i(long long a, long long b) {
  if (b == 0 || b == -1) return 0;
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ double floor_mod_f(double a, double b) {
  if (b == 0.0) return 0.0;
  double r = fmod(a, b);
  if (r != 0.0 && ((r < 0.0) != (b < 0.0))) r = __dadd_rn(r, b);
  return r;
}

// One operand's R lanes: from the file, the previous result, or a constant.
template <int R>
__device__ __forceinline__ void fetch(u64 (&v)[R], int mode, int idx, const u64 (&acc)[R],
                                      const u64* rf, const u64* s_consts) {
  if (mode == M_RF) {
    const u64* src = rf + (long long)idx * R * kEvalThreads + threadIdx.x;
#pragma unroll
    for (int l = 0; l < R; ++l) v[l] = src[l * kEvalThreads];
  } else if (mode == M_ACC) {
#pragma unroll
    for (int l = 0; l < R; ++l) v[l] = acc[l];
  } else if (mode == M_CONST) {
    const u64 k = s_consts[idx];
#pragma unroll
    for (int l = 0; l < R; ++l) v[l] = k;
  }
}

// The long f64 ops and the int64 modulo, out of line: each lane calls it,
// so the interpreter's R-lane cases stay small enough for the instruction
// cache.
__device__ __noinline__ u64 long_op(int op, u64 a, u64 b) {
  switch (op) {
    case MOD_I: return (u64)floor_mod_i((long long)a, (long long)b);
    case DIV_F: return of_f(as_f(b) != 0.0 ? __ddiv_rn(as_f(a), as_f(b)) : 0.0);
    case MOD_F: return of_f(floor_mod_f(as_f(a), as_f(b)));
    case LN: return of_f(log(as_f(a)));
    case LOG2: return of_f(log2(as_f(a)));
    case LOG10: return of_f(log10(as_f(a)));
    case EXP: return of_f(exp(as_f(a)));
    case SQRT: return of_f(__dsqrt_rn(as_f(a)));
    case POW: return of_f(pow(as_f(a), as_f(b)));
    case LOGB: return of_f(__ddiv_rn(log(as_f(b)), log(as_f(a))));  // log(base a, x b)
    default: return 0;
  }
}

#define PX_LANES(expr)                          \
  _Pragma("unroll") for (int l = 0; l < R; ++l) { \
    const u64 a = A[l], b = B[l];                 \
    (void)b;                                      \
    acc[l] = (expr);                              \
  }

template <int R>
__global__ void __launch_bounds__(kEvalThreads, 4)
    scalar_eval_kernel(const int4* __restrict__ code, int n_instr,
                       const u64* __restrict__ consts, int n_consts,
                       const __grid_constant__ ScalarArgs args, long long n) {
  extern __shared__ __align__(16) unsigned char sh_scalar[];
  int4* s_code = reinterpret_cast<int4*>(sh_scalar);
  u64* s_consts = reinterpret_cast<u64*>(s_code + 2 * n_instr);
  u64* rf = s_consts + ((n_consts + 1) & ~1);
  for (int k = threadIdx.x; k < 2 * n_instr; k += blockDim.x) s_code[k] = code[k];
  for (int k = threadIdx.x; k < n_consts; k += blockDim.x) s_consts[k] = consts[k];
  __syncthreads();

  const long long tile = (long long)R * kEvalThreads;
  const long long step = (long long)gridDim.x * tile;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n; t0 += step) {
    const long long r0 = t0 + (long long)threadIdx.x * R;
    if (r0 >= n) break;  // later tiles start further on; nothing here syncs
    const bool full = r0 + R <= n;
    u64 acc[R];
#pragma unroll
    for (int l = 0; l < R; ++l) acc[l] = 0;
    for (int pc = 0; pc < n_instr; ++pc) {
      const int4 i0 = s_code[2 * pc], i1 = s_code[2 * pc + 1];
      const int op = i0.x, d = i0.y, mode = i1.y;
      u64 A[R], B[R];
      fetch<R>(A, mode & 3, i0.z, acc, rf, s_consts);
      fetch<R>(B, (mode >> 2) & 3, i0.w, acc, rf, s_consts);
      switch (op) {
        case LOAD: {
          const int c = i0.z;
          load_rows<R>(args.cols[c], args.col_kind[c], args.col_off[c], r0, n, full, acc);
          break;
        }
        case STORE: store_rows<R>(args.outs[i0.w], args.out_kind[i0.w], r0, n, full, A); break;
        case ADD_I: PX_LANES(a + b) break;
        case SUB_I: PX_LANES(a - b) break;
        case MUL_I: PX_LANES(a * b) break;
        case NEG_I: PX_LANES(0ull - a) break;
        case ABS_I: PX_LANES((long long)a < 0 ? 0ull - a : a) break;
        case MAX_I: PX_LANES((long long)a > (long long)b ? a : b) break;
        case ADD_F: PX_LANES(of_f(__dadd_rn(as_f(a), as_f(b)))) break;
        case SUB_F: PX_LANES(of_f(__dsub_rn(as_f(a), as_f(b)))) break;
        case MUL_F: PX_LANES(of_f(__dmul_rn(as_f(a), as_f(b)))) break;
        case NEG_F: PX_LANES(a ^ 0x8000000000000000ull) break;
        case ABS_F: PX_LANES(a & 0x7fffffffffffffffull) break;
        case EQ_I: PX_LANES((long long)a == (long long)b) break;
        case NE_I: PX_LANES((long long)a != (long long)b) break;
        case LT_I: PX_LANES((long long)a < (long long)b) break;
        case LE_I: PX_LANES((long long)a <= (long long)b) break;
        case GT_I: PX_LANES((long long)a > (long long)b) break;
        case GE_I: PX_LANES((long long)a >= (long long)b) break;
        case EQ_F: PX_LANES(as_f(a) == as_f(b)) break;
        case NE_F: PX_LANES(as_f(a) != as_f(b)) break;
        case LT_F: PX_LANES(as_f(a) < as_f(b)) break;
        case LE_F: PX_LANES(as_f(a) <= as_f(b)) break;
        case GT_F: PX_LANES(as_f(a) > as_f(b)) break;
        case GE_F: PX_LANES(as_f(a) >= as_f(b)) break;
        case AND: PX_LANES(a & b) break;  // bools: 0 or 1
        case OR: PX_LANES(a | b) break;
        case NOT: PX_LANES(a ^ 1ull) break;
        case B2I: PX_LANES(a) break;
        case I2F: PX_LANES(of_f(__ll2double_rn((long long)a))) break;
        case F2I: PX_LANES((u64)f2i_sat(as_f(a))) break;
        case FLOOR_F: PX_LANES(of_f(floor(as_f(a)))) break;
        case CEIL_F: PX_LANES(of_f(ceil(as_f(a)))) break;
        case RINT_F: PX_LANES(of_f(rint(as_f(a)))) break;
        case MOD_I: case DIV_F: case MOD_F: case LN: case LOG2: case LOG10: case EXP:
        case SQRT: case POW: case LOGB: PX_LANES(long_op(op, a, b)) break;
        case SELECT: {
          u64 C[R];
          fetch<R>(C, (mode >> 4) & 3, i1.x, acc, rf, s_consts);
#pragma unroll
          for (int l = 0; l < R; ++l) acc[l] = A[l] != 0 ? B[l] : C[l];
          break;
        }
        case LUT: {
          const int t = i0.w;
          const void* lut = args.luts[t];
          const int kind = args.lut_kind[t];
          const long long top = args.lut_len[t] - 1;
#pragma unroll
          for (int l = 0; l < R; ++l) {
            long long k = (long long)A[l] < 0 ? 0 : (long long)A[l];
            if (k > top) k = top;
            acc[l] = load(lut, kind, k);
          }
          break;
        }
        default: break;
      }
      if (mode & kWriteRf) {
        u64* dst = rf + (long long)d * R * kEvalThreads + threadIdx.x;
#pragma unroll
        for (int l = 0; l < R; ++l) dst[l * kEvalThreads] = acc[l];
      }
    }
  }
}

#undef PX_LANES

template <int R>
int launch_eval(const int4* code, int n_instr, const u64* consts, int n_consts, int n_regs,
                const ScalarArgs& args, long long n, cudaStream_t stream) {
  const size_t smem = (size_t)n_instr * kInsWords * sizeof(int) +
                      (size_t)((n_consts + 1) & ~1) * 8 +
                      (size_t)n_regs * R * kEvalThreads * 8;
  cudaError_t err = px::allow_smem(scalar_eval_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scalar_eval_kernel<R>,
                                                      kEvalThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tile = (long long)R * kEvalThreads;
  long long grid = (n + tile - 1) / tile;
  const long long cap = (long long)px::num_sms() * (per_sm > 0 ? per_sm : 1);
  if (grid > cap) grid = cap;
  scalar_eval_kernel<R><<<(int)grid, kEvalThreads, smem, stream>>>(
      code, n_instr, consts, n_consts, args, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// code: int32 [n_instr, 8] (ops/scalar.py ``lower``'s rows) and consts:
// 8-byte [n_consts], both on the device; n_regs: the file's depth, at most
// kMaxRegs; long_ops: whether the code has an op of long_op; cols[c] (kind col_kind[c], plus col_off[c] when an int) [n];
// luts[t] (kind lut_kind[t]) [lut_len[t]]; outs[o] (kind out_kind[o]: bool,
// int32, int64 or f64) [n].
int px_scalar_eval(const void* code, int n_instr, const void* consts, int n_consts, int n_regs,
                   int long_ops, const void* const* cols, const int* col_kind, const long long* col_off,
                   int n_cols,
                   const void* const* luts, const int* lut_kind, const long long* lut_len,
                   int n_luts, void* const* outs, const int* out_kind, int n_outs, long long n,
                   void* stream) {
  if (n_instr < 0 || n_instr > kMaxInstrs || n_consts < 0 || n_consts > kMaxConsts ||
      n_regs < 0 || n_regs > kMaxRegs || n_cols < 0 || n_cols > kMaxCols || n_luts < 0 ||
      n_luts > kMaxLuts || n_outs < 0 || n_outs > kMaxOuts) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || n_instr == 0) return (int)cudaSuccess;
  if (n_regs < 1) n_regs = 1;
  // Rows a thread: 8, or 4 when the program calls an out-of-line op (more
  // warps hide those calls better); fewer while the file overflows its budget.
  int R = long_ops ? 4 : 8;
  while (R > 1 && (size_t)n_regs * R * kEvalThreads * 8 > (size_t)kFileBytes) R /= 2;
  // A column or output is read or written in R-row vectors when its pointer
  // is aligned for them.
  auto vec = [R](const void* p, int kind) {
    int v = R * kind_bytes(kind);
    if (v > 16) v = 16;
    return ((uintptr_t)p % (uintptr_t)v) == 0 ? kVec : 0;
  };
  ScalarArgs args{};
  for (int c = 0; c < n_cols; ++c) {
    args.cols[c] = cols[c];
    args.col_kind[c] = col_kind[c] | vec(cols[c], col_kind[c]);
    args.col_off[c] = col_off[c];
  }
  for (int t = 0; t < n_luts; ++t) {
    args.luts[t] = luts[t];
    args.lut_kind[t] = lut_kind[t];
    args.lut_len[t] = lut_len[t];
  }
  for (int o = 0; o < n_outs; ++o) {
    args.outs[o] = outs[o];
    args.out_kind[o] = out_kind[o] | vec(outs[o], out_kind[o]);
  }
  const int4* c4 = static_cast<const int4*>(code);
  const u64* k8 = static_cast<const u64*>(consts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 8: return launch_eval<8>(c4, n_instr, k8, n_consts, n_regs, args, n, s);
    case 4: return launch_eval<4>(c4, n_instr, k8, n_consts, n_regs, args, n, s);
    case 2: return launch_eval<2>(c4, n_instr, k8, n_consts, n_regs, args, n, s);
    default: return launch_eval<1>(c4, n_instr, k8, n_consts, n_regs, args, n, s);
  }
}

}  // extern "C"
