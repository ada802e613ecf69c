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
//    Program: n_instr instructions of five int32 (op, dst, a, b, c) and a
//    pool of 8-byte constants, both in device memory, loaded into shared
//    memory once per CTA. Registers: kMaxRegs 8-byte words per thread (a bool
//    as 0/1, an int64, or an f64's bits); the compiler assigns them and
//    raises on a deeper tree. Inputs: up to kMaxCols columns (bool, uint8,
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
//    Design: one thread per row, grid-stride; the interpreter loop is a
//    switch over the shared-memory program. Nothing here is fast on purpose:
//    the register file sits in local memory (dynamic indexing), and every
//    row pays one dispatch per instruction.
//
//    What bounds it on an H100: it must read each input column once and
//    write each output once (the LUTs and the program are tiny and cached):
//    bytes-bound, e.g. 10 bytes a row for service_stats.pxl's LET filter
//    (three code columns and the status as staged, uint8/uint16, and the
//    mask in; the mask and `failure` out). The interpreter's dispatch and
//    the local-memory registers set its time long before the bytes do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using px::grid_for;
using px::kThreads;

constexpr int kMaxRegs = 32;
constexpr int kMaxInstrs = 512;
constexpr int kMaxConsts = 256;
constexpr int kMaxCols = 64;
constexpr int kMaxLuts = 32;
constexpr int kMaxOuts = 64;

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

__device__ __forceinline__ double as_f(unsigned long long v) {
  return __longlong_as_double((long long)v);
}
__device__ __forceinline__ unsigned long long of_f(double d) {
  return (unsigned long long)__double_as_longlong(d);
}

// An element of a column or LUT as a register: ints widened to int64, f32
// to f64, bools to 0/1.
__device__ __forceinline__ unsigned long long load(const void* p, int kind, long long i) {
  switch (kind) {
    case K_BOOL: return static_cast<const unsigned char*>(p)[i] != 0;
    case K_U8: return static_cast<const unsigned char*>(p)[i];
    case K_U16: return static_cast<const unsigned short*>(p)[i];
    case K_I32: return (unsigned long long)(long long)static_cast<const int*>(p)[i];
    case K_I64: return (unsigned long long)static_cast<const long long*>(p)[i];
    case K_F32: return of_f((double)static_cast<const float*>(p)[i]);
    default: return (unsigned long long)static_cast<const long long*>(p)[i];  // K_F64 bits
  }
}

__device__ __forceinline__ void store(void* p, int kind, long long i, unsigned long long v) {
  switch (kind) {
    case K_BOOL: static_cast<unsigned char*>(p)[i] = v != 0; break;
    case K_I32: static_cast<int*>(p)[i] = (int)(long long)v; break;
    default: static_cast<unsigned long long*>(p)[i] = v; break;  // K_I64, K_F64 bits
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

__global__ void __launch_bounds__(kThreads)
    scalar_eval_kernel(const int* __restrict__ code, int n_instr,
                       const unsigned long long* __restrict__ consts, int n_consts,
                       ScalarArgs args, long long n) {
  extern __shared__ unsigned long long sh_scalar[];
  unsigned long long* s_consts = sh_scalar;
  int* s_code = reinterpret_cast<int*>(sh_scalar + n_consts);
  for (int k = threadIdx.x; k < n_consts; k += blockDim.x) s_consts[k] = consts[k];
  for (int k = threadIdx.x; k < 5 * n_instr; k += blockDim.x) s_code[k] = code[k];
  __syncthreads();

  unsigned long long r[kMaxRegs];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    for (int pc = 0; pc < n_instr; ++pc) {
      const int* ins = s_code + 5 * pc;
      const int op = ins[0], d = ins[1];
      const unsigned long long a = r[ins[2] & (kMaxRegs - 1)];
      const unsigned long long b = r[ins[3] & (kMaxRegs - 1)];
      const long long sa = (long long)a, sb = (long long)b;
      switch (op) {
        case LOAD: {
          const int c = ins[2];
          const int k = args.col_kind[c];
          r[d] = load(args.cols[c], k, i);
          if (k != K_BOOL && k != K_F32 && k != K_F64) r[d] += (unsigned long long)args.col_off[c];
          break;
        }
        case CONST: r[d] = s_consts[ins[2]]; break;
        case STORE: store(args.outs[ins[3]], args.out_kind[ins[3]], i, a); break;
        case ADD_I: r[d] = a + b; break;
        case SUB_I: r[d] = a - b; break;
        case MUL_I: r[d] = a * b; break;
        case MOD_I: r[d] = (unsigned long long)floor_mod_i(sa, sb); break;
        case NEG_I: r[d] = 0ull - a; break;
        case ABS_I: r[d] = sa < 0 ? 0ull - a : a; break;
        case MAX_I: r[d] = sa > sb ? a : b; break;
        case ADD_F: r[d] = of_f(__dadd_rn(as_f(a), as_f(b))); break;
        case SUB_F: r[d] = of_f(__dsub_rn(as_f(a), as_f(b))); break;
        case MUL_F: r[d] = of_f(__dmul_rn(as_f(a), as_f(b))); break;
        case DIV_F: r[d] = of_f(as_f(b) != 0.0 ? __ddiv_rn(as_f(a), as_f(b)) : 0.0); break;
        case MOD_F: r[d] = of_f(floor_mod_f(as_f(a), as_f(b))); break;
        case NEG_F: r[d] = a ^ 0x8000000000000000ull; break;
        case ABS_F: r[d] = a & 0x7fffffffffffffffull; break;
        case EQ_I: r[d] = sa == sb; break;
        case NE_I: r[d] = sa != sb; break;
        case LT_I: r[d] = sa < sb; break;
        case LE_I: r[d] = sa <= sb; break;
        case GT_I: r[d] = sa > sb; break;
        case GE_I: r[d] = sa >= sb; break;
        case EQ_F: r[d] = as_f(a) == as_f(b); break;
        case NE_F: r[d] = as_f(a) != as_f(b); break;
        case LT_F: r[d] = as_f(a) < as_f(b); break;
        case LE_F: r[d] = as_f(a) <= as_f(b); break;
        case GT_F: r[d] = as_f(a) > as_f(b); break;
        case GE_F: r[d] = as_f(a) >= as_f(b); break;
        case AND: r[d] = (a != 0) & (b != 0); break;
        case OR: r[d] = (a != 0) | (b != 0); break;
        case NOT: r[d] = a == 0; break;
        case B2I: r[d] = a; break;
        case I2F: r[d] = of_f(__ll2double_rn(sa)); break;
        case F2I: r[d] = (unsigned long long)f2i_sat(as_f(a)); break;
        case FLOOR_F: r[d] = of_f(floor(as_f(a))); break;
        case CEIL_F: r[d] = of_f(ceil(as_f(a))); break;
        case RINT_F: r[d] = of_f(rint(as_f(a))); break;
        case LN: r[d] = of_f(log(as_f(a))); break;
        case LOG2: r[d] = of_f(log2(as_f(a))); break;
        case LOG10: r[d] = of_f(log10(as_f(a))); break;
        case EXP: r[d] = of_f(exp(as_f(a))); break;
        case SQRT: r[d] = of_f(__dsqrt_rn(as_f(a))); break;
        case POW: r[d] = of_f(pow(as_f(a), as_f(b))); break;
        case LOGB: r[d] = of_f(__ddiv_rn(log(as_f(b)), log(as_f(a)))); break;  // log(base a, x b)
        case SELECT: r[d] = a != 0 ? b : r[ins[4] & (kMaxRegs - 1)]; break;
        case LUT: {
          const int t = ins[3];
          long long k = sa < 0 ? 0 : sa;
          if (k > args.lut_len[t] - 1) k = args.lut_len[t] - 1;
          r[d] = load(args.luts[t], args.lut_kind[t], k);
          break;
        }
        default: break;
      }
    }
  }
}

}  // namespace

extern "C" {

// code: int32 [n_instr, 5] and consts: 8-byte [n_consts], both on the
// device; cols[c] (kind col_kind[c], plus col_off[c] when an int) [n]; luts[t] (kind lut_kind[t])
// [lut_len[t]]; outs[o] (kind out_kind[o]: bool, int32, int64 or f64) [n].
int px_scalar_eval(const void* code, int n_instr, const void* consts, int n_consts,
                   const void* const* cols, const int* col_kind, const long long* col_off,
                   int n_cols,
                   const void* const* luts, const int* lut_kind, const long long* lut_len,
                   int n_luts, void* const* outs, const int* out_kind, int n_outs, long long n,
                   void* stream) {
  if (n_instr < 0 || n_instr > kMaxInstrs || n_consts < 0 || n_consts > kMaxConsts ||
      n_cols < 0 || n_cols > kMaxCols || n_luts < 0 || n_luts > kMaxLuts || n_outs < 0 ||
      n_outs > kMaxOuts) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || n_instr == 0) return (int)cudaSuccess;
  ScalarArgs args{};
  for (int c = 0; c < n_cols; ++c) {
    args.cols[c] = cols[c];
    args.col_kind[c] = col_kind[c];
    args.col_off[c] = col_off[c];
  }
  for (int t = 0; t < n_luts; ++t) {
    args.luts[t] = luts[t];
    args.lut_kind[t] = lut_kind[t];
    args.lut_len[t] = lut_len[t];
  }
  for (int o = 0; o < n_outs; ++o) {
    args.outs[o] = outs[o];
    args.out_kind[o] = out_kind[o];
  }
  const size_t smem = (size_t)n_consts * 8 + (size_t)n_instr * 5 * sizeof(int);
  scalar_eval_kernel<<<grid_for(n, 4), kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)code, n_instr, (const unsigned long long*)consts, n_consts, args, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
