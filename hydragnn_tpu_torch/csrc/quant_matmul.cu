// Int8 quantized dense layer for Hopper (sm_90a): every calibrated Dense of
// hydragnn_tpu_torch's quantized predict step (serve/quant.py).
//
// Replaces one Pallas kernel of the JAX package:
//   quant_dense_fwd <- hydragnn_tpu/ops/quant_matmul.py::_quant_kernel
//   (launcher quant_dense):
//     x_q[m, k] = clip(rint(x[m, k] / s_x), -127, 127)          (int8)
//     acc[m, n] = sum_k x_q[m, k] * W_q[k, n]                     (int32)
//     y[m, n]   = fma(float(acc[m, n]), s_x * s_w[n], b[n])        (fp32)
//   x [M, K] fp32 or bf16 row-major, W_q [K, N] int8 row-major (the JAX
//   layout), s_w [N] and b [N] fp32, s_x a host float.
//
// Arithmetic, operation for operation the XLA route's: x / s_x is an IEEE
// division (__fdiv_rn, never a reciprocal multiply), rintf rounds half to
// even as jnp.round does, the clamp to +-127 is taken in fp32; the int8
// products are summed exactly in int32, so any order of the sum (here the
// tensor cores') gives the same bits; s_x * s_w[n] is one fp32 product
// (__fmul_rn) and the dequantisation and bias one fused multiply-add
// (__fmaf_rn), the single rounding the XLA CPU route computes.
//
// Bound on this card: at the served shapes (M = 1,864 rows, K = N = 64) the
// layer moves ~0.96 MB (fp32 x in, fp32 y out, 4 KB of weights) and does
// 15 M int8 operations, so memory bounds it (~0.29 us at 3.35 TB/s); at
// these sizes a call is a launch and one round of load latency.
//
// Design: quant_mma.cuh's tensor-core kernel, shared with the fp8 layer
// (kernel B7), with the int8 policy below: the products on the int8 tensor
// cores, mma.sync m16n8k32 (s8 x s8 -> s32), one CTA of 8 warps per 16 rows
// (117 CTAs on the 132 SMs at 1,864 rows; 32 and 64 rows per CTA were slower
// at every served shape), the codes staged once per CTA, W_q transposed into
// the B operand's layout with __byte_perm while it is staged, and K
// zero-padded to a multiple of 32. The int32 sums are exact, so the tensor
// cores' order of the sum changes no bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_mma.cuh"

namespace {

struct Int8 {
  using Scale = float;  // s_x arrives as a kernel argument
  using Acc = int32_t;
  __device__ static float scale(float s) { return s; }
  __device__ static int code(float v, float s_x) {
    return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s_x)), -127.0f), 127.0f));
  }
  __device__ static void mma(int32_t acc[4], const uint32_t a[4], uint2 b) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  }
  __device__ static float to_float(int32_t acc) { return __int2float_rn(acc); }
};

}  // namespace

// dtype: 0 = fp32 x, 1 = bf16 x. bias, xq_out and acc_out may be null.
extern "C" int quant_dense_fwd(int dtype, const void* x, const void* wq, const void* sw,
                               const void* bias, float s_x, void* out, void* xq_out,
                               void* acc_out, int M, int K, int N, void* stream) {
  if (dtype == 0)
    return quant_mma::launch<Int8, float>(x, wq, sw, bias, s_x, out, xq_out, acc_out, M, K, N,
                                          stream);
  if (dtype == 1)
    return quant_mma::launch<Int8, __nv_bfloat16>(x, wq, sw, bias, s_x, out, xq_out, acc_out, M,
                                                  K, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
