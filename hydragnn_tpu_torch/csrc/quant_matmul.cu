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
// The tile kernel and its launcher are quant_tile.cuh's, shared with the fp8
// layer (fp8_matmul.cu); this file is the int8 quantizer. Its arithmetic is
// the XLA route's, operation for operation: x / s_x is an IEEE division
// (__fdiv_rn, never a reciprocal multiply), rintf rounds half to even as
// jnp.round does, and the int8 products are summed exactly in int32 (any
// order gives the same bits).
//
// Bound on this card: at the served shapes (M = 1,864 rows, K = N = 64) the
// layer moves ~0.96 MB (fp32 x in, fp32 y out, 4 KB of weights) and does
// 15 M int8 operations, so memory bounds it (~0.29 us at 3.35 TB/s) and at
// these sizes the launch and the weight staging dominate. The scalar int32
// loop does not use the tensor cores (wgmma / mma.sync int8 tiles are later
// work).

#include "quant_tile.cuh"

namespace {

template <typename T>
struct Int8 {
  using In = T;
  using Raw = int8_t;
  using Code = int8_t;
  using Acc = int32_t;
  using Scale = float;
  __device__ static float scale(float s) { return s; }
  __device__ static int8_t quantize(float v, float s_x, int8_t& raw) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s_x)), -127.0f), 127.0f);
    raw = static_cast<int8_t>(__float2int_rn(q));
    return raw;
  }
  __device__ static int8_t weight(int8_t w) { return w; }
  __device__ static int32_t mac(int32_t acc, int8_t a, int8_t b) {
    return acc + static_cast<int32_t>(a) * static_cast<int32_t>(b);
  }
  __device__ static float to_float(int32_t acc) { return __int2float_rn(acc); }
};

}  // namespace

// dtype: 0 = fp32 x, 1 = bf16 x. bias, xq_out and acc_out may be null.
extern "C" int quant_dense_fwd(int dtype, const void* x, const void* wq, const void* sw,
                               const void* bias, float s_x, void* out, void* xq_out,
                               void* acc_out, int M, int K, int N, void* stream) {
  if (dtype == 0)
    return quant_tile::launch<Int8<float>>(x, wq, sw, bias, s_x, out, xq_out, acc_out, M, K,
                                           N, stream);
  if (dtype == 1)
    return quant_tile::launch<Int8<__nv_bfloat16>>(x, wq, sw, bias, s_x, out, xq_out, acc_out,
                                                   M, K, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
