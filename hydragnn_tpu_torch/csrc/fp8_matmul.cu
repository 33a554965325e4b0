// fp8 (e4m3 / e5m2) dense layer for Hopper (sm_90a): hydragnn_tpu_torch's
// ops.fp8_matmul.fp8_dense and certify_fp8_dense.
//
// Replaces one Pallas kernel of the JAX package:
//   fp8_dense_fwd <- hydragnn_tpu/ops/fp8_matmul.py::_fp8_kernel
//   (launcher fp8_dense):
//     x_q[m, k] = fp8(clip(x[m, k] / s_x, -max, max))      (saturating cast)
//     acc[m, n] = sum_k x_q[m, k] * W_q[k, n]                (fp32)
//     y[m, n]   = fma(acc[m, n], s_x * s_w[n], b[n])          (fp32)
//   x [M, K] fp32 row-major, W_q [K, N] fp8 bytes row-major (quantized per
//   output column by the wrapper), s_w [N] and b [N] fp32, s_x one fp32 on
//   the device: the activation scale is a tensor computed on the card, read
//   here through its pointer, so no value crosses to the host.
//
// The tile kernel and its launcher are quant_tile.cuh's; this file is the
// fp8 quantizer. The
// conversion is __nv_cvt_float_to_fp8(v, __NV_SATFINITE, format) after the
// same clip as the XLA route (max = 448 for e4m3, 57344 for e5m2), both
// rounding to nearest even, as torch's .to(torch.float8_*) does; x / s_x is
// an IEEE division (__fdiv_rn). The codes are decoded to fp32 exactly (in
// shared memory, weights and activations alike), and the products of two
// fp8 values (at most 4 + 4 significant bits) are exact in fp32, so only the
// order of the fp32 sum differs from the XLA route: here k = 0, 1, ..., K-1
// in one chain of __fmaf_rn.
//
// Bound on this card: at the oc20 EGNN's first edge-MLP Dense (25,472 rows)
// and at qm9's Dense shapes the layer reads fp32 x and writes fp32 y, a few
// MB, against ~2 M K N fp8 operations at 1,979 TFLOP/s: memory bounds it.
// The scalar fp32 chain does not use the tensor cores (mma.sync / wgmma
// e4m3 tiles are later work).

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "quant_tile.cuh"

namespace {

template <__nv_fp8_interpretation_t FMT>
struct Fp8 {
  using In = float;
  using Raw = __nv_fp8_storage_t;
  using Code = float;
  using Acc = float;
  using Scale = const float*;
  __device__ static float scale(const float* s) { return *s; }
  __device__ static float decode(__nv_fp8_storage_t q) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, FMT)));
  }
  __device__ static float quantize(float v, float s_x, __nv_fp8_storage_t& raw) {
    const float bound = FMT == __NV_E4M3 ? 448.0f : 57344.0f;
    raw = __nv_cvt_float_to_fp8(fminf(fmaxf(__fdiv_rn(v, s_x), -bound), bound),
                                __NV_SATFINITE, FMT);
    return decode(raw);
  }
  __device__ static float weight(__nv_fp8_storage_t w) { return decode(w); }
  __device__ static float mac(float acc, float a, float b) { return __fmaf_rn(a, b, acc); }
  __device__ static float to_float(float acc) { return acc; }
};

}  // namespace

// fmt: 0 = e4m3 (bound 448), 1 = e5m2 (bound 57344). bias and xq_out may be
// null; sx points at one fp32 on the device.
extern "C" int fp8_dense_fwd(int fmt, const void* x, const void* wq, const void* sw,
                             const void* sx, const void* bias, void* out, void* xq_out, int M,
                             int K, int N, void* stream) {
  const float* s = static_cast<const float*>(sx);
  if (fmt == 0)
    return quant_tile::launch<Fp8<__NV_E4M3>>(x, wq, sw, bias, s, out, xq_out, nullptr, M, K,
                                              N, stream);
  if (fmt == 1)
    return quant_tile::launch<Fp8<__NV_E5M2>>(x, wq, sw, bias, s, out, xq_out, nullptr, M, K,
                                              N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
