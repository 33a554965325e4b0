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
// The conversion is __nv_cvt_float_to_fp8(v, __NV_SATFINITE, format) after
// the same clip as the XLA route (max = 448 for e4m3, 57344 for e5m2), both
// rounding to nearest even, as torch's .to(torch.float8_*) does; x / s_x is
// an IEEE division (__fdiv_rn). The products of two fp8 values (at most 4 + 4
// significant bits) are exact in fp32, so only the order and the rounding of
// the fp32 sum differ from the XLA route.
//
// Bound on this card: at the oc20 EGNN's first edge-MLP Dense (25,472 rows)
// and at qm9's Dense shapes the layer reads fp32 x and writes fp32 y, a few
// MB, against ~2 M K N fp8 operations at 1,979 TFLOP/s: memory bounds it
// (5.9 us at the EGNN's [25472, 129] x [129, 64], 0.29 us at qm9's
// [1864, 64] x [64, 64], at 3.35 TB/s).
//
// Design: quant_mma.cuh's tensor-core kernel, shared with the int8 layer
// (kernel B6), with the fp8 policy below: the same staging (codes once per
// CTA, W_q's bytes transposed into the B operand's layout with __byte_perm,
// K zero-padded to a multiple of 32) and the same fragments, whose layout
// for 8-bit floats is the s8 one.

#include <cuda_fp8.h>

#include "quant_mma.cuh"

namespace {

template <__nv_fp8_interpretation_t FMT>
struct Fp8 {
  using Scale = const float*;  // s_x is read on the device
  using Acc = float;
  __device__ static float scale(const float* s) { return *s; }
  __device__ static int code(float v, float s_x) {
    const float bound = FMT == __NV_E4M3 ? 448.0f : 57344.0f;
    return __nv_cvt_float_to_fp8(fminf(fmaxf(__fdiv_rn(v, s_x), -bound), bound),
                                 __NV_SATFINITE, FMT);
  }
  __device__ static void mma(float acc[4], const uint32_t a[4], uint2 b) {
    if constexpr (FMT == __NV_E4M3) {
      asm(
          "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
    } else {
      asm(
          "mma.sync.aligned.m16n8k32.row.col.f32.e5m2.e5m2.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
    }
  }
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
    return quant_mma::launch<Fp8<__NV_E4M3>, float>(x, wq, sw, bias, s, out, xq_out, nullptr, M,
                                                    K, N, stream);
  if (fmt == 1)
    return quant_mma::launch<Fp8<__NV_E5M2>, float>(x, wq, sw, bias, s, out, xq_out, nullptr, M,
                                                    K, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
