// The tile kernel and launcher of the fp8 dense layer of hydragnn_tpu_torch
// (fp8_matmul.cu, kernel B7), written as a template over a quantizer policy.
// The int8 layer (kernel B6) has its own tensor-core kernel in
// quant_matmul.cu and no longer instantiates this one. A layer here computes
//
//   x_q[m, k] = quantize(x[m, k] / s_x)
//   acc[m, n] = sum_k x_q[m, k] * W_q[k, n]
//   y[m, n]   = fma(float(acc[m, n]), s_x * s_w[n], b[n])      (fp32)
//
// with x [M, K] row-major, W_q [K, N] row-major (the JAX layout), s_w [N] and
// b [N] fp32. A quantizer policy P supplies the format (fp8_matmul.cu's
// Fp8<e4m3 or e5m2>):
//
//   P::In     x's element type                 (float)
//   P::Raw    the stored code (W_q, x_q debug)  (an fp8 byte)
//   P::Code   the code kept in shared memory    (the decoded float)
//   P::Acc    the accumulator                   (float)
//   P::Scale  how s_x arrives                   (a device pointer)
//   scale(s)            s_x as an fp32 value
//   quantize(v, s_x, r) the code of v (and its stored byte in r)
//   weight(w)           a stored weight as a Code
//   mac(acc, a, b)      acc + a * b
//   to_float(acc)       the accumulator as fp32
//
// The shared arithmetic is stated with intrinsics, so nothing depends
// on nvcc's contraction flags: s_x * s_w[n] is one fp32 product (__fmul_rn)
// and the dequantisation and bias are one fused multiply-add (__fmaf_rn),
// the single rounding the XLA CPU route computes.
//
// Design: one CTA of 256 threads per tile of 16 rows and of up to NC output
// columns. The CTA stages W_q's [K, NC] slice (as Codes), s_x * s_w and b in
// dynamic shared memory (above the 48 KB default, opted into once per
// device), quantizes its rows of x
// into shared memory while loading them, and gives each thread outputs
// (r, n) with consecutive n across a warp: the weights a warp reads are
// consecutive (no bank conflict) and the x codes are one broadcast. Scalar
// loops take any K and N (GIN's conv layer 0 has K = 1, the heads' output
// Dense N = 1). NC = N unless the slice does not fit in 227 KB; then the
// grid's second axis tiles N and every tile re-quantizes its rows (the codes
// are the same bits). Optional debug outputs x_q [M, K] and acc [M, N] let a
// check hold the codes and the accumulator against the plain version.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace quant_tile {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // rows of x per CTA
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may opt into on sm_90

__device__ __forceinline__ float load_x(const float* x, size_t i) { return x[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// the columns of W_q one CTA holds: all N if the slice fits, else as many
// as fit beside the scales, the bias and the tile's codes
inline int columns_per_cta(int K, int N, int code_bytes) {
  long fixed = static_cast<long>(code_bytes) * kRows * K;
  long per_col = static_cast<long>(code_bytes) * K + 8;  // a weight column + scale and bias
  long fit = (kMaxSmem - fixed) / per_col;
  if (fit >= N) return N;
  return static_cast<int>(fit >= 4 ? fit / 4 * 4 : fit);
}

inline size_t smem_bytes(int K, int NC, int code_bytes) {
  return 8 * static_cast<size_t>(NC) +
         static_cast<size_t>(code_bytes) * (static_cast<size_t>(K) * NC +
                                            static_cast<size_t>(kRows) * K);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const typename P::In* __restrict__ x, const typename P::Raw* __restrict__ wq,
            const float* __restrict__ sw, const float* __restrict__ bias,
            typename P::Scale s, float* __restrict__ out,
            typename P::Raw* __restrict__ xq_out, typename P::Acc* __restrict__ acc_out,
            int M, int K, int N, int NC) {
  using Code = typename P::Code;
  using Acc = typename P::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * NC;
  const int nc = min(NC, N - n0);
  const int rows = min(kRows, M - m0);
  const float s_x = P::scale(s);
  float* s_scale = reinterpret_cast<float*>(smem);            // [nc]: s_x * s_w[n]
  float* s_bias = s_scale + nc;                                // [nc]
  Code* s_w = reinterpret_cast<Code*>(s_bias + nc);            // [K][nc]
  Code* s_xq = s_w + static_cast<size_t>(K) * nc;              // [rows][K]

  for (int i = threadIdx.x; i < nc; i += kThreads) {
    s_scale[i] = __fmul_rn(s_x, sw[n0 + i]);
    s_bias[i] = bias != nullptr ? bias[n0 + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < K * nc; i += kThreads) {
    const int k = i / nc, n = i - k * nc;
    s_w[i] = P::weight(wq[static_cast<size_t>(k) * N + n0 + n]);
  }
  for (int i = threadIdx.x; i < rows * K; i += kThreads) {
    const size_t g = static_cast<size_t>(m0) * K + i;  // rows are contiguous
    typename P::Raw raw;
    s_xq[i] = P::quantize(load_x(x, g), s_x, raw);
    if (xq_out != nullptr && blockIdx.y == 0) xq_out[g] = raw;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * nc; i += kThreads) {
    const int r = i / nc, n = i - r * nc;
    const Code* xr = s_xq + r * K;
    const Code* wc = s_w + n;
    Acc acc = 0;
    for (int k = 0; k < K; ++k) acc = P::mac(acc, xr[k], wc[k * nc]);
    const size_t o = static_cast<size_t>(m0 + r) * N + n0 + n;
    out[o] = __fmaf_rn(P::to_float(acc), s_scale[n], s_bias[n]);
    if (acc_out != nullptr) acc_out[o] = acc;
  }
}

// One launch of tile_kernel<P>. Returns a cudaError_t. bias, xq_out and
// acc_out may be null.
template <class P>
int launch(const void* x, const void* wq, const void* sw, const void* bias,
           typename P::Scale s, void* out, void* xq_out, void* acc_out, int M, int K, int N,
           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int code_bytes = sizeof(typename P::Code);
  const int NC = columns_per_cta(K, N, code_bytes);
  if (NC < 1) return static_cast<int>(cudaErrorInvalidValue);  // K too large for one column
  // the opt-in above 48 KB is a property of the function on one device:
  // made once per device this process launches on
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned long long bit = 1ull << dev;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const dim3 grid((M + kRows - 1) / kRows, (N + NC - 1) / NC);
  tile_kernel<P><<<grid, kThreads, smem_bytes(K, NC, code_bytes),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename P::In*>(x), static_cast<const typename P::Raw*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(bias), s,
      static_cast<float*>(out), static_cast<typename P::Raw*>(xq_out),
      static_cast<typename P::Acc*>(acc_out), M, K, N, NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace quant_tile
