// The tensor-core kernel of hydragnn_tpu_torch's quantized dense layers,
// written once as a template over the format: the int8 layer (kernel B6,
// quant_matmul.cu) and the fp8 layer (kernel B7, fp8_matmul.cu) include this
// header and supply a format policy F. A layer here computes
//
//   x_q[m, k] = F::code(x[m, k], s_x)                         (one byte)
//   acc[m, n] = sum_k x_q[m, k] * W_q[k, n]                     (F::Acc)
//   y[m, n]   = fma(F::to_float(acc[m, n]), s_x * s_w[n], b[n])  (fp32)
//
// with x [M, K] (fp32 or bf16) row-major, W_q [K, N] bytes row-major (the
// JAX layout), s_w [N] and b [N] fp32. The policy supplies:
//
//   F::Scale        how s_x arrives (a float, or a device pointer)
//   F::scale(s)     s_x as an fp32 value
//   F::code(v, s_x) the code of v as an int whose low byte is the stored code
//   F::Acc          the accumulator (int32, or fp32)
//   F::mma(acc, a, b)  acc += the products of one m16n8k32 step (fragments
//                   below), on the tensor cores
//   F::to_float(acc)   the accumulator as fp32
//
// The shared arithmetic is stated with intrinsics, so nothing depends on
// nvcc's contraction flags: s_x * s_w[n] is one fp32 product (__fmul_rn) and
// the dequantisation and bias one fused multiply-add (__fmaf_rn), the single
// rounding the XLA CPU route computes.
//
// Design: one CTA of 8 warps per 16 rows (one m-tile) and up to NC output
// columns.
//   * Staging, all in shared memory: the CTA's x rows quantized once, in
//     chunks of 8 k (one or two 16-byte loads of x, 8 codes, one 8-byte
//     store) where a row is a multiple of 16 bytes, else, where a row holds
//     a full chunk (the EGNN's K = 129), as one contiguous run of 16-byte
//     vectors across the threads, each value's code stored at its (row, k)
//     (on an H100 at the EGNN's [25472, 129]: 23.5 us, against 27 with the
//     per-value loads at a 32-byte lane stride, which stay for narrower rows
//     such as GIN's K = 1, where the run of vectors was 0.6 us slower);
//     W_q's [K, NC] slice transposed into the B operand's column
//     layout s_w[n][k], in blocks of 4 k x 16 columns (four 16-byte loads of
//     W_q rows, a 4 x 4 byte transpose in registers with __byte_perm, 32-bit
//     stores; lanes on consecutive k, so no bank conflict); the scales and
//     the bias. K is zero-padded to a multiple of 32 (a zero byte is the code
//     of 0 in every format) and NC to one of 8; a row's stride is an odd
//     multiple of 32 bytes, so the 8-byte fragment loads of a half-warp hit
//     16 distinct banks. The three staging loops start at different threads,
//     so at the served shapes every thread has one item and all its global
//     loads go out in one round. Above the 48 KB default the shared memory is
//     opted into once per device (GAT's 384 x 384 lin_l takes 170 KB); NC < N
//     only where the slice does not fit in 227 KB, and then the grid's second
//     axis tiles N.
//   * The CTA's warps split its n-tiles (8 columns each) and accumulate up to
//     8 at a time in registers: per 32 k, two 8-byte loads give a lane its A
//     fragment and one its B fragment, in the m16n8k32 layout of 8-bit
//     operands (s8, e4m3 and e5m2 alike): lane (g, t) = (lane / 4, lane % 4)
//     holds rows g and g + 8 of A and column g of B. The k order inside a
//     fragment is relabelled (logical k 4t..4t+3 and 16+4t..16+4t+3 of lane t
//     are the staged k 8t..8t+7) for A and B alike, which leaves every
//     product where it was.
//   * The epilogue dequantizes each sum with one __fmaf_rn and stores pairs
//     of columns (masked to N, which may be 1).
// 16 rows per CTA at every M: 117 CTAs at qm9's 1,864 rows, 1,592 at the
// oc20 EGNN's 25,472 edges (on an H100, 32 and 64 rows were slower for the
// int8 layer at every served shape, and 64 rows at the EGNN's M, with every
// thread's x loads issued before any was quantized, slower at both; issuing
// the tile's vectors before the weights' loads changed nothing there). Optional
// debug outputs x_q [M, K] and acc [M, N] let a check hold the codes and the
// accumulator against the plain version.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace quant_mma {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;          // rows of x per CTA: one m-tile
constexpr int kTilesPerPass = 8;   // n-tiles a warp accumulates at once
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may opt into on sm_90
constexpr int kFlatUnroll = 4;     // 16-byte vectors a thread loads at once (stage_flat)

// bytes of one staged weight column: K padded to a multiple of 32, then to an
// odd multiple of 32 (bank-conflict-free 8-byte fragment loads)
inline int row_stride(int kp) { return (kp / 32) % 2 ? kp : kp + 32; }

__device__ __forceinline__ uint32_t pack4(const int c[4]) {
  return (static_cast<uint32_t>(c[0]) & 0xffu) | ((static_cast<uint32_t>(c[1]) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c[2]) & 0xffu) << 16) | (static_cast<uint32_t>(c[3]) << 24);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its fp32
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// a 16-byte vector as its 4 fp32 or 8 bf16 values
__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its fp32
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The codes of x[row, kb .. kb + 8), zero outside [M, K), packed 4 per word
// (lowest k in the lowest byte); also stored to xq_out when it is given.
template <class F, typename T>
__device__ __forceinline__ uint2 quantize8(const T* __restrict__ x, int row, int kb, int M,
                                           int K, float s_x, bool vec,
                                           uint8_t* __restrict__ xq_out) {
  int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (row < M) {
    const size_t at = static_cast<size_t>(row) * K + kb;
    if (vec && kb + 8 <= K) {
      float v[8];
      load8(x + at, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = F::code(v[j], s_x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (kb + j < K) c[j] = F::code(load1(x + at + j), s_x);
    }
    if (xq_out != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (kb + j < K) xq_out[at + j] = static_cast<uint8_t>(c[j]);
    }
  }
  return make_uint2(pack4(c), pack4(c + 4));
}

// The codes of a whole tile whose rows are not 16-byte multiples but hold a
// full chunk of 8 values (the oc20 EGNN's K = 129): the tile's rows m0 .. m0
// + valid are one contiguous run of valid K values starting on a 16-byte
// boundary (m0 is a multiple of 16), so it is read as consecutive 16-byte
// vectors across the threads (kFlatUnroll in flight each) and every value's
// code is stored at its (row, k). The bytes no value lands on, [K, kp) of
// each row and the rows past M, are 0.
template <class F, typename T>
__device__ __forceinline__ void stage_flat(const T* __restrict__ x, int m0, int M, int K, int kp,
                                           int ks, float s_x, uint8_t* __restrict__ s_xq,
                                           uint8_t* __restrict__ xq_out, int tid) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte vector
  const int valid = min(kRows, M - m0);
  const int pad = kp - K;
  for (int i = tid; i < kRows * pad; i += kThreads) {
    const int r = i / pad;
    s_xq[r * ks + K + (i - r * pad)] = 0;
  }
  for (int i = tid; i < (kRows - valid) * K; i += kThreads) {
    const int r = i / K;
    s_xq[(valid + r) * ks + (i - r * K)] = 0;
  }
  const T* src = x + static_cast<size_t>(m0) * K;
  uint8_t* dst = xq_out != nullptr ? xq_out + static_cast<size_t>(m0) * K : nullptr;
  const int n = valid * K;
  const int nv = n / V;
  for (int v0 = tid; v0 < nv; v0 += kThreads * kFlatUnroll) {
    uint4 raw[kFlatUnroll];
#pragma unroll
    for (int u = 0; u < kFlatUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nv) raw[u] = reinterpret_cast<const uint4*>(src)[v];
    }
#pragma unroll
    for (int u = 0; u < kFlatUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= nv) continue;
      float vals[V];
      unpack16(raw[u], vals);
      int r = v * V / K, k = v * V - r * K;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int c = F::code(vals[q], s_x);
        s_xq[r * ks + k] = static_cast<uint8_t>(c);
        if (dst != nullptr) dst[v * V + q] = static_cast<uint8_t>(c);
        if (++k == K) {
          k = 0;
          ++r;
        }
      }
    }
  }
  for (int f = nv * V + tid; f < n; f += kThreads) {  // the tail of a ragged last tile
    const int r = f / K;
    const int c = F::code(load1(src + f), s_x);
    s_xq[r * ks + f - r * K] = static_cast<uint8_t>(c);
    if (dst != nullptr) dst[f] = static_cast<uint8_t>(c);
  }
}

template <class F, typename T>
__global__ void __launch_bounds__(kThreads)
quant_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wq,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 typename F::Scale s, float* __restrict__ out, uint8_t* __restrict__ xq_out,
                 typename F::Acc* __restrict__ acc_out, int M, int K, int N, int NC, int ks,
                 bool vec, bool flat, bool wvec) {
  using Acc = typename F::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const float s_x = F::scale(s);
  const int kp = (K + 31) / 32 * 32;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * NC;
  const int nc = min(NC, N - n0);
  const int ncp = (nc + 7) / 8 * 8;
  float* s_scale = reinterpret_cast<float*>(smem);              // [ncp]: s_x * s_w[n]
  float* s_bias = s_scale + ncp;                                 // [ncp]
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_bias + ncp);       // [ncp][ks]: W_q^T
  uint8_t* s_xq = s_w + static_cast<size_t>(ncp) * ks;           // [kRows][ks]: x's codes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Staging: x's codes in chunks of 8 k, W_q^T in blocks of 4 k x 16
  // columns, the scales and the bias, each loop started at another thread so
  // that at the served shapes every thread has one item and all loads go out
  // in one round.
  const int x_items = kRows * (kp / 8);
  uint8_t* xq = blockIdx.y == 0 ? xq_out : nullptr;  // the codes, written once
  if (flat) {
    stage_flat<F>(x, m0, M, K, kp, ks, s_x, s_xq, xq, tid);
  } else {
    for (int i = tid; i < x_items; i += kThreads) {
      const int r = i / (kp / 8), k8 = (i - r * (kp / 8)) * 8;
      *reinterpret_cast<uint2*>(s_xq + r * ks + k8) =
          quantize8<F>(x, m0 + r, k8, M, K, s_x, vec, xq);
    }
  }
  for (int i = (tid + kThreads - x_items % kThreads) % kThreads; i < ncp; i += kThreads) {
    s_scale[i] = i < nc ? __fmul_rn(s_x, sw[n0 + i]) : 0.0f;
    s_bias[i] = i < nc && bias != nullptr ? bias[n0 + i] : 0.0f;
  }
  const int k_quads = kp / 4;
  for (int i = kThreads - 1 - tid; i < (ncp + 15) / 16 * k_quads; i += kThreads) {
    const int c = i / k_quads * 16, k4 = (i - i / k_quads * k_quads) * 4;
    uint32_t rows[4][4];  // 4 k x 16 columns of W_q, as read
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint4 v = make_uint4(0, 0, 0, 0);
      const int k = k4 + h;
      if (k < K) {
        const uint8_t* src = wq + static_cast<size_t>(k) * N + n0 + c;
        if (wvec && c + 16 <= nc) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (c + j < nc) w[j / 4] |= static_cast<uint32_t>(src[j]) << (8 * (j % 4));
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      rows[h][0] = v.x; rows[h][1] = v.y; rows[h][2] = v.z; rows[h][3] = v.w;
    }
    // transposed: column c + 4q + j gets byte j of each row's word q, k4 in
    // its lowest byte
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo01 = __byte_perm(rows[0][q], rows[1][q], 0x5140);
      const uint32_t lo23 = __byte_perm(rows[2][q], rows[3][q], 0x5140);
      const uint32_t hi01 = __byte_perm(rows[0][q], rows[1][q], 0x7362);
      const uint32_t hi23 = __byte_perm(rows[2][q], rows[3][q], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = c + 4 * q + j;
        if (n < ncp) *reinterpret_cast<uint32_t*>(s_w + n * ks + k4) = col[j];
      }
    }
  }
  __syncthreads();

  // this warp: n-tiles warp, warp + kWarps, ...
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + g, row1 = row0 + 8;
  const uint8_t* a0 = s_xq + g * ks + 8 * t;  // row g; row g + 8 at 8 ks
  const int ntiles = ncp / 8;
  for (int p0 = warp; p0 < ntiles; p0 += kWarps * kTilesPerPass) {
    Acc acc[kTilesPerPass][4];
#pragma unroll
    for (int u = 0; u < kTilesPerPass; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0;
    for (int k0 = 0; k0 < kp; k0 += 32) {
      const uint2 lo = *reinterpret_cast<const uint2*>(a0 + k0);
      const uint2 hi = *reinterpret_cast<const uint2*>(a0 + 8 * ks + k0);
      const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int u = 0; u < kTilesPerPass; ++u) {
        const int nt = p0 + u * kWarps;
        if (nt < ntiles) {
          const uint2 b = *reinterpret_cast<const uint2*>(s_w + (nt * 8 + g) * ks + k0 + 8 * t);
          F::mma(acc[u], a, b);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTilesPerPass; ++u) {
      const int nt = p0 + u * kWarps;
      if (nt >= ntiles) continue;
      const int c = nt * 8 + 2 * t;  // this lane's first column in the slice
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row1 : row0;
        if (row >= M) continue;
        const size_t o = static_cast<size_t>(row) * N + n0 + c;
        const Acc a0_ = acc[u][2 * h], a1_ = acc[u][2 * h + 1];
        const float y0 = __fmaf_rn(F::to_float(a0_), s_scale[c], s_bias[c]);
        const float y1 = __fmaf_rn(F::to_float(a1_), s_scale[c + 1], s_bias[c + 1]);
        if (c + 1 < nc && N % 2 == 0) {
          *reinterpret_cast<float2*>(out + o) = make_float2(y0, y1);
          if (acc_out != nullptr) {
            acc_out[o] = a0_;
            acc_out[o + 1] = a1_;
          }
        } else {
          if (c < nc) {
            out[o] = y0;
            if (acc_out != nullptr) acc_out[o] = a0_;
          }
          if (c + 1 < nc) {
            out[o + 1] = y1;
            if (acc_out != nullptr) acc_out[o + 1] = a1_;
          }
        }
      }
    }
  }
}

// One launch of quant_mma_kernel<F, T>. Returns a cudaError_t. bias, xq_out
// and acc_out may be null.
template <class F, typename T>
int launch(const void* x, const void* wq, const void* sw, const void* bias, typename F::Scale s,
           void* out, void* xq_out, void* acc_out, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ks = row_stride((K + 31) / 32 * 32);
  // all N columns if their slice fits beside the x tile, else as many
  // 16-column chunks as fit
  const long fit = (kMaxSmem - static_cast<long>(kRows) * ks) / (ks + 8L);
  const int NC = fit >= (N + 7) / 8 * 8 ? N : static_cast<int>(fit / 16 * 16);
  if (NC < 1) return static_cast<int>(cudaErrorInvalidValue);  // K too large for one chunk
  const size_t smem = static_cast<size_t>((NC + 7) / 8 * 8) * (ks + 8) + kRows * ks;
  // the opt-in above 48 KB is a property of the function on one device:
  // made once per device this process launches on
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned long long bit = 1ull << dev;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(quant_mma_kernel<F, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec = aligned && (K * sizeof(T)) % 16 == 0;
  const bool flat = aligned && !vec && K >= 8;  // narrower rows: one short chunk each
  const bool wvec = reinterpret_cast<uintptr_t>(wq) % 16 == 0 && N % 16 == 0 && NC % 16 == 0;
  const dim3 grid((M + kRows - 1) / kRows, (N + NC - 1) / NC);
  quant_mma_kernel<F, T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(bias), s, static_cast<float*>(out), static_cast<uint8_t*>(xq_out),
      static_cast<typename F::Acc*>(acc_out), M, K, N, NC, ks, vec, flat, wvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace quant_mma
