// CSR segmented reductions for Hopper (sm_90a): the message-passing and
// pooling kernels of hydragnn_tpu_torch.
//
// Replaces two Pallas kernels of the JAX package:
//   * gather_scatter_sum_fwd <- hydragnn_tpu/ops/fused_scatter.py::_kernel
//     (launcher _pallas_gather_scatter): out[r] = sum_e w[e] * h[s[e]] over
//     the edges e whose receiver is r, fp32 accumulation, output in h's type.
//   * segment_sum_fwd <- hydragnn_tpu/ops/fused_scatter.py::_scatter_kernel
//     (launcher _fused_scatter_fwd): out[r] = sum_e data[e] over the rows e
//     whose segment id is r, fp32 accumulation, output in data's type.
//
// The TPU kernels turn the scatter into one-hot matrix products over a
// narrow node window, because the TPU has a matrix unit and a sequential
// grid. Here the same function is a CSR segmented reduction: the wrapper
// hands the kernels a row pointer over receiver-sorted edges (row r owns
// sorted positions ptr[r] .. ptr[r+1]) and, when the ids were not certified
// sorted, the stable sort permutation of the edges (perm; null = identity).
//
// Design: every row is cut into pieces of `piece` consecutive edges,
// counted from the row's own first edge (piece_ptr[r] .. piece_ptr[r+1] are
// the global ids of row r's pieces; an empty row has one empty piece).
//   1. csr_piece_kernel: one warp per piece. The lanes stride over channels
//      (neighbouring lanes read neighbouring addresses of one feature row,
//      so each gathered row is one coalesced read); the warp walks its
//      piece's edges in edge order and keeps the sums in fp32 registers. A
//      row of one piece (every real row of a molecular batch) is written to
//      out directly; a longer row writes one fp32 partial per piece.
//   2. csr_combine_kernel: one block per row of more than one piece; its
//      warps add the partials in a fixed strided order and warp 0 adds the
//      warp sums in warp order.
// No atomics: every output row and every partial has one writer, so the
// result is deterministic, and since pieces count from the row's start,
// each row's edges are summed in the same order whatever other graphs share
// the batch. Rows without edges write 0.
//
// Why pieces: a padded batch wires every pad edge (weight 0) to the
// reserved dummy row N-1, so that row can own most of the edges (11,346
// of 17,792 in a QM9 batch at the top bucket). With one warp per row it became
// a serial chain of dependent loads that set the kernel's time; pieces
// spread it over hundreds of warps.
//
// Bound: memory. The function must read h (or data), the ids, the weights
// and write out once; it does 1-2 flops per element read, far below the
// ~20 flop/byte the card needs before arithmetic is the limit. Each warp
// hoists the index, weight and feature loads of kUnroll edges ahead of
// their (in-order) adds so that several loads are in flight; the gathered
// h rows are re-read once per incoming edge (that is what a gather is), and
// at the serving shapes h (at most 1864 x 64 fp32, 0.48 MB) stays in the
// 50 MB L2. Multiplies and adds are kept separate (__fmul_rn/__fadd_rn) so
// a row's sum is the plain version's sequence of roundings, not an FMA
// contraction. With C = 1 (the first GIN layer on QM9) only lane 0 of each
// warp has a channel; that costs occupancy, not correctness.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kChannelsPerLane = 2;  // 64 channels per warp pass
constexpr int kPass = 32 * kChannelsPerLane;
constexpr int kUnroll = 8;  // edges (or partials) whose loads are in flight together

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Largest r in [0, num_rows) with piece_ptr[r] <= p (piece_ptr is
// non-decreasing and every row owns at least one piece, so r owns p).
__device__ __forceinline__ int row_of_piece(const int* __restrict__ piece_ptr, int num_rows,
                                            int p) {
  int lo = 0, hi = num_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (piece_ptr[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// w_mode: 0 = no weight, 1 = one fp32 weight per edge [E],
//         2 = one fp32 weight per edge and channel [E, C].
// GATHER: read src row gather_idx[e] (gather_scatter_sum) or row e
//         (segment_sum, the same loop without the gather).
template <typename T, bool GATHER>
__global__ void __launch_bounds__(kThreads)
csr_piece_kernel(const T* __restrict__ src, const int* __restrict__ gather_idx,
                 const float* __restrict__ w, int w_mode, const int* __restrict__ ptr,
                 const int* __restrict__ piece_ptr, const int* __restrict__ perm,
                 T* __restrict__ out, float* __restrict__ partial, int num_rows,
                 int max_pieces, int piece, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= max_pieces || p >= piece_ptr[num_rows]) return;
  const int r = row_of_piece(piece_ptr, num_rows, p);
  const int k = p - piece_ptr[r];
  const bool whole_row = piece_ptr[r + 1] - piece_ptr[r] == 1;
  const int beg = ptr[r] + k * piece;
  const int end = min(ptr[r + 1], beg + piece);
  for (int c0 = 0; c0 < C; c0 += kPass) {
    float acc[kChannelsPerLane];
#pragma unroll
    for (int q = 0; q < kChannelsPerLane; ++q) acc[q] = 0.0f;
    int j = beg;
    for (; j < end; j += kUnroll) {
      const int n = min(kUnroll, end - j);
      int e[kUnroll];
      float v[kUnroll][kChannelsPerLane];
      float we[kUnroll][kChannelsPerLane];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) e[u] = u < n ? (perm ? perm[j + u] : j + u) : 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = u < n ? (GATHER ? (long long)gather_idx[e[u]] : (long long)e[u])
                                    : 0;
        const float w1 = (u < n && w_mode == 1) ? w[e[u]] : 1.0f;
#pragma unroll
        for (int q = 0; q < kChannelsPerLane; ++q) {
          const int c = c0 + q * 32 + lane;
          const bool live = u < n && c < C;
          v[u][q] = live ? to_float(src[row * C + c]) : 0.0f;
          we[u][q] = (live && w_mode == 2) ? w[(long long)e[u] * C + c] : w1;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n) {
#pragma unroll
          for (int q = 0; q < kChannelsPerLane; ++q) {
            const float x = w_mode ? __fmul_rn(v[u][q], we[u][q]) : v[u][q];
            acc[q] = __fadd_rn(acc[q], x);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChannelsPerLane; ++q) {
      const int c = c0 + q * 32 + lane;
      if (c < C) {
        if (whole_row) out[(long long)r * C + c] = from_float<T>(acc[q]);
        else partial[(long long)p * C + c] = acc[q];
      }
    }
  }
}

// One block per row; rows of a single piece were written by the piece
// kernel and return at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_combine_kernel(const float* __restrict__ partial, const int* __restrict__ piece_ptr,
                   T* __restrict__ out, int C) {
  __shared__ float warp_sum[kWarpsPerBlock][kPass];
  const int r = blockIdx.x;
  const int p0 = piece_ptr[r];
  const int p1 = piece_ptr[r + 1];
  if (p1 - p0 <= 1) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < C; c0 += kPass) {
#pragma unroll
    for (int q = 0; q < kChannelsPerLane; ++q) {
      const int c = c0 + q * 32 + lane;
      float acc = 0.0f;
      if (c < C) {
        // the warp's pieces p0 + warp, + 8, + 16, ... added in that order;
        // kUnroll loads in flight ahead of their adds
        for (int p = p0 + warp; p < p1; p += kUnroll * kWarpsPerBlock) {
          float v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int pu = p + u * kWarpsPerBlock;
            v[u] = pu < p1 ? partial[(long long)pu * C + c] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (p + u * kWarpsPerBlock < p1) acc = __fadd_rn(acc, v[u]);
        }
      }
      warp_sum[warp][q * 32 + lane] = acc;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < kChannelsPerLane; ++q) {
        const int c = c0 + q * 32 + lane;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kWarpsPerBlock; ++k) acc = __fadd_rn(acc, warp_sum[k][q * 32 + lane]);
        if (c < C) out[(long long)r * C + c] = from_float<T>(acc);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool GATHER>
int launch(const void* src, const void* gather_idx, const void* w, int w_mode,
           const void* ptr, const void* piece_ptr, const void* perm, void* out,
           void* partial, int num_rows, int max_pieces, int piece, int C, void* stream) {
  if (num_rows > 0 && C > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
    csr_piece_kernel<T, GATHER><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(src), static_cast<const int*>(gather_idx),
        static_cast<const float*>(w), w_mode, static_cast<const int*>(ptr),
        static_cast<const int*>(piece_ptr), static_cast<const int*>(perm),
        static_cast<T*>(out), static_cast<float*>(partial), num_rows, max_pieces, piece, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_combine_kernel<T><<<num_rows, kThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<const int*>(piece_ptr),
        static_cast<T*>(out), C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a device pointer; perm
// may be null (identity). partial is fp32 scratch of max_pieces x C.
// Returns cudaGetLastError() after the launches.
extern "C" int gather_scatter_sum_fwd(int dtype, const void* h, const void* senders,
                                      const void* w, int w_mode, const void* ptr,
                                      const void* piece_ptr, const void* perm, void* out,
                                      void* partial, int num_rows, int max_pieces,
                                      int piece, int C, void* stream) {
  if (dtype == 0)
    return launch<float, true>(h, senders, w, w_mode, ptr, piece_ptr, perm, out, partial,
                               num_rows, max_pieces, piece, C, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(h, senders, w, w_mode, ptr, piece_ptr, perm, out,
                                       partial, num_rows, max_pieces, piece, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int segment_sum_fwd(int dtype, const void* data, const void* ptr,
                               const void* piece_ptr, const void* perm, void* out,
                               void* partial, int num_rows, int max_pieces, int piece, int C,
                               void* stream) {
  if (dtype == 0)
    return launch<float, false>(data, nullptr, nullptr, 0, ptr, piece_ptr, perm, out,
                                partial, num_rows, max_pieces, piece, C, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(data, nullptr, nullptr, 0, ptr, piece_ptr, perm, out,
                                        partial, num_rows, max_pieces, piece, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
