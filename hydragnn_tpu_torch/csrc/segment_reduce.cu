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
// hands the kernel a row pointer over receiver-sorted edges (row r owns
// sorted positions ptr[r] .. ptr[r+1]) and, when the ids were not certified
// sorted, the stable sort permutation of the edges (perm; null = identity).
//
// Every row is cut into pieces of kPiece consecutive edges, counted from the
// row's own first edge (piece_ptr[r] .. piece_ptr[r+1] are the global ids of
// row r's pieces; an empty row has one empty piece), and piece_row[p] is the
// row of piece p (num_rows for the spare ids up to max_pieces). One launch:
//   1. One warp per piece. It reads its row from piece_row, then the row's
//      bounds, then the piece's up to 32 edge ids in one load (lane j holds
//      edge j; its gather index and weight too), then every edge's features
//      at once: lanes take VEC neighbouring channels each (float4 / float2 /
//      bf16x4 ... loads), and up to 32 edges' loads are in flight, so a
//      piece costs about four dependent memory rounds whatever its length.
//      The adds then run in edge order in fp32 registers. A row of one piece
//      (every real row of a molecular batch) is written to out directly; a
//      longer row writes one fp32 partial per piece.
//   2. Rows of several pieces (the reserved dummy row N-1, which owns every
//      pad edge; 64-atom graphs pooled): after its warps finish, the block
//      takes one ticket per such row it holds pieces of (atomicAdd of its
//      piece count on tickets[r], after __threadfence; the ticket elects the
//      combiner and never touches data). The block that completes a row adds
//      its partials in the fixed order: warp w sums the pieces w, w + 8,
//      w + 16, ... left to right, then the 8 chain sums are added left to
//      right; it then resets the row's ticket to 0, so the next launch, and a
//      CUDA graph's next replay, starts from zero. The tickets live on the
//      row index (SegmentIndex), zeroed when it is built; the partials are
//      scratch the wrapper allocates per call.
// No atomics on data: every output row and every partial has one writer,
// and each row's additions run in one fixed order (that of the two-launch
// design before, kept bit for bit), whatever other graphs share the batch
// and whichever block finishes last. Rows without edges write 0.
//
// Bound: memory. The function must read h (or data), the ids, the weights
// and write out once; it does 1-2 flops per element read, far below the
// ~20 flop/byte the card needs before arithmetic is the limit. At the
// training and serving shapes the inputs (at most a few MB) sit in the 50 MB
// L2 and the grid is one wave, so the time is the latency of the dependent
// loads above plus the launch; the design cuts that chain (no search for
// the row, no second launch, all of a piece's loads at once). Multiplies and
// adds are kept separate (__fmul_rn/__fadd_rn) so a row's sum is the plain
// version's sequence of roundings, not an FMA contraction.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // also the combine's chains
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kPiece = 32;  // edges per piece (PIECE_EDGES of ops/fused_scatter.py)
constexpr int kChainUnroll = 8;  // partials of one chain in flight together
constexpr unsigned kFull = 0xffffffffu;

// the element types as raw bits, with their fp32 conversions
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float;
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float to_f(unsigned short v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ unsigned short from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));  // round to nearest even
  }
};

// VEC neighbouring values as one aligned load or store
template <typename R, int VEC>
struct alignas(sizeof(R) * VEC) Pack {
  R x[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  using R = typename Raw<T>::type;
  const Pack<R, VEC> q = *reinterpret_cast<const Pack<R, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = Raw<T>::to_f(q.x[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  using R = typename Raw<T>::type;
  Pack<R, VEC> q;
#pragma unroll
  for (int i = 0; i < VEC; ++i) q.x[i] = Raw<T>::from_f(v[i]);
  *reinterpret_cast<Pack<R, VEC>*>(p) = q;
}

// fp32 partials written by other blocks: read through L2 (ld.global.cg)
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[VEC]);
template <>
__device__ __forceinline__ void load_partial<1>(const float* p, float (&v)[1]) {
  v[0] = __ldcg(p);
}
template <>
__device__ __forceinline__ void load_partial<2>(const float* p, float (&v)[2]) {
  const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
template <>
__device__ __forceinline__ void load_partial<4>(const float* p, float (&v)[4]) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// W_MODE: 0 = no weight, 1 = one fp32 weight per edge [E],
//         2 = one fp32 weight per edge and channel [E, C].
// GATHER: read src row gather_idx[e] (gather_scatter_sum) or row e
//         (segment_sum, the same loop without the gather).
// VEC: channels per lane (C % VEC == 0, src, out and a [E, C] weight
//      aligned to VEC elements); a pass covers 32 * VEC channels.
template <typename T, bool GATHER, int W_MODE, int VEC>
__global__ void __launch_bounds__(kThreads)
csr_sum_kernel(const T* __restrict__ src, const int* __restrict__ gather_idx,
               const float* __restrict__ w, const int* __restrict__ ptr,
               const int* __restrict__ piece_ptr, const int* __restrict__ piece_row,
               const int* __restrict__ perm, T* __restrict__ out, float* __restrict__ partial,
               int* __restrict__ tickets, int num_rows, int max_pieces, int C) {
  constexpr int kPass = 32 * VEC;
  // edges whose loads are in flight together (registers: kInFlight x VEC
  // values, twice that with per-channel weights)
  constexpr int kBudget = (W_MODE == 2 ? 32 : 64) / VEC;
  constexpr int kInFlight = kBudget < kPiece ? kBudget : kPiece;
  __shared__ int s_row[kWarpsPerBlock];  // rows this block combines, or -1
  __shared__ int s_p0[kWarpsPerBlock];
  __shared__ int s_np[kWarpsPerBlock];
  __shared__ float s_chain[kWarpsPerBlock][kPass];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarpsPerBlock;  // this block's first piece
  const int p = first + warp;
  const int r = p < max_pieces ? piece_row[p] : num_rows;
  int p0 = 0, np = 0;
  if (r < num_rows) {  // warp-uniform
    p0 = piece_ptr[r];
    np = piece_ptr[r + 1] - p0;
    const int beg = ptr[r] + (p - p0) * kPiece;
    const int n = min(ptr[r + 1] - beg, kPiece);
    // lane j holds edge j of the piece: its id, data row and weight
    int e = 0, row = 0;
    float we = 1.0f;
    if (lane < n) {
      e = perm ? perm[beg + lane] : beg + lane;
      row = GATHER ? gather_idx[e] : e;
      if (W_MODE == 1) we = w[e];
    }
    for (int c0 = 0; c0 < C; c0 += kPass) {
      const int c = c0 + lane * VEC;
      const bool live_c = c < C;  // C % VEC == 0: the whole vector is live
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      for (int j0 = 0; j0 < n; j0 += kInFlight) {
        float v[kInFlight][VEC];
        float wv[W_MODE == 2 ? kInFlight : 1][VEC];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int j = j0 + u;  // < 32: j0 is a multiple of kInFlight below n <= 32
          const long long src_row = __shfl_sync(kFull, row, j);
          if (j < n && live_c) {
            load_vec<T, VEC>(src + src_row * C + c, v[u]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) v[u][q] = 0.0f;
          }
          if constexpr (W_MODE == 2) {
            const long long edge = __shfl_sync(kFull, e, j);
            if (j < n && live_c) {
              load_vec<float, VEC>(w + edge * C + c, wv[u]);
            } else {
#pragma unroll
              for (int q = 0; q < VEC; ++q) wv[u][q] = 1.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int j = j0 + u;
          const float w1 = W_MODE == 1 ? __shfl_sync(kFull, we, j) : 1.0f;
          if (j < n) {  // warp-uniform: the edges in order
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
              float x = v[u][q];
              if constexpr (W_MODE == 1) x = __fmul_rn(x, w1);
              if constexpr (W_MODE == 2) x = __fmul_rn(x, wv[u][q]);
              acc[q] = __fadd_rn(acc[q], x);
            }
          }
        }
      }
      if (live_c) {
        if (np == 1) store_vec<T, VEC>(out + (long long)r * C + c, acc);
        else store_vec<float, VEC>(partial + (long long)p * C + c, acc);
      }
    }
  }

  // rows of several pieces: the block that adds the last of a row's pieces
  // combines the row
  const bool multi = np > 1;
  if (multi) __threadfence();  // this warp's partials before its block's ticket
  if (!__syncthreads_or(multi)) return;
  if (lane == 0) {
    int combine = -1;
    if (multi && (p == p0 || warp == 0)) {  // the row's first piece in this block
      const int count = min(first + kWarpsPerBlock, p0 + np) - p;
      const int taken = atomicAdd(&tickets[r], count);
      if (taken + count == np) {
        combine = r;
        __threadfence();  // the other blocks' partials before this block's reads
      }
    }
    s_row[warp] = combine;
    s_p0[warp] = p0;
    s_np[warp] = np;
  }
  __syncthreads();
  for (int k = 0; k < kWarpsPerBlock; ++k) {
    const int cr = s_row[k];  // block-uniform
    if (cr < 0) continue;
    const int q0 = s_p0[k];
    const int nq = s_np[k];
    for (int c0 = 0; c0 < C; c0 += kPass) {
      const int c = c0 + lane * VEC;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      if (c < C) {
        // chain `warp`: the row's pieces warp, warp + 8, ... left to right
        for (int j = warp; j < nq; j += kWarpsPerBlock * kChainUnroll) {
          float v[kChainUnroll][VEC];
#pragma unroll
          for (int u = 0; u < kChainUnroll; ++u) {
            const int pj = j + u * kWarpsPerBlock;
            if (pj < nq) {
              load_partial<VEC>(partial + (long long)(q0 + pj) * C + c, v[u]);
            } else {
#pragma unroll
              for (int q = 0; q < VEC; ++q) v[u][q] = 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kChainUnroll; ++u) {
            if (j + u * kWarpsPerBlock < nq) {
#pragma unroll
              for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], v[u][q]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) s_chain[warp][lane * VEC + q] = acc[q];
      __syncthreads();
      for (int t = threadIdx.x; t < kPass; t += kThreads) {
        if (c0 + t < C) {
          float s = 0.0f;
#pragma unroll
          for (int chain = 0; chain < kWarpsPerBlock; ++chain) s = __fadd_rn(s, s_chain[chain][t]);
          float one[1] = {s};
          store_vec<T, 1>(out + (long long)cr * C + c0 + t, one);
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) tickets[cr] = 0;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Channels per lane: the narrowest of 1, 2, 4 that needs as few passes over
// the channels as the widest the shape and the pointers allow.
template <typename T>
int channels_per_lane(int C, const void* src, const void* out, const void* w_channel) {
  auto fits = [&](int v) {
    return C % v == 0 && aligned(src, v * sizeof(T)) && aligned(out, v * sizeof(T)) &&
           (w_channel == nullptr || aligned(w_channel, v * sizeof(float)));
  };
  auto passes = [&](int v) { return (C + 32 * v - 1) / (32 * v); };
  const int widest = fits(4) ? 4 : fits(2) ? 2 : 1;
  int v = 1;
  while (v < widest && passes(v) > passes(widest)) v *= 2;
  return v;
}

template <typename T, bool GATHER, int W_MODE>
int launch(const void* src, const void* gather_idx, const void* w, const void* ptr,
           const void* piece_ptr, const void* piece_row, const void* perm, void* out,
           void* partial, void* tickets, int num_rows, int max_pieces, int piece, int C,
           void* stream) {
  if (piece != kPiece) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int vec = channels_per_lane<T>(C, src, out, W_MODE == 2 ? w : nullptr);
  const T* x = static_cast<const T*>(src);
  const int* gi = static_cast<const int*>(gather_idx);
  const float* wf = static_cast<const float*>(w);
  const int* p = static_cast<const int*>(ptr);
  const int* pp = static_cast<const int*>(piece_ptr);
  const int* pr = static_cast<const int*>(piece_row);
  const int* pm = static_cast<const int*>(perm);
  T* o = static_cast<T*>(out);
  float* part = static_cast<float*>(partial);
  int* tk = static_cast<int*>(tickets);
  if (vec == 4)
    csr_sum_kernel<T, GATHER, W_MODE, 4><<<blocks, kThreads, 0, s>>>(
        x, gi, wf, p, pp, pr, pm, o, part, tk, num_rows, max_pieces, C);
  else if (vec == 2)
    csr_sum_kernel<T, GATHER, W_MODE, 2><<<blocks, kThreads, 0, s>>>(
        x, gi, wf, p, pp, pr, pm, o, part, tk, num_rows, max_pieces, C);
  else
    csr_sum_kernel<T, GATHER, W_MODE, 1><<<blocks, kThreads, 0, s>>>(
        x, gi, wf, p, pp, pr, pm, o, part, tk, num_rows, max_pieces, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* h, const void* senders, const void* w, int w_mode,
                  const void* ptr, const void* piece_ptr, const void* piece_row,
                  const void* perm, void* out, void* partial, void* tickets, int num_rows,
                  int max_pieces, int piece, int C, void* stream) {
  if (w_mode == 0)
    return launch<T, true, 0>(h, senders, w, ptr, piece_ptr, piece_row, perm, out, partial,
                              tickets, num_rows, max_pieces, piece, C, stream);
  if (w_mode == 1)
    return launch<T, true, 1>(h, senders, w, ptr, piece_ptr, piece_row, perm, out, partial,
                              tickets, num_rows, max_pieces, piece, C, stream);
  if (w_mode == 2)
    return launch<T, true, 2>(h, senders, w, ptr, piece_ptr, piece_row, perm, out, partial,
                              tickets, num_rows, max_pieces, piece, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a device pointer; perm
// may be null (identity). partial is fp32 scratch of max_pieces x C; tickets
// is int32 [num_rows], all 0 between launches (the kernel puts back what it
// takes). Returns cudaGetLastError() after the launch.
extern "C" int gather_scatter_sum_fwd(int dtype, const void* h, const void* senders,
                                      const void* w, int w_mode, const void* ptr,
                                      const void* piece_ptr, const void* piece_row,
                                      const void* perm, void* out, void* partial,
                                      void* tickets, int num_rows, int max_pieces, int piece,
                                      int C, void* stream) {
  if (dtype == 0)
    return launch_gather<float>(h, senders, w, w_mode, ptr, piece_ptr, piece_row, perm, out,
                                partial, tickets, num_rows, max_pieces, piece, C, stream);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16>(h, senders, w, w_mode, ptr, piece_ptr, piece_row, perm,
                                        out, partial, tickets, num_rows, max_pieces, piece, C,
                                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int segment_sum_fwd(int dtype, const void* data, const void* ptr,
                               const void* piece_ptr, const void* piece_row, const void* perm,
                               void* out, void* partial, void* tickets, int num_rows,
                               int max_pieces, int piece, int C, void* stream) {
  if (dtype == 0)
    return launch<float, false, 0>(data, nullptr, nullptr, ptr, piece_ptr, piece_row, perm, out,
                                   partial, tickets, num_rows, max_pieces, piece, C, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false, 0>(data, nullptr, nullptr, ptr, piece_ptr, piece_row,
                                           perm, out, partial, tickets, num_rows, max_pieces,
                                           piece, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
