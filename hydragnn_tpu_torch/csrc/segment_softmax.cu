// Softmax kernels for Hopper (sm_90a): the attention normalisations of
// hydragnn_tpu_torch's GAT and GPS layers.
//
// Replaces two Pallas kernels of the JAX package:
//   * segment_softmax_fwd <- hydragnn_tpu/ops/fused_softmax.py::_softmax_kernel
//     (launcher _pallas_softmax): per-segment softmax of [E, H] logits over
//     segment ids (GAT's receivers): out[e, h] = exp(x[e, h] - M[r, h]) /
//     max(sum_{e' in r} exp(x[e', h] - M[r, h]), 1e-12), with M the segment
//     max, taken as 0 where it is not finite. fp32 inside, output in the
//     logits' type.
//   * masked_softmax_fwd <- fused_softmax.py::_row_softmax_kernel (launcher
//     _fused_rows_fwd): softmax(where(mask > 0, x, -1e9)) of independent rows
//     of m entries (GPS's dense per-graph attention blocks [G, H, n, m]), the
//     mask read per graph as [G, m] bytes. fp32 inside, output in x's type.
//
// segment_softmax: the TPU kernel runs three phases over one-hot windows of
// receiver-sorted edges because a TPU has a matrix unit and a sequential
// grid. Here it is a segmented softmax over the CSR view of the segment ids
// (ptr over the stable-sorted ids, perm = the sort permutation or null),
// cut into the same 32-entry pieces as the segment-reduction kernels
// (segment_reduce.cu): piece_ptr[r] .. piece_ptr[r+1] are row r's pieces.
//   1. softmax_piece_kernel: one warp per piece, one lane per entry. For
//      each head the warp takes the piece's max and sum of exp(x - max) with
//      butterfly shuffles (every lane ends with the same bits). A row of one
//      piece (every real row of a molecular batch: at most 20 edges plus the
//      self loop) is normalised and written at once; a longer row writes its
//      pieces' (max, sum) pairs.
//   2. softmax_combine_kernel: one warp per row of more than one piece (the
//      reserved dummy row N-1, which owns every pad edge and every alignment
//      slot: ~11.5k of ~19.8k entries at the top QM9 bucket). It takes the
//      row max of the piece maxima and adds sum_p s_p * exp(m_p - M) in a
//      fixed order (lane-strided, then the butterfly).
//   3. softmax_normalise_kernel: one warp per piece of those rows writes
//      exp(x - M) / S.
// No atomics and fixed orders of addition: two launches on the same inputs
// give the same bits, which the serving tier's bit-equality rests on.
//
// masked_softmax: two paths, chosen by the launcher from the shape and the
// pointers.
//   * masked_rows_vec_kernel, where m is 4 L with L a power of two up to 32
//     (m = n_max = 32 for GPS on QM9: L = 8) and x, out and the mask are
//     aligned to 4 entries: one row per L lanes, so a warp holds 32 / L rows.
//     Each lane reads its 4 entries once (one float4, or 8 bytes of bf16)
//     and their 4 mask bytes as one word (the rows of one graph read the same
//     words, so they come from L1), keeps them in registers, takes the row
//     max with a log2(L)-step shuffle tree inside its lane group,
//     exponentiates each entry once, adds the exps in the general path's
//     order (its 32-lane butterfly, here shuffles across the group and adds
//     inside the lane: the two paths give the same bits, so the port's
//     answers did not move when this path came in), divides by the sum with
//     IEEE division and writes its 4 results with one store. The chain per
//     row is one load round, two short shuffle trees, 4 exps and one store.
//   * masked_row_softmax_kernel for any other m or alignment: one warp per
//     row, the lanes striding over the row's entries in three passes (max,
//     sum, write) that re-read the row from L1.
// Both: a fully masked row (a pad slot of a graph) comes out uniform, 1/m,
// as the -1e9 fill gives; masked entries of a row with any valid entry come
// out exactly 0 (their exp underflows).
//
// Bound: memory, for both. Each reads its input once and writes its output
// once and does a few flops and one exp per element, far below the ~20
// flop/byte at which the card's arithmetic would be the limit. At the served
// shapes both are far smaller than the 50 MB L2 and are launch- and
// latency-bound; multiplies and adds are kept separate (__fmul_rn,
// __fadd_rn) so the sums are the same roundings on every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr float kDenomMin = 1e-12f;  // the reference's denominator clamp
constexpr float kMaskFill = -1e9f;   // GPS's mask fill, matched exactly

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

// xor butterflies: every lane ends with the same value, and the pairing
// order is fixed, so the result is deterministic
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the reference's rule: a segment max that is not finite counts as 0
// (|m| < inf is false for +-inf and NaN)
__device__ __forceinline__ float finite_or_zero(float m) { return fabsf(m) < INFINITY ? m : 0.0f; }

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

// The piece this warp handles: its row, whether the row is this one piece,
// and the sorted positions [beg, end) of its entries.
struct Piece {
  int row;
  bool whole_row;
  int beg;
  int end;
};

__device__ __forceinline__ bool find_piece(const int* __restrict__ ptr,
                                           const int* __restrict__ piece_ptr, int num_rows,
                                           int max_pieces, int piece, Piece* out) {
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= max_pieces || p >= piece_ptr[num_rows]) return false;
  const int r = row_of_piece(piece_ptr, num_rows, p);
  const int k = p - piece_ptr[r];
  out->row = r;
  out->whole_row = piece_ptr[r + 1] - piece_ptr[r] == 1;
  out->beg = ptr[r] + k * piece;
  out->end = min(ptr[r + 1], out->beg + piece);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_piece_kernel(const T* __restrict__ logits, const int* __restrict__ ptr,
                     const int* __restrict__ piece_ptr, const int* __restrict__ perm,
                     T* __restrict__ out, float* __restrict__ piece_max,
                     float* __restrict__ piece_sum, int num_rows, int max_pieces, int piece,
                     int H) {
  Piece pc;
  if (!find_piece(ptr, piece_ptr, num_rows, max_pieces, piece, &pc)) return;
  const int lane = threadIdx.x & 31;
  const long long p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int j = pc.beg + lane;
  const bool live = j < pc.end;
  const long long e = live ? (perm ? perm[j] : j) : 0;
  for (int h = 0; h < H; ++h) {
    const float x = live ? to_float(logits[e * H + h]) : -INFINITY;
    const float m = warp_max(x);
    const float ex = live ? expf(x - finite_or_zero(m)) : 0.0f;
    const float s = warp_sum(ex);
    if (pc.whole_row) {
      if (live) out[e * H + h] = from_float<T>(ex / fmaxf(s, kDenomMin));
    } else if (lane == 0) {
      // s is the sum of exp(x - finite_or_zero(m)) over the piece
      piece_max[p * H + h] = m;
      piece_sum[p * H + h] = s;
    }
  }
}

// One warp per row; rows of a single piece were written by the piece kernel.
__global__ void __launch_bounds__(kThreads)
softmax_combine_kernel(const float* __restrict__ piece_max, const float* __restrict__ piece_sum,
                       const int* __restrict__ piece_ptr, float* __restrict__ row_shift,
                       float* __restrict__ row_denom, int num_rows, int H) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= num_rows) return;
  const int p0 = piece_ptr[r];
  const int p1 = piece_ptr[r + 1];
  if (p1 - p0 <= 1) return;
  for (int h = 0; h < H; ++h) {
    float m = -INFINITY;
    for (int p = p0 + lane; p < p1; p += 32) m = fmaxf(m, piece_max[(long long)p * H + h]);
    const float shift = finite_or_zero(warp_max(m));
    float s = 0.0f;
    for (int p = p0 + lane; p < p1; p += 32) {
      const float sp = piece_sum[(long long)p * H + h];
      // a piece whose entries are all -inf adds nothing (and must not
      // multiply its zero by an overflowing exp)
      if (sp > 0.0f) {
        const float mp = finite_or_zero(piece_max[(long long)p * H + h]);
        s = __fadd_rn(s, __fmul_rn(sp, expf(mp - shift)));
      }
    }
    s = warp_sum(s);
    if (lane == 0) {
      row_shift[(long long)r * H + h] = shift;
      row_denom[(long long)r * H + h] = fmaxf(s, kDenomMin);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_normalise_kernel(const T* __restrict__ logits, const int* __restrict__ ptr,
                         const int* __restrict__ piece_ptr, const int* __restrict__ perm,
                         const float* __restrict__ row_shift,
                         const float* __restrict__ row_denom, T* __restrict__ out,
                         int num_rows, int max_pieces, int piece, int H) {
  Piece pc;
  if (!find_piece(ptr, piece_ptr, num_rows, max_pieces, piece, &pc) || pc.whole_row) return;
  const int j = pc.beg + (threadIdx.x & 31);
  if (j >= pc.end) return;
  const long long e = perm ? perm[j] : j;
  const long long r = pc.row;
  for (int h = 0; h < H; ++h) {
    const float x = to_float(logits[e * H + h]);
    out[e * H + h] = from_float<T>(expf(x - row_shift[r * H + h]) / row_denom[r * H + h]);
  }
}

template <typename T>
int launch_segment_softmax(const void* logits, const void* ptr, const void* piece_ptr,
                           const void* perm, void* out, void* scratch, int num_rows,
                           int max_pieces, int piece, int H, void* stream) {
  if (piece < 1 || piece > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* piece_max = static_cast<float*>(scratch);
  float* piece_sum = piece_max + (long long)max_pieces * H;
  float* row_shift = piece_sum + (long long)max_pieces * H;
  float* row_denom = row_shift + (long long)num_rows * H;
  const int piece_blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int row_blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* x = static_cast<const T*>(logits);
  const int* p = static_cast<const int*>(ptr);
  const int* pp = static_cast<const int*>(piece_ptr);
  const int* pm = static_cast<const int*>(perm);
  T* o = static_cast<T*>(out);
  softmax_piece_kernel<T><<<piece_blocks, kThreads, 0, s>>>(
      x, p, pp, pm, o, piece_max, piece_sum, num_rows, max_pieces, piece, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  softmax_combine_kernel<<<row_blocks, kThreads, 0, s>>>(piece_max, piece_sum, pp, row_shift,
                                                         row_denom, num_rows, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  softmax_normalise_kernel<T><<<piece_blocks, kThreads, 0, s>>>(
      x, p, pp, pm, row_shift, row_denom, o, num_rows, max_pieces, piece, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_row_softmax_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                          T* __restrict__ out, int rows, int m, int rows_per_graph) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * m;
  const uint8_t* mr = mask + (row / rows_per_graph) * m;
  T* orow = out + row * m;
  float mx = -INFINITY;
  for (int c = lane; c < m; c += 32) {
    const float v = mr[c] != 0 ? to_float(xr[c]) : kMaskFill;
    mx = fmaxf(mx, v);
  }
  mx = warp_max(mx);
  float s = 0.0f;
  for (int c = lane; c < m; c += 32) {
    const float v = mr[c] != 0 ? to_float(xr[c]) : kMaskFill;
    s = __fadd_rn(s, expf(v - mx));
  }
  s = warp_sum(s);
  for (int c = lane; c < m; c += 32) {
    const float v = mr[c] != 0 ? to_float(xr[c]) : kMaskFill;
    orow[c] = from_float<T>(expf(v - mx) / s);
  }
}

// 4 neighbouring entries of a row as one aligned load or store: a float4,
// or 8 bytes of bf16
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

// One row per L lanes (m = 4 L), 4 entries per lane; 256 / L rows a block.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
masked_rows_vec_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int rows, int rows_per_graph) {
  constexpr int m = 4 * L;
  const long long row = (long long)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int part = (threadIdx.x % L) * 4;  // this lane's first entry of the row
  // lanes past the last row work on the last row (the shuffles need every
  // lane) and store nothing
  const long long r = row < rows ? row : rows - 1;
  const Quad<T> q = *reinterpret_cast<const Quad<T>*>(x + r * m + part);
  const uchar4 valid =
      *reinterpret_cast<const uchar4*>(mask + (r / rows_per_graph) * m + part);
  float v[4] = {valid.x ? to_float(q.v[0]) : kMaskFill, valid.y ? to_float(q.v[1]) : kMaskFill,
                valid.z ? to_float(q.v[2]) : kMaskFill, valid.w ? to_float(q.v[3]) : kMaskFill};
  float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = expf(v[i] - mx);
  // the sum in masked_row_softmax_kernel's order, so both paths give the
  // same bits: its lane l (l = 4 l' + k here: entry k of lane l' < 8 of the
  // group) adds the entries l, l + 32, ... left to right, then its 32 lanes
  // pair up by xor 16, 8, 4 (lanes l' ^ 4, 2, 1 here), 2 and 1 (entries
  // k ^ 2 and k ^ 1 of one lane); partners past the row's entries add 0
  float t[4];
  const int group = (threadIdx.x & 31) & ~(L - 1);  // the group's first lane in the warp
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t[k] = v[k];
    if (L > 8) {
      const int lane0 = group + (threadIdx.x % L) % 8;
      t[k] = __shfl_sync(0xffffffffu, v[k], lane0);
#pragma unroll
      for (int q = 1; q < L / 8; ++q)
        t[k] = __fadd_rn(t[k], __shfl_sync(0xffffffffu, v[k], lane0 + 8 * q));
    }
#pragma unroll
    for (int o = (L < 8 ? L : 8) / 2; o > 0; o >>= 1)
      t[k] = __fadd_rn(t[k], __shfl_xor_sync(0xffffffffu, t[k], o));
  }
  const float s = __fadd_rn(__fadd_rn(t[0], t[2]), __fadd_rn(t[1], t[3]));
  if (row < rows) {
    Quad<T> y;
#pragma unroll
    for (int i = 0; i < 4; ++i) y.v[i] = from_float<T>(__fdiv_rn(v[i], s));
    *reinterpret_cast<Quad<T>*>(out + r * m + part) = y;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int L>
void launch_rows_vec(const void* x, const void* mask, void* out, int rows, int rows_per_graph,
                     cudaStream_t s) {
  const int blocks = (rows + kThreads / L - 1) / (kThreads / L);
  masked_rows_vec_kernel<T, L><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask), static_cast<T*>(out), rows,
      rows_per_graph);
}

template <typename T>
int launch_masked_softmax(const void* x, const void* mask, void* out, int rows, int m,
                          int rows_per_graph, void* stream) {
  if (rows <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  if (rows_per_graph <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = m / 4;
  const bool vec = m % 4 == 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
                   aligned(x, 4 * sizeof(T)) && aligned(out, 4 * sizeof(T)) && aligned(mask, 4);
  if (!vec) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    masked_row_softmax_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(mask), static_cast<T*>(out), rows,
        m, rows_per_graph);
  } else if (lanes == 1) {
    launch_rows_vec<T, 1>(x, mask, out, rows, rows_per_graph, s);
  } else if (lanes == 2) {
    launch_rows_vec<T, 2>(x, mask, out, rows, rows_per_graph, s);
  } else if (lanes == 4) {
    launch_rows_vec<T, 4>(x, mask, out, rows, rows_per_graph, s);
  } else if (lanes == 8) {
    launch_rows_vec<T, 8>(x, mask, out, rows, rows_per_graph, s);
  } else if (lanes == 16) {
    launch_rows_vec<T, 16>(x, mask, out, rows, rows_per_graph, s);
  } else {
    launch_rows_vec<T, 32>(x, mask, out, rows, rows_per_graph, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a device pointer; perm
// may be null (identity). scratch is fp32 of 2 * (max_pieces + num_rows) * H.
// Returns cudaGetLastError() after the launches.
extern "C" int segment_softmax_fwd(int dtype, const void* logits, const void* ptr,
                                   const void* piece_ptr, const void* perm, void* out,
                                   void* scratch, int num_rows, int max_pieces, int piece,
                                   int H, void* stream) {
  if (dtype == 0)
    return launch_segment_softmax<float>(logits, ptr, piece_ptr, perm, out, scratch, num_rows,
                                         max_pieces, piece, H, stream);
  if (dtype == 1)
    return launch_segment_softmax<__nv_bfloat16>(logits, ptr, piece_ptr, perm, out, scratch,
                                                 num_rows, max_pieces, piece, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x and out: rows x m, row-major; mask: [rows / rows_per_graph, m] bytes, an
// entry is valid where its byte is not 0.
extern "C" int masked_softmax_fwd(int dtype, const void* x, const void* mask, void* out,
                                  int rows, int m, int rows_per_graph, void* stream) {
  if (dtype == 0)
    return launch_masked_softmax<float>(x, mask, out, rows, m, rows_per_graph, stream);
  if (dtype == 1)
    return launch_masked_softmax<__nv_bfloat16>(x, mask, out, rows, m, rows_per_graph, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
