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
// (segment_reduce.cu): piece_ptr[r] .. piece_ptr[r+1] are row r's pieces and
// piece_row[p] is piece p's row (num_rows for the spare ids up to
// max_pieces). Two launches:
//   1. segment_softmax_kernel: one warp per piece, its row read from
//      piece_row in one load, one lane per entry holding all H heads of its
//      entry (one load round: 8-byte pairs of fp32, 4-byte pairs of bf16,
//      where H is even and the tensors aligned). For each head the warp takes
//      the piece's max and sum of exp(x - max) with butterfly shuffles (every
//      lane ends with the same bits). A row of one piece (every real row of a
//      molecular batch: at most 20 edges plus the self loop) is normalised
//      and written at once; a longer row publishes its pieces' (max, sum)
//      pairs. Rows of several pieces (the reserved dummy row N-1, which owns
//      every pad edge and alignment slot: 11,475 of 19,784 entries in 359
//      pieces at the top QM9 bucket) are combined by the block that takes
//      the last of a row's pieces: after its warps finish, a block takes one
//      ticket per such row it holds pieces of (atomicAdd of its piece count
//      on tickets[r], after __threadfence; the ticket elects the combiner and
//      never touches data), and the completing block combines the row, its
//      heads on different warps, then puts the ticket back to 0 (so the next
//      launch, and a CUDA graph's next replay, starts from zero). Lane l of a
//      head's warp loads the pairs of pieces l, l + 32, ... in one round,
//      takes the row max M (butterfly, not-finite -> 0) and adds s_p * exp(m_p
//      - M) over its pieces left to right, then the butterfly: the order of
//      the three-launch design this one replaced, so the bits are unchanged.
//   2. softmax_normalise_kernel: one warp per piece of those rows writes
//      exp(x - M) / S. On an H100 the two launches took 11.1 us at the top
//      QM9 bucket; the combining block writing the dummy row's ~69k values
//      itself, 63.6 (one SM's exps and divisions); one launch whose later
//      blocks (by a ticket drawn at their start) normalise after waiting for
//      the row's statistics, 12.3.
//   The split form (segment_softmax_stats, segment_softmax_normalise; the
//   edge-sharded route, where a row's entries lie on several ranks and every
//   rank needs the row's max and sum before it normalises) runs the same two
//   kernels as templates: the first writes every row's raw max and
//   unclamped sum instead of outputs (a row of one piece from the warp's
//   registers, a longer row from its combiner, in the orders above), the
//   second normalises the pieces of every row from statistics the ranks
//   combined (ops/fused_softmax.py::combine_softmax_stats).
// No atomics on data and no waiting: every output and every statistic has one
// writer and each sum one fixed order, so two launches on the same inputs
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
// flop/byte at which the card's arithmetic would be the limit: at GAT's top
// QM9 bucket, segment_softmax moves 2 E' H 4 + E' 4 bytes (logits in, out,
// and the ids), 1.03 MB, 0.307 us at 3.35 TB/s. At the served shapes both
// are far smaller than the 50 MB L2 and are launch- and latency-bound;
// multiplies and adds are kept separate (__fmul_rn, __fadd_rn) so the sums
// are the same roundings on every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr float kDenomMin = 1e-12f;  // the reference's denominator clamp
constexpr float kMaskFill = -1e9f;   // GPS's mask fill, matched exactly
constexpr int kPiece = 32;           // entries per piece (PIECE_EDGES of ops/fused_scatter.py)
constexpr int kHeadChunk = 8;        // heads a lane holds at once
constexpr int kStatLoads = 16;       // pieces' statistics a lane loads at once when combining

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

// kHeadChunk neighbouring heads of one entry, as VEC-wide loads and stores
// (VEC = 2: H even and the tensors aligned to two elements)
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  a = q.x;
  b = q.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(q);
  b = __high2float(q);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);  // each rounded as one
}

template <int VEC, typename T>
__device__ __forceinline__ void load_heads(const T* __restrict__ p, int hc,
                                           float (&v)[kHeadChunk]) {
#pragma unroll
  for (int i = 0; i < kHeadChunk; i += VEC) {
    if (i < hc) {
      if (VEC == 2) load2(p + i, v[i], v[i + 1]);
      else v[i] = to_float(p[i]);
    }
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_heads(T* __restrict__ p, int hc,
                                            const float (&v)[kHeadChunk]) {
#pragma unroll
  for (int i = 0; i < kHeadChunk; i += VEC) {
    if (i < hc) {
      if (VEC == 2) store2(p + i, v[i], v[i + 1]);
      else p[i] = from_float<T>(v[i]);
    }
  }
}

// Row r's statistics for head h from its pieces q0 .. q0 + nq (published by
// the blocks that took them), in the three-launch design's order: lane l
// takes the max over pieces l, l + 32, ..., then the butterfly, then the
// not-finite rule; it adds s_p * exp(m_p - M) over the same pieces left to
// right (pieces of all -inf entries add nothing), then the butterfly; the
// denominator is clamped. A lane loads its first kStatLoads pieces' pairs in
// one round and keeps them for both passes (the dummy row of a qm9 batch
// has ~360 pieces). Lane 0 writes the statistics.
template <bool STATS>
__device__ __forceinline__ void combine_row_head(const float* __restrict__ piece_max,
                                                 const float* __restrict__ piece_sum,
                                                 float* __restrict__ row_shift,
                                                 float* __restrict__ row_denom, int r, int q0,
                                                 int nq, int h, int H, int lane) {
  const float* pm = piece_max + (long long)q0 * H + h;
  const float* ps = piece_sum + (long long)q0 * H + h;
  constexpr int kRound = 32 * kStatLoads;  // pieces a warp loads in one round
  float mv[kStatLoads], sv[kStatLoads];
#pragma unroll
  for (int u = 0; u < kStatLoads; ++u) {
    const int j = lane + 32 * u;
    mv[u] = j < nq ? __ldcg(pm + (long long)j * H) : -INFINITY;
    sv[u] = j < nq ? __ldcg(ps + (long long)j * H) : 0.0f;
  }
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < kStatLoads; ++u) m = fmaxf(m, mv[u]);
  for (int j = lane + kRound; j < nq; j += 32) m = fmaxf(m, __ldcg(pm + (long long)j * H));
  const float row_max = warp_max(m);
  const float shift = finite_or_zero(row_max);
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < kStatLoads; ++u)
    if (sv[u] > 0.0f) s = __fadd_rn(s, __fmul_rn(sv[u], expf(finite_or_zero(mv[u]) - shift)));
  for (int j = lane + kRound; j < nq; j += 32) {
    const float sp = __ldcg(ps + (long long)j * H);
    if (sp > 0.0f)
      s = __fadd_rn(s, __fmul_rn(sp, expf(finite_or_zero(__ldcg(pm + (long long)j * H)) - shift)));
  }
  s = warp_sum(s);
  if (lane == 0) {
    // the split form's statistics: the raw max and the unclamped sum
    row_shift[(long long)r * H + h] = STATS ? row_max : shift;
    row_denom[(long long)r * H + h] = STATS ? s : fmaxf(s, kDenomMin);
  }
}

// The first launch: one warp per piece (piece_row gives its row in one
// load), one lane per entry holding all its heads; rows of several pieces
// combined by the block that completes them (a ticket per row elects it and
// is put back to 0). With STATS (the split form's first entry) no output is
// written: a row of one piece writes its raw max and its sum into
// row_shift / row_denom, a row of several pieces its combined raw max and
// unclamped sum, in the same order of operations.
template <typename T, int VEC, bool STATS>
__global__ void __launch_bounds__(kThreads)
segment_softmax_kernel(const T* __restrict__ logits, const int* __restrict__ ptr,
                       const int* __restrict__ piece_ptr, const int* __restrict__ piece_row,
                       const int* __restrict__ perm, T* __restrict__ out,
                       float* __restrict__ piece_max, float* __restrict__ piece_sum,
                       float* __restrict__ row_shift, float* __restrict__ row_denom,
                       int* __restrict__ tickets, int num_rows, int max_pieces, int H) {
  __shared__ int s_row[kWarpsPerBlock];  // rows this block combines, or -1
  __shared__ int s_p0[kWarpsPerBlock];
  __shared__ int s_np[kWarpsPerBlock];

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
    const bool live = lane < min(ptr[r + 1] - beg, kPiece);
    const long long e = live ? (perm ? perm[beg + lane] : beg + lane) : 0;
    for (int h0 = 0; h0 < H; h0 += kHeadChunk) {
      const int hc = min(kHeadChunk, H - h0);
      float v[kHeadChunk] = {};
      if (live) load_heads<VEC>(logits + e * H + h0, hc, v);
      float y[kHeadChunk];
#pragma unroll
      for (int i = 0; i < kHeadChunk; ++i) {
        if (i >= hc) break;  // warp-uniform
        const float x = live ? v[i] : -INFINITY;
        const float m = warp_max(x);
        const float ex = live ? expf(x - finite_or_zero(m)) : 0.0f;
        const float s = warp_sum(ex);
        if (STATS && np == 1) {
          if (lane == 0) {
            row_shift[(long long)r * H + h0 + i] = m;
            row_denom[(long long)r * H + h0 + i] = s;
          }
        } else if (np == 1) {
          y[i] = ex / fmaxf(s, kDenomMin);
        } else if (lane == 0) {
          // s is the sum of exp(x - finite_or_zero(m)) over the piece
          piece_max[(long long)p * H + h0 + i] = m;
          piece_sum[(long long)p * H + h0 + i] = s;
        }
      }
      if (!STATS && np == 1 && live) store_heads<VEC>(out + e * H + h0, hc, y);
    }
  }

  // rows of several pieces: the block that adds the last of a row's pieces
  // combines the row
  const bool multi = np > 1;
  if (multi) __threadfence();  // this warp's statistics before its block's ticket
  if (!__syncthreads_or(multi)) return;
  if (lane == 0) {
    int combine = -1;
    if (multi && (p == p0 || warp == 0)) {  // the row's first piece in this block
      const int count = min(first + kWarpsPerBlock, p0 + np) - p;
      const int taken = atomicAdd(&tickets[r], count);
      if (taken + count == np) {
        combine = r;
        __threadfence();  // the other blocks' statistics before this block's reads
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
    for (int h = warp; h < H; h += kWarpsPerBlock)  // heads to warps
      combine_row_head<STATS>(piece_max, piece_sum, row_shift, row_denom, cr, s_p0[k],
                              s_np[k], h, H, lane);
    if (threadIdx.x == 0) tickets[cr] = 0;
  }
}

// The second launch: one warp per piece of a row of several pieces, exp(x -
// M) / S from the row's statistics (the first launch wrote them). With ALL
// (the split form's second entry) one warp per piece of every row, from
// statistics combined over the ranks: M taken as 0 where it is not finite,
// S clamped at 1e-12 here (both idempotent on what the first launch wrote).
template <typename T, int VEC, bool ALL>
__global__ void __launch_bounds__(kThreads)
softmax_normalise_kernel(const T* __restrict__ logits, const int* __restrict__ ptr,
                         const int* __restrict__ piece_ptr, const int* __restrict__ piece_row,
                         const int* __restrict__ perm, const float* __restrict__ row_shift,
                         const float* __restrict__ row_denom, T* __restrict__ out,
                         int num_rows, int max_pieces, int H) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int r = p < max_pieces ? piece_row[p] : num_rows;
  if (r >= num_rows) return;
  const int p0 = piece_ptr[r];
  if (!ALL && piece_ptr[r + 1] - p0 == 1) return;
  const int beg = ptr[r] + (p - p0) * kPiece;
  if (lane >= min(ptr[r + 1] - beg, kPiece)) return;
  const long long e = perm ? perm[beg + lane] : beg + lane;
  for (int h0 = 0; h0 < H; h0 += kHeadChunk) {
    const int hc = min(kHeadChunk, H - h0);
    float v[kHeadChunk] = {}, y[kHeadChunk];
    load_heads<VEC>(logits + e * H + h0, hc, v);
#pragma unroll
    for (int i = 0; i < kHeadChunk; ++i) {
      const long long rh = (long long)r * H + h0 + i;
      if (ALL)
        y[i] = i < hc ? expf(v[i] - finite_or_zero(row_shift[rh])) /
                            fmaxf(row_denom[rh], kDenomMin)
                      : 0.0f;
      else
        y[i] = i < hc ? expf(v[i] - row_shift[rh]) / row_denom[rh] : 0.0f;
    }
    store_heads<VEC>(out + e * H + h0, hc, y);
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
int launch_segment_softmax_vec(const void* logits, const void* ptr, const void* piece_ptr,
                               const void* piece_row, const void* perm, void* out,
                               void* scratch, void* tickets, int num_rows, int max_pieces, int H,
                               cudaStream_t s) {
  float* piece_max = static_cast<float*>(scratch);
  float* piece_sum = piece_max + (long long)max_pieces * H;
  float* row_shift = piece_sum + (long long)max_pieces * H;
  float* row_denom = row_shift + (long long)num_rows * H;
  const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* x = static_cast<const T*>(logits);
  const int* p = static_cast<const int*>(ptr);
  const int* pp = static_cast<const int*>(piece_ptr);
  const int* pr = static_cast<const int*>(piece_row);
  const int* pm = static_cast<const int*>(perm);
  T* o = static_cast<T*>(out);
  segment_softmax_kernel<T, VEC, false><<<blocks, kThreads, 0, s>>>(
      x, p, pp, pr, pm, o, piece_max, piece_sum, row_shift, row_denom,
      static_cast<int*>(tickets), num_rows, max_pieces, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  softmax_normalise_kernel<T, VEC, false><<<blocks, kThreads, 0, s>>>(
      x, p, pp, pr, pm, row_shift, row_denom, o, num_rows, max_pieces, H);
  return static_cast<int>(cudaGetLastError());
}

// The split form's first entry: row_max and row_sum [num_rows, H] from the
// pieces' statistics in scratch (2 max_pieces H floats).
template <typename T, int VEC>
int launch_softmax_stats_vec(const void* logits, const void* ptr, const void* piece_ptr,
                             const void* piece_row, const void* perm, void* row_max,
                             void* row_sum, void* scratch, void* tickets, int num_rows,
                             int max_pieces, int H, cudaStream_t s) {
  float* piece_max = static_cast<float*>(scratch);
  float* piece_sum = piece_max + (long long)max_pieces * H;
  const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_softmax_kernel<T, VEC, true><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const int*>(ptr),
      static_cast<const int*>(piece_ptr), static_cast<const int*>(piece_row),
      static_cast<const int*>(perm), nullptr, piece_max, piece_sum,
      static_cast<float*>(row_max), static_cast<float*>(row_sum), static_cast<int*>(tickets),
      num_rows, max_pieces, H);
  return static_cast<int>(cudaGetLastError());
}

// The split form's second entry: every entry from its row's statistics.
template <typename T, int VEC>
int launch_softmax_normalise_vec(const void* logits, const void* ptr, const void* piece_ptr,
                                 const void* piece_row, const void* perm, const void* row_max,
                                 const void* row_sum, void* out, int num_rows, int max_pieces,
                                 int H, cudaStream_t s) {
  const int blocks = (max_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  softmax_normalise_kernel<T, VEC, true><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const int*>(ptr),
      static_cast<const int*>(piece_ptr), static_cast<const int*>(piece_row),
      static_cast<const int*>(perm), static_cast<const float*>(row_max),
      static_cast<const float*>(row_sum), static_cast<T*>(out), num_rows, max_pieces, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_softmax_split(bool stats, const void* logits, const void* ptr,
                         const void* piece_ptr, const void* piece_row, const void* perm,
                         void* row_max, void* row_sum, void* scratch, void* tickets, void* out,
                         int num_rows, int max_pieces, int piece, int H, void* stream) {
  if (piece != kPiece) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the same vector width as the fused form for the same logits, so a
  // piece's lanes load and add its heads as there
  const bool vec = H % 2 == 0 && aligned(logits, 2 * sizeof(T)) &&
                   (stats || aligned(out, 2 * sizeof(T)));
  if (stats) {
    if (vec)
      return launch_softmax_stats_vec<T, 2>(logits, ptr, piece_ptr, piece_row, perm, row_max,
                                            row_sum, scratch, tickets, num_rows, max_pieces, H,
                                            s);
    return launch_softmax_stats_vec<T, 1>(logits, ptr, piece_ptr, piece_row, perm, row_max,
                                          row_sum, scratch, tickets, num_rows, max_pieces, H, s);
  }
  if (vec)
    return launch_softmax_normalise_vec<T, 2>(logits, ptr, piece_ptr, piece_row, perm, row_max,
                                              row_sum, out, num_rows, max_pieces, H, s);
  return launch_softmax_normalise_vec<T, 1>(logits, ptr, piece_ptr, piece_row, perm, row_max,
                                            row_sum, out, num_rows, max_pieces, H, s);
}

template <typename T>
int launch_segment_softmax(const void* logits, const void* ptr, const void* piece_ptr,
                           const void* piece_row, const void* perm, void* out, void* scratch,
                           void* tickets, int num_rows, int max_pieces, int piece, int H,
                           void* stream) {
  if (piece != kPiece) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 2 == 0 && aligned(logits, 2 * sizeof(T)) && aligned(out, 2 * sizeof(T)))
    return launch_segment_softmax_vec<T, 2>(logits, ptr, piece_ptr, piece_row, perm, out,
                                            scratch, tickets, num_rows, max_pieces, H, s);
  return launch_segment_softmax_vec<T, 1>(logits, ptr, piece_ptr, piece_row, perm, out, scratch,
                                          tickets, num_rows, max_pieces, H, s);
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
// may be null (identity). scratch is fp32 of 2 * (max_pieces + num_rows) * H;
// tickets is int32 [num_rows], all 0 between launches (the kernel puts back
// what it takes). Returns cudaGetLastError() after the launches.
extern "C" int segment_softmax_fwd(int dtype, const void* logits, const void* ptr,
                                   const void* piece_ptr, const void* piece_row,
                                   const void* perm, void* out, void* scratch, void* tickets,
                                   int num_rows, int max_pieces, int piece, int H,
                                   void* stream) {
  if (dtype == 0)
    return launch_segment_softmax<float>(logits, ptr, piece_ptr, piece_row, perm, out, scratch,
                                         tickets, num_rows, max_pieces, piece, H, stream);
  if (dtype == 1)
    return launch_segment_softmax<__nv_bfloat16>(logits, ptr, piece_ptr, piece_row, perm, out,
                                                 scratch, tickets, num_rows, max_pieces, piece,
                                                 H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split form of segment_softmax_fwd (rows whose entries are spread over
// the ranks of the edge-sharded route). segment_softmax_stats writes, for
// every row and head, row_max (the raw max, -inf for a row without entries)
// and row_sum (the sum of exp(x - M), M taken as 0 where not finite,
// unclamped), in the fused kernel's order: one piece's butterflies, then a
// row's pieces by the same combiner. segment_softmax_normalise writes out =
// exp(x - M) / max(S, 1e-12) for every entry, M taken as 0 where not
// finite. With the statistics of one rank (M and S exp(0)) the two give
// segment_softmax_fwd's bits. scratch: fp32 of 2 * max_pieces * H; tickets
// as for segment_softmax_fwd.
extern "C" int segment_softmax_stats(int dtype, const void* logits, const void* ptr,
                                     const void* piece_ptr, const void* piece_row,
                                     const void* perm, void* row_max, void* row_sum,
                                     void* scratch, void* tickets, int num_rows,
                                     int max_pieces, int piece, int H, void* stream) {
  if (dtype == 0)
    return launch_softmax_split<float>(true, logits, ptr, piece_ptr, piece_row, perm, row_max,
                                       row_sum, scratch, tickets, nullptr, num_rows, max_pieces,
                                       piece, H, stream);
  if (dtype == 1)
    return launch_softmax_split<__nv_bfloat16>(true, logits, ptr, piece_ptr, piece_row, perm,
                                               row_max, row_sum, scratch, tickets, nullptr,
                                               num_rows, max_pieces, piece, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int segment_softmax_normalise(int dtype, const void* logits, const void* ptr,
                                         const void* piece_ptr, const void* piece_row,
                                         const void* perm, const void* row_max,
                                         const void* row_sum, void* out, int num_rows,
                                         int max_pieces, int piece, int H, void* stream) {
  if (dtype == 0)
    return launch_softmax_split<float>(false, logits, ptr, piece_ptr, piece_row, perm,
                                       const_cast<void*>(row_max), const_cast<void*>(row_sum),
                                       nullptr, nullptr, out, num_rows, max_pieces, piece, H,
                                       stream);
  if (dtype == 1)
    return launch_softmax_split<__nv_bfloat16>(false, logits, ptr, piece_ptr, piece_row, perm,
                                               const_cast<void*>(row_max),
                                               const_cast<void*>(row_sum), nullptr, nullptr,
                                               out, num_rows, max_pieces, piece, H, stream);
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
