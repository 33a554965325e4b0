// Cell-list pair test for Hopper (sm_90a): the MD neighbour rebuild of
// hydragnn_tpu_torch.
//
// Replaces hydragnn_tpu/ops/fused_cell_list.py::_cell_kernel (launcher
// fused_binned_radius_graph): for every atom, the atoms of its 27 neighbour
// cells, minimum-image displacement through the cell matrix and its
// inverse, kept where d^2 <= cutoff^2 and not the atom itself.
//
// The TPU kernel gives each cell one program over fixed-width windows of
// cell-sorted atoms and writes a [cells, W, 27 W] int8 hit mask that an XLA
// epilogue decodes, cell-major. Here the hits are written as edges
// directly, in the XLA build's order (md.py:239-305): by sender (atoms in
// their original order), then by neighbour offset (the 27 offsets of
// itertools.product((-1, 0, 1), repeat=3)), then by rank in the cell. The
// wrapper (ops/fused_cell_list.py) bins and sorts in tensor code, and its
// epilogue masks pads and recomputes each edge's shift.
//
// Design: one warp per atom, two launches of one templated kernel.
//   * Lane j < 27 resolves neighbour cell j: open axes mask cells outside
//     the grid, periodic ones wrap; its candidates are the first
//     min(occupancy, capacity) atoms of the cell's sorted run. A warp scan
//     turns the 27 counts into a prefix in shared memory, and the warp then
//     walks the atom's candidates 32 at a time, one per lane, each lane
//     finding its cell by a binary search of the prefix. Dense cells (3-10
//     atoms at MD densities) so fill the lanes instead of leaving most of a
//     27 x 32 sweep idle.
//   * __ballot_sync and __popc give each hit its place among the warp's
//     hits, in candidate order.
//   * Launch 1 (WRITE = false) stores each atom's hit count; the wrapper
//     takes an exclusive cumsum on the device; launch 2 (WRITE = true)
//     writes senders and receivers from each atom's offset, dropping slots
//     at or past max_edges (the XLA build's truncation keeps that prefix).
// No atomics: the output is deterministic. Nothing is capped by the cell
// count, and the capacity is any positive int (more than 32 slots per cell
// just means more chunks).
//
// Arithmetic: each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), in the order the plain version's tensor code
// takes, (v0 m0 + v1 m1) + v2 m2 for a row vector times a 3 x 3 matrix and
// (x x + y y) + z z for d^2; rintf rounds half to even like torch.round and
// jnp.round. A pair at d^2 ~ cutoff^2 then falls the same way on both
// routes.
//
// Bound: operations. Each candidate pair costs ~50 fp32 operations (two
// 3 x 3 products, three roundings, the distance) per launch; the bytes the
// function must move are the positions, cell coordinates and sort order
// (28 B per atom), the cell table (8 B per cell) and the edges (8 B each).
// At MD sizes both bounds are around a microsecond and the kernel is
// latency-bound: each warp's candidate loads are dependent gathers of
// order[] and pos[], and most warps walk only 2-4 chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kCells = 27;  // neighbour cells, self included
constexpr unsigned kFull = 0xffffffffu;

// geo = [inv (3 x 3, row-major), cell matrix (3 x 3), periodic axes (3)]
constexpr int kInv = 0;
constexpr int kCellm = 9;
constexpr int kPbc = 18;
constexpr int kGeo = 21;

// out = v @ m for a row vector v and a row-major 3 x 3 m
__device__ __forceinline__ void rowvec_mat3(const float v[3], const float* m, float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fadd_rn(__fadd_rn(__fmul_rn(v[0], m[c]), __fmul_rn(v[1], m[3 + c])),
                       __fmul_rn(v[2], m[6 + c]));
}

template <bool WRITE>
__global__ void __launch_bounds__(kThreads)
cell_pairs_kernel(const float* __restrict__ pos, const float* __restrict__ geo,
                  const int* __restrict__ idx3, const int* __restrict__ order,
                  const int* __restrict__ start, const int* __restrict__ occ, int n, int gx,
                  int gy, int gz, int capacity, float c2, int* __restrict__ counts,
                  const int* __restrict__ offsets, int* __restrict__ senders,
                  int* __restrict__ receivers, int max_edges) {
  __shared__ float s_geo[kGeo];
  __shared__ int s_pre[kWarpsPerBlock][kCells + 1];
  __shared__ int s_first[kWarpsPerBlock][kCells];
  if (threadIdx.x < kGeo) s_geo[threadIdx.x] = geo[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;  // the whole warp: no block-level barrier follows

  // lane j < 27: neighbour cell j of atom i, its candidate count and run
  int cnt = 0, first = 0;
  if (lane < kCells) {
    const int a[3] = {idx3[3 * i] + lane / 9 - 1, idx3[3 * i + 1] + (lane / 3) % 3 - 1,
                      idx3[3 * i + 2] + lane % 3 - 1};
    const int g[3] = {gx, gy, gz};
    bool valid = true;
    int w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      valid = valid && (s_geo[kPbc + k] > 0.0f || (a[k] >= 0 && a[k] < g[k]));
      w[k] = (a[k] + g[k]) % g[k];  // a[k] in [-1, g]: a floor modulo
    }
    if (valid) {
      const int c = (w[0] * gy + w[1]) * gz + w[2];
      cnt = min(occ[c], capacity);
      first = start[c];
    }
  }
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane < kCells) {
    s_pre[warp][lane + 1] = incl;
    s_first[warp][lane] = first;
  }
  if (lane == 0) s_pre[warp][0] = 0;
  __syncwarp();
  const int total = s_pre[warp][kCells];
  const float pi[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  int base = WRITE ? offsets[i] : 0;
  for (int t0 = 0; t0 < total; t0 += 32) {  // total is the same on every lane
    const int t = t0 + lane;
    bool hit = false;
    int r = 0;
    if (t < total) {
      // the candidate's cell: the largest j with pre[j] <= t (empty cells
      // have pre[j] == pre[j + 1] and are skipped)
      int lo = 0, hi = kCells - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_pre[warp][mid] <= t) lo = mid; else hi = mid - 1;
      }
      r = order[s_first[warp][lo] + (t - s_pre[warp][lo])];
      if (r != i) {
        float d[3], f[3], wrap[3], shift[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(pos[3 * r + k], pi[k]);
        rowvec_mat3(d, s_geo + kInv, f);
#pragma unroll
        for (int k = 0; k < 3; ++k) wrap[k] = __fmul_rn(rintf(f[k]), s_geo[kPbc + k]);
        rowvec_mat3(wrap, s_geo + kCellm, shift);
#pragma unroll
        for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(d[k], shift[k]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                   __fmul_rn(d[2], d[2]));
        hit = d2 <= c2;
      }
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (WRITE && hit) {
      const int slot = base + __popc(mask & ((1u << lane) - 1u));
      if (slot < max_edges) {
        senders[slot] = i;
        receivers[slot] = r;
      }
    }
    base += __popc(mask);
  }
  if (!WRITE && lane == 0) counts[i] = base;
}

template <bool WRITE>
int launch(const void* pos, const void* geo, const void* idx3, const void* order,
           const void* start, const void* occ, int n, int gx, int gy, int gz, int capacity,
           float c2, void* counts, const void* offsets, void* senders, void* receivers,
           int max_edges, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cell_pairs_kernel<WRITE><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(geo),
        static_cast<const int*>(idx3), static_cast<const int*>(order),
        static_cast<const int*>(start), static_cast<const int*>(occ), n, gx, gy, gz, capacity,
        c2, static_cast<int*>(counts), static_cast<const int*>(offsets),
        static_cast<int*>(senders), static_cast<int*>(receivers), max_edges);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every pointer is a device pointer: pos float32 [n, 3], geo float32 [21],
// idx3 int32 [n, 3] (each atom's cell coordinates), order int32 [n] (atoms
// stably sorted by cell id), start / occ int32 [gx * gy * gz] (each cell's
// first sorted index and occupancy). c2 = cutoff^2 in float32. Returns
// cudaGetLastError() after the launch.
extern "C" int cell_list_count(const void* pos, const void* geo, const void* idx3,
                               const void* order, const void* start, const void* occ, int n,
                               int gx, int gy, int gz, int capacity, float c2, void* counts,
                               void* stream) {
  return launch<false>(pos, geo, idx3, order, start, occ, n, gx, gy, gz, capacity, c2, counts,
                       nullptr, nullptr, nullptr, 0, stream);
}

// offsets int32 [n]: each atom's first edge slot (the exclusive cumsum of
// cell_list_count's counts); senders / receivers int32 [max_edges].
extern "C" int cell_list_write(const void* pos, const void* geo, const void* idx3,
                               const void* order, const void* start, const void* occ, int n,
                               int gx, int gy, int gz, int capacity, float c2,
                               const void* offsets, void* senders, void* receivers,
                               int max_edges, void* stream) {
  return launch<true>(pos, geo, idx3, order, start, occ, n, gx, gy, gz, capacity, c2, nullptr,
                      offsets, senders, receivers, max_edges, stream);
}
