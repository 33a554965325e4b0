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
// directly, with their shifts, in the XLA build's order (md.py:239-305): by
// sender (atoms in their original order), then by neighbour offset (the 27
// offsets of itertools.product((-1, 0, 1), repeat=3)), then by rank in the
// cell. The wrapper (ops/fused_cell_list.py) bins and sorts in tensor code
// before the launch, and masks pads and poisons n_edges after it.
//
// Bound: operations. Each candidate pair costs ~48 fp32 operations (two
// 3 x 3 products, three roundings, the displacement and d^2); the bytes the
// function must move are the positions, cell coordinates and sort order
// (28 B per atom), the cell table (8 B per cell) and the edges with their
// shifts. At MD sizes (8,000 atoms, ~600k candidate pairs) both bounds are
// under a microsecond, so what costs is latency: launches, and chains of
// dependent loads inside a warp.
//
// Design: ONE launch per build, a single-pass scan with decoupled look-back
// over the atoms in their original order.
//   * A CTA takes a contiguous run of kWarps = 16 atoms, one warp per atom,
//     in the order of a ticket drawn with atomicAdd (a CTA that waits on a
//     lower ticket waits on a CTA that is already running: forward
//     progress). At 32 registers a thread, 4 CTAs fit an SM, so the
//     8,000-atom MD lattice runs in one wave and draws 500 tickets. Lane
//     j < 27 resolves neighbour cell j: open axes mask cells outside the
//     grid, periodic ones wrap; its candidates are the first
//     min(occupancy, capacity) atoms of the cell's sorted run. A warp scan
//     turns the 27 counts into a prefix in shared memory.
//   * The warp walks the atom's candidates kUnroll x 32 = 64 at a time:
//     each lane keeps a cursor into the prefix (no binary search; the
//     cursor only moves forward), issues all its kUnroll sort-order loads,
//     then all their position loads, then tests them. So an atom costs two
//     dependent global loads per 64 candidates, not two per 32. (A
//     cell-sorted copy of the positions would cut that to one, for one more
//     device operation per build that costs more than the load it saves.)
//   * __ballot_sync and __popc give each hit its place among the atom's
//     hits, in candidate order; the hit (receiver and shift) is kept in
//     shared memory, kCache per atom. Every pair is tested once.
//   * Warp 0 adds the CTA's counts, publishes them as an aggregate with a
//     status flag, looks back over the flags of lower tickets, 32 at a time
//     (one load per lane), to the nearest inclusive prefix, and publishes
//     its own. The last ticket's prefix is n_real, written to device memory
//     (no host wait).
//   * Each warp writes its cached hits at its offset, dropping slots at or
//     past max_edges (the XLA build's truncation keeps that prefix). An atom
//     with more than kCache hits walks its candidates again in the same
//     launch and writes them as it finds them.
// The flags and the ticket are control words, not data: the wrapper zeroes
// them with the shifts' buffer before every launch (one fill), so a second
// launch and a CUDA graph's next replay start from zero. No atomic touches
// an edge: the output is deterministic. Nothing is capped by the cell count,
// and the capacity is any positive int.
//
// Arithmetic: each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), in the order the plain version's tensor code
// takes, (v0 m0 + v1 m1) + v2 m2 for a row vector times a 3 x 3 matrix and
// (x x + y y) + z z for d^2; rintf rounds half to even like torch.round and
// jnp.round. A pair at d^2 ~ cutoff^2 then falls the same way on both
// routes, and the shift written, -(rint(d inv) pbc) cell, is the plain
// epilogue's value bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;  // atoms per CTA, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kMinCtas = 4;  // CTAs per SM: 32 registers a thread, 8,448 atoms in one wave
constexpr int kCells = 27;   // neighbour cells, self included
constexpr int kUnroll = 2;   // candidates per lane in flight
constexpr int kCache = 64;   // hits per atom kept in shared memory
constexpr unsigned kFull = 0xffffffffu;

// look-back flag words: status in the high half, a count in the low half
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// s_geo = [inv (3 x 3, row-major), cell matrix (3 x 3), periodic axes (3)]
constexpr int kInv = 0;
constexpr int kCellm = 9;
constexpr int kPbc = 18;
constexpr int kGeo = 21;

// A flag holds its count in the same word as its status, so relaxed loads
// and stores at device scope are enough (no other data is published).
__device__ __forceinline__ unsigned long long load_flag(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// out = v @ m for a row vector v and a row-major 3 x 3 m
__device__ __forceinline__ void rowvec_mat3(const float v[3], const float* m, float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fadd_rn(__fadd_rn(__fmul_rn(v[0], m[c]), __fmul_rn(v[1], m[3 + c])),
                       __fmul_rn(v[2], m[6 + c]));
}

// Where a hit goes: the atom's shared-memory cache (first pass) ...
struct CacheSink {
  int* r;
  float* sh;  // [kCache][3]
  __device__ void operator()(int q, int recv, const float s[3]) const {
    if (q < kCache) {
      r[q] = recv;
#pragma unroll
      for (int k = 0; k < 3; ++k) sh[3 * q + k] = s[k];
    }
  }
};

// ... or straight to the edge arrays (an atom whose hits overflow the cache)
struct EdgeSink {
  int sender, base, max_edges;
  int* senders;
  int* receivers;
  float* shifts;
  __device__ void operator()(int q, int recv, const float s[3]) const {
    const int slot = base + q;
    if (slot < max_edges) {
      senders[slot] = sender;
      receivers[slot] = recv;
#pragma unroll
      for (int k = 0; k < 3; ++k) shifts[3 * slot + k] = s[k];
    }
  }
};

// Tests atom i against its candidates (pre / first: the warp's prefix over
// the 27 cells and each cell's first sorted index) and hands each hit's
// rank among the atom's hits, receiver and shift to sink, in candidate
// order. Returns the atom's hit count (the same on every lane).
template <class Sink>
__device__ __forceinline__ int walk(int i, int lane, const int* pre, const int* first,
                                    const float* __restrict__ pos,
                                    const int* __restrict__ order, const float* geo, float c2,
                                    const Sink& sink) {
  const int total = pre[kCells];
  const float pi[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  const unsigned below = (1u << lane) - 1u;
  int cursor = 0;  // the cell of this lane's latest candidate
  int hits = 0;
  for (int t0 = 0; t0 < total; t0 += 32 * kUnroll) {  // total is the same on every lane
    int r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * 32 + lane;
      r[u] = -1;
      if (t < total) {
        // the candidate's cell: the largest j with pre[j] <= t (empty cells
        // have pre[j] == pre[j + 1] and are stepped over)
        while (pre[cursor + 1] <= t) ++cursor;
        r[u] = order[first[cursor] + (t - pre[cursor])];
      }
    }
    float p[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p[u][k] = r[u] >= 0 ? pos[3 * r[u] + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bool hit = false;
      float out[3];
      if (r[u] >= 0 && r[u] != i) {
        float d[3], f[3], wrap[3], shift[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(p[u][k], pi[k]);
        rowvec_mat3(d, geo + kInv, f);
#pragma unroll
        for (int k = 0; k < 3; ++k) wrap[k] = __fmul_rn(rintf(f[k]), geo[kPbc + k]);
        rowvec_mat3(wrap, geo + kCellm, shift);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          d[k] = __fsub_rn(d[k], shift[k]);
          out[k] = -shift[k];  // the edge's shift: pos[r] - pos[i] + out is the vector
        }
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                   __fmul_rn(d[2], d[2]));
        hit = d2 <= c2;
      }
      const unsigned mask = __ballot_sync(kFull, hit);
      if (hit) sink(hits + __popc(mask & below), r[u], out);
      hits += __popc(mask);
    }
  }
  return hits;
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
cell_list_kernel(const float* __restrict__ pos, const float* __restrict__ inv,
                 const float* __restrict__ cellm, const float* __restrict__ pbc,
                 const int* __restrict__ idx3, const int* __restrict__ order,
                 const int* __restrict__ start, const int* __restrict__ occ, int n, int gx,
                 int gy, int gz, int capacity, float c2, int max_edges,
                 int* __restrict__ senders, int* __restrict__ receivers,
                 float* __restrict__ shifts, int* __restrict__ n_real,
                 unsigned long long* flags, int* ticket) {
  __shared__ float s_geo[kGeo];
  __shared__ int s_pre[kWarps][kCells + 1];
  __shared__ int s_first[kWarps][kCells];
  __shared__ int s_hits[kWarps];
  __shared__ int s_r[kWarps][kCache];
  __shared__ float s_sh[kWarps][kCache * 3];
  __shared__ int s_tile, s_offset;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  if (threadIdx.x < kGeo) {
    const int k = threadIdx.x;
    s_geo[k] = k < kCellm ? inv[k] : k < kPbc ? cellm[k - kCellm] : pbc[k - kPbc];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = s_tile;
  const int i = tile * kWarps + warp;
  const int* pre = s_pre[warp];
  const int* first = s_first[warp];

  int hits = 0;
  if (i < n) {  // the whole warp
    // lane j < 27: neighbour cell j of atom i, its candidate count and run
    int cnt = 0, run = 0;
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
        run = start[c];
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
      s_first[warp][lane] = run;
    }
    if (lane == 0) s_pre[warp][0] = 0;
    __syncwarp();
    hits = walk(i, lane, pre, first, pos, order, s_geo, c2,
                CacheSink{s_r[warp], s_sh[warp]});
  }
  if (lane == 0) s_hits[warp] = hits;
  __syncthreads();

  // The CTA's offset: warp 0 adds the CTA's counts and looks back over the
  // flags of lower tickets, 32 at a time (one load per lane).
  if (warp == 0) {
    int aggregate = lane < kWarps ? s_hits[lane] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) aggregate += __shfl_xor_sync(kFull, aggregate, d);
    if (lane == 0)
      store_flag(flags + tile,
                 (tile > 0 ? kAggregate : kPrefix) | static_cast<unsigned>(aggregate));
    int exclusive = 0;
    for (int top = tile - 1; top >= 0; top -= 32) {  // the same on every lane
      const int p = top - lane;
      // lanes before ticket 0 read as an empty prefix
      unsigned long long f = p >= 0 ? load_flag(flags + p) : kPrefix;
      // a lower ticket's CTA is running and publishes without waiting on
      // anyone; a flag that never comes means a fault: trap, do not hang
      for (int polls = 0; __any_sync(kFull, (f >> 32) == 0); ++polls) {
        if (polls > (1 << 24)) __trap();
        if ((f >> 32) == 0) f = load_flag(flags + p);
      }
      // the nearest inclusive prefix ends the look-back: add the flags up to it
      const unsigned prefixes = __ballot_sync(kFull, (f & kPrefix) != 0);
      const int last = prefixes ? __ffs(prefixes) - 1 : 31;
      int v = lane <= last ? static_cast<int>(static_cast<unsigned>(f)) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      exclusive += v;
      if (prefixes) break;
    }
    if (lane == 0) {
      if (tile > 0)
        store_flag(flags + tile, kPrefix | static_cast<unsigned>(exclusive + aggregate));
      if (tile == (n + kWarps - 1) / kWarps - 1) *n_real = exclusive + aggregate;
      s_offset = exclusive;
    }
  }
  __syncthreads();

  if (i < n) {
    int base = s_offset;
    for (int w = 0; w < warp; ++w) base += s_hits[w];
    if (hits <= kCache) {
      for (int q = lane; q < hits; q += 32) {
        const int slot = base + q;
        if (slot < max_edges) {
          senders[slot] = i;
          receivers[slot] = s_r[warp][q];
#pragma unroll
          for (int k = 0; k < 3; ++k) shifts[3 * slot + k] = s_sh[warp][3 * q + k];
        }
      }
    } else {  // the cache kept only the first kCache hits: test again, write as found
      walk(i, lane, pre, first, pos, order, s_geo, c2,
           EdgeSink{i, base, max_edges, senders, receivers, shifts});
    }
  }
}

}  // namespace

// Atoms per CTA: the wrapper sizes the look-back flags as one per CTA.
extern "C" int cell_list_atoms_per_cta() { return kWarps; }

// Every pointer is a device pointer: pos float32 [n, 3]; inv, cellm float32
// [3, 3] row-major and pbc float32 [3] (1.0 periodic, 0.0 open); idx3 int32
// [n, 3] (each atom's cell coordinates); order int32 [n] (atoms stably
// sorted by cell id); start / occ int32 [gx * gy * gz] (each cell's first
// sorted index and occupancy). c2 = cutoff^2 in float32. Writes senders /
// receivers int32 [max_edges] and shifts float32 [max_edges, 3] for the
// live slots only, and n_real int32 (the untruncated edge count). flags
// (uint64, one per CTA) and ticket (int32) must be zero at the launch.
// Returns cudaGetLastError() after the launch.
extern "C" int cell_list_edges(const void* pos, const void* inv, const void* cellm,
                               const void* pbc, const void* idx3, const void* order,
                               const void* start, const void* occ, int n, int gx, int gy,
                               int gz, int capacity, float c2, int max_edges, void* senders,
                               void* receivers, void* shifts, void* n_real, void* flags,
                               void* ticket, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    cell_list_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(inv),
        static_cast<const float*>(cellm), static_cast<const float*>(pbc),
        static_cast<const int*>(idx3), static_cast<const int*>(order),
        static_cast<const int*>(start), static_cast<const int*>(occ), n, gx, gy, gz, capacity,
        c2, max_edges, static_cast<int*>(senders), static_cast<int*>(receivers),
        static_cast<float*>(shifts), static_cast<int*>(n_real),
        static_cast<unsigned long long*>(flags), static_cast<int*>(ticket));
  }
  return static_cast<int>(cudaGetLastError());
}
