// Native cell-list neighbor search — the graph-builder hot loop.
//
// Role of the reference's `vesin` C library (neighbor lists for
// RadiusGraph/RadiusGraphPBC): all (qi, pj) pairs with
// ||points[pj] - query[qi]|| <= radius, found via a hash-grid cell list with
// radius-sized cells and multithreaded query scan. PBC is handled by the
// Python layer (image clouds), exactly like the numpy path — this primitive
// only ever sees plain point sets.
//
// A copy of the JAX package's source. Build: see native/__init__.py.
//
// Protocol: the caller supplies an output buffer of capacity max_pairs.
// Returns the pair count written, or -(needed) when the buffer is too small
// (caller reallocates and retries; the grid is rebuilt — preprocessing is
// once-per-sample, so simplicity wins over a persistent handle).
//
// Determinism: pairs are emitted in ascending query order (thread chunks are
// contiguous and merged in order), with point order within a query following
// the grid scan — stable across runs with any thread count.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Grid {
    std::unordered_map<int64_t, std::vector<int64_t>> cells;
    double mins[3];
    double inv_r;

    int64_t key(int64_t bx, int64_t by, int64_t bz) const {
        // 21 bits per axis (signed offset) — boxes up to ~2e6 cells per side
        const int64_t B = int64_t(1) << 20;
        return ((bx + B) << 42) | ((by + B) << 21) | (bz + B);
    }

    void bin(const double* x, int64_t b[3]) const {
        for (int d = 0; d < 3; ++d)
            b[d] = (int64_t)std::floor((x[d] - mins[d]) * inv_r);
    }
};

}  // namespace

extern "C" int64_t pairs_within(
    const double* q, int64_t nq,
    const double* p, int64_t np_,
    double radius,
    int64_t* out_q, int64_t* out_p, int64_t max_pairs,
    int nthreads) {
    if (nq == 0 || np_ == 0 || radius <= 0) return 0;

    Grid grid;
    grid.inv_r = 1.0 / radius;
    for (int d = 0; d < 3; ++d) {
        double mn = q[d];
        for (int64_t i = 0; i < nq; ++i) mn = std::min(mn, q[3 * i + d]);
        for (int64_t j = 0; j < np_; ++j) mn = std::min(mn, p[3 * j + d]);
        grid.mins[d] = mn;
    }
    for (int64_t j = 0; j < np_; ++j) {
        int64_t b[3];
        grid.bin(p + 3 * j, b);
        grid.cells[grid.key(b[0], b[1], b[2])].push_back(j);
    }

    const double r2 = radius * radius;
    int nt = nthreads > 0 ? nthreads : 1;
    if (nt > nq) nt = (int)nq;
    std::vector<std::vector<int64_t>> loc_q(nt), loc_p(nt);

    auto worker = [&](int t) {
        int64_t lo = nq * t / nt, hi = nq * (t + 1) / nt;
        auto& lq = loc_q[t];
        auto& lp = loc_p[t];
        for (int64_t i = lo; i < hi; ++i) {
            int64_t b[3];
            grid.bin(q + 3 * i, b);
            const double qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
            for (int64_t dx = -1; dx <= 1; ++dx)
                for (int64_t dy = -1; dy <= 1; ++dy)
                    for (int64_t dz = -1; dz <= 1; ++dz) {
                        auto it = grid.cells.find(
                            grid.key(b[0] + dx, b[1] + dy, b[2] + dz));
                        if (it == grid.cells.end()) continue;
                        for (int64_t j : it->second) {
                            const double ddx = p[3 * j] - qx;
                            const double ddy = p[3 * j + 1] - qy;
                            const double ddz = p[3 * j + 2] - qz;
                            if (ddx * ddx + ddy * ddy + ddz * ddz <= r2) {
                                lq.push_back(i);
                                lp.push_back(j);
                            }
                        }
                    }
        }
    };

    if (nt == 1) {
        worker(0);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nt);
        for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
        for (auto& th : threads) th.join();
    }

    int64_t total = 0;
    for (int t = 0; t < nt; ++t) total += (int64_t)loc_q[t].size();
    if (total > max_pairs) return -total;

    int64_t off = 0;
    for (int t = 0; t < nt; ++t) {
        const int64_t n = (int64_t)loc_q[t].size();
        for (int64_t k = 0; k < n; ++k) {
            out_q[off + k] = loc_q[t][k];
            out_p[off + k] = loc_p[t][k];
        }
        off += n;
    }
    return total;
}
