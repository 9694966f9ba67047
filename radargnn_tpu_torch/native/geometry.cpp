// Native host-side geometry kernels for the offline data pipeline.
//
// A copy of radargnn_tpu/native/geometry.cpp, kept inside the PyTorch port so
// the port needs nothing of the JAX package: compiled kNN / radius edge lists
// with the reference's tie order, 1-NN, the min-area rectangle and the 2D
// point-pair features.
//
// Build: g++ -O3 -march=native -shared -fPIC geometry.cpp -o libradargnn_native.so
// Loaded via ctypes (radargnn_tpu_torch.native); the numpy fallbacks remain
// authoritative for semantics.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// kNN edge list: for each point i, its k nearest neighbors by squared
// euclidean distance over d dims, neighbors ordered ascending by distance.
// out_edges: (n*k, 2) int64 rows (sender, receiver). Ties broken by index.
void knn_edges(const double* __restrict__ pts, int64_t n, int64_t d,
               int64_t k, int64_t* __restrict__ out_edges) {
    if (k > n - 1) k = n - 1;
    // two passes per point: (1) all squared distances into a flat array —
    // a pure streaming loop the compiler vectorizes — then (2) a bounded
    // max-heap select whose threshold compare rejects almost every
    // candidate with one branch. Lexicographic (dist, idx) ordering keeps
    // the tie-break-by-index semantics of the sorted formulation.
    std::vector<double> dist(n);
    double* __restrict__ dst = dist.data();
    // SoA copy of the 2D case: unit-stride loads vectorize cleanly where
    // the interleaved (x, y) pairs would need deinterleaving shuffles
    std::vector<double> soa;
    if (d == 2) {
        soa.resize(2 * n);
        for (int64_t j = 0; j < n; ++j) {
            soa[j] = pts[2 * j];
            soa[n + j] = pts[2 * j + 1];
        }
    }
    const double* __restrict__ xs = soa.data();
    const double* __restrict__ ys = soa.data() + n;
    std::vector<std::pair<double, int64_t>> heap;
    heap.reserve(k + 1);
    if (k <= 0) return;  // single-point cloud: wrapper clamps k = n-1 = 0
    for (int64_t i = 0; i < n; ++i) {
        const double* pi = pts + i * d;
        if (d == 2) {               // radar BEV fast path
            const double x = pi[0], y = pi[1];
            for (int64_t j = 0; j < n; ++j) {
                const double dx = x - xs[j];
                const double dy = y - ys[j];
                dst[j] = dx * dx + dy * dy;
            }
        } else {
            for (int64_t j = 0; j < n; ++j) {
                const double* pj = pts + j * d;
                double s = 0.0;
                for (int64_t c = 0; c < d; ++c) {
                    double diff = pi[c] - pj[c];
                    s += diff * diff;
                }
                dst[j] = s;
            }
        }
        dst[i] = std::numeric_limits<double>::infinity();

        heap.clear();
        for (int64_t j = 0; j < k; ++j)
            heap.emplace_back(dist[j], j);
        std::make_heap(heap.begin(), heap.end());
        // NOTE (measured): a chunk-min pre-filter (vectorized 32-wide min,
        // skip chunks above the kth distance) was 13% SLOWER than this
        // plain loop — the rarely-taken branch is almost free under the
        // branch predictor, while the chunk mins re-read everything.
        for (int64_t j = k; j < n; ++j) {
            const double s = dst[j];
            if (s < heap.front().first) {
                std::pop_heap(heap.begin(), heap.end());
                heap.back() = {s, j};
                std::push_heap(heap.begin(), heap.end());
            }
            // s == kth distance: the incumbent has the smaller index — the
            // lexicographic order keeps it, so no action needed.
        }
        std::sort_heap(heap.begin(), heap.end());
        for (int64_t m = 0; m < k; ++m) {
            out_edges[(i * k + m) * 2] = i;
            out_edges[(i * k + m) * 2 + 1] = heap[m].second;
        }
    }
}

// 1-NN index per point (self excluded).
void nearest_neighbor(const double* pts, int64_t n, int64_t d, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double* pi = pts + i * d;
        double best = std::numeric_limits<double>::infinity();
        int64_t best_j = 0;
        for (int64_t j = 0; j < n; ++j) {
            if (j == i) continue;
            const double* pj = pts + j * d;
            double s = 0.0;
            for (int64_t c = 0; c < d; ++c) {
                double diff = pi[c] - pj[c];
                s += diff * diff;
            }
            if (s < best) { best = s; best_j = j; }
        }
        out[i] = best_j;
    }
}

static inline double cross2(const double* o, const double* a, const double* b) {
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]);
}

// Monotone-chain convex hull (CCW, unique points). Returns hull size.
static int64_t convex_hull(const double* pts_in, int64_t n, double* hull) {
    std::vector<std::array<double, 2>> p(n);
    for (int64_t i = 0; i < n; ++i) p[i] = {pts_in[2 * i], pts_in[2 * i + 1]};
    std::sort(p.begin(), p.end());
    p.erase(std::unique(p.begin(), p.end()), p.end());
    int64_t m = (int64_t)p.size();
    if (m <= 2) {
        for (int64_t i = 0; i < m; ++i) {
            hull[2 * i] = p[i][0];
            hull[2 * i + 1] = p[i][1];
        }
        return m;
    }
    std::vector<std::array<double, 2>> chain(2 * m);
    int64_t sz = 0;
    for (int64_t i = 0; i < m; ++i) {            // lower
        while (sz >= 2 && cross2(chain[sz - 2].data(), chain[sz - 1].data(),
                                 p[i].data()) <= 0)
            --sz;
        chain[sz++] = p[i];
    }
    int64_t lower = sz + 1;
    for (int64_t i = m - 2; i >= 0; --i) {       // upper
        while (sz >= lower && cross2(chain[sz - 2].data(), chain[sz - 1].data(),
                                     p[i].data()) <= 0)
            --sz;
        chain[sz++] = p[i];
    }
    --sz;                                        // last point == first
    for (int64_t i = 0; i < sz; ++i) {
        hull[2 * i] = chain[i][0];
        hull[2 * i + 1] = chain[i][1];
    }
    return sz;
}

// Minimum-area enclosing rotated rectangle via rotating calipers over hull
// edges. out_corners: (4, 2) in (+,+),(+,-),(-,-),(-,+) box-frame order
// (matching radargnn_tpu.utils.geometry). Returns 0 on success.
int min_area_rect(const double* pts, int64_t n, double* out_corners) {
    if (n < 3) return 1;
    std::vector<double> hull(2 * n);
    int64_t h = convex_hull(pts, n, hull.data());
    if (h < 3) return 1;

    double best_area = std::numeric_limits<double>::infinity();
    double bu[2] = {1, 0}, bo[2] = {0, 1};
    double bmin_p = 0, blen_p = 0, bmin_o = 0, blen_o = 0;

    for (int64_t i = 0; i < h; ++i) {
        int64_t j = (i + 1) % h;
        double ex = hull[2 * j] - hull[2 * i];
        double ey = hull[2 * j + 1] - hull[2 * i + 1];
        double len = std::sqrt(ex * ex + ey * ey);
        if (len == 0) continue;
        double ux = ex / len, uy = ey / len;
        double ox = -uy, oy = ux;

        double min_p = std::numeric_limits<double>::infinity(), max_p = -min_p;
        double min_o = min_p, max_o = -min_p;
        for (int64_t q = 0; q < h; ++q) {
            double px = hull[2 * q], py = hull[2 * q + 1];
            double pp = ux * px + uy * py;
            double po = ox * px + oy * py;
            min_p = std::min(min_p, pp); max_p = std::max(max_p, pp);
            min_o = std::min(min_o, po); max_o = std::max(max_o, po);
        }
        double area = (max_p - min_p) * (max_o - min_o);
        if (area < best_area) {
            best_area = area;
            bu[0] = ux; bu[1] = uy; bo[0] = ox; bo[1] = oy;
            bmin_p = min_p; blen_p = max_p - min_p;
            bmin_o = min_o; blen_o = max_o - min_o;
        }
    }

    double cp = bmin_p + blen_p / 2, co = bmin_o + blen_o / 2;
    double cx = bu[0] * cp + bo[0] * co;
    double cy = bu[1] * cp + bo[1] * co;
    double hpx = bu[0] * blen_p / 2, hpy = bu[1] * blen_p / 2;
    double hox = bo[0] * blen_o / 2, hoy = bo[1] * blen_o / 2;

    out_corners[0] = cx + hpx + hox; out_corners[1] = cy + hpy + hoy;
    out_corners[2] = cx + hpx - hox; out_corners[3] = cy + hpy - hoy;
    out_corners[4] = cx - hpx - hox; out_corners[5] = cy - hpy - hoy;
    out_corners[6] = cx - hpx + hox; out_corners[7] = cy - hpy + hoy;
    return 0;
}

// Radius graph, two-phase: count pass then fill pass (caller allocates).
// Edges (sender, receiver) for 0 < dist^2 <= r2, row-major by sender —
// matching ops.knn.radius_edges_host's (sender, receiver) sort order.
int64_t radius_edges_count(const double* pts, int64_t n, int64_t d,
                           double r2) {
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double* pi = pts + i * d;
        for (int64_t j = 0; j < n; ++j) {
            if (j == i) continue;
            const double* pj = pts + j * d;
            double s = 0.0;
            for (int64_t c = 0; c < d; ++c) {
                double diff = pi[c] - pj[c];
                s += diff * diff;
            }
            count += (s <= r2);
        }
    }
    return count;
}

void radius_edges_fill(const double* pts, int64_t n, int64_t d, double r2,
                       int64_t* out_edges) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double* pi = pts + i * d;
        for (int64_t j = 0; j < n; ++j) {
            if (j == i) continue;
            const double* pj = pts + j * d;
            double s = 0.0;
            for (int64_t c = 0; c < d; ++c) {
                double diff = pi[c] - pj[c];
                s += diff * diff;
            }
            if (s <= r2) {
                out_edges[2 * w] = i;
                out_edges[2 * w + 1] = j;
                ++w;
            }
        }
    }
}

static inline void norm2(double x, double y, double* ox, double* oy) {
    double n = std::sqrt(x * x + y * y);
    if (n == 0.0) { *ox = 0.0; *oy = 0.0; }
    else { *ox = x / n; *oy = y / n; }
}

static inline double angle_deg(double ax, double ay, double bx, double by) {
    double dot = ax * bx + ay * by;
    if (dot > 1.0) dot = 1.0;
    if (dot < -1.0) dot = -1.0;
    return std::acos(dot) * (180.0 / 3.14159265358979323846);
}

// E(2)-invariant point-pair metrics per edge, matching
// radargnn_tpu.graph.features.point_pair_features (and the reference's
// graph_constructor/features.py:6-122): zero velocities normalize to zero
// (-> 90 deg angles), clamped dots. out: (e, 4) rows
// (distance, angle(v1,v2), theta_d_v_min, theta_d_v_max) in degrees.
void point_pair_features_2d(const double* pos, const double* vel,
                            const int64_t* edges, int64_t e, int directed,
                            double* out) {
    for (int64_t i = 0; i < e; ++i) {
        const int64_t s = edges[2 * i], r = edges[2 * i + 1];
        const double p1x = pos[2 * s], p1y = pos[2 * s + 1];
        const double p2x = pos[2 * r], p2y = pos[2 * r + 1];
        double v1x, v1y, v2x, v2y;
        norm2(vel[2 * s], vel[2 * s + 1], &v1x, &v1y);
        norm2(vel[2 * r], vel[2 * r + 1], &v2x, &v2y);
        const double dx = p1x - p2x, dy = p1y - p2y;
        out[4 * i] = std::sqrt(dx * dx + dy * dy);
        out[4 * i + 1] = angle_deg(v1x, v1y, v2x, v2y);
        double d2x, d2y;                       // normalized p2 - p1
        norm2(-dx, -dy, &d2x, &d2y);
        if (directed) {
            out[4 * i + 2] = angle_deg(v1x, v1y, d2x, d2y);
            out[4 * i + 3] = angle_deg(v2x, v2y, d2x, d2y);
        } else {
            const double d1x = -d2x, d1y = -d2y;
            const double t1 = std::min(angle_deg(v1x, v1y, d1x, d1y),
                                       angle_deg(v1x, v1y, d2x, d2y));
            const double t2 = std::min(angle_deg(v2x, v2y, d1x, d1y),
                                       angle_deg(v2x, v2y, d2x, d2y));
            out[4 * i + 2] = std::min(t1, t2);
            out[4 * i + 3] = std::max(t1, t2);
        }
    }
}

}  // extern "C"
