// Native SBVH builder: binned object SAH + spatial splits.
//
// TPU-native framework's counterpart of the reference's CPU SBVH builder
// (Engine/SpatialStructures/BVH/SplitBVHBuilder.cpp — Stich et al. 2009,
// "Spatial Splits in Bounding Volume Hierarchies"). Implements both split
// kinds from the paper: binned object SAH over centroid bins, and spatial
// (chopped-binning) splits with triangle-box clipping and reference
// duplication, gated by the overlap-area criterion (alpha * root area).
// Written from the paper's algorithm, not the reference's code.
//
// Emits exactly the flat layout accel/bvh.py defines:
//   nodes: (M, 16) float32 — [c0.min, c0.max, c1.min, c1.max,
//                             bitcast(int32 c0_code), bitcast(int32 c1_code), pad, pad]
//   child code >= 0: inner node index; < 0: leaf, first = -(code+1),
//   every leaf holds exactly LEAF_SIZE triangles (padded by duplication).
//
// Built as a plain shared object, loaded via ctypes (no pybind11 in the image).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3() : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return Vec3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return Vec3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
    Vec3 lo{1e30f, 1e30f, 1e30f};
    Vec3 hi{-1e30f, -1e30f, -1e30f};
    void grow(const AABB& o) { lo = vmin(lo, o.lo); hi = vmax(hi, o.hi); }
    void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    bool valid() const { return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z; }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
    Vec3 centroid() const {
        return Vec3(0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z));
    }
    AABB intersect(const AABB& o) const {
        AABB r;
        r.lo = vmax(lo, o.lo);
        r.hi = vmin(hi, o.hi);
        return r;
    }
};

// a "reference": triangle id + (possibly clipped) bounding box
struct Ref {
    int tid;
    AABB box;
};

struct Builder {
    const float* tris;  // (T, 9)
    int T;
    int leaf_size;
    int n_bins;
    int max_depth;
    bool spatial;
    float alpha;            // spatial-split gate: overlap > alpha * root area
    float root_area = 0.f;
    size_t max_refs = 0;    // duplication cap
    size_t live_refs = 0;

    std::vector<float> nodes;   // flat (M, 16)
    std::vector<int> order;     // padded leaf-order triangle ids

    Vec3 vert(int tid, int v) const {
        return Vec3(tris[tid * 9 + v * 3], tris[tid * 9 + v * 3 + 1],
                    tris[tid * 9 + v * 3 + 2]);
    }

    int make_leaf(const std::vector<Ref>& refs) {
        int first = (int)order.size();
        for (const Ref& r : refs) order.push_back(r.tid);
        for (int i = (int)refs.size(); i < leaf_size; ++i)
            order.push_back(refs[0].tid);
        return -(first + 1);
    }

    int emit_node() {
        int idx = (int)nodes.size() / 16;
        nodes.resize(nodes.size() + 16, 0.f);
        return idx;
    }

    void write_node(int idx, const AABB& l, const AABB& r, int c0, int c1) {
        float* n = &nodes[idx * 16];
        n[0] = l.lo.x; n[1] = l.lo.y; n[2] = l.lo.z;
        n[3] = l.hi.x; n[4] = l.hi.y; n[5] = l.hi.z;
        n[6] = r.lo.x; n[7] = r.lo.y; n[8] = r.lo.z;
        n[9] = r.hi.x; n[10] = r.hi.y; n[11] = r.hi.z;
        std::memcpy(&n[12], &c0, 4);
        std::memcpy(&n[13], &c1, 4);
    }

    static AABB refs_box(const std::vector<Ref>& refs) {
        AABB b;
        for (const Ref& r : refs) b.grow(r.box);
        return b;
    }

    // balanced subtree of leaf chunks for unsplittable ranges
    int leaf_subtree(std::vector<Ref>& refs) {
        int count = (int)refs.size();
        if (count <= leaf_size) return make_leaf(refs);
        int half = (count / (2 * leaf_size)) * leaf_size;
        if (half == 0) half = leaf_size;
        std::vector<Ref> l(refs.begin(), refs.begin() + half);
        std::vector<Ref> r(refs.begin() + half, refs.end());
        refs.clear();
        refs.shrink_to_fit();
        int idx = emit_node();
        AABB lb = refs_box(l), rb = refs_box(r);
        int c0 = leaf_subtree(l);
        int c1 = leaf_subtree(r);
        write_node(idx, lb, rb, c0, c1);
        return idx;
    }

    // clip the triangle (already restricted to ref.box) to the slab
    // [plane_lo, plane_hi] along `axis`; returns the clipped polygon's AABB
    // intersected with ref.box
    AABB clip_ref(const Ref& ref, int axis, float plane_lo, float plane_hi) const {
        Vec3 poly[9];
        int n = 3;
        for (int v = 0; v < 3; ++v) poly[v] = vert(ref.tid, v);
        Vec3 tmp[9];
        // clip against c >= plane_lo, then c <= plane_hi
        for (int pass = 0; pass < 2; ++pass) {
            float plane = pass == 0 ? plane_lo : plane_hi;
            float sign = pass == 0 ? 1.f : -1.f;
            int m = 0;
            for (int i = 0; i < n; ++i) {
                const Vec3& a = poly[i];
                const Vec3& b = poly[(i + 1) % n];
                float da = sign * (a[axis] - plane);
                float db = sign * (b[axis] - plane);
                if (da >= 0) tmp[m++] = a;
                if ((da >= 0) != (db >= 0)) {
                    float t = da / (da - db);
                    tmp[m++] = Vec3(a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                                    a.z + t * (b.z - a.z));
                }
            }
            n = m;
            std::memcpy(poly, tmp, sizeof(Vec3) * n);
            if (n == 0) break;
        }
        AABB b;
        for (int i = 0; i < n; ++i) b.grow(poly[i]);
        return b.intersect(ref.box);
    }

    int build(std::vector<Ref>& refs, int depth) {
        int count = (int)refs.size();
        if (count <= leaf_size || depth >= max_depth) return leaf_subtree(refs);

        AABB node_box = refs_box(refs);

        // ---------- object split (binned SAH over centroids) ----------
        AABB cb;
        for (const Ref& r : refs) cb.grow(r.box.centroid());
        float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
        int o_axis = 0;
        if (ext[1] > ext[0]) o_axis = 1;
        if (ext[2] > ext[o_axis]) o_axis = 2;

        float obj_cost = 1e30f;
        int obj_bin = -1;
        AABB obj_l, obj_r;
        float cb_lo = 0.f, obj_scale = 0.f;
        if (ext[o_axis] >= 1e-12f) {
            cb_lo = cb.lo[o_axis];
            obj_scale = n_bins * (1.0f - 1e-6f) / ext[o_axis];
            std::vector<AABB> bin_box(n_bins);
            std::vector<int> bin_n(n_bins, 0);
            for (const Ref& r : refs) {
                int b = (int)((r.box.centroid()[o_axis] - cb_lo) * obj_scale);
                b = std::min(std::max(b, 0), n_bins - 1);
                bin_box[b].grow(r.box);
                bin_n[b]++;
            }
            std::vector<float> r_area(n_bins + 1, 0.f);
            std::vector<AABB> r_box(n_bins + 1);
            std::vector<int> r_cnt(n_bins + 1, 0);
            AABB acc;
            for (int b = n_bins - 1; b >= 0; --b) {
                if (bin_n[b]) acc.grow(bin_box[b]);
                r_box[b] = acc;
                r_area[b] = acc.valid() ? acc.area() : 0.f;
                r_cnt[b] = r_cnt[b + 1] + bin_n[b];
            }
            AABB lacc;
            int lcnt = 0;
            for (int b = 0; b < n_bins - 1; ++b) {
                if (bin_n[b]) lacc.grow(bin_box[b]);
                lcnt += bin_n[b];
                if (lcnt == 0 || r_cnt[b + 1] == 0) continue;
                float cost = lacc.area() * lcnt + r_area[b + 1] * r_cnt[b + 1];
                if (cost < obj_cost) {
                    obj_cost = cost;
                    obj_bin = b;
                    obj_l = lacc;
                    obj_r = r_box[b + 1];
                }
            }
        }

        // ---------- spatial split (chopped binning, Stich et al. §4) ----------
        // gated on child overlap vs root area and on the duplication budget
        float spat_cost = 1e30f;
        int spat_bin = -1;
        int s_axis = 0;
        float s_lo = 0.f, s_step = 0.f;
        bool try_spatial = spatial && obj_bin >= 0 && live_refs < max_refs;
        if (try_spatial) {
            AABB ov = obj_l.intersect(obj_r);
            try_spatial = ov.valid() && ov.area() > alpha * root_area;
        }
        if (try_spatial) {
            // chop along the widest node-box axis
            float next[3] = {node_box.hi.x - node_box.lo.x,
                             node_box.hi.y - node_box.lo.y,
                             node_box.hi.z - node_box.lo.z};
            s_axis = 0;
            if (next[1] > next[0]) s_axis = 1;
            if (next[2] > next[s_axis]) s_axis = 2;
            if (next[s_axis] >= 1e-12f) {
                s_lo = node_box.lo[s_axis];
                s_step = next[s_axis] / n_bins;
                std::vector<AABB> bbox(n_bins);
                std::vector<int> entry(n_bins, 0), exit_(n_bins, 0);
                for (const Ref& r : refs) {
                    int b0 = (int)((r.box.lo[s_axis] - s_lo) / s_step);
                    int b1 = (int)((r.box.hi[s_axis] - s_lo) / s_step);
                    b0 = std::min(std::max(b0, 0), n_bins - 1);
                    b1 = std::min(std::max(b1, 0), n_bins - 1);
                    if (b0 == b1) {
                        bbox[b0].grow(r.box);
                    } else {
                        for (int b = b0; b <= b1; ++b) {
                            AABB cb2 = clip_ref(r, s_axis, s_lo + b * s_step,
                                                s_lo + (b + 1) * s_step);
                            if (cb2.valid()) bbox[b].grow(cb2);
                        }
                    }
                    entry[b0]++;
                    exit_[b1]++;
                }
                std::vector<float> r_area(n_bins + 1, 0.f);
                std::vector<int> r_exit(n_bins + 1, 0);
                AABB acc;
                for (int b = n_bins - 1; b >= 0; --b) {
                    acc.grow(bbox[b]);
                    r_area[b] = acc.valid() ? acc.area() : 0.f;
                    r_exit[b] = r_exit[b + 1] + exit_[b];
                }
                AABB lacc;
                int lent = 0;
                for (int b = 0; b < n_bins - 1; ++b) {
                    lacc.grow(bbox[b]);
                    lent += entry[b];
                    int rcnt = r_exit[b + 1];
                    if (lent == 0 || rcnt == 0) continue;
                    float cost = (lacc.valid() ? lacc.area() : 0.f) * lent +
                                 r_area[b + 1] * rcnt;
                    if (cost < spat_cost) {
                        spat_cost = cost;
                        spat_bin = b;
                    }
                }
            }
        }

        std::vector<Ref> left, right;
        left.reserve(count / 2 + 8);
        right.reserve(count / 2 + 8);

        if (spat_bin >= 0 && spat_cost < obj_cost) {
            // perform the spatial split: duplicate straddling references
            float plane = s_lo + (spat_bin + 1) * s_step;
            for (const Ref& r : refs) {
                if (r.box.hi[s_axis] <= plane) {
                    left.push_back(r);
                } else if (r.box.lo[s_axis] >= plane) {
                    right.push_back(r);
                } else {
                    Ref rl = r, rr = r;
                    rl.box = clip_ref(r, s_axis, node_box.lo[s_axis], plane);
                    rr.box = clip_ref(r, s_axis, plane, node_box.hi[s_axis]);
                    if (rl.box.valid()) left.push_back(rl);
                    if (rr.box.valid()) right.push_back(rr);
                    if (rl.box.valid() && rr.box.valid()) live_refs++;
                }
            }
        } else if (obj_bin >= 0) {
            for (const Ref& r : refs) {
                int b = (int)((r.box.centroid()[o_axis] - cb_lo) * obj_scale);
                b = std::min(std::max(b, 0), n_bins - 1);
                (b <= obj_bin ? left : right).push_back(r);
            }
        }

        if (left.empty() || right.empty()) {
            // degenerate: median split on the object axis
            left.clear();
            right.clear();
            std::vector<Ref> sorted = refs;
            int mid = count / 2;
            std::nth_element(sorted.begin(), sorted.begin() + mid, sorted.end(),
                             [&](const Ref& a, const Ref& b) {
                                 return a.box.centroid()[o_axis] <
                                        b.box.centroid()[o_axis];
                             });
            left.assign(sorted.begin(), sorted.begin() + mid);
            right.assign(sorted.begin() + mid, sorted.end());
            if (left.empty() || right.empty()) return leaf_subtree(refs);
        }

        refs.clear();
        refs.shrink_to_fit();

        int idx = emit_node();
        AABB lb = refs_box(left), rb = refs_box(right);
        int c0 = build(left, depth + 1);
        int c1 = build(right, depth + 1);
        write_node(idx, lb, rb, c0, c1);
        return idx;
    }
};

}  // namespace

extern "C" {

// Returns root code; fills caller-queried buffers via the getters below.
// Workflow: bvh_build() -> bvh_n_nodes()/bvh_n_order() -> bvh_copy() -> bvh_release().
static thread_local Builder* g_builder = nullptr;
static thread_local int g_root = 0;

int bvh_build_ex(const float* tris, int T, int leaf_size, int n_bins,
                 int max_depth, int spatial, float alpha) {
    if (g_builder) { delete g_builder; g_builder = nullptr; }
    g_builder = new Builder();
    Builder& B = *g_builder;
    B.tris = tris;
    B.T = T;
    B.leaf_size = leaf_size;
    B.n_bins = n_bins;
    B.max_depth = max_depth;
    B.spatial = spatial != 0;
    B.alpha = alpha;
    B.max_refs = (size_t)T + (size_t)(0.5 * T) + 64;  // duplication budget ~1.5x
    B.live_refs = T;

    std::vector<Ref> refs(T);
    AABB root_box;
    for (int t = 0; t < T; ++t) {
        AABB b;
        for (int v = 0; v < 3; ++v) b.grow(B.vert(t, v));
        refs[t].tid = t;
        refs[t].box = b;
        root_box.grow(b);
    }
    B.root_area = root_box.area();
    B.nodes.reserve((size_t)T * 8);
    B.order.reserve((size_t)T * 2);
    g_root = B.build(refs, 0);
    if (B.nodes.empty()) {
        // single-leaf scene: wrap in a dummy inner node
        int idx = B.emit_node();
        B.write_node(idx, root_box, root_box, g_root, -(1000000000 + 1));
        g_root = idx;
    }
    return g_root;
}

int bvh_build(const float* tris, int T, int leaf_size, int n_bins, int max_depth) {
    return bvh_build_ex(tris, T, leaf_size, n_bins, max_depth, /*spatial=*/1,
                        /*alpha=*/1e-5f);
}

int bvh_n_nodes() { return g_builder ? (int)(g_builder->nodes.size() / 16) : 0; }
int bvh_n_order() { return g_builder ? (int)g_builder->order.size() : 0; }

void bvh_copy(float* nodes_out, int* order_out) {
    if (!g_builder) return;
    std::memcpy(nodes_out, g_builder->nodes.data(), g_builder->nodes.size() * sizeof(float));
    std::memcpy(order_out, g_builder->order.data(), g_builder->order.size() * sizeof(int));
}

void bvh_release() {
    delete g_builder;
    g_builder = nullptr;
}

}  // extern "C"
