// Native host-side geometry kit.
//
// The reference's heavy lifting outside the GPU kernels is host
// marshaling and acceleration-structure construction (reference:
// chroma/gpu/geometry.py, chroma/bvh/). The device side of this framework
// is JAX/XLA; this library is the native runtime piece for the host-side
// hot spots that numpy handles poorly at tens of millions of triangles:
//
//   * vertex deduplication (hash map instead of numpy's sort-based unique)
//   * Morton coding of triangle centroids (chroma/cuda/bvh.cu:42-62 coding)
//   * index argsort of 64-bit Morton keys
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).
// Build: make -C csrc  (or chroma_tpu.native builds it on demand).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct VertexKey {
    uint32_t bits[3];
    bool operator==(const VertexKey &o) const {
        return bits[0] == o.bits[0] && bits[1] == o.bits[1] &&
               bits[2] == o.bits[2];
    }
};

struct VertexKeyHash {
    size_t operator()(const VertexKey &k) const {
        // 64-bit FNV-1a over the 12 key bytes
        uint64_t h = 1469598103934665603ull;
        const unsigned char *p =
            reinterpret_cast<const unsigned char *>(k.bits);
        for (int i = 0; i < 12; ++i) {
            h ^= p[i];
            h *= 1099511628211ull;
        }
        return static_cast<size_t>(h);
    }
};

inline uint64_t spread3_16(uint64_t x) {
    // occupy every third bit with the low 16 bits
    // (same method as chroma/cuda/bvh.cu:42-52)
    x = (x | (x << 16)) & 0x00000000FF0000FFull;
    x = (x | (x << 8)) & 0x000000F00F00F00Full;
    x = (x | (x << 4)) & 0x00000C30C30C30C3ull;
    x = (x | (x << 2)) & 0x0000249249249249ull;
    return x;
}

}  // namespace

extern "C" {

// Deduplicate float32 (n,3) vertices exactly (bit-pattern equality, like
// numpy unique on rows). Writes the unique vertices into unique_out
// (capacity n*3) and the per-input unique index into inverse (n).
// Returns the unique count.
int64_t chroma_dedupe_vertices(const float *verts, int64_t n,
                               int64_t *inverse, float *unique_out) {
    std::unordered_map<VertexKey, int64_t, VertexKeyHash> seen;
    seen.reserve(static_cast<size_t>(n));
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        VertexKey key;
        std::memcpy(key.bits, verts + 3 * i, 12);
        auto it = seen.find(key);
        if (it == seen.end()) {
            seen.emplace(key, count);
            std::memcpy(unique_out + 3 * count, verts + 3 * i, 12);
            inverse[i] = count;
            ++count;
        } else {
            inverse[i] = it->second;
        }
    }
    return count;
}

// 48-bit Morton codes of triangle centroids. tri_verts: (n, 9) float32
// (three vertices per triangle); origin: 3 floats; scale: fixed-point
// step. Matches the quantization of the reference leaf builder
// (chroma/cuda/bvh.cu:148-203).
void chroma_morton_codes(const float *tri_verts, int64_t n,
                         const float *origin, float scale,
                         uint64_t *codes) {
    const float inv = 1.0f / scale;
    for (int64_t i = 0; i < n; ++i) {
        const float *t = tri_verts + 9 * i;
        uint64_t q[3];
        for (int a = 0; a < 3; ++a) {
            float c = (t[a] + t[3 + a] + t[6 + a]) / 3.0f;
            float f = (c - origin[a]) * inv;
            q[a] = f <= 0.0f ? 0u : static_cast<uint64_t>(f);
        }
        codes[i] = spread3_16(q[0]) | (spread3_16(q[1]) << 1) |
                   (spread3_16(q[2]) << 2);
    }
}

// argsort of uint64 keys -> int64 order (stable).
void chroma_argsort_u64(const uint64_t *keys, int64_t n, int64_t *order) {
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order, order + n, [keys](int64_t a, int64_t b) {
        return keys[a] < keys[b];
    });
}

// Per-group AABB reduction: for groups defined by first[g] (sorted,
// counts implied by the next start), reduce (n,3) lo/hi child bounds
// into (ngroups,3) group bounds.
void chroma_group_bounds(const float *child_lo, const float *child_hi,
                         int64_t n, const int64_t *first, int64_t ngroups,
                         float *group_lo, float *group_hi) {
    for (int64_t g = 0; g < ngroups; ++g) {
        int64_t start = first[g];
        int64_t end = (g + 1 < ngroups) ? first[g + 1] : n;
        float lo[3] = {child_lo[3 * start], child_lo[3 * start + 1],
                       child_lo[3 * start + 2]};
        float hi[3] = {child_hi[3 * start], child_hi[3 * start + 1],
                       child_hi[3 * start + 2]};
        for (int64_t i = start + 1; i < end; ++i) {
            for (int a = 0; a < 3; ++a) {
                lo[a] = std::min(lo[a], child_lo[3 * i + a]);
                hi[a] = std::max(hi[a], child_hi[3 * i + a]);
            }
        }
        for (int a = 0; a < 3; ++a) {
            group_lo[3 * g + a] = lo[a];
            group_hi[3 * g + a] = hi[a];
        }
    }
}

// Optimal BVH2 -> wide-fanout collapse DP (Ylitie-style): minimize the
// sum of wide-node areas (= the expected-internal-visit proxy: a node
// is visited with probability proportional to its box area). For every
// binary node v and forest size i in 1..F:
//   FORcost[v][i] = min cost of representing v's subtree as a forest of
//                   <= i roots (roots become children of an ancestor
//                   wide node); leaves cost 0 (leaf-row visits are
//                   collapse-invariant).
//   jch[v][i]     = 0 -> keep v whole (one root);
//                   j -> split into forests of (j, i-j) over (l, r).
// Requires children allocated AFTER their parent (true of the builder's
// parent-first allocation), so one reverse sweep is child-first.
void chroma_collapse_dp(const int64_t *left, const int64_t *right,
                        const double *area, int64_t n, int64_t F,
                        double *forcost, uint8_t *jch) {
    const int64_t S = F + 1;
    std::vector<double> conv(S);
    std::vector<uint8_t> js(S);
    for (int64_t v = n - 1; v >= 0; --v) {
        double *fv = forcost + v * S;
        uint8_t *jv = jch + v * S;
        if (left[v] < 0) {
            for (int64_t i = 0; i <= F; ++i) { fv[i] = 0.0; jv[i] = 0; }
            continue;
        }
        const double *fl = forcost + left[v] * S;
        const double *fr = forcost + right[v] * S;
        for (int64_t i = 2; i <= F; ++i) {
            double best = 1e300;
            uint8_t bj = 1;
            for (int64_t j = 1; j < i; ++j) {
                double c = fl[j] + fr[i - j];
                if (c < best) { best = c; bj = (uint8_t)j; }
            }
            conv[i] = best;
            js[i] = bj;
        }
        const double Cv = area[v] + (F >= 2 ? conv[F] : 1e300);
        fv[0] = 1e300;
        fv[1] = Cv;
        jv[1] = 0;
        for (int64_t i = 2; i <= F; ++i) {
            if (conv[i] < Cv) { fv[i] = conv[i]; jv[i] = js[i]; }
            else { fv[i] = Cv; jv[i] = 0; }
        }
    }
}

}  // extern "C"
