// Instanced wide-BVH traversal for NVIDIA Hopper (sm_90a): one warp (or a
// half-warp) walks one ray, one lane per child, the whole walk in one launch.
//
// Replaces the TPU kernel chroma_tpu/ops/visit_kernel.py::_visit_kernel_inst
// (:109-368; launched once per visit through visit_inst's pallas_call, with
// the row gather left to XLA because Mosaic has no per-lane gather). The
// contract is that of the plain PyTorch traversal
// chroma_tpu_torch/ops/mesh_wide.py::traverse, bit for bit: no implicit FMA
// contraction (built with --fmad=false) but explicit fmaf exactly where the
// plain version fuses (the instance rotation, the triangle test and its
// normal: cross_term, dot3), IEEE division, NaN-propagating min/max, the
// plain version's summation order and first-minimum ties.
//
// What bounds it. A query of N rays reads each row it visits once (R' of
// the table's R rows of W f32 words; they then stay in the 50 MB L2), 24
// bytes of ray per ray (plus 4 of
// last_hit, 1 of mask and 4 of best_limit where given) and writes 32 bytes
// per ray (tri, dist, code, normal, iid, visits). In f32 operations, a visit
// costs: a sweep of an internal or instance row 12 (1/d, -o/d) plus 25 for
// each of the F children (two slab planes 12, min/max 6, their reduction 5,
// two comparisons; q8: 21 plus 32 a child, which adds the byte-to-float
// conversions and the empty-slot test); an instance entry 33 more (the
// rotation into the instance frame); a leaf 55 for each of its K triangle
// slots (Moller-Trumbore with its tests). With V_int, V_inst, V_leaf the
// visits of each kind:
//   bytes = 4 R' W + N (24 + 32 [+ 9])
//   ops   = V_int S + V_inst (33 + S) + V_leaf 55 K,  S = 12 + 25 F
//   bound = max(bytes / 3.35 TB/s, ops / 67 TFLOP/s f32)
// The quick demo detector (bf16 bounds, F 32, K 8) at 2^20 rays is bound by
// the operations, ~0.1 ms; memory is ~20 us.
//
// What the design does about it:
// * Requests. The first design of this kernel gave each thread a ray and
//   looped over the 32 children: six 4-byte loads a child from the
//   thread's own row, so every load of a warp touched up to 32 cache
//   lines. Here lane c reads child c's six bound words: neighbouring lanes
//   read neighbouring words, six coalesced requests a row (bf16 packs two
//   children a word, so lanes c and c + 16 share theirs); leaf lane k
//   reads triangle k. Row header
//   words (tag, rotation, first child) are one broadcast load each.
// * Divergence. A group of lanes holds one ray, so every branch (node kind,
//   descend or pop, the end of the walk) is uniform across the group; the
//   only divergence left is between the two rays of a 16-lane launch.
// * The reductions reproduce the sequential order: the nearest child is the
//   lowest c among the hit children of least tmin, the leaf's winner the
//   lowest k among the valid triangles of least t. tmin and t of a hit are
//   never negative or NaN (tmin = max(..., max(smz, 0)); t > 1e-6), so with
//   the sign bit of a zero cleared their bit patterns order like the floats,
//   and one __reduce_min_sync plus a ballot finds the first minimum.
// * The stack lives in lanes: lane d holds level d's (base, pending mask)
//   in two registers (so depth <= group width). A pop is one ballot of the
//   non-empty levels below the depth, the highest set bit, and two
//   shuffles -- no stack array in local memory, no scan.
// * Two rays a warp: a group is 16 lanes where the table's depth and leaf
//   size fit (the demo tables: depth 8-10, leaf 8), and a fanout-32 row
//   gives each lane children c and c + 16 -- in bf16 the two halves of the
//   word it loads anyway. The ray's uniform work (tag, frame, stack) is
//   then shared by two rays' worth of lanes.
// * Occupancy at any N: one group per ray, so 10^4 rays make 5,000 warps
//   (~38 a SM) where one thread per ray made 79 blocks of 128 threads.
//   Persistent groups (a grid that fills the card, groups taking the next
//   ray from a global counter the wrapper zeroes) win at large N, the plain
//   grid at small N; the wrapper picks by N (chip_smoke.py phase 4 times
//   both at the sizes a bomb's compacted steps launch).
// * The frame's 1/d and -o/d are kept with the frame and recomputed only on
//   entering or leaving an instance, not on every visit.
// What still holds it back (PERF.md, measured by chip_smoke.py phase 4):
// about 5% of the operation bound at 2^20 rays -- a dependent row load
// every visit, and far more issued instructions (unpacking, ballots,
// shuffles, the stack, spills) than the counted f32 operations.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libvisit_kernel.so
//        visit_kernel.cu
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TAG_INTERNAL = 0;
constexpr int TAG_LEAF = 1;
constexpr int TAG_INSTANCE = 2;
constexpr int INST_B0 = 14;
constexpr int LEAF_STRIDE = 11;
constexpr int IBIG = 127;
constexpr int BLOCK = 128;
constexpr uint32_t INF_BITS = 0x7f800000u;

constexpr int FMT_F32 = 0;
constexpr int FMT_BF16 = 1;
constexpr int FMT_Q8 = 2;

// the constants as the plain version rounds them: Python doubles cast to f32
constexpr float EPS = (float)1e-6;
constexpr float NEG_EPS = (float)(-1e-6);
constexpr float ONE_EPS = (float)(1.0 + 1e-6);
constexpr float FLT_EPS = (float)1.19209290e-07;
constexpr float NUDGE = (float)1e-25;

__device__ __forceinline__ int as_int(float x) { return __float_as_int(x); }

// a*b - c*d and a*b + c*d + e*f rounded as the plain version rounds them
// (ops/mesh_wide.py _cross_term, _dot3), which is how XLA's CPU code
// contracts them
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return fmaf(a, b, -(c * d));
}

__device__ __forceinline__ float dot3(float a, float b, float c, float d,
                                      float e, float f) {
    return fmaf(e, f, fmaf(a, b, c * d));
}

// torch.minimum / torch.maximum semantics in one instruction each (sm_80+):
// a NaN operand gives NaN (fminf and fmaxf would drop it, and padding
// children would then hit). On zeros of opposite sign, which compare equal,
// they may return either; the walk uses tmin's bits only with the sign bit
// cleared
__device__ __forceinline__ float pmin(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float pmax(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// ---------------------------------------------------------------------------
// The warp-cooperative walk
// ---------------------------------------------------------------------------

struct Query {
    const float* rows;
    int width, leaf_size, depth_max, fc_col;
    const float* origin;
    const float* direction;
    const int* last_hit;
    const uint8_t* mask;
    const float* best_limit;
    int n;
    int* out_tri;
    float* out_dist;
    int* out_code;
    float* out_normal;
    int* out_iid;
    int* out_visits;
    int by_kind;
};

// the group's lanes of a warp-wide ballot, as bits 0..G-1
template <int G>
__device__ __forceinline__ uint32_t group_ballot(unsigned gm, int shift,
                                                 bool pred) {
    const uint32_t b = __ballot_sync(gm, pred) >> shift;
    return G == 32 ? b : (b & 0xFFFFu);
}

// lowest group lane holding the least key (keys are f32 bit patterns of
// non-negative floats or INF_BITS); every lane gets (least key, lane)
template <int G>
__device__ __forceinline__ int first_min(unsigned gm, int shift,
                                         uint32_t key, uint32_t* least) {
    const uint32_t m = __reduce_min_sync(gm, key);
    *least = m;
    return __ffs((int)group_ballot<G>(gm, shift, key == m)) - 1;
}

// 1/d with exactly-zero components nudged to 1e-25, and -o/d, of a frame
__device__ __forceinline__ void slab_frame(const float o[3], const float d[3],
                                           float inv[3], float neg[3]) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        inv[j] = 1.0f / (d[j] == 0.0f ? NUDGE : d[j]);
        neg[j] = -o[j] * inv[j];
    }
}

// column of child c's bound word g (lo xyz, hi xyz) in an internal or
// instance row, and the bound decoded from that word
template <int FMT, int F>
__device__ __forceinline__ int bound_col(int g, int c) {
    return FMT == FMT_Q8 ? INST_B0 + 6 + g * (F / 4) + (c >> 2)
         : FMT == FMT_BF16 ? INST_B0 + g * (F / 2) + c % (F / 2)
         : INST_B0 + g * F + c;
}

template <int FMT, int F>
__device__ __forceinline__ float bound_of(uint32_t word, int c) {
    if (FMT == FMT_Q8) return (float)((word >> ((c & 3) * 8)) & 0xFFu);
    if (FMT == FMT_BF16)   // child c < F/2 in the low half of its word
        return __uint_as_float(c < F / 2 ? (word << 16)
                                         : (word & 0xFFFF0000u));
    return __uint_as_float(word);
}

// Slab test of one child from its six words: whether it is hit, and its
// reduction key (tmin's bits with a zero's sign cleared; INF_BITS when it is
// not hit -- a hit at tmin = +inf has the same key). si / sn: the frame's
// 1/d and -o/d; qa: a q8 row's anchor and scale.
template <int FMT, int F>
__device__ __forceinline__ bool slab_hit(const uint32_t w[6], int c, bool ok,
                                         const float si[3], const float sn[3],
                                         const float qa[6], float b_d,
                                         uint32_t* key) {
    float b[6];
#pragma unroll
    for (int g = 0; g < 6; ++g) b[g] = bound_of<FMT, F>(w[g], c);
    float t0[3], t1[3];
    if (FMT == FMT_Q8) {
        ok = ok && b[0] <= b[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float q_s = qa[3 + j] * si[j];
            const float q_a = qa[j] * si[j] + sn[j];
            t0[j] = b[j] * q_s + q_a;
            t1[j] = b[3 + j] * q_s + q_a;
        }
    } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            t0[j] = b[j] * si[j] + sn[j];
            t1[j] = b[3 + j] * si[j] + sn[j];
        }
    }
    const float smx = pmin(t0[0], t1[0]);
    const float bgx = pmax(t0[0], t1[0]);
    const float smy = pmin(t0[1], t1[1]);
    const float bgy = pmax(t0[1], t1[1]);
    const float smz = pmin(t0[2], t1[2]);
    const float bgz = pmax(t0[2], t1[2]);
    const float tmin = pmax(pmax(smx, smy), pmax(smz, 0.0f));
    const float tmax = pmin(pmin(bgx, bgy), bgz);
    const bool hit = ok && (tmin <= tmax) && (tmin <= b_d);
    *key = hit ? __float_as_uint(tmin) & 0x7FFFFFFFu : INF_BITS;
    return hit;
}

// Walk ray i with the G lanes of one group (gl = lane in the group, gm =
// the group's lanes in the warp, shift = its first lane). Every register but
// the child / triangle values and the stack slot is the same in all lanes.
// The frame's 1/d and -o/d are kept with the frame (loc) and recomputed
// only when it changes; the world ray is reloaded (a broadcast L1 hit) where
// an instance row or leaving an instance needs it.
template <int FMT, int F, int G>
__device__ __forceinline__ void walk_ray(const Query& q, int i, int gl,
                                         unsigned gm, int shift) {
    const float* w_o = q.origin + 3 * i;
    const float* w_d = q.direction + 3 * i;
    float loc[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        loc[j] = w_o[j];
        loc[3 + j] = w_d[j];
    }
    float inv[3], neg[3];
    slab_frame(loc, loc + 3, inv, neg);

    const int excl = q.last_hit ? q.last_hit[i] : -1;
    int cur = (q.mask == nullptr || q.mask[i]) ? 0 : -1;
    int depth = 0;
    int d_inst = IBIG;
    int tbase = 0;
    int iid = 0;
    int b_tri = -1;
    float b_d = q.best_limit ? q.best_limit[i] : __int_as_float(0x7f800000);
    int b_code = 0;
    float b_n[3] = {0.0f, 0.0f, 0.0f};
    int b_iid = 0;
    int kinds[3] = {0, 0, 0};
    // this lane's stack level: (first child, pending-children mask)
    int s_base = 0;
    uint32_t s_mask = 0u;

    // lane gl tests child gl and, when the fanout is twice the group
    // (F 32 on 16 lanes), child gl + G too; lanes past the fanout read child
    // 0 and report no hit
    constexpr int CPL = F > G ? 2 : 1;
    const int c0 = gl < F ? gl : 0;
    const int c1 = gl + G;

    while (cur >= 0) {
        const float* row = q.rows + (size_t)cur * (size_t)q.width;
        // one round trip a visit: the tag, the first child and this lane's
        // bound words are loaded together, before the tag is known (leaf
        // rows hold triangle words there, which are then unused); bf16
        // packs children c and c + F/2 into one word
        const int tag = as_int(row[q.width - 1]);
        const int first_child = as_int(row[q.fc_col]);
        uint32_t w0[6], w1[6];
#pragma unroll
        for (int g = 0; g < 6; ++g) {
            w0[g] = (uint32_t)as_int(row[bound_col<FMT, F>(g, c0)]);
            if (CPL == 2)
                w1[g] = FMT == FMT_BF16 ? w0[g] : (uint32_t)as_int(
                    row[bound_col<FMT, F>(g, c1)]);
        }
        float qa[6];
        if (FMT == FMT_Q8) {
#pragma unroll
            for (int j = 0; j < 6; ++j) qa[j] = row[INST_B0 + j];
        }
        const bool internal = tag == TAG_INTERNAL;
        const bool at_leaf = tag == TAG_LEAF;
        const bool is_inst = tag == TAG_INSTANCE;
        kinds[0] += internal;
        kinds[1] += at_leaf;
        kinds[2] += is_inst;

        // instance entry: rotate the world ray into the instance frame
        float entered[6];
        float e_inv[3], e_neg[3];
        if (is_inst) {
            const float px = w_o[0] - row[9];
            const float py = w_o[1] - row[10];
            const float pz = w_o[2] - row[11];
            const float wdx = w_d[0], wdy = w_d[1], wdz = w_d[2];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                entered[r] = dot3(row[3 * r], px, row[3 * r + 1], py,
                                  row[3 * r + 2], pz);
                entered[3 + r] = dot3(row[3 * r], wdx, row[3 * r + 1], wdy,
                                      row[3 * r + 2], wdz);
            }
            slab_frame(entered, entered + 3, e_inv, e_neg);
        }

        const bool sweeping = internal || is_inst;
        uint32_t hitmask = 0u;
        int nearest = 0;
        if (sweeping) {
            float si[3], sn[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                si[j] = is_inst ? e_inv[j] : inv[j];
                sn[j] = is_inst ? e_neg[j] : neg[j];
            }
            uint32_t k0, k1 = INF_BITS;
            const bool hit0 = slab_hit<FMT, F>(w0, c0, gl < F, si, sn, qa,
                                               b_d, &k0);
            const bool hit1 = CPL == 2
                && slab_hit<FMT, F>(w1, c1, true, si, sn, qa, b_d, &k1);
            hitmask = group_ballot<G>(gm, shift, hit0);
            if constexpr (CPL == 2)
                hitmask |= group_ballot<G>(gm, shift, hit1) << G;
            if (hitmask != 0u) {
                // nearest-first descent; ties go to the lowest child (every
                // first child of a lane is below every second one), and a
                // sweep whose hits all have tmin = +inf takes child 0, as
                // the plain version's argmin does
                const uint32_t m = __reduce_min_sync(gm, k0 < k1 ? k0 : k1);
                const uint32_t lo = group_ballot<G>(gm, shift, k0 == m);
                nearest = lo != 0u
                    ? __ffs((int)lo) - 1
                    : __ffs((int)group_ballot<G>(gm, shift, k1 == m)) - 1 + G;
            }
        }

        if (at_leaf) {
            // lane k tests triangle slot k
            const float* o = loc;
            const float* dv = loc + 3;
            const bool slot = gl < q.leaf_size;
            const float* tr = row + LEAF_STRIDE * (slot ? gl : 0);
            const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
            const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
            const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
            const int tri = as_int(tr[9]);
            const int code = as_int(tr[10]);
            const int tri_g = tri + tbase;
            const float hx = cross_term(dv[1], e2z, dv[2], e2y);
            const float hy = cross_term(dv[2], e2x, dv[0], e2z);
            const float hz = cross_term(dv[0], e2y, dv[1], e2x);
            const float a = dot3(e1x, hx, e1y, hy, e1z, hz);
            const bool parallel = fabsf(a) <= FLT_EPS;
            const float finv = 1.0f / (parallel ? 1.0f : a);
            const float sx = o[0] - v0x, sy = o[1] - v0y, sz = o[2] - v0z;
            const float u = finv * dot3(sx, hx, sy, hy, sz, hz);
            const float qx = cross_term(sy, e1z, sz, e1y);
            const float qy = cross_term(sz, e1x, sx, e1z);
            const float qz = cross_term(sx, e1y, sy, e1x);
            const float v = finv * dot3(dv[0], qx, dv[1], qy, dv[2], qz);
            const float t = finv * dot3(e2x, qx, e2y, qy, e2z, qz);
            const bool ok = slot && !parallel && u >= NEG_EPS
                && u <= ONE_EPS && v >= NEG_EPS && u + v <= ONE_EPS
                && t > EPS && isfinite(t) && tri >= 0 && tri_g != excl;
            uint32_t least;
            const int kb = first_min<G>(gm, shift,
                                        ok ? __float_as_uint(t) : INF_BITS,
                                        &least);
            const float t_b = __uint_as_float(least);
            if (t_b < b_d) {
                const float n0 = cross_term(e1y, e2z, e1z, e2y);
                const float n1 = cross_term(e1z, e2x, e1x, e2z);
                const float n2 = cross_term(e1x, e2y, e1y, e2x);
                b_d = t_b;
                b_tri = __shfl_sync(gm, tri_g, kb, G);
                b_code = __shfl_sync(gm, code, kb, G);
                b_n[0] = __shfl_sync(gm, n0, kb, G);
                b_n[1] = __shfl_sync(gm, n1, kb, G);
                b_n[2] = __shfl_sync(gm, n2, kb, G);
                b_iid = iid;
            }
        }

        const bool will = sweeping && hitmask != 0u;
        if (will) {
            if (is_inst) {
#pragma unroll
                for (int j = 0; j < 6; ++j) loc[j] = entered[j];
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    inv[j] = e_inv[j];
                    neg[j] = e_neg[j];
                }
                d_inst = depth;
                tbase = as_int(row[12]);
                iid = as_int(row[13]);
            }
            if (depth < q.depth_max && gl == depth) {
                s_base = first_child;
                s_mask = hitmask & ~(1u << nearest);
            }
            cur = first_child + nearest;
            depth += 1;
        } else {
            // pop: the highest non-empty level below the depth, by ballot
            const int lim = depth < q.depth_max ? depth : q.depth_max;
            const uint32_t cand = group_ballot<G>(gm, shift,
                                                  s_mask != 0u && gl < lim);
            if (cand != 0u) {
                const int top = 31 - __clz((int)cand);
                const uint32_t pm = __shfl_sync(gm, s_mask, top, G);
                const int base = __shfl_sync(gm, s_base, top, G);
                if (gl == top) s_mask = pm & (pm - 1u);
                cur = base + (__ffs((int)pm) - 1);
                depth = top + 1;
            } else {
                cur = -1;
            }
        }

        // leaving the instance: restore the world-frame registers
        if (d_inst != IBIG && depth <= d_inst) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                loc[j] = w_o[j];
                loc[3 + j] = w_d[j];
            }
            slab_frame(loc, loc + 3, inv, neg);
            tbase = 0;
            d_inst = IBIG;
        }
    }

    if (gl == 0) {
        q.out_tri[i] = b_tri;
        q.out_dist[i] = b_d;
        q.out_code[i] = b_code;
#pragma unroll
        for (int j = 0; j < 3; ++j) q.out_normal[3 * i + j] = b_n[j];
        q.out_iid[i] = b_iid;
        if (q.by_kind) {
#pragma unroll
            for (int j = 0; j < 3; ++j) q.out_visits[3 * i + j] = kinds[j];
        } else {
            q.out_visits[i] = kinds[0] + kinds[1] + kinds[2];
        }
    }
}

// One group of G lanes per ray. next_ray null: a grid of one group per
// ray. Otherwise persistent groups take the next ray from *next_ray.
// 8 resident blocks of 128 threads a SM (32 warps) cap the walk at 64
// registers, at the price of some spills: the walk waits on dependent
// loads and reductions, so resident warps pay.
constexpr int WARP_MIN_BLOCKS = 8;

template <int FMT, int F, int G>
__global__ void __launch_bounds__(BLOCK, WARP_MIN_BLOCKS)
visit_warp_kernel(Query q, int* __restrict__ next_ray) {
    const int lane = threadIdx.x & 31;
    const int gl = lane & (G - 1);
    const int shift = G == 32 ? 0 : (lane & 16);
    const unsigned gm = G == 32 ? 0xFFFFFFFFu : (0xFFFFu << shift);
    constexpr int GPB = BLOCK / G;
    if (next_ray == nullptr) {
        const int i = blockIdx.x * GPB + threadIdx.x / G;
        if (i < q.n) walk_ray<FMT, F, G>(q, i, gl, gm, shift);
        return;
    }
    for (;;) {
        int i = 0;
        if (gl == 0) i = atomicAdd(next_ray, 1);
        i = __shfl_sync(gm, i, 0, G);
        if (i >= q.n) return;
        walk_ray<FMT, F, G>(q, i, gl, gm, shift);
    }
}

template <int FMT, int F, int G>
void launch_warp(const Query& q, int* next_ray, cudaStream_t stream) {
    constexpr int GPB = BLOCK / G;
    const int need = (q.n + GPB - 1) / GPB;
    int blocks = need;
    if (next_ray != nullptr) {
        // the blocks the card holds at once (one card per process)
        static int fill = 0;
        if (fill == 0) {
            int dev = 0, sms = 0, per_sm = 0;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, visit_warp_kernel<FMT, F, G>, BLOCK, 0);
            fill = sms * (per_sm > 0 ? per_sm : 1);
        }
        blocks = need < fill ? need : fill;
    }
    visit_warp_kernel<FMT, F, G><<<blocks, BLOCK, 0, stream>>>(q, next_ray);
}

}  // namespace

// Plain C entry point for ctypes: the warp-cooperative walk. fmt: 0 f32,
// 1 bf16 pairs, 2 q8; fanout 16 or 32; group: lanes per ray, 32 or 16 (two
// rays a warp; a fanout-32 row then gives each lane two children), at least
// the table's depth and leaf size. last_hit, mask and best_limit may be null.
// by_kind: out_visits is (n, 3) visits per node kind (internal, leaf,
// instance) instead of (n,). next_ray: null for a grid of one group per
// ray, else a zeroed int counter for persistent groups. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported fmt / fanout / group, or a depth or leaf size above the group).
extern "C" int chroma_visit_inst(
    const float* rows, int width, int fanout, int leaf_size, int depth_max,
    int fmt, int fc_col, const float* origin, const float* direction,
    const int* last_hit, const uint8_t* mask, const float* best_limit, int n,
    int* out_tri, float* out_dist, int* out_code, float* out_normal,
    int* out_iid, int* out_visits, int by_kind, int group, int* next_ray,
    void* stream) {
    if (group != 16 && group != 32) return (int)cudaErrorInvalidValue;
    if (depth_max > group || depth_max < 1 || leaf_size > group
        || leaf_size < 1 || fanout > 2 * group)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    const Query q{rows, width, leaf_size, depth_max, fc_col, origin,
                  direction, last_hit, mask, best_limit, n, out_tri,
                  out_dist, out_code, out_normal, out_iid, out_visits,
                  by_kind};
    cudaStream_t s = (cudaStream_t)stream;
#define CHROMA_LAUNCH(FMT, F, G) launch_warp<FMT, F, G>(q, next_ray, s)
#define CHROMA_FMTS(F, G)                                                   \
    if (fmt == FMT_F32) CHROMA_LAUNCH(FMT_F32, F, G);                       \
    else if (fmt == FMT_BF16) CHROMA_LAUNCH(FMT_BF16, F, G);                \
    else if (fmt == FMT_Q8) CHROMA_LAUNCH(FMT_Q8, F, G);                    \
    else return (int)cudaErrorInvalidValue
    if (fanout == 32 && group == 16) {
        CHROMA_FMTS(32, 16);
    } else if (fanout == 32) {
        CHROMA_FMTS(32, 32);
    } else if (fanout == 16 && group == 16) {
        CHROMA_FMTS(16, 16);
    } else if (fanout == 16) {
        CHROMA_FMTS(16, 32);
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef CHROMA_FMTS
#undef CHROMA_LAUNCH
    return (int)cudaGetLastError();
}

