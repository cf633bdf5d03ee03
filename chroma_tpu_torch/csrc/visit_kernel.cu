// Instanced wide-BVH traversal for NVIDIA Hopper (sm_90a), one thread per
// ray, the whole walk in one launch.
//
// Replaces the TPU kernel chroma_tpu/ops/visit_kernel.py::_visit_kernel_inst
// (launched once per visit through visit_inst's pallas_call, with the row
// gather left to XLA because Mosaic has no per-lane gather). Here each
// thread reads its own row every visit and keeps its traversal state -- the
// (base, pending-mask) stack of at most MAX_D levels, the instance-frame
// registers and the best hit -- in registers and local memory, looping until
// the stack is empty.
//
// What bounds it: per visit a thread reads one W-word row (448 bytes for the
// default bf16 / fanout 32 / leaf 8 table) at a data-dependent address, then
// does ~20 flops per child and ~60 per triangle. Rows of the quick demo
// detector (15k rows, 6.8 MB) stay in the 50 MB L2, so the walk is bound by
// L2 latency and by divergence between the rays of a warp, not by HBM
// bandwidth. This first version keeps the arithmetic identical to the plain
// PyTorch traversal (chroma_tpu_torch/ops/mesh_wide.py): no FMA contraction
// (built with --fmad=false), IEEE division, NaN-propagating min/max.
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
constexpr int MAX_D = 32;

constexpr int FMT_F32 = 0;
constexpr int FMT_BF16 = 1;
constexpr int FMT_Q8 = 2;

// the constants as the plain version rounds them: Python doubles cast to f32
constexpr float EPS = (float)1e-6;
constexpr float NEG_EPS = (float)(-1e-6);
constexpr float ONE_EPS = (float)(1.0 + 1e-6);
constexpr float FLT_EPS = (float)1.19209290e-07;
constexpr float NUDGE = (float)1e-25;

// torch.minimum / torch.maximum semantics: a NaN operand gives NaN (fminf
// and fmaxf would drop it, and padding children would then hit)
__device__ __forceinline__ float nmin(float a, float b) {
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                                  : (a < b ? a : b);
}

__device__ __forceinline__ float nmax(float a, float b) {
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                                  : (a > b ? a : b);
}

__device__ __forceinline__ int as_int(float x) { return __float_as_int(x); }

template <int FMT, int F>
__device__ __forceinline__ void child_bounds(const float* row, int c,
                                             float lo[3], float hi[3]) {
    if (FMT == FMT_BF16) {
        constexpr int PW = F / 2;
        const int w = c % PW;
#pragma unroll
        for (int g = 0; g < 6; ++g) {
            const uint32_t u = (uint32_t)as_int(row[INST_B0 + g * PW + w]);
            const uint32_t bits = c < PW ? (u << 16) : (u & 0xFFFF0000u);
            const float v = __uint_as_float(bits);
            if (g < 3) lo[g] = v; else hi[g - 3] = v;
        }
    } else {
#pragma unroll
        for (int g = 0; g < 6; ++g) {
            const float v = row[INST_B0 + g * F + c];
            if (g < 3) lo[g] = v; else hi[g - 3] = v;
        }
    }
}

template <int FMT, int F>
__global__ void __launch_bounds__(128)
visit_inst_kernel(const float* __restrict__ rows, int width, int leaf_size,
                  int depth_max, int fc_col,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const int* __restrict__ last_hit,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ best_limit, int n,
                  int* __restrict__ out_tri, float* __restrict__ out_dist,
                  int* __restrict__ out_code, float* __restrict__ out_normal,
                  int* __restrict__ out_iid, int* __restrict__ out_visits) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float world[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        world[j] = origin[3 * i + j];
        world[3 + j] = direction[3 * i + j];
    }
    float loc[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) loc[j] = world[j];

    const int excl = last_hit ? last_hit[i] : -1;
    int cur = (mask == nullptr || mask[i]) ? 0 : -1;
    int depth = 0;
    int d_inst = IBIG;
    int tbase = 0;
    int iid = 0;
    int b_tri = -1;
    float b_d = best_limit ? best_limit[i] : __int_as_float(0x7f800000);
    int b_code = 0;
    float b_n[3] = {0.0f, 0.0f, 0.0f};
    int b_iid = 0;
    int visits = 0;
    int bases[MAX_D];
    uint32_t masks[MAX_D];
#pragma unroll
    for (int d = 0; d < MAX_D; ++d) {
        bases[d] = 0;
        masks[d] = 0u;
    }

    while (cur >= 0) {
        ++visits;
        const float* row = rows + (size_t)cur * (size_t)width;
        const int tag = as_int(row[width - 1]);
        const bool internal = tag == TAG_INTERNAL;
        const bool at_leaf = tag == TAG_LEAF;
        const bool is_inst = tag == TAG_INSTANCE;

        // instance entry: rotate the world ray into the instance frame
        float entered[6];
        float o[3], dv[3];
        if (is_inst) {
            const float px = world[0] - row[9];
            const float py = world[1] - row[10];
            const float pz = world[2] - row[11];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                entered[r] = row[3 * r] * px + row[3 * r + 1] * py
                    + row[3 * r + 2] * pz;
                entered[3 + r] = row[3 * r] * world[3]
                    + row[3 * r + 1] * world[4] + row[3 * r + 2] * world[5];
            }
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                o[j] = entered[j];
                dv[j] = entered[3 + j];
            }
        } else {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                o[j] = loc[j];
                dv[j] = loc[3 + j];
            }
        }

        const bool sweeping = internal || is_inst;
        uint32_t hitmask = 0u;
        int nearest = 0;
        if (sweeping) {
            float inv[3], neg[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                inv[j] = 1.0f / (dv[j] == 0.0f ? NUDGE : dv[j]);
                neg[j] = -o[j] * inv[j];
            }
            float q_s[3], q_a[3];
            if (FMT == FMT_Q8) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    q_s[j] = row[INST_B0 + 3 + j] * inv[j];
                    q_a[j] = row[INST_B0 + j] * inv[j] + neg[j];
                }
            }
            float tnear = __int_as_float(0x7f800000);
#pragma unroll 4
            for (int c = 0; c < F; ++c) {
                float t0[3], t1[3];
                bool q_ok = true;
                if (FMT == FMT_Q8) {
                    constexpr int QW = F / 4;
                    float qb[6];
#pragma unroll
                    for (int g = 0; g < 6; ++g) {
                        const uint32_t u = (uint32_t)as_int(
                            row[INST_B0 + 6 + g * QW + (c >> 2)]);
                        qb[g] = (float)((u >> ((c & 3) * 8)) & 0xFFu);
                    }
                    q_ok = qb[0] <= qb[3];
#pragma unroll
                    for (int j = 0; j < 3; ++j) {
                        t0[j] = qb[j] * q_s[j] + q_a[j];
                        t1[j] = qb[3 + j] * q_s[j] + q_a[j];
                    }
                } else {
                    float lo[3], hi[3];
                    child_bounds<FMT, F>(row, c, lo, hi);
#pragma unroll
                    for (int j = 0; j < 3; ++j) {
                        t0[j] = lo[j] * inv[j] + neg[j];
                        t1[j] = hi[j] * inv[j] + neg[j];
                    }
                }
                const float smx = nmin(t0[0], t1[0]);
                const float bgx = nmax(t0[0], t1[0]);
                const float smy = nmin(t0[1], t1[1]);
                const float bgy = nmax(t0[1], t1[1]);
                const float smz = nmin(t0[2], t1[2]);
                const float bgz = nmax(t0[2], t1[2]);
                const float tmin = nmax(nmax(smx, smy), nmax(smz, 0.0f));
                const float tmax = nmin(nmin(bgx, bgy), bgz);
                const bool hit = (tmin <= tmax) && (tmin <= b_d) && q_ok;
                if (hit) {
                    hitmask |= 1u << c;
                    // nearest-first descent; ties go to the lowest child
                    if (tmin < tnear) {
                        tnear = tmin;
                        nearest = c;
                    }
                }
            }
        }

        if (at_leaf) {
            for (int k = 0; k < leaf_size; ++k) {
                const float* tr = row + LEAF_STRIDE * k;
                const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
                const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
                const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
                const int tri = as_int(tr[9]);
                const int code = as_int(tr[10]);
                const int tri_g = tri + tbase;
                const float hx = dv[1] * e2z - dv[2] * e2y;
                const float hy = dv[2] * e2x - dv[0] * e2z;
                const float hz = dv[0] * e2y - dv[1] * e2x;
                const float a = e1x * hx + e1y * hy + e1z * hz;
                const bool parallel = fabsf(a) <= FLT_EPS;
                const float finv = 1.0f / (parallel ? 1.0f : a);
                const float sx = o[0] - v0x, sy = o[1] - v0y, sz = o[2] - v0z;
                const float u = finv * (sx * hx + sy * hy + sz * hz);
                const float qx = sy * e1z - sz * e1y;
                const float qy = sz * e1x - sx * e1z;
                const float qz = sx * e1y - sy * e1x;
                const float v = finv * (dv[0] * qx + dv[1] * qy + dv[2] * qz);
                const float t = finv * (e2x * qx + e2y * qy + e2z * qz);
                const bool ok = !parallel && u >= NEG_EPS && u <= ONE_EPS
                    && v >= NEG_EPS && u + v <= ONE_EPS && t > EPS
                    && isfinite(t) && tri >= 0 && tri_g != excl;
                if (ok && t < b_d) {
                    b_d = t;
                    b_tri = tri_g;
                    b_code = code;
                    b_n[0] = e1y * e2z - e1z * e2y;
                    b_n[1] = e1z * e2x - e1x * e2z;
                    b_n[2] = e1x * e2y - e1y * e2x;
                    b_iid = iid;
                }
            }
        }

        const bool will = sweeping && hitmask != 0u;
        if (will) {
            const int first_child = as_int(row[fc_col]);
            if (is_inst) {
#pragma unroll
                for (int j = 0; j < 6; ++j) loc[j] = entered[j];
                d_inst = depth;
                tbase = as_int(row[12]);
                iid = as_int(row[13]);
            }
            if (depth < depth_max) {
                bases[depth] = first_child;
                masks[depth] = hitmask & ~(1u << nearest);
            }
            cur = first_child + nearest;
            depth += 1;
        } else {
            // pop: jump straight to the highest pending sibling group
            int top = -1;
            for (int d = (depth < depth_max ? depth : depth_max) - 1; d >= 0;
                 --d) {
                if (masks[d] != 0u) {
                    top = d;
                    break;
                }
            }
            if (top >= 0) {
                const uint32_t pm = masks[top];
                masks[top] = pm & (pm - 1u);
                cur = bases[top] + (__ffs((int)pm) - 1);
                depth = top + 1;
            } else {
                cur = -1;
            }
        }

        // leaving the instance: restore the world-frame registers
        if (d_inst != IBIG && depth <= d_inst) {
#pragma unroll
            for (int j = 0; j < 6; ++j) loc[j] = world[j];
            tbase = 0;
            d_inst = IBIG;
        }
    }

    out_tri[i] = b_tri;
    out_dist[i] = b_d;
    out_code[i] = b_code;
#pragma unroll
    for (int j = 0; j < 3; ++j) out_normal[3 * i + j] = b_n[j];
    out_iid[i] = b_iid;
    if (out_visits) out_visits[i] = visits;
}

template <int FMT, int F>
void launch(const float* rows, int width, int leaf_size, int depth_max,
            int fc_col, const float* origin, const float* direction,
            const int* last_hit, const uint8_t* mask, const float* best_limit,
            int n, int* out_tri, float* out_dist, int* out_code,
            float* out_normal, int* out_iid, int* out_visits,
            cudaStream_t stream) {
    constexpr int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    visit_inst_kernel<FMT, F><<<blocks, threads, 0, stream>>>(
        rows, width, leaf_size, depth_max, fc_col, origin, direction,
        last_hit, mask, best_limit, n, out_tri, out_dist, out_code,
        out_normal, out_iid, out_visits);
}

}  // namespace

// Plain C entry point for ctypes. fmt: 0 f32, 1 bf16 pairs, 2 q8; fanout
// 16 or 32. last_hit, mask, best_limit and out_visits may be null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported fmt / fanout / depth).
extern "C" int chroma_visit_inst(
    const float* rows, int width, int fanout, int leaf_size, int depth_max,
    int fmt, int fc_col, const float* origin, const float* direction,
    const int* last_hit, const uint8_t* mask, const float* best_limit, int n,
    int* out_tri, float* out_dist, int* out_code, float* out_normal,
    int* out_iid, int* out_visits, void* stream) {
    if (depth_max > MAX_D || depth_max < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
#define CHROMA_LAUNCH(FMT, F)                                               \
    launch<FMT, F>(rows, width, leaf_size, depth_max, fc_col, origin,       \
                   direction, last_hit, mask, best_limit, n, out_tri,       \
                   out_dist, out_code, out_normal, out_iid, out_visits, s)
    if (fanout == 32) {
        if (fmt == FMT_F32) CHROMA_LAUNCH(FMT_F32, 32);
        else if (fmt == FMT_BF16) CHROMA_LAUNCH(FMT_BF16, 32);
        else if (fmt == FMT_Q8) CHROMA_LAUNCH(FMT_Q8, 32);
        else return (int)cudaErrorInvalidValue;
    } else if (fanout == 16) {
        if (fmt == FMT_F32) CHROMA_LAUNCH(FMT_F32, 16);
        else if (fmt == FMT_BF16) CHROMA_LAUNCH(FMT_BF16, 16);
        else if (fmt == FMT_Q8) CHROMA_LAUNCH(FMT_Q8, 16);
        else return (int)cudaErrorInvalidValue;
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef CHROMA_LAUNCH
    return (int)cudaGetLastError();
}
