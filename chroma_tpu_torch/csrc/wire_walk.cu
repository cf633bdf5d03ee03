// K3: the nearest analytic wire hit over all wire planes, one thread a
// lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the device lax.while_loop of chroma_tpu/ops/wireplane.py
// (_intersect_one_plane, :118-174, per plane from intersect_wireplanes,
// :177-197): XLA runs it in lockstep over the batch's widest window of
// candidate wires, plane by plane. The contract is that of the plain
// PyTorch twin chroma_tpu_torch/ops/wireplane.py::walk_plain: for each
// plane in order, the window set-up of _plane_window, then the wires k_lo,
// k_lo + 1, ..., k_hi (at most MAX_WINDOW beyond the first), keeping a hit
// only when strictly nearer than the plane's best so far; a later plane
// wins only when strictly nearer than the earlier planes' best. A lane's
// own loop visits the same k in the same order as the lockstep loop, whose
// other iterations are masked out for it, so ties resolve the same way.
// Built with --fmad=false: fmaf stands exactly where the plain code calls
// linalg.fma (XLA's CPU contractions), every other a * b + c rounds twice.
// min/max propagate NaN as torch.minimum / torch.maximum / clamp do (a
// degenerate ray's window becomes NaN there and is then invalid).
//
// What bounds it. Per lane it reads 24 bytes of ray and 1 of mask and
// writes 16 (t, plane, vn, nn); the planes' 76 bytes each are broadcast.
// Operations: per plane about 70 f32 operations of set-up (three 3-dots,
// the slab and window) and about 30 a candidate wire, so with W_p the
// window of plane p summed over lanes:
//   bytes = 41 N,  ops = 70 P N + 30 sum_p W_p
// A lartpc-wires bomb (three planes at 3 mm pitch, photons from 300 mm
// below) visits on average tens of wires a plane: the operations bound it.
// What the design does about it: one thread a lane, no shared state; the
// loop runs only over the lane's own window (the lockstep loop ran every
// lane over the widest one); lanes of a warp differ in trip count, which
// is the divergence left.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libwire_walk.so
//        wire_walk.cu
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float T_MIN = 1e-4f;
constexpr float PAD_EPS = 1e-6f;
constexpr float MAX_WINDOW = 4096.0f;
constexpr int PLANE_WORDS = 19;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmin(float a, float b) {
    return (a != a || b != b) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
    return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

// the 3-component sum as XLA contracts it: fma(a2, b2, fma(a1, b1, a0 b0))
__device__ __forceinline__ float fma_dot(const float* a, const float* b) {
    return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));
}

__global__ void __launch_bounds__(128)
wire_walk_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ planes, int n_planes, int n,
                 float* __restrict__ out_t, int* __restrict__ out_plane,
                 float* __restrict__ out_vn, float* __restrict__ out_nn) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
    const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
    const bool act = active == nullptr || active[lane] != 0;

    float best_t = __int_as_float(0x7f800000);   // +inf
    int best_plane = -1;
    float best_vn = 0.0f, best_nn = 0.0f;

    for (int ip = 0; ip < n_planes; ++ip) {
        const float* P = planes + PLANE_WORDS * ip;
        const float* u_ax = P + 3;
        const float* v_ax = P + 6;
        const float* n_ax = P + 9;
        const float pitch = P[12], radius = P[13];
        const float umin = P[14], umax = P[15], vmin = P[16], vmax = P[17];
        const float v0 = P[18];

        // _plane_window
        const float w[3] = {p[0] - P[0], p[1] - P[1], p[2] - P[2]};
        const float du = fma_dot(d, u_ax);
        const float dv = fma_dot(d, v_ax);
        const float dn = fma_dot(d, n_ax);
        const float wu = fma_dot(w, u_ax);
        const float wv0 = fma_dot(w, v_ax) - v0;
        const float wn0 = fma_dot(w, n_ax);
        const float pad = 0.5f * (2.0f * radius) + PAD_EPS;

        const bool parallel_u = fabsf(du) < 1e-12f;
        const float inv_du = 1.0f / (parallel_u ? 1.0f : du);
        const float tu1 = (umin - wu) * inv_du;
        const float tu2 = (umax - wu) * inv_du;
        const float t_in = parallel_u ? -__int_as_float(0x7f800000)
                                      : tmin(tu1, tu2);
        const float t_out = parallel_u ? __int_as_float(0x7f800000)
                                       : tmax(tu1, tu2);
        bool valid = (parallel_u ? (wu >= umin && wu <= umax)
                                 : (t_in <= t_out)) && act;

        const float kmin = ceilf((vmin - v0) / pitch);
        const float kmax = floorf((vmax - v0) / pitch);

        float t_lo = tmax(t_in, T_MIN);
        float t_hi = t_out;

        const bool parallel_n = fabsf(dn) <= 1e-9f;
        const float inv_dn = 1.0f / (parallel_n ? 1.0f : dn);
        const float tn1 = (-pad - wn0) * inv_dn;
        const float tn2 = (pad - wn0) * inv_dn;
        if (!parallel_n) {
            t_lo = tmax(t_lo, tmin(tn1, tn2));
            t_hi = tmin(t_hi, tmax(tn1, tn2));
        }
        valid = valid && (!parallel_n || fabsf(wn0) <= pad);
        valid = valid && (t_hi >= t_lo);

        // grazing in-plane rays only need to look one period ahead
        const bool grazing = parallel_n && fabsf(dv) > 1e-9f;
        const float span = (pitch + 2.0f * radius)
                           / tmax(fabsf(dv), 1e-12f);
        if (grazing) t_hi = tmin(t_hi, t_lo + span);

        const float v_entry = fmaf(dv, t_lo, wv0);
        const float v_exit = fmaf(dv, t_hi, wv0);
        const float v_lo = tmin(tmin(v_entry, v_exit), wv0) - pad;
        const float v_hi = tmax(tmax(v_entry, v_exit), wv0) + pad;

        const float k_lo = tmax(floorf(v_lo / pitch), kmin);
        float k_hi = tmin(ceilf(v_hi / pitch), kmax);
        valid = valid && (k_lo <= k_hi);
        k_hi = tmin(k_hi, k_lo + MAX_WINDOW);
        if (!valid) continue;

        // _intersect_one_plane's loop over this lane's window
        const float a_coef = fmaf(dv, dv, dn * dn);
        const float r2 = radius * radius;
        const float eps0 = tmax(1e-6f * r2, 1e-12f);
        const float inv_a = 1.0f / (a_coef > 0.0f ? a_coef : 1.0f);
        float pt = __int_as_float(0x7f800000), pvn = 0.0f, pnn = 0.0f;
        for (float k = k_lo; k <= k_hi; k = k + 1.0f) {
            const float wv = fmaf(-k, pitch, wv0);
            const float b_coef = fmaf(wv, dv, wn0 * dn);
            const float r2_0 = fmaf(wv, wv, wn0 * wn0);
            const float c_coef = r2_0 - r2;
            const float disc = fmaf(b_coef, b_coef, -(a_coef * c_coef));
            bool ok = (disc >= 0.0f) && (a_coef > 0.0f);
            const float sq = sqrtf(tmax(disc, 0.0f));
            const float t_small = (-b_coef - sq) * inv_a;
            const float t_large = (-b_coef + sq) * inv_a;
            const bool outside = r2_0 > r2 + eps0;
            const bool inside = r2_0 < r2 - eps0;
            const float t = outside ? t_small : (inside ? t_large : T_MIN);
            ok = ok && (outside ? t_small > T_MIN
                                : (inside ? t_large > T_MIN : true));
            const float uc = fmaf(du, t, wu);
            ok = ok && (uc >= umin) && (uc <= umax);
            ok = ok && (t >= t_in) && (t <= t_out);
            ok = ok && (t < pt);
            if (ok) {
                pt = t;
                pvn = fmaf(dv, t, wv);
                pnn = fmaf(dn, t, wn0);
            }
        }
        if (pt < best_t) {
            best_t = pt;
            best_plane = ip;
            best_vn = pvn;
            best_nn = pnn;
        }
    }
    out_t[lane] = best_t;
    out_plane[lane] = best_plane;
    out_vn[lane] = best_vn;
    out_nn[lane] = best_nn;
}

}  // namespace

// Loads the kernel's module now (CUDA's lazy loading would otherwise load
// it at the first launch, which may be inside a graph capture).
extern "C" int chroma_wire_walk_load() {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(&attr, wire_walk_kernel);
}

// pos, dir: (n, 3) f32; active: (n,) u8 or null; planes: (n_planes, 19)
// f32 (origin, u, v, w, pitch, radius, umin, umax, vmin, vmax, v0); out_*
// (n,). Launched on `stream`; returns cudaGetLastError() after the launch.
extern "C" int chroma_wire_walk(const float* pos, const float* dir,
                                const uint8_t* active, const float* planes,
                                int n_planes, int n, float* out_t,
                                int* out_plane, float* out_vn, float* out_nn,
                                void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const int threads = 128;
    wire_walk_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        pos, dir, active, planes, n_planes, n, out_t, out_plane, out_vn,
        out_nn);
    return (int)cudaGetLastError();
}
