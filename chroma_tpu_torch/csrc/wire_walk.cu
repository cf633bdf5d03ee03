// K3: the nearest analytic wire hit over all wire planes, for NVIDIA
// Hopper (sm_90a): a warp walks its 32 rays' candidate wires together.
//
// Replaces the device lax.while_loop of chroma_tpu/ops/wireplane.py
// (_intersect_one_plane, :118-174, per plane from intersect_wireplanes,
// :177-197): XLA runs it in lockstep over the batch's widest window of
// candidate wires, plane by plane. The contract is that of the plain
// PyTorch twin chroma_tpu_torch/ops/wireplane.py::walk_plain: for each
// plane in order, the window set-up of _plane_window, then the wires k_lo,
// k_lo + 1, ..., k_hi (at most MAX_WINDOW beyond the first), keeping a hit
// only when strictly nearer than the plane's best so far; a later plane
// wins only when strictly nearer than the earlier planes' best.
// The wire test is not JAX's: it solves each wire about the ray's closest
// approach to the wire's axis (t0, the offsets there, their squared length
// d2 and the half-chord sqrt((r^2 - d2) / a)), as Chroma does in f64
// (photon.h:115-135), where JAX's quadratic from the ray's origin loses
// r^2 to the rounding of |w|^2 a metre away (ops/wireplane.py says more).
// Built with --fmad=false: fmaf stands exactly where the plain code calls
// linalg.fma (XLA's CPU contractions), every other a * b + c rounds twice.
// min/max propagate NaN as torch.minimum / torch.maximum / clamp do (a
// degenerate ray's window becomes NaN there and is then invalid).
//
// The window. A wire can only be met inside the slab |n| <= radius about
// its plane, and there v is linear in t, so a ray's candidates are the
// wires whose v lies within the radius of its slab chord: between the v
// of its entry and of its exit (clipped to the plane's u extent and to
// t >= T_MIN), with one wire more on each side so that the rounding of
// the slab times never shuts out a wire that can be hit. (The JAX
// package and Chroma's photon.h stretch the window back to the v of the
// ray's origin, which a ray from outside the slab can never meet again.)
//
// What bounds it. Per lane it reads 24 bytes of ray and 1 of mask and
// writes 16 (t, plane, vn, nn); the planes' 76 bytes each are broadcast.
// Operations: per plane about 70 f32 operations of set-up (three 3-dots,
// the slab and window) and about 30 a candidate wire, so with W_p the
// window of plane p summed over lanes:
//   bytes = 41 N,  ops = 70 P N + 30 sum_p W_p
// A slab chord at 3 mm pitch spans about two wires, so with the slack a
// lane that meets a plane walks about four of it: the per-plane set-up
// is most of the operations, and the bytes bound it on paper. Rays that
// graze a plane keep windows of up to thousands of wires.
//
// What the design does about it (wire_walk_kernel). The windows of a
// warp's rays differ in length (0 to thousands of wires), so a thread that
// walked its own ray's windows would keep the warp busy for the longest of
// 32 windows, plane by plane. Here each lane does its own ray's set-up for
// every plane into shared memory; the warp scans the 32 x P window lengths
// with shuffles into one flat list of candidates and walks it 32 at a
// time: lane j takes candidate c, finds its (plane, ray) from the scan and
// runs the wire test with k = k_lo + (c - offset) (exact: the window's
// integers are below 2^24). The nearest hit of each (ray, plane) is kept
// by a 64-bit atomicMin in shared memory on (the bits of t) << 32 | the
// index in the window: a kept t is above T_MIN > 0, so its bits order as
// the floats do, and the smallest index wins a tie, as the plain loop's
// strict `t < best` over ascending k does. Each ray's lane then recomputes
// the winner's (vn, nn) with the same fmaf and combines the planes in
// order with the same strict `<`: the result is the one-thread-a-lane
// walk's bit for bit.
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

// _plane_window of one ray and plane: the set-up the candidate test reads
struct Window {
    float wu, wv0, wn0, du, dv, dn, t_in, t_out, k_lo, k_hi;
    bool valid;
};

__device__ __forceinline__ Window plane_window(const float* p,
                                               const float* d, bool act,
                                               const float* P) {
    const float* u_ax = P + 3;
    const float* v_ax = P + 6;
    const float* n_ax = P + 9;
    const float pitch = P[12], radius = P[13];
    const float umin = P[14], umax = P[15], vmin = P[16], vmax = P[17];
    const float v0 = P[18];
    Window r;

    const float w[3] = {p[0] - P[0], p[1] - P[1], p[2] - P[2]};
    r.du = fma_dot(d, u_ax);
    r.dv = fma_dot(d, v_ax);
    r.dn = fma_dot(d, n_ax);
    r.wu = fma_dot(w, u_ax);
    r.wv0 = fma_dot(w, v_ax) - v0;
    r.wn0 = fma_dot(w, n_ax);
    const float pad = 0.5f * (2.0f * radius) + PAD_EPS;

    const bool parallel_u = fabsf(r.du) < 1e-12f;
    const float inv_du = 1.0f / (parallel_u ? 1.0f : r.du);
    const float tu1 = (umin - r.wu) * inv_du;
    const float tu2 = (umax - r.wu) * inv_du;
    r.t_in = parallel_u ? -__int_as_float(0x7f800000) : tmin(tu1, tu2);
    r.t_out = parallel_u ? __int_as_float(0x7f800000) : tmax(tu1, tu2);
    bool valid = (parallel_u ? (r.wu >= umin && r.wu <= umax)
                             : (r.t_in <= r.t_out)) && act;

    const float kmin = ceilf((vmin - v0) / pitch);
    const float kmax = floorf((vmax - v0) / pitch);

    float t_lo = tmax(r.t_in, T_MIN);
    float t_hi = r.t_out;

    const bool parallel_n = fabsf(r.dn) <= 1e-9f;
    const float inv_dn = 1.0f / (parallel_n ? 1.0f : r.dn);
    const float tn1 = (-pad - r.wn0) * inv_dn;
    const float tn2 = (pad - r.wn0) * inv_dn;
    if (!parallel_n) {
        t_lo = tmax(t_lo, tmin(tn1, tn2));
        t_hi = tmin(t_hi, tmax(tn1, tn2));
    }
    valid = valid && (!parallel_n || fabsf(r.wn0) <= pad);
    valid = valid && (t_hi >= t_lo);

    // grazing in-plane rays only need to look one period ahead
    const bool grazing = parallel_n && fabsf(r.dv) > 1e-9f;
    const float span = (pitch + 2.0f * radius) / tmax(fabsf(r.dv), 1e-12f);
    if (grazing) t_hi = tmin(t_hi, t_lo + span);

    // the wires of the slab chord, and one more on each side so that the
    // rounding of the slab times never shuts out a wire that can be hit
    const float v_entry = fmaf(r.dv, t_lo, r.wv0);
    const float v_exit = fmaf(r.dv, t_hi, r.wv0);
    const float v_lo = tmin(v_entry, v_exit) - pad;
    const float v_hi = tmax(v_entry, v_exit) + pad;

    r.k_lo = tmax(floorf(v_lo / pitch) - 1.0f, kmin);
    r.k_hi = tmin(ceilf(v_hi / pitch) + 1.0f, kmax);
    valid = valid && (r.k_lo <= r.k_hi);
    r.k_hi = tmin(r.k_hi, r.k_lo + MAX_WINDOW);
    r.valid = valid;
    return r;
}

// _intersect_one_plane's test of wire k: true and its distance *t on a hit
// the plain loop could keep (before its `t < best` test)
__device__ __forceinline__ bool wire_test(float k, float wv0, float wn0,
                                          float du, float dv, float dn,
                                          float wu, float t_in, float t_out,
                                          float a_coef, float inv_a,
                                          const float* P, float* t_out_) {
    const float pitch = P[12], radius = P[13];
    const float umin = P[14], umax = P[15];
    const float r2 = radius * radius;
    const float eps0 = tmax(1e-6f * r2, 1e-12f);
    const float wv = fmaf(-k, pitch, wv0);
    // about the closest approach t0 to the wire's axis: the offsets there
    // are small near the wire, so d2 keeps its digits far away
    const float t0 = -fmaf(wv, dv, wn0 * dn) * inv_a;
    const float ev = fmaf(dv, t0, wv);
    const float en = fmaf(dn, t0, wn0);
    const float d2 = fmaf(ev, ev, en * en);
    const float h2 = (r2 - d2) * inv_a;
    bool ok = (h2 >= 0.0f) && (a_coef > 0.0f);
    const float half = sqrtf(tmax(h2, 0.0f));
    const float t_small = t0 - half;
    const float t_large = t0 + half;
    const float r2_0 = fmaf(wv, wv, wn0 * wn0);
    const bool outside = r2_0 > r2 + eps0;
    const bool inside = r2_0 < r2 - eps0;
    const float t = outside ? t_small : (inside ? t_large : T_MIN);
    ok = ok && (outside ? t_small > T_MIN
                        : (inside ? t_large > T_MIN : true));
    const float uc = fmaf(du, t, wu);
    ok = ok && (uc >= umin) && (uc <= umax);
    ok = ok && (t >= t_in) && (t <= t_out);
    *t_out_ = t;
    return ok;
}

// ------------------------------------------------- the warp's walk

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
// a ray's set-up of one plane, as the candidate test reads it
enum SetWord { W_WU, W_WV0, W_WN0, W_DU, W_DV, W_DN, W_T_IN, W_T_OUT,
               W_K_LO, W_A, W_INV_A, SET_WORDS };

// shared bytes of one warp over P planes: the keys (P x 32 u64), the
// set-up (P x SET_WORDS x 32 f32), the window offsets (P x 32 i32) and
// each plane's end offset (P i32), rounded up to 8 bytes
__host__ __device__ __forceinline__ int warp_bytes(int n_planes) {
    return (n_planes * (32 * 8 + SET_WORDS * 32 * 4 + 32 * 4 + 4) + 7)
           / 8 * 8;
}

__global__ void __launch_bounds__(128)
wire_walk_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ planes, int n_planes, int n,
                 float* __restrict__ out_t, int* __restrict__ out_plane,
                 float* __restrict__ out_vn, float* __restrict__ out_nn) {
    extern __shared__ unsigned long long smem[];
    const int ln = threadIdx.x & 31;
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = lane < n;
    const int np = n_planes;
    char* base = reinterpret_cast<char*>(smem)
                 + (threadIdx.x >> 5) * warp_bytes(np);
    unsigned long long* key = reinterpret_cast<unsigned long long*>(base);
    float* set = reinterpret_cast<float*>(key + np * 32);
    int* off = reinterpret_cast<int*>(set + np * SET_WORDS * 32);
    int* pend = off + np * 32;

    float p[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    bool act = false;
    if (in) {
        for (int k = 0; k < 3; ++k) {
            p[k] = pos[3 * lane + k];
            d[k] = dir[3 * lane + k];
        }
        act = active == nullptr || active[lane] != 0;
    }

    // each lane's set-up for every plane; the warp's scan of the windows
    int total = 0;
    for (int ip = 0; ip < np; ++ip) {
        const Window w = plane_window(p, d, act, planes + PLANE_WORDS * ip);
        const float a_coef = fmaf(w.dv, w.dv, w.dn * w.dn);
        float* s = set + ip * SET_WORDS * 32 + ln;
        s[W_WU * 32] = w.wu;
        s[W_WV0 * 32] = w.wv0;
        s[W_WN0 * 32] = w.wn0;
        s[W_DU * 32] = w.du;
        s[W_DV * 32] = w.dv;
        s[W_DN * 32] = w.dn;
        s[W_T_IN * 32] = w.t_in;
        s[W_T_OUT * 32] = w.t_out;
        s[W_K_LO * 32] = w.k_lo;
        s[W_A * 32] = a_coef;
        s[W_INV_A * 32] = 1.0f / (a_coef > 0.0f ? a_coef : 1.0f);
        key[ip * 32 + ln] = NO_KEY;
        const int len = (in && w.valid) ? (int)(w.k_hi - w.k_lo) + 1 : 0;
        int x = len;                              // inclusive scan
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, x, o);
            if (ln >= o) x += y;
        }
        off[ip * 32 + ln] = total + x - len;
        total += __shfl_sync(FULL, x, 31);
        if (ln == 0) pend[ip] = total;
    }
    __syncwarp();

    // the flat list of candidates, 32 at a time
    for (int c0 = 0; c0 < total; c0 += 32) {
        const int c = c0 + ln;
        if (c < total) {
            int ip = 0;
            while (c >= pend[ip]) ++ip;
            const int* o = off + ip * 32;
            int r = 0;                  // the last ray whose window starts
            for (int step = 16; step > 0; step >>= 1)      // at or before c
                if (o[r + step] <= c) r += step;
            const int i = c - o[r];
            const float* s = set + ip * SET_WORDS * 32 + r;
            float t;
            const bool ok = wire_test(
                s[W_K_LO * 32] + (float)i, s[W_WV0 * 32], s[W_WN0 * 32],
                s[W_DU * 32], s[W_DV * 32], s[W_DN * 32], s[W_WU * 32],
                s[W_T_IN * 32], s[W_T_OUT * 32], s[W_A * 32],
                s[W_INV_A * 32], planes + PLANE_WORDS * ip, &t);
            // the plain loop's best starts at +inf: it never keeps t = inf
            if (ok && t < __int_as_float(0x7f800000))
                atomicMin(&key[ip * 32 + r],
                          ((unsigned long long)__float_as_uint(t) << 32)
                          | (unsigned)i);
        }
    }
    __syncwarp();

    // each ray's planes in order, the winner's (vn, nn) recomputed
    float best_t = __int_as_float(0x7f800000);   // +inf
    int best_plane = -1;
    float best_vn = 0.0f, best_nn = 0.0f;
    for (int ip = 0; ip < np; ++ip) {
        const unsigned long long kk = key[ip * 32 + ln];
        if (kk == NO_KEY) continue;
        const float t = __uint_as_float((unsigned)(kk >> 32));
        const float* s = set + ip * SET_WORDS * 32 + ln;
        const float k = s[W_K_LO * 32] + (float)(unsigned)(kk & 0xffffffffu);
        const float wv = fmaf(-k, planes[PLANE_WORDS * ip + 12],
                              s[W_WV0 * 32]);
        if (t < best_t) {
            best_t = t;
            best_plane = ip;
            best_vn = fmaf(s[W_DV * 32], t, wv);
            best_nn = fmaf(s[W_DN * 32], t, s[W_WN0 * 32]);
        }
    }
    if (in) {
        out_t[lane] = best_t;
        out_plane[lane] = best_plane;
        out_vn[lane] = best_vn;
        out_nn[lane] = best_nn;
    }
}

}  // namespace

// shared memory a block may use on sm_90 (227 KB)
constexpr int MAX_SMEM = 232448;
constexpr int WARPS = 4;        // warps of a block of the warp's walk

// Loads the kernels now (CUDA's lazy loading would otherwise load each at
// its first launch, which may be inside a graph capture) and lets the
// warp's walk take more than 48 KB of shared memory (many planes).
extern "C" int chroma_wire_walk_load() {
    cudaFuncAttributes attr;
    int err = (int)cudaFuncGetAttributes(&attr, wire_walk_kernel);
    if (!err)
        err = (int)cudaFuncSetAttribute(
            wire_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MAX_SMEM);
    return err;
}

// The most planes the warp's walk takes (one warp a block at the limit).
extern "C" int chroma_wire_walk_max_planes() {
    int np = 1;
    while (warp_bytes(np + 1) <= MAX_SMEM) ++np;
    return np;
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
    int warps = WARPS;
    while (warps > 0 && warps * warp_bytes(n_planes) > MAX_SMEM) --warps;
    if (warps == 0 || n_planes <= 0) return (int)cudaErrorInvalidValue;
    const int threads = 32 * warps;
    wire_walk_kernel<<<(n + threads - 1) / threads, threads,
                       warps * warp_bytes(n_planes),
                       (cudaStream_t)stream>>>(
        pos, dir, active, planes, n_planes, n, out_t, out_plane, out_vn,
        out_nn);
    return (int)cudaGetLastError();
}

