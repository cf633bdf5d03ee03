// K2: the step around the geometry query, for NVIDIA Hopper (sm_90a), in
// two launches a step: k2_pre before the query and k2_post after it.
//
// k2_post replaces the part of the JAX step that XLA fuses after the
// traversal: chroma_tpu/ops/photon.py fill_state's context decode
// (:201-362), bulk transport with reemission, weights and scatter_first,
// the five surface models, Fresnel and medium tracking (:437-1085), as
// propagate_step (:1086-1182) runs them. Its contract is the plain PyTorch
// twin chroma_tpu_torch/ops/step_kernel.py::after_query_plain, which is
// built from the port's plain functions (ops/photon.py: decode_state,
// propagate_to_boundary, propagate_at_surface, propagate_at_boundary):
// given K1's raw outputs (tri, dist, code, nvec, iid), K3's (t, plane, vn,
// nn) or none, the photon fields after the NaN guard, the active and
// pruned lanes, the step's uniform blocks and the geometry's packed
// tables, it writes the photon fields after the step. k2_pre replaces the
// per-lane work of the step's prologue (photon.step_prologue after its
// uniform blocks, which stay torch's uniform_ so that the Philox stream is
// the plain step's): the NaN guard, the active and pruned lanes and the
// traversal's pruning limit.
//
// The plain step evaluates every surface model present for every lane and
// keeps each lane's own; here a lane evaluates only its own model. The
// uniforms it reads are the plain step's: the host gives each draw site
// (S_* below) the stream index the plain step draws it from
// (step_kernel.draw_sites), and lane l reads stream s at u[s * n + l],
// mapped to U(low, high] as DrawPool.draw maps it (high - u * (high -
// low)). Rounding follows the plain version on the card: --fmad=false and
// fmaf only where it calls linalg.fma (sample_cdf_uniform_rows); a
// division of a tensor by a Python scalar is torch's CUDA multiplication
// by the scalar's f32 reciprocal (DIVS); `scalar / tensor` is the
// reciprocal times the scalar; sums in the plain version's order; clamp,
// minimum and maximum propagate NaN. The thin-film model's complex
// arithmetic (c10::complex in torch) may differ from it in the last ulp.
//
// What bounds it. Per lane k2_post reads the photon (60 bytes), the query
// (28, and 16 of wires), the active and pruned bytes and 4 bytes for each
// uniform its path draws (5 in bulk transport, 8 more with reemission,
// 1-12 at a surface, 2 at a Fresnel boundary), and writes the photon (60
// bytes); the tables (a few hundred KB) stay in L2. Its f32 operations (a
// few hundred a lane, more on the thin-film path) are far below the card's
// rate against those bytes, so memory bounds it: about 150-200 bytes a
// lane, ~0.05 ms at 2^20 lanes at 3.35 TB/s. k2_pre reads 40 bytes a lane
// (the position, direction, wavelength, flags, medium and two uniforms)
// and writes 10: bytes bound it too.
//
// What the design does about it (step_kernel, k2_post). One thread a lane
// left a warp running every path any of its lanes took: the lanes that
// step are scattered among lanes that only copy, and after bulk transport
// the lanes that reach the boundary split over five surface models and
// Fresnel alone, the thin-film model the longest. So a block of B lanes
// runs in two phases. Phase A, a thread a lane: the load, the decode and
// bulk transport; a lane that ends there writes its photon, and a lane at
// the boundary writes what the boundary does not change (position, time,
// last hit), takes a class (its surface model, or Fresnel only) and
// stashes what the boundary reads in shared memory. The block counts its
// classes with ballots and scans them, which gives every boundary lane a
// slot in class order; phase B: thread i takes slot i and runs that lane's
// model, Fresnel and medium tracking from the stash with the lane's own
// index (so it reads the lane's own uniforms, and the arithmetic and the
// result are those of one thread a lane, bit for bit). A warp of phase B
// runs one model except at the at most five class boundaries of a block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libstep_kernel.so
//        step_kernel.cu
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// history bits (chroma_tpu_torch/event.py)
constexpr int NO_HIT = 1 << 0;
constexpr int BULK_ABSORB = 1 << 1;
constexpr int SURFACE_DETECT = 1 << 2;
constexpr int SURFACE_ABSORB = 1 << 3;
constexpr int RAYLEIGH_SCATTER = 1 << 4;
constexpr int REFLECT_DIFFUSE = 1 << 5;
constexpr int REFLECT_SPECULAR = 1 << 6;
constexpr int SURFACE_REEMIT = 1 << 7;
constexpr int SURFACE_TRANSMIT = 1 << 8;
constexpr int BULK_REEMIT = 1 << 9;
constexpr int NAN_ABORT = (int)0x80000000u;
constexpr int TERMINAL = NO_HIT | BULK_ABSORB | SURFACE_DETECT
                         | SURFACE_ABSORB | NAN_ABORT;

constexpr int BREAK = 0, CONTINUE = 1, PASS = 2;
// surface models (geometry.SURFACE_*)
constexpr int SURFACE_DEFAULT = 0, SURFACE_COMPLEX = 1, SURFACE_WLS = 2,
              SURFACE_DICHROIC = 3, SURFACE_ANGULAR = 4;
// material and surface property columns (ops/types.py)
constexpr int MAT_RI = 0, MAT_ABS = 1, MAT_SCAT = 2;
constexpr int SURF_DETECT = 0, SURF_ABSORB = 1, SURF_REEMIT = 2,
              SURF_RDIFF = 3, SURF_RSPEC = 4, SURF_ETA = 5, SURF_K = 6;

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float SPEED_OF_LIGHT = 299.792458f;
constexpr float WEIGHT_LOWER = 1e-4f;
constexpr float ONE_MINUS_WEIGHT_LOWER = 0.9999f;   // 1.0 - 1e-4 in f64

// The packed tables (step_kernel.TABLES_F32 / TABLES_I32, same order).
enum Table {
    T_MAT_WL, T_COMP_ABS, T_COMP_PROB, T_COMP_WVL, T_COMP_TIME, T_SURF_WL,
    T_SURF_CDF, T_THICKNESS, T_D_ANGLES, T_D_REFLECT, T_D_TRANSMIT,
    T_A_ANGLES, T_A_TRANSMIT, T_A_RSPEC, T_A_RDIFF, T_ROT, T_WIRE_V,
    T_WIRE_W,
    T_NUM_COMP, T_MODEL, T_TRANSMISSIVE, T_D_INDEX, T_D_NANGLES, T_A_INDEX,
    T_A_NANGLES, T_WIRE_SURFACE, T_WIRE_INNER, T_WIRE_OUTER,
    N_TABLES
};

// The draw sites of the plain step, in its order (step_kernel.SITES).
enum Site {
    S_ABS, S_SCAT, S_FORCE,
    S_RE_COMP, S_RE_REEMIT, S_RE_WL, S_RE_TIME, S_RE_DIR_PHI, S_RE_DIR_U,
    S_RE_POL_PHI, S_RE_POL_U,
    S_RAY_U, S_RAY_PHI,
    S_DEF_U, S_DEF_HEMI_U1, S_DEF_HEMI_U2, S_DEF_POL_PHI, S_DEF_POL_U,
    S_CX_U, S_CX_UDET, S_CX_UREFL, S_CX_HEMI_U1, S_CX_HEMI_U2,
    S_CX_POL_PHI, S_CX_POL_U,
    S_WLS_U, S_WLS_UREEMIT, S_WLS_WL, S_WLS_DIR_PHI, S_WLS_DIR_U,
    S_WLS_POL_PHI, S_WLS_POL_U, S_WLS_UREFL, S_WLS_HEMI_U1, S_WLS_HEMI_U2,
    S_WLS_RPOL_PHI, S_WLS_RPOL_U,
    S_DI_U,
    S_AN_U, S_AN_HEMI_U1, S_AN_HEMI_U2, S_AN_POL_PHI, S_AN_POL_U,
    S_FR_SPOL, S_FR_U,
    N_SITES
};

}  // namespace

// Arguments of one launch, passed by value (step_kernel._Args mirrors it).
struct StepArgs {
    // per lane, in
    const float* pos; const float* dir; const float* pol;
    const float* wl; const float* t; const float* weight;
    const int* flags; const int* lht; const int* cur_mat;
    const uint8_t* active; const uint8_t* pruned;      // pruned may be null
    const int* tri; const float* dist; const int* code; const float* nvec;
    const int* iid;
    const float* w_t; const int* w_plane; const float* w_vn;
    const float* w_nn;                                 // null: no wires
    const float* u;                                    // (streams, n)
    // per lane, out
    float* o_pos; float* o_dir; float* o_pol; float* o_wl; float* o_t;
    float* o_weight; int* o_flags; int* o_lht; int* o_cur_mat;
    // tables
    const float* tf; const int* ti;
    int off[N_TABLES];
    int n;
    int n_wl, n_mat, maxc, n_t, n_surf, d_nang, a_nang, n_inst;
    int use_weights, scatter_first, prune, force_scatter, has_reemission,
        has_inst, wl0_zero, t0_zero;
    float wl0, wl_step, time0, time_step;
    int sites[N_SITES];
};

// Arguments of one k2_pre launch (step_kernel._PreArgs mirrors it).
struct PreArgs {
    const float* pos; const float* dir; const float* wl;
    const int* flags; const int* cur_mat;
    const float* u;                         // the step's (streams, n)
    const float* mat_wl;                    // (n_wl, n_mat, 3)
    int* o_flags; uint8_t* o_active;
    uint8_t* o_pruned; float* o_limit;      // null: no pruning
    int n, n_wl, n_mat;
    float wl0, wl_step;
};

namespace {

// ---------------------------------------------------------------- helpers

// torch.clamp propagates NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x != x ? x : fmaxf(x, lo);
}
// torch.minimum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
// a tensor divided by a Python scalar on the card: times the f32
// reciprocal (torch's div_true_kernel_cuda)
__device__ __forceinline__ float divs(float x, float s) {
    return x * (1.0f / s);
}
__device__ __forceinline__ int sext8(int x) {
    x &= 0xFF;
    return x >= 128 ? x - 256 : x;
}

// wavelength_lerp_rows' fraction: (jl, frac) of x on a uniform grid of n
__device__ __forceinline__ void lerp_grid(float x, float x0, float dx, int n,
                                          int* jl, float* frac) {
    float xf = divs(x - x0, dx);
    int j = (int)xf;
    j = j < 0 ? 0 : (j > n - 2 ? n - 2 : j);
    *jl = j;
    *frac = clampf(xf - (float)j, 0.0f, 1.0f);
}
// one row of a wavelength-major table t (n_wl, rows, cols), lerped
__device__ __forceinline__ float lerp_row(const float* t, int rows, int cols,
                                          int r, int c, int jl, float frac) {
    float lo = __ldg(t + ((size_t)jl * rows + r) * cols + c);
    float hi = __ldg(t + ((size_t)(jl + 1) * rows + r) * cols + c);
    return lo + frac * (hi - lo);
}

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    V3 r; r.x = x; r.y = y; r.z = z; return r;
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalize(V3 a) {
    float l = sqrtf(dot(a, a));
    return v3(a.x / l, a.y / l, a.z / l);
}

// linalg.rotate: Rodrigues' formula about unit axis n
__device__ __forceinline__ V3 rotate(V3 x, float phi, V3 n) {
    float c = cosf(phi), s = sinf(phi);
    float d = dot(x, n);
    float omc = 1.0f - c;
    V3 cr = cross(x, n);
    return v3((x.x * c + (n.x * d) * omc) + cr.x * s,
              (x.y * c + (n.y * d) * omc) + cr.y * s,
              (x.z * c + (n.z * d) * omc) + cr.z * s);
}

// photon.get_theta(a, b)
__device__ __forceinline__ float get_theta(V3 a, V3 b) {
    return acosf(clampf(dot(a, b), -1.0f, 1.0f));
}

// photon.pick_new_direction
__device__ V3 pick_new_direction(V3 axis, float theta, float phi) {
    float cos_t = cosf(theta), sin_t = sinf(theta);
    float cos_p = cosf(phi), sin_p = sinf(phi);
    float sat = sqrtf(clamp_min(1.0f - axis.z * axis.z, 0.0f));
    bool degenerate = sat < 1e-5f;
    float inv = 1.0f / (degenerate ? 1.0f : sat);
    float cap = degenerate ? 1.0f : axis.x * inv;
    float sap = degenerate ? 0.0f : axis.y * inv;
    return v3(cos_t * axis.x + sin_t * ((axis.z * cos_p) * cap - sin_p * sap),
              cos_t * axis.y + sin_t * ((cos_p * axis.z) * sap + sin_p * cap),
              cos_t * axis.z - (sin_t * cos_p) * sat);
}

// ------------------------------------------------------------ the context

struct Ctx {
    const StepArgs& a;
    int lane;
    __device__ Ctx(const StepArgs& args, int l) : a(args), lane(l) {}

    __device__ __forceinline__ const float* tf(int t) const {
        return a.tf + a.off[t];
    }
    __device__ __forceinline__ const int* ti(int t) const {
        return a.ti + a.off[t];
    }
    __device__ __forceinline__ bool present(int site) const {
        return a.sites[site] >= 0;
    }
    __device__ __forceinline__ float raw(int site) const {
        return __ldg(a.u + (size_t)a.sites[site] * a.n + lane);
    }
    // DrawPool.draw(low, high) = high - u * (high - low)
    __device__ __forceinline__ float u01(int site) const {
        return 1.0f - raw(site) * 1.0f;
    }
    __device__ __forceinline__ float u2pi(int site) const {
        return TWO_PI_F - raw(site) * TWO_PI_F;
    }
    __device__ __forceinline__ float usym(int site) const {
        return 1.0f - raw(site) * 2.0f;
    }
    // DrawPool.uniform_sphere from two sites (theta, u)
    __device__ V3 sphere(int s_theta, int s_u) const {
        float theta = u2pi(s_theta);
        float u = usym(s_u);
        float c = sqrtf(clamp_min(1.0f - u * u, 0.0f));
        return v3(c * cosf(theta), c * sinf(theta), u);
    }
    // photon._random_perpendicular_pol
    __device__ V3 perp_pol(int s_theta, int s_u, V3 direction) const {
        return normalize(cross(sphere(s_theta, s_u), direction));
    }

    // wavelength_lerp_rows' fraction: (jl, frac) of x on a uniform grid
    __device__ void grid(float x, float x0, float dx, int n, int* jl,
                         float* frac) const {
        lerp_grid(x, x0, dx, n, jl, frac);
    }
    // one row of a wavelength-major table (n_wl, rows, cols), lerped
    __device__ float wl_row(int table, int rows, int cols, int r, int c,
                            int jl, float frac) const {
        return lerp_row(tf(table), rows, cols, r, c, jl, frac);
    }
    // photon._interp_rows on table (R, n)
    __device__ float interp_row(int table, int n, int row, float x, float x0,
                                float dx) const {
        int jl; float frac;
        grid(x, x0, dx, n, &jl, &frac);
        const float* t = tf(table) + (size_t)row * n;
        float lo = __ldg(t + jl), hi = __ldg(t + jl + 1);
        return lo + frac * (hi - lo);
    }
    // sample.sample_cdf_uniform_rows on table (R, n), row `row`
    __device__ float sample_cdf(int table, int n, int row, float u, float x0,
                                float dx, bool x0_zero) const {
        const float* t = tf(table) + (size_t)row * n;
        int lower = 0, upper = n - 1;
        while (lower < upper - 1) {
            int half = (lower + upper) / 2;
            if (u < __ldg(t + half)) upper = half; else lower = half;
        }
        float y_lo = __ldg(t + lower), y_hi = __ldg(t + upper);
        float dy = y_hi - y_lo;
        float frac = dy > 0.0f ? (u - y_lo) / dy : 0.0f;
        float lo = (float)lower;
        if (x0_zero) return fmaf(dx, lo, dx * frac);
        return fmaf(dx, lo, x0) + dx * frac;
    }
    // every material's property p at the lane's wavelength, row `mat`
    // (select_rows: 0 outside the table)
    __device__ float mat_prop(int mat, int p, int jl, float frac) const {
        if (mat < 0 || mat >= a.n_mat) return 0.0f;
        return wl_row(T_MAT_WL, a.n_mat, 3, mat, p, jl, frac);
    }
};

struct Photon {
    V3 pos, dir, pol;
    float wl, t, w;
    int flags, lht, cur_mat;
};

struct State {
    float dist, rindex1, rindex2, abslen, scatlen;
    V3 normal;
    int mat1, mat2, surf;
};

// photon._incident_geometry
struct Incident {
    float inc, refr, s_fraction;
    bool tir;
    V3 ipn;
};

__device__ Incident incident_geometry(const Photon& p, const State& s) {
    Incident r;
    r.inc = get_theta(s.normal, neg(p.dir));
    float sin_ratio = (sinf(r.inc) * s.rindex1) / s.rindex2;
    r.refr = asinf(sin_ratio);
    r.tir = fabsf(sin_ratio) > 1.0f;
    V3 ipn = cross(p.dir, s.normal);
    float len = sqrtf(dot(ipn, ipn));
    bool degenerate = len < 1e-6f;
    float l = degenerate ? 1.0f : len;
    r.ipn = degenerate ? p.pol : v3(ipn.x / l, ipn.y / l, ipn.z / l);
    float nc = dot(p.pol, r.ipn);
    r.s_fraction = nc * nc;
    return r;
}

// photon.cosine_hemisphere
__device__ V3 cosine_hemisphere(const Ctx& c, int s_u1, int s_u2, V3 n) {
    float u1 = c.u01(s_u1), u2 = c.u01(s_u2);
    float z = sqrtf(u1);
    float r = sqrtf(clamp_min(1.0f - u1, 0.0f));
    float phi = TWO_PI_F * u2;
    float sign = n.z >= 0.0f ? 1.0f : -1.0f;
    float a = (1.0f / (sign + n.z)) * -1.0f;
    float b = (n.x * n.y) * a;
    V3 t1 = v3(1.0f + ((sign * n.x) * n.x) * a, sign * b, (-sign) * n.x);
    V3 t2 = v3(b, sign + (n.y * n.y) * a, -n.y);
    float rc = r * cosf(phi), rs = r * sinf(phi);
    return v3((rc * t1.x + rs * t2.x) + z * n.x,
              (rc * t1.y + rs * t2.y) + z * n.y,
              (rc * t1.z + rs * t2.z) + z * n.z);
}

// photon._specular_reflect
__device__ void specular_reflect(Photon& p, const State& s) {
    float inc = get_theta(s.normal, neg(p.dir));
    V3 ipn = normalize(cross(p.dir, s.normal));
    p.dir = rotate(s.normal, inc, ipn);
    p.flags |= REFLECT_SPECULAR;
}

// photon._reflect_either (its four draws: hemisphere u1, u2, then the
// polarization's theta, u)
__device__ void reflect_either(const Ctx& c, Photon& p, const State& s,
                               bool diffuse, int s_hemi) {
    if (diffuse) {
        p.dir = cosine_hemisphere(c, s_hemi, s_hemi + 1, s.normal);
        p.pol = c.perp_pol(s_hemi + 2, s_hemi + 3, p.dir);
        p.flags |= REFLECT_DIFFUSE;
    } else {
        specular_reflect(p, s);
    }
}

// photon._weight_out_absorption over `np` probabilities
__device__ void weight_out(Photon& p, float& absorb, float* probs, int np) {
    bool lane = (p.w > WEIGHT_LOWER) && (absorb < ONE_MINUS_WEIGHT_LOWER);
    float survive = 1.0f - absorb;
    if (lane) {
        p.w = p.w * survive;
        for (int i = 0; i < np; ++i) probs[i] = probs[i] / survive;
        absorb = 0.0f;
    }
}

// ------------------------------------------------------- surface models

__device__ int default_surface(const Ctx& c, Photon& p, const State& s,
                               const float* sp) {
    float detect = sp[SURF_DETECT], absorb = sp[SURF_ABSORB];
    float rdiff = sp[SURF_RDIFF], rspec = sp[SURF_RSPEC];
    if (c.a.force_scatter) {
        float total = ((detect + absorb) + rdiff) + rspec;
        float inv = 1.0f / (total > 0.0f ? total : 1.0f);
        float scale = total > 0.0f ? inv : 1.0f;
        detect = detect * scale;
        absorb = absorb * scale;
        rdiff = rdiff * scale;
        rspec = rspec * scale;
        rspec = rspec + (1.0f - (((detect + absorb) + rdiff) + rspec));
    }
    float u = c.u01(S_DEF_U);
    bool forced = false;
    if (c.a.use_weights) {
        float probs[3] = {detect, rdiff, rspec};
        weight_out(p, absorb, probs, 3);
        detect = probs[0]; rdiff = probs[1]; rspec = probs[2];
        forced = detect > 0.0f;
    }
    bool absorbs = u < absorb;
    bool detects = !absorbs && (u < absorb + detect);
    bool diffuses = !absorbs && !detects && (u < (absorb + detect) + rdiff);
    bool speculars = c.a.force_scatter
        ? (!absorbs && !detects && !diffuses)
        : (!absorbs && !detects && !diffuses
           && (u < ((absorb + detect) + rdiff) + rspec));
    bool passes = !absorbs && !detects && !diffuses && !speculars;
    absorbs = absorbs && !forced;
    detects = (detects || forced) && !absorbs;
    diffuses = diffuses && !forced;
    speculars = speculars && !forced;
    passes = passes && !forced;
    if (c.a.use_weights && forced) p.w = p.w * detect;
    if (diffuses || speculars) reflect_either(c, p, s, diffuses,
                                              S_DEF_HEMI_U1);
    if (detects) p.flags |= SURFACE_DETECT;
    if (absorbs) p.flags |= SURFACE_ABSORB;
    return (absorbs || detects) ? BREAK : (passes ? PASS : CONTINUE);
}

struct Cx { float re, im; };

__device__ __forceinline__ Cx cx(float re, float im) {
    Cx r; r.re = re; r.im = im; return r;
}
__device__ __forceinline__ Cx cadd(Cx a, Cx b) {
    return cx(a.re + b.re, a.im + b.im);
}
__device__ __forceinline__ Cx csub(Cx a, Cx b) {
    return cx(a.re - b.re, a.im - b.im);
}
__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
    return cx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
// a real Python scalar times a complex tensor
__device__ __forceinline__ Cx cscale(float s, Cx a) {
    return cx(s * a.re, s * a.im);
}
// c10::complex division (numpy's scaled algorithm)
__device__ Cx cdiv(Cx x, Cx y) {
    float a = x.re, b = x.im, c = y.re, d = y.im;
    float ac = fabsf(c), ad = fabsf(d);
    if (ac >= ad) {
        if (ac == 0.0f && ad == 0.0f) return cx(a / ac, b / ad);
        float rat = d / c;
        float scl = 1.0f / (c + d * rat);
        return cx((a + b * rat) * scl, (b - a * rat) * scl);
    }
    float rat = c / d;
    float scl = 1.0f / (d + c * rat);
    return cx((a * rat + b) * scl, (b * rat - a) * scl);
}
// principal square root (Algorithm 312, CACM 10, as thrust's csqrtf)
__device__ Cx csqrt(Cx z) {
    float a = z.re, b = z.im;
    if (a == 0.0f && b == 0.0f) return cx(0.0f, b);
    float h = hypotf(a, b);
    if (a >= 0.0f) {
        float t = sqrtf((a + h) * 0.5f);
        return cx(t, b / (2.0f * t));
    }
    float t = sqrtf((-a + h) * 0.5f);
    return cx(fabsf(b) / (2.0f * t), copysignf(t, b));
}
__device__ __forceinline__ float cabs_(Cx z) { return hypotf(z.re, z.im); }
__device__ __forceinline__ float carg(Cx z) { return atan2f(z.im, z.re); }

// photon._film: (r, t) of one polarization
__device__ void film(Cx r12, Cx r23, Cx t12, Cx t23, Cx g, float u_,
                     float v_, float e, float* r_out, float* t_out) {
    float abs_r12 = cabs_(r12), abs_r23 = cabs_(r23);
    float abs_t12 = cabs_(t12), abs_t23 = cabs_(t23);
    float arg_r12 = carg(r12), arg_r23 = carg(r23);
    float sq_r12 = abs_r12 * abs_r12, sq_r23 = abs_r23 * abs_r23;
    float exp1 = expf((2.0f * v_) * e);
    float exp2 = 1.0f / exp1;
    float two_rr = (2.0f * abs_r12) * abs_r23;
    float two_ue = (2.0f * u_) * e;
    float denom = (exp1 + (sq_r12 * sq_r23) * exp2)
                  + two_rr * cosf((arg_r23 + arg_r12) + two_ue);
    *r_out = ((sq_r12 * exp1 + sq_r23 * exp2)
              + two_rr * cosf((arg_r23 - arg_r12) + two_ue)) / denom;
    *t_out = ((g.re * (abs_t12 * abs_t12)) * (abs_t23 * abs_t23)) / denom;
}

__device__ int complex_surface(const Ctx& c, Photon& p, const State& s,
                               const float* sp, float thickness,
                               bool transmissive) {
    float detect = sp[SURF_DETECT], rdiff = sp[SURF_RDIFF];
    Cx n1 = cx(s.rindex1, 0.0f), n2 = cx(sp[SURF_ETA], sp[SURF_K]);
    Cx n3 = cx(s.rindex2, 0.0f);
    float cos_t1 = fabsf(dot(p.dir, s.normal));
    float theta = acosf(clampf(cos_t1, -1.0f, 1.0f));
    Cx cos1 = cx(cosf(theta), 0.0f), sin1 = cx(sinf(theta), 0.0f);
    Cx sin1_sq = cmul(sin1, sin1);
    float e = ((float)(2.0 * 3.14159265358979323846) * thickness) / p.wl;
    Cx r13 = cdiv(n1, n3), r12 = cdiv(n1, n2);
    Cx one = cx(1.0f, 0.0f);
    Cx cos3 = csqrt(csub(one, cmul(cmul(r13, r13), sin1_sq)));
    Cx cos2 = csqrt(csub(one, cmul(cmul(r12, r12), sin1_sq)));
    Cx n2c2 = cmul(n2, cos2);
    float u_ = n2c2.re, v_ = n2c2.im;

    Cx s_n1c1 = cmul(n1, cos1), s_n2c2 = n2c2, s_n3c3 = cmul(n3, cos3);
    float s_r, s_t;
    film(cdiv(csub(s_n1c1, s_n2c2), cadd(s_n1c1, s_n2c2)),
         cdiv(csub(s_n2c2, s_n3c3), cadd(s_n2c2, s_n3c3)),
         cdiv(cscale(2.0f, s_n1c1), cadd(s_n1c1, s_n2c2)),
         cdiv(cscale(2.0f, s_n2c2), cadd(s_n2c2, s_n3c3)),
         cdiv(s_n3c3, s_n1c1), u_, v_, e, &s_r, &s_t);
    Cx p_n2c1 = cmul(n2, cos1), p_n3c2 = cmul(n3, cos2);
    Cx p_n2c3 = cmul(n2, cos3), p_n1c2 = cmul(n1, cos2);
    float p_r, p_t;
    film(cdiv(csub(p_n2c1, p_n1c2), cadd(p_n2c1, p_n1c2)),
         cdiv(csub(p_n3c2, p_n2c3), cadd(p_n3c2, p_n2c3)),
         cdiv(cmul(cscale(2.0f, n1), cos1), cadd(p_n2c1, p_n1c2)),
         cdiv(cmul(cscale(2.0f, n2), cos2), cadd(p_n3c2, p_n2c3)),
         cdiv(cmul(n3, cos3), cmul(n1, cos1)), u_, v_, e, &p_r, &p_t);

    Incident ig = incident_geometry(p, s);
    float transmit = ig.s_fraction * s_t + (1.0f - ig.s_fraction) * p_t;
    transmit = transmissive ? transmit : 0.0f;
    float reflect = ig.s_fraction * s_r + (1.0f - ig.s_fraction) * p_r;
    float absorb = (1.0f - transmit) - reflect;

    bool forced = false;
    if (c.a.use_weights) {
        float probs[3] = {detect, reflect, transmit};
        weight_out(p, absorb, probs, 3);
        detect = probs[0]; reflect = probs[1]; transmit = probs[2];
        forced = detect > 0.0f;
        if (forced) p.w = p.w * detect;
    }
    float u = c.u01(S_CX_U);
    bool absorbs = (u < absorb) && !forced;
    float u_det = c.u01(S_CX_UDET);
    bool detects = (absorbs && (u_det < detect)) || forced;
    absorbs = absorbs && !detects;
    bool reflects = !absorbs && !detects
                    && ((u < absorb + reflect) || !transmissive);
    bool transmits = !absorbs && !detects && !reflects;
    float u_refl = c.u01(S_CX_UREFL);
    bool diffuses = reflects && (u_refl < rdiff);
    if (reflects) reflect_either(c, p, s, diffuses, S_CX_HEMI_U1);
    if (transmits) {
        float safe_refr = ig.tir ? 0.0f : ig.refr;
        p.dir = rotate(s.normal, PI_F - safe_refr, ig.ipn);
        p.pol = normalize(cross(ig.ipn, p.dir));
    }
    if (detects || forced) p.flags |= SURFACE_DETECT;
    if (absorbs) p.flags |= SURFACE_ABSORB;
    if (transmits) p.flags |= SURFACE_TRANSMIT;
    return (absorbs || detects) ? BREAK : CONTINUE;
}

__device__ int wls_surface(const Ctx& c, Photon& p, const State& s,
                           const float* sp, int sidx) {
    float absorb = sp[SURF_ABSORB], rspec = sp[SURF_RSPEC];
    float rdiff = sp[SURF_RDIFF], reemit = sp[SURF_REEMIT];
    if (c.a.use_weights) {
        float probs[2] = {rdiff, rspec};
        weight_out(p, absorb, probs, 2);
        rdiff = probs[0]; rspec = probs[1];
    }
    float u = c.u01(S_WLS_U);
    bool absorbs = u < absorb;
    float u_reemit = c.u01(S_WLS_UREEMIT);
    bool reemits = absorbs && (u_reemit < reemit);
    bool absorbs_dead = absorbs && !reemits;
    bool reflects = !absorbs && (u < (absorb + rspec) + rdiff);
    bool passes = !absorbs && !reflects;
    if (reemits) {
        p.wl = c.sample_cdf(T_SURF_CDF, c.a.n_wl, sidx, c.u01(S_WLS_WL),
                            c.a.wl0, c.a.wl_step, c.a.wl0_zero);
        p.dir = c.sphere(S_WLS_DIR_PHI, S_WLS_DIR_U);
        p.pol = c.perp_pol(S_WLS_POL_PHI, S_WLS_POL_U, p.dir);
    }
    if (reflects) {
        float u_refl = c.u01(S_WLS_UREFL) * (rspec + rdiff);
        reflect_either(c, p, s, u_refl >= rspec, S_WLS_HEMI_U1);
    }
    if (reemits) p.flags |= SURFACE_REEMIT;
    if (absorbs_dead) p.flags |= SURFACE_ABSORB;
    if (passes) p.flags |= SURFACE_TRANSMIT;
    return absorbs_dead ? BREAK : (passes ? PASS : CONTINUE);
}

// photon._interp_angle_rows on a padded per-row angle table (rows, nang)
__device__ void interp_angle(const Ctx& c, int t_angles, int t_nangles,
                             int nang, int row, float x, int* iidx,
                             float* frac) {
    const float* table = c.tf(t_angles) + (size_t)row * nang;
    int below = 0;
    for (int k = 0; k < nang; ++k) below += (__ldg(table + k) <= x);
    int i = below - 1 < 0 ? 0 : below - 1;
    int cap = __ldg(c.ti(t_nangles) + row) - 2;
    i = i < cap ? i : cap;
    float a_lo = __ldg(table + i), a_hi = __ldg(table + i + 1);
    *iidx = i;
    *frac = clampf((x - a_lo) / (a_hi > a_lo ? a_hi - a_lo : 1.0f),
                   0.0f, 1.0f);
}

__device__ int dichroic_surface(const Ctx& c, Photon& p, const State& s,
                                int sidx) {
    int didx = __ldg(c.ti(T_D_INDEX) + sidx);
    didx = didx < 0 ? 0 : didx;
    float inc = get_theta(s.normal, neg(p.dir));
    int iidx; float frac;
    interp_angle(c, T_D_ANGLES, T_D_NANGLES, c.a.d_nang, didx, inc, &iidx,
                 &frac);
    int row_lo = didx * c.a.d_nang + iidx;
    float lo, hi;
    lo = c.interp_row(T_D_REFLECT, c.a.n_wl, row_lo, p.wl, c.a.wl0,
                      c.a.wl_step);
    hi = c.interp_row(T_D_REFLECT, c.a.n_wl, row_lo + 1, p.wl, c.a.wl0,
                      c.a.wl_step);
    float reflect_prob = lo + (hi - lo) * frac;
    lo = c.interp_row(T_D_TRANSMIT, c.a.n_wl, row_lo, p.wl, c.a.wl0,
                      c.a.wl_step);
    hi = c.interp_row(T_D_TRANSMIT, c.a.n_wl, row_lo + 1, p.wl, c.a.wl0,
                      c.a.wl_step);
    float transmit_prob = lo + (hi - lo) * frac;
    float u = c.u01(S_DI_U);
    bool reflects = u < reflect_prob;
    bool transmits = !reflects && (u < reflect_prob + transmit_prob);
    bool absorbs = !reflects && !transmits;
    if (reflects) specular_reflect(p, s);
    if (transmits) p.flags |= SURFACE_TRANSMIT;
    if (absorbs) p.flags |= SURFACE_ABSORB;
    return absorbs ? BREAK : (transmits ? PASS : CONTINUE);
}

__device__ int angular_surface(const Ctx& c, Photon& p, const State& s,
                               int sidx) {
    int aidx = __ldg(c.ti(T_A_INDEX) + sidx);
    aidx = aidx < 0 ? 0 : aidx;
    float inc = get_theta(s.normal, neg(p.dir));
    int iidx; float frac;
    interp_angle(c, T_A_ANGLES, T_A_NANGLES, c.a.a_nang, aidx, inc, &iidx,
                 &frac);
    const size_t at = (size_t)aidx * c.a.a_nang + iidx;
    float lo, hi;
    lo = __ldg(c.tf(T_A_TRANSMIT) + at); hi = __ldg(c.tf(T_A_TRANSMIT) + at + 1);
    float transmit = lo + frac * (hi - lo);
    lo = __ldg(c.tf(T_A_RSPEC) + at); hi = __ldg(c.tf(T_A_RSPEC) + at + 1);
    float rspec = lo + frac * (hi - lo);
    lo = __ldg(c.tf(T_A_RDIFF) + at); hi = __ldg(c.tf(T_A_RDIFF) + at + 1);
    float rdiff = lo + frac * (hi - lo);
    float absorb = ((1.0f - transmit) - rspec) - rdiff;
    if (c.a.use_weights) {
        float probs[3] = {transmit, rspec, rdiff};
        weight_out(p, absorb, probs, 3);
        transmit = probs[0]; rspec = probs[1]; rdiff = probs[2];
    }
    float u = c.u01(S_AN_U);
    bool absorbs = u < absorb;
    bool transmits = !absorbs && (u < absorb + transmit);
    bool speculars = !absorbs && !transmits
                     && (u < (absorb + transmit) + rspec);
    bool diffuses = !absorbs && !transmits && !speculars;
    if (speculars || diffuses) reflect_either(c, p, s, diffuses,
                                              S_AN_HEMI_U1);
    if (absorbs) p.flags |= SURFACE_ABSORB;
    if (transmits) p.flags |= SURFACE_TRANSMIT;
    return absorbs ? BREAK : (transmits ? PASS : CONTINUE);
}

// photon.propagate_at_boundary: Fresnel reflect or refract
__device__ void fresnel(const Ctx& c, Photon& p, const State& s) {
    Incident ig = incident_geometry(p, s);
    bool s_polarized = c.u01(S_FR_SPOL) < ig.s_fraction;
    float sum_angle = ig.inc + ig.refr, diff_angle = ig.inc - ig.refr;
    float refl_s = -sinf(diff_angle) / sinf(sum_angle);
    float refl_p = tanf(diff_angle) / tanf(sum_angle);
    float refl = s_polarized ? refl_s : refl_p;
    float u = c.u01(S_FR_U);
    bool reflects = (u < refl * refl) || ig.tir;
    V3 new_dir;
    if (reflects) {
        new_dir = rotate(s.normal, ig.inc, ig.ipn);
    } else {
        float safe_refr = ig.tir ? 0.0f : ig.refr;
        new_dir = rotate(s.normal, PI_F - safe_refr, ig.ipn);
    }
    p.pol = s_polarized ? ig.ipn : normalize(cross(ig.ipn, new_dir));
    p.dir = new_dir;
    if (reflects) p.flags |= REFLECT_SPECULAR;
}

// ------------------------------------------------------------- the step

// The boundary classes of k2_post's phase B: a lane's surface model (the
// ids of `model`), or Fresnel alone (no surface, or no model drawn).
constexpr int C_FRESNEL = 5, N_CLASSES = 6;

__device__ __forceinline__ Photon load_photon(const StepArgs& a, int lane) {
    Photon p;
    p.pos = v3(a.pos[3 * lane], a.pos[3 * lane + 1], a.pos[3 * lane + 2]);
    p.dir = v3(a.dir[3 * lane], a.dir[3 * lane + 1], a.dir[3 * lane + 2]);
    p.pol = v3(a.pol[3 * lane], a.pol[3 * lane + 1], a.pol[3 * lane + 2]);
    p.wl = a.wl[lane];
    p.t = a.t[lane];
    p.w = a.weight[lane];
    p.flags = a.flags[lane];
    p.lht = a.lht[lane];
    p.cur_mat = a.cur_mat[lane];
    return p;
}

// the fields the boundary does not change: final after bulk transport
__device__ __forceinline__ void store_moved(const StepArgs& a, int lane,
                                            const Photon& p) {
    a.o_pos[3 * lane] = p.pos.x;
    a.o_pos[3 * lane + 1] = p.pos.y;
    a.o_pos[3 * lane + 2] = p.pos.z;
    a.o_t[lane] = p.t;
    a.o_lht[lane] = p.lht;
}

// the fields the boundary changes
__device__ __forceinline__ void store_turned(const StepArgs& a, int lane,
                                             const Photon& p) {
    a.o_dir[3 * lane] = p.dir.x;
    a.o_dir[3 * lane + 1] = p.dir.y;
    a.o_dir[3 * lane + 2] = p.dir.z;
    a.o_pol[3 * lane] = p.pol.x;
    a.o_pol[3 * lane + 1] = p.pol.y;
    a.o_pol[3 * lane + 2] = p.pol.z;
    a.o_wl[lane] = p.wl;
    a.o_weight[lane] = p.w;
    a.o_flags[lane] = p.flags;
    a.o_cur_mat[lane] = p.cur_mat;
}

// The step up to the boundary: photon.decode_state and bulk transport
// (photon.propagate_to_boundary with reemission, weights, scatter_first).
// Returns the lane's boundary class, or -1 when its step ends here (p is
// then the lane's result: inactive, no hit, absorbed, scattered or
// reemitted); s is set for a lane that reaches the boundary.
__device__ int to_boundary(const Ctx& c, Photon& p, State& s) {
    const StepArgs& a = c.a;
    const int lane = c.lane;
    const bool active = a.active[lane] != 0;
    if (active) {
        // ---- photon.decode_state: the boundary context
        const bool pruned = a.pruned != nullptr && a.pruned[lane] != 0;
        const int tri = a.tri[lane];
        float dist = a.dist[lane];
        const int code = a.code[lane];
        V3 nv = v3(a.nvec[3 * lane], a.nvec[3 * lane + 1],
                   a.nvec[3 * lane + 2]);
        const bool hit = tri >= 0;

        bool use_analytic = false;
        int w_plane = 0;
        float w_t = 0.0f;
        V3 w_normal = v3(0.0f, 0.0f, 0.0f);
        bool w_outside = false;
        int w_surf = -1;
        if (a.w_t != nullptr) {
            // wireplane.classify of K3's walk
            w_t = a.w_t[lane];
            const int bp = a.w_plane[lane];
            w_plane = bp < 0 ? 0 : bp;
            const float vn = a.w_vn[lane], nn = a.w_nn[lane];
            const float length = sqrtf(fmaf(vn, vn, nn * nn));
            const float inv_len = 1.0f / (length > 0.0f ? length : 1.0f);
            const float* wv = c.tf(T_WIRE_V) + 3 * w_plane;
            const float* ww = c.tf(T_WIRE_W) + 3 * w_plane;
            const float a1 = vn * inv_len, a2 = nn * inv_len;
            V3 n_world = v3(fmaf(a1, __ldg(wv), a2 * __ldg(ww)),
                            fmaf(a1, __ldg(wv + 1), a2 * __ldg(ww + 1)),
                            fmaf(a1, __ldg(wv + 2), a2 * __ldg(ww + 2)));
            w_outside = dot(n_world, neg(p.dir)) > 0.0f;
            w_normal = w_outside ? n_world : neg(n_world);
            w_surf = __ldg(c.ti(T_WIRE_SURFACE) + w_plane);
            const float best = hit ? dist : 1e30f;
            use_analytic = bp >= 0 && w_surf >= 0 && (w_t + 1e-6f < best);
        }
        const bool any_hit = hit || use_analytic;

        if (a.has_inst) {
            int iid = a.iid[lane];
            if (iid < 0) iid += a.n_inst;
            const float* R = c.tf(T_ROT) + 9 * iid;
            float r[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) r[k] = __ldg(R + k);
            nv = v3((r[0] * nv.x + r[1] * nv.y) + r[2] * nv.z,
                    (r[3] * nv.x + r[4] * nv.y) + r[5] * nv.z,
                    (r[6] * nv.x + r[7] * nv.y) + r[8] * nv.z);
        }
        const float ln = sqrtf(dot(nv, nv));
        const float lnd = ln > 0.0f ? ln : 1.0f;
        const V3 face = v3(nv.x / lnd, nv.y / lnd, nv.z / lnd);
        const int inner = sext8(code >> 24);
        const int outer = sext8(code >> 16);

        s.surf = sext8(code >> 8);
        const bool outside = dot(face, neg(p.dir)) > 0.0f;
        s.normal = outside ? face : neg(face);
        s.mat1 = outside ? outer : inner;
        s.mat2 = outside ? inner : outer;
        if (use_analytic) {
            dist = w_t;
            s.normal = w_normal;
            const int mi = __ldg(c.ti(T_WIRE_INNER) + w_plane);
            const int mo = __ldg(c.ti(T_WIRE_OUTER) + w_plane);
            s.mat1 = w_outside ? mo : mi;
            s.mat2 = w_outside ? mi : mo;
            s.surf = w_surf;
        }
        s.dist = dist;
        if (!any_hit) { s.mat1 = 0; s.mat2 = 0; }

        int jl; float frac;
        c.grid(p.wl, a.wl0, a.wl_step, a.n_wl, &jl, &frac);
        s.rindex1 = c.mat_prop(s.mat1, MAT_RI, jl, frac);
        s.abslen = c.mat_prop(s.mat1, MAT_ABS, jl, frac);
        s.scatlen = c.mat_prop(s.mat1, MAT_SCAT, jl, frac);
        s.rindex2 = c.mat_prop(s.mat2, MAT_RI, jl, frac);
        if (a.prune && p.cur_mat >= 0) {
            // the current medium's properties, which the interaction
            // distances of the pruning limit were sampled from
            s.rindex1 = c.mat_prop(p.cur_mat, MAT_RI, jl, frac);
            s.abslen = c.mat_prop(p.cur_mat, MAT_ABS, jl, frac);
            s.scatlen = c.mat_prop(p.cur_mat, MAT_SCAT, jl, frac);
            s.mat1 = p.cur_mat;
        }
        if (!any_hit && !pruned) p.flags |= NO_HIT;
        int new_last = hit ? tri : -1;
        if (use_analytic) new_last = -2;
        p.lht = new_last;

        if (any_hit || pruned) {
            // ---- photon.propagate_to_boundary
            const float d_bound = s.dist;
            float absorption_distance = -s.abslen * logf(c.u01(S_ABS));
            float scattering_distance = -s.scatlen * logf(c.u01(S_SCAT));
            const bool lane_weighted = a.use_weights && p.w > WEIGHT_LOWER;
            if (lane_weighted) absorption_distance = 1e30f;
            float w = p.w;
            const float u_force = c.u01(S_FORCE);
            if (a.scatter_first == 1) {
                const float scatter_prob =
                    1.0f - expf(-d_bound / s.scatlen);
                if (scatter_prob > WEIGHT_LOWER) {
                    scattering_distance =
                        -s.scatlen * log1pf(-u_force * scatter_prob);
                    w = w * scatter_prob;
                } else {
                    w = w * 1.0f;
                }
            } else if (a.scatter_first == -1) {
                const float no_scatter_prob = expf(-d_bound / s.scatlen);
                if (no_scatter_prob > WEIGHT_LOWER) {
                    scattering_distance = d_bound - s.scatlen * logf(u_force);
                    w = w * no_scatter_prob;
                } else {
                    w = w * 1.0f;
                }
            }
            const bool absorb_first =
                absorption_distance <= scattering_distance;
            const bool absorbed =
                absorb_first && (absorption_distance <= d_bound);
            const bool scattered =
                !absorb_first && (scattering_distance <= d_bound);
            const bool passed = !absorbed && !scattered;
            const float step_dist = absorbed ? absorption_distance
                : (scattered ? scattering_distance : d_bound);
            const float speed = (1.0f / s.rindex1) * SPEED_OF_LIGHT;
            float new_t = p.t + step_dist / speed;
            p.pos = v3(p.pos.x + step_dist * p.dir.x,
                       p.pos.y + step_dist * p.dir.y,
                       p.pos.z + step_dist * p.dir.z);

            bool reemits = false;
            float re_wl = 0.0f, re_dt = 0.0f;
            if (a.has_reemission && absorbed) {
                // photon._reemission
                const int mat = s.mat1;
                const int num_comp = __ldg(c.ti(T_NUM_COMP) + mat);
                const int maxc = a.maxc;
                const float u_comp = c.u01(S_RE_COMP);
                float cum = 0.0f;
                int comp = 0;
                bool found = false;
                for (int k = 0; k < maxc; ++k) {
                    const float comp_abs = c.interp_row(
                        T_COMP_ABS, a.n_wl, mat * maxc + k, p.wl, a.wl0,
                        a.wl_step);
                    const float q = s.abslen / comp_abs;
                    cum = k == 0 ? q : cum + q;
                    if (!found && ((u_comp < cum) || k == num_comp - 1)) {
                        comp = k;
                        found = true;
                    }
                }
                const float reemit_prob = c.interp_row(
                    T_COMP_PROB, a.n_wl, mat * maxc + comp, p.wl, a.wl0,
                    a.wl_step);
                reemits = (num_comp > 0) && (c.u01(S_RE_REEMIT) < reemit_prob);
                if (reemits) {
                    const int row = mat * maxc + comp;
                    re_wl = c.sample_cdf(T_COMP_WVL, a.n_wl, row,
                                         c.u01(S_RE_WL), a.wl0, a.wl_step,
                                         a.wl0_zero);
                    re_dt = c.sample_cdf(T_COMP_TIME, a.n_t, row,
                                         c.u01(S_RE_TIME), a.time0,
                                         a.time_step, a.t0_zero);
                    p.dir = c.sphere(S_RE_DIR_PHI, S_RE_DIR_U);
                    p.pol = c.perp_pol(S_RE_POL_PHI, S_RE_POL_U, p.dir);
                }
            }
            if (scattered) {
                // photon.rayleigh_scatter
                const float u = c.u01(S_RAY_U);
                float cos_theta = 2.0f * cosf(divs(
                    acosf(1.0f - 2.0f * u) - TWO_PI_F, 3.0f));
                cos_theta = clampf(cos_theta, -1.0f, 1.0f);
                const float theta = acosf(cos_theta);
                const float phi = c.u2pi(S_RAY_PHI);
                const V3 new_dir = pick_new_direction(p.pol, theta, phi);
                V3 new_pol;
                if ((1.0f - fabsf(cos_theta)) < 1e-6f) {
                    new_pol = pick_new_direction(p.pol, PI_F / 2.0f, phi);
                } else {
                    new_pol = v3(p.pol.x - cos_theta * new_dir.x,
                                 p.pol.y - cos_theta * new_dir.y,
                                 p.pol.z - cos_theta * new_dir.z);
                }
                p.dir = normalize(new_dir);
                p.pol = normalize(new_pol);
            }
            if (a.has_reemission) {
                if (reemits) p.wl = re_wl;
                new_t = new_t + (reemits ? re_dt : 0.0f);
                if (reemits) p.flags |= BULK_REEMIT;
            }
            const bool bulk_absorbed = absorbed && !reemits;
            if (bulk_absorbed) p.flags |= BULK_ABSORB;
            if (scattered) p.flags |= RAYLEIGH_SCATTER;
            if (a.use_weights) {
                const float surv = expf(-step_dist / s.abslen);
                w = w * ((lane_weighted && (scattered || passed)) ? surv
                                                                  : 1.0f);
            }
            p.t = new_t;
            p.w = w;
            if (!passed) {
                p.lht = -1;
                p.cur_mat = s.mat1;
                return -1;
            }
            // ---- at the boundary: the lane's surface model, or Fresnel
            if (s.surf == -1) return C_FRESNEL;
            const int sidx = s.surf < 0 ? 0 : s.surf;
            const int model = __ldg(c.ti(T_MODEL) + sidx);
            if (model == SURFACE_COMPLEX && c.present(S_CX_U))
                return SURFACE_COMPLEX;
            if (model == SURFACE_WLS && c.present(S_WLS_U))
                return SURFACE_WLS;
            if (model == SURFACE_DICHROIC && c.present(S_DI_U))
                return SURFACE_DICHROIC;
            if (model == SURFACE_ANGULAR && c.present(S_AN_U))
                return SURFACE_ANGULAR;
            if (c.present(S_DEF_U)) return SURFACE_DEFAULT;
            return C_FRESNEL;
        }
    }
    return -1;
}

// At the boundary: the lane's surface model of class `cls`
// (photon.propagate_at_surface), then Fresnel if it passes, then medium
// tracking: through the boundary plane -> material2.
__device__ void at_boundary(const Ctx& c, Photon& p, const State& s,
                            int cls) {
    const StepArgs& a = c.a;
    int cmd = PASS;
    if (cls != C_FRESNEL) {
        const int sidx = s.surf < 0 ? 0 : s.surf;
        float sp[7];
        if (sidx < a.n_surf) {
            int sjl; float sfrac;
            c.grid(p.wl, a.wl0, a.wl_step, a.n_wl, &sjl, &sfrac);
#pragma unroll
            for (int k = 0; k < 7; ++k)
                sp[k] = c.wl_row(T_SURF_WL, a.n_surf, 8, sidx, k, sjl, sfrac);
        } else {
#pragma unroll
            for (int k = 0; k < 7; ++k) sp[k] = 0.0f;
        }
        if (cls == SURFACE_COMPLEX) {
            cmd = complex_surface(c, p, s, sp, __ldg(c.tf(T_THICKNESS) + sidx),
                                  __ldg(c.ti(T_TRANSMISSIVE) + sidx) != 0);
        } else if (cls == SURFACE_WLS) {
            cmd = wls_surface(c, p, s, sp, sidx);
        } else if (cls == SURFACE_DICHROIC) {
            cmd = dichroic_surface(c, p, s, sidx);
        } else if (cls == SURFACE_ANGULAR) {
            cmd = angular_surface(c, p, s, sidx);
        } else {
            cmd = default_surface(c, p, s, sp);
        }
    }
    if (cmd == PASS) fresnel(c, p, s);
    const bool crossed = dot(p.dir, s.normal) < 0.0f;
    p.cur_mat = crossed ? s.mat2 : s.mat1;
}

// ------------------------------------------ k2_post, regrouped by path

// What phase B reads of a boundary lane, in shared memory by slot:
// f32 words (direction, polarization, wavelength, weight, the boundary
// normal, the two refractive indices) and i32 words (flags, the two
// materials, the surface, and the lane's thread | its class << 16).
enum StashF { F_DIR = 0, F_POL = 3, F_WL = 6, F_W = 7, F_NORMAL = 8,
              F_RI1 = 11, F_RI2 = 12, N_STASH_F = 13 };
enum StashI { I_FLAGS, I_MAT1, I_MAT2, I_SURF, I_META, N_STASH_I };
constexpr int MAX_BLOCK = 256;

__host__ __device__ __forceinline__ int post_smem_bytes(int block) {
    return 4 * (block * (N_STASH_F + N_STASH_I)
                + 2 * (block / 32) * N_CLASSES + 1);
}

__global__ void __launch_bounds__(MAX_BLOCK)
step_kernel(const __grid_constant__ StepArgs a) {
    extern __shared__ int smem[];
    const int nb = blockDim.x, tid = threadIdx.x;
    const int base = blockIdx.x * nb, lane = base + tid;
    const int warp = tid >> 5, wl = tid & 31, nwarps = nb >> 5;
    float* sf = reinterpret_cast<float*>(smem);     // [N_STASH_F][nb]
    int* si = smem + N_STASH_F * nb;                // [N_STASH_I][nb]
    int* count = si + N_STASH_I * nb;               // [nwarps][N_CLASSES]
    int* start = count + nwarps * N_CLASSES;        // [nwarps][N_CLASSES]
    int* n_boundary = start + nwarps * N_CLASSES;

    // phase A: a thread a lane up to the boundary
    int cls = -1;
    Photon p;
    State s;
    if (lane < a.n) {
        const Ctx c(a, lane);
        p = load_photon(a, lane);
        cls = to_boundary(c, p, s);
        store_moved(a, lane, p);
        if (cls < 0) store_turned(a, lane, p);
    }

    // regroup: the block's classes counted and scanned, a slot a lane
    const unsigned below = (1u << wl) - 1u;
    int rank = 0;
    for (int k = 0; k < N_CLASSES; ++k) {
        const unsigned m = __ballot_sync(0xffffffffu, cls == k);
        if (cls == k) rank = __popc(m & below);
        if (wl == 0) count[warp * N_CLASSES + k] = __popc(m);
    }
    __syncthreads();
    if (tid == 0) {
        int run = 0;
        for (int k = 0; k < N_CLASSES; ++k)
            for (int w = 0; w < nwarps; ++w) {
                start[w * N_CLASSES + k] = run;
                run += count[w * N_CLASSES + k];
            }
        *n_boundary = run;
    }
    __syncthreads();
    if (cls >= 0) {
        const int slot = start[warp * N_CLASSES + cls] + rank;
        sf[(F_DIR + 0) * nb + slot] = p.dir.x;
        sf[(F_DIR + 1) * nb + slot] = p.dir.y;
        sf[(F_DIR + 2) * nb + slot] = p.dir.z;
        sf[(F_POL + 0) * nb + slot] = p.pol.x;
        sf[(F_POL + 1) * nb + slot] = p.pol.y;
        sf[(F_POL + 2) * nb + slot] = p.pol.z;
        sf[F_WL * nb + slot] = p.wl;
        sf[F_W * nb + slot] = p.w;
        sf[(F_NORMAL + 0) * nb + slot] = s.normal.x;
        sf[(F_NORMAL + 1) * nb + slot] = s.normal.y;
        sf[(F_NORMAL + 2) * nb + slot] = s.normal.z;
        sf[F_RI1 * nb + slot] = s.rindex1;
        sf[F_RI2 * nb + slot] = s.rindex2;
        si[I_FLAGS * nb + slot] = p.flags;
        si[I_MAT1 * nb + slot] = s.mat1;
        si[I_MAT2 * nb + slot] = s.mat2;
        si[I_SURF * nb + slot] = s.surf;
        si[I_META * nb + slot] = tid | (cls << 16);
    }
    __syncthreads();

    // phase B: thread i takes slot i, its lane's boundary
    if (tid < *n_boundary) {
        const int meta = si[I_META * nb + tid];
        const int l = base + (meta & 0xffff);
        Photon q;
        q.pos = v3(0.0f, 0.0f, 0.0f);
        q.dir = v3(sf[(F_DIR + 0) * nb + tid], sf[(F_DIR + 1) * nb + tid],
                   sf[(F_DIR + 2) * nb + tid]);
        q.pol = v3(sf[(F_POL + 0) * nb + tid], sf[(F_POL + 1) * nb + tid],
                   sf[(F_POL + 2) * nb + tid]);
        q.wl = sf[F_WL * nb + tid];
        q.t = 0.0f;
        q.w = sf[F_W * nb + tid];
        q.flags = si[I_FLAGS * nb + tid];
        q.lht = 0;
        q.cur_mat = 0;
        State b;
        b.dist = b.abslen = b.scatlen = 0.0f;
        b.normal = v3(sf[(F_NORMAL + 0) * nb + tid],
                      sf[(F_NORMAL + 1) * nb + tid],
                      sf[(F_NORMAL + 2) * nb + tid]);
        b.rindex1 = sf[F_RI1 * nb + tid];
        b.rindex2 = sf[F_RI2 * nb + tid];
        b.mat1 = si[I_MAT1 * nb + tid];
        b.mat2 = si[I_MAT2 * nb + tid];
        b.surf = si[I_SURF * nb + tid];
        const Ctx c(a, l);
        at_boundary(c, q, b, meta >> 16);
        store_turned(a, l, q);
    }
}

// ------------------------------------------------------------- k2_pre

// photon.step_prologue after its uniform blocks, one thread a lane: the
// NaN guard, the active lanes and, with pruning, the interaction distance
// that bounds the traversal (the current medium's lengths at the lane's
// wavelength, sampled from streams 0 and 1 as DrawPool.draw maps them).
__global__ void __launch_bounds__(128)
pre_kernel(const __grid_constant__ PreArgs a) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= a.n) return;
    int flags = a.flags[lane];
    const bool alive = (flags & TERMINAL) == 0;
    // dir.sum(-1) + pos.sum(-1)
    const float sum = ((a.dir[3 * lane] + a.dir[3 * lane + 1])
                       + a.dir[3 * lane + 2])
                      + ((a.pos[3 * lane] + a.pos[3 * lane + 1])
                         + a.pos[3 * lane + 2]);
    const bool nan_abort = alive && (sum != sum);
    if (nan_abort) flags |= NO_HIT | NAN_ABORT;
    const bool active = alive && !nan_abort;
    a.o_flags[lane] = flags;
    a.o_active[lane] = active;
    if (a.o_pruned == nullptr) return;
    const int mat = a.cur_mat[lane];
    const int safe = mat < 0 ? 0 : mat;
    float abslen = 0.0f, scatlen = 0.0f;       // select_rows: 0 outside
    if (safe < a.n_mat) {
        int jl; float frac;
        lerp_grid(a.wl[lane], a.wl0, a.wl_step, a.n_wl, &jl, &frac);
        abslen = lerp_row(a.mat_wl, a.n_mat, 3, safe, MAT_ABS, jl, frac);
        scatlen = lerp_row(a.mat_wl, a.n_mat, 3, safe, MAT_SCAT, jl, frac);
    }
    const float pre_abs = -abslen * logf(1.0f - __ldg(a.u + lane) * 1.0f);
    const float pre_scat =
        -scatlen * logf(1.0f - __ldg(a.u + (size_t)a.n + lane) * 1.0f);
    const float interaction = nan_min(pre_abs, pre_scat);
    // near-vacuum media stay unpruned; the Python scalars in f32
    const bool pruned = active && mat >= 0 && interaction < (float)1e20;
    a.o_pruned[lane] = pruned;
    a.o_limit[lane] = pruned ? interaction * (float)(1.0 + 1e-4)
                             : __int_as_float(0x7f800000);
}

}  // namespace

// Loads the kernels now (CUDA's lazy loading would otherwise load each at
// its first launch, which may be inside a graph capture).
extern "C" int chroma_step_load() {
    cudaFuncAttributes attr;
    int err = (int)cudaFuncGetAttributes(&attr, step_kernel);
    if (!err) err = (int)cudaFuncGetAttributes(&attr, pre_kernel);
    return err;
}

// sizeof(StepArgs) and sizeof(PreArgs), which the wrapper checks against
// its own layouts.
extern "C" int chroma_step_args_size() { return (int)sizeof(StepArgs); }
extern "C" int chroma_step_pre_args_size() { return (int)sizeof(PreArgs); }

// k2_post: one launch over args.n lanes in blocks of `block` (a multiple
// of 32, at most MAX_BLOCK) on `stream`; returns cudaGetLastError().
extern "C" int chroma_step(StepArgs args, int block, void* stream) {
    if (args.n <= 0) return (int)cudaSuccess;
    if (block < 32 || block > MAX_BLOCK || block % 32 != 0)
        return (int)cudaErrorInvalidValue;
    step_kernel<<<(args.n + block - 1) / block, block,
                  post_smem_bytes(block), (cudaStream_t)stream>>>(args);
    return (int)cudaGetLastError();
}

// k2_pre: one launch over args.n lanes on `stream`.
extern "C" int chroma_step_pre(PreArgs args, void* stream) {
    if (args.n <= 0) return (int)cudaSuccess;
    const int threads = 128;
    pre_kernel<<<(args.n + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(args);
    return (int)cudaGetLastError();
}
