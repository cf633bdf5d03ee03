// K4: the DAQ readout of a propagated batch, all of its replicas in one
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's readout, chroma_tpu/ops/daq.py::_daq_block
// (:70-106, called per block of DAQ_BLOCK replicas by run_daq, :109-146):
// XLA's segment_min, segment_sum and per-bit segment_max over every
// (replica, photon) pair, the pairs that do not count sent to an overflow
// segment. It does what Chroma's own chroma/cuda/daq.cu does (run_daq and
// run_daq_many, :35-150): one pass over the photons, an undetected photon
// leaves at once, a kept one does an atomicMin on a sortable int of its
// time, an atomicAdd of its charge and an atomicOr of its history. The
// contract is that of the plain PyTorch twin
// chroma_tpu_torch/ops/daq.py::readout_plain, bit for bit: a photon's
// channel is photon_channels_device's (its last triangle's solid, by the
// instances' triangle ranges or the per-triangle solid ids, through the
// detector's channel map, when a `detection_state` flag bit is set); for
// replica r (draw block b = r / rows, row r - b * rows, sites keep, time,
// charge of the (blocks, 3, rows, N) U[0, 1) draws) a photon on a channel
// is kept when 1 - u_keep < weight * global_weight; its time is t + the
// time CDF at 1 - u_time, its charge count rint(the charge CDF at
// 1 - u_charge / unit). The sampler is ops/sample.py::sample_cdf_pairs
// to the bit: searchsorted right, the index clamped to [1, n - 1], the
// IEEE quotient, the f64 lerp rounded once to f32, the flat-step, below-
// and above-range rules. Built with --fmad=false and no fast math; the
// division by the unit is a true division. The min, the 64-bit integer
// sum and the OR do not depend on the order in which the atomics land, so
// the result is deterministic.
//
// Times can be negative (the jitter reaches -5 rms), so the earliest time
// is kept as Chroma's sortable int: a float's bits, with the magnitude
// bits flipped for negative floats, order as signed ints as the floats do.
// Counts are 64-bit: one channel of a 2^22-photon bomb can pass 2^31
// units of 1.5 / 2^16 pe.
//
// What bounds it. A readout must read every photon's last triangle and
// flags, a detected photon's time and weight, each detected pair's keep
// draw and each kept pair's time and charge draws, and write 12 bytes a
// replica and channel. Counted in the 32-byte sectors those reads touch
// (chip_smoke.py's k4_bytes) that is 68 MB, 20 us at 3.35 TB/s, for the
// bomb's one replica of 2^22 photons (6.4% of them detected), and 3 MB,
// 0.9 us, for the likelihood's 50 replicas of 10^4. The arithmetic is a
// binary search over the instances' triangle ranges and two over CDF
// tables of tens of entries: bytes bound it.
//
// What the design does about it. A thread takes one photon and a group of
// REPS replicas (a 1-D grid over photon blocks x replica groups, the
// photon blocks grid-strided past TARGET_BLOCKS so the tables are staged
// a limited number of times): an undetected photon, most of them, costs
// its 8 bytes of triangle and flags and no draw; a detected one finds its
// channel once for the group and then, replica by replica, reads its keep
// draw and, when kept, the two others, coalesced across the warp
// (neighbouring lanes read neighbouring photons of the same row). The
// four CDF tables and the unit are staged in shared memory when they fit
// in 48 KB, else read through the cache. Contention: a warp's photons are
// in no channel order, so its atomics hit about as many channels as it
// has kept lanes, spread over all 630 channels of the quick detector. On
// an H100 (SXM, 700 W) K4 takes 4.5 times its bound at 2^22 photons, and
// not for contention: with each channel's atomics spread over 64 copies
// it is 3% faster, and with the channel rows privatised in shared memory
// (flushed once a block) 20% slower or more at every grid size tried;
// nor for the grid (512 to 65,536 blocks). What is left is the latency
// of a detected photon's chain of dependent reads (triangle, channel,
// draws, the CDF searches), so the rows stay in global memory. At 50 x
// 10^4 the fixed cost of its three launches sets its 17 us. Mapping the
// triangles here, not in torch ops before the launch, leaves a readout's
// host work at the draws' fills and one call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libdaq_kernel.so
//        daq_kernel.cu
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int REPS = 4;                 // replicas a thread reads out
constexpr int TARGET_BLOCKS = 2048;     // about 16 blocks an SM
constexpr int MAX_STAGED = 12288;       // table floats in 48 KB of shared
constexpr float MAX_TIME = 1e9f;        // "no hit" (ops/daq.py MAX_TIME)
// np.spacing(np.finfo(np.float32).eps) = 2^-46: a flat CDF step
constexpr float FLAT_STEP = 1.4210854715202004e-14f;

__device__ __forceinline__ int sortable(float f) {
    const int i = __float_as_int(f);
    return i < 0 ? i ^ 0x7fffffff : i;
}

__device__ __forceinline__ float unsortable(int i) {
    return __int_as_float(i < 0 ? i ^ 0x7fffffff : i);
}

// torch.searchsorted(sorted[:n], v, right=True): the first index whose
// element is above v
template <class T>
__device__ __forceinline__ int upper_bound(const T* sorted, int n, T v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(sorted[mid] > v)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// ops/sample.py::sample_cdf_pairs(u, val, cdf) for one u: linear
// interpolation of u against the ascending `cdf`, giving `val`'s values
__device__ __forceinline__ float sample_cdf(float u, const float* val,
                                            const float* cdf, int n) {
    const int lo = upper_bound(cdf, n, u);
    const int i = lo < 1 ? 1 : (lo > n - 1 ? n - 1 : lo);
    const float c_lo = cdf[i - 1];
    const float v_lo = val[i - 1];
    const float dv = val[i] - v_lo;
    const float dc = cdf[i] - c_lo;
    const float delta = u - c_lo;
    const bool flat = fabsf(dc) <= FLAT_STEP;
    const float q = delta / (flat ? 1.0f : dc);
    const float lerp = (float)((double)v_lo + (double)q * (double)dv);
    float f = flat ? v_lo : lerp;
    if (u < cdf[0]) f = val[0];
    if (u > cdf[n - 1]) f = val[n - 1];
    return f;
}

// Each (replica, channel) slot: no hit, no charge, no history.
__global__ void __launch_bounds__(THREADS)
daq_init_kernel(int m, int blocks, int* __restrict__ earliest,
                unsigned long long* __restrict__ count,
                int* __restrict__ history) {
    const int none = sortable(MAX_TIME);
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < m;
         i += blocks * THREADS) {
        earliest[i] = none;
        count[i] = 0ull;
        history[i] = 0;
    }
}

// The channel of a photon that ended on a channel's triangle with a
// `detection_state` flag bit, else -1 (ops/daq.py::photon_channels_device):
// the triangle's solid is the instance whose range [tri_base[i],
// tri_base[i + 1]) holds it (torch.searchsorted right, minus one), or
// solid_id[tri] where the geometry has no instances.
__device__ __forceinline__ int photon_channel(
        int tri, int fl, int detection_state, const int* tri_base,
        int n_base, const int* solid_id, const int* solid_channel,
        int n_solids) {
    if (tri < 0 || !(fl & detection_state)) return -1;
    const int solid = tri_base ? upper_bound(tri_base, n_base, tri) - 1
                               : solid_id[tri];
    return solid >= 0 && solid < n_solids ? solid_channel[solid] : -1;
}

// K4. tables: time x, time cdf (n_time each), charge x, charge cdf
// (n_charge each), then the charge unit; draws: (blocks, 3, rows, n).
// Block k reads out photon block k % blocks_x (grid-strided by
// blocks_x) for replicas REPS * (k / blocks_x) on.
__global__ void __launch_bounds__(THREADS)
daq_kernel(const int* __restrict__ last_tri, const int* __restrict__ flags,
           const float* __restrict__ t, const float* __restrict__ weight,
           const int* __restrict__ tri_base, int n_base,
           const int* __restrict__ solid_id,
           const int* __restrict__ solid_channel, int n_solids,
           int detection_state, const float* __restrict__ draws,
           const float* __restrict__ tables, int n_time, int n_charge,
           int staged, float global_weight, int ndaq, int rows, int n,
           int nchannels, int blocks_x, int* __restrict__ earliest,
           unsigned long long* __restrict__ count,
           int* __restrict__ history) {
    extern __shared__ float staged_tables[];
    const int n_tab = 2 * (n_time + n_charge);
    const float unit = tables[n_tab];
    const float* tab = tables;
    if (staged) {
        for (int k = threadIdx.x; k < n_tab; k += THREADS)
            staged_tables[k] = tables[k];
        __syncthreads();
        tab = staged_tables;
    }
    const float* time_x = tab;
    const float* time_cdf = tab + n_time;
    const float* charge_x = tab + 2 * n_time;
    const float* charge_cdf = charge_x + n_charge;

    const int group = blockIdx.x / blocks_x;
    const int r0 = group * REPS;
    const int r1 = r0 + REPS < ndaq ? r0 + REPS : ndaq;
    const size_t site = (size_t)rows * n;     // one site's (rows, n) draws
    for (int p = (blockIdx.x - group * blocks_x) * THREADS + threadIdx.x;
         p < n; p += blocks_x * THREADS) {
        const int fp = flags[p];
        const int ch = photon_channel(last_tri[p], fp, detection_state,
                                      tri_base, n_base, solid_id,
                                      solid_channel, n_solids);
        if (ch < 0 || ch >= nchannels) continue;  // no draw, no atomic
        const float tp = t[p];
        const float keep_below = weight[p] * global_weight;
        for (int r = r0; r < r1; ++r) {
            const int b = r / rows;
            const size_t at = ((size_t)(3 * b) * rows + (r - b * rows)) * n
                              + p;
            if (!(1.0f - draws[at] < keep_below)) continue;
            const float jitter = sample_cdf(1.0f - draws[at + site], time_x,
                                            time_cdf, n_time);
            const float charge = sample_cdf(1.0f - draws[at + 2 * site],
                                            charge_x, charge_cdf, n_charge);
            const long long units = (long long)rintf(charge / unit);
            const int slot = r * nchannels + ch;
            atomicMin(earliest + slot, sortable(tp + jitter));
            atomicAdd(count + slot, (unsigned long long)units);
            atomicOr(history + slot, fp);
        }
    }
}

// The slots as ChannelArrays: the sortable ints back to floats in place,
// the counts times the unit.
__global__ void __launch_bounds__(THREADS)
daq_finish_kernel(int m, int blocks, const float* __restrict__ tables,
                  int n_tab, int* __restrict__ earliest,
                  const unsigned long long* __restrict__ count,
                  float* __restrict__ charge) {
    const float unit = tables[n_tab];
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < m;
         i += blocks * THREADS) {
        earliest[i] = __float_as_int(unsortable(earliest[i]));
        charge[i] = (float)(long long)count[i] * unit;
    }
}

int blocks_for(long long items, long long cap) {
    const long long b = (items + THREADS - 1) / THREADS;
    return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

}  // namespace

// Loads the kernels' module now, not at the first launch.
extern "C" int chroma_daq_load() {
    cudaFuncAttributes attr;
    int err = (int)cudaFuncGetAttributes(&attr, daq_init_kernel);
    if (!err) err = (int)cudaFuncGetAttributes(&attr, daq_kernel);
    if (!err) err = (int)cudaFuncGetAttributes(&attr, daq_finish_kernel);
    return err;
}

// Init, K4 and finish on `stream`. Per photon: last_tri, flags (i32),
// t, weight (f32); the geometry's tri_base (n_base i32, null without
// instances) or solid_id (a solid a triangle), solid_channel (n_solids
// i32); tables and draws as daq_kernel reads them. Out: earliest
// (ndaq * nchannels) i32 slots that come back as the f32 earliest times,
// count (ndaq * nchannels) u64 scratch, history i32 and charge f32.
// Returns cudaGetLastError() after the first launch that fails, else
// after the last.
extern "C" int chroma_daq(const int* last_tri, const int* flags,
                          const float* t, const float* weight,
                          const int* tri_base, int n_base,
                          const int* solid_id, const int* solid_channel,
                          int n_solids, int detection_state,
                          const float* draws, const float* tables,
                          int n_time, int n_charge, float global_weight,
                          int ndaq, int rows, int n, int nchannels,
                          int* earliest, unsigned long long* count,
                          int* history, float* charge, void* stream) {
    if (ndaq <= 0 || nchannels <= 0 || rows <= 0 || n_time < 2
        || n_charge < 2 || (tri_base == nullptr) == (solid_id == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int m = ndaq * nchannels;
    const int slot_blocks = blocks_for(m, TARGET_BLOCKS);
    daq_init_kernel<<<slot_blocks, THREADS, 0, s>>>(m, slot_blocks, earliest,
                                                   count, history);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (n > 0) {
        const int groups = (ndaq + REPS - 1) / REPS;
        const int cap = TARGET_BLOCKS / groups > 1 ? TARGET_BLOCKS / groups
                                                   : 1;
        const int blocks_x = blocks_for(n, cap);
        const int n_tab = 2 * (n_time + n_charge);
        const int staged = n_tab <= MAX_STAGED;
        daq_kernel<<<blocks_x * groups, THREADS,
                     staged ? n_tab * sizeof(float) : 0, s>>>(
            last_tri, flags, t, weight, tri_base, n_base, solid_id,
            solid_channel, n_solids, detection_state, draws, tables, n_time,
            n_charge, staged, global_weight, ndaq, rows, n, nchannels,
            blocks_x, earliest, count, history);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    daq_finish_kernel<<<slot_blocks, THREADS, 0, s>>>(
        m, slot_blocks, tables, 2 * (n_time + n_charge), earliest, count,
        charge);
    return (int)cudaGetLastError();
}
