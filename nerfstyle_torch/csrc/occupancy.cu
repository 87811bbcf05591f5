// K6: occupancy-grid maintenance (the probe scatter-max, the EMA decay-max
// merge and the threshold to a bitfield).
//
// Replaces nerfstyle_tpu/ops/occupancy.py: the scatter-max of
// occupancy_update_random (`tmp.at[cas, idx].max(sig)`, :281) and
// _merge_and_threshold (:157-176), which both update paths end in:
//     grid = (grid >= 0 & tmp >= 0) ? max(grid * decay, tmp) : grid,
//     mean = mean(max(grid, 0)),  bitfield = grid > min(mean, density_thresh).
//
// Scatter-max: one thread per probe, atomicMax on the float's int32 bits.
// The order of int32 bits is the order of the floats for every value >= +0,
// and the fill -1.0f has the sign bit set, so it is below every probe: probe
// sigmas are exp(.) * density_scale >= 0.  A max is order-free, so the
// result is exact and deterministic whatever the atomics' order.
//
// Merge + threshold: a fixed number of blocks walks the grid (grid-stride),
// merges each cell into a new grid and sums max(grid, 0) in double, one
// partial per block; the threshold kernel sums those partials in a fixed
// order (so the mean is deterministic), writes the mean, and thresholds.
// Two launches, no host round trip for the mean.
//
// Bound on the H100: bytes (a 2 x 128^3 grid is 16.8 MB f32: read grid and
// tmp, write grid and bitfield, read grid again: ~88 MB, ~0.03 ms).  The
// scatter-max moves 12 bytes a probe (index + sigma) and one random 4-byte
// read-modify-write in L2.
//
// K6c: the skip distance, replacing skipdist_from_bitfield (:99, with
// _dilate3 :85), which the JAX package rebuilds after every merge (:174) and
// every restore (:78): each cell's L-inf distance, in cells, to the nearest
// occupied cell of its cascade, the grid not wrapping, capped at dmax = 15.
// JAX dilates the whole grid 14 times (84 shifted ORs).  The L-inf distance
// is separable instead:
//     d(x, y, z) = min_x' max(|x - x'|, min_y' max(|y - y'|,
//                  min_z' max(|z - z'|, occupied(x', y', z') ? 0 : dmax)))
// and the cap commutes with each step (a window never reaches past dmax).
// So three launches, one an axis (z, y, x), each one thread a cell: a min of
// max(|delta|, d_prev) over the cell's neighbours along the axis, walking
// outward from delta 0 and stopping once |delta| reaches the best so far
// (a farther neighbour cannot lower it).  The first pass reads the bitfield.
// Integer arithmetic: the result equals the iterated dilation bit for bit.
// Bound on the H100: bytes, the bitfield in and the distances out (2 x 128^3
// cells: 4 MiB each, ~2.5 us).  Each pass reads up to 2 * dmax neighbours a
// cell again, from L1/L2, and writes a 1-byte intermediate: a later, faster
// version keeps a tile's lines in shared memory and fuses the passes.
#include "common.cuh"

namespace {

constexpr int kMergeBlocks = 264;  // 2 per SM of the H100

__global__ void scatter_max_kernel(float* __restrict__ tmp, const long long* __restrict__ idx,
                                   const float* __restrict__ sig, long long num_probes) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= num_probes) return;
    atomicMax(reinterpret_cast<int*>(tmp + idx[i]), __float_as_int(sig[i]));
}

__device__ double block_sum(double v, double* shared) {
    shared[threadIdx.x] = v;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) shared[threadIdx.x] += shared[threadIdx.x + s];
        __syncthreads();
    }
    return shared[0];
}

__global__ void merge_kernel(const float* __restrict__ grid, const float* __restrict__ tmp,
                             float decay, long long n, float* __restrict__ out,
                             double* __restrict__ partials) {
    __shared__ double shared[nst::kThreads];
    double acc = 0.0;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        float g = grid[i];
        const float t = tmp[i];
        if (g >= 0.f && t >= 0.f) g = fmaxf(__fmul_rn(g, decay), t);
        out[i] = g;
        acc += static_cast<double>(fmaxf(g, 0.f));
    }
    const double total = block_sum(acc, shared);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void threshold_kernel(const float* __restrict__ grid,
                                 const double* __restrict__ partials, int num_partials,
                                 long long n, float density_thresh, bool* __restrict__ bitfield,
                                 float* __restrict__ mean_out) {
    __shared__ double shared[nst::kThreads];
    double acc = 0.0;
    for (int j = threadIdx.x; j < num_partials; j += blockDim.x) acc += partials[j];
    const float mean = static_cast<float>(block_sum(acc, shared) / static_cast<double>(n));
    if (blockIdx.x == 0 && threadIdx.x == 0) *mean_out = mean;
    const float thresh = fminf(mean, density_thresh);
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        bitfield[i] = grid[i] > thresh;
    }
}

// One axis pass of K6c over n cells (cascade * h^3), axis stride 1 (z), h
// (y) or h * h (x).  from_bits: in is the bitfield (0 where occupied, dmax
// elsewhere); else in holds the previous pass's distances.
__global__ void skipdist_pass_kernel(const unsigned char* __restrict__ in, bool from_bits,
                                     int h, long long n, long long stride, int dmax,
                                     unsigned char* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int c = static_cast<int>((i / stride) % h);
    auto dist = [&](long long j) -> int {
        const int v = in[j];
        return from_bits ? (v ? 0 : dmax) : v;
    };
    int best = dist(i);
    for (int r = 1; r < best; ++r) {
        if (c - r >= 0) best = min(best, max(r, dist(i - r * stride)));
        if (c + r < h) best = min(best, max(r, dist(i + r * stride)));
    }
    out[i] = static_cast<unsigned char>(best);
}

}  // namespace

// tmp [K] f32 (updated in place), idx [P] i64 (flat cell index into tmp),
// sig [P] f32 >= 0.
NST_API int nst_occupancy_scatter_max(void* tmp, const void* idx, const void* sig,
                                      long long num_probes, void* stream) {
    if (num_probes <= 0) return 0;
    scatter_max_kernel<<<nst::blocks_for(num_probes), nst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(tmp), static_cast<const long long*>(idx),
        static_cast<const float*>(sig), num_probes);
    return nst::launch_status();
}

// Number of double partial sums nst_occupancy_merge writes.
NST_API int nst_occupancy_num_partials() { return kMergeBlocks; }

// grid, tmp [K] f32 -> out [K] f32 (the merged grid), partials [264] f64.
NST_API int nst_occupancy_merge(const void* grid, const void* tmp, float decay, long long n,
                                void* out, void* partials, void* stream) {
    if (n <= 0) return 0;
    merge_kernel<<<kMergeBlocks, nst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grid), static_cast<const float*>(tmp), decay, n,
        static_cast<float*>(out), static_cast<double*>(partials));
    return nst::launch_status();
}

// grid [K] f32 (merged), partials [264] f64 -> bitfield [K] bool, mean [1] f32.
NST_API int nst_occupancy_threshold(const void* grid, const void* partials, long long n,
                                    float density_thresh, void* bitfield, void* mean,
                                    void* stream) {
    if (n <= 0) return 0;
    threshold_kernel<<<kMergeBlocks, nst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grid), static_cast<const double*>(partials), kMergeBlocks, n,
        density_thresh, static_cast<bool*>(bitfield), static_cast<float*>(mean));
    return nst::launch_status();
}

// One K6c axis pass: in [n] u8 (the bitfield when from_bits), out [n] u8.
NST_API int nst_occupancy_skipdist_pass(const void* in, int from_bits, int grid_size,
                                        long long n, long long stride, int dmax, void* out,
                                        void* stream) {
    if (n <= 0) return 0;
    skipdist_pass_kernel<<<nst::blocks_for(n), nst::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(in), from_bits != 0, grid_size, n, stride, dmax,
        static_cast<unsigned char*>(out));
    return nst::launch_status();
}
