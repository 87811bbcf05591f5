// K3: occupancy-grid ray march with ray-major compaction, in two forms that
// share one walk (nst_march_count / nst_march_write).
//
// Dense (no skip distance) replaces the JAX marcher
// nerfstyle_tpu/ops/marching.py:march_rays on its dense path (adaptive_march
// off: _kept_mask_dense and cell_index_and_size) and its static-size
// compaction (ops/compact.py:compact_indices).  Two-stage, K3s (given the
// skip distance of K6c), replaces _march_two_stage (:191-317), the JAX
// default, and emits the same samples.
//
// Ray r visits the lattice t_k = near_r + k*dt, k = 0 .. t_lattice-1, while
// t_k < far_r.  A point x = clamp(o + d*t_k, -bound, bound) is kept when the
// cell of its cascade level is occupied, level = clamp(max(frexp_exp(max|x|),
// mip_dt_level), 0, cascade-1); a ray keeps at most max_steps points.
//
//   pass 1 (count): one thread per ray counts its kept points;
//   scan   (in PyTorch): exclusive cumsum of the counts -> ray offsets;
//   pass 2 (write): one thread per ray walks again and writes xyz, dirs,
//          tau = t + dt - near, ray id and lattice index k at its offset.
//          The order is ray-major and deterministic.
//
// Two-stage: the ray's lattice is cut into windows of S = 8 points.  At a
// window's first point the coarse test takes, over every cascade level lv,
// d_world = min_lv (skipdist[lv, cell_lv] - 1) * cell_size_lv; the window
// is a candidate iff d_world < S*dt and its first point lies before far.
// Every point of the window lies within (S-1)*dt of that point (clamping to
// the box contracts), so a window that is no candidate holds no occupied
// point at any level, and its S fine points are not visited.  A candidate's
// fine points take the dense test.  The count pass also counts the
// candidate windows (num_cand, for observability), past the max_steps cap
// as JAX does.  The dense form is the same walk with every window a
// candidate.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn):
// nvcc would otherwise contract o + d*t into an FMA, and a lattice point on a
// cell boundary would then change cell against the plain version.
//
// Bound on the H100: bytes.  The function must read the rays and the
// occupancy and write 36 bytes per kept point.  Both forms are held back by
// instructions instead: each visited lattice point costs ~40 operations
// (position, frexp, cell index, one 1-byte bitfield read that mostly hits
// L1/L2: the 4 MB bitfield fits in L2).  The dense form visits every lattice
// point, twice; the two-stage form visits every window's first point
// (cascade lookups of the 4 MB skip distance) and the fine points of
// candidate windows only.  Design: one thread per ray in each pass, the
// simplest exact form; a warp per ray is later work.
#include "common.cuh"

namespace {

struct MarchGeom {
    float dt;
    float bound;
    int t_lattice;
    int cascade;
    int grid_size;
    int mip_dt_level;
    int max_steps;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// Position of lattice point t on ray (o, d), clamped to the bound, and
// whether its cell is occupied.
__device__ __forceinline__ bool lattice_point(const float o[3], const float d[3], float t,
                                              const MarchGeom& g,
                                              const unsigned char* __restrict__ bits,
                                              float xyz[3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        xyz[a] = clampf(__fadd_rn(o[a], __fmul_rn(d[a], t)), -g.bound, g.bound);
    }
    const float mx = fmaxf(fmaxf(fabsf(xyz[0]), fabsf(xyz[1])), fabsf(xyz[2]));
    int e;
    frexpf(mx, &e);
    const int level = min(max(max(e, g.mip_dt_level), 0), g.cascade - 1);
    const float mip_bound = fminf(ldexpf(1.f, level), g.bound);
    const int h = g.grid_size;
    const float hf = static_cast<float>(h);
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float u = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fdiv_rn(xyz[a], mip_bound), 1.f)), hf);
        c[a] = min(max(static_cast<int>(u), 0), h - 1);
    }
    const long long cell = static_cast<long long>(level) * h * h * h +
                           (static_cast<long long>(c[0]) * h + c[1]) * h + c[2];
    return bits[cell] != 0;
}

// The two-stage coarse test of the window starting at lattice point t_c:
// d_world < reach over every level (cells[lv] = the level's cell size in
// world units, rounded to f32 as JAX rounds 2*min(2^lv, bound)/H; reach =
// f32(S*dt)).
__device__ __forceinline__ bool window_candidate(const float o[3], const float d[3], float t_c,
                                                 const MarchGeom& g,
                                                 const unsigned char* __restrict__ skip,
                                                 const float* __restrict__ cells, float reach) {
    float xyz[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        xyz[a] = clampf(__fadd_rn(o[a], __fmul_rn(d[a], t_c)), -g.bound, g.bound);
    }
    const int h = g.grid_size;
    const float hf = static_cast<float>(h);
    float d_world = __int_as_float(0x7f800000);  // +inf
    for (int lv = 0; lv < g.cascade; ++lv) {
        const float mip_bound = fminf(ldexpf(1.f, lv), g.bound);
        int c[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float u =
                __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fdiv_rn(xyz[a], mip_bound), 1.f)), hf);
            c[a] = min(max(static_cast<int>(u), 0), h - 1);
        }
        const long long cell = static_cast<long long>(lv) * h * h * h +
                               (static_cast<long long>(c[0]) * h + c[1]) * h + c[2];
        const float dl = __fmul_rn(__fsub_rn(static_cast<float>(skip[cell]), 1.f), cells[lv]);
        d_world = fminf(d_world, dl);
    }
    return d_world < reach;
}

// The sample stream's outputs (pass 2).
struct MarchOut {
    float* xyz;
    float* dirs;
    float* tau;
    int* ray;
    int* step;
};

// One walk for both passes and both forms.  kWrite = false: count ray r's
// kept points (and, two-stage, its candidate windows); kWrite = true: write
// them at offsets[r].  skip == nullptr is the dense march: every window is a
// candidate, so the walk visits every lattice point in range.
template <bool kWrite>
__global__ void march_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                             const float* __restrict__ nears, const float* __restrict__ fars,
                             const unsigned char* __restrict__ bits,
                             const unsigned char* __restrict__ skip,
                             const float* __restrict__ cells, MarchGeom g, int window,
                             float reach, int num_rays, int* __restrict__ counts,
                             int* __restrict__ cand_counts, const long long* __restrict__ offsets,
                             MarchOut out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= num_rays) return;
    // The write pass stops at its ray's end offset, the count pass at the
    // max_steps cap: the same point, since the count came from this walk.
    long long j = 0, end = g.max_steps;
    if (kWrite) {
        j = offsets[r];
        end = offsets[r + 1];
        if (j == end) return;
    }
    const float o[3] = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
    const float d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
    const float near = nears[r];
    const float far = fars[r];
    int cand = 0;
    float xyz[3];
    for (int k0 = 0; k0 < g.t_lattice; k0 += window) {
        // Past the cap only the two-stage count pass walks on, to count the
        // candidate windows as JAX does.
        if (j >= end && (kWrite || skip == nullptr)) break;
        const float t_c = __fadd_rn(near, __fmul_rn(static_cast<float>(k0), g.dt));
        if (!(t_c < far)) break;  // t grows with k: no later point is in range
        if (skip != nullptr && !window_candidate(o, d, t_c, g, skip, cells, reach)) continue;
        ++cand;
        const int k1 = min(k0 + window, g.t_lattice);
        for (int k = k0; k < k1 && j < end; ++k) {
            const float t = __fadd_rn(near, __fmul_rn(static_cast<float>(k), g.dt));
            if (!(t < far)) break;
            if (!lattice_point(o, d, t, g, bits, xyz)) continue;
            if (kWrite) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    out.xyz[3 * j + a] = xyz[a];
                    out.dirs[3 * j + a] = d[a];
                }
                out.tau[j] = __fsub_rn(__fadd_rn(t, g.dt), near);
                out.ray[j] = r;
                out.step[j] = k;
            }
            ++j;
        }
    }
    if (!kWrite) {
        counts[r] = static_cast<int>(j);
        if (cand_counts != nullptr) cand_counts[r] = cand;
    }
}

}  // namespace

// origins, dirs [N, 3] f32; nears, fars [N] f32; bitfield [cascade*H^3] u8.
// Two-stage (K3s): skipdist [cascade*H^3] u8, cells [cascade] f32 (world
// cell size of each level), the window S and reach = f32(S*dt); dense (K3):
// skipdist, cells and cand_counts null.  counts [N] i32 (out); cand_counts
// [N] i32 (out, two-stage): candidate windows of each ray.
NST_API int nst_march_count(const void* origins, const void* dirs, const void* nears,
                            const void* fars, const void* bitfield, const void* skipdist,
                            const void* cells, float dt, float bound, int t_lattice, int cascade,
                            int grid_size, int mip_dt_level, int max_steps, int window,
                            float reach, int num_rays, void* counts, void* cand_counts,
                            void* stream) {
    if (num_rays <= 0) return 0;
    const MarchGeom g{dt, bound, t_lattice, cascade, grid_size, mip_dt_level, max_steps};
    march_kernel<false><<<nst::blocks_for(num_rays), nst::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(origins), static_cast<const float*>(dirs),
        static_cast<const float*>(nears), static_cast<const float*>(fars),
        static_cast<const unsigned char*>(bitfield), static_cast<const unsigned char*>(skipdist),
        static_cast<const float*>(cells), g, window, reach, num_rays, static_cast<int*>(counts),
        static_cast<int*>(cand_counts), nullptr, MarchOut{});
    return nst::launch_status();
}

// Pass 2, with the arguments of pass 1 and offsets [N+1] i64 (exclusive scan
// of its counts); outputs sized offsets[N]: xyz, dirs [M, 3] f32, tau [M]
// f32, ray id and lattice index [M] i32.
NST_API int nst_march_write(const void* origins, const void* dirs, const void* nears,
                            const void* fars, const void* bitfield, const void* skipdist,
                            const void* cells, float dt, float bound, int t_lattice, int cascade,
                            int grid_size, int mip_dt_level, int max_steps, int window,
                            float reach, int num_rays, const void* offsets, void* out_xyz,
                            void* out_dirs, void* out_tau, void* out_ray, void* out_step,
                            void* stream) {
    if (num_rays <= 0) return 0;
    const MarchGeom g{dt, bound, t_lattice, cascade, grid_size, mip_dt_level, max_steps};
    const MarchOut out{static_cast<float*>(out_xyz), static_cast<float*>(out_dirs),
                       static_cast<float*>(out_tau), static_cast<int*>(out_ray),
                       static_cast<int*>(out_step)};
    march_kernel<true><<<nst::blocks_for(num_rays), nst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(origins), static_cast<const float*>(dirs),
        static_cast<const float*>(nears), static_cast<const float*>(fars),
        static_cast<const unsigned char*>(bitfield), static_cast<const unsigned char*>(skipdist),
        static_cast<const float*>(cells), g, window, reach, num_rays, nullptr, nullptr,
        static_cast<const long long*>(offsets), out);
    return nst::launch_status();
}
