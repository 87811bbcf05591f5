// K3: occupancy-grid ray march with ray-major compaction.
//
// Replaces the JAX marcher nerfstyle_tpu/ops/marching.py:march_rays (the
// dense lattice semantics of _kept_mask_dense and cell_index_and_size; the
// two-stage skip-distance form emits the same samples) and its static-size
// compaction (ops/compact.py:compact_indices).
//
// Ray r visits the lattice t_k = near_r + k*dt, k = 0 .. t_lattice-1, while
// t_k < far_r.  A point x = clamp(o + d*t_k, -bound, bound) is kept when the
// cell of its cascade level is occupied, level = clamp(max(frexp_exp(max|x|),
// mip_dt_level), 0, cascade-1); a ray keeps at most max_steps points.
//
//   pass 1 (nst_march_count): one thread per ray counts its kept points;
//   scan   (in PyTorch): exclusive cumsum of the counts -> ray offsets;
//   pass 2 (nst_march_write): one thread per ray walks again and writes
//          xyz, dirs, tau = t + dt - near, ray id and lattice index k at
//          its offset.  The order is ray-major and deterministic.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn):
// nvcc would otherwise contract o + d*t into an FMA, and a lattice point on a
// cell boundary would then change cell against the plain version.
//
// Bound on the H100: bytes.  The function must read the rays and the
// bitfield and write 36 bytes per kept point.  This kernel is held back by
// instructions instead: each visited lattice point costs ~40 operations
// (position, frexp, cell index, one 1-byte bitfield read that mostly hits
// L1/L2: the 4 MB bitfield fits in L2), and it visits every lattice point,
// twice.  Design: the simplest exact form, one thread per ray walking the
// dense lattice in each pass; empty-space skipping with the skip distance
// and a warp per ray are later work.
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

__global__ void march_count_kernel(const float* __restrict__ origins,
                                   const float* __restrict__ dirs,
                                   const float* __restrict__ nears,
                                   const float* __restrict__ fars,
                                   const unsigned char* __restrict__ bits, MarchGeom g,
                                   int num_rays, int* __restrict__ counts) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= num_rays) return;
    const float o[3] = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
    const float d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
    const float near = nears[r];
    const float far = fars[r];
    int kept = 0;
    float xyz[3];
    for (int k = 0; k < g.t_lattice && kept < g.max_steps; ++k) {
        const float t = __fadd_rn(near, __fmul_rn(static_cast<float>(k), g.dt));
        if (!(t < far)) break;  // t grows with k: no later point is in range
        kept += lattice_point(o, d, t, g, bits, xyz) ? 1 : 0;
    }
    counts[r] = kept;
}

__global__ void march_write_kernel(const float* __restrict__ origins,
                                   const float* __restrict__ dirs,
                                   const float* __restrict__ nears,
                                   const float* __restrict__ fars,
                                   const unsigned char* __restrict__ bits, MarchGeom g,
                                   int num_rays, const long long* __restrict__ offsets,
                                   float* __restrict__ out_xyz, float* __restrict__ out_dirs,
                                   float* __restrict__ out_tau, int* __restrict__ out_ray,
                                   int* __restrict__ out_step) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= num_rays) return;
    long long j = offsets[r];
    const long long end = offsets[r + 1];
    if (j == end) return;
    const float o[3] = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
    const float d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
    const float near = nears[r];
    const float far = fars[r];
    float xyz[3];
    for (int k = 0; k < g.t_lattice && j < end; ++k) {
        const float t = __fadd_rn(near, __fmul_rn(static_cast<float>(k), g.dt));
        if (!(t < far)) break;
        if (!lattice_point(o, d, t, g, bits, xyz)) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            out_xyz[3 * j + a] = xyz[a];
            out_dirs[3 * j + a] = d[a];
        }
        out_tau[j] = __fsub_rn(__fadd_rn(t, g.dt), near);
        out_ray[j] = r;
        out_step[j] = k;
        ++j;
    }
}

}  // namespace

// origins, dirs [N, 3] f32; nears, fars [N] f32; bitfield [cascade*H^3] u8;
// counts [N] i32 (out).
NST_API int nst_march_count(const void* origins, const void* dirs, const void* nears,
                            const void* fars, const void* bitfield, float dt, float bound,
                            int t_lattice, int cascade, int grid_size, int mip_dt_level,
                            int max_steps, int num_rays, void* counts, void* stream) {
    if (num_rays <= 0) return 0;
    const MarchGeom g{dt, bound, t_lattice, cascade, grid_size, mip_dt_level, max_steps};
    march_count_kernel<<<nst::blocks_for(num_rays), nst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(origins), static_cast<const float*>(dirs),
        static_cast<const float*>(nears), static_cast<const float*>(fars),
        static_cast<const unsigned char*>(bitfield), g, num_rays, static_cast<int*>(counts));
    return nst::launch_status();
}

// offsets [N+1] i64 (exclusive scan of the counts); outputs sized offsets[N]:
// xyz, dirs [M, 3] f32, tau [M] f32, ray id and lattice index [M] i32.
NST_API int nst_march_write(const void* origins, const void* dirs, const void* nears,
                            const void* fars, const void* bitfield, float dt, float bound,
                            int t_lattice, int cascade, int grid_size, int mip_dt_level,
                            int max_steps, int num_rays, const void* offsets, void* out_xyz,
                            void* out_dirs, void* out_tau, void* out_ray, void* out_step,
                            void* stream) {
    if (num_rays <= 0) return 0;
    const MarchGeom g{dt, bound, t_lattice, cascade, grid_size, mip_dt_level, max_steps};
    march_write_kernel<<<nst::blocks_for(num_rays), nst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(origins), static_cast<const float*>(dirs),
        static_cast<const float*>(nears), static_cast<const float*>(fars),
        static_cast<const unsigned char*>(bitfield), g, num_rays,
        static_cast<const long long*>(offsets), static_cast<float*>(out_xyz),
        static_cast<float*>(out_dirs), static_cast<float*>(out_tau), static_cast<int*>(out_ray),
        static_cast<int*>(out_step));
    return nst::launch_status();
}
