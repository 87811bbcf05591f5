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
//   pass 1 (count): one warp per ray counts its kept points;
//   scan   (in PyTorch): exclusive cumsum of the counts -> ray offsets;
//   pass 2 (write): one warp per ray walks again and writes xyz, dirs,
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
// instructions and latency instead: each visited lattice point costs ~40
// operations (position, frexp, cell index, one 1-byte bitfield read that
// mostly hits L1/L2: the 4 MB bitfield fits in L2).  The dense form visits
// every lattice point, twice; the two-stage form visits every window's first
// point (cascade lookups of the 4 MB skip distance) and the fine points of
// candidate windows only.
//
// Design: one warp a ray, in both passes and both forms.  Lanes take
// neighbouring lattice points (dense) or neighbouring windows (coarse), so a
// ray's walk is 32 points or windows a step instead of one, and a late
// train batch of 4096 rays fills the card with 4096 warps instead of 4096
// threads.  A kept point's slot comes from a ballot and a prefix popc over
// the lanes, so neighbouring lanes write neighbouring slots of xyz, dirs,
// tau, ray id and step: the write pass's stores coalesce (a thread a ray
// wrote its samples to 32 unrelated lines a warp).  Exactness: t_k = near +
// k dt, each step rounded on its own, does not decrease in k, so masking
// t < far keeps exactly the points that a sequential walk's break keeps,
// and the lanes' prefix order is the lattice order.
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

// Rays a CTA: one warp a ray.
constexpr int kRaysPerCta = nst::kThreads / 32;

// One walk for both passes and both forms, one warp a ray.  kWrite = false:
// count ray r's kept points (and, two-stage, its candidate windows);
// kWrite = true: write them at offsets[r].  skip == nullptr is the dense
// march: every window is a candidate, and the 32 lanes take 32 consecutive
// lattice points a step.  Two-stage: lane i tests window w0 + i (coarse),
// and the group's candidate windows are then taken in order, 32 / window of
// them a step, lane i on point i % window of the (i / window)-th (fine).  A
// kept point's slot is j plus the kept lanes below it (ballot and popc), so
// slots follow lattice order, and slots at or past `end` are dropped.  Every
// branch of the loop depends only on ballots and on j: the warp stays
// converged.
template <bool kWrite>
__global__ void __launch_bounds__(nst::kThreads)
    march_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                 const float* __restrict__ nears, const float* __restrict__ fars,
                 const unsigned char* __restrict__ bits, const unsigned char* __restrict__ skip,
                 const float* __restrict__ cells, MarchGeom g, int window, float reach,
                 int num_rays, int* __restrict__ counts, int* __restrict__ cand_counts,
                 const long long* __restrict__ offsets, MarchOut out) {
    const int r = blockIdx.x * kRaysPerCta + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (r >= num_rays) return;  // the whole warp
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
    const unsigned below = (1u << lane) - 1u;
    // Lattice point k of this lane: test it, and in the write pass store it
    // at its slot; then advance j past the step's kept points.
    auto fine = [&](bool live, int k) {
        const float t = __fadd_rn(near, __fmul_rn(static_cast<float>(k), g.dt));
        float xyz[3];
        const bool keep = live && k < g.t_lattice && t < far && lattice_point(o, d, t, g, bits, xyz);
        const unsigned kept = __ballot_sync(0xffffffffu, keep);
        if (kWrite) {
            const long long slot = j + __popc(kept & below);
            if (keep && slot < end) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    out.xyz[3 * slot + a] = xyz[a];
                    out.dirs[3 * slot + a] = d[a];
                }
                out.tau[slot] = __fsub_rn(__fadd_rn(t, g.dt), near);
                out.ray[slot] = r;
                out.step[slot] = k;
            }
        }
        j = min(j + __popc(kept), end);
    };
    int cand = 0;
    if (skip == nullptr) {
        for (int k0 = 0; j < end; k0 += 32) {
            const int k = k0 + lane;
            const float t = __fadd_rn(near, __fmul_rn(static_cast<float>(k), g.dt));
            const bool in = k < g.t_lattice && t < far;
            fine(in, k);
            // t grows with k: once a lane is out of range, so are all later points.
            if (__ballot_sync(0xffffffffu, in) != 0xffffffffu) break;
        }
    } else {
        const int per = 32 / window;  // windows a fine step
        const int q = lane / window, p = lane - q * window;
        for (int w0 = 0;; w0 += 32) {
            const int k0 = (w0 + lane) * window;
            const float t_c = __fadd_rn(near, __fmul_rn(static_cast<float>(k0), g.dt));
            const bool in = k0 < g.t_lattice && t_c < far;
            const unsigned in_mask = __ballot_sync(0xffffffffu, in);
            if (in_mask == 0u) break;
            unsigned c_mask = __ballot_sync(
                0xffffffffu, in && window_candidate(o, d, t_c, g, skip, cells, reach));
            // Past the cap the count pass walks on, to count the candidate
            // windows as JAX does.
            cand += __popc(c_mask);
            while (c_mask != 0u && j < end) {
                unsigned mine = c_mask;  // drop this lane's q lower candidates
                for (int i = 0; i < q; ++i) mine &= mine - 1u;
                const bool live = q < per && mine != 0u;
                fine(live, live ? (w0 + __ffs(mine) - 1) * window + p : 0);
                for (int i = 0; i < per; ++i) c_mask &= c_mask - 1u;
            }
            if (in_mask != 0xffffffffu || (kWrite && j >= end)) break;
        }
    }
    if (!kWrite && lane == 0) {
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
    if (window < 1 || window > 32) return static_cast<int>(cudaErrorInvalidValue);
    const MarchGeom g{dt, bound, t_lattice, cascade, grid_size, mip_dt_level, max_steps};
    march_kernel<false><<<nst::blocks_for(num_rays, kRaysPerCta), nst::kThreads, 0,
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
    if (window < 1 || window > 32) return static_cast<int>(cudaErrorInvalidValue);
    const MarchGeom g{dt, bound, t_lattice, cascade, grid_size, mip_dt_level, max_steps};
    const MarchOut out{static_cast<float*>(out_xyz), static_cast<float*>(out_dirs),
                       static_cast<float*>(out_tau), static_cast<int*>(out_ray),
                       static_cast<int*>(out_step)};
    march_kernel<true><<<nst::blocks_for(num_rays, kRaysPerCta), nst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(origins), static_cast<const float*>(dirs),
        static_cast<const float*>(nears), static_cast<const float*>(fars),
        static_cast<const unsigned char*>(bitfield), static_cast<const unsigned char*>(skipdist),
        static_cast<const float*>(cells), g, window, reach, num_rays, nullptr, nullptr,
        static_cast<const long long*>(offsets), out);
    return nst::launch_status();
}
