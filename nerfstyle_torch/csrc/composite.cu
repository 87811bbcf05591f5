// K4 (forward and backward) and K7: per-ray passes over a ray-major sample
// stream.
//
// Both take ray offsets [N+1] (int64): ray r owns samples offsets[r] ..
// offsets[r+1]-1, as the marcher (march.cu) and the significance
// compaction emit them.  Neither needs atomics, and every sum is taken in a
// fixed order, so results are deterministic.
//
// K4 replaces nerfstyle_tpu/ops/compositing.py:sample_weights (significance,
// segment_exclusive_cumsum) plus the per-ray weights_sum and depth sums of
// render/renderer.py:make_two_phase_renderer.  Per ray, front to back:
//     sdt_i = min(sigma_i * dt, 100), alpha_i = 1 - exp(-sdt_i),
//     T_i = exp(-sum_{j<i} sdt_j), w_i = alpha_i * T_i while T_i >= t_thresh,
//     weights_sum = sum w_i, depth = sum w_i * tau_i.
// The JAX form takes a flat fp32 cumsum over the whole stream minus per-ray
// totals, which loses digits as the stream grows; this kernel sums each
// ray's optical depth on its own, front to back, and stops at the first
// sample with T < t_thresh (T never rises again, so every later w is 0).
// It also writes each ray's included count n_inc: the samples with entering
// T >= t_thresh, the prefix a train step's phase B keeps.
//
// One warp a ray, in chunks of 32 consecutive samples, a lane a sample, so
// that sigma, tau and w move coalesced.  A chunk's optical depth is an
// inclusive warp scan of sdt (shuffles, a fixed tree) on top of the carry
// of the chunks in front; __ballot_sync on T < t_thresh finds the cutoff's
// lane, and weights_sum and depth are fixed-order warp sums carried chunk
// to chunk.  The warp stops after the cutoff's chunk and writes the rest of
// the ray's w as zeros (16 bytes a lane).  Against a sequential sum the scan
// only reassociates the optical depth (~5 roundings deep in a chunk, one
// more for the carry); results are the same bits on every launch.
//
// K4i, K4's entry for a round of the incremental renderer, replaces the
// round composite of nerfstyle_tpu/render/renderer.py:
// make_incremental_renderer (:364-373, the reference's inference
// composite_rays, raymarching.cu:1005-1239): a ray's round of samples enters
// with the transmittance t0 it kept from its earlier rounds, so
//     T_i = t0 * exp(-sum_{j<i} sdt_j),  w_i = alpha_i * T_i while T_i >= t_thresh,
// and the ray leaves with t_out = t0 * exp(-sum sdt) over all of the round's
// samples (the death test reads it).  K4 cannot do this: its threshold test
// has no entering T.  K4's chunk scan, lane a sample, and K4's sum trees, so
// at t0 = 1 it gives K4's bits; the walk does not stop at the cutoff,
// because t_out sums the round's whole optical depth.  A round is short (32
// samples a ray, one chunk, at the default round size).  The grid is about
// one wave of resident warps, each walking a contiguous block of rays: lane
// i loads ray r0 + i's offsets and t0 (one coalesced load each, handed out
// by shuffle, 32-bit offsets from the group's first sample), the next
// chunk's sigma and tau are loaded before the current chunk's scan (a
// two-deep register pipeline), each scan level is one shuffle and one add
// predicated on the shuffle's own in-range bit (warp_inclusive_scan_p),
// weights_sum's and depth's warp sums share their shuffles (warp_sum_pair:
// each keeps its own tree), a sample's inclusion is a mask test instead of
// a branch, and lane i keeps ray r0 + i's results for one coalesced store.
// Rays longer than 32 walk chunk by chunk as in K4; a ray with no samples
// writes zeros and t_out = t0.  No backward: inference only.
//
// Bound on the H100: bytes, 0.0017 ms at the 1008x756 frame's largest
// round; K4i takes ~0.006 ms there, as the warp-a-ray kernel it replaced
// did (PERF.md, the K4i row).  Not load latency: neither this pipeline
// nor a warp a ray, two or four rays a warp in lockstep, or a thread a ray
// with the trees unrolled in registers ran faster; with the chunk's
// shuffles taken out (wrong sums) it did.  The warp shuffles (17 a ray),
// the two exact expf a sample and the launch floor (an empty kernel takes
// ~0.0017 ms) hold it.
//
// K4 backward replaces JAX's autodiff of ops/compositing.py:composite_rays
// (:116-148) with the reference's composite_rays_train_backward, given the
// cotangents gI [N, C] of the image, gW [N] of weights_sum and gD [N] of
// depth.  With v_i = gW + gD * tau_i + gI . ch_i, over a ray's n_inc
// included samples:
//     d ch_i  = w_i * gI,
//     d sdt_i = T_{i+1} * v_i - sum_{k>i} w_k * v_k,   T_{i+1} = T_i e^{-sdt_i},
//     d sigma_i = dt * d sdt_i where sigma_i * dt < 100 (the cap), else 0,
// and 0 for every sample past the cutoff.  Also one warp a ray: forward,
// T_{i+1} by K4's scan (the same bits as K4's); a ray's last chunk keeps it
// in registers, earlier chunks park it in d_sigma.  Then in reverse, chunk
// by chunk from the back, sum_{k>i} w_k v_k is a reverse warp scan on top
// of the later chunks' carry: a sum of later terms only, so no late
// sample's gradient is a difference of two large prefix sums.  d ch, zero
// rows past the cutoff included, is written as one coalesced span of the
// ray's [n, C] rows, as K7b writes.
//
// K7 replaces the phase-B segment sum of make_two_phase_renderer
// (render/renderer.py:648-659) and of the style stage's cached stream
// (training/style_trainer.py:689-691, 753-755): out[r, c] = sum_i w_i *
// ch[i, c] over ray r's significant samples, each product and sum rounded
// on its own, in stream order (deterministic, no atomics).  Segments are
// short (a few samples a ray), so a thread per (ray, channel) walking its
// segment (re-reading w and the offsets C times, loads drifting apart by
// the segment lengths) is mostly latency.  Instead a CTA takes a run of
// kSegRays consecutive rays, whose samples form one contiguous span of the
// stream; it stages the span's w and ch rows in shared memory with
// coalesced loads (16 bytes a thread for ch's aligned body), reading each
// sample once, and each thread then sums its own ray's rows from shared
// memory.  A span longer than the staged tile is walked in pieces, the
// sums carried in shared memory from piece to piece; the CTA's [rays, C]
// block of out is written back in one coalesced pass.
//
// K7b is its backward on its own (JAX's autodiff of that segment_sum, written
// out at training/style_trainer.py:875), for a stream whose weights are
// fixed: d ch[i, c] = w_i * g[r, c] for every sample i of ray r, and, only
// when asked, d w_i = sum_c ch[i, c] * g[r, c] in order of c.  Rays are
// short and most are empty (a style cache: ~4 samples a ray, 84% of rays
// empty, the rest ~26), so neither a warp a ray nor a CTA a run of rays
// balances: the work is cut by samples instead.  A CTA takes a tile of
// kBwdTile consecutive samples (a few CTAs an SM walk the tiles: the
// stream's length is on the device), finds the tile's first and last ray
// by a warp's 32-way search of the offsets, and gives each sample its ray
// without a search: each non-empty ray of the tile marks the sample it
// starts at, and a block scan takes the running max.  Then a thread a
// sample writes its C products w_i * g[r, c] (and d w) into a staged piece
// of d ch in shared memory, which the CTA copies out flat, 16 bytes a
// thread (a piece starts on a 16-byte boundary).  32-bit indices inside a
// tile, no division; one fp32 product a float, the plain version's bits;
// no atomics.
//
// Bound on the H100: bytes (a few flops per 4-byte sample value).  At a
// train batch (4096 rays, ~0.2 MB moved) K4 and K4b take a few microseconds
// against a bound of a fraction of one: a launch and the longest ray's
// chain of chunks (~7), each a dependent load, scan and exp, hold them.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Inclusive scan of x over the warp's lanes in lane order, each sum rounded
// on its own, in a fixed tree (the same bits on every launch).
__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFullMask, x, off);
        if (lane >= off) x = __fadd_rn(y, x);
    }
    return x;
}

// Inclusive scan of x from the last lane down: lane l gets the sum over
// lanes >= l, in a fixed tree.
__device__ __forceinline__ float warp_suffix_scan(float x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(kFullMask, x, off);
        if (lane + off < 32) x = __fadd_rn(x, y);
    }
    return x;
}

// Sum over the warp's lanes; every lane gets the same bits (a butterfly:
// partners add the same two values).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFullMask, x, off));
    return x;
}

// p[0 .. n) = 0 by the warp: scalar head and tail, 16 bytes a lane between.
__device__ __forceinline__ void warp_zero(float* __restrict__ p, long long n, int lane) {
    if (n <= 0) return;
    const int head = static_cast<int>(
        min(n, static_cast<long long>((4 - (reinterpret_cast<uintptr_t>(p) >> 2 & 3)) & 3)));
    if (lane < head) p[lane] = 0.f;
    const long long body = (n - head) >> 2;
    float4* p4 = reinterpret_cast<float4*>(p + head);
    for (long long q = lane; q < body; q += 32) p4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long q = head + 4 * body + lane; q < n; q += 32) p[q] = 0.f;
}

__global__ void __launch_bounds__(nst::kThreads)
    composite_weights_kernel(const float* __restrict__ sigmas, const float* __restrict__ tau,
                             const long long* __restrict__ offsets, int num_rays, float dt,
                             float t_thresh, float* __restrict__ w,
                             float* __restrict__ weights_sum, float* __restrict__ depth,
                             int* __restrict__ n_inc) {
    const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (r >= num_rays) return;  // the whole warp
    const long long begin = offsets[r];
    const long long end = offsets[r + 1];
    float carry = 0.f;  // optical depth in front of the chunk
    float ws = 0.f;
    float dep = 0.f;
    long long stop = end;  // the first excluded sample
    long long base = begin;
    for (; base < end; base += 32) {
        const long long i = base + lane;
        const bool valid = i < end;
        const float sdt = valid ? fminf(__fmul_rn(sigmas[i], dt), 100.f) : 0.f;
        const float incl = warp_inclusive_scan(sdt, lane);
        const float excl = __shfl_up_sync(kFullMask, incl, 1);
        const float trans = expf(-__fadd_rn(carry, lane == 0 ? 0.f : excl));
        const unsigned out = __ballot_sync(kFullMask, valid && !(trans >= t_thresh));
        const int cut = out ? __ffs(out) - 1 : 32;  // the first excluded lane
        const bool inc = valid && lane < cut;
        const float wi = inc ? __fmul_rn(__fsub_rn(1.f, expf(-sdt)), trans) : 0.f;
        if (valid) w[i] = wi;
        ws = __fadd_rn(ws, warp_sum(wi));
        dep = __fadd_rn(dep, warp_sum(inc ? __fmul_rn(wi, tau[i]) : 0.f));
        if (out) {
            stop = base + cut;
            base += 32;
            break;
        }
        carry = __fadd_rn(carry, __shfl_sync(kFullMask, incl, 31));
    }
    warp_zero(w + base, end - base, lane);  // the chunks past the cutoff's
    if (lane == 0) {
        n_inc[r] = static_cast<int>(stop - begin);
        weights_sum[r] = ws;
        depth[r] = dep;
    }
}

// warp_inclusive_scan's bits in two instructions a level: the shuffle's own
// predicate says whether the source lane exists, and the add is predicated
// on it.
__device__ __forceinline__ float warp_inclusive_scan_p(float x) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        asm("{\n\t.reg .f32 y;\n\t.reg .pred p;\n\t"
            "shfl.sync.up.b32 y|p, %0, %1, 0, 0xffffffff;\n\t"
            "@p add.rn.f32 %0, y, %0;\n\t}"
            : "+f"(x)
            : "r"(off));
    }
    return x;
}

// x of the lane below; 0 on lane 0.
__device__ __forceinline__ float shfl_up1_or_zero(float x) {
    float y;
    asm("{\n\t.reg .pred p;\n\t"
        "shfl.sync.up.b32 %0|p, %1, 1, 0, 0xffffffff;\n\t"
        "@!p mov.f32 %0, 0f00000000;\n\t}"
        : "=f"(y)
        : "f"(x));
    return y;
}

// Lanes 0-15 get the warp's sum of a and lanes 16-31 its sum of b, each
// with the bits warp_sum gives it: the butterfly's first step trades halves
// (a lane sends its partner the value the partner keeps, and each adds its
// own first, as warp_sum does), the other four steps run on one value, so
// the two sums share five shuffles.
__device__ __forceinline__ float warp_sum_pair(float a, float b, int lane) {
    const bool lo = lane < 16;
    float x = __fadd_rn(lo ? a : b, __shfl_xor_sync(kFullMask, lo ? b : a, 16));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFullMask, x, off));
    return x;
}

constexpr int kEnterThreads = 256;

__global__ void __launch_bounds__(kEnterThreads) composite_weights_entering_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ tau,
    const long long* __restrict__ offsets, const float* __restrict__ t0, int num_rays,
    int rays_per_warp, float dt, float t_thresh, float* __restrict__ w,
    float* __restrict__ weights_sum, float* __restrict__ depth, float* __restrict__ t_out) {
    const int lane = threadIdx.x & 31;
    unsigned lanes_le;  // this lane and those below it
    asm("mov.u32 %0, %%lanemask_le;" : "=r"(lanes_le));
    const long long warp =
        (static_cast<long long>(blockIdx.x) * kEnterThreads + threadIdx.x) >> 5;
    const long long first = warp * rays_per_warp;
    const long long last = min(first + rays_per_warp, static_cast<long long>(num_rays));
    for (long long g = first; g < last; g += 32) {  // groups of up to 32 rays
        const int nr = static_cast<int>(min(32LL, last - g));
        // Lane i holds ray g + i's span (32-bit, from the group's first
        // sample) and entering T, each one coalesced load, and collects
        // the ray's results for one coalesced store.
        const long long b0 = offsets[g];
        int rb = 0, len = 0;
        float rt = 0.f;
        if (lane < nr) {
            const long long b = offsets[g + lane];
            rb = static_cast<int>(b - b0);
            len = static_cast<int>(offsets[g + lane + 1] - b);
            rt = t0[g + lane];
        }
        const float* __restrict__ gs = sigmas + b0;
        const float* __restrict__ gt = tau + b0;
        float* __restrict__ gw = w + b0;
        float o_ws = 0.f, o_dep = 0.f, o_carry = 0.f;
        // The walk over the group's chunks: chunk c (samples c .. c + 31 of
        // the ray) of ray j, whose sigma and tau were loaded one chunk
        // ahead.  A ray with no samples takes one chunk with no valid lane.
        int j = 0, c = 0;
        int base = __shfl_sync(kFullMask, rb, 0), n = __shfl_sync(kFullMask, len, 0);
        float t_in = __shfl_sync(kFullMask, rt, 0);
        float sig = 0.f, ta = 0.f;
        if (lane < n) {
            sig = gs[base + lane];
            ta = gt[base + lane];
        }
        float carry = 0.f;  // optical depth in front of the chunk
        float acc = 0.f;    // weights_sum on lanes 0-15, depth on lanes 16-31
        bool cut = false;   // a sample in front fell below t_thresh
        while (true) {
            int nj = j, nc = c + 32, nbase = base, nn = n;
            if (nc >= n) {  // the ray's last chunk: the next ray's first
                nj = j + 1;
                nc = 0;
                nbase = __shfl_sync(kFullMask, rb, nj & 31);
                nn = __shfl_sync(kFullMask, len, nj & 31);
                if (nj == nr) nn = 0;
            }
            float nsig = 0.f, nta = 0.f;
            if (lane < nn - nc) {
                nsig = gs[nbase + nc + lane];
                nta = gt[nbase + nc + lane];
            }
            // K4's chunk step with the entering T; a lane past the ray's
            // end holds sigma 0, so its sdt is 0 as in K4.
            const bool valid = lane < n - c;
            const float sdt = fminf(__fmul_rn(sig, dt), 100.f);
            const float incl = warp_inclusive_scan_p(sdt);
            const float trans =
                __fmul_rn(t_in, expf(-__fadd_rn(carry, shfl_up1_or_zero(incl))));
            const unsigned out = __ballot_sync(kFullMask, valid && !(trans >= t_thresh));
            // Included: no sample at or in front of this one fell below
            // t_thresh (K4's lane < first_out).
            const bool inc = valid && ((cut ? kFullMask : out) & lanes_le) == 0;
            const float alpha_t = __fmul_rn(__fsub_rn(1.f, expf(-sdt)), trans);
            const float wi = inc ? alpha_t : 0.f;
            if (valid) gw[base + c + lane] = wi;
            acc = __fadd_rn(acc, warp_sum_pair(wi, inc ? __fmul_rn(wi, ta) : 0.f, lane));
            cut = cut || out != 0;
            carry = __fadd_rn(carry, __shfl_sync(kFullMask, incl, 31));
            if (nj != j) {  // the ray is done
                const float ws = __shfl_sync(kFullMask, acc, 0);
                const float dep = __shfl_sync(kFullMask, acc, 16);
                if (lane == j) {
                    o_ws = ws;
                    o_dep = dep;
                    o_carry = carry;
                }
                if (nj == nr) break;
                t_in = __shfl_sync(kFullMask, rt, nj);
                carry = 0.f;
                acc = 0.f;
                cut = false;
            }
            j = nj;
            c = nc;
            base = nbase;
            n = nn;
            sig = nsig;
            ta = nta;
        }
        if (lane < nr) {
            weights_sum[g + lane] = o_ws;
            depth[g + lane] = o_dep;
            t_out[g + lane] = __fmul_rn(rt, expf(-o_carry));
        }
    }
}

__global__ void __launch_bounds__(nst::kThreads) composite_backward_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ ch,
    const float* __restrict__ tau, const float* __restrict__ w,
    const long long* __restrict__ offsets, const int* __restrict__ n_inc,
    const float* __restrict__ g_img, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, int num_rays, int channels, float dt,
    float* __restrict__ d_sigmas, float* __restrict__ d_ch) {
    const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (r >= num_rays) return;  // the whole warp
    const long long begin = offsets[r];
    const long long end = offsets[r + 1];
    const long long stop = begin + n_inc[r];
    const float* gi = g_img + r * channels;
    const float gw = g_ws[r];
    const float gd = g_depth[r];

    if (stop > begin) {
        // Forward: T_{i+1} of every included sample by K4's scan; the last
        // chunk's stays in t_next, earlier chunks' are parked in d_sigmas.
        float carry = 0.f;
        float t_next = 0.f;
        long long last = begin;  // the last chunk's first sample
        for (long long base = begin; base < stop; base += 32) {
            const long long i = base + lane;
            const float sdt = i < stop ? fminf(__fmul_rn(sigmas[i], dt), 100.f) : 0.f;
            const float incl = warp_inclusive_scan(sdt, lane);
            t_next = expf(-__fadd_rn(carry, incl));
            last = base;
            if (base + 32 < stop) {  // a full chunk with more behind it
                d_sigmas[i] = t_next;
                carry = __fadd_rn(carry, __shfl_sync(kFullMask, incl, 31));
            }
        }
        // Reverse, chunk by chunk from the back: suffix = sum_{k>i} w_k v_k,
        // the later chunks' carry plus a reverse scan in this one.
        float later = 0.f;
        for (long long base = last; base >= begin; base -= 32) {
            const long long i = base + lane;
            const bool valid = i < stop;
            float v = 0.f;
            float p = 0.f;
            if (valid) {
                v = __fadd_rn(gw, __fmul_rn(gd, tau[i]));
                const float* chi = ch + i * channels;
                for (int c = 0; c < channels; ++c) v = __fadd_rn(v, __fmul_rn(gi[c], chi[c]));
                p = __fmul_rn(w[i], v);
            }
            const float incl = warp_suffix_scan(p, lane);
            const float excl = __shfl_down_sync(kFullMask, incl, 1);
            if (valid) {
                const float suffix = __fadd_rn(later, lane == 31 ? 0.f : excl);
                const float tn = base == last ? t_next : d_sigmas[i];
                const float dsdt = __fsub_rn(__fmul_rn(tn, v), suffix);
                d_sigmas[i] = __fmul_rn(sigmas[i], dt) < 100.f ? __fmul_rn(dt, dsdt) : 0.f;
            }
            later = __fadd_rn(later, __shfl_sync(kFullMask, incl, 0));
        }
    }
    warp_zero(d_sigmas + stop, end - stop, lane);
    // d ch = w * gI over the included rows and 0 past them: the ray's [n, C]
    // rows as one contiguous span, consecutive lanes on consecutive floats.
    const long long n_in = (stop - begin) * channels;
    float* dst = d_ch + begin * channels;
    for (long long e = lane; e < n_in; e += 32) {
        const long long j = e / channels;
        dst[e] = __fmul_rn(w[begin + j], gi[e - j * channels]);
    }
    warp_zero(dst + n_in, (end - stop) * channels, lane);
}

constexpr int kSegRays = 128;          // rays (one a thread) a CTA
constexpr int kSegSmemFloats = 11776;  // at most 46 KB of dynamic shared memory a CTA
constexpr int kSegMaxTile = 1024;      // samples a staged piece holds at most
constexpr int kSegMaxChannels = 64;

// Samples a staged piece holds for C channels: the shared memory left after
// the [kSegRays, C] sums, over C + 1 floats a sample (4 floats of slack
// let the ch rows keep their 16-byte alignment), a multiple of 4.
__host__ __device__ inline int seg_tile_samples(int channels) {
    const int fit = (kSegSmemFloats - 4 - kSegRays * channels) / (channels + 1);
    return (fit < kSegMaxTile ? fit : kSegMaxTile) & ~3;
}

__host__ __device__ inline int seg_smem_floats(int channels) {
    return kSegRays * channels + seg_tile_samples(channels) * (channels + 1) + 4;
}

// dst[q] = src[q] for q < n, with dst at src's offset modulo 16 bytes:
// scalar head and tail, float4 body.  Every thread of the CTA takes part;
// consecutive threads read consecutive addresses.
__device__ __forceinline__ void stage_floats(const float* __restrict__ src, long long n,
                                             float* dst) {
    const int head = static_cast<int>(
        min(n, static_cast<long long>((4 - (reinterpret_cast<uintptr_t>(src) >> 2 & 3)) & 3)));
    for (int q = threadIdx.x; q < head; q += blockDim.x) dst[q] = src[q];
    const long long body = (n - head) >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    for (long long q = threadIdx.x; q < body; q += blockDim.x) d4[q] = s4[q];
    for (long long q = head + 4 * body + threadIdx.x; q < n; q += blockDim.x) dst[q] = src[q];
}

__global__ void __launch_bounds__(kSegRays)
    segment_sum_kernel(const float* __restrict__ w, const float* __restrict__ ch,
                       const long long* __restrict__ offsets, int num_rays, int channels,
                       float* __restrict__ out) {
    extern __shared__ float4 seg_smem4[];
    __shared__ long long offs[kSegRays + 1];
    const int c_n = channels;
    const int tile = seg_tile_samples(c_n);
    float* sums = reinterpret_cast<float*>(seg_smem4);  // [kSegRays][C]
    float* ws = sums + kSegRays * c_n;                   // [tile]
    float* cs_base = ws + tile;                          // [tile * C + 4], 16-byte aligned
    const int r0 = blockIdx.x * kSegRays;
    const int nr = min(kSegRays, num_rays - r0);
    const int t = threadIdx.x;
    for (int i = t; i <= nr; i += kSegRays) offs[i] = offsets[r0 + i];
    for (int c = 0; c < c_n; ++c) sums[t * c_n + c] = 0.f;
    __syncthreads();
    const long long begin = t < nr ? offs[t] : 0;
    const long long end = t < nr ? offs[t + 1] : 0;
    // The pieces of the span [offs[0], offs[nr]), tile samples each.
    for (long long p0 = offs[0]; p0 < offs[nr]; p0 += tile) {
        const long long n = min(static_cast<long long>(tile), offs[nr] - p0);
        const float* src = ch + p0 * c_n;
        // ch row j of the piece sits at cs[(j - p0) * C], cs at src's
        // offset modulo 16 bytes.
        float* cs = cs_base + (reinterpret_cast<uintptr_t>(src) >> 2 & 3);
        for (int q = t; q < n; q += kSegRays) ws[q] = w[p0 + q];
        stage_floats(src, n * c_n, cs);
        __syncthreads();
        const long long lo = max(begin, p0) - p0;
        const long long hi = min(end, p0 + n) - p0;
        for (int c = 0; c < c_n; ++c) {
            float acc = sums[t * c_n + c];
            for (long long j = lo; j < hi; ++j) {
                acc = __fadd_rn(acc, __fmul_rn(ws[j], cs[j * c_n + c]));
            }
            sums[t * c_n + c] = acc;
        }
        __syncthreads();
    }
    float* dst = out + static_cast<long long>(r0) * c_n;
    for (int e = t; e < nr * c_n; e += kSegRays) dst[e] = sums[e];
}

constexpr int kBwdTile = 1024;         // samples a tile (a CTA's unit of work)
constexpr int kBwdThreads = 256;       // kBwdTile / 4: four samples a thread in the scan
constexpr int kBwdOutFloats = 4096;    // d ch floats a tile stages before writing (16 KB)
constexpr int kBwdCtasPerSm = 8;
static_assert(4 * kBwdThreads == kBwdTile, "the ray scan takes four samples a thread");

// The last ray r of [0, n) with offsets[r] <= key (the ray that holds
// sample key; an empty ray never is), by a warp: 32 probes a step, so a
// step narrows the range 32 times.
__device__ int warp_last_ray_at_most(const long long* __restrict__ offsets, int n, long long key,
                                     int lane) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        const int step = (hi - lo + 32) / 32;
        const int p = lo + lane * step;
        const unsigned ok = __ballot_sync(kFullMask, p <= hi && offsets[p] <= key);
        const int next = lo + (31 - __clz(ok)) * step;  // lane 0 (p = lo) always holds
        hi = min(hi, next + step - 1);
        lo = next;
    }
    return lo;
}

__global__ void __launch_bounds__(kBwdThreads)
segment_sum_backward_kernel(const float* __restrict__ w, const float* __restrict__ ch,
                            const float* __restrict__ g, const long long* __restrict__ offsets,
                            int num_rays, int channels, float* __restrict__ d_ch,
                            float* __restrict__ d_w) {
    __shared__ float4 out4[kBwdOutFloats / 4];
    __shared__ int ray[kBwdTile];  // a sample's ray, counted from the tile's first
    __shared__ int span[2];
    __shared__ int warp_max[kBwdThreads / 32];
    float* out = reinterpret_cast<float*>(out4);
    const int c_n = channels;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const long long num_samples = offsets[num_rays];
    // Samples a staged piece of d ch holds: a multiple of 4, so that each
    // piece starts on a 16-byte boundary of d ch.
    const int piece = kBwdOutFloats / c_n & ~3;
    for (long long s0 = static_cast<long long>(blockIdx.x) * kBwdTile; s0 < num_samples;
         s0 += static_cast<long long>(gridDim.x) * kBwdTile) {
        const int n = static_cast<int>(min(static_cast<long long>(kBwdTile), num_samples - s0));
        if (warp < 2) {
            const int r = warp_last_ray_at_most(offsets, num_rays, s0 + (warp ? n - 1 : 0), lane);
            if (lane == 0) span[warp] = r;
        }
        for (int q = t; q < kBwdTile; q += kBwdThreads) ray[q] = 0;
        __syncthreads();
        const int r0 = span[0], nr = span[1] - span[0] + 1;
        // Each non-empty ray after the first marks the sample it starts at
        // (an empty ray marks nothing: the next ray starts there); the first
        // ray holds sample 0.
        for (int j = 1 + t; j < nr; j += kBwdThreads) {
            const long long a = offsets[r0 + j] - s0;
            if (a < offsets[r0 + j + 1] - s0) ray[a] = j;
        }
        __syncthreads();
        // A sample's ray: the running max of the marks (an inclusive scan,
        // four samples a thread, then across lanes and warps).
        int m[4], run = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            run = max(run, ray[4 * t + k]);
            m[k] = run;
        }
        int scan = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kFullMask, scan, d);
            if (lane >= d) scan = max(scan, up);
        }
        if (lane == 31) warp_max[warp] = scan;
        const int prev = __shfl_up_sync(kFullMask, scan, 1);
        __syncthreads();
        int before = lane > 0 ? prev : 0;  // the max over the samples in front
        for (int k = 0; k < warp; ++k) before = max(before, warp_max[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) ray[4 * t + k] = max(before, m[k]);
        __syncthreads();
        const float* gr = g + static_cast<long long>(r0) * c_n;
        for (int p0 = 0; p0 < n; p0 += piece) {
            const int m_n = min(piece, n - p0);
            // A thread a sample: its C products (and d w, in order of c)
            // into the staged piece.
            for (int q = t; q < m_n; q += kBwdThreads) {
                const long long i = s0 + p0 + q;
                const float wi = w[i];
                const float* gq = gr + ray[p0 + q] * c_n;
                float* o = out + q * c_n;
                for (int c = 0; c < c_n; ++c) o[c] = __fmul_rn(wi, gq[c]);
                if (d_w != nullptr) {
                    const float* row = ch + i * c_n;
                    float acc = 0.f;
                    for (int c = 0; c < c_n; ++c) acc = __fadd_rn(acc, __fmul_rn(row[c], gq[c]));
                    d_w[i] = acc;
                }
            }
            __syncthreads();
            // The piece's [m_n, C] block of d ch, flat: 16 bytes a thread.
            float* dst = d_ch + (s0 + p0) * c_n;
            const int total = m_n * c_n, body = total >> 2;
            for (int v = t; v < body; v += kBwdThreads) {
                reinterpret_cast<float4*>(dst)[v] = out4[v];
            }
            for (int e = 4 * body + t; e < total; e += kBwdThreads) dst[e] = out[e];
            __syncthreads();
        }
    }
}

}  // namespace

// sigmas, tau [M] f32; offsets [N+1] i64; w [M], weights_sum [N], depth [N] f32,
// n_inc [N] i32.
NST_API int nst_composite_weights(const void* sigmas, const void* tau, const void* offsets,
                                  int num_rays, float dt, float t_thresh, void* w,
                                  void* weights_sum, void* depth, void* n_inc, void* stream) {
    if (num_rays <= 0) return 0;
    const long long threads = static_cast<long long>(num_rays) * 32;  // a warp a ray
    composite_weights_kernel<<<nst::blocks_for(threads), nst::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(tau),
        static_cast<const long long*>(offsets), num_rays, dt, t_thresh, static_cast<float*>(w),
        static_cast<float*>(weights_sum), static_cast<float*>(depth), static_cast<int*>(n_inc));
    return nst::launch_status();
}

// sigmas, tau [M] f32; offsets [N+1] i64; t0 [N] f32 -> w [M], weights_sum [N],
// depth [N], t_out [N] f32.
NST_API int nst_composite_weights_entering(const void* sigmas, const void* tau,
                                           const void* offsets, const void* t0, int num_rays,
                                           float dt, float t_thresh, void* w, void* weights_sum,
                                           void* depth, void* t_out, void* stream) {
    if (num_rays <= 0) return 0;
    // About one wave of resident warps, each walking a contiguous block of
    // rays.
    static long long resident_warps = 0;
    if (resident_warps == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, composite_weights_entering_kernel,
                                                      kEnterThreads, 0);
        resident_warps = std::max(1LL, static_cast<long long>(sms) * per_sm * kEnterThreads / 32);
    }
    const int rays_per_warp = static_cast<int>((num_rays + resident_warps - 1) / resident_warps);
    const long long warps = (num_rays + rays_per_warp - 1) / rays_per_warp;
    composite_weights_entering_kernel<<<nst::blocks_for(warps * 32, kEnterThreads),
                                        kEnterThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(tau),
        static_cast<const long long*>(offsets), static_cast<const float*>(t0), num_rays,
        rays_per_warp, dt, t_thresh, static_cast<float*>(w), static_cast<float*>(weights_sum),
        static_cast<float*>(depth), static_cast<float*>(t_out));
    return nst::launch_status();
}

// sigmas, tau, w [M] f32; ch [M, C] f32; offsets [N+1] i64; n_inc [N] i32;
// g_img [N, C], g_ws [N], g_depth [N] f32 -> d_sigmas [M], d_ch [M, C] f32.
NST_API int nst_composite_backward(const void* sigmas, const void* ch, const void* tau,
                                   const void* w, const void* offsets, const void* n_inc,
                                   const void* g_img, const void* g_ws, const void* g_depth,
                                   int num_rays, int channels, float dt, void* d_sigmas,
                                   void* d_ch, void* stream) {
    if (num_rays <= 0) return 0;
    const long long threads = static_cast<long long>(num_rays) * 32;  // a warp a ray
    composite_backward_kernel<<<nst::blocks_for(threads), nst::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(ch),
        static_cast<const float*>(tau), static_cast<const float*>(w),
        static_cast<const long long*>(offsets), static_cast<const int*>(n_inc),
        static_cast<const float*>(g_img), static_cast<const float*>(g_ws),
        static_cast<const float*>(g_depth), num_rays, channels, dt,
        static_cast<float*>(d_sigmas), static_cast<float*>(d_ch));
    return nst::launch_status();
}

// w [S] f32, ch [S, C] f32 (C <= 64), offsets [N+1] i64, out [N, C] f32.
NST_API int nst_segment_sum(const void* w, const void* ch, const void* offsets, int num_rays,
                            int channels, void* out, void* stream) {
    if (channels > kSegMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
    if (num_rays <= 0 || channels <= 0) return 0;
    segment_sum_kernel<<<nst::blocks_for(num_rays, kSegRays), kSegRays,
                         sizeof(float) * seg_smem_floats(channels),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(ch),
        static_cast<const long long*>(offsets), num_rays, channels, static_cast<float*>(out));
    return nst::launch_status();
}

// w [S] f32, ch [S, C] f32 (read only for d_w), g [N, C] f32 (C <= 64), offsets [N+1]
// i64 covering the stream (offsets[0] = 0, offsets[N] = S) -> d_ch [S, C] f32
// and, when d_w is not null, d_w [S] f32.
NST_API int nst_segment_sum_backward(const void* w, const void* ch, const void* g,
                                     const void* offsets, int num_rays, int channels,
                                     void* d_ch, void* d_w, void* stream) {
    if (channels > kSegMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
    if (num_rays <= 0 || channels <= 0) return 0;
    // The stream's length is on the device (offsets[N]): a grid of a few
    // CTAs an SM walks its tiles.
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 1;
    }
    segment_sum_backward_kernel<<<sms * kBwdCtasPerSm, kBwdThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(ch),
        static_cast<const float*>(g), static_cast<const long long*>(offsets), num_rays,
        channels, static_cast<float*>(d_ch), static_cast<float*>(d_w));
    return nst::launch_status();
}
