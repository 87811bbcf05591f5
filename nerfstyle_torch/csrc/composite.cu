// K4 (forward and backward) and K7: per-ray passes over a ray-major sample
// stream.
//
// Both take ray offsets [N+1] (int64): ray r owns samples offsets[r] ..
// offsets[r+1]-1, as the marcher (march.cu) and the significance
// compaction emit them.  Neither needs atomics, and both sum in stream order,
// so results are deterministic.
//
// K4 replaces nerfstyle_tpu/ops/compositing.py:sample_weights (significance,
// segment_exclusive_cumsum) plus the per-ray weights_sum and depth sums of
// render/renderer.py:make_two_phase_renderer.  Per ray, front to back:
//     sdt_i = min(sigma_i * dt, 100), alpha_i = 1 - exp(-sdt_i),
//     T_i = exp(-sum_{j<i} sdt_j), w_i = alpha_i * T_i while T_i >= t_thresh,
//     weights_sum = sum w_i, depth = sum w_i * tau_i.
// The JAX form takes a flat fp32 cumsum over the whole stream minus per-ray
// totals, which loses digits as the stream grows; this kernel accumulates
// each ray's optical depth on its own, front to back, and stops at the first
// sample with T < t_thresh (T never rises again, so every later w is 0).
// It also writes each ray's included count n_inc: the samples with entering
// T >= t_thresh, the prefix a train step's phase B keeps.
//
// K4 backward replaces JAX's autodiff of ops/compositing.py:composite_rays
// (:116-148) with the reference's composite_rays_train_backward, given the
// cotangents gI [N, C] of the image, gW [N] of weights_sum and gD [N] of
// depth.  With v_i = gI . ch_i + gW + gD * tau_i, over a ray's n_inc
// included samples:
//     d ch_i  = w_i * gI,
//     d sdt_i = T_{i+1} * v_i - sum_{k>i} w_k * v_k,   T_{i+1} = T_i e^{-sdt_i},
//     d sigma_i = dt * d sdt_i where sigma_i * dt < 100 (the cap), else 0,
// and 0 for every sample past the cutoff.  One thread per ray makes two
// passes: forward, it recomputes T_{i+1} exactly as the forward pass does
// and parks it in d_sigma; then in reverse it accumulates the suffix sum
// from the back, so no late sample's gradient is a difference of two large
// prefix sums.  This also makes channels' gradients exact products.
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
// when asked, d w_i = sum_c ch[i, c] * g[r, c].  One warp a ray: its lanes
// walk the ray's contiguous rows of d ch, so the writes coalesce; no atomics.
//
// Bound on the H100: bytes (a few flops per 4-byte sample value).  K4 and
// K4b run one thread per ray walking its contiguous segment; a warp's
// threads read different segments, so their loads coalesce poorly (a
// warp-per-ray scan is the faster form, left for later).
#include "common.cuh"

namespace {

__global__ void composite_weights_kernel(const float* __restrict__ sigmas,
                                         const float* __restrict__ tau,
                                         const long long* __restrict__ offsets, int num_rays,
                                         float dt, float t_thresh, float* __restrict__ w,
                                         float* __restrict__ weights_sum,
                                         float* __restrict__ depth, int* __restrict__ n_inc) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= num_rays) return;
    const long long begin = offsets[r];
    const long long end = offsets[r + 1];
    float od = 0.f;  // optical depth in front of sample i
    float ws = 0.f;
    float dep = 0.f;
    long long i = begin;
    for (; i < end; ++i) {
        const float trans = expf(-od);
        if (!(trans >= t_thresh)) break;
        const float sdt = fminf(__fmul_rn(sigmas[i], dt), 100.f);
        const float wi = __fmul_rn(__fsub_rn(1.f, expf(-sdt)), trans);
        w[i] = wi;
        ws = __fadd_rn(ws, wi);
        dep = __fadd_rn(dep, __fmul_rn(wi, tau[i]));
        od = __fadd_rn(od, sdt);
    }
    n_inc[r] = static_cast<int>(i - begin);
    for (; i < end; ++i) w[i] = 0.f;
    weights_sum[r] = ws;
    depth[r] = dep;
}

__global__ void composite_backward_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ ch,
    const float* __restrict__ tau, const float* __restrict__ w,
    const long long* __restrict__ offsets, const int* __restrict__ n_inc,
    const float* __restrict__ g_img, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, int num_rays, int channels, float dt,
    float* __restrict__ d_sigmas, float* __restrict__ d_ch) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= num_rays) return;
    const long long begin = offsets[r];
    const long long end = offsets[r + 1];
    const long long stop = begin + n_inc[r];
    const float* gi = g_img + static_cast<long long>(r) * channels;
    const float gw = g_ws[r];
    const float gd = g_depth[r];

    // Forward: T_{i+1} of every included sample, parked in d_sigmas.
    float od = 0.f;
    for (long long i = begin; i < stop; ++i) {
        od = __fadd_rn(od, fminf(__fmul_rn(sigmas[i], dt), 100.f));
        d_sigmas[i] = expf(-od);
    }
    // Reverse: suffix = sum_{k>i} w_k v_k.
    float suffix = 0.f;
    for (long long i = stop - 1; i >= begin; --i) {
        const float* chi = ch + i * channels;
        float* dchi = d_ch + i * channels;
        const float wi = w[i];
        float v = __fadd_rn(gw, __fmul_rn(gd, tau[i]));
        for (int c = 0; c < channels; ++c) {
            v = __fadd_rn(v, __fmul_rn(gi[c], chi[c]));
            dchi[c] = __fmul_rn(wi, gi[c]);
        }
        const float dsdt = __fsub_rn(__fmul_rn(d_sigmas[i], v), suffix);
        d_sigmas[i] = __fmul_rn(sigmas[i], dt) < 100.f ? __fmul_rn(dt, dsdt) : 0.f;
        suffix = __fadd_rn(suffix, __fmul_rn(wi, v));
    }
    for (long long i = stop; i < end; ++i) {
        d_sigmas[i] = 0.f;
        for (int c = 0; c < channels; ++c) d_ch[i * channels + c] = 0.f;
    }
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

__global__ void segment_sum_backward_kernel(const float* __restrict__ w,
                                            const float* __restrict__ ch,
                                            const float* __restrict__ g,
                                            const long long* __restrict__ offsets, int num_rays,
                                            int channels, float* __restrict__ d_ch,
                                            float* __restrict__ d_w) {
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= num_rays) return;
    const long long begin = offsets[warp];
    const long long end = offsets[warp + 1];
    const float* gr = g + warp * channels;
    const long long n = (end - begin) * channels;
    float* dst = d_ch + begin * channels;
    for (long long e = lane; e < n; e += 32) {
        const long long i = e / channels;
        dst[e] = __fmul_rn(w[begin + i], gr[e - i * channels]);
    }
    if (d_w != nullptr) {
        for (long long i = begin + lane; i < end; i += 32) {
            float acc = 0.f;
            for (int c = 0; c < channels; ++c) {
                acc = __fadd_rn(acc, __fmul_rn(ch[i * channels + c], gr[c]));
            }
            d_w[i] = acc;
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
    composite_weights_kernel<<<nst::blocks_for(num_rays), nst::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(tau),
        static_cast<const long long*>(offsets), num_rays, dt, t_thresh, static_cast<float*>(w),
        static_cast<float*>(weights_sum), static_cast<float*>(depth), static_cast<int*>(n_inc));
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
    composite_backward_kernel<<<nst::blocks_for(num_rays), nst::kThreads, 0,
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

// w [S] f32, ch [S, C] f32 (read only for d_w), g [N, C] f32, offsets [N+1]
// i64 covering the stream (offsets[0] = 0, offsets[N] = S) -> d_ch [S, C] f32
// and, when d_w is not null, d_w [S] f32.
NST_API int nst_segment_sum_backward(const void* w, const void* ch, const void* g,
                                     const void* offsets, int num_rays, int channels,
                                     void* d_ch, void* d_w, void* stream) {
    if (num_rays <= 0 || channels <= 0) return 0;
    const long long threads = static_cast<long long>(num_rays) * 32;
    segment_sum_backward_kernel<<<nst::blocks_for(threads), nst::kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(ch),
        static_cast<const float*>(g), static_cast<const long long*>(offsets), num_rays,
        channels, static_cast<float*>(d_ch), static_cast<float*>(d_w));
    return nst::launch_status();
}
