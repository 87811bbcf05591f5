// K5d: spherical-harmonics direction encoding, and the colour head's input
// built around it.
//
// Replaces nerfstyle_tpu/ops/sh.py:sh_encode, the color head's view-direction
// input (the style field under use_dir, models/fields.py:251-253 and
// :311-314; the base field's rgb_net, :333-336): the real SH basis of degree
// 1-4 with tiny-cuda-nn's constants of d = d01 * 2 - 1, d01 [M, 3] in
// [0, 1], written [M, deg^2].  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction), in the JAX order
// of operations, so the kernel gives the plain PyTorch version's bits.
//
// Two entries of one kernel template:
//   (a) nst_sh_encode: d01 [M, 3] -> [M, deg^2], JAX's sh_encode;
//   (b) nst_sh_assemble: feat [M, k] (any row stride) and raw dirs [M, 3]
//       -> the color MLP's whole input [M, W]: feat in columns [0, k), the
//       basis of (dirs + 1) / 2 in [k, k + deg^2), zeros up to W (K5's input
//       width).  JAX's (and the plain version's) add, divide and concat,
//       and the zero padding K5 needs, in one pass.  (d + 1) / 2 is computed
//       as __fadd_rn(d, 1) * 0.5: halving is exact, so these are the bits of
//       torch's (dirs + 1.0) / 2.0.
//
// Bound on the H100: bytes (12 B in and 4 W B out a row, plus 4k B of feat,
// against ~45 flops).  A warp takes 32 consecutive rows: it reads their
// 96 direction floats (and their 32 x k feature floats) with coalesced loads
// into shared memory, each lane evaluates one row's basis into the warp's
// output tile there (an odd row stride: the lanes' scalar writes fall in 32
// banks), and the warp writes the tile, 32 x W contiguous floats, back in
// 16-byte stores, 512 contiguous bytes an instruction.  Warps walk the tiles
// grid-stride, with as many CTAs as the SMs hold at once.
#include "common.cuh"

namespace {

constexpr int kTileRows = 32;  // rows a warp takes at a time: one a lane
constexpr int kWarps = nst::kThreads / 32;

// The basis of one direction d01 in [0, 1]^3 into v[0 .. DEG^2).
template <int DEG>
__device__ __forceinline__ void sh_basis(float d0, float d1, float d2, float* v) {
    const float x = __fsub_rn(__fmul_rn(d0, 2.0f), 1.0f);
    const float y = __fsub_rn(__fmul_rn(d1, 2.0f), 1.0f);
    const float z = __fsub_rn(__fmul_rn(d2, 2.0f), 1.0f);
    v[0] = 0.28209479177387814f;
    if constexpr (DEG >= 2) {
        v[1] = __fmul_rn(-0.48860251190291987f, y);
        v[2] = __fmul_rn(0.48860251190291987f, z);
        v[3] = __fmul_rn(-0.48860251190291987f, x);
    }
    if constexpr (DEG >= 3) {
        const float xy = __fmul_rn(x, y), yz = __fmul_rn(y, z), xz = __fmul_rn(x, z);
        const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y), z2 = __fmul_rn(z, z);
        v[4] = __fmul_rn(1.0925484305920792f, xy);
        v[5] = __fmul_rn(-1.0925484305920792f, yz);
        v[6] = __fsub_rn(__fmul_rn(0.94617469575755997f, z2), 0.31539156525251999f);
        v[7] = __fmul_rn(-1.0925484305920792f, xz);
        v[8] = __fmul_rn(0.54627421529603959f, __fsub_rn(x2, y2));
        if constexpr (DEG >= 4) {
            const float one_m_5z2 = __fsub_rn(1.0f, __fmul_rn(5.0f, z2));
            v[9] = __fmul_rn(__fmul_rn(0.59004358992664352f, y),
                             __fadd_rn(__fmul_rn(-3.0f, x2), y2));
            v[10] = __fmul_rn(__fmul_rn(__fmul_rn(2.8906114426405538f, x), y), z);
            v[11] = __fmul_rn(__fmul_rn(0.45704579946446572f, y), one_m_5z2);
            v[12] = __fmul_rn(__fmul_rn(0.3731763325901154f, z),
                              __fsub_rn(__fmul_rn(5.0f, z2), 3.0f));
            v[13] = __fmul_rn(__fmul_rn(0.45704579946446572f, x), one_m_5z2);
            v[14] = __fmul_rn(__fmul_rn(1.4453057213202769f, z), __fsub_rn(x2, y2));
            v[15] = __fmul_rn(__fmul_rn(0.59004358992664352f, x),
                              __fadd_rn(-x2, __fmul_rn(3.0f, y2)));
        }
    }
}

// ASSEMBLE false: entry (a), W = DEG^2, dirs are d01, no feat.  ASSEMBLE
// true: entry (b), dirs raw, feat [M, k] at row stride ldf, k + DEG^2 <= W.
template <int DEG, int W, bool ASSEMBLE>
__global__ void __launch_bounds__(nst::kThreads)
    sh_kernel(const float* __restrict__ dirs, const float* __restrict__ feat, long long ldf,
              int k, long long m, float* __restrict__ out) {
    constexpr int S = W % 2 ? W : W + 1;  // the tile's row stride in shared memory: odd
    __shared__ float s_dirs[kWarps][3 * kTileRows];
    __shared__ float s_tile[kWarps][kTileRows * S];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* sd = s_dirs[warp];
    float* st = s_tile[warp];
    // f / k for f < 32 k <= 1024 as (f * magic) >> 16: exact, since the
    // error f / 2^16 < 1/64 stays below 1/k.
    const unsigned magic = ASSEMBLE && k > 0 ? (65536u + k - 1) / k : 0u;
    const long long tiles = (m + kTileRows - 1) / kTileRows;
    for (long long t = static_cast<long long>(blockIdx.x) * kWarps + warp; t < tiles;
         t += static_cast<long long>(gridDim.x) * kWarps) {
        const long long row0 = t * kTileRows;
        const int rows = m - row0 < kTileRows ? static_cast<int>(m - row0) : kTileRows;
        const float* dp = dirs + row0 * 3;
#pragma unroll
        for (int e = lane; e < 3 * kTileRows; e += 32)
            if (e < 3 * rows) sd[e] = __ldg(dp + e);
        if constexpr (ASSEMBLE) {
            const float* fp = feat + row0 * ldf;
            for (int f = lane; f < rows * k; f += 32) {
                const int r = static_cast<int>((static_cast<unsigned>(f) * magic) >> 16);
                const int c = f - r * k;
                st[r * S + c] = __ldg(fp + r * ldf + c);
            }
        }
        __syncwarp();
        if (lane < rows) {
            float d[3] = {sd[3 * lane], sd[3 * lane + 1], sd[3 * lane + 2]};
            if constexpr (ASSEMBLE) {
#pragma unroll
                for (int i = 0; i < 3; ++i) d[i] = __fmul_rn(__fadd_rn(d[i], 1.0f), 0.5f);
            }
            float v[DEG * DEG];
            sh_basis<DEG>(d[0], d[1], d[2], v);
            float* tr = st + lane * S + (ASSEMBLE ? k : 0);
#pragma unroll
            for (int j = 0; j < DEG * DEG; ++j) tr[j] = v[j];
            if constexpr (ASSEMBLE) {
                for (int j = k + DEG * DEG; j < W; ++j) st[lane * S + j] = 0.0f;
            }
        }
        __syncwarp();
        // The tile is rows x W contiguous floats of out, starting 16-byte
        // aligned (row0 is a multiple of 32).
        float* op = out + row0 * W;
        const int n = rows * W;
        for (int e = 4 * lane; e < n; e += 128) {
            if (e + 4 <= n) {
                float q[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) q[i] = st[(e + i) / W * S + (e + i) % W];
                *reinterpret_cast<float4*>(op + e) = make_float4(q[0], q[1], q[2], q[3]);
            } else {
                for (int i = e; i < n; ++i) op[i] = st[i / W * S + i % W];
            }
        }
        __syncwarp();
    }
}

// CTAs: enough for a tile a warp, and at most as many as the SMs hold at
// once (the occupancy query, once an instantiation).
template <int DEG, int W, bool ASSEMBLE>
int launch(const float* dirs, const float* feat, long long ldf, int k, long long m, float* out,
           cudaStream_t stream) {
    static int most = 0;
    if (most == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, sh_kernel<DEG, W, ASSEMBLE>, nst::kThreads, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
        most = (per_sm > 0 ? per_sm : 1) * sms;
    }
    const long long ctas = (m + kTileRows * kWarps - 1) / (kTileRows * kWarps);
    sh_kernel<DEG, W, ASSEMBLE><<<static_cast<unsigned>(ctas < most ? ctas : most), nst::kThreads,
                                  0, stream>>>(dirs, feat, ldf, k, m, out);
    return nst::launch_status();
}

template <int W>
int launch_assemble(const float* dirs, const float* feat, long long ldf, int k, long long m,
                    int degree, float* out, cudaStream_t s) {
    if (k < 0 || k + degree * degree > W) return static_cast<int>(cudaErrorInvalidValue);
    switch (degree) {
        case 1: return launch<1, W, true>(dirs, feat, ldf, k, m, out, s);
        case 2: return launch<2, W, true>(dirs, feat, ldf, k, m, out, s);
        case 3: return launch<3, W, true>(dirs, feat, ldf, k, m, out, s);
        case 4: return launch<4, W, true>(dirs, feat, ldf, k, m, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Entry (a).  d01 [M, 3] f32, out [M, degree^2] f32, both contiguous (out
// 16-byte aligned, as PyTorch allocates).  cudaErrorInvalidValue for a
// degree outside 1..4.
NST_API int nst_sh_encode(const void* d01, long long m, int degree, void* out, void* stream) {
    if (m <= 0) return 0;
    const float* d = static_cast<const float*>(d01);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (degree) {
        case 1: return launch<1, 1, false>(d, nullptr, 0, 0, m, o, s);
        case 2: return launch<2, 4, false>(d, nullptr, 0, 0, m, o, s);
        case 3: return launch<3, 9, false>(d, nullptr, 0, 0, m, o, s);
        case 4: return launch<4, 16, false>(d, nullptr, 0, 0, m, o, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Entry (b).  feat [M, k] f32 with unit column stride and row stride ldf
// (elements; any offset), dirs [M, 3] f32 contiguous, out [M, width] f32
// contiguous and 16-byte aligned.  cudaErrorInvalidValue for a width other
// than 16 or 32 (K5's input widths), a degree outside 1..4, or k + degree^2
// above the width.
NST_API int nst_sh_assemble(const void* feat, long long ldf, int k, const void* dirs, long long m,
                            int degree, int width, void* out, void* stream) {
    if (m <= 0) return 0;
    const float* f = static_cast<const float*>(feat);
    const float* d = static_cast<const float*>(dirs);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (width) {
        case 16: return launch_assemble<16>(d, f, ldf, k, m, degree, o, s);
        case 32: return launch_assemble<32>(d, f, ldf, k, m, degree, o, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
