// K5d: spherical-harmonics direction encoding.
//
// Replaces nerfstyle_tpu/ops/sh.py:sh_encode, the color head's view-direction
// input (the style field under use_dir, models/fields.py:251-253 and
// :311-314; the base field's rgb_net, :333-336): the real SH basis of degree
// 1-4 with tiny-cuda-nn's constants of d = d01 * 2 - 1, d01 [M, 3] in
// [0, 1], written [M, deg^2].  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction), in the JAX order
// of operations, so the kernel gives the plain PyTorch version's bits.
//
// Bound on the H100: bytes (12 B in, 4 deg^2 B out a row against ~40 flops).
// One thread a row: three 4-byte loads, whose neighbours' addresses are
// contiguous across the warp, and at degree 4 four 16-byte stores of the
// row's 64 bytes (degree 2 one; degree 1 and 3 scalar stores), which the L2
// merges into whole sectors before they reach memory.  The fused form
// (the basis evaluated in the prologue of K5's color2 chain, no [M, 16]
// round trip) is later work.
#include "common.cuh"

namespace {

template <int DEG>
__global__ void __launch_bounds__(nst::kThreads)
    sh_encode_kernel(const float* __restrict__ d01, long long m, float* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const float x = __fsub_rn(__fmul_rn(__ldg(d01 + 3 * i), 2.0f), 1.0f);
    const float y = __fsub_rn(__fmul_rn(__ldg(d01 + 3 * i + 1), 2.0f), 1.0f);
    const float z = __fsub_rn(__fmul_rn(__ldg(d01 + 3 * i + 2), 2.0f), 1.0f);
    float v[DEG * DEG];
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
    float* row = out + i * (DEG * DEG);
    if constexpr (DEG == 2 || DEG == 4) {
#pragma unroll
        for (int k = 0; k < DEG * DEG; k += 4)
            *reinterpret_cast<float4*>(row + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < DEG * DEG; ++k) row[k] = v[k];
    }
}

template <int DEG>
int launch(const float* d01, long long m, float* out, cudaStream_t stream) {
    sh_encode_kernel<DEG><<<nst::blocks_for(m), nst::kThreads, 0, stream>>>(d01, m, out);
    return nst::launch_status();
}

}  // namespace

// d01 [M, 3] f32, out [M, degree^2] f32 (16-byte aligned, as PyTorch
// allocates).  cudaErrorInvalidValue for a degree outside 1..4.
NST_API int nst_sh_encode(const void* d01, long long m, int degree, void* out, void* stream) {
    if (m <= 0) return 0;
    const float* d = static_cast<const float*>(d01);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (degree) {
        case 1: return launch<1>(d, m, o, s);
        case 2: return launch<2>(d, m, o, s);
        case 3: return launch<3>(d, m, o, s);
        case 4: return launch<4>(d, m, o, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
