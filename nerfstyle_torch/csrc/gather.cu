// P0: row gather, out[i, :] = table[idx[i], :].
//
// Replaces the one pl.pallas_call of the repository,
// tools/exp_encoder_r4.py:exp_mosaic_dyngather (:108-128): a kernel body
// jnp.take(tab, idx, axis=0) over a [1024, 128] f32 table and 256 int32
// indices, a TPU experiment on dim-0 dynamic gathers in VMEM.  Its domain is
// 0 <= idx < T, as P0 draws its indices; the kernel does not check it.
//
// Bound on the H100: bytes (each output row read once from the table and
// written once; no arithmetic).  A warp a row: lane l moves the row's
// 16-byte pieces l, l + 32, ... (a 128-float row is one float4 a lane), so
// each load and each store of a warp is one contiguous 512-byte span.  Rows
// whose width is not a multiple of 4 floats, or a table that is not 16-byte
// aligned, move one float at a time in the same pattern.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    take_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                     long long n, long long c, float* __restrict__ out) {
    const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
    if (row >= n) return;
    const int lane = threadIdx.x % 32;
    const long long src = static_cast<long long>(__ldg(idx + row));
    if constexpr (kVec4) {
        const float4* s = reinterpret_cast<const float4*>(table + src * c);
        float4* d = reinterpret_cast<float4*>(out + row * c);
        for (long long k = lane; k < c / 4; k += 32) d[k] = __ldg(s + k);
    } else {
        const float* s = table + src * c;
        float* d = out + row * c;
        for (long long k = lane; k < c; k += 32) d[k] = __ldg(s + k);
    }
}

}  // namespace

// table [T, C] f32, idx [N] int32, each in [0, T); out [N, C] f32.
NST_API int nst_take_rows(const void* table, const void* idx, long long n, long long c, void* out,
                          void* stream) {
    if (n <= 0 || c <= 0) return 0;
    const float* t = static_cast<const float*>(table);
    const int* ix = static_cast<const int*>(idx);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const bool vec4 = c % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(o) % 16 == 0;
    if (vec4)
        take_rows_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, s>>>(t, ix, n, c, o);
    else
        take_rows_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, s>>>(t, ix, n, c, o);
    return nst::launch_status();
}
