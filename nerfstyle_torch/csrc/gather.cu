// P0: row gather, out[i, :] = table[idx[i], :].
//
// Replaces the one pl.pallas_call of the repository,
// tools/exp_encoder_r4.py:exp_mosaic_dyngather (:108-128): a kernel body
// jnp.take(tab, idx, axis=0) over a [1024, 128] f32 table and 256 int32
// indices, a TPU experiment on dim-0 dynamic gathers in VMEM.  Its domain is
// 0 <= idx < T, as P0 draws its indices; the kernel does not check it.  On a
// path it gathers the incremental renderer's rounds: 16-byte [xyz, tau]
// rows, or 32-byte [xyz, tau, dirs, 0] rows for the view-dependent fields,
// at positions that come in ascending runs of up to a round's size a ray.
//
// Bound on the H100: bytes (each output row read once from the table and
// written once; no arithmetic).  A thread a piece over the flattened output:
// a row is q pieces of 16 bytes (one float each where the width is not a
// multiple of 4 floats or the table is not 16-byte aligned), and thread t
// moves piece t % q of row t / q.  Consecutive threads write consecutive
// pieces, so each warp's store is one contiguous 512-byte span (128 bytes
// on the scalar path) at any row width, and ascending positions make the
// loads contiguous runs too; a 16-byte row busies one thread, not one warp.
// Each thread reads its row's index once (neighbours on one row share it
// through L1).  The grid holds a thread a piece, so the blocks in flight
// write one compact stretch of the output: a grid capped at four waves of
// resident blocks, each thread striding over 31 pieces, took 8% longer at
// 2^20 rows of 512 bytes (chip_smoke.py --round-kernels, PERF.md) and no
// less on the rounds.  The grid-stride loop only covers grids past the
// launch limit.  64-bit index arithmetic throughout, shifts where q is a
// power of two.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = (1LL << 31) - 1;  // gridDim.x's limit

template <bool kVec4, bool kPow2>
__global__ void __launch_bounds__(kThreads)
    take_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                     long long pieces, long long q, int shift, float* __restrict__ out) {
    using Piece = typename std::conditional<kVec4, float4, float>::type;
    const Piece* __restrict__ src = reinterpret_cast<const Piece*>(table);
    Piece* __restrict__ dst = reinterpret_cast<Piece*>(out);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < pieces;
         t += stride) {
        const long long row = kPow2 ? t >> shift : t / q;
        const long long k = kPow2 ? t & (q - 1) : t - row * q;
        dst[t] = __ldg(src + static_cast<long long>(__ldg(idx + row)) * q + k);
    }
}

template <bool kVec4>
void launch(const float* t, const int* ix, long long n, long long q, float* o, cudaStream_t s) {
    const long long pieces = n * q;
    const unsigned blocks =
        static_cast<unsigned>(std::min((pieces + kThreads - 1) / kThreads, kMaxBlocks));
    int shift = 0;
    while ((1LL << shift) < q) ++shift;
    if ((1LL << shift) == q)
        take_rows_kernel<kVec4, true><<<blocks, kThreads, 0, s>>>(t, ix, pieces, q, shift, o);
    else
        take_rows_kernel<kVec4, false><<<blocks, kThreads, 0, s>>>(t, ix, pieces, q, shift, o);
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
    const bool vec4 = c % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(o) % 16 == 0;
    if (vec4)
        launch<true>(t, ix, n, c / 4, o, s);
    else
        launch<false>(t, ix, n, c, o, s);
    return nst::launch_status();
}
