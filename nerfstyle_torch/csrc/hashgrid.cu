// K1: multiresolution hash-grid encode, forward, and K2: its table gradient.
//
// K1 replaces the JAX encoder nerfstyle_tpu/ops/hashgrid.py:hashgrid_encode ->
// _encode_fast -> _encode_flat, on trilinear levels (_flat_block_tri) and on
// simplex levels (K1s: _flat_block_simplex, _simplex_ranks, _simplex_sorted,
// the levels >= simplex_start of _flat_corners).  K2 replaces its custom
// backward _encode_fast_bwd -> _sort_scatter (and the corner-dedup variant
// _dedup_bwd), on both kinds of level (K2s: the rows4/w4 stream): see
// hashgrid_backward_kernel below.
//
// A trilinear level: out[b, l*C + c] = sum over the 8 cell corners s of
//     table[(hash_s % size_l) + offset_l, c] * w_s,
// hash_s = XOR_d (uint32(pg_d + bit_d(s)) * prime_d) with uint32 wraparound,
// w_s = prod_d (bit ? frac_d : 1 - frac_d).  A simplex level (Freudenthal
// triangulation of the cell) sums 4 vertices v = 0..3 instead: with the
// fractions' strict descending ranks (ties broken x before y before z) and
// sorted fractions s1 >= s2 >= s3 (s2 = fx + fy + fz - s1 - s3), vertex v
// includes axis d iff rank_d < v, is hashed as the trilinear corner with
// the same integer coordinates, and weighs 1 - s1, s1 - s2, s2 - s3, s3.
// Rows of points outside [0, 1]^3 are zero.  The arithmetic follows the JAX
// order step for step and rounds every product and sum on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), so the kernel gives the
// plain PyTorch version's bits.
//
// Bound on the H100: bytes.  Each (point, level) reads 8 (simplex: 4)
// random [C]-wide table rows (8 or 16 bytes) and does ~60 flops, far below
// the card's flop/byte balance.  A level's table is at most 2^19 rows (4 MB
// at C=2), the whole density or color table ~50 MB, about the 50 MB L2, so
// most corner reads hit L2.  Design: one thread per (point, level),
// consecutive threads on consecutive levels of one point, so a warp writes
// whole contiguous output rows and shares its point's coordinates; each
// corner row is one vector load through the read-only path.  Corner dedup
// and shared-memory staging of coarse levels are left for a later, faster
// version.
#include "common.cuh"

namespace {

// Spatial primes of the hash, per axis.
__device__ __forceinline__ unsigned int prime(int d) {
    return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

template <int C>
struct Row;

template <>
struct Row<1> {
    float v[1];
    __device__ __forceinline__ void load(const float* p) { v[0] = __ldg(p); }
};
template <>
struct Row<2> {
    float v[2];
    __device__ __forceinline__ void load(const float* p) {
        const float2 r = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = r.x;
        v[1] = r.y;
    }
};
template <>
struct Row<4> {
    float v[4];
    __device__ __forceinline__ void load(const float* p) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = r.x;
        v[1] = r.y;
        v[2] = r.z;
        v[3] = r.w;
    }
};

// The (point, level) cell: integer corner pg and fractions frac of point p
// at resolution res, in the JAX order of operations.
__device__ __forceinline__ void cell_of(const float p[3], int res, unsigned int pg[3],
                                        float frac[3]) {
    const float scale = static_cast<float>(res);
    const float resm1 = __fsub_rn(scale, 1.f);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const float pos = __fmul_rn(p[d], scale);
        const float g = fminf(fmaxf(floorf(pos), 0.f), resm1);
        frac[d] = __fsub_rn(pos, g);
        pg[d] = static_cast<unsigned int>(g);
    }
}

// Calls visit(row, w) for each corner (trilinear, 8) or vertex (simplex, 4)
// of the level, in the JAX slot order.
template <typename Visit>
__device__ __forceinline__ void for_each_corner(const unsigned int pg[3], const float frac[3],
                                                bool simplex, unsigned int size, int offset,
                                                Visit visit) {
    if (!simplex) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            float w = 1.f;
            unsigned int h = 0u;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                const unsigned int bit = (s >> d) & 1u;
                w = __fmul_rn(w, bit ? frac[d] : __fsub_rn(1.f, frac[d]));
                h ^= (pg[d] + bit) * prime(d);
            }
            visit(static_cast<long long>(h % size) + offset, w);
        }
        return;
    }
    const float fx = frac[0], fy = frac[1], fz = frac[2];
    const int rank[3] = {(fy > fx) + (fz > fx), (fx >= fy) + (fz > fy), (fx >= fz) + (fy >= fz)};
    const float s1 = fmaxf(fx, fmaxf(fy, fz));
    const float s3 = fminf(fx, fminf(fy, fz));
    const float s2 = __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(fx, fy), fz), s1), s3);
    const float wv[4] = {__fsub_rn(1.f, s1), __fsub_rn(s1, s2), __fsub_rn(s2, s3), s3};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
        unsigned int h = 0u;
#pragma unroll
        for (int d = 0; d < 3; ++d) h ^= (pg[d] + (rank[d] < v ? 1u : 0u)) * prime(d);
        visit(static_cast<long long>(h % size) + offset, wv[v]);
    }
}

// levels: int32 [4, L] = resolutions, table sizes (rows), row offsets, and
// 1 on simplex levels (0 on trilinear ones).
template <int C>
__global__ void hashgrid_encode_kernel(const float* __restrict__ x,
                                       const float* __restrict__ table,
                                       const int* __restrict__ levels,
                                       float* __restrict__ out, long long num_points,
                                       int num_levels) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= num_points * num_levels) return;
    const long long b = i / num_levels;
    const int l = static_cast<int>(i - b * num_levels);
    float* o = out + i * C;  // == b * L * C + l * C

    const float p[3] = {x[3 * b], x[3 * b + 1], x[3 * b + 2]};
    const bool oob = (p[0] < 0.f) | (p[0] > 1.f) | (p[1] < 0.f) | (p[1] > 1.f) |
                     (p[2] < 0.f) | (p[2] > 1.f);
    if (oob) {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = 0.f;
        return;
    }

    unsigned int pg[3];
    float frac[3];
    cell_of(p, levels[l], pg, frac);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for_each_corner(pg, frac, levels[3 * num_levels + l] != 0,
                    static_cast<unsigned int>(levels[num_levels + l]),
                    levels[2 * num_levels + l], [&](long long row, float w) {
                        Row<C> r;
                        r.load(table + row * C);
#pragma unroll
                        for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(r.v[c], w));
                    });
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
}

// K2: d table[row, c] += w_s * g[b, l*C + c] over every (point b, level l,
// corner or simplex vertex s); the gradient of the input positions is zero, as in the JAX fast
// VJP (positions come from the non-differentiable marcher).
//
// The JAX backward sorts the B*L*8 contributions by table row and collapses
// runs with cumsum differences: deterministic, built for the TPU, where a
// scatter serialises.  Hopper adds in L2: one thread per (point, level)
// recomputes corners and weights exactly as K1 does (same rounding), and adds
// each corner's C-wide contribution with one vector atomicAdd (float2/float4
// on global memory, sm_90).  Sums therefore run in an order that changes
// from run to run: the result differs from a sorted sum by reassociation
// only.  Bound on the H100: the B*L*8 atomics, each a C-wide read-modify-write
// in L2.  Level 0 (4,096 cells at H=16) takes one contribution of every
// sample, so its rows are the most contended; a per-block pre-reduction of
// the coarse levels is left for a faster version.
template <int C>
__device__ __forceinline__ void add_row(float* dst, const float* v) {
    if constexpr (C == 4) {
        atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else if constexpr (C == 2) {
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    } else {
        atomicAdd(dst, v[0]);
    }
}

template <int C>
__global__ void hashgrid_backward_kernel(const float* __restrict__ x,
                                         const float* __restrict__ g,
                                         const int* __restrict__ levels,
                                         float* __restrict__ grad, long long num_points,
                                         int num_levels) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= num_points * num_levels) return;
    const long long b = i / num_levels;
    const int l = static_cast<int>(i - b * num_levels);

    const float p[3] = {x[3 * b], x[3 * b + 1], x[3 * b + 2]};
    const bool oob = (p[0] < 0.f) | (p[0] > 1.f) | (p[1] < 0.f) | (p[1] > 1.f) |
                     (p[2] < 0.f) | (p[2] > 1.f);
    if (oob) return;

    float gv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gv[c] = g[i * C + c];
    unsigned int pg[3];
    float frac[3];
    cell_of(p, levels[l], pg, frac);
    for_each_corner(pg, frac, levels[3 * num_levels + l] != 0,
                    static_cast<unsigned int>(levels[num_levels + l]),
                    levels[2 * num_levels + l], [&](long long row, float w) {
                        float v[C];
#pragma unroll
                        for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gv[c]);
                        add_row<C>(grad + row * C, v);
                    });
}

template <int C>
void launch(const float* x, const float* table, const int* levels, float* out,
            long long num_points, int num_levels, cudaStream_t stream) {
    const long long n = num_points * num_levels;
    hashgrid_encode_kernel<C><<<nst::blocks_for(n), nst::kThreads, 0, stream>>>(
        x, table, levels, out, num_points, num_levels);
}

template <int C>
void launch_backward(const float* x, const float* g, const int* levels, float* grad,
                     long long num_points, int num_levels, cudaStream_t stream) {
    const long long n = num_points * num_levels;
    hashgrid_backward_kernel<C><<<nst::blocks_for(n), nst::kThreads, 0, stream>>>(
        x, g, levels, grad, num_points, num_levels);
}

}  // namespace

// x [B, 3] f32, table [T, C] f32, levels int32 [4, L], out [B, L*C] f32.
// Returns cudaErrorInvalidValue for an unsupported row width C.
NST_API int nst_hashgrid_encode(const void* x, const void* table, const void* levels, void* out,
                                long long num_points, int num_levels, int channels,
                                void* stream) {
    if (num_points <= 0) return 0;
    const float* xf = static_cast<const float*>(x);
    const float* tf = static_cast<const float*>(table);
    const int* lv = static_cast<const int*>(levels);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (channels) {
        case 1: launch<1>(xf, tf, lv, of, num_points, num_levels, s); break;
        case 2: launch<2>(xf, tf, lv, of, num_points, num_levels, s); break;
        case 4: launch<4>(xf, tf, lv, of, num_points, num_levels, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return nst::launch_status();
}

// x [B, 3] f32, g [B, L*C] f32, levels int32 [4, L], grad [T, C] f32 (zeroed
// by the caller; contributions are added).  cudaErrorInvalidValue for an
// unsupported row width C.
NST_API int nst_hashgrid_backward(const void* x, const void* g, const void* levels, void* grad,
                                  long long num_points, int num_levels, int channels,
                                  void* stream) {
    if (num_points <= 0) return 0;
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(g);
    const int* lv = static_cast<const int*>(levels);
    float* df = static_cast<float*>(grad);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (channels) {
        case 1: launch_backward<1>(xf, gf, lv, df, num_points, num_levels, s); break;
        case 2: launch_backward<2>(xf, gf, lv, df, num_points, num_levels, s); break;
        case 4: launch_backward<4>(xf, gf, lv, df, num_points, num_levels, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return nst::launch_status();
}
