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
// (__fmul_rn / __fadd_rn: no FMA contraction), summing the corners in slot
// order, so the kernel gives the plain PyTorch version's bits.
//
// The streams K1 and K2 see are ray-major and t-ordered, with neighbouring
// rays next to each other (the marched samples of a frame chunk or a train
// batch, a pose's cached samples), or cells in linear order (an occupancy
// sweep's probes): neighbouring points share their cell at the coarse
// levels (a level-0 cell spans dozens of march steps).  So a CTA takes a
// tile of 32 consecutive points and its warps take the levels, warp w the
// levels w, w + 8, ...: each warp runs one level over the tile's 32 points.
// The lanes that share a cell load the same corner row in the same
// instruction, and the load unit serves them with one request: the corner
// reuse of the JAX package's dedup (ops/hashgrid.py, "Ray-coherent corner
// dedup"), done by the hardware, with no shuffle.  The level's constants are
// warp-uniform and sit in shared memory.  Each lane writes its features
// into the tile's [32 points x L x C] block in shared memory, which the CTA
// then writes to the contiguous output rows in C-wide vectors, neighbouring
// threads on neighbouring addresses.
//
// Bound on the H100: bytes, at the roofline: each (point, level) reads 8
// (simplex: 4) [C]-wide rows, mostly L2 and L1 hits (a table is ~50 MB, the
// L2's size), and does ~60 flops.  What bounds the kernels in practice is
// the instructions a (point, level) issues: 8 hashes, 8 weights, 8 C-wide
// multiply-adds, each rounded on its own.  A row index is hash % size, and
// an integer remainder takes ~20 instructions: 12 of the default 16 levels
// (level 0, 16^3 rows, and every level whose table is full, 2^19 rows) have
// a power-of-two size, where the remainder is a mask (the level's branch
// is warp-uniform).  (Measured on the H100 against the same mapping with pair
// loads: corners s and s|1 of an even-x cell are rows r and r ^ 1 — every
// table size and row offset is even — and one 16-byte load can read both at
// C = 2; the selection and the second load of split pairs cost more than the
// load they save, so every corner is one C-wide load.)
#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Warps a CTA: a tile of 32 points, warp w on its levels w, w + kWarps, ...
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Spatial primes of the hash, per axis.
__device__ __forceinline__ unsigned int prime(int d) {
    return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

// A C-wide row load (read-only path), the row aligned to C floats.
template <int C>
__device__ __forceinline__ void load_row(const float* p, float v[C]) {
    if constexpr (C == 4) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
    } else if constexpr (C == 2) {
        const float2 r = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = r.x, v[1] = r.y;
    } else {
        v[0] = __ldg(p);
    }
}

// A C-wide row store from registers, and a copy between rows, each row
// aligned to C floats.
template <int C>
__device__ __forceinline__ void store_row(float* dst, const float v[C]) {
    if constexpr (C == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (C == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
        *dst = v[0];
    }
}
template <int C>
__device__ __forceinline__ void copy_row(float* dst, const float* src) {
    if constexpr (C == 4) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else if constexpr (C == 2) {
        *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
    } else {
        *dst = *src;
    }
}

// The (point, level) cell: integer corner pg and fractions frac of point p
// at resolution res, in the JAX order of operations.  pg is a valid cell
// for any p (the clamp), so every lane may compute and load.
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

__device__ __forceinline__ bool outside(const float p[3]) {
    return (p[0] < 0.f) | (p[0] > 1.f) | (p[1] < 0.f) | (p[1] > 1.f) | (p[2] < 0.f) |
           (p[2] > 1.f);
}

// One level's constants (warp-uniform).
struct Level {
    int res;
    unsigned size;
    int offset;
    bool simplex;
    bool pow2;  // size a power of two: the remainder is a mask
};

// hash % size + offset.
template <bool kPow2>
__device__ __forceinline__ int row_of(unsigned h, const Level& lv) {
    return static_cast<int>(kPow2 ? (h & (lv.size - 1u)) : (h % lv.size)) + lv.offset;
}

// Calls visit(row, w) for each corner (trilinear, 8) or vertex (simplex, 4)
// of the level, in the JAX slot order, with the JAX weights.
template <bool kPow2, typename Visit>
__device__ __forceinline__ void for_each_corner(const unsigned pg[3], const float frac[3],
                                                const Level& lv, Visit visit) {
    if (!lv.simplex) {
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
            visit(row_of<kPow2>(h, lv), w);
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
        visit(row_of<kPow2>(h, lv), wv[v]);
    }
}

// Runs body with the level's remainder kind as a compile-time constant (a
// warp-uniform branch).
template <typename Body>
__device__ __forceinline__ void on_level(const Level& lv, Body body) {
    if (lv.pow2) {
        body(std::integral_constant<bool, true>());
    } else {
        body(std::integral_constant<bool, false>());
    }
}

// The CTA's shared memory: the level table (int32 [4, L]: resolutions,
// table sizes, row offsets, simplex flags), then the tile's 32 rows of
// L*C + C floats (the pad of C staggers the rows over the banks).
__host__ __device__ inline int tile_stride(int num_levels, int c) { return num_levels * c + c; }
__host__ __device__ inline int levels_words(int num_levels) { return (4 * num_levels + 3) & ~3; }
inline size_t smem_bytes(int num_levels, int c) {
    return static_cast<size_t>(levels_words(num_levels) + 32 * tile_stride(num_levels, c)) *
           sizeof(float);
}

struct Tile {
    const int* lv;    // the level table
    float* rows;      // the tile's [32, stride] block
    long long first;  // the tile's first point
    int n;            // its points (1..32)
    int lane, warp;

    __device__ Level level(int l, int num_levels) const {
        Level v;
        v.res = lv[l];
        v.size = static_cast<unsigned>(lv[num_levels + l]);
        v.offset = lv[2 * num_levels + l];
        v.simplex = lv[3 * num_levels + l] != 0;
        v.pow2 = (v.size & (v.size - 1u)) == 0u;
        return v;
    }
};

// Loads the level table and places the CTA on its tile (blockIdx.x).
__device__ __forceinline__ Tile enter_tile(const int* levels, int num_levels,
                                           long long num_points) {
    extern __shared__ __align__(16) float smem[];
    int* lv = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < 4 * num_levels; i += kThreads) lv[i] = levels[i];
    Tile t;
    t.lv = lv;
    t.rows = smem + levels_words(num_levels);
    t.first = static_cast<long long>(blockIdx.x) * 32;
    t.n = static_cast<int>(min(32LL, num_points - t.first));
    t.lane = threadIdx.x & 31;
    t.warp = threadIdx.x >> 5;
    __syncthreads();
    return t;
}

// The lane's point; lanes past the tile's end take its last point (their
// results are dropped), so that every warp stays converged.
__device__ __forceinline__ void tile_point(const float* x, const Tile& t, float p[3]) {
    const long long b = t.first + min(t.lane, t.n - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = x[3 * b + d];
}

template <int C>
__global__ void __launch_bounds__(kThreads)
hashgrid_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                       const int* __restrict__ levels, float* __restrict__ out,
                       long long num_points, int num_levels) {
    const Tile t = enter_tile(levels, num_levels, num_points);
    const int stride = tile_stride(num_levels, C);
    float p[3];
    tile_point(x, t, p);
    const bool inside = !outside(p);
    for (int l = t.warp; l < num_levels; l += kWarps) {
        const Level lv = t.level(l, num_levels);
        unsigned pg[3];
        float frac[3];
        cell_of(p, lv.res, pg, frac);
        float acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.f;
        on_level(lv, [&](auto pow2) {
            for_each_corner<decltype(pow2)::value>(pg, frac, lv, [&](int row, float w) {
                float v[C];
                load_row<C>(table + static_cast<long long>(row) * C, v);
#pragma unroll
                for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(v[c], w));
            });
        });
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = inside ? acc[c] : 0.f;
        store_row<C>(t.rows + t.lane * stride + l * C, acc);
    }
    __syncthreads();
    // The tile's n output rows are n * L * C contiguous floats.
    float* o = out + t.first * num_levels * C;
    for (int j = threadIdx.x; j < t.n * num_levels; j += kThreads) {
        const int q = j / num_levels;
        copy_row<C>(o + static_cast<long long>(j) * C,
                    t.rows + q * stride + (j - q * num_levels) * C);
    }
}

// K2: d table[row, c] += w_s * g[b, l*C + c] over every (point b, level l,
// corner or simplex vertex s); the gradient of the input positions is zero,
// as in the JAX fast VJP (positions come from the non-differentiable
// marcher).
//
// The JAX backward sorts the B*L*8 contributions by table row and collapses
// runs with cumsum differences: deterministic, built for the TPU, where a
// scatter serialises.  Hopper adds in L2 with vector atomics (float2/float4
// on global memory, sm_90), and atomics on one row serialise in the L2
// slice that owns it: at the coarse levels every sample of a stream adds
// into a few thousand rows.  So K2 takes K1's mapping, a tile of 32
// consecutive points a CTA and one level a warp, with the tile's cotangent
// loaded coalesced into shared memory, recomputes corners and weights as K1
// does (same rounding) and combines in the warp the contributions of the
// lanes that add into one row (warp_add): each run of neighbouring lanes on
// one row folds into its first lane, those lanes fold the runs of one row
// together, and the lane that leads a row issues its one vector atomic.  A
// warp whose 32 rows are distinct (the fine levels) issues its atomics
// directly.  The tiles take the levels in rotated order, which spreads the
// coarse levels' atomics over the launch.  Sums therefore run in an order
// that changes from run to run (the atomics' order across warps): the
// result differs from a sorted sum by reassociation only.
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

// Adds each lane's v into grad[row] (row < 0: nothing), one atomic a
// distinct row of the warp.  Called by all 32 lanes together.
template <int C>
__device__ __forceinline__ void warp_add(float* __restrict__ grad, int row, float v[C], int lane) {
    const int prev = __shfl_up_sync(kFull, row, 1);
    const bool head = lane == 0 || prev != row || row < 0;
    const unsigned heads = __ballot_sync(kFull, head);
    if (heads == kFull) {
        if (row >= 0) add_row<C>(grad + static_cast<long long>(row) * C, v);
        return;
    }
    // Each run of one row folds into its head: after the step of distance
    // d, lane i holds the sum of lanes i .. min(i + 2d - 1, end of its run).
    const unsigned later = heads & (~1u << lane);
    const int end = later ? __ffs(later) - 2 : 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float o = __shfl_down_sync(kFull, v[c], d);
            if (lane + d <= end) v[c] = __fadd_rn(v[c], o);
        }
    }
    // The heads of runs on one row fold into the lowest, in lane order.
    const unsigned live = heads & __ballot_sync(kFull, row >= 0);
    if ((live >> lane) & 1u) {
        const unsigned peers = __match_any_sync(live, row);
        const int leader = __ffs(peers) - 1;
        const int rounds = static_cast<int>(__reduce_max_sync(live, __popc(peers))) - 1;
        unsigned rest = peers & (peers - 1);
        for (int i = 0; i < rounds; ++i) {
            const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float o = __shfl_sync(live, v[c], src);
                if (lane == leader && rest) v[c] = __fadd_rn(v[c], o);
            }
            rest &= rest - 1;
        }
        if (lane == leader) add_row<C>(grad + static_cast<long long>(row) * C, v);
    }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
hashgrid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const int* __restrict__ levels, float* __restrict__ grad,
                         long long num_points, int num_levels) {
    const Tile t = enter_tile(levels, num_levels, num_points);
    const int stride = tile_stride(num_levels, C);
    // The tile's cotangent rows are n * L * C contiguous floats (read one a
    // thread: g need not be aligned beyond a float).
    const float* gt = g + t.first * num_levels * C;
    const int width = num_levels * C;
    for (int j = threadIdx.x; j < t.n * width; j += kThreads) {
        const int q = j / width;
        t.rows[q * stride + (j - q * width)] = gt[j];
    }
    float p[3];
    tile_point(x, t, p);
    const bool live = t.lane < t.n && !outside(p);
    __syncthreads();
    const int l0 = static_cast<int>(blockIdx.x % num_levels);
    for (int k = t.warp; k < num_levels; k += kWarps) {
        const int l = l0 + k < num_levels ? l0 + k : l0 + k - num_levels;
        const Level lv = t.level(l, num_levels);
        float gv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) gv[c] = live ? t.rows[t.lane * stride + l * C + c] : 0.f;
        unsigned pg[3];
        float frac[3];
        cell_of(p, lv.res, pg, frac);
        on_level(lv, [&](auto pow2) {
            for_each_corner<decltype(pow2)::value>(pg, frac, lv, [&](int row, float w) {
                float v[C];
#pragma unroll
                for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gv[c]);
                warp_add<C>(grad, live ? row : -1, v, t.lane);
            });
        });
    }
}

// The launch: a CTA a tile of 32 points, the level table and the tile in
// dynamic shared memory.
template <typename Kernel>
int launch_tiles(Kernel kernel, const float* x, const float* in, const int* levels, float* out,
                 long long num_points, int num_levels, int c, cudaStream_t stream) {
    const size_t smem = smem_bytes(num_levels, c);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long tiles = (num_points + 31) / 32;
    kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(x, in, levels, out,
                                                                     num_points, num_levels);
    return nst::launch_status();
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
        case 1: return launch_tiles(hashgrid_encode_kernel<1>, xf, tf, lv, of, num_points,
                                    num_levels, 1, s);
        case 2: return launch_tiles(hashgrid_encode_kernel<2>, xf, tf, lv, of, num_points,
                                    num_levels, 2, s);
        case 4: return launch_tiles(hashgrid_encode_kernel<4>, xf, tf, lv, of, num_points,
                                    num_levels, 4, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
        case 1: return launch_tiles(hashgrid_backward_kernel<1>, xf, gf, lv, df, num_points,
                                    num_levels, 1, s);
        case 2: return launch_tiles(hashgrid_backward_kernel<2>, xf, gf, lv, df, num_points,
                                    num_levels, 2, s);
        case 4: return launch_tiles(hashgrid_backward_kernel<4>, xf, gf, lv, df, num_points,
                                    num_levels, 4, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
