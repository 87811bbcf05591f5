// K1: multiresolution hash-grid encode, forward, K2: its table gradient, and
// K2x: its position gradient.  (K9, the multi-style table init over the same
// index law, is at the end.)
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
// Rows of points outside [0, 1]^3 are zero.  A style slot s != 0 (JAX's
// hashgrid_encode(style=s), _level_indices) XORs the warp-uniform term
// (s * 3674653429) mod 2^32 into every hash: the kernels take the term and
// are instantiated with and without it, so style 0 runs the instructions it
// ran before.  (The dense branch of JAX's index law, s * (res + 1)^3 added,
// needs (res + 1)^3 * 512 <= the level's table size, which no level of a
// spec that hashgrid_spec builds meets: every level hashes.)  The
// arithmetic follows the JAX order step for step and rounds every product
// and sum on its own
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
// h0 seeds every hash: 0, or the style term.
template <bool kPow2, typename Visit>
__device__ __forceinline__ void for_each_corner(const unsigned pg[3], const float frac[3],
                                                const Level& lv, unsigned h0, Visit visit) {
    if (!lv.simplex) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            float w = 1.f;
            unsigned int h = h0;
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
        unsigned int h = h0;
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

template <int C, bool kStyled>
__global__ void __launch_bounds__(kThreads)
hashgrid_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                       const int* __restrict__ levels, float* __restrict__ out,
                       long long num_points, int num_levels, unsigned style_term) {
    const unsigned h0 = kStyled ? style_term : 0u;
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
            for_each_corner<decltype(pow2)::value>(pg, frac, lv, h0, [&](int row, float w) {
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

// The tile's cotangent rows, n * L * C contiguous floats, into its block of
// shared memory (read one a thread: g need not be aligned beyond a float).
template <int C>
__device__ __forceinline__ void load_cotangent(const float* g, const Tile& t, int num_levels) {
    const int stride = tile_stride(num_levels, C);
    const float* gt = g + t.first * num_levels * C;
    const int width = num_levels * C;
    for (int j = threadIdx.x; j < t.n * width; j += kThreads) {
        const int q = j / width;
        t.rows[q * stride + (j - q * width)] = gt[j];
    }
}

template <int C, bool kStyled>
__global__ void __launch_bounds__(kThreads)
hashgrid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const int* __restrict__ levels, float* __restrict__ grad,
                         long long num_points, int num_levels, unsigned style_term) {
    const unsigned h0 = kStyled ? style_term : 0u;
    const Tile t = enter_tile(levels, num_levels, num_points);
    const int stride = tile_stride(num_levels, C);
    load_cotangent<C>(g, t, num_levels);
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
            for_each_corner<decltype(pow2)::value>(pg, frac, lv, h0, [&](int row, float w) {
                float v[C];
#pragma unroll
                for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gv[c]);
                warp_add<C>(grad, live ? row : -1, v, t.lane);
            });
        });
    }
}

// K2x: the position gradient, d x[b, d] = sum over levels l of res_l *
// dL/dfrac[b, l, d] (d frac / d x = res_l: floor and the clamp pass none),
// with t_s = sum_c g[b, l*C + c] * table[row_s, c] the cotangent's dot with
// corner s's row and dL/dfrac_d = sum_s t_s * d w_s / d frac_d.  Replaces the
// JAX autodiff of nerfstyle_tpu/ops/hashgrid.py:hashgrid_encode(fast_vjp=False) (:840)
// through corner_indices_weights (:225) and _encode_from_indices (:342).
// Simplex: w = (1 - s1, s1 - s2, s2 - s3, s3) with s2 = fx + fy + fz - s1 -
// s3, s1 = max(fx, max(fy, fz)), s3 = min(fx, min(fy, fz)), differentiated
// as JAX does: jnp.maximum / jnp.minimum give half the gradient to each
// side of a tie, so a three-way tie splits 1/2, 1/4, 1/4 in that nesting
// (torch.maximum splits alike).  Points outside [0, 1]^3 get 0.
//
// Bound on the H100: bytes (the points, the cotangent, the distinct corner
// rows and d x, ~7.5 us on a frame chunk's kept stream of 129,929 points),
// the bytes K1 moves.  What holds it, as K1, is the instructions a (point,
// level) issues and the latency of its corner-row gathers, so:
//  - the row index: a level whose table size is not a power of two takes
//    hash % size as Lemire's direct remainder, ((M * hash) mod 2^64 * size)
//    >> 64 with M = ceil(2^64 / size) from the host (K2x's own rows 4 and 5
//    of the level table, ops.hashgrid.position_grad_table): four integer
//    multiplies a corner instead of a ~20-instruction division, exact for
//    every 32-bit hash and size;
//  - the hashes: per axis (pg_d + 1) * prime_d = pg_d * prime_d + prime_d,
//    so three multiplies a level, and a corner's hash is two XORs (one
//    LOP3); a simplex vertex selects its three terms;
//  - the trilinear gradient factored: dL/dfrac_x = sum over the y and z
//    bits of w_y * w_z * (t[1, y, z] - t[0, y, z]), nested as w_z0 * (w_y0 *
//    . + w_y1 * .) + w_z1 * (...): 10 operations an axis instead of a
//    two-factor weight and a signed add a corner;
//  - every corner row of a level, and the lane's cotangent row, is loaded
//    before the first dot, and a lane takes two points (kPts = 2), so a
//    thread keeps 16 corner gathers in flight;
//  - at most 64 registers a thread, so 32 warps an SM stay resident.
// The mapping keeps K1's row sharing: a CTA takes 32 * kPts consecutive
// points (lane i the points i and i + 32, so each load instruction serves
// 32 consecutive points and the lanes that share a cell share a row load)
// and kW = 4 warps, warp w the levels w, w + kW, ...; each lane sums its
// levels' partials in registers in level order, and the CTA adds the
// warps' partials in warp order: the result does not depend on the
// launch.  Sums run in another order than the plain version's autograd,
// so they agree to rounding.  Two points a lane and 4 warps (8 CTAs an SM)
// beat one point a lane with 8 or 16 warps and two points with 8 warps (2
// warps take the same time); on the H100 the integer remainder (%) took
// the same time as the magic one.

// hash % size + offset: a mask on a power-of-two table, else Lemire's
// remainder with m = ceil(2^64 / size).
template <bool kPow2>
__device__ __forceinline__ int position_row(unsigned h, unsigned size, unsigned long long m,
                                            int offset) {
    if constexpr (kPow2) {
        return static_cast<int>(h & (size - 1u)) + offset;
    } else {
        const unsigned long long low = m * h;  // mod 2^64
        const unsigned long long hi = static_cast<unsigned long long>(
                                          static_cast<unsigned>(low >> 32)) * size +
                                      __umulhi(static_cast<unsigned>(low), size);
        return static_cast<int>(hi >> 32) + offset;
    }
}

template <int C>
__device__ __forceinline__ float row_dot(const float (&gv)[C], const float (&v)[C]) {
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) t = fmaf(gv[c], v[c], t);
    return t;
}

// One (point, level)'s dL/dfrac: rows from the per-axis hashes hx[bit] (x,
// with the style term), hy[bit], hz[bit].
template <int C, bool kPow2>
__device__ __forceinline__ void position_dfrac(const float* __restrict__ table, bool simplex,
                                               unsigned size, unsigned long long m, int offset,
                                               const unsigned (&hx)[2], const unsigned (&hy)[2],
                                               const unsigned (&hz)[2], const float (&frac)[3],
                                               const float (&gv)[C], float (&dfrac)[3]) {
    if (!simplex) {
        float v[8][C];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            const int row = position_row<kPow2>(hx[s & 1] ^ hy[(s >> 1) & 1] ^ hz[s >> 2], size,
                                                m, offset);
            load_row<C>(table + static_cast<long long>(row) * C, v[s]);
        }
        float t[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) t[s] = row_dot<C>(gv, v[s]);
        const float f0[3] = {1.f - frac[0], 1.f - frac[1], 1.f - frac[2]};
        // Axis d's difference at the other two bits (a, b), weighed by the
        // other two axes' factors.
        auto axis = [&](int d, int da, int db) {
            const int sd = 1 << d, sa = 1 << da, sb = 1 << db;
            const float d00 = t[sd] - t[0], d10 = t[sd | sa] - t[sa];
            const float d01 = t[sd | sb] - t[sb], d11 = t[sd | sa | sb] - t[sa | sb];
            const float i0 = fmaf(frac[da], d10, f0[da] * d00);
            const float i1 = fmaf(frac[da], d11, f0[da] * d01);
            return fmaf(frac[db], i1, f0[db] * i0);
        };
        dfrac[0] = axis(0, 1, 2);
        dfrac[1] = axis(1, 0, 2);
        dfrac[2] = axis(2, 0, 1);
        return;
    }
    const float fx = frac[0], fy = frac[1], fz = frac[2];
    const int rank[3] = {(fy > fx) + (fz > fx), (fx >= fy) + (fz > fy), (fx >= fz) + (fy >= fz)};
    float v[4][C];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        // Vertex k takes the upper corner on the axes ranked below k
        // (selects: an index into the register pairs would compile to a
        // compare chain).
        const unsigned h = (rank[0] < k ? hx[1] : hx[0]) ^ (rank[1] < k ? hy[1] : hy[0]) ^
                           (rank[2] < k ? hz[1] : hz[0]);
        const int row = position_row<kPow2>(h, size, m, offset);
        load_row<C>(table + static_cast<long long>(row) * C, v[k]);
    }
    float tv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tv[k] = row_dot<C>(gv, v[k]);
    // dL/ds1, dL/ds2, dL/ds3 of w = (1 - s1, s1 - s2, s2 - s3, s3); s2's
    // own term reaches every axis, s1's and s3's less s2's through the max
    // and the min.
    const float d2 = tv[2] - tv[1];
    const float d1 = (tv[1] - tv[0]) - d2, d3 = (tv[3] - tv[2]) - d2;
    // max(fx, m), m = max(fy, fz): a tie halves (JAX's _balanced_eq).
    const float mx = fmaxf(fy, fz), s1 = fmaxf(fx, mx);
    const float gx1 = fx == s1 ? (mx == s1 ? 0.5f : 1.f) : 0.f;
    const float gm1 = mx == s1 ? (fx == s1 ? 0.5f : 1.f) : 0.f;
    const float gy1 = fy == mx ? (fz == mx ? 0.5f : 1.f) : 0.f;
    const float gz1 = fz == mx ? (fy == mx ? 0.5f : 1.f) : 0.f;
    const float n = fminf(fy, fz), s3 = fminf(fx, n);
    const float gx3 = fx == s3 ? (n == s3 ? 0.5f : 1.f) : 0.f;
    const float gn3 = n == s3 ? (fx == s3 ? 0.5f : 1.f) : 0.f;
    const float gy3 = fy == n ? (fz == n ? 0.5f : 1.f) : 0.f;
    const float gz3 = fz == n ? (fy == n ? 0.5f : 1.f) : 0.f;
    dfrac[0] = d2 + d1 * gx1 + d3 * gx3;
    dfrac[1] = d2 + d1 * (gm1 * gy1) + d3 * (gn3 * gy3);
    dfrac[2] = d2 + d1 * (gm1 * gz1) + d3 * (gn3 * gz3);
}


// K2x's mapping: kPts points a lane, kW warps a CTA.
constexpr int kPts = 2, kW = 4;

// At most 64 registers a thread (32 / kW CTAs of kW warps an SM), so that
// 32 warps an SM stay resident.
template <int C, bool kStyled>
__global__ void __launch_bounds__(kW * 32, 32 / kW)
hashgrid_position_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                              const float* __restrict__ table, const int* __restrict__ levels,
                              float* __restrict__ dx, long long num_points, int num_levels,
                              unsigned style_term) {
    constexpr int kThr = kW * 32, kTile = 32 * kPts;
    __shared__ float part[kW][kTile][3];
    extern __shared__ __align__(16) int lv[];  // the level table
    for (int i = threadIdx.x; i < 6 * num_levels; i += kThr) lv[i] = levels[i];
    const long long first = static_cast<long long>(blockIdx.x) * kTile;
    const int n = static_cast<int>(min(static_cast<long long>(kTile), num_points - first));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // The lane's points (lanes past the tile's end take its last point and
    // drop their result) and their cotangent rows.
    float p[kPts][3];
    bool live[kPts];
    const float* gp[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
        const long long b = first + min(lane + 32 * k, n - 1);
#pragma unroll
        for (int d = 0; d < 3; ++d) p[k][d] = x[3 * b + d];
        live[k] = lane + 32 * k < n && !outside(p[k]);
        gp[k] = g + b * num_levels * C;
    }
    __syncthreads();
    const unsigned h0 = kStyled ? style_term : 0u;
    float acc[kPts][3] = {};
    for (int l = warp; l < num_levels; l += kW) {
        const int res = lv[l], offset = lv[2 * num_levels + l];
        const unsigned size = static_cast<unsigned>(lv[num_levels + l]);
        const bool simplex = lv[3 * num_levels + l] != 0;
        const unsigned long long m =
            static_cast<unsigned long long>(static_cast<unsigned>(lv[4 * num_levels + l])) |
            static_cast<unsigned long long>(static_cast<unsigned>(lv[5 * num_levels + l])) << 32;
        float dfrac[kPts][3];
        auto level = [&](auto pow2) {
#pragma unroll
            for (int k = 0; k < kPts; ++k) {
                float gv[C];
                load_row<C>(gp[k] + l * C, gv);
                unsigned pg[3];
                float frac[3];
                cell_of(p[k], res, pg, frac);
                const unsigned hy0 = pg[1] * prime(1), hz0 = pg[2] * prime(2);
                const unsigned hx[2] = {h0 ^ pg[0], h0 ^ (pg[0] + 1u)};
                const unsigned hy[2] = {hy0, hy0 + prime(1)}, hz[2] = {hz0, hz0 + prime(2)};
                position_dfrac<C, decltype(pow2)::value>(table, simplex, size, m, offset, hx, hy,
                                                         hz, frac, gv, dfrac[k]);
            }
        };
        if ((size & (size - 1u)) == 0u) {
            level(std::integral_constant<bool, true>());
        } else {
            level(std::integral_constant<bool, false>());
        }
        const float r = static_cast<float>(res);
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
#pragma unroll
            for (int d = 0; d < 3; ++d) acc[k][d] += r * dfrac[k][d];
        }
    }
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
#pragma unroll
        for (int d = 0; d < 3; ++d) part[warp][lane + 32 * k][d] = live[k] ? acc[k][d] : 0.f;
    }
    __syncthreads();
    // The tile's n rows of d x are 3n contiguous floats.
    for (int j = threadIdx.x; j < 3 * n; j += kThr) {
        const int q = j / 3, d = j - 3 * q;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kW; ++w) sum += part[w][q][d];
        dx[3 * first + j] = sum;
    }
}

// The launch: a CTA a tile of 32 points, the level table and the tile in
// dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, long long num_points, int num_levels, int c, cudaStream_t stream,
                 Args... args) {
    const size_t smem = smem_bytes(num_levels, c);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long tiles = (num_points + 31) / 32;
    kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(args...);
    return nst::launch_status();
}

// Launches kernel(C, styled) for a row width C in {1, 2, 4} (pick returns
// the instantiation): the style term selects the styled one, so style 0
// runs the unstyled one.  cudaErrorInvalidValue for another C.
template <typename Pick, typename... Args>
int launch_width(Pick pick, int channels, unsigned style_term, long long num_points,
                 int num_levels, cudaStream_t stream, Args... args) {
    if (channels != 1 && channels != 2 && channels != 4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_tiles(pick(channels, style_term != 0u), num_points, num_levels, channels, stream,
                        args..., num_points, num_levels, style_term);
}

template <int C>
auto encode_kernel(bool styled) {
    return styled ? hashgrid_encode_kernel<C, true> : hashgrid_encode_kernel<C, false>;
}
template <int C>
auto backward_kernel(bool styled) {
    return styled ? hashgrid_backward_kernel<C, true> : hashgrid_backward_kernel<C, false>;
}
template <int C>
auto position_grad_kernel(bool styled) {
    return styled ? hashgrid_position_grad_kernel<C, true>
                  : hashgrid_position_grad_kernel<C, false>;
}

// K2x's launch: a CTA a tile of 32 * kPts points, kW warps, the level table
// (int32 [6, L]) in dynamic shared memory.
int launch_position_grad(const float* x, const float* g, const float* table, const int* levels,
                         float* dx, long long num_points, int num_levels, int channels,
                         unsigned style_term, cudaStream_t stream) {
    if (channels != 1 && channels != 2 && channels != 4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool styled = style_term != 0u;
    auto kernel = channels == 1 ? position_grad_kernel<1>(styled)
                                : (channels == 2 ? position_grad_kernel<2>(styled)
                                                 : position_grad_kernel<4>(styled));
    const size_t smem = sizeof(int) * 6 * num_levels;
    if (smem > 48 * 1024 - sizeof(float) * kW * 32 * kPts * 3) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long tiles = (num_points + 32 * kPts - 1) / (32 * kPts);
    kernel<<<static_cast<unsigned>(tiles), kW * 32, smem, stream>>>(
        x, g, table, levels, dx, num_points, num_levels, style_term);
    return nst::launch_status();
}

}  // namespace

// x [B, 3] f32, table [T, C] f32, levels int32 [4, L], out [B, L*C] f32;
// style_term = (style * 3674653429) mod 2^32 (0: style 0).  Returns
// cudaErrorInvalidValue for an unsupported row width C.
NST_API int nst_hashgrid_encode(const void* x, const void* table, const void* levels, void* out,
                                long long num_points, int num_levels, int channels,
                                unsigned style_term, void* stream) {
    if (num_points <= 0) return 0;
    auto pick = [](int c, bool styled) {
        return c == 1 ? encode_kernel<1>(styled)
                      : (c == 2 ? encode_kernel<2>(styled) : encode_kernel<4>(styled));
    };
    return launch_width(pick, channels, style_term, num_points, num_levels,
                        static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                        static_cast<const float*>(table), static_cast<const int*>(levels),
                        static_cast<float*>(out));
}

// x [B, 3] f32, g [B, L*C] f32, levels int32 [4, L], grad [T, C] f32 (zeroed
// by the caller; contributions are added); style_term as above.
// cudaErrorInvalidValue for an unsupported row width C.
NST_API int nst_hashgrid_backward(const void* x, const void* g, const void* levels, void* grad,
                                  long long num_points, int num_levels, int channels,
                                  unsigned style_term, void* stream) {
    if (num_points <= 0) return 0;
    auto pick = [](int c, bool styled) {
        return c == 1 ? backward_kernel<1>(styled)
                      : (c == 2 ? backward_kernel<2>(styled) : backward_kernel<4>(styled));
    };
    return launch_width(pick, channels, style_term, num_points, num_levels,
                        static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                        static_cast<const float*>(g), static_cast<const int*>(levels),
                        static_cast<float*>(grad));
}

// K2x.  x [B, 3] f32, g [B, L*C] f32, table [T, C] f32, levels int32 [6, L]
// (ops.hashgrid.position_grad_table), dx [B, 3] f32 (every row written);
// style_term as above.  cudaErrorInvalidValue for an unsupported row width C.
NST_API int nst_hashgrid_position_grad(const void* x, const void* g, const void* table,
                                       const void* levels, void* dx, long long num_points,
                                       int num_levels, int channels, unsigned style_term,
                                       void* stream) {
    if (num_points <= 0) return 0;
    return launch_position_grad(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(table), static_cast<const int*>(levels),
        static_cast<float*>(dx), num_points, num_levels, channels, style_term,
        static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// K9: multi-style grid init.
//
// Replaces nerfstyle_tpu/ops/hashgrid.py:grid_initialize (:351; the
// reference's gridencoder.cu:495-571, a one-time init that the reference
// never calls): for each level and each integer corner (x, y, z) of
// [0, res]^3, read the reference table's style-0 row at the corner and
// write it at the corner's row of every style slot s < num_styles of a new
// zero table.  The index law is JAX's _level_indices in uint32 arithmetic
// with wraparound: a hashed level x ^ y * 2654435761 ^ z * 805459861 ^
// s * 3674653429, a dense one (every axis and the style slot fit the table)
// x + y * (res + 1) + z * (res + 1)^2 + s * (res + 1)^3; then % size +
// offset.  Stores of corners that collide on a row race, so its surviving
// value is arbitrary, as in the reference kernel and in JAX's .at[].set.
//
// Bound on the H100: the corner traffic.  The render grid has
// sum_l (res_l + 1)^3 = 1.026e11 corners, each a row read and num_styles
// rows written (mostly in L2: a level's table is 4 MiB), against a table
// of 52 MB read and written once.  A warp takes one (y, z) column of a
// level, forms the column's part of the law once, and walks x in aligned
// blocks of 32, one x a lane.  On a hashed level whose table is a power of
// two (every full 2^19 table) the row is (x ^ part ^ style term) & (size -
// 1): a mask, and 32 consecutive x aligned to 32 land on 32 consecutive
// rows (in some order), so a warp's 32 row loads, and its 32 row stores of
// each style (the style term XORs a constant in), fall in 32 x 4C
// contiguous bytes: whole 32-byte sectors.  A dense level's rows, x + part
// + style * (res + 1)^3, are contiguous too.  Levels whose table is not a
// power of two (coarse levels, small tables) keep the 32-bit remainder.
// Rows are loaded and stored whole (float2 at C = 2, float4 at C = 4), four
// blocks of x a lane in flight.  The columns of every level are one
// grid-stride range over the warps, one launch a call; lanes past the
// column's end are masked.
// ---------------------------------------------------------------------------

namespace {

constexpr int kInitUnroll = 4;  // blocks of 32 x a warp loads before it stores

// Rows of one level's table: the index law's last step, % size, as a mask
// on a power-of-two table.
struct InitLaw {
    unsigned size, mask;
    int offset;
    bool dense;
    __device__ InitLaw(const int* levels, int num_levels, int base, int l)
        : size(static_cast<unsigned>(__ldg(levels + base * num_levels + l))),
          mask((size & (size - 1)) == 0 ? size - 1 : 0u),
          offset(__ldg(levels + (base + 1) * num_levels + l)),
          dense(__ldg(levels + (base + 2) * num_levels + l) != 0) {}
    // h: the law before the remainder.
    __device__ __forceinline__ long long row(unsigned h) const {
        const unsigned r = mask ? h & mask : h % size;
        return static_cast<long long>(static_cast<int>(r) + offset);
    }
};

template <int C>
__global__ void __launch_bounds__(nst::kThreads)
    grid_initialize_kernel(const float* __restrict__ ref, const int* __restrict__ levels,
                           int num_levels, int num_styles, float* __restrict__ out) {
    const unsigned lane = threadIdx.x % 32;
    const long long step = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
    long long first = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
    for (int l = 0; l < num_levels; ++l) {
        const unsigned side = static_cast<unsigned>(__ldg(levels + l)) + 1u;
        const InitLaw src(levels, num_levels, 1, l), dst(levels, num_levels, 4, l);
        const unsigned cube = side * side * side;  // the dense law's style stride (mod 2^32)
        const long long columns = static_cast<long long>(side) * side;
        for (long long j = first; j < columns; j += step) {
            const unsigned column = static_cast<unsigned>(j);  // < side^2 < 2^32
            const unsigned y = column / side, z = column % side;
            const unsigned hashed = y * 2654435761u ^ z * 805459861u;
            const unsigned dense_part = y * side + z * side * side;
            const unsigned src_part = src.dense ? dense_part : hashed;
            const unsigned dst_part = dst.dense ? dense_part : hashed;
            for (unsigned x0 = 0; x0 < side; x0 += 32 * kInitUnroll) {
                float v[kInitUnroll][C];
#pragma unroll
                for (int u = 0; u < kInitUnroll; ++u) {
                    const unsigned x = x0 + 32 * u + lane;
                    if (x < side) {
                        const unsigned h = src.dense ? x + src_part : x ^ src_part;
                        load_row<C>(ref + src.row(h) * C, v[u]);
                    }
                }
#pragma unroll
                for (int u = 0; u < kInitUnroll; ++u) {
                    const unsigned x = x0 + 32 * u + lane;
                    if (x >= side) continue;
                    unsigned term = 0;  // the style term, for s = 0, 1, ...
                    for (int s = 0; s < num_styles; ++s) {
                        const unsigned h = dst.dense ? x + dst_part + term : x ^ dst_part ^ term;
                        store_row<C>(out + dst.row(h) * C, v[u]);
                        term += dst.dense ? cube : 3674653429u;
                    }
                }
            }
        }
        // The next level's columns start where this level's range ended.
        first = ((first - columns) % step + step) % step;
    }
}

template <int C>
int launch_grid_initialize(const float* ref, const int* levels, int num_levels, int num_styles,
                           float* out, cudaStream_t stream) {
    int device = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid_initialize_kernel<C><<<8 * sms, nst::kThreads, 0, stream>>>(ref, levels, num_levels,
                                                                     num_styles, out);
    return nst::launch_status();
}

}  // namespace

// ref [T_ref, C] f32, levels int32 [7, L] (resolution; the reference
// table's size, row offset and dense flag; the new table's size, row
// offset and dense flag), out [T, C] f32 zeroed by the caller.
// cudaErrorInvalidValue for an unsupported row width C.
NST_API int nst_grid_initialize(const void* ref, const void* levels, int num_levels, int channels,
                                int num_styles, void* out, void* stream) {
    const float* r = static_cast<const float*>(ref);
    const int* lv = static_cast<const int*>(levels);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_levels <= 0 || num_styles <= 0) return 0;
    switch (channels) {
        case 1: return launch_grid_initialize<1>(r, lv, num_levels, num_styles, o, s);
        case 2: return launch_grid_initialize<2>(r, lv, num_levels, num_styles, o, s);
        case 4: return launch_grid_initialize<4>(r, lv, num_levels, num_styles, o, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
