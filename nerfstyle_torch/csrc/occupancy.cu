// K6: occupancy-grid maintenance (the probe scatter-max, the EMA decay-max
// merge and the threshold to a bitfield).
//
// Replaces nerfstyle_tpu/ops/occupancy.py: the scatter-max of
// occupancy_update_random (`tmp.at[cas, idx].max(sig)`, :281) and
// _merge_and_threshold (:157-176), which both update paths end in:
//     grid = (grid >= 0 & tmp >= 0) ? max(grid * decay, tmp) : grid,
//     mean = mean(max(grid, 0)),  bitfield = grid > min(mean, density_thresh).
//
// Scatter-max: one thread per probe, atomicMax on the float's int32 bits.
// The order of int32 bits is the order of the floats for every value >= +0,
// and the fill -1.0f has the sign bit set, so it is below every probe: probe
// sigmas are exp(.) * density_scale >= 0.  A max is order-free, so the
// result is exact and deterministic whatever the atomics' order.
//
// Merge + threshold (K6m): one cooperative launch, every CTA resident (2 an
// SM), with a grid-wide barrier between the merge and the threshold.  A CTA
// takes one contiguous chunk of the grid: it reads grid and tmp with 16-byte
// streaming loads (evict first, so the L2 keeps the outputs; two a thread in
// flight before the first use), writes the merged cells with 16-byte stores,
// keeps them in shared memory (up to 96 KiB a CTA: the whole 2 x 128^3 grid
// fits the 132 SMs) and sums max(cell, 0) in double: a thread in a fixed
// order, then a fixed shuffle tree and the warps in order, one partial a CTA.
// After the barrier every CTA sums the partials in one fixed order (so every
// CTA, and every launch, gets the same mean bits), and thresholds its chunk
// from shared memory (cells past the 96 KiB read back from the merged grid, L2
// at most sizes) four cells, one 4-byte store, a thread.  So the grid is read
// once; tmp once; the merged grid and the bitfield written once.  Unaligned
// pointers take the same walk a cell at a time.
//
// Bound on the H100: bytes (a 2 x 128^3 grid: grid and tmp read, the merged
// grid and the bitfield written, 13 bytes a cell: 54.6 MB, ~0.016 ms).  The
// scatter-max moves 12 bytes a probe (index + sigma) and one random 4-byte
// read-modify-write in L2.
//
// K6c: the skip distance, replacing skipdist_from_bitfield (:99, with
// _dilate3 :85), which the JAX package rebuilds after every merge (:174) and
// every restore (:78): each cell holds the first k of 0..dmax-1 at which k
// 3x3x3 dilations (the grid not wrapping) of its cascade's occupancy cover
// it, and dmax (15) if none does.  One entry, one launch, at every grid
// size 1..kSkipMaxGrid; bits and integer logic only (no atomics: two
// launches give equal bits).
//
// A CTA takes one (x, y) tile of a cascade, at most kTileMax cells a side,
// and its region: the tile and a halo of dmax - 1 cells each side in x and
// y, clipped at the grid's faces.  It packs the region's z-lines as bits in
// shared memory, W = ceil(h / 32) words a line: the whole line up to W = 4
// (h <= 128), else a chunk of two central words and a word of halo each
// side (of which only the 16 cells next to the chunk are read), a CTA a
// chunk.  A word comes from the aligned 16-byte pieces that hold its 32
// bytes, 4 bool bytes folded into 4 bits by one multiply; two words' reads
// a thread in flight.  Then dmax - 1 rounds, each one 3x3x3 dilation on
// the lines still exact (r cells in from each halo side that is not a
// face, so after dmax - 1 rounds the tile's own cells are), in two phases
// between two buffers, a thread a line: the OR of lines y-1..y+1 of a
// plane, z-dilated by funnel shifts across the chunk's words; then the OR
// of three planes of that.  The distance is the number of rounds 0..dmax-1
// that have not covered a cell, kept as four bit-sliced words a central
// word in registers: the covered sets are nested, so bit j of the count
// flips at each round r with 2^j dividing r + 1.  At the end the counts
// go through shared memory and leave four cells (one 4-byte store where
// aligned) a thread, neighbouring threads on neighbouring cells.  The host
// picks the tile side with the least modelled time (tiles in waves of one
// an SM, times the words a tile's pack and rounds touch).
//
// Bound on the H100: bytes, the bitfield in and the distances out (2 x
// 256^3 cells: 32 MiB each, ~0.020 ms).  What holds the kernel is the
// halo: at 2 x 256^3 a 32-cell tile packs 3.5 times its own lines (and the
// chunk's halo words), and its rounds touch 2 times its own words; the
// pack and the write alone take about half the time, the rounds the rest,
// each round a few hundred cycles of latency-bound shared-memory work at
// one or two CTAs an SM.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMergeThreads = 512;
constexpr int kMergeBlocksPerSm = 2;
constexpr int kMergeKeep = 24576;  // merged cells a CTA keeps in shared memory (96 KiB)
constexpr int kMergeUnroll = 2;    // 16-byte loads of grid and of tmp a thread in flight

__global__ void scatter_max_kernel(float* __restrict__ tmp, const long long* __restrict__ idx,
                                   const float* __restrict__ sig, long long num_probes) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= num_probes) return;
    atomicMax(reinterpret_cast<int*>(tmp + idx[i]), __float_as_int(sig[i]));
}

// The grid-wide barrier of K6m (cooperative groups' scheme): CTA 0 adds
// 2^31 - (G - 1), every other CTA 1, so the word's top bit flips exactly
// when all G have arrived and its low bits are back where they were.
__device__ unsigned int merge_barrier_word = 0u;

__device__ __forceinline__ void grid_barrier() {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1u) : 1u;
        __threadfence();
        const unsigned int old = atomicAdd(&merge_barrier_word, add);
        while (((old ^ *static_cast<volatile unsigned int*>(&merge_barrier_word)) &
                0x80000000u) == 0u) {
        }
        __threadfence();
    }
    __syncthreads();
}

// A warp's sum of v in a fixed order (a shuffle-down tree), broadcast from
// lane 0 so every lane holds the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float merge_cell(float g, float t, float decay) {
    return (g >= 0.f && t >= 0.f) ? fmaxf(__fmul_rn(g, decay), t) : g;
}

// V cells: one 4V-byte load or store; V flags: one V-byte store.
template <int V>
struct alignas(4 * V) Cells {
    float v[V];
};
template <int V>
struct alignas(V) Flags {
    unsigned char v[V];
};

// A streaming load (evict first): grid and tmp are read once, so the L2
// keeps the merged grid and the bitfield instead.
template <int V>
__device__ __forceinline__ Cells<V> load_streaming(const Cells<V>* p) {
    Cells<V> c;
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(c.v) = __ldcs(reinterpret_cast<const float4*>(p));
    } else {
        c.v[0] = __ldcs(p->v);
    }
    return c;
}

// K6m, see the header.  V = 4 (16-byte aligned grid, tmp and merged grid,
// 4-byte aligned bitfield) or 1.  A CTA's chunk starts at a multiple of 16
// cells.
template <int V>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocksPerSm)
merge_threshold_kernel(const float* __restrict__ grid, const float* __restrict__ tmp, float decay,
                       long long n, long long chunk, float density_thresh,
                       float* __restrict__ out, unsigned char* __restrict__ bits,
                       double* __restrict__ partials, float* __restrict__ mean_out) {
    extern __shared__ float4 merge_smem4[];
    float* keep = reinterpret_cast<float*>(merge_smem4);
    __shared__ double warp_part[kMergeThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long begin = min(n, static_cast<long long>(blockIdx.x) * chunk);
    const int len = static_cast<int>(min(n, begin + chunk) - begin);
    const int kept = min(len, kMergeKeep);
    const int nv = len / V;
    using C = Cells<V>;
    const C* g_v = reinterpret_cast<const C*>(grid + begin);
    const C* t_v = reinterpret_cast<const C*>(tmp + begin);
    C* o_v = reinterpret_cast<C*>(out + begin);
    C* k_v = reinterpret_cast<C*>(keep);

    // Merge: vectors v = t, t + T, ... (kMergeUnroll loaded before use).
    double acc = 0.0;
    for (int v0 = threadIdx.x; v0 < nv; v0 += kMergeThreads * kMergeUnroll) {
        C a[kMergeUnroll], b[kMergeUnroll];
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u) {
            const int v = v0 + u * kMergeThreads;
            if (v < nv) {
                a[u] = load_streaming(g_v + v);
                b[u] = load_streaming(t_v + v);
            }
        }
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u) {
            const int v = v0 + u * kMergeThreads;
            if (v < nv) {
                C m;
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    m.v[j] = merge_cell(a[u].v[j], b[u].v[j], decay);
                    acc += static_cast<double>(fmaxf(m.v[j], 0.f));
                }
                o_v[v] = m;
                if (V * v < kept) k_v[v] = m;
            }
        }
    }
    for (int i = V * nv + threadIdx.x; i < len; i += kMergeThreads) {  // V = 4: the tail
        const float m = merge_cell(grid[begin + i], tmp[begin + i], decay);
        acc += static_cast<double>(fmaxf(m, 0.f));
        out[begin + i] = m;
        if (i < kept) keep[i] = m;
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_part[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int w = 0; w < kMergeThreads / 32; ++w) s += warp_part[w];
        partials[blockIdx.x] = s;
    }

    grid_barrier();

    // The mean: the CTAs' partials in one fixed order, the same in every CTA.
    if (warp == 0) {
        double s = 0.0;
        for (int j = lane; j < static_cast<int>(gridDim.x); j += 32) s += __ldcg(partials + j);
        s = warp_sum(s);
        if (lane == 0) warp_part[0] = s;
    }
    __syncthreads();
    const float mean = static_cast<float>(warp_part[0] / static_cast<double>(n));
    if (blockIdx.x == 0 && threadIdx.x == 0) *mean_out = mean;
    const float thresh = fminf(mean, density_thresh);

    // Threshold: V cells a thread a store, from shared memory (or read back).
    using F = Flags<V>;
    F* b_v = reinterpret_cast<F*>(bits + begin);
    for (int v = threadIdx.x; v < nv; v += kMergeThreads) {
        C m;
        if (V * v < kept) {
            m = k_v[v];
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j) m.v[j] = __ldcg(out + begin + V * v + j);
        }
        F f;
#pragma unroll
        for (int j = 0; j < V; ++j) f.v[j] = m.v[j] > thresh;
        b_v[v] = f;
    }
    for (int i = V * nv + threadIdx.x; i < len; i += kMergeThreads) {
        bits[begin + i] = (i < kept ? keep[i] : __ldcg(out + begin + i)) > thresh;
    }
}

// CTAs of K6m: kMergeBlocksPerSm on every SM of the current device.
int merge_grid() {
    static int grid = 0;
    if (grid == 0) {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            return 0;
        }
        grid = sms * kMergeBlocksPerSm;
    }
    return grid;
}

template <int V>
int launch_merge(const float* grid, const float* tmp, float decay, long long n, long long chunk,
                 float density_thresh, float* out, unsigned char* bits, double* partials,
                 float* mean, int ctas, cudaStream_t stream) {
    const int smem = static_cast<int>(chunk < kMergeKeep ? chunk : kMergeKeep) *
                     static_cast<int>(sizeof(float));
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            merge_threshold_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kMergeKeep * static_cast<int>(sizeof(float)));
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = true;
    }
    void* args[] = {&grid, &tmp, &decay, &n, &chunk, &density_thresh, &out, &bits, &partials,
                    &mean};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(merge_threshold_kernel<V>), dim3(ctas),
        dim3(kMergeThreads), args, static_cast<size_t>(smem), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return nst::launch_status();
}

// A line chunk of NW words to registers and back (16- or 8-byte accesses
// where NW is 4 or 2).
template <int W>
__device__ __forceinline__ void load_line(const uint32_t* s, uint32_t (&v)[W]) {
    if constexpr (W == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(s);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (W == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(s);
        v[0] = q.x; v[1] = q.y;
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) v[i] = s[i];
    }
}

template <int W>
__device__ __forceinline__ void store_line(uint32_t* s, const uint32_t (&v)[W]) {
    if constexpr (W == 4) {
        *reinterpret_cast<uint4*>(s) = make_uint4(v[0], v[1], v[2], v[3]);
    } else if constexpr (W == 2) {
        *reinterpret_cast<uint2*>(s) = make_uint2(v[0], v[1]);
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) s[i] = v[i];
    }
}

// Four bool bytes (0 or 1) -> 4 bits, byte k at bit k.
__device__ __forceinline__ uint32_t nibble(uint32_t x) { return (x * 0x01020408u) >> 24 & 0xFu; }

// 4 bits -> 4 bytes of 0 or 1, bit k at byte k.
__device__ __forceinline__ uint32_t spread(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

// K6c, see the header.
constexpr int kTileThreads = 512;
constexpr int kTileMax = 32;    // central cells of a tile along x and y
constexpr int kTileOwn = 4;     // central words a thread counts: a tile has at most 2048
constexpr int kPackUnroll = 2;  // words a thread packs with their reads in flight
constexpr int kSkipMaxGrid = 2048;  // kernels.SKIPDIST_MAX_GRID
constexpr int kTileMaxSmem = 227 * 1024;

// Tile b: cascade cas, central cells [x0, x0 + sx) x [y0, y0 + sy) and
// z-words [w0, w0 + swc); its region, the central cells and a halo of dmax
// - 1 cells each side clipped at the faces, [xs, xs + nx) x [ys, ys + ny),
// the central cells at (cx, cy) in it.
struct SkipTile {
    int h, W, halo, cas;
    int x0, sx, xs, nx, cx;
    int y0, sy, ys, ny, cy;
    int w0, swc;
    // The z-line of region line (px, py): its index, and its first cell.
    __device__ size_t line_index(int px, int py) const {
        return (static_cast<size_t>(cas) * h + xs + px) * h + ys + py;
    }
    __device__ size_t line(int px, int py) const { return line_index(px, py) * h; }
};

__device__ __forceinline__ SkipTile skip_tile(int h, int dmax, int tile, int wc, int b) {
    SkipTile t;
    t.h = h;
    t.W = (h + 31) >> 5;
    t.halo = dmax - 1;
    const int nt = (h + tile - 1) / tile, nwz = (t.W + wc - 1) / wc;
    const int tz = b % nwz;
    b /= nwz;
    const int ty = b % nt;
    b /= nt;
    const int tx = b % nt;
    t.cas = b / nt;
    t.x0 = tx * tile;
    t.sx = min(tile, h - t.x0);
    t.xs = max(0, t.x0 - t.halo);
    t.nx = min(h, t.x0 + t.sx + t.halo) - t.xs;
    t.cx = t.x0 - t.xs;
    t.y0 = ty * tile;
    t.sy = min(tile, h - t.y0);
    t.ys = max(0, t.y0 - t.halo);
    t.ny = min(h, t.y0 + t.sy + t.halo) - t.ys;
    t.cy = t.y0 - t.ys;
    t.w0 = tz * wc;
    t.swc = min(wc, t.W - t.w0);
    return t;
}

// 16 bool bytes -> 16 bits, byte k at bit k.
__device__ __forceinline__ uint32_t fold16(uint4 q) {
    return nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8 | nibble(q.w) << 12;
}

// A word of cells bits[s, s + n) (n in 0..32), from the aligned 16-byte
// pieces that hold them: the bitfield is 16-byte aligned, and a piece is
// read only if it holds one of the cells, so no read leaves the
// allocation's last 16-byte piece.  load issues the reads, word assembles
// them, so that a thread keeps several words' reads in flight.
struct PackedWord {
    uint4 q[3];
    int m, n, at;
    // Cells [s, s + cells) (cells 0: none) to bits at, at + 1, ...
    __device__ __forceinline__ void load(const unsigned char* __restrict__ bits, size_t s,
                                         int cells, int first_bit) {
        m = static_cast<int>(s & 15u);
        n = cells;
        at = first_bit;
        const unsigned char* c = bits + (s - m);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            q[k] = 16 * k < m + n ? __ldg(reinterpret_cast<const uint4*>(c + 16 * k))
                                  : make_uint4(0u, 0u, 0u, 0u);
        }
    }
    __device__ __forceinline__ uint32_t word() const {
        const unsigned long long acc = fold16(q[0]) |
                                       static_cast<unsigned long long>(fold16(q[1])) << 16 |
                                       static_cast<unsigned long long>(fold16(q[2])) << 32;
        const uint32_t w = static_cast<uint32_t>(acc >> m);
        return (n >= 32 ? w : w & ((1u << n) - 1u)) << at;
    }
};

// Adds round r's uncovered cells (~d) to the bit-sliced count c of rounds
// 0..r that have not covered a cell.  The sets are nested, so a cell's
// count is the first round that covers it; bit j of it is the XOR over m =
// 2^j, 2 * 2^j, ... of [count >= m], and [count >= r + 1] = ~d: bit j flips
// at each round r with 2^j dividing r + 1.
__device__ __forceinline__ void count_round(uint32_t (&c)[4], uint32_t d, int r) {
    const uint32_t nd = ~d;
    c[0] ^= nd;
    if (((r + 1) & 1) == 0) c[1] ^= nd;
    if (((r + 1) & 3) == 0) c[2] ^= nd;
    if (((r + 1) & 7) == 0) c[3] ^= nd;
}

// The z-dilated OR of lines y-1..y+1 of region plane p: each bit ORed with
// its z-neighbours by funnel shifts across the chunk's words, nothing past
// its ends.
template <int NW>
__device__ __forceinline__ void tile_yz(const uint32_t* src, int ny, int p, int y,
                                        uint32_t (&d)[NW]) {
    const uint32_t* at = src + (p * ny + y) * NW;
    uint32_t v[NW], u[NW];
    load_line<NW>(at, v);
    if (y > 0) {
        load_line<NW>(at - NW, u);
#pragma unroll
        for (int i = 0; i < NW; ++i) v[i] |= u[i];
    }
    if (y + 1 < ny) {
        load_line<NW>(at + NW, u);
#pragma unroll
        for (int i = 0; i < NW; ++i) v[i] |= u[i];
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        d[i] = v[i] | __funnelshift_l(i > 0 ? v[i - 1] : 0u, v[i], 1) |
               __funnelshift_r(v[i], i + 1 < NW ? v[i + 1] : 0u, 1);
    }
}

// Writes tile t's central cells from their bit-sliced distances,
// stage[j * ncw + u] for bit j of central word u = (i * sy + jy) * swc +
// jw, four cells (one 4-byte store where aligned) a thread, neighbouring
// threads on neighbouring cells of a line.
__device__ void write_tile(const SkipTile& t, const uint32_t* stage,
                           unsigned char* __restrict__ out) {
    const int ncw = t.sx * t.sy * t.swc;
    const int zc = min(t.h, 32 * (t.w0 + t.swc)) - 32 * t.w0;  // cells of a central line
    const int ng = (zc + 3) >> 2;
    for (int q = threadIdx.x; q < t.sx * t.sy * ng; q += kTileThreads) {
        const int li = q / ng, z = 4 * (q - li * ng);
        const int i = li / t.sy, jy = li - i * t.sy;
        const int u = li * t.swc + (z >> 5), b = z & 31;
        uint32_t v = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) v |= spread(stage[j * ncw + u] >> b & 0xFu) << j;
        unsigned char* dst = out + t.line(t.cx + i, t.cy + jy) + 32 * t.w0 + z;
        if (z + 4 <= zc && (reinterpret_cast<uintptr_t>(dst) & 3u) == 0u) {
            *reinterpret_cast<uint32_t*>(dst) = v;
        } else {
            for (int k = 0; k < 4 && z + k < zc; ++k) {
                dst[k] = static_cast<unsigned char>(v >> 8 * k);
            }
        }
    }
}

// K6c, see the header.  NW words a line chunk: the whole line (W <= 4), or
// 4 (W > 4: central words w0, w0 + 1 and a word each side).
template <int NW>
__global__ void __launch_bounds__(kTileThreads, 2)
skipdist_kernel(const unsigned char* __restrict__ bits, int h, int dmax, int tile, int wc,
                unsigned char* __restrict__ out) {
    extern __shared__ uint4 tile_smem4[];
    const SkipTile t = skip_tile(h, dmax, tile, wc, blockIdx.x);
    const int zoff = t.W > NW ? 1 : 0;  // the chunk slot of word w0
    const int nl = t.nx * t.ny;
    uint32_t* A = reinterpret_cast<uint32_t*>(tile_smem4);  // [nx][ny][NW]
    uint32_t* B = A + nl * NW;
    for (int q0 = threadIdx.x; q0 < nl * NW; q0 += kPackUnroll * kTileThreads) {
        PackedWord pw[kPackUnroll];
#pragma unroll
        for (int u = 0; u < kPackUnroll; ++u) {
            const int q = min(q0 + u * kTileThreads, nl * NW - 1);
            const int L = q / NW, j = q - L * NW, word = t.w0 - zoff + j, px = L / t.ny;
            // A halo word's cells within dmax - 1 of the central words: its
            // upper half (before them) or its lower half (after them).
            const int lo = zoff && j == 0 ? 16 : 0;
            const int hi = min(zoff && j == NW - 1 ? 16 : 32, h - 32 * word);
            const bool in = word >= 0 && word < t.W;
            pw[u].load(bits, in ? t.line(px, L - px * t.ny) + 32 * word + lo : 0,
                       in ? hi - lo : 0, lo);
        }
#pragma unroll
        for (int u = 0; u < kPackUnroll; ++u) {
            if (q0 + u * kTileThreads < nl * NW) A[q0 + u * kTileThreads] = pw[u].word();
        }
    }
    // The central words a thread counts: u = threadIdx.x + k * kTileThreads.
    const int ncw = t.sx * t.sy * t.swc;
    uint32_t cnt[kTileOwn][4];
    int own[kTileOwn];
#pragma unroll
    for (int k = 0; k < kTileOwn; ++k) {
        const int u = threadIdx.x + k * kTileThreads;
        const int li = u / t.swc, i = li / t.sy, jy = li - i * t.sy;
        own[k] = ((t.cx + i) * t.ny + t.cy + jy) * NW + zoff + (u - li * t.swc);
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[k][j] = 0u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileOwn; ++k) {
        if (threadIdx.x + k * kTileThreads < ncw) count_round(cnt[k], A[own[k]], 0);
    }
    for (int r = 1; r < dmax; ++r) {
        // Lines exact after r rounds: [ax, bx) x [ay, by).  First B = yz(A)
        // on those planes and one more each side, then A = the OR of three
        // planes of B; a thread a line: line y of every ystep-th plane from
        // tp on.
        const int ax = t.xs > 0 ? r : 0, bx = t.xs + t.nx < h ? t.nx - r : t.nx;
        const int ay = t.ys > 0 ? r : 0, by = t.ys + t.ny < h ? t.ny - r : t.ny;
        const int rows = by - ay, ystep = kTileThreads / rows;
        const int tp = threadIdx.x / rows, y = ay + threadIdx.x - tp * rows;
        if (tp < ystep) {
            for (int p = max(0, ax - 1) + tp; p < min(t.nx, bx + 1); p += ystep) {
                uint32_t d[NW];
                tile_yz<NW>(A, t.ny, p, y, d);
                store_line<NW>(B + (p * t.ny + y) * NW, d);
            }
        }
        __syncthreads();
        if (tp < ystep) {
            for (int p = ax + tp; p < bx; p += ystep) {
                const uint32_t* at = B + (p * t.ny + y) * NW;
                uint32_t v[NW], u[NW];
                load_line<NW>(at, v);
                if (p > 0) {
                    load_line<NW>(at - t.ny * NW, u);
#pragma unroll
                    for (int i = 0; i < NW; ++i) v[i] |= u[i];
                }
                if (p + 1 < t.nx) {
                    load_line<NW>(at + t.ny * NW, u);
#pragma unroll
                    for (int i = 0; i < NW; ++i) v[i] |= u[i];
                }
                store_line<NW>(A + (p * t.ny + y) * NW, v);
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTileOwn; ++k) {
            if (threadIdx.x + k * kTileThreads < ncw) count_round(cnt[k], A[own[k]], r);
        }
    }
    __syncthreads();
    uint32_t* stage = reinterpret_cast<uint32_t*>(tile_smem4);
#pragma unroll
    for (int k = 0; k < kTileOwn; ++k) {
        const int u = threadIdx.x + k * kTileThreads;
        if (u < ncw) {
#pragma unroll
            for (int j = 0; j < 4; ++j) stage[j * ncw + u] = cnt[k][j];
        }
    }
    __syncthreads();
    write_tile(t, stage, out);
}

int num_sms() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            return 0;
        }
    }
    return sms;
}

// A launch of K6c: the central tile's side, words a line chunk
// and central words of it, tiles (a CTA each) and shared memory.
struct TilePlan {
    int tile, nw, wc, tiles;
    size_t smem;
};

// The tile side with the least modelled time: the tiles in waves of one an
// SM, times a tile's word updates (its region's pack, then each round over
// the lines still exact); a fixed side when tile > 0.
TilePlan plan_tiles(int h, int cascades, int dmax, int tile, int sms) {
    sms = std::max(sms, 1);
    const long long W = (h + 31) / 32, halo = dmax - 1;
    TilePlan best{0, W <= 4 ? static_cast<int>(W) : 4, W <= 4 ? static_cast<int>(W) : 2, 0, 0};
    const long long nwz = (W + best.wc - 1) / best.wc, nw = best.nw, wc = best.wc;
    const int t0 = tile > 0 ? tile : 1, t1 = tile > 0 ? tile : std::min(h, kTileMax);
    double best_cost = 0.0;
    for (int T = t0; T <= t1; ++T) {
        const long long c = std::min(T, h), e = std::min<long long>(h, T + 2 * halo);
        const long long smem = 4 * std::max(2 * e * e * nw, 4 * c * c * wc);
        if (smem > kTileMaxSmem || c * c * wc > kTileOwn * kTileThreads) continue;
        const long long nt = (h + T - 1) / T, tiles = cascades * nt * nt * nwz;
        double work = static_cast<double>(e * e * nw);  // the region's load
        for (long long r = 1; r <= halo; ++r) {
            const double er = static_cast<double>(std::min<long long>(h, T + 2 * (halo - r)));
            work += er * er * static_cast<double>(nw);
        }
        const double cost = static_cast<double>((tiles + sms - 1) / sms) * work;
        if (best.tile == 0 || cost < best_cost) {
            best.tile = T;
            best.tiles = static_cast<int>(tiles);
            best.smem = static_cast<size_t>(smem);
            best_cost = cost;
        }
    }
    return best;
}

template <int NW>
int launch_skipdist(const TilePlan& p, const unsigned char* bits, int h, int dmax,
                    unsigned char* out, cudaStream_t stream) {
    static size_t smem_set = 0;  // the largest dynamic shared memory allowed so far
    if (p.smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(skipdist_kernel<NW>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(p.smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = p.smem;
    }
    skipdist_kernel<NW><<<p.tiles, kTileThreads, p.smem, stream>>>(bits, h, dmax, p.tile, p.wc,
                                                                    out);
    return nst::launch_status();
}

}  // namespace

// tmp [K] f32 (updated in place), idx [P] i64 (flat cell index into tmp),
// sig [P] f32 >= 0.
NST_API int nst_occupancy_scatter_max(void* tmp, const void* idx, const void* sig,
                                      long long num_probes, void* stream) {
    if (num_probes <= 0) return 0;
    scatter_max_kernel<<<nst::blocks_for(num_probes), nst::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(tmp), static_cast<const long long*>(idx),
        static_cast<const float*>(sig), num_probes);
    return nst::launch_status();
}

// Number of double partial sums nst_occupancy_merge writes (its CTAs).
NST_API int nst_occupancy_num_partials() { return merge_grid(); }

// K6m: grid, tmp [K] f32 -> out [K] f32 (the merged grid), bitfield [K]
// bool, mean [1] f32; partials [nst_occupancy_num_partials()] f64 scratch.
NST_API int nst_occupancy_merge(const void* grid, const void* tmp, float decay, long long n,
                                float density_thresh, void* out, void* bitfield, void* partials,
                                void* mean, void* stream) {
    if (n <= 0) return 0;
    const int ctas = merge_grid();
    if (ctas <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const long long chunk = ((n + ctas - 1) / ctas + 15) / 16 * 16;
    const auto* g = static_cast<const float*>(grid);
    const auto* t = static_cast<const float*>(tmp);
    auto* o = static_cast<float*>(out);
    auto* b = static_cast<unsigned char*>(bitfield);
    auto* p = static_cast<double*>(partials);
    auto* m = static_cast<float*>(mean);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec = (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(t) |
                      reinterpret_cast<uintptr_t>(o)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 4 == 0;
    if (vec) return launch_merge<4>(g, t, decay, n, chunk, density_thresh, o, b, p, m, ctas, s);
    return launch_merge<1>(g, t, decay, n, chunk, density_thresh, o, b, p, m, ctas, s);
}

// K6c: bitfield [cascades * h^3] bool (16-byte aligned) -> out [same] u8,
// 1 <= h <= kSkipMaxGrid, 1 <= dmax <= 15; one launch.  tile > 0 fixes the
// central tile's side (the host's model picks it at 0).
NST_API int nst_occupancy_skipdist(const void* bitfield, int grid_size, long long n, int dmax,
                                   int tile, void* out, void* stream) {
    const int h = grid_size;
    const long long h3 = static_cast<long long>(h) * h * h;
    if (h <= 0 || h > kSkipMaxGrid || dmax < 1 || dmax > 15 || n % h3 ||
        tile > kTileMax || reinterpret_cast<uintptr_t>(bitfield) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const int sms = num_sms();
    if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const TilePlan p = plan_tiles(h, static_cast<int>(n / h3), dmax, tile, sms);
    if (p.tile == 0) return static_cast<int>(cudaErrorInvalidValue);
    const auto* in = static_cast<const unsigned char*>(bitfield);
    auto* o = static_cast<unsigned char*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (p.nw) {
        case 1: return launch_skipdist<1>(p, in, h, dmax, o, s);
        case 2: return launch_skipdist<2>(p, in, h, dmax, o, s);
        case 3: return launch_skipdist<3>(p, in, h, dmax, o, s);
        default: return launch_skipdist<4>(p, in, h, dmax, o, s);
    }
}

// The launch nst_occupancy_skipdist makes: plan[0..3] = tile side,
// words a line chunk, central words of it, tiles; returns the shared memory
// (0 if no tile fits).
NST_API long long nst_occupancy_skipdist_plan(int grid_size, int cascades, int dmax, int tile,
                                              int* plan) {
    const TilePlan p = plan_tiles(grid_size, cascades, dmax, tile, num_sms());
    plan[0] = p.tile;
    plan[1] = p.nw;
    plan[2] = p.wc;
    plan[3] = p.tiles;
    return static_cast<long long>(p.smem);
}
