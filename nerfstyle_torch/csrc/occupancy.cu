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
// it, and dmax (15) if none does.
//
// One launch, one fused pass over a tile in shared memory, bits and integer
// logic only (no atomics: two launches give equal bits).  A CTA takes
// kSkipSlab x-planes of one cascade and loads them with a halo of dmax-1
// planes each side (clipped at the grid's faces), at full y and z extent,
// packed as bits:
// a z-line of h cells is W = ceil(h/32) 32-bit words (h = 128: a plane is 2
// KiB, 30 planes 60 KiB, two ping-pong buffers 120 KiB of dynamic shared
// memory, with the counters 136 KiB).  The pack reads 32 bytes a thread
// (two 16-byte loads, coalesced) and folds 4 bool bytes into 4 bits with
// one multiply.  Then dmax-1 rounds, each one dilation from one buffer into
// the other: a thread walks a run of planes along one line y, keeping three
// planes' "yz" in registers (lines y-1..y+1 ORed, then z-dilated by shifts
// with carries across the line's words) and ORing them across x.  A round
// is exact one plane further in from each halo side than the last, so it
// computes only the planes still exact, and after dmax-1 rounds the central
// planes are.  The distance is the number of rounds 0..dmax-1 in which a
// cell is not yet covered: a 4-bit counter kept bit-sliced in four words a
// word, in shared memory.  At the end a thread a central line expands its
// counters to bytes (a multiply a 4 cells) and writes them with 16-byte
// stores.  h must be a multiple of 16 (a tail word is masked) and at most
// 128 (W <= 4; the wrapper raises above).
// Bound on the H100: bytes, the bitfield in and the distances out (2 x 128^3
// cells: 4 MiB each, ~2.5 us).  The kernel is held by instructions instead:
// ~40 a line a round from shared memory, 14 rounds over a slab 15 times
// wider than its central planes, at ~1 CTA an SM.
//
// K6c general: every other grid size (not a multiple of 16, or above 128)
// takes three separable axis passes instead, one launch an axis (z, y, x),
// one thread a cell.  The L-inf distance is separable:
//     d(x, y, z) = min_x' max(|x - x'|, min_y' max(|y - y'|,
//                  min_z' max(|z - z'|, occupied(x', y', z') ? 0 : dmax)))
// and the cap commutes with each step (a window never reaches past dmax).
// A pass takes the min of max(|delta|, d_prev) over the cell's neighbours
// along its axis, walking outward from delta 0 and stopping once |delta|
// reaches the best so far; the first pass reads the bitfield.  Integer
// arithmetic: equal bits to the iterated dilation at any grid size.  Each
// pass reads up to 2 (dmax - 1) neighbours a cell again from L1/L2 and
// writes a 1-byte intermediate.
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

// One K6c axis pass over n cells (cascade * h^3), axis stride 1 (z), h (y)
// or h * h (x).  from_bits: in is the bitfield (0 where occupied, dmax
// elsewhere); else in holds the previous pass's distances.
__global__ void skipdist_pass_kernel(const unsigned char* __restrict__ in, bool from_bits,
                                     int h, long long n, long long stride, int dmax,
                                     unsigned char* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int c = static_cast<int>((i / stride) % h);
    auto dist = [&](long long j) -> int {
        const int v = in[j];
        return from_bits ? (v ? 0 : dmax) : v;
    };
    int best = dist(i);
    for (int r = 1; r < best; ++r) {
        if (c - r >= 0) best = min(best, max(r, dist(i - r * stride)));
        if (c + r < h) best = min(best, max(r, dist(i + r * stride)));
    }
    out[i] = static_cast<unsigned char>(best);
}

// K6c, see the header.  Shared memory: two buffers of pmax planes x h lines
// x W words, pmax = min(h, kSkipSlab + 2 (dmax - 1)), and the counters, 4
// words a word of the central planes.
constexpr int kSkipSlab = 2;       // central x-planes a CTA
constexpr int kSkipThreads = 512;
constexpr int kSkipMaxGrid = 128;  // W <= 4 words a line (kernels.SKIPDIST_MAX_GRID)

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

// The line's z-dilation: each bit ORed with its two z-neighbours, carries
// across words, nothing past either end; the tail word masked.
template <int W>
__device__ __forceinline__ void dilate_z(const uint32_t (&v)[W], uint32_t (&d)[W], uint32_t tail) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
        uint32_t x = v[i] | (v[i] << 1) | (v[i] >> 1);
        if (i > 0) x |= v[i - 1] >> 31;
        if (i < W - 1) x |= v[i + 1] << 31;
        d[i] = x;
    }
    d[W - 1] &= tail;
}

// Four bool bytes (0 or 1) -> 4 bits, byte k at bit k.
__device__ __forceinline__ uint32_t nibble(uint32_t x) { return (x * 0x01020408u) >> 24 & 0xFu; }

// 4 bits -> 4 bytes of 0 or 1, bit k at byte k.
__device__ __forceinline__ uint32_t spread(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

template <int W>
__global__ void __launch_bounds__(kSkipThreads)
skipdist_kernel(const unsigned char* __restrict__ bits, int h, int dmax, int pmax,
                unsigned char* __restrict__ out) {
    extern __shared__ uint4 skip_smem4[];
    const int halo = dmax - 1;
    const int nslab = (h + kSkipSlab - 1) / kSkipSlab;
    const int cas = blockIdx.x / nslab;
    const int x0 = (blockIdx.x % nslab) * kSkipSlab;
    const int sc = min(kSkipSlab, h - x0);
    const int xs = max(0, x0 - halo), xe = min(h, x0 + sc + halo);
    const int np = xe - xs, c0 = x0 - xs;
    const int t = threadIdx.x;
    const size_t h2 = static_cast<size_t>(h) * h;
    const size_t base = static_cast<size_t>(cas) * h2 * h + static_cast<size_t>(xs) * h2;
    uint32_t* A = reinterpret_cast<uint32_t*>(skip_smem4);  // [pmax][h][W]
    uint32_t* B = A + pmax * h * W;
    uint32_t* cnt = B + pmax * h * W;  // [4 bits][kSkipSlab * h lines][W]: the counters
    const int cl = kSkipSlab * h;      // counter lines a bit
    const uint32_t tail = (h & 31) ? (1u << (h & 31)) - 1u : ~0u;

    // Pack the slab: word q = (line, w) from its 32 bytes (16 at a tail).
    for (int q = t; q < np * h * W; q += kSkipThreads) {
        const int line = q / W, w = q - line * W;
        const unsigned char* src = bits + base + static_cast<size_t>(line) * h + 32 * w;
        const uint4 lo = *reinterpret_cast<const uint4*>(src);
        uint32_t word = nibble(lo.x) | nibble(lo.y) << 4 | nibble(lo.z) << 8 | nibble(lo.w) << 12;
        if (32 * w + 16 < h) {
            const uint4 hi = *reinterpret_cast<const uint4*>(src + 16);
            word |= (nibble(hi.x) | nibble(hi.y) << 4 | nibble(hi.z) << 8 | nibble(hi.w) << 12)
                    << 16;
        }
        A[q] = word;
    }
    for (int q = t; q < 4 * cl * W; q += kSkipThreads) cnt[q] = 0u;

    // Adds 1 to the counter of each cell of central line (p, y) that v does
    // not cover: a ripple carry through the four bit-sliced words.
    auto count = [&](int p, int y, const uint32_t (&v)[W]) {
        uint32_t* c = cnt + ((p - c0) * h + y) * W;
        uint32_t k[4][W];
#pragma unroll
        for (int j = 0; j < 4; ++j) load_line<W>(c + j * cl * W, k[j]);
#pragma unroll
        for (int i = 0; i < W; ++i) {
            uint32_t carry = ~v[i] & (i == W - 1 ? tail : ~0u);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t next = k[j][i] & carry;
                k[j][i] ^= carry;
                carry = next;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) store_line<W>(c + j * cl * W, k[j]);
    };
    __syncthreads();
    for (int L = t; L < sc * h; L += kSkipThreads) {
        uint32_t v[W];
        load_line<W>(A + (c0 * h + L) * W, v);
        count(c0 + L / h, L % h, v);
    }

    // y and z of plane p, line y: the OR of lines y-1..y+1, z-dilated.
    auto yz = [&](const uint32_t* src, int p, int y, uint32_t (&d)[W]) {
        uint32_t v[W], u[W];
        load_line<W>(src + (p * h + y) * W, v);
        if (y > 0) {
            load_line<W>(src + (p * h + y - 1) * W, u);
#pragma unroll
            for (int i = 0; i < W; ++i) v[i] |= u[i];
        }
        if (y < h - 1) {
            load_line<W>(src + (p * h + y + 1) * W, u);
#pragma unroll
            for (int i = 0; i < W; ++i) v[i] |= u[i];
        }
        dilate_z<W>(v, d, tail);
    };
    const int nchunks = max(1, kSkipThreads / h);
    for (int r = 1; r <= halo; ++r) {
        // Planes exact after r dilations: [a, b); a thread takes a run of
        // them along one line (y), three planes of yz in registers:
        // B[p] = yz(A[p-1]) | yz(A[p]) | yz(A[p+1]).
        const int a = xs > 0 ? r : 0;
        const int b = xe < h ? np - r : np;
        const int len = b - a, run = (len + nchunks - 1) / nchunks;
        __syncthreads();
        for (int task = t; task < h * nchunks; task += kSkipThreads) {
            const int y = task % h, j = task / h;
            const int p0 = a + j * run, p1 = min(b, p0 + run);
            if (p0 >= p1) continue;
            uint32_t prev[W], cur[W], next[W], v[W];
            if (p0 > 0) {
                yz(A, p0 - 1, y, prev);
            } else {
#pragma unroll
                for (int i = 0; i < W; ++i) prev[i] = 0u;
            }
            yz(A, p0, y, cur);
            for (int p = p0; p < p1; ++p) {
                if (p + 1 < np) {
                    yz(A, p + 1, y, next);
                } else {
#pragma unroll
                    for (int i = 0; i < W; ++i) next[i] = 0u;
                }
#pragma unroll
                for (int i = 0; i < W; ++i) {
                    v[i] = prev[i] | cur[i] | next[i];
                    prev[i] = cur[i];
                    cur[i] = next[i];
                }
                store_line<W>(B + (p * h + y) * W, v);
                if (p >= c0 && p < c0 + sc) count(p, y, v);
            }
        }
        uint32_t* swap = A;
        A = B;
        B = swap;
    }
    __syncthreads();

    // A central line's distances, 16 cells (bytes) a store.
    for (int L = t; L < sc * h; L += kSkipThreads) {
        const int p = c0 + L / h, y = L % h;
        uint32_t k[4][W];
#pragma unroll
        for (int j = 0; j < 4; ++j) load_line<W>(cnt + (j * cl + L) * W, k[j]);
        unsigned char* dst = out + base + static_cast<size_t>(p) * h2 + static_cast<size_t>(y) * h;
#pragma unroll
        for (int i = 0; i < W; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                if (32 * i + 16 * half >= h) continue;
                uint32_t q[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    const int sh = 16 * half + 4 * m;
                    q[m] = spread(k[0][i] >> sh & 0xFu) | spread(k[1][i] >> sh & 0xFu) << 1 |
                           spread(k[2][i] >> sh & 0xFu) << 2 | spread(k[3][i] >> sh & 0xFu) << 3;
                }
                *reinterpret_cast<uint4*>(dst + 32 * i + 16 * half) =
                    make_uint4(q[0], q[1], q[2], q[3]);
            }
        }
    }
}

template <int W>
int launch_skipdist(const unsigned char* bits, int h, int cascades, int dmax,
                    unsigned char* out, cudaStream_t stream) {
    const int pmax = min(h, kSkipSlab + 2 * (dmax - 1));
    const int smem = (2 * pmax + 4 * kSkipSlab) * h * W * static_cast<int>(sizeof(uint32_t));
    static int smem_set = 0;  // the largest dynamic shared memory allowed so far
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            skipdist_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = smem;
    }
    const int nslab = (h + kSkipSlab - 1) / kSkipSlab;
    skipdist_kernel<W><<<cascades * nslab, kSkipThreads, smem, stream>>>(bits, h, dmax, pmax, out);
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
// h a multiple of 16 and at most kSkipMaxGrid, 1 <= dmax <= 15.
NST_API int nst_occupancy_skipdist(const void* bitfield, int grid_size, long long n, int dmax,
                                   void* out, void* stream) {
    const int h = grid_size;
    const long long h3 = static_cast<long long>(h) * h * h;
    if (h <= 0 || h % 16 || h > kSkipMaxGrid || dmax < 1 || dmax > 15 || n % h3)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const auto* in = static_cast<const unsigned char*>(bitfield);
    auto* o = static_cast<unsigned char*>(out);
    const int cascades = static_cast<int>(n / h3);
    const auto s = static_cast<cudaStream_t>(stream);
    switch ((h + 31) / 32) {
        case 1: return launch_skipdist<1>(in, h, cascades, dmax, o, s);
        case 2: return launch_skipdist<2>(in, h, cascades, dmax, o, s);
        case 3: return launch_skipdist<3>(in, h, cascades, dmax, o, s);
        default: return launch_skipdist<4>(in, h, cascades, dmax, o, s);
    }
}

// K6c general, one axis pass: in [n] u8 (the bitfield when from_bits), out
// [n] u8; any grid size.
NST_API int nst_occupancy_skipdist_pass(const void* in, int from_bits, int grid_size,
                                        long long n, long long stride, int dmax, void* out,
                                        void* stream) {
    if (grid_size <= 0 || dmax < 1 || dmax > 255) return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0) return 0;
    skipdist_pass_kernel<<<nst::blocks_for(n), nst::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(in), from_bits != 0, grid_size, n, stride, dmax,
        static_cast<unsigned char*>(out));
    return nst::launch_status();
}
