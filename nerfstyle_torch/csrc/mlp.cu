// K5: the fused bias-free ReLU MLP, forward and backward.
//
// Replaces nerfstyle_tpu/ops/mlp.py:mlp_apply (a jnp.dot chain that XLA
// fuses; the reference runs tiny-cuda-nn's FullyFusedMLP).  The function,
// for weights W_0 [IN, 64], W_1..W_{L-1} [64, 64] and W_L [64, OUT]:
//     h_0 = r(x),  h_{l+1} = r(relu(h_l r(W_l)))  (l < L),
//     y = h_L r(W_L) in fp32,  out = y or sigmoid(y),
// where r() rounds to bf16 under mixed precision (bf16 = 1) and is the
// identity in fp32.  Products of two bf16 values are exact in fp32, and every
// sum accumulates in fp32, so this is JAX's dot with preferred_element_type
// f32 up to the order of the fp32 sums.
//
// The backward rounds where JAX's autodiff rounds (the cotangent reaching a
// bf16 value is rounded to bf16): with d y = g (times s (1 - s) after a
// sigmoid),
//     d a_l = r(d h_l) * [h_l > 0],   d h_l = d a_{l+1} r(W_l)^T,
//     d x = r(d a_0 r(W_0)^T),        d W_l = h_l^T d a_{l+1}  (summed over rows),
// and d W is rounded to bf16 by the caller after the sum over all rows.  The
// ReLU mask is read from the stored (rounded) activation: under bf16 it
// differs from the pre-activation's sign only below 2^-133.
//
// In fp32 (bf16 = 0), forward and backward: one CTA of kRows threads
// takes kRows rows, one row a thread.  All layer weights are staged in
// shared memory (the backward also stages their transposes), so every
// thread reads the same weights at the same time (a broadcast, 16 bytes a
// load).  Each thread keeps the 64 accumulators of the
// layer it computes in registers and walks the layer's input, which lives
// in its own row of a shared-memory tile (rows padded to an odd stride, so a
// warp's 32 rows fall in 32 banks); the hidden activations of every layer
// stay in those tiles, where the backward reads them again.  Inputs and
// outputs go through shared memory so that device-memory reads and writes
// coalesce.  The backward recomputes the forward (nothing is saved between
// the passes) and, when a weight gradient is asked for, forms the tile's
// A^T G from the shared tiles and adds it to the [d_in, d_out] gradient with
// one fp32 atomicAdd an element a CTA; the order of those adds varies from
// run to run.
//
// The backward under bf16 (bf16 = 1, the mixed-precision default) runs on
// the tensor cores (warp-level mma.sync through nvcuda::wmma, bf16 16x16x16
// tiles, fp32 accumulators).  Every product of its hidden and input layers
// is a product of two bf16 values summed in fp32, which is what the tensor
// cores compute: x, W_l and h_l are bf16 by the rounding points above, and
// d a_l = r(d h_l) [h_l > 0] is rounded too.  So
//     h_{l+1} = r(relu(h_l W_l)),  d h_l = d a_{l+1} W_l^T,
//     d x = r(d a_0 W_0^T),        d W_l = h_l^T d a_{l+1}
// change only in the order of their fp32 sums.  The output layer stays on
// fp32 FMAs: its cotangent g (times s (1 - s) after a sigmoid) is an fp32
// value, so neither d h_L = g W_L^T nor d W_L = h_L^T g is a bf16 product
// (its width is at most 64 x out a row); it runs as independent FMA chains
// (32 outputs a thread for d a_L, four partial sums a weight for d W_L).
// A persistent grid of (CTAs an SM) x (SMs) CTAs walks 64-row tiles, four
// warps of 16 rows each; the next tile's x and g are copied in with
// cp.async while a tile computes.  Weights and the tile's activations live
// in shared memory as bf16 (exact there), with row strides of 72 (a
// multiple of 8, not of 64) against bank conflicts; W^T and h^T are read as
// col_major fragments of the same row-major tiles, so no transposed copy is
// staged.  An accumulator passes through a per-warp fp32 tile, where the
// ReLU mask meets the stored activation at the same position.  Each CTA
// keeps its d W partial sums on chip across its tiles (the hidden layers'
// in mma accumulators, the output layer's in shared memory), writes them to
// a [grid, n_weights] scratch at the end, and a second kernel sums the
// partials in CTA order: d W is bit-reproducible from run to run on one
// machine (no float atomics).  Shared memory a CTA: 64,512 bytes at IN
// 32, one hidden layer, out 16 (color1; 3 CTAs or 12 warps an SM); 65,920
// bytes for color2 (IN 16, two hidden layers, out 3; ~250 registers, 2 CTAs
// or 8 warps); 113,664 bytes at the largest shape (IN 32, two hidden
// layers, out 64: 2 CTAs).
//
// The ReLU masks of both tensor-core kernels are the plain chain's, so
// that d x follows the same units: the first of two hidden layers is summed
// on fp32 FMAs in the plain chain's order, and the last hidden layer's
// pre-activations that lie so near 0 that their sign could follow the order
// of the sums are summed again in that order (see warp_dense_relu).
//
// The forward under bf16 runs on the tensor cores too, with the backward's
// tiles and hidden-layer passes, so the forward and the backward's
// recompute round the same h_l: x is rounded to bf16 on its way into the
// tile, the last hidden layer is a bf16 mma with fp32 accumulators whose
// ReLU and rounding are applied as the accumulator goes back to the bf16
// tile (the first of two is summed on fp32 FMAs, as above), and the output
// layer y = h_L r(W_L) is a bf16 mma too (h_L and r(W_L) are bf16, y their
// fp32 sum), with W_L zero-padded to a multiple of 16 columns and the
// sigmoid applied in fp32 on the accumulator tile.  A persistent grid of
// (CTAs an SM) x (SMs) stages and rounds the weights once a CTA, then walks
// 64-row tiles, a warp its 16 rows with no CTA barrier in the loop: a warp
// copies in its rows of the CTA's next tile (cp.async, 16 bytes a copy)
// while it computes the current one.  Shared memory a CTA: 54,016 bytes at
// IN 32 with one hidden layer (class, color1, density: 4 CTAs or 16 warps
// an SM); 54,784 for color2 (IN 16, two hidden layers: 4 CTAs); 63,232 at
// IN 32 with two hidden layers (3 CTAs).  mlp.cu builds in 17-23 s with
// nvcc 12.8.
//
// Bound on the H100: bytes.  A row reads IN and writes OUT fp32 values for
// 2 (IN*64 + 64*64*(L-1) + 64*OUT) operations: ~6 k operations for ~200
// bytes, far below the ~295 operations a byte where the bf16 tensor cores
// would bind.  The fp32 kernels run at the fp32 FMA rate at best, with one
// CTA of 4 warps an SM where their shared tiles are largest.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kHid = 64;
constexpr int kRows = 128;
constexpr int kMaxOut = 64;
constexpr int kStride = kHid + 1;  // odd row stride of the 64-wide tiles
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

// v rounded to bf16, returned in fp32.
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__host__ __device__ constexpr int odd_stride(int n) { return (n & 1) ? n : n + 1; }

__host__ __device__ inline int num_weights(int in_dim, int n_hidden, int out_dim) {
    return in_dim * kHid + (n_hidden - 1) * kHid * kHid + kHid * out_dim;
}

// Offset of layer l's matrix in the packed weights.
__device__ __forceinline__ int layer_offset(int in_dim, int l) {
    return l == 0 ? 0 : in_dim * kHid + (l - 1) * kHid * kHid;
}

// acc[n] = sum_{k < d} src[k] * m[k * N + n] for n < N, in order of k.  src
// is a thread's row in shared memory; m is row-major [d, N] in shared memory
// (16-byte aligned), read as broadcast float4s.
template <int N>
__device__ __forceinline__ void dense(const float* src, int d, const float* m, float (&acc)[N]) {
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
        const float a = src[k];
        const float4* m4 = reinterpret_cast<const float4*>(m + k * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const float4 w = m4[q];
            acc[4 * q] = fmaf(a, w.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
        }
    }
}

// dst[j] = relu(sum_k src[k] W[k][j]) for j < 64 (ReLU lets NaN pass, as
// torch.relu does).
__device__ __forceinline__ void dense_relu(const float* src, int d, const float* wl, float* dst) {
    float acc[kHid];
    dense<kHid>(src, d, wl, acc);
#pragma unroll
    for (int j = 0; j < kHid; ++j) dst[j] = acc[j] < 0.f ? 0.f : acc[j];
}

// The output layer's pre-activation y_o = sum_k h[k] W_L[k][o] (h in
// registers, W_L [64, out] in shared memory).
__device__ __forceinline__ float output_unit(const float (&h)[kHid], const float* wl, int out_dim,
                                             int o) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) acc = fmaf(h[k], wl[k * out_dim + o], acc);
    return acc;
}

// Stage the weights (with their transposes when wt is not null) and the
// tile's input rows (zero rows past the end of the batch).
template <int IN, int NHID>
__device__ __forceinline__ void stage(const float* __restrict__ x, const float* __restrict__ w,
                                      int out_dim, long long row0, int rows, float* ws, float* wt,
                                      float* xs) {
    const int nw = num_weights(IN, NHID, out_dim);
    for (int i = threadIdx.x; i < nw; i += kRows) ws[i] = w[i];
    if (wt != nullptr) {
#pragma unroll 1
        for (int l = 0; l <= NHID; ++l) {
            const int d_in = l == 0 ? IN : kHid;
            const int d_out = l == NHID ? out_dim : kHid;
            const int off = layer_offset(IN, l);
            for (int e = threadIdx.x; e < d_in * d_out; e += kRows) {
                const int i = e / d_out;
                const int o = e - i * d_out;
                wt[off + o * d_in + i] = w[off + e];
            }
        }
    }
    for (int e = threadIdx.x; e < kRows * IN; e += kRows) {
        const int r = e / IN;
        xs[r * (IN + 1) + (e - r * IN)] = r < rows ? x[row0 * IN + e] : 0.f;
    }
}

// Hidden layers of one row: h_0 from the row of xs into hs[0], h_l from
// hs[l-1] into hs[l].
template <int IN, int NHID>
__device__ __forceinline__ void hidden_layers(const float* xs, const float* ws, float* hs) {
    const int t = threadIdx.x;
    dense_relu(xs + t * (IN + 1), IN, ws, hs + t * kStride);
#pragma unroll 1
    for (int l = 1; l < NHID; ++l) {
        dense_relu(hs + ((l - 1) * kRows + t) * kStride, kHid, ws + layer_offset(IN, l),
                   hs + (l * kRows + t) * kStride);
    }
}

template <int IN, int NHID>
__global__ void __launch_bounds__(kRows)
    mlp_forward_kernel(const float* __restrict__ x, const float* __restrict__ w, long long m,
                       int out_dim, int sigmoid, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* ws = reinterpret_cast<float*>(smem4);
    float* xs = ws + num_weights(IN, NHID, out_dim);  // [kRows][IN + 1]
    float* hs = xs + kRows * (IN + 1);                 // [NHID][kRows][kStride]
    float* os = hs + NHID * kRows * kStride;           // [kRows][ostride]
    const int ostride = odd_stride(out_dim);
    const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kRows), m - row0));
    const int t = threadIdx.x;
    stage<IN, NHID>(x, w, out_dim, row0, rows, ws, nullptr, xs);
    __syncthreads();

    hidden_layers<IN, NHID>(xs, ws, hs);
    float h[kHid];
    const float* hl = hs + ((NHID - 1) * kRows + t) * kStride;
#pragma unroll
    for (int k = 0; k < kHid; ++k) h[k] = hl[k];
    const float* wl = ws + layer_offset(IN, NHID);
#pragma unroll 1
    for (int o = 0; o < out_dim; ++o) {
        float y = output_unit(h, wl, out_dim, o);
        if (sigmoid) y = 1.f / (1.f + expf(-y));
        os[t * ostride + o] = y;
    }
    __syncthreads();
    for (int e = t; e < rows * out_dim; e += kRows) {
        const int r = e / out_dim;
        out[row0 * out_dim + e] = os[r * ostride + (e - r * out_dim)];
    }
}

// dW[i][o] += sum over the tile's rows of a[r][i] * g[r][o] (one atomicAdd an
// element).  Rows past the end of the batch hold zeros in a and g.
__device__ __forceinline__ void add_tile_grad(const float* a, int astride, int n_in,
                                              const float* g, int n_out,
                                              float* __restrict__ dw) {
    for (int e = threadIdx.x; e < n_in * n_out; e += kRows) {
        const int i = e / n_out;
        const int o = e - i * n_out;
        float acc = 0.f;
#pragma unroll 4
        for (int r = 0; r < kRows; ++r) acc = fmaf(a[r * astride + i], g[r * kStride + o], acc);
        atomicAdd(dw + e, acc);
    }
}

template <int IN, int NHID>
__global__ void __launch_bounds__(kRows)
    mlp_backward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ g_out, long long m, int out_dim, int sigmoid,
                        unsigned int dw_mask, float* __restrict__ dx, float* __restrict__ dw) {
    extern __shared__ float4 smem4[];
    const int nw = num_weights(IN, NHID, out_dim);
    float* ws = reinterpret_cast<float*>(smem4);
    float* wt = ws + nw;                // transposed layers, same offsets
    float* xs = wt + nw;                // [kRows][IN + 1]
    float* gs = xs + kRows * (IN + 1);  // [kRows][kStride]: the cotangent rows
    float* hs = gs + kRows * kStride;   // [NHID][kRows][kStride]
    const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kRows), m - row0));
    const int t = threadIdx.x;
    stage<IN, NHID>(x, w, out_dim, row0, rows, ws, wt, xs);
    for (int e = t; e < kRows * out_dim; e += kRows) {
        const int r = e / out_dim;
        gs[r * kStride + (e - r * out_dim)] = r < rows ? g_out[row0 * out_dim + e] : 0.f;
    }
    __syncthreads();

    hidden_layers<IN, NHID>(xs, ws, hs);
    float* grow = gs + t * kStride;
    const float* hl = hs + ((NHID - 1) * kRows + t) * kStride;
    if (sigmoid) {
        float h[kHid];
#pragma unroll
        for (int k = 0; k < kHid; ++k) h[k] = hl[k];
        const float* wl = ws + layer_offset(IN, NHID);
#pragma unroll 1
        for (int o = 0; o < out_dim; ++o) {
            const float s = 1.f / (1.f + expf(-output_unit(h, wl, out_dim, o)));
            grow[o] = grow[o] * (s * (1.f - s));
        }
    }
    if ((dw_mask >> NHID) & 1u) {
        __syncthreads();
        add_tile_grad(hs + (NHID - 1) * kRows * kStride, kStride, kHid, gs, out_dim,
                      dw + layer_offset(IN, NHID));
    }
    // d a of the last hidden layer: d y W_L^T under its ReLU mask.
    {
        float acc[kHid];
        dense<kHid>(grow, out_dim, wt + layer_offset(IN, NHID), acc);
        __syncthreads();  // every tile gradient has read gs
#pragma unroll
        for (int j = 0; j < kHid; ++j) grow[j] = hl[j] > 0.f ? acc[j] : 0.f;
    }
    // Hidden layers back to front: layer l maps its input (x for l = 0, else
    // h_{l-1}) through W_l; grow holds the cotangent of its output.
#pragma unroll 1
    for (int l = NHID - 1; l >= 0; --l) {
        if ((dw_mask >> l) & 1u) {
            __syncthreads();
            if (l == 0) {
                add_tile_grad(xs, IN + 1, IN, gs, kHid, dw);
            } else {
                add_tile_grad(hs + (l - 1) * kRows * kStride, kStride, kHid, gs, kHid,
                              dw + layer_offset(IN, l));
            }
            __syncthreads();
        }
        if (l > 0) {
            float acc[kHid];
            dense<kHid>(grow, kHid, wt + layer_offset(IN, l), acc);
            const float* hp = hs + ((l - 1) * kRows + t) * kStride;
#pragma unroll
            for (int i = 0; i < kHid; ++i) grow[i] = hp[i] > 0.f ? acc[i] : 0.f;
        } else {
            float acc[IN];
            dense<IN>(grow, kHid, wt, acc);
#pragma unroll
            for (int k = 0; k < IN; ++k) xs[t * (IN + 1) + k] = acc[k];
        }
    }
    __syncthreads();
    for (int e = t; e < rows * IN; e += kRows) {
        const int r = e / IN;
        dx[row0 * IN + e] = xs[r * (IN + 1) + (e - r * IN)];
    }
}

// ---------------------------------------------------------------------------
// Backward under bf16, on the tensor cores
// ---------------------------------------------------------------------------

namespace wmma = nvcuda::wmma;
typedef __nv_bfloat16 bf16_t;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

constexpr int kTcRows = 64;       // rows a tile
constexpr int kTcThreads = 128;   // 4 warps of 16 rows
constexpr int kHs = kHid + 8;     // bf16 row stride of the 64-wide tiles
constexpr int kSs = kHid + 4;     // fp32 row stride of the accumulator tile

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// Byte offsets of the shared regions (each 128-byte aligned).
struct TcSmem {
    size_t w0, w1, wlt, xs, hs, da, st, gs, dwl, xf, cs, total;
};

__host__ __device__ inline TcSmem tc_smem(int in_dim, int n_hidden, int out_dim) {
    TcSmem s;
    size_t o = 0;
    s.w0 = o;  o += align128(sizeof(bf16_t) * in_dim * kHs);             // r(W_0) [IN][kHs]
    s.w1 = o;  o += align128(sizeof(bf16_t) * (n_hidden - 1) * kHid * kHs);  // r(W_1) [64][kHs]
    s.wlt = o; o += align128(sizeof(bf16_t) * out_dim * kHid);         // r(W_L)^T [out][64]
    s.xs = o;  o += align128(sizeof(bf16_t) * kTcRows * (in_dim + 8));   // r(x) [rows][IN + 8]
    s.hs = o;  o += align128(sizeof(bf16_t) * n_hidden * kTcRows * kHs); // h_l [L][rows][kHs]
    s.da = o;  o += align128(sizeof(bf16_t) * kTcRows * kHs);            // d a [rows][kHs]
    s.st = o;  o += align128(sizeof(float) * kTcRows * kSs);           // accumulators [rows][kSs]
    s.gs = o;  o += align128(sizeof(float) * kTcRows * odd_stride(out_dim));  // g [rows][odd]
    s.dwl = o; o += align128(sizeof(float) * kHid * out_dim);          // d W_L partial [64][out]
    s.xf = o;  o += align128(sizeof(float) * kTcRows * in_dim);        // next x [rows][IN]
    s.cs = o;  o += align128(sizeof(float) * kHid);                      // |r(W_L-1)| column sums
    s.total = o;
    return s;
}

__device__ __forceinline__ float bf(bf16_t v) { return __bfloat162float(v); }

// A 4-byte asynchronous copy into shared memory (cp.async), and the wait for
// every copy this thread has started.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of `rows` rows of src [*, width] from row0 into dst (row
// stride ld), zeros for the rest of a tile's rows.
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ src, long long row0,
                                              int rows, int width, float* dst, int ld) {
    for (int e = threadIdx.x; e < kTcRows * width; e += kTcThreads) {
        const int r = e / width;
        float* d = dst + r * ld + (e - r * width);
        if (r < rows) {
            cp_async4(d, src + row0 * width + e);
        } else {
            *d = 0.f;
        }
    }
}

// st[16][kSs] = a[16][KS*16] . B[KS*16][NS*16] for one warp: a row-major
// bf16 (stride lda); B = m (row-major [K][kHs]) or, with TRANS, m^T for a
// row-major m [NS*16][kHs] (read as a col_major fragment).
template <int KS, int NS, bool TRANS>
__device__ __forceinline__ void warp_mm(const bf16_t* a, int lda, const bf16_t* m, float* st) {
    AccFrag acc[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + k * 16, lda);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            if (TRANS) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::col_major> fb;
                wmma::load_matrix_sync(fb, m + n * 16 * kHs + k * 16, kHs);
                wmma::mma_sync(acc[n], fa, fb, acc[n]);
            } else {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::row_major> fb;
                wmma::load_matrix_sync(fb, m + k * 16 * kHs + n * 16, kHs);
                wmma::mma_sync(acc[n], fa, fb, acc[n]);
            }
        }
    }
    __syncwarp();  // every lane is done reading st
#pragma unroll
    for (int n = 0; n < NS; ++n) wmma::store_matrix_sync(st + n * 16, acc[n], kSs, wmma::mem_row_major);
    __syncwarp();
}

// Four fp32 values rounded to bf16 and stored at dst (8-byte aligned).
__device__ __forceinline__ void store_bf16x4(bf16_t* dst, float a, float b, float c, float d) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(dst);
    p[0] = __floats2bfloat162_rn(a, b);
    p[1] = __floats2bfloat162_rn(c, d);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// Column sums cs[j] = sum_k |r(W)[k][j]| of the last hidden layer's staged
// weights m [d][kHs] (the bound of warp_dense_relu's sign test); a CTA
// barrier must follow.
__device__ __forceinline__ void stage_colsums(const bf16_t* m, int d, float* cs) {
    for (int j = threadIdx.x; j < kHid; j += kTcThreads) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s += fabsf(bf(m[k * kHs + j]));
        cs[j] = s;
    }
}

// A cotangent flows through a hidden unit or not, so a unit whose ReLU mask
// differs from the plain chain's moves its row's d x by a whole term.  The
// plain chain's fp32 GEMM (cuBLAS, at a few thousand rows or more) sums one
// FMA at a time in order of k; the tensor cores sum in another order, and
// where the exact pre-activation lies within the rounding of either sum of
// 0 (an exact 2^-26 from terms of ~1 is such a case) or of a bf16 rounding
// step, the two give another mask or another bf16 activation.  So the
// masks are made the plain chain's: the first of two hidden layers (whose
// bf16 output feeds the last layer's masks) is summed on fp32 FMAs in the
// plain order (warp_dense_relu_sequential), and the last hidden layer on
// the tensor cores with a sign test (warp_dense_relu).

// One warp's 16 rows of a hidden layer on fp32 FMAs, one at a time in order
// of k: dst = r(relu(a W)), bit for bit the plain chain's.  Lane l takes
// columns 4 (l & 15) .. + 3 of rows 8 (l >> 4) .. + 7: a's rows are read 8
// values a broadcast load, W's 4 a load.  dst must not alias a.
template <int K>
__device__ __forceinline__ void warp_dense_relu_sequential(const bf16_t* a, int lda,
                                                           const bf16_t* wm, bf16_t* dst) {
    const int lane = threadIdx.x & 31, c = 4 * (lane & 15), r0 = 8 * (lane >> 4);
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    }
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 8) {
        float w[8][4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const uint2 p = *reinterpret_cast<const uint2*>(wm + (k0 + u) * kHs + c);
            const bf16_t* b = reinterpret_cast<const bf16_t*>(&p);
#pragma unroll
            for (int q = 0; q < 4; ++q) w[u][q] = bf(b[q]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const uint4 v = *reinterpret_cast<const uint4*>(a + (r0 + r) * lda + k0);
            const bf16_t* b = reinterpret_cast<const bf16_t*>(&v);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const float x = bf(b[u]);
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(x, w[u][q], acc[r][q]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        store_bf16x4(dst + (r0 + r) * kHs + c, relu(acc[r][0]), relu(acc[r][1]), relu(acc[r][2]),
                     relu(acc[r][3]));
    }
    __syncwarp();
}

// One warp's 16 rows of the last hidden layer on the tensor cores: dst =
// r(relu(a W)) (ReLU lets NaN pass, as torch.relu does), with the plain
// chain's ReLU mask; cs holds W's column sums of |r(W)|.  With S = sum_k
// |a_k w_kj| <= max_k |a_k| cs_j, the sequential sum lies within (K - 1)
// 2^-24 S of the exact value and the tensor cores' (whose adds truncate)
// within a small multiple of that, so K 2^-22 S bounds their distance: a
// pre-activation with |v| below K 2^-22 max|a| cs_j is summed again in the
// plain order, and any other has the sign of both.  Such values are rare,
// so the warp seldom takes that branch.  The accumulator tile is read 16
// bytes a lane, unrolled, so the warp's loads are in flight together; lane
// l holds columns 4 (l & 15) .. + 3 of rows 2i + (l >> 4).  dst may be a.
template <int KS>
__device__ __forceinline__ void warp_dense_relu(const bf16_t* a, int lda, const bf16_t* wm,
                                                const float* cs, float* st, bf16_t* dst) {
    constexpr int K = 16 * KS;
    constexpr float kTau = K * 0x1p-22f;
    warp_mm<KS, 4, false>(a, lda, wm, st);
    const int lane = threadIdx.x & 31, j = 4 * (lane & 15);
    // max_k |a[r][k]|: lane l takes row l & 15 and half l >> 4 of its columns.
    float amax = 0.f;
    {
        const uint4* p =
            reinterpret_cast<const uint4*>(a + (lane & 15) * lda + (lane >> 4) * (K / 2));
#pragma unroll
        for (int q = 0; q < K / 16; ++q) {
            const uint4 v = p[q];
            const bf16_t* b = reinterpret_cast<const bf16_t*>(&v);
#pragma unroll
            for (int u = 0; u < 8; ++u) amax = fmaxf(amax, fabsf(bf(b[u])));
        }
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 16));
    }
    const float4 c = *reinterpret_cast<const float4*>(cs + j);
    unsigned flags = 0u;
#pragma unroll
    for (int i = 0; i < 16 * kHid / 128; ++i) {
        const float bound = kTau * __shfl_sync(0xffffffffu, amax, 2 * i + (lane >> 4));
        const float4 v = *reinterpret_cast<const float4*>(st + (2 * i + (lane >> 4)) * kSs + j);
        flags |= (static_cast<unsigned>(fabsf(v.x) < bound * c.x) |
                  static_cast<unsigned>(fabsf(v.y) < bound * c.y) << 1 |
                  static_cast<unsigned>(fabsf(v.z) < bound * c.z) << 2 |
                  static_cast<unsigned>(fabsf(v.w) < bound * c.w) << 3) << (4 * i);
    }
    if (__any_sync(0xffffffffu, flags != 0u)) {
        while (flags != 0u) {
            const int b = __ffs(flags) - 1;
            flags &= flags - 1u;
            const int r = 2 * (b >> 2) + (lane >> 4), col = j + (b & 3);
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) acc = fmaf(bf(a[r * lda + k]), bf(wm[k * kHs + col]), acc);
            st[r * kSs + col] = acc;
        }
        __syncwarp();  // every lane is done reading a
    }
#pragma unroll
    for (int i = 0; i < 16 * kHid / 128; ++i) {
        const int r = 2 * i + (lane >> 4);
        const float4 v = *reinterpret_cast<const float4*>(st + r * kSs + j);
        store_bf16x4(dst + r * kHs + j, relu(v.x), relu(v.y), relu(v.z), relu(v.w));
    }
    __syncwarp();
}

// d W[i][j] += sum over the tile's rows of in[r][i] da[r][j]: a warp owns
// the column block j of d W (16 wide) and its NB row blocks.  in^T is read
// as a col_major fragment of the row-major input tile.
template <int NB>
__device__ __forceinline__ void warp_weight_grad(const bf16_t* in, int ld, const bf16_t* da,
                                                 AccFrag (&dw)[NB]) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kTcRows / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, da + k * 16 * kHs + warp * 16, kHs);
#pragma unroll
        for (int q = 0; q < NB; ++q) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::col_major> fa;
            wmma::load_matrix_sync(fa, in + k * 16 * ld + q * 16, ld);
            wmma::mma_sync(dw[q], fa, fb, dw[q]);
        }
    }
}

template <int NB>
__device__ __forceinline__ void store_weight_grad(float* dst, AccFrag (&dw)[NB]) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
        wmma::store_matrix_sync(dst + q * 16 * kHid + warp * 16, dw[q], kHid, wmma::mem_row_major);
    }
}

// At most 168 registers a thread with one hidden layer (3 CTAs an SM), 255
// with two (2 CTAs: the second layer's d W fragments stay in registers).
template <int IN, int NHID>
__global__ void __launch_bounds__(kTcThreads, NHID == 1 ? 3 : 2)
    mlp_backward_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ g_out, long long m, int out_dim,
                           int sigmoid, unsigned int dw_mask, float* __restrict__ dx,
                           float* __restrict__ partials) {
    extern __shared__ __align__(128) unsigned char tc_raw[];
    constexpr int XS = IN + 8;
    constexpr int NB1 = NHID == 2 ? 4 : 1;
    const TcSmem lay = tc_smem(IN, NHID, out_dim);
    bf16_t* w0s = reinterpret_cast<bf16_t*>(tc_raw + lay.w0);
    bf16_t* w1s = reinterpret_cast<bf16_t*>(tc_raw + lay.w1);
    bf16_t* wlt = reinterpret_cast<bf16_t*>(tc_raw + lay.wlt);
    bf16_t* xs = reinterpret_cast<bf16_t*>(tc_raw + lay.xs);
    bf16_t* hs = reinterpret_cast<bf16_t*>(tc_raw + lay.hs);
    bf16_t* das = reinterpret_cast<bf16_t*>(tc_raw + lay.da);
    float* st = reinterpret_cast<float*>(tc_raw + lay.st);
    float* gs = reinterpret_cast<float*>(tc_raw + lay.gs);
    float* dwl = reinterpret_cast<float*>(tc_raw + lay.dwl);
    float* xf = reinterpret_cast<float*>(tc_raw + lay.xf);
    float* cs = reinterpret_cast<float*>(tc_raw + lay.cs);
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int ostride = odd_stride(out_dim);
    const bool dw_out = (dw_mask >> NHID) & 1u;
    const bf16_t zero = __float2bfloat16_rn(0.f);

    for (int e = t; e < IN * kHid; e += kTcThreads) {
        w0s[(e >> 6) * kHs + (e & 63)] = __float2bfloat16_rn(w[e]);
    }
    if (NHID == 2) {
        for (int e = t; e < kHid * kHid; e += kTcThreads) {
            w1s[(e >> 6) * kHs + (e & 63)] = __float2bfloat16_rn(w[IN * kHid + e]);
        }
    }
    const float* wl = w + layer_offset(IN, NHID);
    for (int e = t; e < kHid * out_dim; e += kTcThreads) {
        const int k = e / out_dim;
        wlt[(e - k * out_dim) * kHid + k] = __float2bfloat16_rn(wl[e]);
        if (dw_out) dwl[e] = 0.f;
    }
    AccFrag dw0[IN / 16], dw1[NB1];
#pragma unroll
    for (int q = 0; q < IN / 16; ++q) wmma::fill_fragment(dw0[q], 0.f);
#pragma unroll
    for (int q = 0; q < NB1; ++q) wmma::fill_fragment(dw1[q], 0.f);
    __syncthreads();
    stage_colsums(NHID == 1 ? w0s : w1s, NHID == 1 ? IN : kHid, cs);
    __syncthreads();

    const bf16_t* hl = hs + (NHID - 1) * kTcRows * kHs;  // the last hidden layer
    const long long tiles = (m + kTcRows - 1) / kTcRows;
    auto tile_rows = [&](long long tile) {
        return static_cast<int>(min(static_cast<long long>(kTcRows), m - tile * kTcRows));
    };
    // A tile's x and g are copied in while the tile before it computes: x
    // (fp32) into xf as soon as the tile before has converted its own, g
    // into gs once the tile before is done with it (after its output layer).
    // The grid has at most one CTA a tile: blockIdx.x is a tile.
    prefetch_rows(x, blockIdx.x * static_cast<long long>(kTcRows), tile_rows(blockIdx.x), IN, xf,
                  IN);
    prefetch_rows(g_out, blockIdx.x * static_cast<long long>(kTcRows), tile_rows(blockIdx.x),
                  out_dim, gs, ostride);
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long row0 = tile * kTcRows;
        const int rows = tile_rows(tile);
        const long long next = tile + gridDim.x;
        cp_async_wait_all();
        __syncthreads();  // this tile's x and g have landed; the tile before is done
        for (int e = t; e < kTcRows * IN; e += kTcThreads) {
            const int r = e / IN;
            xs[r * XS + (e - r * IN)] = __float2bfloat16_rn(xf[e]);
        }
        __syncthreads();
        if (next < tiles) prefetch_rows(x, next * kTcRows, tile_rows(next), IN, xf, IN);

        // Forward recompute, each warp its 16 rows.
        float* stw = st + warp * 16 * kSs;
        if (NHID == 1) {
            warp_dense_relu<IN / 16>(xs + warp * 16 * XS, XS, w0s, cs, stw, hs + warp * 16 * kHs);
        } else {
            warp_dense_relu_sequential<IN>(xs + warp * 16 * XS, XS, w0s, hs + warp * 16 * kHs);
            warp_dense_relu<4>(hs + warp * 16 * kHs, kHs, w1s, cs, stw,
                               hs + (kTcRows + warp * 16) * kHs);
        }
        __syncthreads();

        // The output layer on fp32 FMAs: g times s (1 - s) after a sigmoid,
        // d W_L += h_L^T g, d a_L = r(g W_L^T) [h_L > 0].
        if (sigmoid) {
            for (int e = t; e < kTcRows * out_dim; e += kTcThreads) {
                const int r = e / out_dim, o = e - r * out_dim;
                float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int k = 0; k < kHid; k += 4) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc[q] = fmaf(bf(hl[r * kHs + k + q]), bf(wlt[o * kHid + k + q]), acc[q]);
                    }
                }
                const float y = (acc[0] + acc[1]) + (acc[2] + acc[3]);
                const float s = 1.f / (1.f + expf(-y));
                gs[r * ostride + o] *= s * (1.f - s);
            }
            __syncthreads();
        }
        if (dw_out) {
            // Four partial sums a weight (rows r = 4i + q), added in a fixed
            // order: independent FMA chains.
            for (int e = t; e < kHid * out_dim; e += kTcThreads) {
                const int j = e / out_dim, o = e - j * out_dim;
                float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
                for (int r = 0; r < kTcRows; r += 4) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc[q] = fmaf(bf(hl[(r + q) * kHs + j]), gs[(r + q) * ostride + o], acc[q]);
                    }
                }
                dwl[e] += (acc[0] + acc[1]) + (acc[2] + acc[3]);
            }
        }
        {
            // Thread t takes row t / 2 and 32 of its columns: the out loop
            // outside, 32 independent FMA chains inside, W_L^T rows read as
            // broadcast 16-byte loads of 8 bf16 values.
            static_assert(kTcThreads == 2 * kTcRows, "two threads a row");
            const int r = t >> 1, j0 = (t & 1) * 32;
            float acc[32];
#pragma unroll
            for (int q = 0; q < 32; ++q) acc[q] = 0.f;
            for (int o = 0; o < out_dim; ++o) {
                const float gv = gs[r * ostride + o];
                const uint4* w8 = reinterpret_cast<const uint4*>(wlt + o * kHid + j0);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const uint4 v = w8[q];
                    const bf16_t* p = reinterpret_cast<const bf16_t*>(&v);
#pragma unroll
                    for (int u = 0; u < 8; ++u) acc[8 * q + u] = fmaf(gv, bf(p[u]), acc[8 * q + u]);
                }
            }
#pragma unroll
            for (int q = 0; q < 32; ++q) {
                const int i = r * kHs + j0 + q;
                das[i] = bf(hl[i]) > 0.f ? __float2bfloat16_rn(acc[q]) : zero;
            }
        }
        __syncthreads();  // every thread is done with gs
        if (next < tiles) {
            prefetch_rows(g_out, next * kTcRows, tile_rows(next), out_dim, gs, ostride);
        }

        // The hidden layers back to front; das holds the cotangent of layer
        // l's output.
        if (NHID == 2) {
            if ((dw_mask >> 1) & 1u) warp_weight_grad<NB1>(hs, kHs, das, dw1);
            warp_mm<4, 4, true>(das + warp * 16 * kHs, kHs, w1s, stw);
            __syncthreads();  // every warp is done reading das
            for (int e = lane; e < 16 * kHid; e += 32) {
                const int r = warp * 16 + (e >> 6), j = e & 63;
                das[r * kHs + j] = bf(hs[r * kHs + j]) > 0.f
                                       ? __float2bfloat16_rn(stw[(e >> 6) * kSs + j])
                                       : zero;
            }
            __syncthreads();
        }
        if (dw_mask & 1u) warp_weight_grad<IN / 16>(xs, XS, das, dw0);
        warp_mm<4, IN / 16, true>(das + warp * 16 * kHs, kHs, w0s, stw);
        for (int e = lane; e < 16 * IN; e += 32) {
            const int r = e / IN, i = e - r * IN;
            if (warp * 16 + r < rows) dx[(row0 + warp * 16) * IN + e] = rnd(stw[r * kSs + i]);
        }
    }

    if (dw_mask == 0u) return;
    float* part = partials + static_cast<long long>(blockIdx.x) * num_weights(IN, NHID, out_dim);
    if (dw_mask & 1u) store_weight_grad<IN / 16>(part, dw0);
    if (NHID == 2 && ((dw_mask >> 1) & 1u)) store_weight_grad<NB1>(part + IN * kHid, dw1);
    if (dw_out) {
        float* pl = part + layer_offset(IN, NHID);
        for (int e = t; e < kHid * out_dim; e += kTcThreads) pl[e] = dwl[e];
    }
}

// ---------------------------------------------------------------------------
// Forward under bf16, on the tensor cores
// ---------------------------------------------------------------------------

// Byte offsets of the forward's shared regions (each 128-byte aligned).
// They depend on IN and the hidden depth only: W_L is staged zero-padded to
// 64 columns whatever its width.
struct FwdSmem {
    size_t w0, w1, wl, xs, hs, st, xf, cs, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int in_dim, int n_hidden) {
    FwdSmem s;
    size_t o = 0;
    s.w0 = o; o += align128(sizeof(bf16_t) * in_dim * kHs);                 // r(W_0) [IN][kHs]
    s.w1 = o; o += align128(sizeof(bf16_t) * (n_hidden - 1) * kHid * kHs);  // r(W_1) [64][kHs]
    s.wl = o; o += align128(sizeof(bf16_t) * kHid * kHs);                   // r(W_L) [64][kHs]
    s.xs = o; o += align128(sizeof(bf16_t) * kTcRows * (in_dim + 8));       // r(x) [rows][IN + 8]
    s.hs = o; o += align128(sizeof(bf16_t) * kTcRows * kHs);                // h_l [rows][kHs]
    s.st = o; o += align128(sizeof(float) * kTcRows * kSs);                 // accumulators
    s.xf = o; o += align128(sizeof(float) * kTcRows * in_dim);              // next x [rows][IN]
    s.cs = o; o += align128(sizeof(float) * kHid);                          // |r(W_L-1)| column sums
    s.total = o;
    return s;
}

// A 16-byte asynchronous copy into shared memory (cp.async, L2 only).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Start one warp's copy of n contiguous floats (n a multiple of 4; 16-byte
// copies where src is 16-byte aligned).
__device__ __forceinline__ void warp_prefetch(const float* __restrict__ src, int n, float* dst,
                                              bool vec) {
    const int lane = threadIdx.x & 31;
    if (vec) {
        for (int e = 4 * lane; e < n; e += 128) cp_async16(dst + e, src + e);
    } else {
        for (int e = lane; e < n; e += 32) cp_async4(dst + e, src + e);
    }
}

// A persistent grid walks 64-row tiles; warp w of a CTA owns rows 16w..16w+15
// of each tile and works on them alone (no CTA barrier after the weights are
// staged): it converts its x rows to bf16, starts the copy of its rows of the
// CTA's next tile, runs the hidden layers (h_l overwrites h_{l-1} in place:
// warp_mm has read every row into fragments before the ReLU pass writes) and
// the output layer on the tensor cores, and stores its rows' `out` real
// columns from the fp32 accumulator tile, sigmoid applied there: the warp's
// 16 rows of out are contiguous in memory, so the stores coalesce.
template <int IN, int NHID>
__global__ void __launch_bounds__(kTcThreads, 4)
    mlp_forward_tc_kernel(const float* __restrict__ x, const float* __restrict__ w, long long m,
                          int out_dim, int sigmoid, float* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char fw_raw[];
    constexpr int XS = IN + 8;
    const FwdSmem lay = fwd_smem(IN, NHID);
    bf16_t* w0s = reinterpret_cast<bf16_t*>(fw_raw + lay.w0);
    bf16_t* w1s = reinterpret_cast<bf16_t*>(fw_raw + lay.w1);
    bf16_t* wls = reinterpret_cast<bf16_t*>(fw_raw + lay.wl);
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    bf16_t* xw = reinterpret_cast<bf16_t*>(fw_raw + lay.xs) + warp * 16 * XS;
    bf16_t* hw = reinterpret_cast<bf16_t*>(fw_raw + lay.hs) + warp * 16 * kHs;
    float* stw = reinterpret_cast<float*>(fw_raw + lay.st) + warp * 16 * kSs;
    float* xfw = reinterpret_cast<float*>(fw_raw + lay.xf) + warp * 16 * IN;
    float* cs = reinterpret_cast<float*>(fw_raw + lay.cs);

    for (int e = t; e < IN * kHid; e += kTcThreads) {
        w0s[(e >> 6) * kHs + (e & 63)] = __float2bfloat16_rn(w[e]);
    }
    if (NHID == 2) {
        for (int e = t; e < kHid * kHid; e += kTcThreads) {
            w1s[(e >> 6) * kHs + (e & 63)] = __float2bfloat16_rn(w[IN * kHid + e]);
        }
    }
    const float* wl = w + layer_offset(IN, NHID);
    for (int e = t; e < kHid * kHid; e += kTcThreads) {
        const int k = e >> 6, j = e & 63;
        wls[k * kHs + j] = __float2bfloat16_rn(j < out_dim ? wl[k * out_dim + j] : 0.f);
    }
    __syncthreads();
    stage_colsums(NHID == 1 ? w0s : w1s, NHID == 1 ? IN : kHid, cs);
    __syncthreads();

    const int nb = (out_dim + 15) / 16;  // 16-wide column blocks of the output layer
    const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const long long tiles = (m + kTcRows - 1) / kTcRows;
    auto warp_rows = [&](long long tile, long long* r0) {
        *r0 = tile * kTcRows + warp * 16;
        return static_cast<int>(max(0LL, min(16LL, m - *r0)));
    };
    long long r0;
    int rows = warp_rows(blockIdx.x, &r0);
    warp_prefetch(x + r0 * IN, rows * IN, xfw, vec);
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        cp_async_wait_all();
        __syncwarp();  // the warp's rows have landed
#pragma unroll
        for (int i = 0; i < 16 * IN / 128; ++i) {
            const int e = 4 * (lane + 32 * i);
            const int r = e / IN;
            const float4 v = r < rows ? *reinterpret_cast<const float4*>(xfw + e)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
            store_bf16x4(xw + r * XS + (e - r * IN), v.x, v.y, v.z, v.w);
        }
        __syncwarp();  // every lane is done reading xfw
        long long n0;
        const int n_rows = warp_rows(tile + gridDim.x, &n0);
        if (tile + gridDim.x < tiles) warp_prefetch(x + n0 * IN, n_rows * IN, xfw, vec);

        if (NHID == 1) {
            warp_dense_relu<IN / 16>(xw, XS, w0s, cs, stw, hw);
        } else {
            warp_dense_relu_sequential<IN>(xw, XS, w0s, hw);
            warp_dense_relu<4>(hw, kHs, w1s, cs, stw, hw);
        }
        for (int b = 0; b < nb; ++b) warp_mm<4, 1, false>(hw, kHs, wls + b * 16, stw + b * 16);
        float* dst = out + r0 * out_dim;
        for (int e = lane; e < rows * out_dim; e += 32) {
            const int r = e / out_dim;
            float y = stw[r * kSs + (e - r * out_dim)];
            if (sigmoid) y = 1.f / (1.f + expf(-y));
            dst[e] = y;
        }
        r0 = n0;
        rows = n_rows;
    }
}

// dw[e] = sum over b < grid of partials[b][e], in order of b, for the
// elements of the layers in mask.
__global__ void mlp_dw_reduce_kernel(const float* __restrict__ partials, int grid, int nw,
                                     int in_dim, int n_hidden, unsigned int mask,
                                     float* __restrict__ dw) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= nw) return;
    const int first = in_dim * kHid;
    const int l = e < first ? 0 : min(n_hidden, 1 + (e - first) / (kHid * kHid));
    if (!((mask >> l) & 1u)) return;
    float acc = 0.f;
    for (int b = 0; b < grid; ++b) acc = __fadd_rn(acc, partials[static_cast<long long>(b) * nw + e]);
    dw[e] = acc;
}

size_t forward_smem(int in_dim, int n_hidden, int out_dim) {
    return sizeof(float) * (num_weights(in_dim, n_hidden, out_dim) + kRows * (in_dim + 1) +
                            kRows * kStride * n_hidden + kRows * odd_stride(out_dim));
}

size_t backward_smem(int in_dim, int n_hidden, int out_dim) {
    return sizeof(float) * (2 * num_weights(in_dim, n_hidden, out_dim) + kRows * (in_dim + 1) +
                            kRows * kStride * (1 + n_hidden));
}

// Allow a kernel the most dynamic shared memory once (above 48 KB a launch is
// refused without it).
template <typename Kernel>
int allow_smem(Kernel kernel, bool* done) {
    if (*done) return 0;
    const int status = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
    if (status == 0) *done = true;
    return status;
}

template <int IN, int NHID>
int launch_forward(const float* x, const float* w, long long m, int out_dim, int sigmoid,
                   float* out, cudaStream_t stream) {
    static bool ready = false;
    auto kernel = mlp_forward_kernel<IN, NHID>;
    const int status = allow_smem(kernel, &ready);
    if (status != 0) return status;
    kernel<<<nst::blocks_for(m, kRows), kRows, forward_smem(IN, NHID, out_dim), stream>>>(
        x, w, m, out_dim, sigmoid, out);
    return nst::launch_status();
}

template <int IN, int NHID>
int launch_backward(const float* x, const float* w, const float* g, long long m, int out_dim,
                    int sigmoid, unsigned int dw_mask, float* dx, float* dw,
                    cudaStream_t stream) {
    static bool ready = false;
    auto kernel = mlp_backward_kernel<IN, NHID>;
    const int status = allow_smem(kernel, &ready);
    if (status != 0) return status;
    kernel<<<nst::blocks_for(m, kRows), kRows, backward_smem(IN, NHID, out_dim), stream>>>(
        x, w, g, m, out_dim, sigmoid, dw_mask, dx, dw);
    return nst::launch_status();
}

// The persistent grid of a tensor-core kernel for m rows at smem bytes a
// CTA: (CTAs that fit an SM) x (SMs), at most one CTA a 64-row tile.  It
// depends only on the device and the shapes, so the bf16 backward's partial
// sums of d W add in the same order from run to run.
template <typename Kernel>
int persistent_grid(Kernel kernel, bool* ready, size_t smem, long long m, int* grid) {
    int status = allow_smem(kernel, ready);
    if (status != 0) return status;
    int dev = 0, sms = 0, per_sm = 0;
    status = static_cast<int>(cudaGetDevice(&dev));
    if (status == 0) {
        status = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    }
    if (status == 0) {
        status = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem));
    }
    if (status != 0) return status;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long tiles = (m + kTcRows - 1) / kTcRows;
    *grid = static_cast<int>(tiles < static_cast<long long>(per_sm) * sms ? tiles : per_sm * sms);
    return 0;
}

template <int IN, int NHID>
int launch_forward_tc(const float* x, const float* w, long long m, int out_dim, int sigmoid,
                      float* out, cudaStream_t stream) {
    static bool ready = false;
    auto kernel = mlp_forward_tc_kernel<IN, NHID>;
    const size_t smem = fwd_smem(IN, NHID).total;
    int grid = 0;
    const int status = persistent_grid(kernel, &ready, smem, m, &grid);
    if (status != 0) return status;
    kernel<<<grid, kTcThreads, smem, stream>>>(x, w, m, out_dim, sigmoid, out);
    return nst::launch_status();
}

template <int IN, int NHID>
int backward_tc_grid(long long m, int out_dim, int* grid) {
    static bool ready = false;
    return persistent_grid(mlp_backward_tc_kernel<IN, NHID>, &ready,
                           tc_smem(IN, NHID, out_dim).total, m, grid);
}

template <int IN, int NHID>
int launch_backward_tc(const float* x, const float* w, const float* g, long long m, int out_dim,
                       int sigmoid, unsigned int dw_mask, float* dx, float* partials,
                       cudaStream_t stream) {
    int grid = 0;
    const int status = backward_tc_grid<IN, NHID>(m, out_dim, &grid);
    if (status != 0) return status;
    mlp_backward_tc_kernel<IN, NHID><<<grid, kTcThreads, tc_smem(IN, NHID, out_dim).total,
                                       stream>>>(x, w, g, m, out_dim, sigmoid, dw_mask, dx,
                                                 partials);
    return nst::launch_status();
}

bool supported(int in_dim, int n_hidden, int hidden, int out_dim) {
    return (in_dim == 16 || in_dim == 32) && (n_hidden == 1 || n_hidden == 2) &&
           hidden == kHid && out_dim >= 1 && out_dim <= kMaxOut;
}

}  // namespace

// x [M, in] f32; w: the layers' [d_in, d_out] f32 matrices packed one after
// another; out [M, out] f32.  bf16: round as under mixed precision; sigmoid:
// output activation.
NST_API int nst_mlp_forward(const void* x, const void* w, long long m, int in_dim, int n_hidden,
                            int hidden, int out_dim, int bf16, int sigmoid, void* out,
                            void* stream) {
    if (!supported(in_dim, n_hidden, hidden, out_dim)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m <= 0) return 0;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
        if (in_dim == 32 && n_hidden == 1) return launch_forward_tc<32, 1>(xf, wf, m, out_dim, sigmoid, of, s);
        if (in_dim == 32 && n_hidden == 2) return launch_forward_tc<32, 2>(xf, wf, m, out_dim, sigmoid, of, s);
        if (in_dim == 16 && n_hidden == 1) return launch_forward_tc<16, 1>(xf, wf, m, out_dim, sigmoid, of, s);
        return launch_forward_tc<16, 2>(xf, wf, m, out_dim, sigmoid, of, s);
    }
    if (in_dim == 32 && n_hidden == 1) return launch_forward<32, 1>(xf, wf, m, out_dim, sigmoid, of, s);
    if (in_dim == 32 && n_hidden == 2) return launch_forward<32, 2>(xf, wf, m, out_dim, sigmoid, of, s);
    if (in_dim == 16 && n_hidden == 1) return launch_forward<16, 1>(xf, wf, m, out_dim, sigmoid, of, s);
    return launch_forward<16, 2>(xf, wf, m, out_dim, sigmoid, of, s);
}

// g [M, out] f32 -> dx [M, in] f32 and, for each layer l with bit l of
// dw_mask set, its gradient.  With bf16 = 0 it is added into dw (packed
// like w, zero-filled by the caller, unrounded) with fp32 atomics.  With
// bf16 = 1 dw is a [grid, n_weights] scratch (grid from
// nst_mlp_backward_grid) that takes each CTA's partial sums, which
// nst_mlp_dw_reduce then sums into the packed gradient.
NST_API int nst_mlp_backward(const void* x, const void* w, const void* g, long long m, int in_dim,
                             int n_hidden, int hidden, int out_dim, int bf16, int sigmoid,
                             int dw_mask, void* dx, void* dw, void* stream) {
    if (!supported(in_dim, n_hidden, hidden, out_dim)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m <= 0) return 0;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* gf = static_cast<const float*>(g);
    float* dxf = static_cast<float*>(dx);
    float* dwf = static_cast<float*>(dw);
    const unsigned int mask = static_cast<unsigned int>(dw_mask);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
        if (in_dim == 32 && n_hidden == 1) return launch_backward_tc<32, 1>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
        if (in_dim == 32 && n_hidden == 2) return launch_backward_tc<32, 2>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
        if (in_dim == 16 && n_hidden == 1) return launch_backward_tc<16, 1>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
        return launch_backward_tc<16, 2>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
    }
    if (in_dim == 32 && n_hidden == 1) return launch_backward<32, 1>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
    if (in_dim == 32 && n_hidden == 2) return launch_backward<32, 2>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
    if (in_dim == 16 && n_hidden == 1) return launch_backward<16, 1>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
    return launch_backward<16, 2>(xf, wf, gf, m, out_dim, sigmoid, mask, dxf, dwf, s);
}

// The grid (CTAs) of the bf16 backward for M rows: the rows of the d W
// scratch it needs.
NST_API int nst_mlp_backward_grid(long long m, int in_dim, int n_hidden, int hidden, int out_dim,
                                  int* grid) {
    if (!supported(in_dim, n_hidden, hidden, out_dim) || m <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (in_dim == 32 && n_hidden == 1) return backward_tc_grid<32, 1>(m, out_dim, grid);
    if (in_dim == 32 && n_hidden == 2) return backward_tc_grid<32, 2>(m, out_dim, grid);
    if (in_dim == 16 && n_hidden == 1) return backward_tc_grid<16, 1>(m, out_dim, grid);
    return backward_tc_grid<16, 2>(m, out_dim, grid);
}

// partials [grid, n_weights] f32 -> dw [n_weights] f32: the layers in
// dw_mask summed over the grid in CTA order (other layers untouched).
NST_API int nst_mlp_dw_reduce(const void* partials, int grid, int in_dim, int n_hidden,
                              int hidden, int out_dim, int dw_mask, void* dw, void* stream) {
    if (!supported(in_dim, n_hidden, hidden, out_dim) || grid < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int nw = num_weights(in_dim, n_hidden, out_dim);
    mlp_dw_reduce_kernel<<<nst::blocks_for(nw), nst::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(partials), grid, nw, in_dim, n_hidden,
        static_cast<unsigned int>(dw_mask), static_cast<float*>(dw));
    return nst::launch_status();
}
