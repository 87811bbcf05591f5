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
// Design: one CTA of kRows threads takes kRows rows, one row a thread.  All
// layer weights are staged in shared memory (already rounded; the backward
// also stages their transposes), so every thread reads the same weights at
// the same time (a broadcast, 16 bytes a load).  Each thread keeps the 64
// accumulators of the layer it computes in registers and walks the layer's
// input, which lives in its own row of a shared-memory tile (rows padded to
// an odd stride, so a warp's 32 rows fall in 32 banks); the hidden
// activations of every layer stay in those tiles, where the backward reads
// them again.  Inputs and outputs go through shared memory so that
// device-memory reads and writes coalesce.  The backward recomputes the
// forward (nothing is saved between the passes) and, when a weight gradient
// is asked for, forms the tile's A^T G from the shared tiles and adds it to
// the [d_in, d_out] gradient with one fp32 atomicAdd an element a CTA; the
// order of those adds varies from run to run.
//
// Bound on the H100: bytes.  A row reads IN and writes OUT fp32 values for
// 2 (IN*64 + 64*64*(L-1) + 64*OUT) operations: ~6 k operations for ~200
// bytes, far below the ~295 operations a byte where the bf16 tensor cores
// would bind.  This scalar-FMA form runs at the fp32 FMA rate at best, with
// one CTA of 4 warps an SM where the shared tiles are largest; mma tiles are
// later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kHid = 64;
constexpr int kRows = 128;
constexpr int kMaxOut = 64;
constexpr int kStride = kHid + 1;  // odd row stride of the 64-wide tiles
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

__device__ __forceinline__ float rnd(float v, bool bf16) {
    return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

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

// dst[j] = r(relu(sum_k src[k] W[k][j])) for j < 64 (ReLU lets NaN pass, as
// torch.relu does).
__device__ __forceinline__ void dense_relu(const float* src, int d, const float* wl, bool bf16,
                                           float* dst) {
    float acc[kHid];
    dense<kHid>(src, d, wl, acc);
#pragma unroll
    for (int j = 0; j < kHid; ++j) dst[j] = rnd(acc[j] < 0.f ? 0.f : acc[j], bf16);
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

// Stage the weights (rounded; with their transposes when wt is not null) and
// the tile's input rows (rounded; zero rows past the end of the batch).
template <int IN, int NHID>
__device__ __forceinline__ void stage(const float* __restrict__ x, const float* __restrict__ w,
                                      int out_dim, long long row0, int rows, bool bf16,
                                      float* ws, float* wt, float* xs) {
    const int nw = num_weights(IN, NHID, out_dim);
    for (int i = threadIdx.x; i < nw; i += kRows) ws[i] = rnd(w[i], bf16);
    if (wt != nullptr) {
#pragma unroll 1
        for (int l = 0; l <= NHID; ++l) {
            const int d_in = l == 0 ? IN : kHid;
            const int d_out = l == NHID ? out_dim : kHid;
            const int off = layer_offset(IN, l);
            for (int e = threadIdx.x; e < d_in * d_out; e += kRows) {
                const int i = e / d_out;
                const int o = e - i * d_out;
                wt[off + o * d_in + i] = rnd(w[off + e], bf16);
            }
        }
    }
    for (int e = threadIdx.x; e < kRows * IN; e += kRows) {
        const int r = e / IN;
        xs[r * (IN + 1) + (e - r * IN)] = r < rows ? rnd(x[row0 * IN + e], bf16) : 0.f;
    }
}

// Hidden layers of one row: h_0 from the row of xs into hs[0], h_l from
// hs[l-1] into hs[l].
template <int IN, int NHID>
__device__ __forceinline__ void hidden_layers(const float* xs, const float* ws, bool bf16,
                                              float* hs) {
    const int t = threadIdx.x;
    dense_relu(xs + t * (IN + 1), IN, ws, bf16, hs + t * kStride);
#pragma unroll 1
    for (int l = 1; l < NHID; ++l) {
        dense_relu(hs + ((l - 1) * kRows + t) * kStride, kHid, ws + layer_offset(IN, l), bf16,
                   hs + (l * kRows + t) * kStride);
    }
}

template <int IN, int NHID>
__global__ void __launch_bounds__(kRows)
    mlp_forward_kernel(const float* __restrict__ x, const float* __restrict__ w, long long m,
                       int out_dim, int bf16, int sigmoid, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* ws = reinterpret_cast<float*>(smem4);
    float* xs = ws + num_weights(IN, NHID, out_dim);  // [kRows][IN + 1]
    float* hs = xs + kRows * (IN + 1);                 // [NHID][kRows][kStride]
    float* os = hs + NHID * kRows * kStride;           // [kRows][ostride]
    const int ostride = odd_stride(out_dim);
    const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kRows), m - row0));
    const int t = threadIdx.x;
    stage<IN, NHID>(x, w, out_dim, row0, rows, bf16 != 0, ws, nullptr, xs);
    __syncthreads();

    hidden_layers<IN, NHID>(xs, ws, bf16 != 0, hs);
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
                        const float* __restrict__ g_out, long long m, int out_dim, int bf16_flag,
                        int sigmoid, unsigned int dw_mask, float* __restrict__ dx,
                        float* __restrict__ dw) {
    extern __shared__ float4 smem4[];
    const bool bf16 = bf16_flag != 0;
    const int nw = num_weights(IN, NHID, out_dim);
    float* ws = reinterpret_cast<float*>(smem4);
    float* wt = ws + nw;                // transposed layers, same offsets
    float* xs = wt + nw;                // [kRows][IN + 1]
    float* gs = xs + kRows * (IN + 1);  // [kRows][kStride]: the cotangent rows
    float* hs = gs + kRows * kStride;   // [NHID][kRows][kStride]
    const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kRows), m - row0));
    const int t = threadIdx.x;
    stage<IN, NHID>(x, w, out_dim, row0, rows, bf16, ws, wt, xs);
    for (int e = t; e < kRows * out_dim; e += kRows) {
        const int r = e / out_dim;
        gs[r * kStride + (e - r * out_dim)] = r < rows ? g_out[row0 * out_dim + e] : 0.f;
    }
    __syncthreads();

    hidden_layers<IN, NHID>(xs, ws, bf16, hs);
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
    // d a of the last hidden layer: r(d y W_L^T) under its ReLU mask.
    {
        float acc[kHid];
        dense<kHid>(grow, out_dim, wt + layer_offset(IN, NHID), acc);
        __syncthreads();  // every tile gradient has read gs
#pragma unroll
        for (int j = 0; j < kHid; ++j) grow[j] = hl[j] > 0.f ? rnd(acc[j], bf16) : 0.f;
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
            for (int i = 0; i < kHid; ++i) grow[i] = hp[i] > 0.f ? rnd(acc[i], bf16) : 0.f;
        } else {
            float acc[IN];
            dense<IN>(grow, kHid, wt, acc);
#pragma unroll
            for (int k = 0; k < IN; ++k) xs[t * (IN + 1) + k] = rnd(acc[k], bf16);
        }
    }
    __syncthreads();
    for (int e = t; e < rows * IN; e += kRows) {
        const int r = e / IN;
        dx[row0 * IN + e] = xs[r * (IN + 1) + (e - r * IN)];
    }
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
int launch_forward(const float* x, const float* w, long long m, int out_dim, int bf16,
                   int sigmoid, float* out, cudaStream_t stream) {
    static bool ready = false;
    auto kernel = mlp_forward_kernel<IN, NHID>;
    const int status = allow_smem(kernel, &ready);
    if (status != 0) return status;
    kernel<<<nst::blocks_for(m, kRows), kRows, forward_smem(IN, NHID, out_dim), stream>>>(
        x, w, m, out_dim, bf16, sigmoid, out);
    return nst::launch_status();
}

template <int IN, int NHID>
int launch_backward(const float* x, const float* w, const float* g, long long m, int out_dim,
                    int bf16, int sigmoid, unsigned int dw_mask, float* dx, float* dw,
                    cudaStream_t stream) {
    static bool ready = false;
    auto kernel = mlp_backward_kernel<IN, NHID>;
    const int status = allow_smem(kernel, &ready);
    if (status != 0) return status;
    kernel<<<nst::blocks_for(m, kRows), kRows, backward_smem(IN, NHID, out_dim), stream>>>(
        x, w, g, m, out_dim, bf16, sigmoid, dw_mask, dx, dw);
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
    if (in_dim == 32 && n_hidden == 1) return launch_forward<32, 1>(xf, wf, m, out_dim, bf16, sigmoid, of, s);
    if (in_dim == 32 && n_hidden == 2) return launch_forward<32, 2>(xf, wf, m, out_dim, bf16, sigmoid, of, s);
    if (in_dim == 16 && n_hidden == 1) return launch_forward<16, 1>(xf, wf, m, out_dim, bf16, sigmoid, of, s);
    return launch_forward<16, 2>(xf, wf, m, out_dim, bf16, sigmoid, of, s);
}

// g [M, out] f32 -> dx [M, in] f32 and, for each layer l with bit l of
// dw_mask set, its gradient added into dw (packed like w, zero-filled by the
// caller, unrounded).
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
    if (in_dim == 32 && n_hidden == 1) return launch_backward<32, 1>(xf, wf, gf, m, out_dim, bf16, sigmoid, mask, dxf, dwf, s);
    if (in_dim == 32 && n_hidden == 2) return launch_backward<32, 2>(xf, wf, gf, m, out_dim, bf16, sigmoid, mask, dxf, dwf, s);
    if (in_dim == 16 && n_hidden == 1) return launch_backward<16, 1>(xf, wf, gf, m, out_dim, bf16, sigmoid, mask, dxf, dwf, s);
    return launch_backward<16, 2>(xf, wf, gf, m, out_dim, bf16, sigmoid, mask, dxf, dwf, s);
}
