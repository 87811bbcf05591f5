// K8: the reference checkpoint's occupancy layout.
//
// K8a replaces nerfstyle_tpu/ops/occupancy.py:packbits / unpackbits
// (:299-313): bool [K] <-> uint8 [K/8], LSB-first (bit b of byte i is cell
// 8i + b), the reference's packed bitfield.  One thread a byte: the pack
// reads its 8 cells as one 8-byte load, the unpack writes them as one
// 8-byte store (a bool is one byte of 0 or 1).
//
// K8b replaces nerfstyle_tpu/ops/morton.py:morton3d / morton3d_invert
// (:17-50): the 10-bit-a-coordinate Z-order interleave, code = x_bits at
// 3i, y at 3i + 1, z at 3i + 2, by the reference's multiply-and-mask bit
// spreading in uint32 arithmetic, and its inverse.  One thread a cell.
//
// Bound on the H100: bytes for all four (no more than a few integer
// operations a byte).  At the reference's 2 x 128^3 grid the pack moves
// 4 MiB in and 0.5 MiB out, the Morton code of every cell 12 bytes in and 4
// out a cell.  Design: the simplest exact form; each thread's loads and
// stores are contiguous with its neighbours'.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned int expand_bits(unsigned int v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

__device__ __forceinline__ unsigned int compact_bits(unsigned int v) {
    v &= 0x49249249u;
    v = (v | (v >> 2)) & 0xC30C30C3u;
    v = (v | (v >> 4)) & 0x0F00F00Fu;
    v = (v | (v >> 8)) & 0xFF0000FFu;
    v = (v | (v >> 16)) & 0x0000FFFFu;
    return v;
}

__global__ void packbits_kernel(const unsigned long long* __restrict__ bits, long long n_bytes,
                                unsigned char* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n_bytes) return;
    const unsigned long long v = bits[i];  // cell 8i + b in byte b (little endian)
    unsigned int byte = 0u;
#pragma unroll
    for (int b = 0; b < 8; ++b) byte |= ((v >> (8 * b)) & 1ull) ? (1u << b) : 0u;
    out[i] = static_cast<unsigned char>(byte);
}

__global__ void unpackbits_kernel(const unsigned char* __restrict__ packed, long long n_bytes,
                                  unsigned long long* __restrict__ bits) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n_bytes) return;
    const unsigned int byte = packed[i];
    unsigned long long v = 0ull;
#pragma unroll
    for (int b = 0; b < 8; ++b) v |= static_cast<unsigned long long>((byte >> b) & 1u) << (8 * b);
    bits[i] = v;
}

__global__ void morton3d_kernel(const int* __restrict__ coords, long long n,
                                int* __restrict__ codes) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned int x = expand_bits(static_cast<unsigned int>(coords[3 * i]));
    const unsigned int y = expand_bits(static_cast<unsigned int>(coords[3 * i + 1]));
    const unsigned int z = expand_bits(static_cast<unsigned int>(coords[3 * i + 2]));
    codes[i] = static_cast<int>(x | (y << 1) | (z << 2));
}

__global__ void morton3d_invert_kernel(const int* __restrict__ codes, long long n,
                                       int* __restrict__ coords) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned int c = static_cast<unsigned int>(codes[i]);
    coords[3 * i] = static_cast<int>(compact_bits(c));
    coords[3 * i + 1] = static_cast<int>(compact_bits(c >> 1));
    coords[3 * i + 2] = static_cast<int>(compact_bits(c >> 2));
}

}  // namespace

// bits [8 * n_bytes] bool (8-byte aligned) -> out [n_bytes] u8.
NST_API int nst_packbits(const void* bits, long long n_bytes, void* out, void* stream) {
    if (n_bytes <= 0) return 0;
    packbits_kernel<<<nst::blocks_for(n_bytes), nst::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(bits), n_bytes, static_cast<unsigned char*>(out));
    return nst::launch_status();
}

// packed [n_bytes] u8 -> bits [8 * n_bytes] bool (8-byte aligned).
NST_API int nst_unpackbits(const void* packed, long long n_bytes, void* bits, void* stream) {
    if (n_bytes <= 0) return 0;
    unpackbits_kernel<<<nst::blocks_for(n_bytes), nst::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(packed), n_bytes,
        static_cast<unsigned long long*>(bits));
    return nst::launch_status();
}

// coords [n, 3] i32 -> codes [n] i32.
NST_API int nst_morton3d(const void* coords, long long n, void* codes, void* stream) {
    if (n <= 0) return 0;
    morton3d_kernel<<<nst::blocks_for(n), nst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(coords), n, static_cast<int*>(codes));
    return nst::launch_status();
}

// codes [n] i32 -> coords [n, 3] i32.
NST_API int nst_morton3d_invert(const void* codes, long long n, void* coords, void* stream) {
    if (n <= 0) return 0;
    morton3d_invert_kernel<<<nst::blocks_for(n), nst::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(codes), n, static_cast<int*>(coords));
    return nst::launch_status();
}
