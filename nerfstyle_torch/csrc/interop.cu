// K8: the reference checkpoint's occupancy layout.
//
// K8a replaces nerfstyle_tpu/ops/occupancy.py:packbits / unpackbits
// (:299-313): bool [K] <-> uint8 [K/8], LSB-first (bit b of byte i is cell
// 8i + b), the reference's packed bitfield.  One thread a unit of 16 cells
// (two packed bytes): the unpack reads a 2-byte word and writes its cells
// with one 16-byte store, the pack reads 16 cells with one 16-byte load and
// writes a 2-byte word, so a warp's loads and stores are each one
// contiguous span.  Bits and bytes move by multiplies: 4 bool bytes (0 or
// 1) -> 4 bits with one multiply and a shift, 4 bits -> 4 bytes with one
// multiply and a mask.  A K that is an odd number of bytes ends in an
// 8-cell unit; a bitfield that is 8- but not 16-byte aligned walks 8-cell
// units throughout (8-byte accesses, one packed byte).
//
// K8b replaces nerfstyle_tpu/ops/morton.py:morton3d / morton3d_invert
// (:17-50): the 10-bit-a-coordinate Z-order interleave, code = x_bits at
// 3i, y at 3i + 1, z at 3i + 2, by the reference's multiply-and-mask bit
// spreading in uint32 arithmetic, and its inverse.  One thread a cell.
//
// Bound on the H100: bytes for all four (no more than a few integer
// operations a byte).  At the reference's 2 x 128^3 grid the pack moves
// 4 MiB in and 0.5 MiB out (~1.4 us, near the time a launch itself takes),
// the Morton code of every cell 12 bytes in and 4 out a cell.  K8b's design:
// the simplest exact form; each thread's loads and stores are contiguous
// with its neighbours'.
#include <type_traits>

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

// Four bool bytes (0 or 1) -> 4 bits, byte k at bit k.
__device__ __forceinline__ unsigned int nibble(unsigned int x) {
    return ((x & 0x01010101u) * 0x01020408u) >> 24 & 0xFu;
}

// 4 bits -> 4 bytes of 0 or 1, bit k at byte k.
__device__ __forceinline__ unsigned int spread(unsigned int x) {
    return (x * 0x00204081u) & 0x01010101u;
}

// U cells as bool bytes: one U-byte access.
template <int U>
struct alignas(U) CellBytes {
    unsigned int w[U / 4];
};

// The packed bytes of a unit of U cells: a U / 8-byte word.
template <int U>
using PackedWord = typename std::conditional<U == 16, unsigned short, unsigned char>::type;

// Thread i < num_units: unit i of U cells; num_units <= i < num_units +
// tail: the packed byte U / 8 num_units + (i - num_units) after the units,
// as an 8-cell unit.
template <int U>
__global__ void unpackbits_kernel(const unsigned char* __restrict__ packed, long long num_units,
                                  int tail, unsigned char* __restrict__ bits) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < num_units) {
        const unsigned int p = reinterpret_cast<const PackedWord<U>*>(packed)[i];
        CellBytes<U> c;
#pragma unroll
        for (int k = 0; k < U / 4; ++k) c.w[k] = spread(p >> (4 * k) & 0xFu);
        reinterpret_cast<CellBytes<U>*>(bits)[i] = c;
    } else if (i < num_units + tail) {
        const long long b = U / 8 * num_units + (i - num_units);
        const unsigned int p = packed[b];
        CellBytes<8> c;
        c.w[0] = spread(p & 0xFu);
        c.w[1] = spread(p >> 4);
        *reinterpret_cast<CellBytes<8>*>(bits + 8 * b) = c;
    }
}

template <int U>
__global__ void packbits_kernel(const unsigned char* __restrict__ bits, long long num_units,
                                int tail, unsigned char* __restrict__ packed) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < num_units) {
        const CellBytes<U> c = reinterpret_cast<const CellBytes<U>*>(bits)[i];
        unsigned int p = 0u;
#pragma unroll
        for (int k = 0; k < U / 4; ++k) p |= nibble(c.w[k]) << (4 * k);
        reinterpret_cast<PackedWord<U>*>(packed)[i] = static_cast<PackedWord<U>>(p);
    } else if (i < num_units + tail) {
        const long long b = U / 8 * num_units + (i - num_units);
        const CellBytes<8> c = *reinterpret_cast<const CellBytes<8>*>(bits + 8 * b);
        packed[b] = static_cast<unsigned char>(nibble(c.w[0]) | nibble(c.w[1]) << 4);
    }
}

// The units of n_bytes packed bytes: 16 cells where the bitfield is
// 16-byte and the packed array 2-byte aligned, else 8; their count and the
// packed byte left after them (an 8-cell unit).
struct Units {
    int size;
    long long count;
    int tail;
};

Units units_of(const void* bits, const void* packed, long long n_bytes) {
    if (reinterpret_cast<uintptr_t>(bits) % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 2 == 0)
        return {16, n_bytes / 2, static_cast<int>(n_bytes % 2)};
    return {8, n_bytes, 0};
}

__global__ void empty_kernel() {}

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
    const Units u = units_of(bits, out, n_bytes);
    const unsigned int blocks = nst::blocks_for(u.count + u.tail);
    const auto* in = static_cast<const unsigned char*>(bits);
    auto* o = static_cast<unsigned char*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    if (u.size == 16) {
        packbits_kernel<16><<<blocks, nst::kThreads, 0, s>>>(in, u.count, u.tail, o);
    } else {
        packbits_kernel<8><<<blocks, nst::kThreads, 0, s>>>(in, u.count, u.tail, o);
    }
    return nst::launch_status();
}

// packed [n_bytes] u8 -> bits [8 * n_bytes] bool (8-byte aligned).
NST_API int nst_unpackbits(const void* packed, long long n_bytes, void* bits, void* stream) {
    if (n_bytes <= 0) return 0;
    const Units u = units_of(bits, packed, n_bytes);
    const unsigned int blocks = nst::blocks_for(u.count + u.tail);
    const auto* in = static_cast<const unsigned char*>(packed);
    auto* o = static_cast<unsigned char*>(bits);
    const auto s = static_cast<cudaStream_t>(stream);
    if (u.size == 16) {
        unpackbits_kernel<16><<<blocks, nst::kThreads, 0, s>>>(in, u.count, u.tail, o);
    } else {
        unpackbits_kernel<8><<<blocks, nst::kThreads, 0, s>>>(in, u.count, u.tail, o);
    }
    return nst::launch_status();
}

// An empty kernel (one warp): the least time a launch takes, the floor of
// kernels as short as K8a's.
NST_API int nst_empty_kernel(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
