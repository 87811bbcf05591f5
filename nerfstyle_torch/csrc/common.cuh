// Shared helpers of the hand-written Hopper kernels (built for sm_90a).
//
// Every entry point is a plain C function: pointers and the CUDA stream come
// in as void*-sized arguments from Python (ctypes), and the return value is
// the cudaError_t of the launch (0 = success), which the Python wrapper turns
// into an exception.  No entry point allocates or synchronises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NST_API extern "C" __attribute__((visibility("default")))

namespace nst {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n, int threads = kThreads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}

// cudaGetLastError after a launch: reports a refused launch (bad grid, too
// many registers or too much shared memory), which never runs and which a
// later synchronise would not report.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace nst
