// Error text for the status codes the kernel entry points return.
#include "common.cuh"

NST_API const char* nst_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
