// Error reporting for the ctypes binding (ops/kernels.py).
#include "common.cuh"

CUSMC_EXPORT const char* cusmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
