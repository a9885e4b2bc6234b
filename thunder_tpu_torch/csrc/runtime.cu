// Error text for the status codes the kernel entry points return.
#include "common.cuh"

extern "C" const char* thunder_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
