// Error text for the cudaError_t codes that the kernels' C entry points
// return, so that the Python wrappers can raise a readable message.

#include <cuda_runtime.h>

extern "C" const char* equihgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
