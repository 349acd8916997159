// Error reporting for the C interface of the kernel library: every entry
// point returns a cudaError_t as int, and the Python wrappers turn a
// non-zero code into an exception with this text.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
