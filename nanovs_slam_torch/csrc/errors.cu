// The CUDA runtime's message for an error code returned by a launcher.
#include <cuda_runtime.h>

extern "C" const char* nvs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
