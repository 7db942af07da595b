// CUDA error text for the Python wrappers' exceptions.
#include "sfm_common.cuh"

SFM_API const char* sfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
