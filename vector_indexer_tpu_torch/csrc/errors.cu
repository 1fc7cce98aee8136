// Error text for the codes the entry points return.
#include "common.cuh"

VITORCH_API const char* vitorch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
