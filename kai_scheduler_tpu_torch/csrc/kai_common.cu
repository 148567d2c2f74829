// Error strings for the kernels' C entry points.
#include "kai_common.cuh"

KAI_EXPORT const char* kai_error_string(int rc) {
  if (rc == KAI_ERR_ARGS) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
