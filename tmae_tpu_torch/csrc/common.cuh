// Shared by every kernel library of tmae_tpu_torch: the C interface returns
// the cudaError_t of each launch (cudaGetLastError right after it), and the
// Python side turns a non-zero code into an exception with this string.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <cstdint>

extern "C" const char* tmae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline int tmae_last_error() {
  return static_cast<int>(cudaGetLastError());
}
