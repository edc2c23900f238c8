// The error-string entry point every kernel library exports: the Python
// side (kernels/common.py check_launch) turns the cudaError_t an entry point
// returns into a message with it. Included once per library.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
