// Plain C helpers shared by the kernel wrappers (loaded with ctypes).
#include <cuda_runtime.h>

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
