// Error reporting for the ctypes binding: every launcher returns the
// cudaError_t of its launch as an int, and the Python wrapper turns a
// nonzero code into an exception carrying this string.
#include <cuda_runtime.h>

extern "C" const char* sdr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
