// Error reporting for the kernel entries.
//
// `repro_cuda_error_string`: text for the codes the entries return
// (cudaGetLastError() after each launch).
//
// `repro_error_word_alloc`: one 32-bit error word in pinned host memory that
// the device can write.  A kernel that finds a bad input (a segment bound
// past the table, a window start past its row) stores a non-zero value into
// its word and reads nothing out of range; the host reads the word from its
// own memory whenever it likes, with no copy and no synchronization, and sees
// every store of the kernels that finished before its last synchronization.
// The word is allocated mapped and portable, and the kernels are handed the
// host pointer itself: under unified addressing (every 64-bit CUDA device)
// the device pointer of mapped host memory is the same address.
#include <cuda_runtime.h>
#include <cstdint>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A zeroed error word, or nullptr when the allocation fails or the device
// address of the word differs from its host address.
extern "C" void* repro_error_word_alloc(void) {
  int32_t* host = nullptr;
  if (cudaHostAlloc(reinterpret_cast<void**>(&host), sizeof(int32_t),
                    cudaHostAllocMapped | cudaHostAllocPortable) != cudaSuccess) {
    return nullptr;
  }
  void* dev = nullptr;
  if (cudaHostGetDevicePointer(&dev, host, 0) != cudaSuccess || dev != host) {
    cudaFreeHost(host);
    return nullptr;
  }
  *host = 0;
  return host;
}
