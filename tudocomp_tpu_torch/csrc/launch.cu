// Host helpers of the launch path (kernels.py); they launch no kernel.
//
// tdc_mapped_word: one 32-bit word of pinned host memory, mapped into the
// card's address space, that a kernel writes to report a bad input. The
// host zeroes it, launches, waits for the stream and reads it: no device
// allocation, no memset launch and no copy back per call. Allocated once
// per device and kept for the life of the process.
// tdc_stream_wait: cudaStreamSynchronize on a raw stream handle, so the
// wrapper waits on PyTorch's current stream without building a Stream
// object.

#include <cuda_runtime.h>

// Returns the host address of a zeroed mapped word on `device` and stores
// its device address in *dev_ptr; null on failure. The current device is
// left as it was.
extern "C" void* tdc_mapped_word(int device, void** dev_ptr) {
  int prev = 0;
  if (cudaGetDevice(&prev) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) return nullptr;
  void* host = nullptr;
  if (cudaHostAlloc(&host, 16, cudaHostAllocMapped | cudaHostAllocPortable) != cudaSuccess) {
    host = nullptr;
  } else if (cudaHostGetDevicePointer(dev_ptr, host, 0) != cudaSuccess) {
    cudaFreeHost(host);
    host = nullptr;
  } else {
    *static_cast<volatile int*>(host) = 0;
  }
  cudaSetDevice(prev);
  return host;
}

extern "C" int tdc_stream_wait(void* stream) {
  return (int)cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}
