// Copy of a row-major f32 array, for NVIDIA Hopper (sm_90a).
//
// Replaces scripts/probe_pallas.py::copy_kernel, the 8 x 128 VMEM copy that
// probed whether the TPU compiler produced a working kernel at all. Here it
// plays the same part for the port's toolchain: it is the smallest program
// that goes through nvcc, the ctypes binding of ops/_build.py and a launch
// on PyTorch's stream, so a probe that fails on it blames the toolchain and
// not a particular kernel.
//
// What bounds it: launch latency. The probe's array is 4 KB; the kernel
// reads and writes each element once. Design: one block of 128 threads
// strides over the n elements, neighbouring threads on neighbouring
// addresses, so any n (ragged included) is covered by one launch and the
// output equals the input bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void copy_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ y, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) y[i] = x[i];
}

}  // namespace

// y[i] = x[i] for i < n, on `stream`. Returns the cudaError_t of the launch
// (0 on success); the wrapper raises on anything else.
extern "C" int glio_copy_f32(const void* x, void* y, int n, void* stream) {
  copy_f32_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
