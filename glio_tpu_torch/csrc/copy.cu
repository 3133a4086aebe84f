// Copy of a contiguous f32 array, for NVIDIA Hopper (sm_90a).
//
// Replaces scripts/probe_pallas.py::copy_kernel, the 8 x 128 VMEM copy that
// probed whether the TPU compiler produced a working kernel at all. Here it
// plays the same part for the port's toolchain: it is the smallest program
// that goes through nvcc, the ctypes binding of ops/_build.py and a launch
// on PyTorch's stream, so a probe that fails on it blames the toolchain and
// not a particular kernel. It copies any n >= 0 elements bit for bit in one
// launch, and is written to copy large arrays at the card's rate as well.
//
// What bounds it: device-memory bytes, 2 x 4n moved (each element read and
// written once, nothing computed); below a few hundred KB, the launch
// latency and the host's path to the launch (ops/_launch.py).
//
// Design. The host splits the n * 4 bytes (ops/probe.py::copy_plan) into a
// head, a body and a tail:
//   * the body is the part that is 16-byte aligned on both sides, a
//     multiple of 16 bytes; it is non-empty only when x and y share their
//     alignment modulo 16 (every fresh allocation does) and the array holds
//     at least one ring stage. It is moved by the card's bulk-copy engine:
//     a persistent grid of at most one block per SM, each walking its
//     stage-sized chunks (block b takes chunks b, b + grid, ...) through a
//     ring of kStages stages of dynamic shared memory. One thread of the
//     block issues every copy: cp.async.bulk global -> shared completing on
//     the stage's mbarrier, a wait on that barrier's phase parity, then
//     cp.async.bulk shared -> global in a bulk group; a stage is reloaded
//     only after cp.async.bulk.wait_group.read says its store has read it.
//     With kStages - 1 loads and a store in flight per SM, 32 KB stages keep
//     ~12 MB moving on 132 SMs, more than the ~5 MB that 3.35 TB/s needs
//     against ~1.5 us of memory latency;
//   * the head and tail (under 16 bytes each), and the whole array when it
//     is smaller than one stage or when x is not aligned like y (a view such
//     as buf[1:]), are copied by the threads of the grid: 16-byte vector
//     accesses where x and y share their alignment, 4-byte accesses
//     otherwise, neighbouring threads on neighbouring addresses, eight loads
//     in flight per thread. The probe's 4 KB block takes only this path, in
//     one block: the simplest code in the file.
// Offsets and sizes are 64-bit throughout.
//
// Proxies: the stages are written only by the bulk load and read only by
// the bulk store, both in the async proxy; no thread reads or writes them
// through the generic proxy. So no fence.proxy.async is needed between the
// two copies: that fence orders generic-proxy writes to shared memory
// (st.shared, stmatrix) before an async-proxy read, and there are none. The
// mbarrier wait orders the load's completion before the store is issued,
// and wait_group.read orders the store's reads before the stage is loaded
// again. The mbarriers themselves are initialised through the generic proxy
// and then completed by the async proxy, so fence.mbarrier_init follows
// their initialisation.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kStages = 4;
constexpr int kUnroll = 8;
constexpr int kMaxSharedBytes = 232448;   // 227 KB, a block's most on sm_90, static included
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N committed bulk stores have not yet read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// y[j] = x[j] for j = i, i + stride, ... < n, kUnroll loads in flight.
template <typename T>
__device__ __forceinline__ void strided_copy(const T* __restrict__ x, T* __restrict__ y,
                                             size_t n, size_t i, size_t stride) {
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) y[i] = x[i];
}

// The grid's threads copy n floats from x to y: float4 where the two share
// their alignment modulo 16, float elsewhere.
__device__ void thread_copy(const float* __restrict__ x, float* __restrict__ y, size_t n) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  if (((uintptr_t)x ^ (uintptr_t)y) & 15) {
    strided_copy(x, y, n, i, stride);
    return;
  }
  const size_t to_16 = ((0 - (uintptr_t)y) & 15) / 4;   // floats before y's next 16 B
  const size_t lead = to_16 < n ? to_16 : n;
  const size_t n_vec = (n - lead) / 4;
  const size_t done = lead + 4 * n_vec;
  if (i < lead) y[i] = x[i];
  strided_copy(reinterpret_cast<const float4*>(x + lead), reinterpret_cast<float4*>(y + lead),
               n_vec, i, stride);
  if (i < n - done) y[done + i] = x[done + i];
}

// Bytes [0, head) and [head + body, head + body + tail) by the threads;
// [head, head + body) by the bulk-copy ring, chunk c of stage_bytes going
// to block c % gridDim.x.
__global__ void __launch_bounds__(kThreads)
copy_f32_kernel(const char* __restrict__ x, char* __restrict__ y, size_t head, size_t body,
                size_t tail, uint32_t stage_bytes) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ __align__(8) uint64_t full[kStages];

  thread_copy(reinterpret_cast<const float*>(x), reinterpret_cast<float*>(y), head / 4);
  thread_copy(reinterpret_cast<const float*>(x + head + body),
              reinterpret_cast<float*>(y + head + body), tail / 4);
  if (body == 0 || threadIdx.x != 0) return;

  const char* src = x + head;
  char* dst = y + head;
  const uint32_t stage0 = static_cast<uint32_t>(__cvta_generic_to_shared(stages));
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
  fence_mbar_init();

  const size_t n_chunks = (body + stage_bytes - 1) / stage_bytes;
  const size_t first = blockIdx.x, step = gridDim.x;
  const size_t mine = first < n_chunks ? (n_chunks - first + step - 1) / step : 0;
  auto offset = [&](size_t j) { return (first + j * step) * stage_bytes; };
  auto length = [&](size_t j) {
    const size_t left = body - offset(j);
    return static_cast<uint32_t>(left < stage_bytes ? left : stage_bytes);
  };
  auto load = [&](size_t j) {
    const uint32_t s = static_cast<uint32_t>(j % kStages);
    arrive_expect_tx(bar0 + 8 * s, length(j));
    bulk_load(stage0 + s * stage_bytes, src + offset(j), length(j), bar0 + 8 * s);
  };

  for (size_t j = 0; j < mine && j < (size_t)kStages; ++j) load(j);
  for (size_t j = 0; j < mine; ++j) {
    const uint32_t s = static_cast<uint32_t>(j % kStages);
    wait_parity(bar0 + 8 * s, static_cast<uint32_t>((j / kStages) & 1));
    bulk_store(dst + offset(j), stage0 + s * stage_bytes, length(j));
    if (j >= 1 && j - 1 + kStages < mine) {
      bulk_wait_read<1>();   // chunk j - 1's store has read its stage
      load(j - 1 + kStages);
    }
  }
  bulk_wait_all();   // the stores have landed before the block's memory goes
}

std::atomic<size_t> g_shared_set[kMaxDevices];   // dynamic shared bytes allowed so far

}  // namespace

// y = x for the head + body + tail bytes that ops/probe.py::copy_plan split,
// on `stream`, with `blocks` blocks. Returns the cudaError_t of the launch
// (0 on success); the wrapper raises on anything else.
// Every argument is 64 bits wide, which ctypes converts fastest.
extern "C" int glio_copy_f32(const void* x, void* y, size_t head, size_t body, size_t tail,
                             size_t blocks, size_t stage_bytes, void* stream) {
  const size_t shared = body > 0 ? kStages * stage_bytes : 0;
  if (blocks < 1 || blocks > INT32_MAX || head % 4 != 0 || tail % 4 != 0 || body % 16 != 0 ||
      (body > 0 && (stage_bytes == 0 || stage_bytes % 16 != 0)) || shared > (size_t)kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (shared > 48 * 1024) {   // above the default: raise the kernel's limit, once per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= kMaxDevices || g_shared_set[dev].load() < shared)) {
      err = cudaFuncSetAttribute(copy_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared));
      if (err == cudaSuccess && dev < kMaxDevices) g_shared_set[dev].store(shared);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();   // leave no error behind for the next launch to report
      return static_cast<int>(err);
    }
  }
  copy_f32_kernel<<<static_cast<int>(blocks), kThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(y), head, body, tail,
      static_cast<uint32_t>(stage_bytes));
  return static_cast<int>(cudaGetLastError());
}
