// The probe's minimal kernel on Hopper (sm_90a): out = x * 2 over int32,
// wrapping as two's complement does.
//
// Replaces the TPU kernel `minimal_kernel` (tools/pallas_probe.py:59,
// pallas_call at :70), which exists to prove that the kernel toolchain
// runs at all.
//
// Bound: bytes, 4 read and 4 written per element.  At the probe's
// [256, 256] that is 524,288 B, 0.00016 ms at 3.35 TB/s, far below the
// few microseconds any launch costs: the call is launch-bound, so the
// design keeps the device side short and the host side to one ctypes
// call.  A grid-stride loop sized to about one wave moves 16-byte
// vectors; a scalar head brings x to a 16-byte boundary and a scalar tail
// takes the ragged end.  When x and out differ in their alignment modulo
// 16 bytes (x a view at an odd element offset), every element goes the
// scalar way.
//
// Interface: plain C, loaded with ctypes; the launch returns
// cudaGetLastError() so the caller raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;    // 2048 threads: one full wave
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int32_t twice(int32_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << 1);
}

__global__ void __launch_bounds__(kThreads)
    minimal_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   long long n, long long head) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = tid; i < head; i += stride) out[i] = twice(x[i]);
  const long long nvec = (n - head) / 4;
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  for (long long i = tid; i < nvec; i += stride) {
    int4 v = xv[i];
    v.x = twice(v.x);
    v.y = twice(v.y);
    v.z = twice(v.z);
    v.w = twice(v.w);
    ov[i] = v;
  }
  const long long tail = head + nvec * 4;
  if (tid < n - tail) out[tail + tid] = twice(x[tail + tid]);
}

int g_sms[kMaxDevices];

}  // namespace

extern "C" int minimal_launch(const int32_t* x, int32_t* out, long long n,
                              void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (n < 0 || (xa & 3u) || (oa & 3u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  long long head = n;
  if ((xa & 15u) == (oa & 15u)) {
    head = static_cast<long long>((16u - (xa & 15u)) & 15u) / 4;
    if (head > n) head = n;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long work = head == n ? n : (n - head) / 4 + 1;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(g_sms[dev]) * kBlocksPerSm;
  if (blocks > wave) blocks = wave;
  minimal_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, out, n, head);
  return static_cast<int>(cudaGetLastError());
}
