// What the LAS kernels share: K2 / K3 (las_step.cu) and K3b (las_scan.cu).
// Blocks of kThreads threads over kFrames frames of one row, cp.async
// helpers, the location conv by half-warps, the fast tanh, and the
// per-device cache of the dynamic shared memory a kernel was granted.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

#include "rel_attention_common.cuh"

namespace nsp_las {

using nsp_rel::cp_async16;
using nsp_rel::cp_async_commit;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 16;     // frames per block of the attention / conv kernels
// location-conv channels held in registers at once (the flagship's C);
// the attention and conv kernels take any C, kGroupC channels at a time
constexpr int kGroupC = 10;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sums x over the 16 lanes of each half-warp (lanes that differ in their
// low four bits); every lane of the warp takes part.
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A 4-byte cp.async (zero-fill when pred is false).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_two() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_none() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tanh(x) = 1 - 2 / (exp(2x) + 1), on the fast exponential: absolute
// error about 1e-7 (float32 rounding), a few instructions instead of
// tanhf's accurate path; it saturates to +-1 at large |x|.
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// Starts the copy of n floats from global src to shared dst by a block of
// kThreads threads: 16-byte cp.async where both are 16-byte aligned,
// 4-byte ones for the rest.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  int head = 0;
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0) {
    head = n & ~3;
    for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads) cp_async16(dst + i, src + i, true);
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i, true);
}

// Starts the copy of aw_prev's window of row n for the block's frames
// t0 .. t0 + kFrames - 1 under a width-K SAME conv: awp[i] = aw_prev[n, t0
// - left + i], zeros outside [0, T).
__device__ __forceinline__ void window_async(float* awp, const float* aw_prev, int n, int t0,
                                             int T, int K) {
  const int left = (K - 1) / 2;
  for (int i = threadIdx.x; i < kFrames + K - 1; i += kThreads) {
    const int t = t0 + i - left;
    const bool in = t >= 0 && t < T;
    cp_async4(awp + i, aw_prev + (in ? (size_t)n * T + t : 0), in);
  }
}

// awp[i] *= keep[n, t0 - left + i] inside [0, T): the window of the
// previous step's raw weights times its attention dropout scale, the
// dropped weights the location conv read in the forward. Each thread
// scales the entries window_async gave it to copy.
__device__ __forceinline__ void scale_window(float* awp, const float* keep, int n, int t0, int T,
                                             int K) {
  const int left = (K - 1) / 2;
  for (int i = threadIdx.x; i < kFrames + K - 1; i += kThreads) {
    const int t = t0 + i - left;
    if (t >= 0 && t < T) awp[i] *= keep[(size_t)n * T + t];
  }
}

// loc[tl, c0 + c] = sum_k awp[tl + k] cw[c0 + c, k] for the group's
// channels: a half-warp per frame tl, lanes along K.
__device__ __forceinline__ void loc_group(const float* awp, const float* cw, float* loc, int c0,
                                          int C, int K) {
  static_assert(kThreads == 16 * kFrames, "a half-warp per frame");
  const int tl = threadIdx.x >> 4, part16 = threadIdx.x & 15;
  float acc[kGroupC];
#pragma unroll
  for (int c = 0; c < kGroupC; ++c) acc[c] = 0.0f;
  for (int kk = part16; kk < K; kk += 16) {
    const float x = awp[tl + kk];
#pragma unroll
    for (int c = 0; c < kGroupC; ++c)
      if (c0 + c < C) acc[c] += x * cw[(c0 + c) * K + kk];
  }
#pragma unroll
  for (int c = 0; c < kGroupC; ++c) {
    if (c0 + c >= C) break;
    const float s = half_warp_sum(acc[c]);
    if (part16 == c) loc[tl * C + c0 + c] = s;
  }
}

// static: each source that includes this header gets its own copy
static __device__ __noinline__ void loc_rest(const float* awp, const float* cw, float* loc, int C,
                                              int K) {
  for (int c0 = kGroupC; c0 < C; c0 += kGroupC) loc_group(awp, cw, loc, c0, C, K);
}

// Programmatic dependent launch (sm_90): a kernel launched with
// launch_kernel(chained = true) may start while the kernel before it on
// the stream still runs. Its blocks call grid_dependency_wait() before
// their first read of anything an earlier kernel of the chain wrote, and
// before their first write: the wait returns when every kernel launched
// before on the stream has completed and its writes are visible. What a
// block does before the wait may only read what no kernel of the chain
// writes. Right after the wait they call grid_dependents_launch(), so that
// the next kernel of the chain may start in turn: at most two kernels of a
// chain are on the card at once. Launched the plain way, both calls do
// nothing.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_kernel(bool chained, void (*kernel)(Params...), dim3 grid, dim3 block,
                          size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = chained ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Lets Kernel take `bytes` of dynamic shared memory on the current device.
// The attribute is set only when a call on that device needs more than
// before, so a call captured in a CUDA graph after a first one at its
// shapes makes no such request.
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (bytes <= 48 * 1024 || (cached && bytes <= allowed[dev])) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && cached) allowed[dev] = bytes;
  return err;
}

inline size_t max_of(std::initializer_list<size_t> xs) {
  size_t m = 0;
  for (size_t x : xs) m = x > m ? x : m;
  return m;
}

}  // namespace nsp_las
