// Helpers shared by the attention kernels: element conversion, the finite
// mask value of the plain versions (kernels/ref.py) and the shared-memory
// opt-in of a launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace repro {

// Devices whose opt-in is remembered; a later one opts in on every launch.
constexpr int kMaxDevices = 64;

// Let `kernel` launch with up to `bytes` of dynamic shared memory on the
// current device.  The attribute is per device, so `set_on` (one flag per
// device, a static array of the caller's kernel instantiation) records
// where it is set.  A caller passes one fixed `bytes` per kernel, so host
// threads racing here set the same value and need no lock.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, std::atomic<bool>* set_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev < kMaxDevices;
  if (tracked && set_on[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && tracked) set_on[dev].store(true, std::memory_order_release);
  return err;
}

// -2^30, the finite NEG_INF of ref.py: a masked key whose row has some
// valid key gets weight exp(-2^30 - m) == 0; a row with no valid key gets
// the uniform average, as in ref.py.  Keys that do not exist (past the
// sequence or the tile bound) get -inf instead, i.e. weight 0 always.
constexpr float kMaskedLogit = -1073741824.0f;

constexpr float kLog2e = 1.4426950408889634f;  // log2(e): exp(x) = exp2(x kLog2e)
constexpr float kLn2 = 0.6931471805599453f;    // ln(2): a log2-domain value times it is natural

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One 16-byte global load (4 fp32 or 8 bf16 values), widened to fp32.
// p must be 16-byte aligned.
__device__ __forceinline__ void load16_f32(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace repro
