// RG-LRU linear recurrence h_t = a_t * h_{t-1} + bx_t for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// `rglru_pallas` (:48; kernel body `_kernel`, :31).  Same function as the
// plain version `rglru_scan_ref` in kernels/ref.py.
//
// Layouts: a, bx, h (B, S, W) in T (fp32 or bf16), contiguous; the final
// state (B, W) fp32.  The carry is fp32; h rounds once to T per step.
//
// Design.  The recurrence is elementwise over W.  The TPU kernel tiles W
// into 128-lane blocks, walks S in chunks on a sequential grid axis with the
// carry in VMEM and resolves each chunk with a log-depth associative scan.
// Here one thread owns one (row, channel) and walks S itself: a warp reads
// 32 neighbouring channels of one step, 128 (fp32) or 64 (bf16) contiguous
// bytes, and the carry never leaves a register.  No padding of S is needed
// (the TPU kernel pads with a = 1, bx = 0): the loop stops at S.
//
// What bounds it on this card: 2 reads and 1 write per element for 1 FMA,
// so device-memory bandwidth (B 4, S 512, W 4096 fp32: ~100 MB, 0.030 ms at
// 3.35 TB/s).  The loads do not depend on the carry, so the loop is
// software-pipelined: the next kUnroll steps' loads are issued before this
// group's FMAs, keeping 2 * kUnroll loads in flight per thread.  At
// B * W = 16,384 threads that is ~1 MB in flight, below what hides the
// memory latency at full rate; a chunked two-pass scan over S (more
// threads, one more pass over the carries) is the next step if it shows.
//
// Why CUDA C++ and not Triton: a fused elementwise pass would suit Triton
// as well, but the port builds every kernel with nvcc into a plain C
// library bound with ctypes, and this keeps to that one build path.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx, T* __restrict__ h,
                  float* __restrict__ final_state, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(b) * S * W + w;
  float ca[kUnroll], cb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = u < S;
    ca[u] = in ? repro::to_f32(a[base + static_cast<size_t>(u) * W]) : 1.f;
    cb[u] = in ? repro::to_f32(bx[base + static_cast<size_t>(u) * W]) : 0.f;
  }
  float carry = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float na[kUnroll], nb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next group's loads, issued first
      const int t = t0 + kUnroll + u;
      const bool in = t < S;
      na[u] = in ? repro::to_f32(a[base + static_cast<size_t>(t) * W]) : 1.f;
      nb[u] = in ? repro::to_f32(bx[base + static_cast<size_t>(t) * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        carry = fmaf(ca[u], carry, cb[u]);
        repro::store_f32(h + base + static_cast<size_t>(t) * W, carry);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  if (final_state != nullptr) final_state[static_cast<size_t>(b) * W + w] = carry;
}

template <typename T>
cudaError_t launch(const void* a, const void* bx, void* h, float* final_state, int B, int S,
                   int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx), static_cast<T*>(h), final_state,
      S, W);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  final_state may be null.
// Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan(const void* a, const void* bx, void* h, float* final_state,
                                int B, int S, int W, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
                              ? launch<__nv_bfloat16>(a, bx, h, final_state, B, S, W, s)
                              : launch<float>(a, bx, h, final_state, B, S, W, s);
  return static_cast<int>(err);
}
