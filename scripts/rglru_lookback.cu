// rglru_scan with the other carry handoff, for scripts/rglru_chunk_sweep.py
// only: a decoupled look-back in place of the thread-block cluster of
// src/repro_torch/kernels/csrc/rglru_scan.cu, whose chunk body (loads,
// aggregate, walk) it includes and reuses.
//
// Grid: one block per (chunk, tile, row), in ticket order: a block takes
// its chunk from an atomic counter, chunk-major, so it only ever waits on
// chunks whose blocks have started.  Each block publishes its chunk's
// aggregate (A, H) with flag 1, looks back over the flags of the chunks
// before it (a warp reads 32 at a time) to the nearest one that has
// published its inclusive carry (flag 2), composes forward from there in
// chunk order, carry_c = A_{c-1} * carry_{c-1} + H_{c-1}, and publishes its
// own inclusive carry.  Every inclusive carry is the same fmaf chain as the
// cluster kernel's, so both give the same bits at one chunk length.  The
// flags and the counter are zeroed by a memset before each launch.
//
//   nvcc <the port's flags> -I src/repro_torch/kernels/csrc -o lib.so scripts/rglru_lookback.cu

#include "rglru_scan.cu"

namespace {

struct Scratch {
  int* counter;
  int* flags;   // [B][tiles][chunks]
  float* agg;   // [B][tiles][chunks][2][kThreads]
  float* incl;  // [B][tiles][chunks][kThreads]
};

size_t scratch_layout(int B, int S, int W, int chunk, char* base, Scratch* out) {
  const size_t units = static_cast<size_t>(B) * ((W + kThreads - 1) / kThreads) *
                       ((S + chunk - 1) / chunk);
  const size_t flag_bytes = (16 + units * 4 + 15) / 16 * 16;
  if (out != nullptr) {
    out->counter = reinterpret_cast<int*>(base);
    out->flags = reinterpret_cast<int*>(base + 16);
    out->agg = reinterpret_cast<float*>(base + flag_bytes);
    out->incl = out->agg + units * 2 * kThreads;
  }
  return flag_bytes + units * 3 * kThreads * sizeof(float);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) rglru_lookback_kernel(const Args<T> p, Scratch sc,
                                                                  int tiles, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket, stop;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + p.chunk * kThreads;
  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(sc.counter, 1);
  __syncthreads();
  const int pairs = tiles * gridDim.y;
  const int c = ticket / pairs, tile = ticket % tiles, b = (ticket % pairs) / tiles;
  const int w0 = tile * kThreads;
  const int tile_w = min(kThreads, p.W - w0);
  const bool valid = tid < tile_w;
  const int t0 = c * p.chunk, n = min(p.chunk, p.S - t0);
  const size_t row = static_cast<size_t>(b) * p.S * p.W;
  load_chunk<T, kVec>(sa, sb, p.a, p.bx, row + static_cast<size_t>(t0) * p.W + w0, n, p.W,
                      tile_w);
  repro::cp_async_wait<0>();
  __syncthreads();

  const size_t unit = (static_cast<size_t>(b) * tiles + tile) * n_chunks;  // chunk 0's slot
  float* my_agg = sc.agg + (unit + c) * 2 * kThreads;
  chunk_aggregate(sa, sb, n, my_agg);  // A, H straight to the published slot
  const float A = my_agg[tid], H = my_agg[kThreads + tid];
  float carry = 0.f;
  if (c > 0) {
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(sc.flags + unit + c, 1);
    if (tid < 32) {  // look back, 32 chunks at a time, to the nearest inclusive carry
      int found = -1;
      for (int base = c - 1; base >= 0; base -= 32) {
        const int j = base - tid;
        int f = 0;
        if (j >= 0) {
          do f = load_acquire(sc.flags + unit + j);
          while (f == 0);
        }
        const unsigned incl = __ballot_sync(0xffffffffu, j >= 0 && f == 2);
        if (incl != 0u) {
          found = base - (__ffs(incl) - 1);
          break;
        }
      }
      if (tid == 0) stop = found;
      __threadfence();
    }
    __syncthreads();
    if (stop >= 0) carry = __ldcg(sc.incl + (unit + stop) * kThreads + tid);
    for (int j = stop + 1; j < c; ++j) {
      const float* agg = sc.agg + (unit + j) * 2 * kThreads;
      carry = fmaf(__ldcg(agg + tid), carry, __ldcg(agg + kThreads + tid));
    }
  }
  sc.incl[(unit + c) * kThreads + tid] = fmaf(A, carry, H);
  __threadfence();
  __syncthreads();
  if (tid == 0) store_release(sc.flags + unit + c, 2);

  T* out = p.h + row + static_cast<size_t>(t0) * p.W + w0 + tid;
  const float end = chunk_walk(sa, sb, n, carry, out, p.W, valid);
  if (p.final_state != nullptr && valid && t0 + n == p.S)
    p.final_state[static_cast<size_t>(b) * p.W + w0 + tid] = end;
}

template <typename T, bool kVec>
cudaError_t launch_lookback(const Args<T>& p, const Scratch& sc, int B, cudaStream_t stream) {
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const auto kernel = rglru_lookback_kernel<T, kVec>;
  cudaError_t err =
      repro::allow_dynamic_smem(kernel, 2 * kMaxChunk * kThreads * sizeof(T), smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = (p.W + kThreads - 1) / kThreads;
  const int n_chunks = (p.S + p.chunk - 1) / p.chunk;
  const dim3 grid(tiles * n_chunks, B);
  kernel<<<grid, kThreads, 2 * p.chunk * kThreads * sizeof(T), stream>>>(p, sc, tiles,
                                                                        n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_lookback(const void* a, const void* bx, void* h, float* final_state,
                              const Scratch& sc, int B, int S, int W, int chunk,
                              cudaStream_t stream) {
  Args<T> p{};
  p.a = static_cast<const T*>(a);
  p.bx = static_cast<const T*>(bx);
  p.h = static_cast<T*>(h);
  p.final_state = final_state;
  p.S = S;
  p.W = W;
  p.chunk = chunk;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const bool vec = W % kPer == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bx) % 16 == 0;
  return vec ? launch_lookback<T, true>(p, sc, B, stream)
             : launch_lookback<T, false>(p, sc, B, stream);
}

}  // namespace

// Bytes of scratch the look-back needs at these shapes.
extern "C" long long repro_rglru_lookback_scratch(int B, int S, int W, int chunk) {
  return static_cast<long long>(scratch_layout(B, S, W, chunk, nullptr, nullptr));
}

// The scan with the look-back handoff; `scratch` holds
// repro_rglru_lookback_scratch bytes.  Zeroes the flags and the counter,
// then launches.  Returns the cudaError_t.
extern "C" int repro_rglru_lookback(const void* a, const void* bx, void* h, float* final_state,
                                    void* scratch, int B, int S, int W, int is_bf16, int chunk,
                                    void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scratch sc;
  const size_t units = static_cast<size_t>(B) * ((W + kThreads - 1) / kThreads) *
                       ((S + chunk - 1) / chunk);
  scratch_layout(B, S, W, chunk, static_cast<char*>(scratch), &sc);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 16 + units * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = is_bf16 ? dispatch_lookback<__nv_bfloat16>(a, bx, h, final_state, sc, B, S, W, chunk, s)
                : dispatch_lookback<float>(a, bx, h, final_state, sc, B, S, W, chunk, s);
  return static_cast<int>(err);
}
