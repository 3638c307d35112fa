// RG-LRU linear recurrence h_t = a_t * h_{t-1} + bx_t for Hopper, sm_90a:
// a chunked single-pass scan over S, chunks handing on their carries
// through a thread-block cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// `rglru_pallas` (:48; kernel body `_kernel`, :28), which tiles W into
// lanes, walks S in chunks of 256 on a sequential grid axis and keeps the
// carry in VMEM between them.  Same function as the plain version
// `rglru_scan_ref` in kernels/ref.py.
//
// Layouts: a, bx, h (B, S, W) in T (fp32 or bf16), contiguous; the final
// state (B, W) fp32.  The carry is fp32; h rounds once to T per step.
//
// What bounds it.  Each element is read twice (a, bx) and written once (h)
// for one FMA: 12 bytes per FMA in fp32, 6 in bf16, so device-memory
// bandwidth (B 4, S 512, W 4096 fp32: 100.7 MB, 0.0301 ms at 3.35 TB/s;
// B 1, S 256: 12.6 MB, 0.0038 ms).
//
// Why the first design missed that bound.  It gave one thread to
// each (row, channel) and let that thread walk all of S, keeping the next 8
// steps' loads in flight.  That is a serial walk: every 8 steps wait about
// one device-memory round trip, so S, not bytes, set the time (B 4, S 512:
// 64 waits, 0.058-0.060 ms on an H100, half the bound).  B * W threads hold ~1 MB in flight
// at B 4, and a 1-row admission at W 4096 filled 32 blocks of 132 SMs.
//
// This design.  S is cut into chunks of `chunk` steps and the grid covers
// (channel tile of 128, chunk, row), so a 1-row admission still fills the
// card (rglru_scan.py `rglru_chunks` picks the chunk from the shapes and the
// SM count).  A block serves one chunk of one tile, one thread per channel:
//   1. it issues every load of its chunk at once, 16-byte cp.async copies of
//      a and bx into shared memory (64 KB in flight per block in fp32 at a
//      chunk of 64), so the card sees its whole chunk's bytes in flight;
//   2. it walks the chunk from shared memory from a zero carry: the
//      aggregate (A = prod a, H = the end state);
//   3. the `cluster` consecutive chunks of a (row, tile) form one cluster
//      along S; after a cluster barrier each block reads the aggregates of
//      the blocks before it from their shared memory (distributed shared
//      memory) and composes its incoming carry in chunk order,
//      carry_c = A_{c-1} * carry_{c-1} + H_{c-1}, from the cluster's own
//      incoming carry;
//   4. it walks the chunk again from shared memory with that carry and
//      writes h.
// a and bx are read from device memory once and h is written once.  When S
// holds more chunks than one cluster, the cluster walks S in windows of
// `cluster` chunks: each block composes all of the window's aggregates (the
// same chain in every block) to get the next window's carry, and prefetches
// its next window's chunk into a second stage of shared memory while it
// works on this one.  No global flags, memsets or scheduling order are
// needed, and the carries are composed in one fixed order, so two launches
// on the same inputs give the same bits.  Inside a chunk the arithmetic is
// the serial fmaf chain of the first design; only the composition of chunk
// carries adds an association order.
//
// Where W is not a multiple of a 16-byte vector or a pointer is not 16-byte
// aligned, each thread loads its own channel's column with plain loads
// instead of cp.async (same arithmetic; not on the main path, whose W is
// 4096).
//
// Why CUDA C++ and not Triton: the port builds every kernel with nvcc into
// a plain C library bound with ctypes, and this keeps to that one build
// path; the cluster launch, its barrier and the reads of another block's
// shared memory are CUDA's own (Triton exposes none of them).
//
// scripts/rglru_chunk_sweep.py times every chunk length, and this handoff
// against a decoupled look-back over flags in device memory
// (scripts/rglru_lookback.cu, the same chunk body): on an H100 the cluster
// at the chunk rglru_chunks picks is faster than the look-back at any chunk
// on every shape it times.

#include <cooperative_groups.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;   // channels per block, one thread each
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxChunk = 64;   // longest chunk the shared memory is sized for
constexpr int kMaxStages = 2;   // chunks in flight per block when S needs several windows
constexpr int kAggBytes = 2 * 2 * kThreads * static_cast<int>(sizeof(float));

// Dynamic shared memory: the aggregates (two windows' parity x {A, H} x
// kThreads fp32), then `stages` x {a, bx} x chunk x kThreads of T.
template <typename T>
constexpr int smem_bytes(int chunk, int stages) {
  return kAggBytes + stages * 2 * chunk * kThreads * static_cast<int>(sizeof(T));
}

template <typename T>
struct Args {
  const T* a;
  const T* bx;
  T* h;
  float* final_state;  // may be null
  int S, W, chunk, windows;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Issue the loads of one chunk, n steps from `base` (the chunk's first step
// at the tile's first channel), into sa / sb ([n][kThreads] of T), and
// commit them as one cp.async group.  With kVec each 16-byte piece of a row
// is one cp.async; otherwise each thread copies its own channel.
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(T* sa, T* sb, const T* __restrict__ a,
                                           const T* __restrict__ bx, size_t base, int n,
                                           int W, int tile_w) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per copy
    const int per_row = tile_w / kPer;  // W and the tile start are multiples of kPer
    for (int idx = threadIdx.x; idx < n * per_row; idx += kThreads) {
      const int i = idx / per_row;
      const int c = (idx - i * per_row) * kPer;
      const size_t g = base + static_cast<size_t>(i) * W + c;
      repro::cp_async16(smem_u32(sa + i * kThreads + c), a + g, true);
      repro::cp_async16(smem_u32(sb + i * kThreads + c), bx + g, true);
    }
  } else {
    const int tid = threadIdx.x;
    if (tid < tile_w) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const size_t g = base + static_cast<size_t>(i) * W + tid;
        sa[i * kThreads + tid] = a[g];
        sb[i * kThreads + tid] = bx[g];
      }
    }
  }
  repro::cp_async_commit();
}

// The chunk's aggregate from a zero carry, A = prod a_i and H = the end
// state, stored at agg[threadIdx.x] and agg[kThreads + threadIdx.x].
template <typename T>
__device__ __forceinline__ void chunk_aggregate(const T* sa, const T* sb, int n, float* agg) {
  float A = 1.f, H = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float av = repro::to_f32(sa[i * kThreads + threadIdx.x]);
    A *= av;
    H = fmaf(av, H, repro::to_f32(sb[i * kThreads + threadIdx.x]));
  }
  agg[threadIdx.x] = A;
  agg[kThreads + threadIdx.x] = H;
}

// Walk the chunk from `carry`, writing h at `out` (the chunk's first step
// at this thread's channel) when `valid`; returns the end carry.
template <typename T>
__device__ __forceinline__ float chunk_walk(const T* sa, const T* sb, int n, float carry,
                                            T* __restrict__ out, int W, bool valid) {
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    carry = fmaf(repro::to_f32(sa[i * kThreads + threadIdx.x]), carry,
                 repro::to_f32(sb[i * kThreads + threadIdx.x]));
    if (valid) repro::store_f32(out + static_cast<size_t>(i) * W, carry);
  }
  return carry;
}

// Grid (W tiles, cluster, B), clusters of (1, cluster, 1): block y of a
// cluster takes chunk k * cluster + y of window k.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) rglru_chunk_kernel(const Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* agg = reinterpret_cast<float*>(smem);
  T* stages_base = reinterpret_cast<T*>(smem + kAggBytes);
  const int G = gridDim.y;
  const int rank = blockIdx.y;
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * kThreads;
  const int tile_w = min(kThreads, p.W - w0);
  const bool valid = tid < tile_w;
  const int L = p.chunk;
  const int stages = min(p.windows, kMaxStages);
  const size_t row = static_cast<size_t>(blockIdx.z) * p.S * p.W;

  auto steps = [&](int k) {  // (first step, length) of this block's chunk in window k
    const int t0 = (k * G + rank) * L;
    return make_int2(t0, max(0, min(L, p.S - t0)));
  };
  auto stage = [&](int k, int which) {
    return stages_base + (static_cast<size_t>(k % stages) * 2 + which) * L * kThreads;
  };
  auto issue = [&](int k) {
    const int2 c = steps(k);
    load_chunk<T, kVec>(stage(k, 0), stage(k, 1), p.a, p.bx,
                        row + static_cast<size_t>(c.x) * p.W + w0, c.y, p.W, tile_w);
  };

  for (int k = 0; k < stages; ++k) issue(k);
  float window_carry = 0.f;
  for (int k = 0; k < p.windows; ++k) {
    if (k + 1 < min(p.windows, k + stages)) {
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const int2 c = steps(k);
    const T* sa = stage(k, 0);
    const T* sb = stage(k, 1);
    float* mine = agg + (k & 1) * 2 * kThreads;
    chunk_aggregate(sa, sb, c.y, mine);
    cluster.sync();
    // The chain over the window's chunks, in order: the carry into this
    // chunk is its value before link `rank`, the next window's after all.
    // Every link's aggregate is read before the chain starts, so the reads
    // of other blocks' shared memory overlap.
    const int links = k + 1 < p.windows ? G : rank;
    float ra[kMaxCluster], rh[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < links) {
        const float* other = cluster.map_shared_rank(mine, j);
        ra[j] = other[tid];
        rh[j] = other[kThreads + tid];
      }
    }
    float carry_in = window_carry, chain = window_carry;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < links) {
        chain = fmaf(ra[j], chain, rh[j]);
        if (j + 1 == rank) carry_in = chain;
      }
    }
    T* out = p.h + row + static_cast<size_t>(c.x) * p.W + w0 + tid;
    const float end = chunk_walk(sa, sb, c.y, carry_in, out, p.W, valid);
    if (p.final_state != nullptr && valid && c.y > 0 && c.x + c.y == p.S)
      p.final_state[static_cast<size_t>(blockIdx.z) * p.W + w0 + tid] = end;
    window_carry = chain;
    __syncthreads();  // every thread is done with this stage before it refills
    if (k + stages < p.windows) issue(k + stages);
  }
  cluster.sync();  // no block leaves while another may still read its aggregates
}

template <typename T, bool kVec>
cudaError_t launch(const Args<T>& p, int B, int cluster, cudaStream_t stream) {
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const auto kernel = rglru_chunk_kernel<T, kVec>;
  cudaError_t err =
      repro::allow_dynamic_smem(kernel, smem_bytes<T>(kMaxChunk, kMaxStages), smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.W + kThreads - 1) / kThreads, cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>(p.chunk, std::min(p.windows, kMaxStages));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* bx, void* h, float* final_state, int B, int S,
                     int W, int chunk, int cluster, cudaStream_t stream) {
  const int n_chunks = (S + chunk - 1) / chunk;
  const Args<T> p{static_cast<const T*>(a), static_cast<const T*>(bx), static_cast<T*>(h),
                  final_state, S, W, chunk, (n_chunks + cluster - 1) / cluster};
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const bool vec = W % kPer == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bx) % 16 == 0;
  return vec ? launch<T, true>(p, B, cluster, stream) : launch<T, false>(p, B, cluster, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  final_state may be null.
// `chunk` in [1, 64] steps per block, `cluster` in [1, 8] chunks per
// cluster, at most the number of chunks.  Returns the cudaError_t of the
// launch.
extern "C" int repro_rglru_scan(const void* a, const void* bx, void* h, float* final_state,
                                int B, int S, int W, int is_bf16, int chunk, int cluster,
                                void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || chunk < 1 || chunk > kMaxChunk ||
      cluster < 1 || cluster > kMaxCluster || cluster > (S + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(a, bx, h, final_state, B, S, W, chunk, cluster, s)
              : dispatch<float>(a, bx, h, final_state, B, S, W, chunk, cluster, s);
  return static_cast<int>(err);
}

// Registers, spill bytes, shared memory at one stage of `which / 2` steps
// and resident blocks per SM of the body for fp32 (which % 2 == 0) or bf16
// inputs, on the 16-byte copy path.
extern "C" int repro_rglru_scan_info(int which, int* out) {
  const int chunk = which / 2;
  if (chunk < 1 || chunk > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> smem_f32[repro::kMaxDevices], smem_bf16[repro::kMaxDevices];
  cudaError_t err;
  if (which % 2) {
    const auto k = rglru_chunk_kernel<__nv_bfloat16, true>;
    err = repro::allow_dynamic_smem(k, smem_bytes<__nv_bfloat16>(kMaxChunk, kMaxStages),
                                    smem_bf16);
    if (err == cudaSuccess)
      err = repro::kernel_info(k, kThreads, smem_bytes<__nv_bfloat16>(chunk, 1), out);
  } else {
    const auto k = rglru_chunk_kernel<float, true>;
    err = repro::allow_dynamic_smem(k, smem_bytes<float>(kMaxChunk, kMaxStages), smem_f32);
    if (err == cudaSuccess)
      err = repro::kernel_info(k, kThreads, smem_bytes<float>(chunk, 1), out);
  }
  return static_cast<int>(err);
}
