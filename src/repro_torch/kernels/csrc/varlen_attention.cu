// Packed variable-length flash attention forward (GQA; block-diagonal
// segments from cu_seqlens; causal and sliding-window masks) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/varlen_attention.py
// `flash_mha_varlen` (:117; kernel body `_kernel`, :42).  Same function as
// the plain version `mha_varlen_ref` in kernels/ref.py on every row: token i
// attends token j iff both lie in the same segment of cu_seqlens (j <= i
// when causal, i - j < window when windowed).  Rows at or past cu_seqlens[B]
// form one phantom segment of their own.  Every row sees at least itself, so
// no row is fully masked.
//
// Layouts: q (T, Hq, D), k/v (T, Hkv, D), out (T, Hq, D), all contiguous,
// fp32 or bf16; cu_seqlens (B + 1,) int32 on the device, nondecreasing, with
// cu_seqlens[0] = 0 and cu_seqlens[B] <= T.  Query head h reads KV head
// h / (Hq / Hkv).
//
// Design.  One block per (64-row query tile, query head); T need not be a
// multiple of the tile.  The block first finds, by a binary search over
// cu_seqlens, each of its rows' segment [lo, hi) and keeps both bounds in
// shared memory; a key j is then in row i's segment iff lo_i <= j < hi_i,
// so no per-key segment id is needed.  The TPU kernel's per-tile segment
// ranges (scalar-prefetched, :134-139) and its skip of non-overlapping
// (q tile, k tile) pairs (:56-63) become a key range computed inside the
// block: keys from its first row's segment start (or the window's start,
// if later, on the segment's 64-key grid) to its last row (causal) or its
// last row's segment end.  The
// TPU kernel's sequential KV grid axis becomes a loop over 64-key tiles of
// that range, carrying the online-softmax state (row max m, row sum l,
// output accumulator) in fp32 registers, with the thread layout of
// flash_attention.cu.  Masked keys weigh exactly 0 (-inf logits; a row
// whose keys in a tile are all masked keeps its state), so a row's output
// does not depend on any value of another segment: bit-identical under a
// perturbation of another sequence.
//
// What bounds it on this card: at the packed train shapes (segments of a
// few hundred tokens, D = 64) the work is ~4*D flops per unmasked (query,
// key) pair, so the tensor-core roofline says operations.  bf16 inputs run
// the tensor-core tile body of attn_tile.cuh, the one flash_attention.cu's
// bf16 kernel runs, with the segment mask `VarlenMask` below; so on equal
// segments the two kernels give the same bits.  fp32 inputs keep the first
// design, both products as fp32 FMAs from shared memory as
// flash_attention.cu's fp32 kernel does, bound by shared-memory loads
// feeding the FMAs.  A backward kernel is later work.

#include <math.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads: ty -> 4 query rows, tx -> 4 keys

template <int D>
constexpr int smem_bytes() {
  return (3 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1)) * 4 + 2 * kBlockQ * 4;
}

// Index of the segment holding token t: the number of cu[1..B] <= t (B for
// a phantom token at or past cu[B]).
__device__ __forceinline__ int segment_of(const int* __restrict__ cu, int B, int t) {
  int lo = 0, hi = B;  // answer in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cu + mid + 1) <= t) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_mha_varlen_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ cu, int Tn, int B, int Hq, int Hkv,
                        int causal, int window, float scale) {
  constexpr int LD = D + 1;        // padded row stride of the Q/K/V tiles
  constexpr int LDP = kBlockK + 1;  // padded row stride of the P tile
  constexpr int DC = D / 16;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * LD;
  float* sV = sK + kBlockK * LD;
  float* sP = sV + kBlockK * LD;
  int* sLo = reinterpret_cast<int*>(sP + kBlockQ * LDP);  // row's segment [lo, hi)
  int* sHi = sLo + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int n_rows = min(kBlockQ, Tn - q0);

  if (tid < kBlockQ) {
    int lo = 0, hi = 0;  // rows past T: an empty segment, never stored
    if (tid < n_rows) {
      const int s = segment_of(cu, B, q0 + tid);
      lo = __ldg(cu + s);
      hi = s < B ? __ldg(cu + s + 1) : Tn;
    }
    sLo[tid] = lo;
    sHi[tid] = hi;
  }
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    sQ[r * LD + d] =
        qi < Tn ? repro::to_f32(q[(static_cast<size_t>(qi) * Hq + h) * D + d]) : 0.f;
  }
  __syncthreads();

  // the block's key range: segments are contiguous and rows ascend, so the
  // first row's segment starts first and the last row's ends last.  A
  // window's first key is rounded down to the 64-key grid of the segment,
  // so that B equal segments walk the tiles flash_attention.cu walks on the
  // (B, S) layout, in the same order (the same bits)
  int k_begin = sLo[0];
  if (window > 0) k_begin += max(0, q0 - window + 1 - k_begin) / kBlockK * kBlockK;
  const int k_end = causal ? q0 + n_rows : sHi[n_rows - 1];

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D, kj = k0 + r;
      float xk = 0.f, xv = 0.f;
      if (kj < k_end) {
        const size_t off = (static_cast<size_t>(kj) * Hkv + hk) * D + d;
        xk = repro::to_f32(k[off]);
        xv = repro::to_f32(v[off]);
      }
      sK[r * LD + d] = xk;
      sV[r * LD + d] = xv;
    }
    __syncthreads();

    // S = Q K^T: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // mask, then the online-softmax update; a row's 64 keys live on the 16
    // lanes that share its ty, so row reductions are xor-shuffles over 16
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
      const int lo = sLo[r], hi = sHi[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj >= lo && kj < hi && kj < k_end && (!causal || kj <= qi) &&
                        (window <= 0 || qi - kj < window);
        const float x = ok ? s[i][j] * scale : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      // -inf while the row has met no key of its own: its state stays 0
      const float base = mn == -INFINITY ? 0.f : mn;
      alpha[i] = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - base);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = mn;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc = acc * alpha + P V: rows ty*4 + i, columns tx + 16*c
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = sV[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Tn) continue;
    const float inv = 1.f / l[i];  // l >= 1: every row sees its own key
    T* out = o + (static_cast<size_t>(qi) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) repro::store_f32(out + tx + 16 * c, acc[i][c] * inv);
  }
}

// The segment mask of the bf16 kernel: row i's keys are its segment
// [lo, hi) (found by segment_of), below it when causal and within the
// window; every other key gets -inf, so no other segment's values reach a
// row's sums.  The walked range is the fp32 kernel's: from the first row's
// segment start (the window's start if later, on the segment's 64-key
// grid) to the last row (causal) or its segment's end.
struct VarlenMask {
  struct Row {
    int pos, lo, hi;
  };
  const int* cu;
  int B, Tn, q0, n_rows, causal, window;
  int k_begin, k_end, k_limit;
  int lo, hi;  // the rows' one segment, if they share one (else lo > hi)

  __device__ VarlenMask(const int* cu_, int B_, int Tn_, int q0_, int causal_, int window_)
      : cu(cu_), B(B_), Tn(Tn_), q0(q0_), n_rows(min(repro::attn::kTile, Tn_ - q0_)),
        causal(causal_), window(window_) {
    const Row first = row(0), last = row(n_rows - 1);
    k_begin = first.lo;
    if (window > 0)
      k_begin += max(0, q0 - window + 1 - k_begin) / repro::attn::kTile * repro::attn::kTile;
    k_end = causal ? q0 + n_rows : last.hi;
    k_limit = k_end;
    lo = first.lo == last.lo ? first.lo : 1;
    hi = first.lo == last.lo ? first.hi : 0;
  }
  __device__ Row row(int r) const {
    if (r >= n_rows) return {0, 0, 0};  // rows past T: an empty segment, never stored
    const int t = q0 + r, s = segment_of(cu, B, t);
    return {t, __ldg(cu + s), s < B ? __ldg(cu + s + 1) : Tn};
  }
  __device__ int key(int kj) const { return kj; }
  __device__ float logit(const Row& r, int kj, int, float x) const {
    const bool ok = kj >= r.lo && kj < r.hi && (!causal || kj <= r.pos) &&
                    (window <= 0 || r.pos - kj < window);
    return ok ? x : -INFINITY;
  }
  // every key of the step at k0 lies in the rows' one segment and is valid
  // for each of them
  __device__ bool full(int k0) const {
    constexpr int kT = repro::attn::kTile;
    return lo <= k0 && k0 + kT <= hi && (!causal || k0 + kT - 1 <= q0) &&
           (window <= 0 || q0 + n_rows - 1 - k0 < window);
  }
};

template <int D>
__global__ void __launch_bounds__(repro::attn::kThreads)
flash_mha_varlen_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                             const int* __restrict__ cu, int Tn, int B, int Hq, int Hkv,
                             int causal, int window, float scale_log2) {
  extern __shared__ __align__(128) char tile_smem[];
  const int q0 = blockIdx.x * repro::attn::kTile;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const VarlenMask mask(cu, B, Tn, q0, causal, window);
  const size_t q_off = (static_cast<size_t>(q0) * Hq + h) * D;
  repro::attn::tile<D>(q + q_off, k + hk * D, v + hk * D, o + q_off,
                       static_cast<size_t>(Hq) * D, static_cast<size_t>(Hkv) * D, mask.n_rows,
                       mask, scale_log2, tile_smem);
}

// The bf16 instantiation's shared-memory opt-in, once per device.
template <int D>
cudaError_t prepare_bf16() {
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  return repro::allow_dynamic_smem(flash_mha_varlen_bf16_kernel<D>,
                                   repro::attn::smem_bytes<D>(), smem_set);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const int* cu,
                        int Tn, int B, int Hq, int Hkv, int causal, int window,
                        cudaStream_t stream) {
  const cudaError_t err = prepare_bf16<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + repro::attn::kTile - 1) / repro::attn::kTile, Hq);
  flash_mha_varlen_bf16_kernel<D>
      <<<grid, repro::attn::kThreads, repro::attn::smem_bytes<D>(), stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), cu, Tn, B, Hq,
          Hkv, causal, window, repro::kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* cu,
                   int Tn, int B, int Hq, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err =
      repro::allow_dynamic_smem(flash_mha_varlen_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + kBlockQ - 1) / kBlockQ, Hq);
  flash_mha_varlen_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), cu, Tn, B, Hq, Hkv, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// bf16 runs the shared tile body, fp32 the FMA kernel above.
template <int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, const int* cu,
                         int Tn, int B, int Hq, int Hkv, int causal, int window, int is_bf16,
                         cudaStream_t stream) {
  if (is_bf16) return launch_bf16<D>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, stream);
  return launch<float, D>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, stream);
}

cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o, const int* cu,
                       int Tn, int B, int Hq, int Hkv, int D, int causal, int window,
                       int is_bf16, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<16>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, is_bf16, stream);
    case 32: return launch_typed<32>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, is_bf16, stream);
    case 64: return launch_typed<64>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, is_bf16, stream);
    case 128: return launch_typed<128>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, is_bf16, stream);
    case 256: return launch_typed<256>(q, k, v, o, cu, Tn, B, Hq, Hkv, causal, window, is_bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  cu_seqlens: (B + 1,) int32 on
// the device.  window <= 0 means no window.  Returns the cudaError_t of the
// launch.
extern "C" int repro_flash_mha_varlen(const void* q, const void* k, const void* v, void* o,
                                      const int* cu_seqlens, int Tn, int B, int Hq, int Hkv,
                                      int D, int causal, int window, int is_bf16,
                                      void* stream) {
  if (Tn <= 0 || B <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      launch_dim(q, k, v, o, cu_seqlens, Tn, B, Hq, Hkv, D, causal, window, is_bf16, s));
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the bf16 kernel at head_dim D (out: 4 ints).
extern "C" int repro_flash_mha_varlen_bf16_info(int D, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
#define REPRO_INFO(d)                                                                 \
  case d:                                                                             \
    err = prepare_bf16<d>();                                                          \
    if (err == cudaSuccess)                                                           \
      err = repro::kernel_info(flash_mha_varlen_bf16_kernel<d>,                       \
                               repro::attn::kThreads,                                 \
                               repro::attn::smem_bytes<d>(), out);                    \
    break;
    REPRO_INFO(16) REPRO_INFO(32) REPRO_INFO(64) REPRO_INFO(128) REPRO_INFO(256)
#undef REPRO_INFO
  }
  return static_cast<int>(err);
}
