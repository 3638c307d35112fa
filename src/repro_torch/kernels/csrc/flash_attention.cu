// Flash attention forward (GQA; causal and sliding-window masks; optional
// explicit positions) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// `flash_mha` (kernel body `_kernel`, :30).  Same function as the plain
// version `mha_ref` in kernels/ref.py.
//
// Layouts: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), out (B, Sq, Hq, D), all
// contiguous, fp32 or bf16; query head h reads KV head h / (Hq / Hkv).
//
// Design.  One block per (64-query tile, query head, batch row).  The TPU
// kernel's sequential ("arbitrary") KV grid axis becomes a loop inside the
// block, carrying the online-softmax state (row max m, row sum l, output
// accumulator) in fp32 registers.  Without explicit positions the loop
// visits only KV tiles holding an unmasked key under the same causal and
// window rule as flash_attention.py:44-50; with positions it visits every
// tile and masks by position (the TPU kernel drops the positions, :94).
// Ragged edges are masked in the kernel: keys at or past Skv weigh 0, query
// rows past Sq are not stored.
//
// What bounds it on this card: at the prefill shapes (S of a few hundred,
// D = 64 or 256) the work is ~4*D flops per unmasked (query, key) pair
// against 2*D*(Hq+2*Hkv+Hq)/Hq bytes per query, so the tensor-core
// roofline says operations.
//
// bf16 inputs run the tensor-core tile body of attn_tile.cuh (bf16 tiles
// in 128-byte-swizzled shared memory, cp.async, wgmma for both products, P
// kept in registers; 97 KiB of shared memory at D = 256, two blocks per
// SM), which flash_mha_varlen's bf16 kernel shares.  fp32 inputs keep the
// first design below: both products as fp32 FMAs from shared memory
// (256 threads; each owns 4 query rows x 4 keys of the score tile and 4
// rows x D/16 columns of the accumulator), bound by shared-memory loads
// feeding the FMAs, so that fp32 stays exact to ~1e-6 (neither bf16 nor
// TF32 products would).  Its tiles are staged as fp32 with one padding
// column, so every column read is bank-conflict free; at D = 256 the three
// staged tiles take 214,528 bytes, one block per SM.

#include <math.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads: ty -> 4 query rows, tx -> 4 keys

template <int D>
constexpr int smem_bytes() {
  return (3 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1)) * 4 + (kBlockQ + kBlockK) * 4;
}

template <typename T, int D, bool kHasPos>
__global__ void __launch_bounds__(kThreads)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                 int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                 float scale) {
  constexpr int LD = D + 1;        // padded row stride of the Q/K/V tiles
  constexpr int LDP = kBlockK + 1;  // padded row stride of the P tile
  constexpr int DC = D / 16;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * LD;
  float* sV = sK + kBlockK * LD;
  float* sP = sV + kBlockK * LD;
  int* sQpos = reinterpret_cast<int*>(sP + kBlockQ * LDP);
  int* sKpos = sQpos + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    sQ[r * LD + d] =
        qi < Sq ? repro::to_f32(q[((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D + d]) : 0.f;
  }
  if (kHasPos) {
    for (int i = tid; i < kBlockQ; i += kThreads)
      sQpos[i] = q0 + i < Sq ? q_pos[static_cast<size_t>(b) * Sq + q0 + i] : 0;
  }

  const int n_tiles = (Skv + kBlockK - 1) / kBlockK;
  int kt_begin = 0, kt_end = n_tiles;
  if (!kHasPos) {
    // the tile skip of flash_attention.py:44-50: a tile is live when its
    // first key is not after the tile's last query (causal) and its last key
    // is within the window of the tile's first query
    if (causal) kt_end = min(kt_end, (q0 + kBlockQ - 1) / kBlockK + 1);
    if (window > 0) kt_begin = max(0, q0 - window + 1) / kBlockK;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D, kj = k0 + r;
      float xk = 0.f, xv = 0.f;
      if (kj < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kj) * Hkv + hk) * D + d;
        xk = repro::to_f32(k[off]);
        xv = repro::to_f32(v[off]);
      }
      sK[r * LD + d] = xk;
      sV[r * LD + d] = xv;
    }
    if (kHasPos) {
      for (int i = tid; i < kBlockK; i += kThreads)
        sKpos[i] = k0 + i < Skv ? kv_pos[static_cast<size_t>(b) * Skv + k0 + i] : 0;
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
      const int qp = kHasPos ? sQpos[r] : q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        float x = s[i][j] * scale;
        if (kj >= Skv) {
          x = -INFINITY;
        } else {
          const int kp = kHasPos ? sKpos[c] : kj;
          const bool ok = (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
          if (!ok) x = repro::kMaskedLogit;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // finite: every visited tile holds at least one key below Skv
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
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
    if (qi >= Sq) continue;
    // l >= 1 whenever a tile was visited; a row that saw none stores zeros
    // (possible only without positions when Sq > Skv), as the TPU kernel does
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* out = o + ((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) repro::store_f32(out + tx + 16 * c, acc[i][c] * inv);
  }
}

// The bf16 kernel: one 64-row query tile of one (head, batch row) through
// the shared tile body.
template <int D, bool kHasPos>
__global__ void __launch_bounds__(repro::attn::kThreads)
flash_mha_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos, int Sq,
                      int Skv, int Hq, int Hkv, int causal, int window, float scale_log2) {
  extern __shared__ __align__(128) char tile_smem[];
  const int q0 = blockIdx.x * repro::attn::kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const repro::attn::DenseMask<kHasPos> mask(
      kHasPos ? q_pos + static_cast<size_t>(b) * Sq : nullptr,
      kHasPos ? kv_pos + static_cast<size_t>(b) * Skv : nullptr, q0, Sq, Skv, causal, window);
  const size_t q_off = ((static_cast<size_t>(b) * Sq + q0) * Hq + h) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  repro::attn::tile<D>(q + q_off, k + kv_off, v + kv_off, o + q_off,
                       static_cast<size_t>(Hq) * D, static_cast<size_t>(Hkv) * D,
                       min(repro::attn::kTile, Sq - q0), mask, scale_log2, tile_smem);
}

// The bf16 instantiation's shared-memory opt-in, once per device.
template <int D, bool kHasPos>
cudaError_t prepare_bf16() {
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  return repro::allow_dynamic_smem(flash_mha_bf16_kernel<D, kHasPos>,
                                   repro::attn::smem_bytes<D>(), smem_set);
}

template <int D, bool kHasPos>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const int* q_pos, const int* kv_pos, int B, int Sq, int Skv, int Hq,
                        int Hkv, int causal, int window, cudaStream_t stream) {
  const cudaError_t err = prepare_bf16<D, kHasPos>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + repro::attn::kTile - 1) / repro::attn::kTile, Hq, B);
  flash_mha_bf16_kernel<D, kHasPos>
      <<<grid, repro::attn::kThreads, repro::attn::smem_bytes<D>(), stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), q_pos, kv_pos,
          Sq, Skv, Hq, Hkv, causal, window,
          repro::kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D, bool kHasPos>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
                   int Hq, int Hkv, int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err =
      repro::allow_dynamic_smem(flash_mha_kernel<T, D, kHasPos>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_mha_kernel<T, D, kHasPos><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_pos, kv_pos, Sq, Skv, Hq, Hkv, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// bf16 runs the shared tile body, fp32 the FMA kernel above.
template <int D>
cudaError_t launch_pos(const void* q, const void* k, const void* v, void* o,
                       const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
                       int Hq, int Hkv, int causal, int window, int is_bf16,
                       cudaStream_t stream) {
  if (is_bf16) {
    if (q_pos != nullptr)
      return launch_bf16<D, true>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal,
                                  window, stream);
    return launch_bf16<D, false>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal,
                                 window, stream);
  }
  if (q_pos != nullptr)
    return launch<float, D, true>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal,
                                  window, stream);
  return launch<float, D, false>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal,
                                 window, stream);
}

cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
                       int Hq, int Hkv, int D, int causal, int window, int is_bf16,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch_pos<16>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal, window, is_bf16, stream);
    case 32: return launch_pos<32>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal, window, is_bf16, stream);
    case 64: return launch_pos<64>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal, window, is_bf16, stream);
    case 128: return launch_pos<128>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal, window, is_bf16, stream);
    case 256: return launch_pos<256>(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, causal, window, is_bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q_pos/kv_pos are (B, Sq) and
// (B, Skv) int32, both null (arange positions, tile skipping) or both set.
// window <= 0 means no window.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_mha(const void* q, const void* k, const void* v, void* o,
                               const int* q_pos, const int* kv_pos, int B, int Sq,
                               int Skv, int Hq, int Hkv, int D, int causal,
                               int window, int is_bf16, void* stream) {
  if ((q_pos == nullptr) != (kv_pos == nullptr) || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_dim(q, k, v, o, q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, D,
                                     causal, window, is_bf16, s));
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the bf16 kernel without positions at head_dim D (out: 4 ints).
extern "C" int repro_flash_mha_bf16_info(int D, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
#define REPRO_INFO(d)                                                                 \
  case d:                                                                             \
    err = prepare_bf16<d, false>();                                                   \
    if (err == cudaSuccess)                                                           \
      err = repro::kernel_info(flash_mha_bf16_kernel<d, false>,                       \
                               repro::attn::kThreads,                                 \
                               repro::attn::smem_bytes<d>(), out);                    \
    break;
    REPRO_INFO(16) REPRO_INFO(32) REPRO_INFO(64) REPRO_INFO(128) REPRO_INFO(256)
#undef REPRO_INFO
  }
  return static_cast<int>(err);
}
