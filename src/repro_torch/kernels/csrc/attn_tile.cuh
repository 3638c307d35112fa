// The bf16 tensor-core tile body of the prefill attention kernels:
// flash_attention.cu (`flash_mha`) and varlen_attention.cu
// (`flash_mha_varlen`) both run one 64-row query tile per block through
// `attn::tile`, so on the same rows, keys and tile grid the two give the
// same bits.  A mask policy (`DenseMask` below, `VarlenMask` in
// varlen_attention.cu) says which keys the tile walks (k_begin, k_end,
// k_limit), each row's state (row(): its position, or its segment), each
// (row, key) pair's logit (key(), logit()) and which steps mask nothing
// (full()).
//
// Design.  One warpgroup (128 threads) per block; its four warps own 16
// query rows each.  Q, K and V lie in shared memory as bf16 in the
// 128-byte-swizzled layout wgmma reads: 64-column slabs of 64 rows x 128
// bytes, 16-byte chunk c of row r at chunk c ^ (r % 8); head_dim below 64
// is zero-padded to one slab.  3 * 64 * max(D, 64) * 2 bytes in all, and 1
// KiB of alignment slack (25 KiB at D 64, 97 KiB at D 256: two blocks per
// SM).  Loads are cp.async with zero fill past the last row; the V tile of
// step j is in flight while S = Q K^T of step j runs, and the K tile of
// step j + 1 (issued as soon as S is done with K) while the softmax and
// P V of step j run.  Both products are wgmma m64n64k16 bf16 -> fp32: S
// with Q and K from shared memory (K-major), P V with P from registers and
// V from shared memory (MN-major).  The S accumulator (16 rows x 64 keys a
// warp) is masked, scaled to log2 units, exponentiated against the running
// row max and rounded to bf16 in registers, where its layout is the A
// fragment of the second product: P never goes to shared memory.  The
// online softmax (row max m, row sum l of the fp32 P, rescale alpha) runs
// in fp32; a row's 64 keys of a step live on the 4 lanes of a quad, so row
// reductions are two xor shuffles.  The output accumulator is 16 x D fp32
// a warp (D / 2 registers a thread), normalised by 1 / l and stored as
// bf16.
//
// Semantics (as kernels/ref.py): a masked key inside the walked range gets
// the policy's logit (kMaskedLogit for the dense masks, so a row with no
// valid key averages every key; -inf for varlen), keys past the loaded
// range weigh 0, rows past n_rows are not stored, and a row that never
// met a finite logit stores zeros.  P is rounded to bf16 before P V, as the
// plain version rounds its probabilities to the value dtype.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // query rows of a block, keys of a step
constexpr int kThreads = 128;  // 4 warps x 16 query rows

// Head dims below 64 are zero-padded to one 64-column slab.
template <int D>
__host__ __device__ constexpr int padded() {
  return D < 64 ? 64 : D;
}

static_assert(kTile == kSlabRows, "a tile is one slab deep");

// Q, K and V tiles, plus the slack that aligns them to 1024 bytes (the
// swizzle repeats every 8 rows of 128 bytes).
template <int D>
constexpr int smem_bytes() {
  return 3 * kTile * padded<D>() * static_cast<int>(sizeof(bf16)) + 1024;
}

// Copy rows [0, n_valid) of a 64-row tile (row r at g + r * stride, D
// values) into the swizzled tile at s; rows past n_valid and columns past
// D are zero-filled.  Row 0 must exist (n_valid >= 1).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t s, const bf16* g, size_t stride, int n_valid,
                                          int tid) {
  constexpr int kChunks = padded<D>() / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < n_valid && c * 8 < D;
    cp_async16(s + swz(r, c), ok ? g + r * stride + c * 8 : g, ok);
  }
}

// The dense masks of flash_mha: arange positions (keys from the causal and
// window tile skip of flash_attention.py:44-50), or explicit positions
// (every tile, masked by position).  Keys at or past Skv weigh 0; an
// in-range key outside the causal or window rule gets kMaskedLogit.
template <bool kHasPos>
struct DenseMask {
  const int* q_pos;   // this batch row's (Sq,) positions (kHasPos)
  const int* kv_pos;  // this batch row's (Skv,) positions (kHasPos)
  int q0, Sq, Skv, causal, window;
  int k_begin, k_end, k_limit;  // keys walked: tiles from k_begin below k_end; loaded below k_limit

  __device__ DenseMask(const int* qp, const int* kp, int q0_, int Sq_, int Skv_, int causal_,
                       int window_)
      : q_pos(qp), kv_pos(kp), q0(q0_), Sq(Sq_), Skv(Skv_), causal(causal_), window(window_),
        k_begin(0), k_end(Skv_), k_limit(Skv_) {
    if (!kHasPos) {
      // a tile is live when its first key is not after the block's last
      // query (causal) and its last key is within the window of the block's
      // first query
      if (causal) k_end = min(k_end, ((q0 + kTile - 1) / kTile + 1) * kTile);
      if (window > 0) k_begin = max(0, q0 - window + 1) / kTile * kTile;
    }
  }
  __device__ int row(int r) const {
    if (!kHasPos) return q0 + r;
    return q0 + r < Sq ? __ldg(q_pos + q0 + r) : 0;
  }
  __device__ int key(int kj) const {
    if (!kHasPos) return kj;
    return kj < Skv ? __ldg(kv_pos + kj) : 0;
  }
  __device__ float logit(int qp, int kj, int kp, float x) const {
    if (kj >= Skv) return -INFINITY;
    const bool ok = (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
    return ok ? x : kMaskedLogit;
  }
  // every key of the step at k0 is valid for every row of the tile
  __device__ bool full(int k0) const {
    const int last_row = min(q0 + kTile, Sq) - 1;
    return !kHasPos && k0 + kTile <= Skv && (!causal || k0 + kTile - 1 <= q0) &&
           (window <= 0 || last_row - k0 < window);
  }
};

// One 64-row query tile against the keys `mask` walks, in steps of 64.
// q: row 0 of the tile, rows `q_stride` apart, n_rows of them valid; k, v:
// key 0 (the mask's key indices count from it), rows `kv_stride` apart; o:
// row 0 of the output tile, rows `q_stride` apart.  `scale_log2` is
// log2(e) / sqrt(D).  smem: smem_bytes<D>() bytes (the tiles start at its
// first 1024-byte boundary).
template <int D, class Mask>
__device__ __forceinline__ void tile(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, bf16* __restrict__ o,
                                     size_t q_stride, size_t kv_stride, int n_rows,
                                     const Mask& mask, float scale_log2, char* smem) {
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be a multiple of 16, at most 256");
  constexpr int kSlabs = padded<D>() / 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, t4 = lane & 3;  // a fragment's row group and column pair
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~static_cast<uint32_t>(1023);
  const uint32_t sK = sQ + kSlabs * kSlabBytes, sV = sK + kSlabs * kSlabBytes;

  load_tile<D>(sQ, q, q_stride, n_rows, tid);
  if (mask.k_begin < mask.k_end)
    load_tile<D>(sK, k + mask.k_begin * kv_stride, kv_stride, mask.k_limit - mask.k_begin, tid);
  cp_async_commit();

  // this thread's two rows: warp * 16 + quad and 8 below it
  const int rows[2] = {warp * 16 + quad, warp * 16 + quad + 8};
  const auto row0 = mask.row(rows[0]), row1 = mask.row(rows[1]);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kSlabs][8][4];  // columns 64 sl + 8 j + 2 t4 + {0, 1} of rows quad, quad + 8
#pragma unroll
  for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sl][j][e] = 0.f;

  for (int k0 = mask.k_begin; k0 < mask.k_end; k0 += kTile) {
    cp_async_wait<0>();
    __syncthreads();  // K of this step landed; every warp is done with the last V
    load_tile<D>(sV, v + k0 * kv_stride, kv_stride, mask.k_limit - k0, tid);
    cp_async_commit();

    // S = Q K^T: s[j] holds keys 8j + 2 t4 + {0, 1} of rows quad (0, 1) and
    // quad + 8 (2, 3)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < padded<D>() / 16; ++ks) {
      const uint32_t off = (ks >> 2) * kSlabBytes + (ks & 3) * 32;
      wgmma_ss<64, 0, 0>(s, sw128_desc(sQ + off), sw128_desc(sK + off));
    }
    wgmma_commit_and_wait();
    fence_regs(s);
    __syncthreads();  // every warp is done with K: fetch the next step's
    if (k0 + kTile < mask.k_end)
      load_tile<D>(sK, k + (k0 + kTile) * kv_stride, kv_stride, mask.k_limit - k0 - kTile, tid);
    cp_async_commit();

    // scale to log2 units and mask (a full step keeps every logit), then
    // the online-softmax update
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    if (!mask.full(k0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t4 + e;
          const int kp = mask.key(kj);
          s[j][e] = mask.logit(row0, kj, kp, s[j][e]);
          s[j][2 + e] = mask.logit(row1, kj, kp, s[j][2 + e]);
        }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      // -inf while the row has met no finite logit: its state stays 0
      const float base = mn == -INFINITY ? 0.f : mn;
      alpha[i] = exp2f(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * i + e] - base);
          s[j][2 * i + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = mn;
    }
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[sl][j][0] *= alpha[0];
        acc[sl][j][1] *= alpha[0];
        acc[sl][j][2] *= alpha[1];
        acc[sl][j][3] *= alpha[1];
      }
    // P's bf16 A fragments, keys 16 kk to 16 kk + 15, straight from s
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    cp_async_wait<1>();
    __syncthreads();  // V of this step landed (the next K may still be in flight)

    // acc += P V
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) fence_regs(acc[sl]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl)
        wgmma_rs<64, 1>(acc[sl], p[kk], sw128_desc(sV + sl * kSlabBytes + kk * 16 * 128));
    wgmma_commit_and_wait();
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) fence_regs(acc[sl]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= n_rows) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* out = o + rows[i] * q_stride + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[c / 8][c % 8][2 * i] * inv, acc[c / 8][c % 8][2 * i + 1] * inv);
  }
}

}  // namespace attn
}  // namespace repro
