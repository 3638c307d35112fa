// Mamba-2 SSD (state-space duality) chunked scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py `ssd_pallas`
// (:76; kernel body `_kernel`, :26).  Same function as the plain version
// `ssd_ref` in kernels/ref.py:
//   h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T,  y_t = h_t C_t + D x_t,
// with A = -exp(a_log), per head, ngroups = 1 (B and C shared by all heads).
//
// Layouts: x (B, S, H, P) and y (B, S, H, P) in T (fp32 or bf16); dt
// (B, S, H) fp32 (softplus-ed); a_log, d (H,) fp32; b, c (B, S, N) in T;
// the final state (B, H, P, N) fp32 (optional).  All contiguous.
//
// The TPU kernel walks the chunks of one (row, head) on a sequential grid
// axis with the (P, N) state in VMEM scratch.  Here a block loops over the
// sequence itself in pieces of its own length, the state kept on chip in
// fp32.  The chunked form is exact in real arithmetic for any piece length,
// so the model's chunk only fixes the caller's padding.  Rows past S load
// as zeros with dt = 0 (decay 1 and no input: an exact no-op) and are not
// stored.  exp is evaluated only where t >= i: above the diagonal
// cum_t - cum_i is positive and may overflow, and inf * 0 would be NaN
// (the TPU kernel's where(tri, exp(seg), 0) evaluates it everywhere).
//
// bf16: a tensor-core body, `ssd_scan_tc_kernel`, grid (p_splits, H, B).
// A block owns one (row, head) and P / p_splits columns of y and the
// matching rows of the state (p_splits in {1, 2, 4}, from the host's
// kernels/ssd_scan.py `ssd_splits`, so that a 1-row admission still fills
// the card).  It walks 128-row pieces, the model's chunk and the plain
// version's decomposition, with two warpgroups: warpgroup g owns piece rows
// 64 g .. 64 g + 63 of y and state rows n = 64 g .. 64 g + 63.  Per piece:
//   1. S = C B^T (wgmma m64n64k16; C and B exact bf16, fp32 sums);
//   2. M[t][i] = S[t][i] exp(cum_t - cum_i) dt_i (t >= i, else 0) in fp32
//      registers, as one exp2 of (cum_t - cum_i) log2(e) + log2(dt_i), then
//      as two bf16 terms M_hi = bf16(M), M_lo = bf16(M - M_hi) in the A
//      fragment layout, as the attention tile keeps P.  A warp's 16 rows
//      are one 16-row block: key blocks before it lie wholly below the
//      diagonal (no mask), those after it wholly above (0, no exp);
//   3. y = exp(cum_t) (C state_hi^T + C state_lo^T) + M_hi X + M_lo X +
//      D x, rounded once to bf16 (A from registers, B = X^T);
//   4. state^T = exp(cum_last) state^T + B^T (X w)_hi + B^T (X w)_lo, with
//      w_i = dt_i exp(cum_last - cum_i): A = B^T is the B tile read
//      MN-major (wgmma's transpose of A), and the accumulator, state^T in
//      fp32, stays in registers from piece to piece.
// Both warpgroups issue the same wgmma sequence, over all 128 keys (M is 0
// past warpgroup 0's rows): a warpgroup-uniform branch between wgmmas
// made ptxas fence them and ran slower.  No fp32 value enters a
// product as one bf16: M, the state and X w each go in as hi + lo (~2^-17
// of the value).  C and B lie in shared memory as 128 x 128 bf16 tiles of
// 128-byte-swizzled 64-column slabs, X^T, (X w)^T hi/lo and state^T hi/lo
// as (P / p_splits) x 128 K-major tiles that the threads write (X
// transposed from its raw tile, the state stored from the accumulators at
// the top of each piece).  The next piece's C and B (into the other of two
// buffers) and raw X are fetched by cp.async, and its dt loaded, while
// this piece's products run; the state update stays in flight while M is
// formed.  The inclusive cumsum of dt A over the piece is a 128-thread scan
// in fixed order.  Column p's arithmetic is the same in every split and at
// any B, so y and the state do not depend on p_splits or on the batch.
// C B^T is recomputed by every block (each head and p split): 4.2 MFLOP a
// piece, ~0.6 us of an SM's tensor rate, where reading a 64 KB fp32 S back
// from L2 would take longer at an SM's share of the L2 rate.
//
// fp32: the first design (`ssd_scan_kernel`), one block per (head, row),
// 64-row pieces, every product in fp32 FMAs from shared memory, since
// neither bf16 nor TF32 products hold fp32's tolerance.
//
// What bounds it on this card: per 128-row piece and head ~17 MFLOP of
// tensor-core work with the hi/lo terms against ~80 KB of input, far above
// the ~295 flop/byte ridge: operations.  4.2 MFLOP of it (C B^T) is shared
// by the heads and recomputed, and the sequential dependence between
// pieces (the state) sets the rest.  In this body the CUDA-core work of a
// piece (M's exponentials and hi/lo terms, the transposes, the state's
// stores), on 8 warps a block, takes longer than its wgmmas.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"


namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;  // rows per piece

template <int P, int N>
constexpr int smem_floats() {
  // sC, sB (kQ x N+1), sX (kQ x P+1), state (P x N+1), M (kQ x kQ+1), cum, dt, w
  return 2 * kQ * (N + 1) + kQ * (P + 1) + P * (N + 1) + kQ * (kQ + 1) + 3 * kQ;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ dvec,
                float* __restrict__ y, float* __restrict__ state_out, int S, int H) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  constexpr int LDN = N + 1, LDP = P + 1, LDQ = kQ + 1;
  constexpr int TP = P / 16, TN = N / 16;
  extern __shared__ float smem[];
  float* sC = smem;               // kQ x LDN
  float* sB = sC + kQ * LDN;      // kQ x LDN
  float* sX = sB + kQ * LDN;      // kQ x LDP
  float* sS = sX + kQ * LDP;      // P x LDN, the running state
  float* sM = sS + P * LDN;       // kQ x LDQ
  float* sCum = sM + kQ * LDQ;    // inclusive cumsum of dt * A
  float* sDt = sCum + kQ;         // dt
  float* sW = sDt + kQ;           // dt * exp(cum_last - cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float A = -expf(a_log[h]);
  const float Dh = dvec[h];
  for (int i = tid; i < P * LDN; i += kThreads) sS[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int rows = min(kQ, S - t0);
    __syncthreads();  // the previous piece is consumed
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float cv = 0.f, bv = 0.f;
      if (r < rows) {
        const size_t off = (static_cast<size_t>(b) * S + t0 + r) * N + n;
        cv = repro::to_f32(cm[off]);
        bv = repro::to_f32(bm[off]);
      }
      sC[r * LDN + n] = cv;
      sB[r * LDN + n] = bv;
    }
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i % P;
      sX[r * LDP + p] =
          r < rows ? repro::to_f32(x[((static_cast<size_t>(b) * S + t0 + r) * H + h) * P + p])
                   : 0.f;
    }
    if (tid < 32) {  // warp 0: dt, the inclusive cumsum of dt * A, and w
      const int r0 = tid, r1 = tid + 32;
      const float d0 = r0 < rows ? dt[(static_cast<size_t>(b) * S + t0 + r0) * H + h] : 0.f;
      const float d1 = r1 < rows ? dt[(static_cast<size_t>(b) * S + t0 + r1) * H + h] : 0.f;
      float c0 = d0 * A, c1 = d1 * A;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
        if (tid >= off) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      sDt[r0] = d0;
      sDt[r1] = d1;
      sCum[r0] = c0;
      sCum[r1] = c1;
      sW[r0] = d0 * expf(last - c0);
      sW[r1] = d1 * expf(last - c1);
    }
    __syncthreads();

    // 1. M = (C B^T) * decay * dt on and below the diagonal: rows ty + 16i,
    //    columns tx + 16j
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          sM[t * LDQ + c] = t >= c ? s[i][j] * expf(sCum[t] - sCum[c]) * sDt[c] : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. y: rows ty + 16i, columns tx + 16j
    {
      float dg[4][TP], of[4][TP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) dg[i][j] = of[i][j] = 0.f;
      const int i_end = ty + 16 * 3 + 1;  // M is 0 past the thread's last row
#pragma unroll 4
      for (int c = 0; c < i_end; ++c) {
        float mv[4], xv[TP];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = sM[(ty + 16 * i) * LDQ + c];
#pragma unroll
        for (int j = 0; j < TP; ++j) xv[j] = sX[c * LDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) dg[i][j] = fmaf(mv[i], xv[j], dg[i][j]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[TP];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < TP; ++j) sv[j] = sS[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) of[i][j] = fmaf(cv[i], sv[j], of[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= rows) continue;
        const float e = expf(sCum[t]);
        float* out = y + ((static_cast<size_t>(b) * S + t0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const int p = tx + 16 * j;
          repro::store_f32(out + p, dg[i][j] + e * of[i][j] + Dh * sX[t * LDP + p]);
        }
      }
    }
    __syncthreads();  // the state is read by every thread above

    // 3. state = exp(cum_last) state + sum_i x_i w_i B_i: p = ty + 16a, n = tx + 16c
    {
      const float decay = expf(sCum[kQ - 1]);
      float st[TP][TN];
#pragma unroll
      for (int a = 0; a < TP; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) st[a][c] = sS[(ty + 16 * a) * LDN + tx + 16 * c] * decay;
#pragma unroll 4
      for (int i = 0; i < kQ; ++i) {
        const float w = sW[i];
        float xv[TP], bv[TN];
#pragma unroll
        for (int a = 0; a < TP; ++a) xv[a] = sX[i * LDP + ty + 16 * a] * w;
#pragma unroll
        for (int c = 0; c < TN; ++c) bv[c] = sB[i * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < TP; ++a)
#pragma unroll
          for (int c = 0; c < TN; ++c) st[a][c] = fmaf(xv[a], bv[c], st[a][c]);
      }
#pragma unroll
      for (int a = 0; a < TP; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) sS[(ty + 16 * a) * LDN + tx + 16 * c] = st[a][c];
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* out = state_out + (static_cast<size_t>(b) * H + h) * P * N;
    for (int i = tid; i < P * N; i += kThreads) out[i] = sS[(i / N) * LDN + i % N];
  }
}

template <int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* a_log, const void* bm,
                   const void* cm, const float* dvec, void* y, float* state_out, int B,
                   int S, int H, cudaStream_t stream) {
  constexpr int smem = smem_floats<P, N>() * 4;
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err = repro::allow_dynamic_smem(ssd_scan_kernel<P, N>, smem, smem_set);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<P, N><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, a_log, static_cast<const float*>(bm),
      static_cast<const float*>(cm), dvec, static_cast<float*>(y), state_out, S, H);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;     // rows of a piece
constexpr int kThreads = 256;  // two warpgroups
constexpr int kN = 128;        // N, the state width
constexpr int kP = 64;         // P, the head dim

// Byte offset of 16-byte chunk c (0..15) of row r (0..127) in a 128 x 128
// bf16 tile: two 64-row blocks of two 64-column slabs.
__device__ __forceinline__ uint32_t sq_off(int r, int c) {
  return static_cast<uint32_t>((r >> 6) * 2 * repro::kSlabBytes) + repro::swz(r & 63, c);
}

// Byte offset of chunk c (0..15) of row r (0..PB-1) in a PB x 128 bf16 tile:
// two 64-column slabs of PB rows.
template <int PB>
__device__ __forceinline__ uint32_t pt_off(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * PB * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Byte offsets of the shared memory at PB = P / p_splits columns, from its
// first 1024-byte boundary.  C and B are double-buffered by piece.
template <int PB>
struct Smem {
  static constexpr int kSq = 2 * 2 * repro::kSlabBytes;  // a 128 x 128 tile
  static constexpr int kPt = 2 * PB * 128;               // a PB x 128 tile
  static constexpr int kCB = 0;               // 2 x (C rows t, B rows i; columns n)
  static constexpr int kXt = kCB + 4 * kSq;   // X^T, rows p, columns i
  static constexpr int kWh = kXt + kPt;       // (X w)^T hi
  static constexpr int kWl = kWh + kPt;       // (X w)^T lo
  static constexpr int kSh = kWl + kPt;       // state^T hi, rows p, columns n
  static constexpr int kSl = kSh + kPt;       // state^T lo
  static constexpr int kXr = kSl + kPt;       // X as loaded: rows i, 128 bytes each
  static constexpr int kCL = kXr + kRows * 128;  // fp32 pairs: cumsum of dt A, log2 dt
  static constexpr int kW = kCL + kRows * 8;  // dt exp(cum_last - cum)
  static constexpr int kTot = kW + kRows * 4; // the scan's 4 warp totals
  static constexpr int kBytes = kTot + 16 + 1024;  // and the alignment slack
  static_assert(PB % 8 == 0 && kPt % 1024 == 0, "tiles must stay 1024-byte aligned");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// Byte offset of 16-byte chunk c of row r of raw X: rows of 128 bytes, the
// chunk swizzled by the row so that a warp reading one chunk of 32 rows
// meets no bank conflict.
__device__ __forceinline__ uint32_t xr_off(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

template <int PB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_log, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, const float* __restrict__ dvec,
                   bf16* __restrict__ y, float* __restrict__ state_out, int S, int H) {
  using L = Smem<PB>;
  constexpr int NT = PB / 8;  // 8-column n-tiles of a PB-wide accumulator
  extern __shared__ __align__(16) char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t s0 = (raw + 1023) & ~1023u;
  char* base = smem_raw + (s0 - raw);
  const uint32_t sXt = s0 + L::kXt, sWh = s0 + L::kWh, sWl = s0 + L::kWl, sSh = s0 + L::kSh,
                 sSl = s0 + L::kSl, sXr = s0 + L::kXr;
  float* sCL = reinterpret_cast<float*>(base + L::kCL);
  float* sW = reinterpret_cast<float*>(base + L::kW);
  float* sTot = reinterpret_cast<float*>(base + L::kTot);

  const int tid = threadIdx.x, g = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane >> 2, t4 = lane & 3;  // a fragment's row group and column pair
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float A = -expf(a_log[h]);
  const float Dh = dvec[h];
  // this thread's accumulator rows: r0 and r0 + 8 of its warpgroup's 64
  // (piece rows t for y, state rows n for the state)
  const int r0 = 64 * g + 16 * warp + quad;

  // The piece at t0n's C and B (into buffer (t0n / kRows) % 2) and raw X by
  // cp.async, zero past S, as one commit group; warpgroup 0's dt into d.
  auto issue_loads = [&](int t0n, float& d) {
    const int rows_n = min(kRows, S - t0n);
    const uint32_t cb = s0 + L::kCB + ((t0n / kRows) & 1) * 2 * L::kSq;
    for (int i = tid; i < kRows * (kN / 8); i += kThreads) {
      const int r = i / (kN / 8), c = i % (kN / 8);
      const bool ok = r < rows_n;
      const size_t off = (static_cast<size_t>(b) * S + t0n + (ok ? r : 0)) * kN + c * 8;
      repro::cp_async16(cb + sq_off(r, c), cm + off, ok);
      repro::cp_async16(cb + L::kSq + sq_off(r, c), bm + off, ok);
    }
    for (int i = tid; i < kRows * (PB / 8); i += kThreads) {
      const int r = i / (PB / 8), c = i % (PB / 8);
      const bool ok = r < rows_n;
      const size_t row = (static_cast<size_t>(b) * S + t0n + (ok ? r : 0)) * H + h;
      repro::cp_async16(sXr + xr_off(r, c), x + row * kP + p0 + c * 8, ok);
    }
    repro::cp_async_commit();
    if (g == 0) d = tid < rows_n ? dt[(static_cast<size_t>(b) * S + t0n + tid) * H + h] : 0.f;
  };

  // state^T: rows n = r0 (0, 1) and r0 + 8 (2, 3), columns p0 + 8 j + 2 t4 + {0, 1}
  float st[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;

  float d = 0.f, d_next = 0.f;  // this piece's and the next piece's dt (warpgroup 0)
  issue_loads(0, d);
  for (int t0 = 0; t0 < S; t0 += kRows) {
    const int rows = min(kRows, S - t0);
    const uint32_t sC = s0 + L::kCB + ((t0 / kRows) & 1) * 2 * L::kSq, sB = sC + L::kSq;
    if (t0 > 0) __syncthreads();  // every tile of the last piece is consumed

    // the state as two bf16 terms into the (p, n) tiles
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = r0 + 8 * (e >> 1), p = 8 * j + 2 * t4 + (e & 1);
        const uint32_t at = pt_off<PB>(p, n >> 3) + (n & 7) * 2;
        const bf16 hi = __float2bfloat16(st[j][e]);
        *reinterpret_cast<bf16*>(base + L::kSh + at) = hi;
        *reinterpret_cast<bf16*>(base + L::kSl + at) =
            __float2bfloat16(__fsub_rn(st[j][e], __bfloat162float(hi)));
      }

    // the inclusive cumsum of dt A (warpgroup 0, a row a thread: each warp's
    // shuffle scan, then the warp totals before it in order) and w
    float c = d * A;
    if (g == 0) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, c, off);
        if (lane >= off) c += u;
      }
      if (lane == 31) sTot[warp] = c;
    }
    __syncthreads();
    if (g == 0) {
      float before = 0.f, last = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (w < warp) before += sTot[w];
        last += sTot[w];
      }
      const float cum = before + c;  // row 127's is `last`, bit for bit
      *reinterpret_cast<float2*>(sCL + 2 * tid) = make_float2(cum, log2f(d));
      sW[tid] = d * expf(last - cum);
    }
    repro::cp_async_wait<0>();  // this piece's C, B and raw X
    __syncthreads();

    // X^T and (X w)^T as two bf16 terms from raw X: a thread takes one row
    // i of one 8-column chunk and writes 8 elements of each tile
    for (int item = tid; item < kRows * (PB / 8); item += kThreads) {
      const int i = item % kRows, pc = item / kRows;
      const uint4 v = *reinterpret_cast<const uint4*>(base + L::kXr + xr_off(i, pc));
      const bf16* xv = reinterpret_cast<const bf16*>(&v);
      const float w = sW[i];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t at = pt_off<PB>(8 * pc + k, i >> 3) + (i & 7) * 2;
        *reinterpret_cast<bf16*>(base + L::kXt + at) = xv[k];
        const float xw = __fmul_rn(__bfloat162float(xv[k]), w);
        const bf16 hi = __float2bfloat16(xw);
        *reinterpret_cast<bf16*>(base + L::kWh + at) = hi;
        *reinterpret_cast<bf16*>(base + L::kWl + at) =
            __float2bfloat16(__fsub_rn(xw, __bfloat162float(hi)));
      }
    }
    repro::cp_async_wait<0>();  // fences this thread's tile writes for wgmma
    __syncthreads();

    // 1a. S = C B^T over all 128 keys; acc = C state_hi^T + C state_lo^T.
    //     s[jb][nt]: keys 64 jb + 8 nt + 2 t4 + {0, 1} of rows r0 (0, 1) and r0 + 8 (2, 3)
    // 1b. state^T = exp(cum_last) state^T + B^T (X w)_hi + B^T (X w)_lo, in
    //     flight while M is formed
    float s[2][8][4], acc[NT][4];
#pragma unroll
    for (int jb = 0; jb < 2; ++jb)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jb][nt][e] = 0.f;
    const float decay = expf(sCL[2 * (kRows - 1)]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = 0.f;
        st[j][e] *= decay;
      }
    repro::fence_regs(s[0]);
    repro::fence_regs(s[1]);
    repro::fence_regs(acc);
    repro::fence_regs(st);
    repro::wgmma_fence();
    const uint32_t sCg = sC + g * 2 * repro::kSlabBytes;  // this warpgroup's rows of C
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {  // k = n
      const uint32_t koff = (ks >> 2) * repro::kSlabBytes + (ks & 3) * 32;
      const uint32_t poff = (ks >> 2) * PB * 128 + (ks & 3) * 32;
      const uint64_t ca = repro::sw128_desc(sCg + koff);
      repro::wgmma_ss<64, 0, 0>(s[0], ca, repro::sw128_desc(sB + koff));
      repro::wgmma_ss<64, 0, 0>(s[1], ca, repro::sw128_desc(sB + 2 * repro::kSlabBytes + koff));
      repro::wgmma_ss<PB, 0, 0>(acc, ca, repro::sw128_desc(sSh + poff));
      repro::wgmma_ss<PB, 0, 0>(acc, ca, repro::sw128_desc(sSl + poff));
    }
    repro::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {  // k = i
      // B^T's rows n = 64 g.., keys 16 kk..: MN-major from the B tile
      const uint64_t bt = repro::sw128_desc(sB + (kk >> 2) * 2 * repro::kSlabBytes +
                                            g * repro::kSlabBytes + (kk & 3) * 16 * 128);
      const uint32_t poff = (kk >> 2) * PB * 128 + (kk & 3) * 32;
      repro::wgmma_ss<PB, 1, 0>(st, bt, repro::sw128_desc(sWh + poff));
      repro::wgmma_ss<PB, 1, 0>(st, bt, repro::sw128_desc(sWl + poff));
    }
    repro::wgmma_commit();

    // the next piece's loads, into the other C/B buffer and raw X (both free)
    if (t0 + kRows < S) issue_loads(t0 + kRows, d_next);

    repro::wgmma_wait<1>();  // S and acc are ready
    repro::fence_regs(s[0]);
    repro::fence_regs(s[1]);
    repro::fence_regs(acc);

    // 2. M = S exp(cum_t - cum_i) dt_i on and below the diagonal, as the
    //    A fragments of its two bf16 terms, keys 16 kk .. 16 kk + 15; the
    //    warp's 16 rows form row block rb, so key blocks before it lie wholly
    //    below the diagonal and those after it wholly above (0, no exp)
    const int ta = r0, tb = r0 + 8;  // piece rows of this thread
    const int rb = 4 * g + warp;
    const float cum_a = sCL[2 * ta], cum_b = sCL[2 * tb];
    uint32_t mh[8][4], ml[8][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      if (kk > rb) {  // keys past this warp's rows: M is 0
#pragma unroll
        for (int e = 0; e < 4; ++e) mh[kk][e] = ml[kk][e] = 0u;
        continue;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * (kk & 3) + half;
        const int i = 64 * (kk >> 2) + 8 * nt + 2 * t4;
        // (cum, log2 dt) of keys i and i + 1
        const float4 cl = *reinterpret_cast<const float4*>(sCL + 2 * i);
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? ta : tb, col = i + (e & 1);
          const float cum_t = e < 2 ? cum_a : cum_b;
          // exp(cum_t - cum_i) dt_i as one exp2: (cum_t - cum_i) log2(e) + log2(dt_i)
          const float arg = __fmaf_rn(cum_t - (e & 1 ? cl.z : cl.x), repro::kLog2e,
                                      e & 1 ? cl.w : cl.y);
          const float v = __fmul_rn(s[kk >> 2][nt][e], exp2f(arg));
          m[e] = kk == rb && t < col ? 0.f : v;  // above the diagonal (in its block)
        }
        repro::split_bf16(m[0], m[1], &mh[kk][2 * half], &ml[kk][2 * half]);
        repro::split_bf16(m[2], m[3], &mh[kk][2 * half + 1], &ml[kk][2 * half + 1]);
      }
    }

    // 3. acc = exp(cum_t) acc + M_hi X + M_lo X
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= ea;
      acc[j][1] *= ea;
      acc[j][2] *= eb;
      acc[j][3] *= eb;
    }
    repro::fence_regs(acc);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t xd = repro::sw128_desc(sXt + (kk >> 2) * PB * 128 + (kk & 3) * 32);
      repro::wgmma_rs<PB, 0>(acc, mh[kk], xd);
      repro::wgmma_rs<PB, 0>(acc, ml[kk], xd);
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(acc);
    repro::fence_regs(st);

    // y = acc + D x, rounded once to bf16 (x from the X^T tile)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = hh ? tb : ta;
      if (t >= rows) continue;
      const size_t row = (static_cast<size_t>(b) * S + t0 + t) * H + h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = 8 * j + 2 * t4;
        const float x0 = __bfloat162float(*reinterpret_cast<const bf16*>(
            base + L::kXt + pt_off<PB>(p, t >> 3) + (t & 7) * 2));
        const float x1 = __bfloat162float(*reinterpret_cast<const bf16*>(
            base + L::kXt + pt_off<PB>(p + 1, t >> 3) + (t & 7) * 2));
        *reinterpret_cast<__nv_bfloat162*>(y + row * kP + p0 + p) = __floats2bfloat162_rn(
            acc[j][2 * hh] + Dh * x0, acc[j][2 * hh + 1] + Dh * x1);
      }
    }
    d = d_next;
  }

  if (state_out != nullptr) {
    float* out = state_out + (static_cast<size_t>(b) * H + h) * kP * kN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(p0 + 8 * j + 2 * t4 + (e & 1)) * kN + r0 + 8 * (e >> 1)] = st[j][e];
  }
}

template <int PB>
cudaError_t prepare() {
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  return repro::allow_dynamic_smem(ssd_scan_tc_kernel<PB>, Smem<PB>::kBytes, smem_set);
}

template <int PB>
cudaError_t launch(const void* x, const float* dt, const float* a_log, const void* bm,
                   const void* cm, const float* dvec, void* y, float* state_out, int B, int S,
                   int H, cudaStream_t stream) {
  const cudaError_t err = prepare<PB>();
  if (err != cudaSuccess) return err;
  ssd_scan_tc_kernel<PB><<<dim3(kP / PB, H, B), kThreads, Smem<PB>::kBytes, stream>>>(
      static_cast<const bf16*>(x), dt, a_log, static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), dvec, static_cast<bf16*>(y), state_out, S, H);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Plain C entry point, loaded with ctypes.  state_out may be null (no final
// state).  Built for mamba2-1.3b's P = 64, N = 128 only; other widths come
// with the configuration that needs them.  bf16 takes p_splits in {1, 2,
// 4}; fp32 takes 1.  Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan(const void* x, const float* dt, const float* a_log,
                              const void* bm, const void* cm, const float* dvec, void* y,
                              float* state_out, int B, int S, int H, int P, int N,
                              int is_bf16, int p_splits, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || P != 64 || N != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (p_splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch<64, 128>(x, dt, a_log, bm, cm, dvec, y, state_out, B, S, H, s));
  }
  switch (p_splits) {
#define REPRO_CASE(ps)                                                                     \
  case ps:                                                                                 \
    return static_cast<int>(                                                               \
        tc::launch<64 / ps>(x, dt, a_log, bm, cm, dvec, y, state_out, B, S, H, s));
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(4)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the bf16 body at p_splits (out: 4 ints).
extern "C" int repro_ssd_scan_bf16_info(int p_splits, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (p_splits) {
#define REPRO_INFO(ps)                                                                     \
  case ps:                                                                                 \
    err = tc::prepare<64 / ps>();                                                          \
    if (err == cudaSuccess)                                                                \
      err = repro::kernel_info(tc::ssd_scan_tc_kernel<64 / ps>, tc::kThreads,              \
                               tc::Smem<64 / ps>::kBytes, out);                            \
    break;
    REPRO_INFO(1) REPRO_INFO(2) REPRO_INFO(4)
#undef REPRO_INFO
  }
  return static_cast<int>(err);
}
