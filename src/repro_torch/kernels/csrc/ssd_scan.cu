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
// Design.  The TPU kernel walks the chunks of one (row, head) on a
// sequential grid axis with the (P, N) state in VMEM scratch.  Here one block
// owns a (head, row) and loops over the sequence itself, 64 rows at a time,
// with the state in shared memory in fp32.  The split into 64-row pieces is
// the kernel's own: the chunked form is exact in real arithmetic for any
// chunk length, so the model's chunk (128 for mamba2-1.3b) only fixes the
// caller's padding.  Per piece, from shared memory, all in fp32 FMAs:
//   1. M[t][i] = (C_t . B_i) * exp(cum_t - cum_i) * dt_i for t >= i, else 0;
//      exp is evaluated only where t >= i: above the diagonal cum_t - cum_i
//      is positive and may overflow, and inf * 0 would be NaN (the TPU
//      kernel's where(tri, exp(seg), 0) evaluates it everywhere);
//   2. y[t][p] = sum_i M[t][i] x[i][p] + exp(cum_t) (C_t . state[p]) + D x[t][p],
//      rounded once to T;
//   3. state[p][n] = exp(cum_last) state[p][n]
//                    + sum_i x[i][p] dt_i exp(cum_last - cum_i) B[i][n].
// Rows past S load as zeros with dt = 0: decay 1 and no input, an exact
// no-op, and they are not stored.  The inclusive cumsum of dt * A over the
// 64 rows is one warp's shuffle scan.  256 threads as a 16 x 16 grid; each
// phase gives a thread a strided 4 x 4 (phase 3: P/16 x N/16) register tile,
// so that the shared rows it reads are broadcast or conflict-free (tiles
// are stored with one padding column).
//
// What bounds it on this card: per 64 rows and head, ~1.8 M FMAs against
// (64 * (2 N + 2 P) + ...) bytes, ~3,500 flops per byte at mamba2's
// P = 64, N = 128: operations.  This first version uses fp32 FMAs fed from
// shared memory (about one shared load per two FMAs), not the tensor
// cores, and runs one 133 KB block per SM: B * H = 256 blocks at a 4-row
// prefill are two waves on 132 SMs, and a 1-row admission leaves half the
// SMs idle.  Computing C . B^T once per row for all heads (it does not
// depend on the head), splitting P across blocks at small B, and mma tiles
// are later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;  // rows per piece

template <int P, int N>
constexpr int smem_floats() {
  // sC, sB (kQ x N+1), sX (kQ x P+1), state (P x N+1), M (kQ x kQ+1), cum, dt, w
  return 2 * kQ * (N + 1) + kQ * (P + 1) + P * (N + 1) + kQ * (kQ + 1) + 3 * kQ;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dvec,
                T* __restrict__ y, float* __restrict__ state_out, int S, int H) {
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
        T* out = y + ((static_cast<size_t>(b) * S + t0 + t) * H + h) * P;
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

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* a_log, const void* bm,
                   const void* cm, const float* dvec, void* y, float* state_out, int B,
                   int S, int H, cudaStream_t stream) {
  constexpr int smem = smem_floats<P, N>() * 4;
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err = repro::allow_dynamic_smem(ssd_scan_kernel<T, P, N>, smem, smem_set);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, P, N><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dvec, static_cast<T*>(y), state_out, S, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  state_out may be null (no final
// state).  Built for mamba2-1.3b's P = 64, N = 128 only; other widths come
// with the configuration that needs them.  Returns the cudaError_t of the
// launch.
extern "C" int repro_ssd_scan(const void* x, const float* dt, const float* a_log,
                              const void* bm, const void* cm, const float* dvec, void* y,
                              float* state_out, int B, int S, int H, int P, int N,
                              int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || P != 64 || N != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16, 64, 128>(x, dt, a_log, bm, cm, dvec, y, state_out, B, S,
                                               H, s)
              : launch<float, 64, 128>(x, dt, a_log, bm, cm, dvec, y, state_out, B, S, H, s);
  return static_cast<int>(err);
}
