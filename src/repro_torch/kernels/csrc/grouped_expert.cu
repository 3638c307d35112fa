// Grouped gated expert FFN (dropless MoE) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_expert.py
// `_forward` (:73, pallas_call :103; kernel body `_kernel` :46; public
// `grouped_ffn` :177).  Same function as the plain version
// `grouped_ffn_ref` in kernels/ref.py:
//   out[i] = (silu(x_i . Wg[e_i]) * (x_i . Wi[e_i])) . Wo[e_i],
// fp32 products, fp32 output, where row i of the expert-sorted xs belongs to
// expert e_i by the ragged group_sizes (E,) (rows past their sum are zeros).
//
// Layouts: xs (N, D), w_gate/w_in (E, D, F), w_out (E, F, D), contiguous,
// all fp32 or all bf16; group_sizes (E,) int32; h (N, F) and out (N, D)
// fp32.  D and F are multiples of 8 (16-byte loads of whole rows).
//
// Design.  The TPU kernel walks a sequential grid (units, F tiles) with
// the unit metadata as scalar prefetch, and carries the fp32 output tile
// in VMEM across F tiles and across the units that share a row tile.
// Hopper blocks run in parallel and carry nothing, but each unit owns the
// disjoint rows [lo, hi) of its tile, so a unit stores its rows instead of
// adding into a shared tile: no atomics, and a deterministic result.  Two
// launches of one tiled fp32-FMA GEMM:
//   A, grid (units, F / 64): H = silu(x . Wg[e]) * (x . Wi[e]) for the
//      unit's rows and 64 columns of F, fp32, into the scratch h;
//   B, grid (units + 1, D / 64): Y = H . Wo[e] for the unit's rows and 64
//      columns of D; the extra block row writes zeros to rows past the
//      total.
// Rows are cut into BM-row tiles, and a unit is one expert's rows within
// one tile: a tile straddling a group boundary is visited once per group,
// so there are at most tiles + E - 1 units (the TPU kernel's
// group_metadata schedule, the surplus units empty).  Each block derives
// its own unit from group_sizes (O(E) integer work) instead of reading a
// metadata pass: no extra launch and no host sync.  Empty units return at
// once.  BM is 16 while experts average fewer than 32 rows (decode), else
// 64: chip_smoke.py times both tiles over N and prints the crossover.
//
// What bounds it on this card.  At decode (N = 64 rows, ~28 of 32 experts
// hit) the bytes: each hit expert's 3 * D * F weight slab must be read
// once, ~90 MB at granite's widths, ~27 us at 3.35 TB/s.  The grid spreads
// every slab over F / 64 (A) and D / 64 (B) blocks, ~280 and ~560 of them
// on 132 SMs, each streaming 16-byte loads, the next chunk's loads issued
// before the current chunk is multiplied.  Measured, it moves ~1 TB/s;
// deeper chunks and one thread per decode row and column did not change
// that, and why is not known yet (a suspect: each block reads 128-byte
// pieces of rows 1-2 KB apart).  At
// prefill (N = 8192) the operations: 6 * N * D * F flops, which this
// version does as fp32 FMAs from shared memory (256 threads, each owning
// TM x 4 outputs), far below the tensor-core rate; mma/wgmma and TMA are
// later work.
//
// Reduction order.  Every output element is one thread's FMA chain over
// k = 0 .. K-1 in order (zero padding past K adds exact zeros), whatever
// the row tile (16 or 64 rows) and whatever rows share it, and the
// activation and product round explicitly (no contraction).  So a row's
// result is bit-identical in any cohort: decode, prefill or training.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty -> TM rows, tx -> 4 columns
constexpr int kBN = 64;        // output columns per block
constexpr int kKC = 32;        // depth of one staged chunk
constexpr int kTN = 4;         // output columns per thread

// Rounds every step explicitly, so no instantiation contracts it
// differently.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

// 16 bytes held raw in registers between their load and their store to
// shared memory, widened to fp32 there.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

struct Unit {
  int expert, tile, lo, hi;  // lo >= hi: an empty unit
};

// Unit u of the schedule, and the total of group_sizes.
template <int BM>
__device__ __forceinline__ Unit find_unit(const int* __restrict__ group_sizes, int E, int u,
                                          int* total) {
  Unit unit{0, 0, 0, 0};
  int start = 0, seen = 0;
  bool found = false;
  for (int g = 0; g < E; ++g) {
    const int size = __ldg(group_sizes + g);
    const int end = start + size;
    const int tiles = size > 0 ? (end + BM - 1) / BM - start / BM : 0;
    if (!found && u < seen + tiles) {
      unit = Unit{g, start / BM + (u - seen), start, end};
      found = true;
    }
    seen += tiles;
    start = end;
  }
  *total = start;
  return unit;
}

// C[rows of one unit, 64 columns] = A[rows, :K] . W[e][:K, columns] with
// fp32 FMAs; NW = 2 multiplies two weights and stores silu(C0) * C1 (launch
// A), NW = 1 stores C0 (launch B).  W is (E, K, ncols); A and C are
// row-major with K and ncols columns.  Blocks with blockIdx.x == units
// (launch B only) zero the rows past the total instead.
template <typename TA, typename TW, int BM, int NW>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const TA* __restrict__ a, const TW* __restrict__ w0,
                    const TW* __restrict__ w1, float* __restrict__ c,
                    const int* __restrict__ group_sizes, int E, int units, int N, int K,
                    int ncols) {
  constexpr int TM = BM / 16;
  constexpr int VA = Vec<TA>::kN;
  constexpr int VW = Vec<TW>::kN;
  constexpr int LA = (BM * kKC / VA + kThreads - 1) / kThreads;  // A vectors per thread
  constexpr int LW = (kKC * kBN / VW + kThreads - 1) / kThreads;  // W vectors per thread
  __shared__ __align__(16) float sA[kKC][BM];
  __shared__ __align__(16) float sW[NW][kKC][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.y * kBN;
  int total;
  const int u = blockIdx.x;
  const Unit unit = find_unit<BM>(group_sizes, E, u, &total);
  total = min(total, N);

  if (u >= units) {  // rows past the total come out as zeros
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int cols = min(kBN, ncols - c0) / 4;
    for (int i = tid; i < (N - total) * cols; i += kThreads) {
      const int row = total + i / cols;
      *reinterpret_cast<float4*>(c + static_cast<size_t>(row) * ncols + c0 + 4 * (i % cols)) =
          zero;
    }
    return;
  }
  const int t0 = unit.tile * BM;
  const int r0 = max(unit.lo, t0);
  const int r1 = min(min(unit.hi, t0 + BM), N);
  if (r0 >= r1) return;  // an empty unit
  const bool active = t0 + ty * TM < r1 && t0 + ty * TM + TM > r0;

  const TW* wexp[2] = {w0 + static_cast<size_t>(unit.expert) * K * ncols,
                       NW == 2 ? w1 + static_cast<size_t>(unit.expert) * K * ncols : nullptr};
  uint4 ra[LA], rw[NW][LW];

  // Issue the global loads of the chunk at depth k0 into registers.
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int v = tid + l * kThreads;
      const int m = v / (kKC / VA), k = k0 + (v % (kKC / VA)) * VA;
      const int row = t0 + m;
      ra[l] = make_uint4(0, 0, 0, 0);
      if (v < BM * kKC / VA && row >= r0 && row < r1 && k < K)
        ra[l] = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * K + k);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int l = 0; l < LW; ++l) {
        const int v = tid + l * kThreads;
        const int kk = v / (kBN / VW), col = c0 + (v % (kBN / VW)) * VW;
        rw[j][l] = make_uint4(0, 0, 0, 0);
        if (v < kKC * kBN / VW && k0 + kk < K && col < ncols)
          rw[j][l] = *reinterpret_cast<const uint4*>(wexp[j] + static_cast<size_t>(k0 + kk) *
                                                                  ncols + col);
      }
  };
  // Widen the loaded chunk to fp32 in shared memory (A transposed: k-major).
  auto store = [&]() {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int v = tid + l * kThreads;
      if (v < BM * kKC / VA) {
        float f[VA];
        unpack(ra[l], f, TA());
        const int m = v / (kKC / VA), kk = (v % (kKC / VA)) * VA;
#pragma unroll
        for (int i = 0; i < VA; ++i) sA[kk + i][m] = f[i];
      }
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int l = 0; l < LW; ++l) {
        const int v = tid + l * kThreads;
        if (v < kKC * kBN / VW) {
          float f[VW];
          unpack(rw[j][l], f, TW());
          const int kk = v / (kBN / VW), col = (v % (kBN / VW)) * VW;
#pragma unroll
          for (int i = 0; i < VW; i += 4)
            *reinterpret_cast<float4*>(&sW[j][kk][col + i]) =
                make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
        }
      }
  };

  float acc[NW][TM][kTN];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) acc[j][i][n] = 0.0f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const bool more = k0 + kKC < K;
    if (more) load(k0 + kKC);  // in flight while this chunk is multiplied
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        float av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = sA[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(&sW[j][kk][tx * kTN]);
          const float w[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int n = 0; n < kTN; ++n) acc[j][i][n] = __fmaf_rn(av[i], w[n], acc[j][i][n]);
        }
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  const int col = c0 + tx * kTN;
  if (col >= ncols) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = t0 + ty * TM + i;
    if (row < r0 || row >= r1) continue;
    float y[kTN];
#pragma unroll
    for (int n = 0; n < kTN; ++n)
      y[n] = NW == 2 ? __fmul_rn(silu(acc[0][i][n]), acc[NW - 1][i][n]) : acc[0][i][n];
    *reinterpret_cast<float4*>(c + static_cast<size_t>(row) * ncols + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

template <typename T, int BM>
cudaError_t launch(const void* xs, const int* group_sizes, const void* wg, const void* wi,
                   const void* wo, float* h, float* out, int N, int D, int F, int E,
                   cudaStream_t stream) {
  const int units = (N + BM - 1) / BM + E - 1;
  grouped_gemm_kernel<T, T, BM, 2><<<dim3(units, (F + kBN - 1) / kBN), kThreads, 0, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(wg), static_cast<const T*>(wi), h,
      group_sizes, E, units, N, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grouped_gemm_kernel<float, T, BM, 1>
      <<<dim3(units + 1, (D + kBN - 1) / kBN), kThreads, 0, stream>>>(
          h, static_cast<const T*>(wo), nullptr, out, group_sizes, E, units, N, F, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const void* xs, const int* group_sizes, const void* wg,
                        const void* wi, const void* wo, float* h, float* out, int N, int D,
                        int F, int E, int block_rows, cudaStream_t s) {
  if (block_rows == 16) return launch<T, 16>(xs, group_sizes, wg, wi, wo, h, out, N, D, F, E, s);
  if (block_rows == 64) return launch<T, 64>(xs, group_sizes, wg, wi, wo, h, out, N, D, F, E, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  h is an (N, F) fp32 scratch.
// block_rows is the row tile, 16 or 64 (the same bits either way).
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for shapes
// the kernel does not take).
extern "C" int repro_grouped_ffn(const void* xs, const int* group_sizes, const void* wg,
                                 const void* wi, const void* wo, void* h, void* out, int N,
                                 int D, int F, int E, int block_rows, int is_bf16,
                                 void* stream) {
  if (N <= 0 || D <= 0 || F <= 0 || E <= 0 || D % 8 || F % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? launch_tile<__nv_bfloat16>(xs, group_sizes, wg, wi, wo, hf, of, N, D, F, E,
                                           block_rows, s)
              : launch_tile<float>(xs, group_sizes, wg, wi, wo, hf, of, N, D, F, E, block_rows,
                                   s);
  return static_cast<int>(err);
}
