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
// all fp32 or all bf16; group_sizes (E,) int32; out (N, D) fp32.  D and F
// are multiples of 8 (16-byte loads of whole rows).
//
// Schedule.  The TPU kernel walks a sequential grid (units, F tiles) with
// the unit metadata as scalar prefetch, and carries the fp32 output tile
// in VMEM across F tiles and across the units that share a row tile.
// Hopper blocks run in parallel and carry nothing, but each unit owns the
// disjoint rows [lo, hi) of its tile, so a unit stores its rows instead of
// adding into a shared tile: no atomics, and a deterministic result.  Rows
// are cut into 64-row tiles, and a unit is one expert's rows within one
// tile: a tile straddling a group boundary is visited once per group, so
// there are at most tiles + E - 1 units (the TPU kernel's group_metadata
// schedule, the surplus units empty).  Each block derives its own unit from
// group_sizes (O(E) integer work) instead of reading a metadata pass: no
// extra launch and no host sync.  Empty units return at once.  Two
// launches:
//   A, grid (units, F / BN): H = silu(x . Wg[e]) * (x . Wi[e]) for the
//      unit's rows and BN columns of F, into a scratch;
//   B, grid (units + 1, D / BN): Y = H . Wo[e] for the unit's rows and BN
//      columns of D; the extra block row writes zeros to rows past the
//      total.
//
// bf16 runs both products on wgmma (one warpgroup a block): m64n64k16,
// bf16 -> fp32, the unit's 64-row tile of x or H as the K-major A operand
// and the weights, row-major (K, N) and so MN-major, as B, all in
// 128-byte-swizzled 64-column slabs of shared memory (hopper.cuh), filled
// by cp.async with zero fill (rows outside the unit, k and columns past
// the edge) in a ring of kStages k-chunks of 64.  Launch A keeps one
// accumulator per weight over one shared x tile.  x and the weights are
// exact bf16 values, so A's products are exact in fp32; H is not, and one
// bf16 H would cost ~1e-3 of the output (GROUPED_TOL in chip_smoke.py is
// 1e-4).  So A's epilogue stores H as two bf16 terms, H_hi = bf16(H) and
// H_lo = bf16(H - H_hi), which hold H to ~2^-17 of |H|, and B accumulates
// H_hi . Wo + H_lo . Wo, each Wo k-step read from shared memory once for
// both terms.  fp32 inputs keep the first design's body: both products as
// fp32 FMAs from shared memory (256 threads, each owning 4 rows x 4
// columns), since neither bf16 nor TF32 products hold fp32's tolerance.
//
// What bounds it on this card.  At decode (N = 64 rows, ~28 of 32 experts
// hit) the bytes: each hit expert's 3 * D * F weight slab must be read
// once, ~88 MB at granite's widths, ~26 us at 3.35 TB/s; launch A spreads
// every slab over F / 64 blocks and B over D / 128 (BN = 64 kSlabsA, 64
// kSlabsB), each keeping kStages - 1 chunks of 16 KB in flight.  At
// prefill (N = 8192) the function's own bound is still its bytes (~150 MB;
// its 6 * N * D * F flops take less at the bf16 peak, and B's two terms
// double B's share), but each 64 x BN block reads its unit's x or H tile
// and its expert's weight tiles from L2 again, ~0.8 GB in all at granite's
// widths, and on the H100 both launches move ~5.4 TB/s from L2, which sets
// their time.  Wider blocks (BN 128 or 256, one block per SM) and deeper
// or shallower rings measured slower there.
//
// Reduction order.  Every output element is one fixed chain whatever the
// cohort: in bf16 the same wgmma instructions over the same k-chunks in
// order, on a row whose position in its 64-row tile and whose neighbours
// enter no product of it, and H split the same way; in fp32 one thread's
// FMA chain over k = 0 .. K-1 in order.  Zero padding past K adds exact
// zeros, and the activation and product round explicitly (no
// contraction).  So a row's result is bit-identical in any cohort: decode,
// prefill or training.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // rows of a tile, at every N

// Rounds every step explicitly, so no instantiation contracts it
// differently.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

struct Unit {
  int expert, tile, lo, hi;  // lo >= hi: an empty unit
};

// Unit u of the schedule, and the total of group_sizes.
__device__ __forceinline__ Unit find_unit(const int* __restrict__ group_sizes, int E, int u,
                                          int* total) {
  Unit unit{0, 0, 0, 0};
  int start = 0, seen = 0;
  bool found = false;
  for (int g = 0; g < E; ++g) {
    const int size = __ldg(group_sizes + g);
    const int end = start + size;
    const int tiles = size > 0 ? (end + kBM - 1) / kBM - start / kBM : 0;
    if (!found && u < seen + tiles) {
      unit = Unit{g, start / kBM + (u - seen), start, end};
      found = true;
    }
    seen += tiles;
    start = end;
  }
  *total = start;
  return unit;
}

// Zero rows [total, N) of columns [c0, c0 + width) of the (N, ncols) fp32
// output (the extra block row of launch B).
__device__ __forceinline__ void zero_tail(float* __restrict__ c, int total, int N, int c0,
                                          int width, int ncols) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int cols = min(width, ncols - c0) / 4;
  for (int i = threadIdx.x; i < (N - total) * cols; i += blockDim.x) {
    const int row = total + i / cols;
    *reinterpret_cast<float4*>(c + static_cast<size_t>(row) * ncols + c0 + 4 * (i % cols)) =
        zero;
  }
}

// ------------------------------------------------------------------ bf16

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kChunk = 64;       // k depth of a stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kSlabsA = 1;       // 64-column slabs of F a launch-A block computes
constexpr int kSlabsB = 2;       // 64-column slabs of D a launch-B block computes

// The shared-memory ring of a launch: a stage holds NA A tiles (64 rows x
// one k-chunk) and NW weights' NS slabs (one k-chunk x 64 columns each).
template <int NA, int NW, int NS>
struct Ring {
  static constexpr int kA = NA * repro::kSlabBytes;
  static constexpr int kStage = kA + NW * NS * repro::kSlabBytes;
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment slack
};
using RingA = Ring<1, 2, kSlabsA>;  // x; Wg, Wi
using RingB = Ring<2, 1, kSlabsB>;  // H_hi, H_lo; Wo

// One block of launch A (NA 1, NW 2: stores H_hi and H_lo, the (N, ncols)
// bf16 scratches h_hi, h_lo) or launch B (NA 2, NW 1: stores the fp32
// output c; blocks with blockIdx.x == units zero the rows past the total).
// a0 (and a1) are (N, K) row-major; w0 (and w1) (E, K, ncols).
template <int NA, int NW, int NS>
__global__ void __launch_bounds__(kWgThreads)
wgmma_gemm_kernel(const bf16* __restrict__ a0, const bf16* __restrict__ a1,
                  const bf16* __restrict__ w0, const bf16* __restrict__ w1,
                  bf16* __restrict__ h_hi, bf16* __restrict__ h_lo, float* __restrict__ c,
                  const int* __restrict__ group_sizes, int E, int units, int N, int K,
                  int ncols) {
  using R = Ring<NA, NW, NS>;
  constexpr int kCols = NS * 64;  // output columns of a block
  extern __shared__ char smem[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) &
                        ~static_cast<uint32_t>(1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.y * kCols;
  int total;
  const Unit unit = find_unit(group_sizes, E, blockIdx.x, &total);
  total = min(total, N);
  if (static_cast<int>(blockIdx.x) >= units) {  // launch B: rows past the total are zeros
    if (NW == 1) zero_tail(c, total, N, c0, kCols, ncols);
    return;
  }
  const int t0 = unit.tile * kBM;
  const int r0 = max(unit.lo, t0);
  const int r1 = min(min(unit.hi, t0 + kBM), N);
  if (r0 >= r1) return;  // an empty unit

  const bf16* as[2] = {a0, a1};
  const bf16* ws[2] = {w0 + static_cast<size_t>(unit.expert) * K * ncols,
                       NW == 2 ? w1 + static_cast<size_t>(unit.expert) * K * ncols : w0};
  const int nk = (K + kChunk - 1) / kChunk;

  // Issue the copies of k-chunk kc into its stage (none past the last
  // chunk), then commit a group either way so that group counts stay
  // uniform.
  auto load = [&](int kc) {
    if (kc < nk) {
      const uint32_t st = base + (kc % kStages) * R::kStage;
      const int k0 = kc * kChunk;
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int i = 0; i < kBM * 8 / kWgThreads; ++i) {
          const int idx = tid + i * kWgThreads;
          const int r = idx >> 3, ch = idx & 7;
          const int row = t0 + r, k = k0 + ch * 8;
          const bool ok = row >= r0 && row < r1 && k < K;
          repro::cp_async16(st + j * repro::kSlabBytes + repro::swz(r, ch),
                            ok ? as[j] + static_cast<size_t>(row) * K + k : as[j], ok);
        }
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int i = 0; i < kChunk * NS * 8 / kWgThreads; ++i) {
          const int idx = tid + i * kWgThreads;
          const int r = idx / (NS * 8), ch = idx % (NS * 8);
          const int k = k0 + r, col = c0 + ch * 8;
          const bool ok = k < K && col < ncols;
          repro::cp_async16(st + R::kA + j * NS * repro::kSlabBytes + repro::swz(r, ch),
                            ok ? ws[j] + static_cast<size_t>(k) * ncols + col : ws[j], ok);
        }
    }
    repro::cp_async_commit();
  };

  // acc[w][sl][j][e]: weight w, columns 64 sl + 8 j + 2 t4 + {0, 1} of rows
  // 16 warp + quad (e 0, 1) and 16 warp + quad + 8 (e 2, 3)
  float acc[NW][NS][8][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][sl][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int kc = 0; kc < nk; ++kc) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed; every product of chunk kc - 1 is done
    load(kc + kStages - 1);  // into the stage chunk kc - 1 used
    const uint32_t st = base + (kc % kStages) * R::kStage;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) repro::fence_regs(acc[w][sl]);
    repro::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const uint64_t a = repro::sw128_desc(st + j * repro::kSlabBytes + ks * 32);
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int sl = 0; sl < NS; ++sl)
            repro::wgmma_ss<64, 0, 1>(
                acc[w][sl], a,
                repro::sw128_desc(st + R::kA + (w * NS + sl) * repro::kSlabBytes +
                                  ks * 16 * 128));
      }
    repro::wgmma_commit_and_wait();
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) repro::fence_regs(acc[w][sl]);
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t0 + warp * 16 + quad + 8 * i;
    if (row < r0 || row >= r1) continue;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + sl * 64 + 8 * j + 2 * t4;
        if (col >= ncols) continue;
        const size_t at = static_cast<size_t>(row) * ncols + col;
        if (NW == 2) {
          const float h0 = __fmul_rn(silu(acc[0][sl][j][2 * i]), acc[NW - 1][sl][j][2 * i]);
          const float h1 =
              __fmul_rn(silu(acc[0][sl][j][2 * i + 1]), acc[NW - 1][sl][j][2 * i + 1]);
          uint32_t hi, lo;
          repro::split_bf16(h0, h1, &hi, &lo);
          *reinterpret_cast<uint32_t*>(h_hi + at) = hi;
          *reinterpret_cast<uint32_t*>(h_lo + at) = lo;
        } else {
          *reinterpret_cast<float2*>(c + at) =
              make_float2(acc[0][sl][j][2 * i], acc[0][sl][j][2 * i + 1]);
        }
      }
  }
}

// The shared-memory opt-in of one instantiation (a flag array of its own).
template <int NA, int NW, int NS>
cudaError_t opt_in() {
  static std::atomic<bool> set_on[repro::kMaxDevices];
  return repro::allow_dynamic_smem(wgmma_gemm_kernel<NA, NW, NS>, Ring<NA, NW, NS>::kSmem,
                                   set_on);
}

cudaError_t launch_bf16(const void* xs, const int* group_sizes, const void* wg, const void* wi,
                        const void* wo, bf16* h, float* out, int N, int D, int F, int E,
                        cudaStream_t stream) {
  cudaError_t err = opt_in<1, 2, kSlabsA>();
  if (err == cudaSuccess) err = opt_in<2, 1, kSlabsB>();
  if (err != cudaSuccess) return err;
  const int units = (N + kBM - 1) / kBM + E - 1;
  bf16* h_lo = h + static_cast<size_t>(N) * F;
  wgmma_gemm_kernel<1, 2, kSlabsA>
      <<<dim3(units, (F + 64 * kSlabsA - 1) / (64 * kSlabsA)), kWgThreads, RingA::kSmem,
         stream>>>(
      static_cast<const bf16*>(xs), nullptr, static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wi), h, h_lo, nullptr, group_sizes, E, units, N, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgmma_gemm_kernel<2, 1, kSlabsB>
      <<<dim3(units + 1, (D + 64 * kSlabsB - 1) / (64 * kSlabsB)), kWgThreads, RingB::kSmem,
         stream>>>(
      h, h_lo, static_cast<const bf16*>(wo), nullptr, nullptr, nullptr, out, group_sizes, E,
      units, N, F, D);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

constexpr int kThreads = 256;  // 16 x 16: ty -> kTM rows, tx -> 4 columns
constexpr int kBN = 64;        // output columns per block
constexpr int kKC = 32;        // depth of one staged chunk
constexpr int kTM = kBM / 16;  // output rows per thread
constexpr int kTN = 4;         // output columns per thread

// C[rows of one unit, 64 columns] = A[rows, :K] . W[e][:K, columns] with
// fp32 FMAs; NW = 2 multiplies two weights and stores silu(C0) * C1 (launch
// A), NW = 1 stores C0 (launch B).  W is (E, K, ncols); A and C are
// row-major with K and ncols columns.  Blocks with blockIdx.x == units
// (launch B only) zero the rows past the total instead.
template <int NW>
__global__ void __launch_bounds__(kThreads)
fma_gemm_kernel(const float* __restrict__ a, const float* __restrict__ w0,
                const float* __restrict__ w1, float* __restrict__ c,
                const int* __restrict__ group_sizes, int E, int units, int N, int K,
                int ncols) {
  constexpr int LA = (kBM * kKC / 4 + kThreads - 1) / kThreads;  // A vectors per thread
  constexpr int LW = (kKC * kBN / 4 + kThreads - 1) / kThreads;  // W vectors per thread
  __shared__ __align__(16) float sA[kKC][kBM];
  __shared__ __align__(16) float sW[NW][kKC][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.y * kBN;
  int total;
  const int u = blockIdx.x;
  const Unit unit = find_unit(group_sizes, E, u, &total);
  total = min(total, N);

  if (u >= units) {  // rows past the total come out as zeros
    zero_tail(c, total, N, c0, kBN, ncols);
    return;
  }
  const int t0 = unit.tile * kBM;
  const int r0 = max(unit.lo, t0);
  const int r1 = min(min(unit.hi, t0 + kBM), N);
  if (r0 >= r1) return;  // an empty unit
  const bool active = t0 + ty * kTM < r1 && t0 + ty * kTM + kTM > r0;

  const float* wexp[2] = {w0 + static_cast<size_t>(unit.expert) * K * ncols,
                          NW == 2 ? w1 + static_cast<size_t>(unit.expert) * K * ncols : nullptr};
  float4 ra[LA], rw[NW][LW];

  // Issue the global loads of the chunk at depth k0 into registers.
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int v = tid + l * kThreads;
      const int m = v / (kKC / 4), k = k0 + (v % (kKC / 4)) * 4;
      const int row = t0 + m;
      ra[l] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < kBM * kKC / 4 && row >= r0 && row < r1 && k < K)
        ra[l] = *reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * K + k);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int l = 0; l < LW; ++l) {
        const int v = tid + l * kThreads;
        const int kk = v / (kBN / 4), col = c0 + (v % (kBN / 4)) * 4;
        rw[j][l] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v < kKC * kBN / 4 && k0 + kk < K && col < ncols)
          rw[j][l] = *reinterpret_cast<const float4*>(wexp[j] + static_cast<size_t>(k0 + kk) *
                                                                     ncols + col);
      }
  };
  // Store the loaded chunk to shared memory (A transposed: k-major).
  auto store = [&]() {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int v = tid + l * kThreads;
      if (v < kBM * kKC / 4) {
        const float f[4] = {ra[l].x, ra[l].y, ra[l].z, ra[l].w};
        const int m = v / (kKC / 4), kk = (v % (kKC / 4)) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) sA[kk + i][m] = f[i];
      }
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int l = 0; l < LW; ++l) {
        const int v = tid + l * kThreads;
        if (v < kKC * kBN / 4) {
          const int kk = v / (kBN / 4), col = (v % (kBN / 4)) * 4;
          *reinterpret_cast<float4*>(&sW[j][kk][col]) = rw[j][l];
        }
      }
  };

  float acc[NW][kTM][kTN];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
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
        float av[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = sA[kk][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(&sW[j][kk][tx * kTN]);
          const float w[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
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
  for (int i = 0; i < kTM; ++i) {
    const int row = t0 + ty * kTM + i;
    if (row < r0 || row >= r1) continue;
    float y[kTN];
#pragma unroll
    for (int n = 0; n < kTN; ++n)
      y[n] = NW == 2 ? __fmul_rn(silu(acc[0][i][n]), acc[NW - 1][i][n]) : acc[0][i][n];
    *reinterpret_cast<float4*>(c + static_cast<size_t>(row) * ncols + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

cudaError_t launch_fp32(const void* xs, const int* group_sizes, const void* wg, const void* wi,
                        const void* wo, float* h, float* out, int N, int D, int F, int E,
                        cudaStream_t stream) {
  const int units = (N + kBM - 1) / kBM + E - 1;
  fma_gemm_kernel<2><<<dim3(units, (F + kBN - 1) / kBN), kThreads, 0, stream>>>(
      static_cast<const float*>(xs), static_cast<const float*>(wg),
      static_cast<const float*>(wi), h, group_sizes, E, units, N, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fma_gemm_kernel<1><<<dim3(units + 1, (D + kBN - 1) / kBN), kThreads, 0, stream>>>(
      h, static_cast<const float*>(wo), nullptr, out, group_sizes, E, units, N, F, D);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  h is a scratch: (2, N, F) bf16
// (H_hi, H_lo) for bf16 inputs, (N, F) fp32 for fp32 ones.  Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for shapes the kernel
// does not take).
extern "C" int repro_grouped_ffn(const void* xs, const int* group_sizes, const void* wg,
                                 const void* wi, const void* wo, void* h, void* out, int N,
                                 int D, int F, int E, int is_bf16, void* stream) {
  if (N <= 0 || D <= 0 || F <= 0 || E <= 0 || D % 8 || F % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? launch_bf16(xs, group_sizes, wg, wi, wo, static_cast<bf16*>(h), of, N, D, F, E,
                            s)
              : launch_fp32(xs, group_sizes, wg, wi, wo, static_cast<float*>(h), of, N, D, F,
                            E, s);
  return static_cast<int>(err);
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the bf16 body's launch A (launch 0) or B (launch 1) (out: 4 ints).
extern "C" int repro_grouped_ffn_bf16_info(int launch, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (launch == 0) {
    err = opt_in<1, 2, kSlabsA>();
    if (err == cudaSuccess)
      err = repro::kernel_info(wgmma_gemm_kernel<1, 2, kSlabsA>, kWgThreads, RingA::kSmem,
                               out);
  } else if (launch == 1) {
    err = opt_in<2, 1, kSlabsB>();
    if (err == cudaSuccess)
      err = repro::kernel_info(wgmma_gemm_kernel<2, 1, kSlabsB>, kWgThreads, RingB::kSmem,
                               out);
  }
  return static_cast<int>(err);
}
