// Grouped expert GEMM of the sparse-expert layer (kernels/moe.py): every
// routed expert's product in one persistent launch, the tile walk read from
// offsets on the device.
//
//   out[p] = epilogue(x[p] . w[e(p)]),  e(p): offsets[e] <= p < offsets[e+1]
//
// Replaces no TPU kernel (the JAX package has no sparse-expert layer).
// Bound on the H100 at DeepSeek-V2-Lite's widths: at decode (~12 rows an
// expert) the expert weights, read once (1.1 GB a layer); at prefill
// (~3,900 rows an expert) the tensor cores.
//
// Design, on the TMA + wgmma pieces of hopper_gemm_bf16.cuh:
// - x (P, K) bf16, the pairs' rows sorted by expert, K-major, read by a 2-D
//   tensor map in boxes of 128 rows x 64 columns (128-byte swizzle; rows
//   past P zero-filled). w (E, K, N) bf16 is one (E K, N) map read in 64 x
//   64 panels, N-major (wgmma's B with the transpose bit); expert e's rows
//   start at e K.
// - The tiles are (expert, row tile, column tile): expert e has
//   ceil(rows_e / 128) row tiles of 128 columns each. Every CTA copies
//   offsets into shared memory and sums the experts' tile starts there
//   (one thread, E <= 256 steps), then walks tiles blockIdx.x, + gridDim.x,
//   ... ; a tile's expert is a binary search over the starts. An expert
//   with no rows has no tile. The grid is min(SMs, the most tiles P pairs
//   can make), fixed by P alone, so a CUDA graph replays the launch for
//   any routing.
// - Within an expert the row tiles vary fastest: the CTAs in flight at
//   prefill share each weight panel in L2; at decode each expert's one
//   row tile streams its panels once.
// - A tile starts at its expert's row offsets[e] + 128 i: rows of the next
//   expert inside it are computed and not stored (rows >= offsets[e+1]).
// - 384 threads: a producer thread keeps a ring of 6 stages (A tile and two
//   W panels, 32 KB) full; two consumer warpgroups of 64 rows run
//   m64n128k16 wgmma and store from their registers (bf16 pairs): plain,
//   or with swiglu the fused gate|up weight (column blocks of 64 gate then
//   64 up columns) -> silu(gate) * up from the fp32 sums, (P, N / 2).
// Deterministic: no split-K, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using opus_bf16::A_BYTES;
using opus_bf16::BK;
using opus_bf16::BM;
using opus_bf16::CONSUMER_WARPS;
using opus_bf16::CONSUMERS;
using opus_bf16::PANEL_BYTES;
using opus_bf16::THREADS;

constexpr int BN = 128;
constexpr int PANELS = BN / 64;
constexpr int STAGE_BYTES = A_BYTES + PANELS * PANEL_BYTES;
constexpr int STAGES = 6;
constexpr int MAX_EXPERTS = 256;
constexpr int SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + 2 * (MAX_EXPERTS + 1) * 4;
static_assert(SMEM_BYTES <= opus_bf16::SMEM_LIMIT, "shared memory");

struct Args {
  const int* offsets;   // (E + 1,) int32, device
  bf16* out;            // (P, swiglu ? N / 2 : N)
  int P, K, N, E, swiglu;
};

// Tile t -> expert e, first row m0, first column n0 and the expert's row
// end, from the tile starts `starts` (E + 1) and the offsets `offs`.
__device__ __forceinline__ void tile_of(int t, const int* starts,
                                        const int* offs, int E, int* e,
                                        int* m0, int* n0, int* row_end) {
  int lo = 0, hi = E;                     // starts[lo] <= t < starts[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid] <= t)
      lo = mid;
    else
      hi = mid;
  }
  const int rows = offs[lo + 1] - offs[lo];
  const int rt = (rows + BM - 1) / BM;
  const int local = t - starts[lo];
  *e = lo;
  *m0 = offs[lo] + BM * (local % rt);
  *n0 = BN * (local / rt);
  *row_end = offs[lo + 1];
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS, 1)
moe_grouped_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap w_map,
                        const Args g) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (opus_hopper::smem_u32(smem_raw) &
                                       1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int* offs = reinterpret_cast<int*>(empty + STAGES);
  int* starts = offs + (MAX_EXPERTS + 1);

  const int tiles_n = g.N / BN, nk = g.K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      opus_hopper::mbar_init(&full[s], 1);
      opus_hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    opus_hopper::fence_barrier_init();
    int acc = 0;
    offs[0] = g.offsets[0];
    starts[0] = 0;
    for (int e = 0; e < g.E; ++e) {
      offs[e + 1] = g.offsets[e + 1];
      const int rows = offs[e + 1] - offs[e];
      acc += ((rows + BM - 1) / BM) * tiles_n;
      starts[e + 1] = acc;
    }
  }
  __syncthreads();
  const int tiles = starts[g.E];

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the TMA ring full ----
    opus_hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      opus_hopper::prefetch_map(&a_map);
      opus_hopper::prefetch_map(&w_map);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, m0, n0, row_end;
        tile_of(t, starts, offs, g.E, &e, &m0, &n0, &row_end);
        const int wrow = e * g.K;
        for (int k0 = 0; k0 < g.K; k0 += BK, ++it) {
          const int s = it % STAGES;
          opus_hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          opus_hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          opus_hopper::tma_load_2d(st, &a_map, &full[s], k0, m0);
#pragma unroll
          for (int p = 0; p < PANELS; ++p)
            opus_hopper::tma_load_2d(st + A_BYTES + p * PANEL_BYTES, &w_map,
                                     &full[s], n0 + 64 * p, wrow + k0);
        }
      }
    }
  } else {
    opus_hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) opus_attn::mbar_arrive(&empty[it % STAGES]);
    };
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0, row_end;
      tile_of(t, starts, offs, g.E, &e, &m0, &n0, &row_end);
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % STAGES;
        opus_hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* st = smem + s * STAGE_BYTES;
        const uint64_t da = opus_attn::desc_k(st + wg * (A_BYTES / 2));
        const uint64_t db = opus_attn::desc_mn(st + A_BYTES, PANEL_BYTES);
        opus_hopper::fence_regs(acc, BN / 2);
        opus_hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          opus_bf16::wgmma_ss_mn<BN>(acc, da + 2 * kk,
                                     db + kk * (2048 >> 4), ks > 0 || kk > 0);
        opus_hopper::wgmma_commit();
        opus_hopper::fence_regs(acc, BN / 2);
        opus_hopper::wgmma_wait<1>();        // step it - 1 is done
        if (ks > 0) release(it - 1);
      }
      opus_hopper::wgmma_wait<0>();
      opus_hopper::fence_regs(acc, BN / 2);
      release(it - 1);

      // accumulator 4 j + 2 r + c: row 16 warp + lane / 4 + 8 r of the
      // warpgroup's 64, column 8 j + 2 (lane % 4) + c of the tile
      const int row_base = m0 + 64 * wg + 16 * warp + (lane >> 2);
      const int col = 2 * (lane & 3);
      if (g.swiglu) {
        const int n_out = g.N / 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_base + 8 * r;
          if (row >= row_end) continue;
          bf16* dst = g.out + (size_t)row * n_out + n0 / 2 + col;
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            const float* ga = acc + 4 * j + 2 * r;
            const float* ua = acc + 4 * (j + BN / 16) + 2 * r;
            *reinterpret_cast<uint32_t*>(dst + 8 * j) = opus_attn::pack_bf16(
                silu(ga[0]) * ua[0], silu(ga[1]) * ua[1]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_base + 8 * r;
          if (row >= row_end) continue;
          bf16* dst = g.out + (size_t)row * g.N + n0 + col;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j) = opus_attn::pack_bf16(
                acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (P, K) bf16 rows sorted by expert; w (E, K, N) bf16; offsets (E + 1,)
// int32 on the device (offsets[E] <= P); out (P, N) bf16, or (P, N / 2)
// with swiglu (w then the fused gate|up weight). K % 64 == 0, N % 128 ==
// 0, 1 <= E <= 256; sms: the device's SM count. Returns a cudaError_t.
int opus_moe_grouped_gemm(const void* x, const void* w, const void* offsets,
                          void* out, int P, int K, int N, int E, int swiglu,
                          int sms, void* stream) {
  if (P < 1 || K < BK || K % BK || N < BN || N % BN || E < 1 ||
      E > MAX_EXPERTS || sms < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, wm;
  int rc = opus_hopper::make_map_2d(&am, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                    2, P, K, BM, BK,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = opus_hopper::make_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                (uint64_t)E * K, N, BK, 64,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      moe_grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // the most tiles P pairs can make: each expert's last row tile may be
  // partial
  const long long bound =
      ((long long)(P + BM - 1) / BM + E) * (long long)(N / BN);
  const int grid = bound < sms ? (int)bound : sms;
  Args args{static_cast<const int*>(offsets), static_cast<bf16*>(out), P, K,
            N, E, swiglu};
  moe_grouped_gemm_kernel<<<grid, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(am, wm,
                                                                 args);
  return (int)cudaGetLastError();
}

}  // extern "C"
