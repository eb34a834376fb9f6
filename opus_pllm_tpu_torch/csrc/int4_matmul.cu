// Hopper (sm_90a) grouped-int4 matmul over the v2 word layout.
//
// Port of the Pallas kernel `_kernel_v2` / `_pallas_v2` in
// opus_pllm_tpu/kernels/quant4.py: out (M, N) = x (M, K) @ W, where W is
// int4 in (K/8, N) int32 words with one fp32 scale per (128-row group,
// column). It computes what the TPU kernel computes: x rounded to bf16, an
// fp32 partial sum per group, the partial times its fp32 scale, summed in
// fp32, one rounding of the result to the output type.
//
// Word layout (quant4.py pack_int4_v2): word row i of 512-row superblock sb
// holds, in bits 4g..4g+3 and 16+4g..16+4g+3, the biased values q+8 of rows
// 2i and 2i+1 of group g (rows sb*512 + 128g + 2i, +1). So
//   bits = ((w >> 4g) & 0x000F000F) | 0x43004300
// read as a bf16 pair is (136 + q_even, 136 + q_odd), and one bf16x2
// subtract of 136 gives both weights exactly (|q| <= 7).
//
// Bound: the decode shapes (M = batch = 8) stream the words once: bytes,
// 4 bits a weight against 2 M FLOP, so at M = 8 the 3.35 TB/s of HBM and
// not the tensor cores set the time (~1.2 ms of words a Llama-3-8B decode
// step).
// Design (`int4_v2_mma_kernel`, N % 4 == 0):
//   - The products run on the tensor cores, operands swapped: the
//     unpacked weights are mma.sync m16n8k16's A operand (16 weight
//     columns x 16 K) and x^T its B operand (16 K x 8 rows of x). One v2
//     word, put through the bit trick above, IS one bf16x2 A-fragment
//     register: two consecutive K rows of one group and one column. The
//     order of K inside a 16-K chunk and of the columns inside an A tile
//     is free, so a lane's fragment pair (t, t + 4) is word rows 2t and
//     2t + 1 of an 8-row chunk and its A rows g, g + 8 of two tiles are the
//     four consecutive columns 4g .. 4g + 3: one 16-byte shared-memory load
//     per word row, and x's B fragment is the four bf16 of x at K = 4t ..
//     4t + 3 past the chunk's start (one 8-byte load). The epilogue follows
//     the same orders. mma.sync rather than wgmma: a warp owns its columns
//     and K rows outright (no warpgroup-wide 64-column tile), there are
//     only M / 8 B columns, and the kernel waits on memory, not on the
//     tensor cores.
//   - One fp32 accumulator set per scale group: a warp's fragments of a
//     superblock's four groups accumulate apart (every word row holds all
//     four), and at the superblock's end each is multiplied by its fp32
//     column scales and added to the running sum.
//   - Memory: a producer warp keeps an 8-stage ring of TMA loads in flight
//     (a stage: 32 word rows x 64 columns, two 4 KB boxes in the 128-byte
//     swizzle, so 64 KB in flight a CTA). Under the swizzle the 16-byte
//     loads of a quarter warp (word rows 2t, columns 4g .. 4g + 3) hit 8
//     different 16-byte bank groups: no conflict.
//   - CTA: 64 columns x 8 or 16 rows of x (M > 16: more CTAs along y), a
//     superblock range; 4 consumer warps (2 column panels x 2 halves of a
//     stage's rows) and the producer warp.
//   - Filling 132 SMs: a column tile's K is split over a thread-block
//     cluster of up to 8 CTAs (the wrapper picks the size and the
//     superblocks each, quant4.v2_plan). Each CTA writes its warps' sums to
//     its shared memory; after a cluster barrier, every CTA reduces a slice
//     of the tile over the cluster's shared memory (distributed shared
//     memory, ranks and halves in a fixed order), rounds once and stores.
//     One launch, no workspace, deterministic.
// A tensor map needs a word row's stride to be a multiple of 16 bytes:
// N % 4 == 0; the wrapper sends other N to the kernel's plain version.
//
// The entry point returns the cudaError_t of its launch (0 = success); it
// neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "mma_bf16.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ void store(void* out, size_t i, float v,
                                      int out_bf16) {
  if (out_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

namespace v2 {

using opus_hopper::mbar_wait;
using opus_hopper::smem_u32;

constexpr int PANELS = 2;                  // 32-column panels a CTA
constexpr int PANEL_COLS = 32;             // one 128-byte row of words
constexpr int COLS = PANELS * PANEL_COLS;  // weight columns a CTA
constexpr int ROWS = 32;                   // word rows a stage
constexpr int PANEL_BYTES = ROWS * 128;    // one TMA box
constexpr int STAGE_BYTES = PANELS * PANEL_BYTES;
constexpr int STAGES = 65536 / STAGE_BYTES;   // 64 KB in flight a CTA
constexpr int CONSUMERS = 64 * PANELS;     // (panel, half of a stage) a warp
constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
constexpr int MAX_CLUSTER = 8;

template <int MT>                          // MT x 8 rows of x a CTA
struct Plan {
  static constexpr int RED_OFF = STAGES * STAGE_BYTES;
  static constexpr int RED_FLOATS = 2 * COLS * MT * 8;   // [half][col][row]
  static constexpr int BAR_OFF = RED_OFF + RED_FLOATS * 4;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
};

// One A-fragment register from a word: group g's two K rows, exact bf16.
__device__ __forceinline__ uint32_t unpack_a(uint32_t w, int g) {
  uint32_t bits = ((w >> (4 * g)) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&bits);
  v = __hsub2(v, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32 at `p`'s offset in the shared memory of cluster CTA `cta`.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  float v;
  asm volatile(
      "{\n .reg .b32 r;\n mapa.shared::cluster.u32 r, %1, %2;\n"
      " ld.shared::cluster.f32 %0, [r];\n}\n"
      : "=f"(v) : "r"(smem_u32(p)), "r"(cta) : "memory");
  return v;
}

// grid (cluster size, M / (8 MT), N / 64); cluster (cluster size, 1, 1):
// CTA x of a cluster takes superblocks [x sb_per, (x + 1) sb_per).
template <int MT>
__global__ void __launch_bounds__(THREADS)
int4_v2_mma_kernel(const __grid_constant__ CUtensorMap w_map,
                   const bf16* __restrict__ x, const float* __restrict__ gs,
                   void* __restrict__ out, int M, int N, int K, int sb_per,
                   int out_bf16) {
  using P = Plan<MT>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + P::RED_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const uint32_t rank = opus_hopper::cluster_rank();
  const int cs = gridDim.x;
  const int m0 = blockIdx.y * MT * 8, n0 = blockIdx.z * COLS;
  const int sb0 = rank * sb_per, sb1 = min(sb0 + sb_per, K / 512);
  const int n_stages = 2 * max(sb1 - sb0, 0);      // 32 word rows each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      opus_hopper::mbar_init(&full[s], 1);
      opus_hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    opus_hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: the ring of word tiles ----
    if (lane == 0) {
      opus_hopper::prefetch_map(&w_map);
      for (int u = 0; u < n_stages; ++u) {
        const int s = u % STAGES;
        mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        const int row = sb0 * 64 + u * ROWS;
        opus_hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
#pragma unroll
        for (int pi = 0; pi < PANELS; ++pi)
          opus_hopper::tma_load_2d(st + pi * PANEL_BYTES, &w_map, &full[s],
                                   n0 + pi * PANEL_COLS, row);
      }
    }
  } else {
    // ---- consumers: warp (panel p, half) of each stage ----
    const int p = warp % PANELS, half = warp / PANELS;
    const int g = lane >> 2, t = lane & 3;
    const int col = n0 + PANEL_COLS * p + 4 * g;   // this lane's 4 columns
    // acc[tile][j][e]: tile 0 holds columns col, col + 1 (A rows g, g + 8),
    // tile 1 col + 2, col + 3; e = 0, 1 x rows 2t, 2t + 1 of m-tile j at
    // the first column, e = 2, 3 at the second
    float acc[2][MT][4], part[4][2][MT][4];
#pragma unroll
    for (int i = 0; i < 2 * MT * 4; ++i) (&acc[0][0][0])[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * 2 * MT * 4; ++i) (&part[0][0][0][0])[i] = 0.f;
    const bf16* xr[MT];
    bool xlive[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      xlive[j] = m0 + 8 * j + g < M;
      xr[j] = x + (size_t)(xlive[j] ? m0 + 8 * j + g : 0) * K;
    }
    // x's B fragments of a stage, [chunk][group][m-tile], loaded one stage
    // ahead of their products into the other of two buffers (they come
    // from L2 while the words arrive)
    typedef uint2 XFrags[2][4][MT];
    XFrags xa, xb;
    auto load_x = [&](int u, XFrags& dst) {
      const int row0 = sb0 * 64 + u * ROWS;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // K of pair t: 2 (word row in the superblock), + 128 g'
        const int kx = (row0 >> 6) * 512 +
                       2 * ((row0 & 63) + 16 * half + 8 * c + 2 * t);
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
#pragma unroll
          for (int j = 0; j < MT; ++j)
            dst[c][gi][j] =
                xlive[j] && u < n_stages
                    ? __ldg(reinterpret_cast<const uint2*>(xr[j] + kx +
                                                           128 * gi))
                    : make_uint2(0u, 0u);
      }
    };
    // stage u's products into the group partials
    auto run_stage = [&](int u, const XFrags& xf) {
      const int s = u % STAGES;
      mbar_wait(&full[s], (u / STAGES) & 1);
      const uint8_t* pan = ring + s * STAGE_BYTES + p * PANEL_BYTES;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 16 * half + 8 * c + 2 * t;   // word rows r, r + 1
        const uint4 w0 = *reinterpret_cast<const uint4*>(
            pan + opus_hopper::swizzle128(r * 128 + 16 * g));
        const uint4 w1 = *reinterpret_cast<const uint4*>(
            pan + opus_hopper::swizzle128((r + 1) * 128 + 16 * g));
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const uint32_t a0[4] = {unpack_a(w0.x, gi), unpack_a(w0.y, gi),
                                  unpack_a(w1.x, gi), unpack_a(w1.y, gi)};
          const uint32_t a1[4] = {unpack_a(w0.z, gi), unpack_a(w0.w, gi),
                                  unpack_a(w1.z, gi), unpack_a(w1.w, gi)};
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            opus_mma::mma16816(part[gi][0][j], a0, xf[c][gi][j].x,
                               xf[c][gi][j].y);
            opus_mma::mma16816(part[gi][1][j], a1, xf[c][gi][j].x,
                               xf[c][gi][j].y);
          }
        }
      }
      __syncwarp();
      if (lane == 0) opus_hopper::mbar_arrive_cluster(&empty[s], rank);
    };
    load_x(0, xa);
    // a superblock is two stages; its scales load at its start and apply
    // at its end
    for (int u = 0; u < n_stages; u += 2) {
      const int sb = sb0 + u / 2;
      float4 sc[4];
      if (col < N) {
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          sc[gi] = __ldg(reinterpret_cast<const float4*>(
              gs + ((size_t)sb * 4 + gi) * N + col));
      }
      load_x(u + 1, xb);
      run_stage(u, xa);
      load_x(u + 2, xa);
      run_stage(u + 1, xb);
      if (col < N) {
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            acc[0][j][0] += part[gi][0][j][0] * sc[gi].x;
            acc[0][j][1] += part[gi][0][j][1] * sc[gi].x;
            acc[0][j][2] += part[gi][0][j][2] * sc[gi].y;
            acc[0][j][3] += part[gi][0][j][3] * sc[gi].y;
            acc[1][j][0] += part[gi][1][j][0] * sc[gi].z;
            acc[1][j][1] += part[gi][1][j][1] * sc[gi].z;
            acc[1][j][2] += part[gi][1][j][2] * sc[gi].w;
            acc[1][j][3] += part[gi][1][j][3] * sc[gi].w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4 * 2 * MT * 4; ++i) (&part[0][0][0][0])[i] = 0.f;
    }
    // this warp's sums: red[half][local column][row]
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = PANEL_COLS * p + 4 * g + 2 * ti + (e >> 1);
          red[(half * COLS + cl) * MT * 8 + 8 * j + 2 * t + (e & 1)] =
              acc[ti][j][e];
        }
  }

  // every CTA's sums written; each CTA reduces a slice of the tile over
  // the cluster in a fixed order (ranks, then halves)
  opus_hopper::cluster_arrive();
  opus_hopper::cluster_wait();
  for (int i = rank * THREADS + threadIdx.x; i < COLS * MT * 8;
       i += cs * THREADS) {
    const int cl = i / (MT * 8), row = i % (MT * 8);
    const int gm = m0 + row, gc = n0 + cl;
    if (gm >= M || gc >= N) continue;
    // every load issued before the first add (they overlap), then summed
    // in rank and half order
    float v[2 * MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        v[2 * r + hf] =
            r < cs ? ld_cluster(&red[(hf * COLS + cl) * MT * 8 + row], r)
                   : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 2 * MAX_CLUSTER; ++r) sum += v[r];
    store(out, (size_t)gm * N + gc, sum, out_bf16);
  }
  // no CTA leaves while a peer may still read its shared memory
  opus_hopper::cluster_arrive();
  opus_hopper::cluster_wait();
}

template <int MT>
int launch(const void* x, const void* w, const void* gs, void* out, int M,
           int N, int K, int cs, int sb_per, int out_bf16,
           cudaStream_t stream) {
  using P = Plan<MT>;
  CUtensorMap wm;
  int rc = opus_hopper::make_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                                    (uint64_t)K / 8, (uint64_t)N, ROWS,
                                    PANEL_COLS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      int4_v2_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (M + 8 * MT - 1) / (8 * MT), (N + COLS - 1) / COLS);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = P::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;             // a plain launch saves ~1 us
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gs);
  void* args[] = {&wm, &xp, &gp, &out, &M, &N, &K, &sb_per, &out_bf16};
  e = cudaLaunchKernelExC(&cfg, (const void*)int4_v2_mma_kernel<MT>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace v2

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (M, K) bf16 (16-byte aligned); w (K/8, N) int32 words and gs
// (K/128, N) fp32, both 16-byte aligned; out (M, N) bf16 (out_bf16 = 1) or
// fp32. 1 <= M, K % 512 == 0, N % 4 == 0. mt: 8-row tiles of x a CTA (1 or
// 2); cs: CTAs a cluster (1-8), CTA x of a cluster taking superblocks
// [x sb_per, (x + 1) sb_per).
int opus_int4_matmul(const void* x, const void* w, const void* gs, void* out,
                     int M, int N, int K, int mt, int cs, int sb_per,
                     int out_bf16, void* stream) {
  if (M < 1 || N < 4 || N % 4 || K < 512 || K % 512 || sb_per < 1 ||
      cs < 1 || cs > v2::MAX_CLUSTER || (cs - 1) * sb_per >= K / 512 ||
      (mt != 1 && mt != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mt == 1)
    return v2::launch<1>(x, w, gs, out, M, N, K, cs, sb_per, out_bf16, st);
  return v2::launch<2>(x, w, gs, out, M, N, K, cs, sb_per, out_bf16, st);
}

}  // extern "C"
