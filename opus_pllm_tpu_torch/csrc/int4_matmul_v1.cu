// Hopper (sm_90a) int4 weight-only matmul, v1 nibble-byte layout (the QLoRA
// training layout): out = round(sum_g (x_g . q_g) * gscale[g]).
//
// Replaces the Pallas kernel of opus_pllm_tpu/kernels/quant4.py
// (`_int4_matmul_impl` / `_kernel`, pallas_call at :359): x (M, K) rounded
// to bf16 times int4 weights stored as bytes (K/2, N) int8, where byte row
// b * 128 + i holds row b * 256 + i of W in its low nibble and row
// b * 256 + 128 + i in its high nibble (two's complement, |q| <= 7); per
// 128-row group g an fp32 partial product, multiplied by the fp32
// gscale[g, n] before it is added to the fp32 accumulator; the sum rounded
// once to bf16 (or stored in fp32 for fp32 x).
//
// Bound: the tensor cores. At the training shape (M = 16 x 519 = 8304) a
// 4096 -> 14336 product is 2MNK = 0.98 TFLOP against 68 MB of activations
// and 29 MB of packed weights: thousands of FLOP per byte.
// Design (`int4_v1_wgmma_kernel`, the core in hopper_gemm.cuh): one CTA
// per 128 weight columns x 128 x rows. A producer warp keeps a 5-stage
// ring of TMA loads in flight on mbarriers; a stage is half of a 256-row
// block: 64 byte rows x 128 columns, loaded once, the two 64 K x 128 x
// boxes of the K rows they hold (low and high nibbles) and the block's two
// rows of group scales. Two consumer warpgroups widen their 64 columns to
// exact bf16 A fragments in registers (ldmatrix.trans, one lop3 into the
// 0x4300 exponent, minus 136) and run wgmma m64n128k16 on the transposed
// product, 32 K rows a step: the low nibbles of both halves make group 2b,
// the high ones group 2b + 1, so each byte feeds both wgmma chains, as the
// TPU kernel feeds `lo` and `hi` from one load. A group's products
// accumulate into an fp32 partial fragment beside the accumulator; at the
// group's end the partial times its fp32 column scales joins the
// accumulator. TMA zero-fills past M and N; K is a multiple of 256 (the
// layout's block).
// TMA needs 16-byte global strides: N % 16 == 0 (every Llama-3-8B shape,
// the vocab head included). Other N take `int4_v1_unaligned_kernel`, the
// earlier design kept for them: 128 x 128 tiles of 8 warps on mma.sync
// m16n8k16, 32-deep K tiles staged through registers into double-buffered
// shared memory, each 16-byte load of packed bytes unpacked to one nibble
// on its way in (each byte read twice), every load and store masked.
//
// The entry points return the cudaError_t of their launch (0 = success).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "mma_bf16.cuh"

typedef __nv_bfloat16 bf16;
using opus_mma::mma16816;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int GROUP = 128;                   // K rows per scale group
constexpr int THREADS = 256;                 // 8 warps: 2 (M) x 4 (N)
constexpr int A_LD = BK + 8;                 // padded smem row strides
constexpr int B_LD = BN + 8;
constexpr int A_TILE = BM * A_LD;            // elements per stage
constexpr int B_TILE = BK * B_LD;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(THREADS)
int4_v1_unaligned_kernel(const bf16* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ gscale,
                         void* __restrict__ out, int M, int N, int K,
                         int out_f32) {
  __shared__ __align__(128) bf16 As[2 * A_TILE];
  __shared__ __align__(128) bf16 Bs[2 * B_TILE];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool n_vec = (N % 16) == 0;

  // A: 128 x 32 bf16 = 512 chunks of 8, two per thread.
  // B: 32 K rows x 128 columns = 256 chunks of 16 packed bytes, one per
  //    thread; K row k sits in byte row (k / 256) * 128 + k % 128.
  const int brow = tid / (BN / 16), bcol = (tid % (BN / 16)) * 16;
  uint4 ra[2], rbv;
  int8_t* rb = reinterpret_cast<int8_t*>(&rbv);
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int m = m0 + row;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(x + (size_t)m * K +
                                                      k0 + col)
                    : make_uint4(0, 0, 0, 0);
    }
    const int k = k0 + brow;
    const size_t byte_row = (size_t)(k / (2 * GROUP)) * GROUP + k % GROUP;
    const int n = n0 + bcol;
    if (n_vec && n + 16 <= N) {
      rbv = *reinterpret_cast<const uint4*>(w + byte_row * N + n);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        rb[e] = n + e < N ? w[byte_row * N + n + e] : 0;
    }
  };
  // hi: the tile's rows are the high nibbles (the second group of a block)
  auto store_tiles = [&](int buf, bool hi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + buf * A_TILE + row * A_LD + col) = ra[i];
    }
    uint4 o[2];
    bf16* oe = reinterpret_cast<bf16*>(o);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int byte = rb[e];                        // sign-extended
      const int q = hi ? (byte >> 4) : ((int)((unsigned)byte << 28) >> 28);
      oe[e] = __int2bfloat16_rn(q);
    }
    uint4* dst = reinterpret_cast<uint4*>(Bs + buf * B_TILE + brow * B_LD +
                                          bcol);
    dst[0] = o[0];
    dst[1] = o[1];
  };

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  const int nk = K / BK;
  constexpr int TILES_PER_GROUP = GROUP / BK;
  load_tiles(0);
  store_tiles(0, false);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tiles((kt + 1) * BK);
    const bf16* Ab = As + buf * A_TILE;
    const bf16* Bb = Bs + buf * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* ap = Ab + (wm * 64 + i * 16 + g) * A_LD + kk + t * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[i][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * A_LD);
        af[i][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * A_LD + 8);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        // matrices: k 0-7 / 8-15 of n-tile 2jp, then of n-tile 2jp + 1
        const int mat = lane >> 3;
        const int krow = kk + (lane & 7) + (mat & 1) * 8;
        const int ncol = wn * 32 + jp * 16 + (mat >> 1) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bb + krow * B_LD + ncol);
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(part[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if (kt % TILES_PER_GROUP == TILES_PER_GROUP - 1) {
      // the group's partials times its fp32 column scales
      const float* srow = gscale + (size_t)(kt / TILES_PER_GROUP) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t * 2;
        const float s0 = n < N ? srow[n] : 0.f;
        const float s1 = n + 1 < N ? srow[n + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] += part[i][j][0] * s0;
          acc[i][j][1] += part[i][j][1] * s1;
          acc[i][j][2] += part[i][j][2] * s0;
          acc[i][j][3] += part[i][j][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
        }
      }
    }
    if (kt + 1 < nk)
      store_tiles(buf ^ 1, (((kt + 1) * BK) / GROUP) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t * 2;
        const float v0 = acc[i][j][2 * r], v1 = acc[i][j][2 * r + 1];
        const size_t at = (size_t)m * N + n;
        if (out_f32) {
          float* o = static_cast<float*>(out);
          if (n < N) o[at] = v0;
          if (n + 1 < N) o[at + 1] = v1;
        } else {
          bf16* o = static_cast<bf16*>(out);
          if (n + 1 < N && N % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + at) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < N) o[at] = __float2bfloat16(v0);
            if (n + 1 < N) o[at + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
}

__global__ void __cluster_dims__(opus_hopper::Plan<true>::CLUSTER, 1, 1)
__launch_bounds__(opus_hopper::THREADS, 1)
int4_v1_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap s_map,
                     const float* __restrict__ gscale,
                     void* __restrict__ out, int M, int N, int K,
                     int out_f32) {
  opus_hopper::mixed_gemm_core<true>(x_map, w_map, s_map, gscale, out, M, N,
                                     K, out_f32);
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (M, K) bf16, K % 256 == 0; w (K/2, N) int8 nibble bytes, N % 16 == 0;
// gscale (K/128, N) fp32 -> out (M, N) bf16, or fp32 when out_f32. Every
// buffer contiguous and 16-byte aligned.
int opus_int4_matmul_v1(const void* x, const void* w, const void* gscale,
                        void* out, int M, int N, int K, int out_f32,
                        void* stream) {
  return opus_hopper::launch_mixed_gemm<true>(
      int4_v1_wgmma_kernel, x, w, gscale, out, M, N, K, out_f32,
      static_cast<cudaStream_t>(stream));
}

// The same function for any N: x and w 16-byte aligned.
int opus_int4_matmul_v1_unaligned(const void* x, const void* w,
                                  const void* gscale, void* out, int M,
                                  int N, int K, int out_f32, void* stream) {
  if (K % (2 * GROUP)) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int4_v1_unaligned_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(gscale), out, M, N, K, out_f32);
  return (int)cudaGetLastError();
}

}  // extern "C"
