// Hopper (sm_90a) int8 weight-only matmul: out = round((x . q) * scale).
//
// Replaces the Pallas kernel of opus_pllm_tpu/kernels/quant.py
// (`_int8_matmul_impl` / `_kernel`, pallas_call at :142): x (M, K) bf16
// times int8 q (K, N), fp32 accumulation, times the fp32 per-column scale,
// rounded once to bf16.
//
// Bound: the tensor cores (2MNK bf16 FLOP over ~M*K*2 + K*N + M*N*2 bytes;
// thousands of FLOP per byte at the serving prefill's M = 5120).
// Design (`int8_matmul_wgmma_kernel`, the core in hopper_gemm.cuh): one
// CTA per 128 weight columns x 256 x rows, in clusters of two CTAs that
// share the x rows. A producer warp keeps a 5-stage ring of TMA loads in
// flight on mbarriers: per stage a 64 K x 256 x box (128-byte swizzle),
// each CTA loading half of it and multicasting it to both, and the raw
// 64 x 128 int8 box. Two consumer warpgroups widen their 64 columns of
// each stage to exact bf16 A fragments in registers (ldmatrix.trans, then
// the fp32 2^23 magic: no conversion instruction a weight) and run wgmma
// m64n256k16 with fp32 accumulators in registers on the transposed
// product out^T = W^T x^T, widening the next stage while one runs. The
// scale multiplies the fp32 sums in the registers, one rounding, a store
// from the registers masked at ragged M and N. TMA zero-fills past M, N
// and K, so K only needs to be a multiple of 8 (16 by the wrapper's gate).
// TMA needs 16-byte global strides: N % 16 == 0 (every Llama-3-8B shape).
// Other N take `int8_matmul_unaligned_kernel`, the earlier design kept for
// them: one CTA per 128 x 128 tile, 8 warps of WMMA 16x16x16, a K loop of
// 32-deep tiles staged through registers into double-buffered shared
// memory, each weight widened on its way in, the epilogue through a 16 x 16
// fp32 scratch per warp, every load and store masked.
//
// The entry points return the cudaError_t of their launch (0 = success).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;                 // 8 warps: 2 (M) x 4 (N)
constexpr int A_LD = BK + 8;                 // padded smem row strides
constexpr int B_LD = BN + 8;
constexpr int A_TILE = BM * A_LD;            // elements per stage
constexpr int B_TILE = BK * B_LD;

__global__ void __launch_bounds__(THREADS)
int8_matmul_unaligned_kernel(const bf16* __restrict__ x,
                             const int8_t* __restrict__ w,
                             const float* __restrict__ scale,
                             bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2 * A_TILE];
  __shared__ __align__(128) bf16 Bs[2 * B_TILE];
  __shared__ __align__(128) float Cs[8][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool n_vec = (N % 16) == 0;

  // A: 128 x 32 bf16 = 512 chunks of 8, two per thread.
  // B: 32 x 128 int8 = 256 chunks of 16, one per thread.
  uint4 ra[2], rbv;
  int8_t* rb = reinterpret_cast<int8_t*>(&rbv);
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int m = m0 + row, k = k0 + col;
      ra[i] = (m < M && k < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k)
                  : make_uint4(0, 0, 0, 0);
    }
    const int brow = tid / (BN / 16), bcol = (tid % (BN / 16)) * 16;
    const int k = k0 + brow, n = n0 + bcol;
    if (k < K && n_vec && n + 16 <= N) {
      rbv = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        rb[e] = (k < K && n + e < N) ? w[(size_t)k * N + n + e] : 0;
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + buf * A_TILE + row * A_LD + col) = ra[i];
    }
    const int brow = tid / (BN / 16), bcol = (tid % (BN / 16)) * 16;
    uint4 o[2];
    bf16* oe = reinterpret_cast<bf16*>(o);
#pragma unroll
    for (int e = 0; e < 16; ++e) oe[e] = __float2bfloat16((float)rb[e]);
    uint4* dst = reinterpret_cast<uint4*>(Bs + buf * B_TILE + brow * B_LD +
                                          bcol);
    dst[0] = o[0];
    dst[1] = o[1];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tiles((kt + 1) * BK);
    const bf16* Ab = As + buf * A_TILE;
    const bf16* Bb = Bs + buf * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], Ab + (wm * 64 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bb + kk * B_LD + wn * 32 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tiles(buf ^ 1);
    __syncthreads();
  }

  // Epilogue, one 16 x 16 fragment at a time through the warp's scratch:
  // each lane takes 8 consecutive columns of one row.
  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 64 + i * 16 + r;
      const int n = n0 + wn * 32 + j * 16 + c;
      if (m < M) {
        if (n + 8 <= N && N % 8 == 0) {
          uint4 o4;
          bf16* oe = reinterpret_cast<bf16*>(&o4);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            oe[e] = __float2bfloat16(cs[r * 16 + c + e] * scale[n + e]);
          *reinterpret_cast<uint4*>(out + (size_t)m * N + n) = o4;
        } else {
          for (int e = 0; e < 8 && n + e < N; ++e)
            out[(size_t)m * N + n + e] =
                __float2bfloat16(cs[r * 16 + c + e] * scale[n + e]);
        }
      }
      __syncwarp();
    }
}

__global__ void __cluster_dims__(opus_hopper::Plan<false>::CLUSTER, 1, 1)
__launch_bounds__(opus_hopper::THREADS, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap s_map,
                         const float* __restrict__ scale,
                         void* __restrict__ out, int M, int N, int K,
                         int out_f32) {
  opus_hopper::mixed_gemm_core<false>(x_map, w_map, s_map, scale, out, M, N,
                                      K, out_f32);
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (M, K) bf16, K % 8 == 0; w (K, N) int8, N % 16 == 0; scale (N,) fp32
// -> out (M, N) bf16. Every buffer contiguous; x and w 16-byte aligned.
int opus_int8_matmul(const void* x, const void* w, const void* scale,
                     void* out, int M, int N, int K, void* stream) {
  return opus_hopper::launch_mixed_gemm<false>(
      int8_matmul_wgmma_kernel, x, w, scale, out, M, N, K, 0,
      static_cast<cudaStream_t>(stream));
}

// The same function for any N (K % 16 == 0): x and w 16-byte aligned.
int opus_int8_matmul_unaligned(const void* x, const void* w,
                               const void* scale, void* out, int M, int N,
                               int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_unaligned_kernel<<<grid, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
