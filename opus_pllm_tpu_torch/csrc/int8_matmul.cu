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
// TMA needs 16-byte global strides: N % 16 == 0 (every Llama-3-8B shape);
// the wrapper sends other N to the kernel's plain version.
//
// The entry point returns the cudaError_t of its launch (0 = success).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

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

}  // extern "C"
