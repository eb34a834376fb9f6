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
// the vocab head included); the wrapper sends other N to the kernel's
// plain version.
//
// The entry point returns the cudaError_t of its launch (0 = success).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

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

}  // extern "C"
