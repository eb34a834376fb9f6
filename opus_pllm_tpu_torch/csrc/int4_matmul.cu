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
// Decode shapes (M = batch = 8) are weight-streaming with M fp32 FMAs per
// weight on the CUDA cores. A CTA of 8 warps owns 64 columns (2 per lane)
// and a range of superblocks; per superblock its warps take 8 word rows
// each, x is staged to shared memory as fp32 (8 x 512 = 16 KB, so no K is
// too long for shared memory), and each thread keeps four group partials
// per (row, column) before scaling them. The warps' sums are reduced in
// shared memory in a fixed order. When K is split over CTAs (gridDim.y > 1)
// each split writes fp32 partials to a workspace and a second launch adds
// them in split order: deterministic, no atomics.
//
// Entry point returns the cudaError_t of its launches (0 = success); it
// neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MT = 8;                      // rows of x per CTA
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 64;                   // columns per CTA, 2 per lane
constexpr int SUPER = 512;                 // K rows per superblock
constexpr int WROWS = SUPER / 8;           // word rows per superblock
constexpr int ROWS_PER_WARP = WROWS / WARPS;

// Two consecutive rows of group g from one word, as exact fp32 weights:
// .x = row 2i (low half-word), .y = row 2i + 1.
__device__ __forceinline__ float2 unpack_pair(uint32_t w, int g) {
  uint32_t bits = ((w >> (4 * g)) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&bits);
  v = __hsub2(v, __float2bfloat162_rn(136.f));
  return __bfloat1622float2(v);
}

__device__ __forceinline__ void store(void* out, size_t i, float v,
                                      int out_bf16) {
  if (out_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

__global__ void __launch_bounds__(THREADS, 2)
int4_v2_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ w,
               const float* __restrict__ gs, float* __restrict__ ws,
               void* __restrict__ out, int M, int N, int K, int sb_per,
               int out_bf16) {
  __shared__ __align__(16) float xs[MT][SUPER];
  __shared__ float red[WARPS][MT][COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * COLS + lane * 2;   // N is even: col+1 < N too
  const int m0 = blockIdx.z * MT;
  const int sb0 = blockIdx.y * sb_per;
  const int sb1 = min(sb0 + sb_per, K / SUPER);
  const bool live = col < N;

  float acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.f;

  for (int sb = sb0; sb < sb1; ++sb) {
    __syncthreads();                 // the previous superblock's reads done
    for (int i = threadIdx.x; i < MT * SUPER / 8; i += THREADS) {
      const int m = i / (SUPER / 8), kc = (i % (SUPER / 8)) * 8;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (m0 + m < M) {
        uint4 raw = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + m) * K + (size_t)sb * SUPER + kc);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
      }
      *reinterpret_cast<float4*>(&xs[m][kc]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&xs[m][kc + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    if (!live) continue;

    float part[4][MT][2];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int m = 0; m < MT; ++m) part[g][m][0] = part[g][m][1] = 0.f;

    const int r0 = warp * ROWS_PER_WARP;           // first word row here
    const uint32_t* wp = w + ((size_t)sb * WROWS + r0) * N + col;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; r += 2) {
      const uint2 wa = *reinterpret_cast<const uint2*>(wp + (size_t)r * N);
      const uint2 wb =
          *reinterpret_cast<const uint2*>(wp + (size_t)(r + 1) * N);
      const int krow = 2 * (r0 + r);               // row of group g: +128g
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 a0 = unpack_pair(wa.x, g), a1 = unpack_pair(wb.x, g);
        const float2 b0 = unpack_pair(wa.y, g), b1 = unpack_pair(wb.y, g);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[m][g * 128 + krow]);
          part[g][m][0] += xv.x * a0.x + xv.y * a0.y + xv.z * a1.x +
                           xv.w * a1.y;
          part[g][m][1] += xv.x * b0.x + xv.y * b0.y + xv.z * b1.x +
                           xv.w * b1.y;
        }
      }
    }
    // the four groups' fp32 scales, applied to the fp32 partials
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 s = *reinterpret_cast<const float2*>(
          gs + ((size_t)sb * 4 + g) * N + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][0] += part[g][m][0] * s.x;
        acc[m][1] += part[g][m][1] * s.y;
      }
    }
  }

  // sum the warps' K slices in a fixed order
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    red[warp][m][lane * 2] = acc[m][0];
    red[warp][m][lane * 2 + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    const int gm = m0 + m, gc = blockIdx.x * COLS + c;
    if (gm >= M || gc >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[k][m][c];
    if (ws != nullptr)
      ws[((size_t)blockIdx.y * M + gm) * N + gc] = s;
    else
      store(out, (size_t)gm * N + gc, s, out_bf16);
  }
}

// out[i] = sum over splits, in split order, of ws[split][i]
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  void* __restrict__ out, size_t MN,
                                  int splits, int out_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[(size_t)k * MN + i];
  store(out, i, s, out_bf16);
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (M, K) bf16; w (K/8, N) int32 words; gs (K/128, N) fp32; out (M, N)
// bf16 (out_bf16 = 1) or fp32. K % 512 == 0, N even. splits > 1 needs ws:
// fp32 (splits, M, N). Split y covers superblocks [y*sb_per, (y+1)*sb_per).
int opus_int4_matmul(const void* x, const void* w, const void* gs, void* ws,
                     void* out, int M, int N, int K, int sb_per, int splits,
                     int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 2 || N % 2 || K % SUPER || sb_per < 1 || splits < 1 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + COLS - 1) / COLS, splits, (M + MT - 1) / MT);
  int4_v2_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(gs), splits > 1 ? static_cast<float*>(ws)
                                                : nullptr,
      out, M, N, K, sb_per, out_bf16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t mn = (size_t)M * N;
  splitk_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), out, mn, splits, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
