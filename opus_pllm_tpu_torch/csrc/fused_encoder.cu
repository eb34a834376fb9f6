// Hopper (sm_90a) kernels for the ESM2 encoder block.
//
// Port of the four Pallas kernels in opus_pllm_tpu/kernels/fused_encoder.py
// (fused_ln_qkv_rope, flash_attention_pairs, fused_out_proj, fused_ffn).
// Each computes what its TPU kernel computes; the TPU's pair-packed
// (.., H/2, S, 128) layout is not carried over. Layouts here:
//   qkv  : (3, B, H, S, 64) head-major, rope applied to q and k
//   attn : (B, S, H*64) token-major, read directly by the out projection
//
// LN + QKV + rope (`fused_ln_qkv_rope`) and the FFN (`fused_ffn`): a
// LayerNorm pass (one warp per row, the one-pass E[x^2] - mu^2 in fp32)
// writes r = LN(x) rounded to bf16, as the TPU kernel rounds it, into a
// (M, E) scratch; then the TMA + wgmma core of hopper_gemm_bf16.cuh reads r
// as its A operand:
//   ln_qkv_rope : r . W (W (3, E, E) as a (3 E, E) view: a column tile lies
//                 inside one of q, k, v), bias + rotate_half rope from the
//                 registers, stored head-major;
//   ffn (1/2)   : r . W1, bias + exact-erf gelu, rounded to bf16 into a
//                 (M, F) scratch (the TPU kernel's rounding before FC2);
//   ffn (2/2)   : hidden . W2, bias + the residual x, one rounding.
// The out projection (`fused_out_proj`) is the same core's product with
// FC2's arithmetic: A is the token-major attention output (B * S, E) as the
// attention kernel writes it (no relayout), W_o (E, E) the N-major B,
// bias + the residual x added to the fp32 sums and rounded once. Its
// epilogue moves whole tiles by TMA (`OutProjEpi`): the residual tile is
// loaded while the tile's K loop runs and the output stored while the next
// one's runs, so only the in-place add holds the tensor cores (the staged
// epilogue of FC2 left them idle a third of out_proj's time at K = 1280).
// Bound at B = 8, S = 512 (M = 4096, E = 1280, F = 5120): 40 GFLOP (QKV),
// 107 GFLOP (FFN) and 13.4 GFLOP (out) against ~52, ~47 and ~35 MB of
// inputs and outputs: tensor-core bound (0.041, 0.109 and 0.014 ms at 989
// TFLOP/s). The LN pass moves ~21 MB (~6 us at 3.35 TB/s), the gelu
// scratch 42 MB each way.
// Tile plan (`fused_encoder.tile_width` chooses the width and passes it):
// 128 rows x 256, 160 (not for QKV: not whole heads) or 128 columns,
// whichever needs the fewest rounds of 132 persistent CTAs times the
// tile's width (ties: the wider, whose weight panels serve more rows). At
// M = 4096: QKV 480 tiles of 256 (3.6 rounds), FC1 640 of 256 (4.8), FC2
// and the out projection (N = 1280) 256 of 160 (1.9 rounds; 320 of 128
// take 2.4, 160 of 256 leave the card half idle in their second round). At
// M = 1024 (S = 128): QKV 120 of 256, FC1 256 of 160, FC2 and out 80 of
// 128. A 128 x 256 tile holds 128 fp32 accumulators a consumer thread,
// inside the 168 registers a 384-thread block gives (ptxas: 168 used, no
// spill). The epilogue is not overlapped with the products (both
// warpgroups finish a tile together): on an H100 it takes about a quarter
// of ln_qkv_rope's time and a fifth of ffn's (the rope, the exact-erf gelu
// of 21 M values, the stores).
//
// The encoder attention (`flash_attention_pairs` / `_flash_pairs_kernel`):
// non-causal, D = 64, scale 1/8, a (B, S) key-row mask. Per query row over
// the valid keys: an online softmax in fp32 (base 2), the numerators rounded
// to bf16 for P . V, out = acc / max(l, 1e-30). A masked key gets p = 0
// exactly, so a row with a valid key gets the TPU kernel's function (its
// -1e30 logits give exp(-1e30 - m) = 0); a batch row with no valid key gets
// out 0 (the TPU kernel averages v there; no path has such a row: every
// ESM2 row keeps CLS and EOS). Bound: at B = 8, S = 512, H = 20 and the
// annotate path's padding, ~7.7 GFLOP over the valid (query, key) pairs
// (0.008 ms at 989 TFLOP/s) against q, out and the valid keys' k and v
// (~36 MB, 0.011 ms at 3.35 TB/s): the bytes, a little ahead. Design (the
// pieces of hopper_attention.cuh):
//   - The entry point packs the mask into one 64-bit word per (batch row,
//     64-key tile), shared by every query row and head of the batch row
//     (`pack_key_words`, one warp a word), launched inside the wrapper's one
//     counted call; without a mask the words are computed.
//   - One CTA per (128 query rows, head, batch row), the query tiles of one
//     (batch row, head) next to each other in the grid (they share K and V
//     in L2): 640 CTAs at S = 512.
//   - TMA loads through 4-D tensor maps over each of the q, k and v planes
//     as (B, S, H, 64) with head-major strides (no transpose); 64 columns
//     are one 128-byte swizzled panel. Rows past S are zero-filled.
//   - 256 threads, two consumer warpgroups of 64 query rows and no producer
//     warp: thread 0 loads the Q tile and fills a 4-stage ring of K and V
//     tiles, refilling each stage once every warp has released it. It reads
//     the tile's word: a tile false everywhere (the padded tail) is neither
//     loaded nor computed, one true everywhere needs no per-element mask.
//     Without a ninth warp the block fits two CTAs an SM at 128 registers a
//     thread (with a producer warp ptxas granted 96, spilled and serialised
//     the wgmma).
//   - Each warpgroup: S = Q . K^T by wgmma m64n64k16 from shared memory,
//     the online softmax on the fp32 accumulators, P packed to bf16 A
//     fragments in registers, O += P . V by wgmma m64n64k16 with V as the
//     N-major B operand. O 32, S 32 and P 16 registers a thread.
//
// Every entry point returns the cudaError_t of its launches (0 = success);
// the Python wrapper raises on anything else. Nothing here allocates or
// synchronises: the wrapper allocates outputs and scratch with torch and
// passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm_bf16.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// LayerNorm rows: r = LN(x) rounded to bf16 (the TPU kernel's rounding
// point), the A operand of the QKV and FC1 products
// ---------------------------------------------------------------------------

// One warp per row: mu and 1 / sqrt(max(E[x^2] - mu^2, 0) + eps) in fp32
// (the one-pass variance both packages keep), then the row again (from L1)
// normalised, times gamma, plus beta, 16 bytes a lane.
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
               const bf16* __restrict__ beta, bf16* __restrict__ r, int M,
               int K, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      s += f;
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / K;
  const float rstd = 1.f / sqrtf(fmaxf(ss / K - mu * mu, 0.f) + eps);
  bf16* rr = r + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const uint4 g4 = *reinterpret_cast<const uint4*>(gamma + k);
    const uint4 b4 = *reinterpret_cast<const uint4*>(beta + k);
    const bf16* xe = reinterpret_cast<const bf16*>(&v);
    const bf16* ge = reinterpret_cast<const bf16*>(&g4);
    const bf16* be = reinterpret_cast<const bf16*>(&b4);
    uint4 o4;
    bf16* oe = reinterpret_cast<bf16*>(&o4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      oe[i] = __float2bfloat16((__bfloat162float(xe[i]) - mu) * rstd *
                                   __bfloat162float(ge[i]) +
                               __bfloat162float(be[i]));
    *reinterpret_cast<uint4*>(rr + k) = o4;
  }
}

cudaError_t launch_ln_rows(const bf16* x, const bf16* ln, bf16* r, int M,
                           int K, float eps, cudaStream_t st) {
  ln_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, ln, ln + K, r, M, K, eps);
  return cudaGetLastError();
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// Epilogues of the TMA + wgmma core (hopper_gemm_bf16.cuh)
// ---------------------------------------------------------------------------

// Staging rows: 64 bf16 (128 B) or 64 fp32 (256 B), padded by 16 / 32 B so
// that the fragment writes of a warp (rows g, columns 2 (lane % 4)) fall in
// 32 different banks.
constexpr int STG_BF16 = 128 + 16;
constexpr int STG_F32 = 256 + 32;

// The bias of a chunk of NC columns (n + 8 j + 2 (lane % 4), + 1) added to
// both rows.
template <int NC>
__device__ __forceinline__ void add_bias(float* v, const bf16* bias, int n,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + n + 8 * j + 2 * t));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v[4 * j + 2 * r] += b.x;
      v[4 * j + 2 * r + 1] += b.y;
    }
  }
}

// A chunk's values, rounded to bf16, into the staging rows.
template <int NC>
__device__ __forceinline__ void stage_bf16(const float* v, uint8_t* stg,
                                           int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          stg + (16 * warp + g + 8 * r) * STG_BF16 + (8 * j + 2 * t) * 2) =
          __floats2bfloat162_rn(v[4 * j + 2 * r], v[4 * j + 2 * r + 1]);
}

// A staged bf16 chunk to row-major (M, N) rows, 16 bytes a store.
template <int NC>
__device__ __forceinline__ void store_rows(const uint8_t* stg, bf16* out,
                                           int M, int N, int row0, int n,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < NC / 16; ++i) {
    const int u = tid + 128 * i, row = u / (NC / 8), ch = u % (NC / 8);
    const int m = row0 + row;
    if (m >= M) continue;
    *reinterpret_cast<uint4*>(out + (size_t)m * N + n + 8 * ch) =
        *reinterpret_cast<const uint4*>(stg + row * STG_BF16 + 16 * ch);
  }
}

// LN + QKV: bias, then rotate_half rope on q and k (d < 32 takes -t[d+32],
// d >= 32 takes t[d-32]); a 64-column chunk is one head, so the partner of
// fragment j < 4 is fragment j + 4 of the same thread, and a thread's cos
// and sin values (its rows, its columns d) are the same for every head of
// the tile: loaded once a tile, 16 at a time. Stored head-major: one
// 128-byte row piece per (token, head) of the (3, B, H, S, 64) output.
// Tile widths 128 and 256 only (whole heads).
struct QkvRopeEpi : opus_bf16::StagedEpi {
  static constexpr int STG_ROW = STG_BF16;
  static constexpr bool WHOLE_HEADS = true;
  struct Args {
    const bf16* bias;            // (3 E,)
    const float* cos;            // (S, 64)
    const float* sin;
    bf16* out;
    int M, S, E, H;
  };
  template <int BN>
  static __device__ __forceinline__ void tile(const Args& a, float* acc,
                                              int row0, int n0, int warp,
                                              int lane) {
    static_assert(BN % 64 == 0, "a QKV tile holds whole heads");
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      add_bias<64>(acc + 32 * c, a.bias, n0 + 64 * c, t);
    if (n0 / a.E >= 2) return;               // v: no rope
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = row0 + 16 * warp + g + 8 * r;
      const int s = (m < a.M ? m : 0) % a.S;
      const float* cs = a.cos + (size_t)s * 64;
      const float* sn = a.sin + (size_t)s * 64;
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // fragments 2h, 2h + 1
        float2 c0[2], s0[2], c1[2], s1[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int d = 8 * (2 * h + q) + 2 * t;
          c0[q] = *reinterpret_cast<const float2*>(cs + d);
          s0[q] = *reinterpret_cast<const float2*>(sn + d);
          c1[q] = *reinterpret_cast<const float2*>(cs + d + 32);
          s1[q] = *reinterpret_cast<const float2*>(sn + d + 32);
        }
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float* lo = acc + 32 * c + 4 * (2 * h + q) + 2 * r;
            float* hi = lo + 16;             // fragment j + 4
            const float l0 = lo[0], l1 = lo[1], h0 = hi[0], h1 = hi[1];
            lo[0] = l0 * c0[q].x - h0 * s0[q].x;
            lo[1] = l1 * c0[q].y - h1 * s0[q].y;
            hi[0] = h0 * c1[q].x + l0 * s1[q].x;
            hi[1] = h1 * c1[q].y + l1 * s1[q].y;
          }
      }
    }
  }
  template <int NC>
  static __device__ __forceinline__ void stage(const Args&, float* v,
                                               uint8_t* stg, int, int,
                                               int warp, int lane) {
    stage_bf16<NC>(v, stg, warp, lane);
  }
  template <int NC>
  static __device__ __forceinline__ void store(const Args& a,
                                               const uint8_t* stg, int row0,
                                               int n, int tid) {
    static_assert(NC == 64, "one head a chunk");
    const int j = n / a.E, h = (n - j * a.E) / 64, bsz = a.M / a.S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + 128 * i, row = u >> 3, ch = u & 7;
      const int m = row0 + row;
      if (m >= a.M) continue;
      const int b = m / a.S, s = m - b * a.S;
      bf16* dst = a.out + ((((size_t)j * bsz + b) * a.H + h) * a.S + s) * 64 +
                  8 * ch;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(stg + row * STG_BF16 + 16 * ch);
    }
  }
};

// FC1: bias, exact-erf gelu, rounded to bf16 into the (M, F) hidden
// scratch (the TPU kernel's rounding before FC2).
struct GeluEpi : opus_bf16::StagedEpi {
  static constexpr int STG_ROW = STG_BF16;
  static constexpr bool WHOLE_HEADS = false;
  struct Args {
    const bf16* bias;            // (F,)
    bf16* out;                   // (M, F)
    int M, N;
  };
  template <int BN>
  static __device__ __forceinline__ void tile(const Args&, float*, int, int,
                                              int, int) {}
  template <int NC>
  static __device__ __forceinline__ void stage(const Args& a, float* v,
                                               uint8_t* stg, int, int n,
                                               int warp, int lane) {
    add_bias<NC>(v, a.bias, n, lane & 3);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) v[i] = gelu_erf(v[i]);
    stage_bf16<NC>(v, stg, warp, lane);
  }
  template <int NC>
  static __device__ __forceinline__ void store(const Args& a,
                                               const uint8_t* stg, int row0,
                                               int n, int tid) {
    store_rows<NC>(stg, a.out, a.M, a.N, row0, n, tid);
  }
};

// FC2: bias in the registers, staged in fp32; then the residual x (16-byte
// loads) added and the sum rounded once.
struct ResidualEpi : opus_bf16::StagedEpi {
  static constexpr int STG_ROW = STG_F32;
  static constexpr bool WHOLE_HEADS = false;
  struct Args {
    const bf16* bias;            // (N,)
    const bf16* res;             // (M, N)
    bf16* out;                   // (M, N)
    int M, N;
  };
  template <int BN>
  static __device__ __forceinline__ void tile(const Args&, float*, int, int,
                                              int, int) {}
  template <int NC>
  static __device__ __forceinline__ void stage(const Args& a, float* v,
                                               uint8_t* stg, int, int n,
                                               int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
    add_bias<NC>(v, a.bias, n, t);
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            stg + (16 * warp + g + 8 * r) * STG_F32 + (8 * j + 2 * t) * 4) =
            make_float2(v[4 * j + 2 * r], v[4 * j + 2 * r + 1]);
  }
  template <int NC>
  static __device__ __forceinline__ void store(const Args& a,
                                               const uint8_t* stg, int row0,
                                               int n, int tid) {
#pragma unroll
    for (int i = 0; i < NC / 16; ++i) {
      const int u = tid + 128 * i, row = u / (NC / 8), ch = u % (NC / 8);
      const int m = row0 + row;
      if (m >= a.M) continue;
      const size_t at = (size_t)m * a.N + n + 8 * ch;
      const float4 lo =
          *reinterpret_cast<const float4*>(stg + row * STG_F32 + 32 * ch);
      const float4 hi = *reinterpret_cast<const float4*>(
          stg + row * STG_F32 + 32 * ch + 16);
      const uint4 x4 = *reinterpret_cast<const uint4*>(a.res + at);
      const bf16* xe = reinterpret_cast<const bf16*>(&x4);
      const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint4 o4;
      bf16* oe = reinterpret_cast<bf16*>(&o4);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        oe[e] = __float2bfloat16(f[e] + __bfloat162float(xe[e]));
      *reinterpret_cast<uint4*>(a.out + at) = o4;
    }
  }
};

// The out projection: out = (acc + bias) + x, rounded once (FC2's
// arithmetic), as a tile-I/O epilogue: the producer loads the residual
// tile x into the buffer by TMA while the tile's K loop runs, each thread
// adds its accumulators and bias (loaded into registers before the K
// loop) to its residual pairs there and writes the rounded sums back in
// place, and one thread a warpgroup stores its 64 rows by TMA. Buffer
// layout: a warpgroup's 64 rows as BN / 32 boxes of 64 rows x 32 columns
// (4 KB, 64-byte rows), the 16-byte chunk c of row r at c ^ ((r / 2) % 4)
// (the 64-byte swizzle); a warp's pairs (rows g, columns 8 j + 2 (lane %
// 4)) then fall in 32 different banks.
struct OutProjEpi {
  static constexpr bool WHOLE_HEADS = false;
  static constexpr bool WIDE = false;          // 128 or 160 (the buffer)
  static constexpr bool TILE_IO = true;
  typedef ResidualEpi::Args Args;
  template <int BN>
  struct Pre {
    __nv_bfloat162 bias[BN / 8];
  };
  template <int BN>
  static __device__ __forceinline__ void prefetch(const Args& a, Pre<BN>& p,
                                                  int, int n0, int,
                                                  int lane) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      p.bias[j] = *reinterpret_cast<const __nv_bfloat162*>(
          a.bias + n0 + 8 * j + 2 * (lane & 3));
  }
  template <int BN>
  static __device__ __forceinline__ void tile_io(const Args&, float* acc,
                                                 const Pre<BN>& p,
                                                 uint8_t* half, int warp,
                                                 int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 b = __bfloat1622float2(p.bias[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
            half + (j >> 2) * opus_bf16::IO_BOX_BYTES + row * 64 +
            (((j & 3) ^ ((row >> 1) & 3)) << 4) + 4 * t);
        const float2 x = __bfloat1622float2(*at);
        *at = __floats2bfloat162_rn((acc[4 * j + 2 * r] + b.x) + x.x,
                                    (acc[4 * j + 2 * r + 1] + b.y) + x.y);
      }
    }
  }
};

// A product of the core at tile width bn: 128, 256 where the epilogue
// takes it, 160 where it is not per head.
template <class Epi>
int launch_product(int bn, const void* a, const void* w,
                   const opus_bf16::GemmShape& g,
                   const typename Epi::Args& ea, cudaStream_t st) {
  if constexpr (Epi::WIDE)
    if (bn == 256)
      return opus_bf16::launch_bf16_gemm<256, Epi>(a, w, g, ea, st);
  if (bn == 128)
    return opus_bf16::launch_bf16_gemm<128, Epi>(a, w, g, ea, st);
  if constexpr (!Epi::WHOLE_HEADS)
    if (bn == 160)
      return opus_bf16::launch_bf16_gemm<160, Epi>(a, w, g, ea, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Encoder attention: non-causal flash forward at d = 64 (TMA + wgmma)
// ---------------------------------------------------------------------------

namespace enc {

using namespace opus_attn;
using opus_hopper::fence_regs;
using opus_hopper::mbar_wait;
using opus_hopper::wgmma_commit;
using opus_hopper::wgmma_fence;
using opus_hopper::wgmma_wait;

constexpr int HD = 64;
constexpr int QR = 128;                         // query rows a CTA
constexpr int THREADS = 256;                    // two warpgroups of 64 rows
constexpr int STAGES = 4;
constexpr int Q_BYTES = QR * PANEL_ROW_BYTES;   // one 128-byte-swizzled panel
constexpr int KV_BYTES = 64 * PANEL_ROW_BYTES;
constexpr int STAGE_BYTES = 2 * KV_BYTES;       // K tile, then V tile
constexpr float LOG2E = 1.4426950408889634f;

// What a stage carries besides its tiles: the key tile's first key (-1:
// the sweep is over), whether every key of it is valid, and its key word.
struct Meta {
  int k0;
  int full;
  uint64_t word;
};

constexpr int META_OFF = Q_BYTES + STAGES * STAGE_BYTES;
constexpr int BAR_OFF = META_OFF + STAGES * (int)sizeof(Meta);
constexpr int SMEM_BYTES = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;

// The (B, S) key mask as one 64-bit word per (batch row, 64-key tile): bit
// j of word (b, t) = mask[b, 64 t + j] (0 past S). One warp per word.
__global__ void __launch_bounds__(256)
pack_key_words(const uint8_t* __restrict__ mask, uint64_t* __restrict__ words,
               int B, int S) {
  const int nt = (S + 63) / 64;
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B * nt) return;
  const int b = w / nt, j = 64 * (w % nt) + lane;
  const uint8_t* row = mask + (size_t)b * S;
  const uint32_t lo = __ballot_sync(0xffffffffu, j < S && row[j] != 0);
  const uint32_t hi =
      __ballot_sync(0xffffffffu, j + 32 < S && row[j + 32] != 0);
  if (lane == 0) words[w] = (uint64_t)lo | ((uint64_t)hi << 32);
}

// Thread 0 of the CTA fills the K / V ring: it puts the next key tile that
// has a valid key (from tile *t on) into stage u % STAGES once every warp
// has released that stage, with its word, or, past the last one, the end
// marker (k0 = -1). Returns true once the marker is in.
__device__ __forceinline__ bool put_tile(int u, int* t, int nt, int S, int h,
                                         int b, const uint64_t* words,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         uint8_t* stages, Meta* meta,
                                         uint64_t* full, uint64_t* empty) {
  const int s = u % STAGES;
  mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
  for (; *t < nt; ++*t) {
    const uint64_t w = words != nullptr ? words[(size_t)b * nt + *t]
                                        : bit_range(0, S - 64 * *t);
    if (w == 0) continue;                      // padding only: skipped
    meta[s].k0 = 64 * *t;
    meta[s].full = w == ~0ull;
    meta[s].word = w;
    uint8_t* st = stages + s * STAGE_BYTES;
    opus_hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
    tma_load_4d(st, k_map, &full[s], 0, h, 64 * *t, b);
    tma_load_4d(st + KV_BYTES, v_map, &full[s], 0, h, 64 * *t, b);
    ++*t;
    return false;
  }
  meta[s].k0 = -1;
  mbar_arrive(&full[s]);
  return true;
}

// One CTA per (128 query rows, head, batch row); the notes at the top of the
// file give the design.
__global__ void __launch_bounds__(THREADS, 2)
encoder_attn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const uint64_t* __restrict__ words,
                          bf16* __restrict__ out, int H, int S) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* stages = smem + Q_BYTES;
  Meta* meta = reinterpret_cast<Meta*>(smem + META_OFF);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * QR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (S + 63) / 64;
  int next = 0;                 // thread 0: the next key tile to look at
  bool ended = false;           // thread 0: the end marker is in the ring
  if (threadIdx.x == 0) {
    opus_hopper::mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      opus_hopper::mbar_init(&full[s], 1);
      opus_hopper::mbar_init(&empty[s], THREADS / 32);
    }
    opus_hopper::fence_barrier_init();
    opus_hopper::prefetch_map(&q_map);
    opus_hopper::prefetch_map(&k_map);
    opus_hopper::prefetch_map(&v_map);
    opus_hopper::mbar_arrive_expect_tx(qfull, Q_BYTES);
    tma_load_4d(qs, &q_map, qfull, 0, h, q0, b);
    for (int u = 0; u < STAGES && !ended; ++u)
      ended = put_tile(u, &next, nt, S, h, b, words, &k_map, &v_map, stages,
                       meta, full, empty);
  }
  __syncthreads();

  // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 ----
  const int wg = warp >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const float c = 0.125f * LOG2E;                           // base-2 logits
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};

  mbar_wait(qfull, 0);
  for (int u = 0;; ++u) {
    const int s = u % STAGES;
    mbar_wait(&full[s], (u / STAGES) & 1);
    if (meta[s].k0 < 0) break;
    const uint8_t* ks = stages + s * STAGE_BYTES;
    const uint8_t* vs = ks + KV_BYTES;

    // S = Q K^T (64 rows x 64 keys), both operands in shared memory
    float sacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sacc, desc_k(qs + wg * 8192) + 2 * kk,
                   desc_k(ks) + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc, 32);

    // online softmax (base 2); an invalid key: -inf, p = 0 exactly
    const bool all_true = meta[s].full;
    const uint64_t word = meta[s].word;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
      float x = sacc[i] * c;
      if (!all_true && !((word >> col) & 1)) x = -INFINITY;
      sacc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2_approx(sacc[i] - mx[r]);
      sacc[i] = p;
      l_run[r] += p;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: P (rounded to bf16) from registers, V N-major
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(sacc, kk, pa + 4 * kk);
    const uint64_t vd = desc_mn(vs, KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)               // 16 keys: 2048 B of rows
      wgmma_rs_n64_mn(o, pa + 4 * kk, vd + kk * (2048 >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o, HD / 2);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // refill the stage just released (thread 0 waits for every warp)
    if (threadIdx.x == 0 && !ended)
      ended = put_tile(u + STAGES, &next, nt, S, h, b, words, &k_map, &v_map,
                       stages, meta, full, empty);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= S) continue;
    // no valid key in the row: l = 0 and o = 0, so out 0
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* dst = out + (((size_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
  }
}

}  // namespace enc

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes; every pointer and the stream as void*)
// ---------------------------------------------------------------------------

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (B*S, E) -> qkv (3, B, H, S, 64); w (3, E, E); b (3, E); ln (2, E)
// [scale; bias]; cos/sin (S, 64) fp32; normed: bf16 scratch (B * S, E) for
// LN(x); bn: the product's tile width (128 or 256, dividing E).
int opus_ln_qkv_rope(const void* x, const void* w, const void* b,
                     const void* ln, const void* cos, const void* sin,
                     void* out, void* normed, int B, int S, int E, float eps,
                     int bn, void* stream) {
  if (B < 1 || S < 1 || E % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const cudaError_t e =
      launch_ln_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(ln),
                     static_cast<bf16*>(normed), M, E, eps, st);
  if (e != cudaSuccess) return (int)e;
  QkvRopeEpi::Args a = {};
  a.bias = static_cast<const bf16*>(b);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.out = static_cast<bf16*>(out);
  a.M = M; a.S = S; a.E = E; a.H = E / enc::HD;
  const opus_bf16::GemmShape g = {M, 3 * E, E, E};
  return launch_product<QkvRopeEpi>(bn, normed, w, g, a, st);
}

// qkv (3, B, H, S, 64); mask (B, S) bool key rows or NULL, with `words`,
// scratch for its packed words ((B, ceil(S / 64)) 64-bit: packed here,
// then the kernel launched) -> out (B, S, H*64).
int opus_encoder_attention(const void* qkv, const void* mask, void* words,
                           void* out, int B, int H, int S, void* stream) {
  if (B < 1 || H < 1 || S < 1 || (mask != nullptr && words == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long head = (long long)S * enc::HD, plane = (long long)B * H * head;
  const bf16* q = static_cast<const bf16*>(qkv);
  CUtensorMap qm, km, vm;
  // each plane as (B, S, H, 64) through its head-major strides
  int rc = opus_attn::make_map_bshd(&qm, q, B, S, H, enc::HD, H * head,
                                    enc::HD, head, 1, enc::QR);
  if (rc) return rc;
  rc = opus_attn::make_map_bshd(&km, q + plane, B, S, H, enc::HD, H * head,
                                enc::HD, head, 1, 64);
  if (rc) return rc;
  rc = opus_attn::make_map_bshd(&vm, q + 2 * plane, B, S, H, enc::HD,
                                H * head, enc::HD, head, 1, 64);
  if (rc) return rc;
  if (mask != nullptr) {
    const int n = B * ((S + 63) / 64);
    enc::pack_key_words<<<(n + 7) / 8, 256, 0, st>>>(
        static_cast<const uint8_t*>(mask), static_cast<uint64_t*>(words), B,
        S);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      enc::encoder_attn_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, enc::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + enc::QR - 1) / enc::QR, H, B);
  enc::encoder_attn_wgmma_kernel<<<grid, enc::THREADS, enc::SMEM_BYTES, st>>>(
      qm, km, vm, mask != nullptr ? static_cast<const uint64_t*>(words)
                                  : nullptr,
      static_cast<bf16*>(out), H, S);
  return (int)cudaGetLastError();
}

// out = x + a @ w + b; a, x (M, E); w (E, E); b (E,); bn: the product's
// tile width (128 or 160, dividing E).
int opus_out_proj(const void* a, const void* w, const void* b, const void* x,
                  void* out, int M, int E, int bn, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  ResidualEpi::Args ea = {};
  ea.bias = static_cast<const bf16*>(b);
  ea.res = static_cast<const bf16*>(x);
  ea.out = static_cast<bf16*>(out);
  ea.M = M; ea.N = E;
  const opus_bf16::GemmShape g = {M, E, E, E};
  return launch_product<OutProjEpi>(bn, a, w, g, ea,
                                    static_cast<cudaStream_t>(stream));
}

// out = x + b2 + gelu(LN(x) @ w1 + b1) @ w2; x (M, E); w1 (E, F); w2 (F, E);
// normed: bf16 scratch (M, E) for LN(x); hidden: bf16 scratch (M, F); bn1,
// bn2: the two products' tile widths (128, 160 or 256, dividing F and E).
int opus_ffn(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* ln, void* hidden, void* normed,
             void* out, int M, int E, int F, float eps, int bn1, int bn2,
             void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      launch_ln_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(ln),
                     static_cast<bf16*>(normed), M, E, eps, st);
  if (e != cudaSuccess) return (int)e;
  GeluEpi::Args a1 = {};
  a1.bias = static_cast<const bf16*>(b1);
  a1.out = static_cast<bf16*>(hidden);
  a1.M = M; a1.N = F;
  const opus_bf16::GemmShape g1 = {M, F, E, F};
  const int rc = launch_product<GeluEpi>(bn1, normed, w1, g1, a1, st);
  if (rc) return rc;
  ResidualEpi::Args a2 = {};
  a2.bias = static_cast<const bf16*>(b2);
  a2.res = static_cast<const bf16*>(x);
  a2.out = static_cast<bf16*>(out);
  a2.M = M; a2.N = E;
  const opus_bf16::GemmShape g2 = {M, E, F, E};
  return launch_product<ResidualEpi>(bn2, hidden, w2, g2, a2, st);
}

}  // extern "C"
