// Hopper (sm_90a) kernels for the ESM2 encoder block.
//
// Port of the four Pallas kernels in opus_pllm_tpu/kernels/fused_encoder.py
// (fused_ln_qkv_rope, flash_attention_pairs, fused_out_proj, fused_ffn).
// Each computes what its TPU kernel computes; the TPU's pair-packed
// (.., H/2, S, 128) layout is not carried over. Layouts here:
//   qkv  : (3, B, H, S, 64) head-major, rope applied to q and k
//   attn : (B, S, H*64) token-major, read directly by the out projection
//
// One tiled bf16 GEMM core (WMMA 16x16x16 on the tensor cores, fp32
// accumulation, register-staged double buffering) carries three of the
// kernels through a prologue/epilogue choice:
//   ln_qkv_rope : LayerNorm applied to A's rows while staging them to shared
//                 memory (rounded to bf16, as the TPU kernel rounds its LN
//                 output), bias + half-split rope epilogue
//   ffn (1/2)   : the same LN prologue, bias + exact-erf gelu epilogue,
//                 writing a bf16 (M, F) scratch
//   ffn (2/2), out_proj : bias + residual epilogue, one rounding at the end
// LayerNorm statistics come from a small row-stats pass (one warp per row,
// one-pass E[x^2] - mu^2 in fp32) so each GEMM tile does not recompute them.
//
// Every entry point returns the cudaError_t of its launches (0 = success);
// the Python wrapper raises on anything else. Nothing here allocates or
// synchronises: the wrapper allocates outputs and scratch with torch and
// passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// LayerNorm row statistics: mu and 1/sqrt(max(E[x^2] - mu^2, 0) + eps)
// ---------------------------------------------------------------------------

__global__ void ln_stats_kernel(const bf16* __restrict__ x,
                                float* __restrict__ mu,
                                float* __restrict__ rstd, int M, int K,
                                float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float f = __bfloat162float(e[i]);
      s += f;
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    float m = s / K;
    float var = fmaxf(ss / K - m * m, 0.f);
    mu[row] = m;
    rstd[row] = 1.f / sqrtf(var + eps);
  }
}

// ---------------------------------------------------------------------------
// GEMM core: out = epilogue(prologue(A) @ W + bias)
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int GEMM_THREADS = 256;            // 8 warps: 2 (M) x 4 (N)
constexpr int A_LD = BK + 8;                 // padded smem row strides
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_TILE = BM * A_LD;            // elements per stage
constexpr int B_TILE = BK * B_LD;
constexpr size_t PIPE_BYTES = 2 * (A_TILE + B_TILE) * sizeof(bf16);
constexpr size_t EPI_BYTES = (size_t)BM * C_LD * sizeof(float);
constexpr size_t GEMM_SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

enum Epi { EPI_QKV_ROPE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

struct GemmArgs {
  const bf16* A;         // (M, K) row-major
  const bf16* W;         // column groups of (K, w_group_cols), row stride ldw
  const bf16* bias;      // (N,)
  int M, N, K;
  int ldw;               // row stride of W inside one column group
  int w_group_cols;      // columns per group (N for a plain (K, N) weight)
  long long w_group_stride;  // elements between groups (0 for plain)
  // LayerNorm prologue
  const float* mu;       // (M,)
  const float* rstd;     // (M,)
  const bf16* gamma;     // (K,)
  const bf16* beta;      // (K,)
  // epilogues
  const bf16* res;       // (M, N) residual
  const float* cos;      // (S, 64) rope tables
  const float* sin;
  int S, E, H;           // qkv output layout (3, M/S, H, S, 64)
  bf16* out;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + 2 * A_TILE;
  float* Cs = reinterpret_cast<float*>(smem_raw);   // reused after the loop
  __shared__ float s_mu[BM], s_rstd[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (LN) {
    for (int r = tid; r < BM; r += GEMM_THREADS) {
      const int m = m0 + r;
      s_mu[r] = m < p.M ? p.mu[m] : 0.f;
      s_rstd[r] = m < p.M ? p.rstd[m] : 0.f;
    }
    __syncthreads();
  }

  const int group = n0 / p.w_group_cols;
  const bf16* Wt = p.W + group * p.w_group_stride +
                   (n0 - group * p.w_group_cols);

  // Each thread stages 2 16-byte chunks of A (128 x 32) and of B (32 x 128).
  uint4 ra[2], rb[2];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int m = m0 + row;
      ra[i] = m < p.M ? *reinterpret_cast<const uint4*>(
                            p.A + (size_t)m * p.K + k0 + col)
                      : make_uint4(0, 0, 0, 0);
      const int brow = c / (BN / 8), bcol = (c % (BN / 8)) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(
          Wt + (size_t)(k0 + brow) * p.ldw + bcol);
    }
  };
  auto store_tiles = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      uint4 va = ra[i];
      if (LN) {
        const uint4 g4 = *reinterpret_cast<const uint4*>(p.gamma + k0 + col);
        const uint4 b4 = *reinterpret_cast<const uint4*>(p.beta + k0 + col);
        const bf16* xe = reinterpret_cast<const bf16*>(&ra[i]);
        const bf16* ge = reinterpret_cast<const bf16*>(&g4);
        const bf16* be = reinterpret_cast<const bf16*>(&b4);
        bf16* oe = reinterpret_cast<bf16*>(&va);
        const float mu = s_mu[row], rs = s_rstd[row];
        const bool live = m0 + row < p.M;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float r = (__bfloat162float(xe[e]) - mu) * rs *
                              __bfloat162float(ge[e]) +
                          __bfloat162float(be[e]);
          oe[e] = __float2bfloat16(live ? r : 0.f);
        }
      }
      *reinterpret_cast<uint4*>(As + buf * A_TILE + row * A_LD + col) = va;
      const int brow = c / (BN / 8), bcol = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + buf * B_TILE + brow * B_LD + bcol) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = p.K / BK;
  load_tiles(0);
  store_tiles(0, 0);
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
    if (kt + 1 < nk) store_tiles(buf ^ 1, (kt + 1) * BK);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each unit is 8 consecutive columns of one row (one 16-byte
  // store); 8 columns never straddle a 64-wide head.
  for (int u = tid; u < BM * BN / 8; u += GEMM_THREADS) {
    const int r = u / (BN / 8), c = (u % (BN / 8)) * 8;
    const int m = m0 + r;
    if (m >= p.M) continue;
    const int n = n0 + c;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = Cs[r * C_LD + c + e] + __bfloat162float(p.bias[n + e]);
    uint4 o4;
    bf16* oe = reinterpret_cast<bf16*>(&o4);
    if (EPI == EPI_QKV_ROPE) {
      const int j = n / p.E;                 // 0 = q, 1 = k, 2 = v
      const int ecol = n - j * p.E;
      const int h = ecol / 64, d0 = ecol % 64;
      const int b = m / p.S, s = m - b * p.S;
      if (j < 2) {
        // rotate_half: d < 32 takes -t[d+32], d >= 32 takes t[d-32]; the
        // partner column lies in the same tile (heads are 64-aligned)
        const int pc = d0 < 32 ? c + 32 : c - 32;
        const int pn = d0 < 32 ? n + 32 : n - 32;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = Cs[r * C_LD + pc + e] +
                          __bfloat162float(p.bias[pn + e]);
          const float rot = d0 < 32 ? -t : t;
          v[e] = v[e] * p.cos[s * 64 + d0 + e] + rot * p.sin[s * 64 + d0 + e];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16(v[e]);
      const int bsz = p.M / p.S;
      bf16* dst = p.out + ((((size_t)j * bsz + b) * p.H + h) * p.S + s) * 64 + d0;
      *reinterpret_cast<uint4*>(dst) = o4;
    } else {
      if (EPI == EPI_GELU) {
#pragma unroll
        for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16(gelu_erf(v[e]));
      } else {
        const uint4 r4 = *reinterpret_cast<const uint4*>(
            p.res + (size_t)m * p.N + n);
        const bf16* re = reinterpret_cast<const bf16*>(&r4);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          oe[e] = __float2bfloat16(v[e] + __bfloat162float(re[e]));
      }
      *reinterpret_cast<uint4*>(p.out + (size_t)m * p.N + n) = o4;
    }
  }
}

template <bool LN, int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t st) {
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<LN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  gemm_kernel<LN, EPI><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_ln_stats(const bf16* x, float* stats, int M, int K,
                            float eps, cudaStream_t st) {
  ln_stats_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, stats, stats + M, M, K, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Encoder attention: non-causal flash forward at d = 64
// ---------------------------------------------------------------------------

constexpr int HD = 64;
constexpr int AQ = 64;          // query rows per CTA: 4 warps x 16
constexpr int AKV = 64;         // keys per iteration
constexpr int KV_LD = HD + 8;   // padded smem row stride (144 bytes)
constexpr int ATT_THREADS = 128;

using opus_mma::mma16816;
using opus_mma::pack_bf16;
using opus_mma::pack_raw;

// key codes in shared memory: 0 attend, 1 masked (logit -> -1e30 as the TPU
// kernel does), 2 past the end of the sequence (dropped entirely)
__global__ void __launch_bounds__(ATT_THREADS)
encoder_attention_kernel(const bf16* __restrict__ qkv,
                         const uint8_t* __restrict__ mask,
                         bf16* __restrict__ out, int B, int H, int S) {
  __shared__ __align__(16) bf16 Qs[AQ * KV_LD];
  __shared__ __align__(16) bf16 Ks[AKV * KV_LD];
  __shared__ __align__(16) bf16 Vs[AKV * KV_LD];
  __shared__ int kcode[AKV];

  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)S * HD;
  const size_t plane = (size_t)B * H * head;
  const bf16* Q = qkv + ((size_t)b * H + h) * head;
  const bf16* K = Q + plane;
  const bf16* V = K + plane;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  for (int c = tid; c < AQ * HD / 8; c += ATT_THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < S)
      v = *reinterpret_cast<const uint4*>(Q + (size_t)(q0 + r) * HD + col);
    *reinterpret_cast<uint4*>(Qs + r * KV_LD + col) = v;
  }
  __syncthreads();

  uint32_t qf[4][4];
  const bf16* qbase = Qs + warp * 16 * KV_LD;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const bf16* q = qbase + ks * 16 + t * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(q + g * KV_LD);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * KV_LD);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(q + g * KV_LD + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * KV_LD + 8);
  }

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};         // this thread's partial row sums

  for (int k0 = 0; k0 < S; k0 += AKV) {
    __syncthreads();   // the previous block's K/V are no longer read
    for (int c = tid; c < AKV * HD / 8; c += ATT_THREADS) {
      const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(K + (size_t)(k0 + r) * HD + col);
        vv = *reinterpret_cast<const uint4*>(V + (size_t)(k0 + r) * HD + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * KV_LD + col) = kv;
      *reinterpret_cast<uint4*>(Vs + r * KV_LD + col) = vv;
    }
    if (tid < AKV) {
      const int j = k0 + tid;
      kcode[tid] = j >= S ? 2 : (mask == nullptr || mask[(size_t)b * S + j]) ? 0 : 1;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bf16* kb = Ks + (nt * 8 + g) * KV_LD + ks * 16 + t * 2;
        mma16816(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int code = kcode[nt * 8 + t * 2 + (e & 1)];
        float v = s[nt][e] * 0.125f;
        v = code == 0 ? v : (code == 1 ? -1e30f : __int_as_float(0xff800000));
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = __expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pv;
        l_run[e >> 1] += pv;
        o[nt][e] *= alpha[e >> 1];
      }

    // O += P V: P's accumulator layout is the A-fragment layout of the
    // next product, so it stays in registers (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* vb = Vs + (kk * 16 + t * 2) * KV_LD + nt * 8 + g;
        mma16816(o[nt], a, pack_raw(vb[0], vb[KV_LD]),
                 pack_raw(vb[8 * KV_LD], vb[9 * KV_LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const size_t ld = (size_t)H * HD;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = h * HD + nt * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + row0) * ld + d) =
          __floats2bfloat162_rn(o[nt][0] * inv0, o[nt][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + row1) * ld + d) =
          __floats2bfloat162_rn(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes; every pointer and the stream as void*)
// ---------------------------------------------------------------------------

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (B*S, E) -> qkv (3, B, H, S, 64); w (3, E, E); b (3, E); ln (2, E)
// [scale; bias]; cos/sin (S, 64) fp32; stats: fp32 scratch of 2 * B * S.
int opus_ln_qkv_rope(const void* x, const void* w, const void* b,
                     const void* ln, const void* cos, const void* sin,
                     void* out, void* stats, int B, int S, int E, float eps,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  float* mu = static_cast<float*>(stats);
  cudaError_t e = launch_ln_stats(static_cast<const bf16*>(x), mu, M, E, eps, st);
  if (e != cudaSuccess) return (int)e;
  GemmArgs p = {};
  p.A = static_cast<const bf16*>(x);
  p.W = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(b);
  p.M = M; p.N = 3 * E; p.K = E;
  p.ldw = E; p.w_group_cols = E; p.w_group_stride = (long long)E * E;
  p.mu = mu; p.rstd = mu + M;
  p.gamma = static_cast<const bf16*>(ln);
  p.beta = static_cast<const bf16*>(ln) + E;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.S = S; p.E = E; p.H = E / HD;
  p.out = static_cast<bf16*>(out);
  return (int)launch_gemm<true, EPI_QKV_ROPE>(p, st);
}

// qkv (3, B, H, S, 64); mask (B, S) bool key rows or NULL -> out (B, S, H*64)
int opus_encoder_attention(const void* qkv, const void* mask, void* out,
                           int B, int H, int S, void* stream) {
  dim3 grid((S + AQ - 1) / AQ, H, B);
  encoder_attention_kernel<<<grid, ATT_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), B, H, S);
  return (int)cudaGetLastError();
}

// out = x + a @ w + b; a, x (M, E); w (E, E); b (E,)
int opus_out_proj(const void* a, const void* w, const void* b, const void* x,
                  void* out, int M, int E, void* stream) {
  GemmArgs p = {};
  p.A = static_cast<const bf16*>(a);
  p.W = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(b);
  p.M = M; p.N = E; p.K = E;
  p.ldw = E; p.w_group_cols = E; p.w_group_stride = 0;
  p.res = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  return (int)launch_gemm<false, EPI_RESIDUAL>(p, static_cast<cudaStream_t>(stream));
}

// out = x + b2 + gelu(LN(x) @ w1 + b1) @ w2; x (M, E); w1 (E, F); w2 (F, E);
// hidden: bf16 scratch (M, F); stats: fp32 scratch of 2 * M.
int opus_ffn(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* ln, void* hidden, void* stats,
             void* out, int M, int E, int F, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(stats);
  cudaError_t e = launch_ln_stats(static_cast<const bf16*>(x), mu, M, E, eps, st);
  if (e != cudaSuccess) return (int)e;
  GemmArgs p = {};
  p.A = static_cast<const bf16*>(x);
  p.W = static_cast<const bf16*>(w1);
  p.bias = static_cast<const bf16*>(b1);
  p.M = M; p.N = F; p.K = E;
  p.ldw = F; p.w_group_cols = F; p.w_group_stride = 0;
  p.mu = mu; p.rstd = mu + M;
  p.gamma = static_cast<const bf16*>(ln);
  p.beta = static_cast<const bf16*>(ln) + E;
  p.out = static_cast<bf16*>(hidden);
  e = launch_gemm<true, EPI_GELU>(p, st);
  if (e != cudaSuccess) return (int)e;
  GemmArgs q = {};
  q.A = static_cast<const bf16*>(hidden);
  q.W = static_cast<const bf16*>(w2);
  q.bias = static_cast<const bf16*>(b2);
  q.M = M; q.N = E; q.K = F;
  q.ldw = E; q.w_group_cols = E; q.w_group_stride = 0;
  q.res = static_cast<const bf16*>(x);
  q.out = static_cast<bf16*>(out);
  return (int)launch_gemm<false, EPI_RESIDUAL>(q, st);
}

}  // extern "C"
