// Hopper (sm_90a) flash attention forward: GQA, optional bool mask,
// optional causal tile skipping, optional logsumexp.
//
// Replaces the Pallas kernel of opus_pllm_tpu/kernels/flash_attention.py
// (`_flash_impl` / `_kernel`, pallas_call at :257). Computes, per query row
// i of head h over the keys j of KV head h / G:
//   s_ij = (q_i . k_j) / sqrt(D) in fp32; s_ij = -1e30 where the mask is
//   false or (causal) j > i; online softmax with fp32 m and l;
//   out_i = sum_j p_ij v_j / max(l_i, 1e-30); lse_i = m_i + log(max(l_i,
//   1e-30)).
// Layouts are the JAX package's: q (B, Sq, Hq, D), k and v (B, Skv, Hkv,
// D), read through their strides (the head dim contiguous), so no transpose
// is made; mask (B, Sq, Skv) through its strides (a broadcast view costs
// nothing); out (B, Sq, Hq, D) contiguous; lse (B, Hq, Sq) fp32.
//
// Bound: the tensor cores. 4 * B * Hq * Sq * Skv * D FLOP against q, k, v,
// mask and out read or written once: at the serving prefill (B = 16, Sq =
// Skv = 320, Hq = 32, Hkv = 8, D = 128) 26.8 GFLOP over ~34 MB.
// Design: one CTA of 4 warps per (64 query rows, head, batch row); each warp
// owns 16 query rows, its q fragments live in registers for the whole
// sweep. The sequential KV grid axis of the TPU kernel becomes a loop over
// 64-key tiles staged in shared memory with their 64 x 64 mask tile; S =
// QK^T and O += PV run as mma.sync m16n8k16 (bf16 in, fp32 accumulate), the
// softmax numerators P rounded to bf16 on the way from the S accumulators
// into the A fragments of the PV product (the TPU kernel keeps them fp32).
// Ragged tiles: query rows past Sq are zero and never stored; keys past Skv
// get -inf and drop out (the TPU kernel needs block multiples instead).
// Causal: the key loop stops after the tile holding the CTA's last row, as
// the TPU kernel skips blocks above the diagonal (its blocks are larger, so
// the two differ only on rows with no valid key at all).
//
// The entry point returns the cudaError_t of its launch (0 = success).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

typedef __nv_bfloat16 bf16;
using opus_mma::mma16816;
using opus_mma::pack_bf16;
using opus_mma::pack_raw;

namespace {

constexpr int BQ = 64;          // query rows per CTA: 4 warps x 16
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 128;
constexpr int M_LD = BKV + 4;   // mask tile row stride (bytes)

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;          // nullptr: no mask
  bf16* out;
  float* lse;                   // nullptr: no lse
  int Sq, Skv, Hq, G, causal;
  float scale;
  long long q_b, q_s, q_h;      // element strides
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long m_b, m_q, m_k;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const FlashArgs a) {
  constexpr int LD = HD + 8;    // padded smem row stride (elements)
  constexpr int CH = HD / 8;    // 16-byte chunks per row
  __shared__ __align__(16) bf16 Ks[BKV * LD];
  __shared__ __align__(16) bf16 Vs[BKV * LD];
  __shared__ uint8_t mt[BQ * M_LD];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const bf16* Q = a.q + b * a.q_b + h * a.q_h;
  const bf16* K = a.k + b * a.k_b + hk * a.k_h;
  const bf16* V = a.v + b * a.v_b + hk * a.v_h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // the query tile goes through Ks into registers
  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.Sq)
      val = *reinterpret_cast<const uint4*>(Q + (q0 + r) * a.q_s + col);
    *reinterpret_cast<uint4*>(Ks + r * LD + col) = val;
  }
  __syncthreads();
  uint32_t qf[HD / 16][4];
  const bf16* qbase = Ks + warp * 16 * LD;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const bf16* qp = qbase + ks * 16 + t * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(qp + g * LD);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(qp + (g + 8) * LD);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(qp + g * LD + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(qp + (g + 8) * LD + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};   // rows g and g + 8 of the warp
  float l_run[2] = {0.f, 0.f};         // this thread's partial row sums
  const int row_l[2] = {warp * 16 + g, warp * 16 + g + 8};

  const int kend = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();   // the previous tile (or the q tile) is no longer read
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.Skv) {
        kv = *reinterpret_cast<const uint4*>(K + (k0 + r) * a.k_s + col);
        vv = *reinterpret_cast<const uint4*>(V + (k0 + r) * a.v_s + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + col) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + col) = vv;
    }
    for (int c = tid; c < BQ * BKV; c += THREADS) {
      const int r = c / BKV, j = c % BKV;
      const int qi = q0 + r, kj = k0 + j;
      uint8_t keep = 1;
      if (a.mask != nullptr && qi < a.Sq && kj < a.Skv)
        keep = a.mask[b * a.m_b + qi * a.m_q + kj * a.m_k] != 0;
      mt[r * M_LD + j] = keep;
    }
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const bf16* kb = Ks + (nt * 8 + g) * LD + ks * 16 + t * 2;
        mma16816(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + t * 2 + (e & 1);
        const int r = row_l[e >> 1];
        const int kj = k0 + j, qi = q0 + r;
        float val = s[nt][e] * a.scale;
        if (kj >= a.Skv)
          val = __int_as_float(0xff800000);          // -inf: no such key
        else if ((a.causal && kj > qi) || !mt[r * M_LD + j])
          val = -1e30f;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
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
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = __expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pv;
        l_run[e >> 1] += pv;
      }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];

    // O += P V, P straight from the S accumulators (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const bf16* vb = Vs + (kk * 16 + t * 2) * LD + nt * 8 + g;
        mma16816(o[nt], pa, pack_raw(vb[0], vb[LD]),
                 pack_raw(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row_l[r];
    if (qi >= a.Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    const float inv = 1.f / l;
    bf16* dst = a.out + (((size_t)b * a.Sq + qi) * a.Hq + h) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + t * 2) =
          __floats2bfloat162_rn(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    if (a.lse != nullptr && t == 0)
      a.lse[((size_t)b * a.Hq + h) * a.Sq + qi] = m_run[r] + logf(l);
  }
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D) bf16 with the given element
// strides (head dim contiguous, rows 16-byte aligned); mask (B, Sq, Skv)
// bool with its strides, or NULL; out (B, Sq, Hq, D) bf16 contiguous; lse
// (B, Hq, Sq) fp32 or NULL. D is 64 or 128.
int opus_flash_attention(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* lse, int B,
                         int Sq, int Skv, int Hq, int Hkv, int D,
                         long long q_b, long long q_s, long long q_h,
                         long long k_b, long long k_s, long long k_h,
                         long long v_b, long long v_s, long long v_h,
                         long long m_b, long long m_q, long long m_k,
                         int causal, float scale, void* stream) {
  FlashArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.Sq = Sq; a.Skv = Skv; a.Hq = Hq; a.G = Hq / Hkv; a.causal = causal;
  a.scale = scale;
  a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
  a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
  a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
  a.m_b = m_b; a.m_q = m_q; a.m_k = m_k;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    flash_fwd_kernel<128><<<grid, THREADS, 0, st>>>(a);
  else if (D == 64)
    flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
