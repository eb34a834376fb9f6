// Hopper (sm_90a) flash attention backward: dq, and dk/dv with the GQA
// group summed inside the CTA.
//
// Replaces the two Pallas kernels of
// opus_pllm_tpu/kernels/flash_attention_bwd.py: `_dq_kernel` (pallas_call
// at :197) and `_dkv_kernel` (pallas_call at :211). With s = scale q.k^T
// and the forward's saved lse (B, Hq, Sq) fp32 and delta = rowsum(dO * O)
// (B, Hq, Sq) fp32, per query row i of head h and key j of KV head h / G:
//   p_ij  = exp(s_ij - lse_i), set to exactly 0 where the mask is false,
//           (causal) j > i, or the row / key lies past Sq / Skv;
//   dp_ij = dO_i . v_j;   ds_ij = p_ij (dp_ij - delta_i) scale;
//   dq_i  = sum_j ds_ij k_j;
//   dk_j  = sum_{h in group, i} ds_ij q_i;  dv_j = sum_{h in group, i} p_ij dO_i.
// Zeroing p where the mask is false (instead of exp(-1e30 - lse)) gives a
// query row with no valid key zero gradient, the TPU kernel's convention
// (flash_attention_bwd.py:37-46).
// Layouts are the JAX package's: q, dO (B, Sq, Hq, D), k, v (B, Skv, Hkv,
// D), all read through their strides (head dim contiguous), so no
// transpose is made; mask (B, Sq, Skv) through its strides; dq (B, Sq, Hq,
// D), dk and dv (B, Skv, Hkv, D) contiguous, in bf16.
//
// Bound: the tensor cores. dq runs three products per (query, key) pair
// (q.k, dO.v, ds.k), dk/dv four (q.k, dO.v, p.dO, ds.q), each 2 D FLOP a
// pair; only mask-true pairs need computing.
// Design (both kernels: 4 warps, mma.sync m16n8k16 bf16 -> fp32, helpers of
// mma_bf16.cuh; the sequential grid axis of each TPU kernel becomes a loop
// inside the CTA):
//   dq: one CTA per (64 query rows, q head, batch row). Each warp keeps its
//   16 rows of q and dO as A fragments in registers and a 16 x D fp32 dq
//   accumulator; a loop over 32-key tiles of K and V staged in shared
//   memory with their mask tile. ds goes from the accumulators straight
//   into the A fragments of ds.k (rounded to bf16).
//   dk/dv: one CTA per (64 keys, KV head, batch row). Each warp owns 16
//   keys, whose dk and dv accumulate in fp32 registers over the G query
//   heads of the group and every 32-row query tile: the GQA sum happens in
//   the CTA, with no per-q-head buffer and no atomics (deterministic). K,
//   V, the q / dO tiles and the mask tile live in dynamic shared memory
//   (55 KB at D = 128).
//   A tile whose mask is false everywhere (above the causal diagonal, past
//   a row's padding) is skipped after its mask is read, so the products
//   run on about the mask-true pairs. Ragged tiles are masked: rows past Sq
//   and keys past Skv load as zero and get p = 0.
//
// Each entry point returns the cudaError_t of its launch (0 = success).
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

constexpr int THREADS = 128;    // 4 warps
constexpr int DQ_BQ = 64;       // query rows per dq CTA: 4 warps x 16
constexpr int DQ_BK = 32;       // keys per dq tile
constexpr int KV_BK = 64;       // keys per dk/dv CTA: 4 warps x 16
constexpr int KV_BQ = 32;       // query rows per dk/dv tile

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const uint8_t* mask;          // nullptr: no mask
  const float* lse;             // (B, Hq, Sq)
  const float* delta;           // (B, Hq, Sq)
  bf16* out0;                   // dq, or dk
  bf16* out1;                   // dv (dk/dv kernel only)
  int Sq, Skv, Hq, Hkv, G, causal;
  float scale;
  long long q_b, q_s, q_h;      // element strides
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;      // dO
  long long m_b, m_q, m_k;
};

// rows [r0, r0 + nrows) of a strided (rows, HD) bf16 matrix into shared
// memory with row stride ld; rows at or past `limit` are zero
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int r0,
                                          int nrows, int limit, int tid) {
  constexpr int CH = HD / 8;
  for (int c = tid; c < nrows * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// the (nq x nk) tile of "p may be non-zero": mask, causality and range;
// returns (to every thread, after a barrier) whether any entry is set
__device__ __forceinline__ int load_mask(uint8_t* mt, int ld,
                                         const BwdArgs& a, int b, int q0,
                                         int nq, int k0, int nk, int tid) {
  int any = 0;
  for (int c = tid; c < nq * nk; c += THREADS) {
    const int r = c / nk, j = c % nk;
    const int qi = q0 + r, kj = k0 + j;
    uint8_t keep = 0;
    if (qi < a.Sq && kj < a.Skv && !(a.causal && kj > qi))
      keep = a.mask == nullptr
                 ? 1
                 : (a.mask[b * a.m_b + qi * a.m_q + kj * a.m_k] != 0);
    mt[r * ld + j] = keep;
    any |= keep;
  }
  return __syncthreads_or(any);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = HD + 8;    // padded smem row stride (elements)
  constexpr int KT = HD / 16;
  constexpr int MLD = DQ_BK + 4;
  __shared__ __align__(16) bf16 Ks[DQ_BK * LD];
  __shared__ __align__(16) bf16 Vs[DQ_BK * LD];
  __shared__ __align__(16) bf16 St[DQ_BQ * LD];   // q, then dO, staging
  __shared__ uint8_t mt[DQ_BQ * MLD];

  const int q0 = blockIdx.x * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const bf16* Q = a.q + b * a.q_b + h * a.q_h;
  const bf16* K = a.k + b * a.k_b + hk * a.k_h;
  const bf16* V = a.v + b * a.v_b + hk * a.v_h;
  const bf16* O = a.dout + b * a.o_b + h * a.o_h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // this warp's 16 rows of q and of dO as A fragments
  uint32_t qf[KT][4], of[KT][4];
  const bf16* base = St + warp * 16 * LD;
  load_rows<HD>(St, LD, Q, a.q_s, q0, DQ_BQ, a.Sq, tid);
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    const bf16* p = base + ks * 16 + t * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(p + g * LD);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(p + g * LD + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD + 8);
  }
  __syncthreads();
  load_rows<HD>(St, LD, O, a.o_s, q0, DQ_BQ, a.Sq, tid);
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    const bf16* p = base + ks * 16 + t * 2;
    of[ks][0] = *reinterpret_cast<const uint32_t*>(p + g * LD);
    of[ks][1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD);
    of[ks][2] = *reinterpret_cast<const uint32_t*>(p + g * LD + 8);
    of[ks][3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD + 8);
  }

  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    const size_t at = ((size_t)b * a.Hq + h) * a.Sq + qi;
    lse_r[r] = qi < a.Sq ? a.lse[at] : 0.f;
    del_r[r] = qi < a.Sq ? a.delta[at] : 0.f;
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  const int kend = a.causal ? min(a.Skv, q0 + DQ_BQ) : a.Skv;
  for (int k0 = 0; k0 < kend; k0 += DQ_BK) {
    __syncthreads();   // the previous tiles are no longer read
    if (!load_mask(mt, MLD, a, b, q0, DQ_BQ, k0, DQ_BK, tid)) continue;
    load_rows<HD>(Ks, LD, K, a.k_s, k0, DQ_BK, a.Skv, tid);
    load_rows<HD>(Vs, LD, V, a.v_s, k0, DQ_BK, a.Skv, tid);
    __syncthreads();

    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < DQ_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        const bf16* kb = Ks + (nt * 8 + g) * LD + ks * 16 + t * 2;
        mma16816(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
        const bf16* vb = Vs + (nt * 8 + g) * LD + ks * 16 + t * 2;
        mma16816(dp[nt], of[ks], *reinterpret_cast<const uint32_t*>(vb),
                 *reinterpret_cast<const uint32_t*>(vb + 8));
      }
    }
    // ds = p (dp - delta) scale, in place of s
#pragma unroll
    for (int nt = 0; nt < DQ_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + t * 2 + (e & 1);
        const int r = warp * 16 + g + (e >> 1) * 8;
        const float p = mt[r * MLD + j]
                            ? __expf(s[nt][e] * a.scale - lse_r[e >> 1])
                            : 0.f;
        s[nt][e] = p * (dp[nt][e] - del_r[e >> 1]) * a.scale;
      }
    // dq += ds K, ds straight from the accumulators (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const bf16* kb = Ks + (kk * 16 + t * 2) * LD + nt * 8 + g;
        mma16816(dq[nt], da, pack_raw(kb[0], kb[LD]),
                 pack_raw(kb[8 * LD], kb[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= a.Sq) continue;
    bf16* dst = a.out0 + (((size_t)b * a.Sq + qi) * a.Hq + h) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + t * 2) =
          __floats2bfloat162_rn(dq[nt][2 * r], dq[nt][2 * r + 1]);
  }
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * KV_BK + 2 * KV_BQ) * (HD + 8) * sizeof(bf16) +
         2 * KV_BQ * sizeof(float) + KV_BQ * (KV_BK + 4);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int LD = HD + 8;
  constexpr int KT = HD / 16;
  constexpr int MLD = KV_BK + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KV_BK * LD;
  bf16* Qs = Vs + KV_BK * LD;
  bf16* Os = Qs + KV_BQ * LD;
  float* lse_s = reinterpret_cast<float*>(Os + KV_BQ * LD);
  float* del_s = lse_s + KV_BQ;
  uint8_t* mt = reinterpret_cast<uint8_t*>(del_s + KV_BQ);

  const int k0 = blockIdx.x * KV_BK, hk = blockIdx.y, b = blockIdx.z;
  const bf16* K = a.k + b * a.k_b + hk * a.k_h;
  const bf16* V = a.v + b * a.v_b + hk * a.v_h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  load_rows<HD>(Ks, LD, K, a.k_s, k0, KV_BK, a.Skv, tid);
  load_rows<HD>(Vs, LD, V, a.v_s, k0, KV_BK, a.Skv, tid);
  const bf16* kbase = Ks + warp * 16 * LD;
  const bf16* vbase = Vs + warp * 16 * LD;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  // causal: query rows below this CTA's first key see none of its keys
  const int qstart = a.causal ? (k0 / KV_BQ) * KV_BQ : 0;
  for (int hh = 0; hh < a.G; ++hh) {
    const int h = hk * a.G + hh;
    const bf16* Q = a.q + b * a.q_b + h * a.q_h;
    const bf16* O = a.dout + b * a.o_b + h * a.o_h;
    const size_t rows = ((size_t)b * a.Hq + h) * a.Sq;
    for (int q0 = qstart; q0 < a.Sq; q0 += KV_BQ) {
      __syncthreads();   // the previous tiles are no longer read
      if (!load_mask(mt, MLD, a, b, q0, KV_BQ, k0, KV_BK, tid)) continue;
      load_rows<HD>(Qs, LD, Q, a.q_s, q0, KV_BQ, a.Sq, tid);
      load_rows<HD>(Os, LD, O, a.o_s, q0, KV_BQ, a.Sq, tid);
      for (int i = tid; i < KV_BQ; i += THREADS) {
        const int qi = q0 + i;
        lse_s[i] = qi < a.Sq ? a.lse[rows + qi] : 0.f;
        del_s[i] = qi < a.Sq ? a.delta[rows + qi] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T for this warp's 16 keys
      float st[KV_BQ / 8][4], dpt[KV_BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < KV_BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t kf[4], vf[4];
        const bf16* kp = kbase + ks * 16 + t * 2;
        const bf16* vp = vbase + ks * 16 + t * 2;
        kf[0] = *reinterpret_cast<const uint32_t*>(kp + g * LD);
        kf[1] = *reinterpret_cast<const uint32_t*>(kp + (g + 8) * LD);
        kf[2] = *reinterpret_cast<const uint32_t*>(kp + g * LD + 8);
        kf[3] = *reinterpret_cast<const uint32_t*>(kp + (g + 8) * LD + 8);
        vf[0] = *reinterpret_cast<const uint32_t*>(vp + g * LD);
        vf[1] = *reinterpret_cast<const uint32_t*>(vp + (g + 8) * LD);
        vf[2] = *reinterpret_cast<const uint32_t*>(vp + g * LD + 8);
        vf[3] = *reinterpret_cast<const uint32_t*>(vp + (g + 8) * LD + 8);
#pragma unroll
        for (int nt = 0; nt < KV_BQ / 8; ++nt) {
          const bf16* qb = Qs + (nt * 8 + g) * LD + ks * 16 + t * 2;
          mma16816(st[nt], kf, *reinterpret_cast<const uint32_t*>(qb),
                   *reinterpret_cast<const uint32_t*>(qb + 8));
          const bf16* ob = Os + (nt * 8 + g) * LD + ks * 16 + t * 2;
          mma16816(dpt[nt], vf, *reinterpret_cast<const uint32_t*>(ob),
                   *reinterpret_cast<const uint32_t*>(ob + 8));
        }
      }
      // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
      for (int nt = 0; nt < KV_BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + t * 2 + (e & 1);          // query
          const int rl = warp * 16 + g + (e >> 1) * 8;     // key
          const float p = mt[c * MLD + rl]
                              ? __expf(st[nt][e] * a.scale - lse_s[c])
                              : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - del_s[c]) * a.scale;
        }
      // dv += p^T dO, dk += ds^T Q (A fragments from the accumulators)
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const bf16* ob = Os + (kk * 16 + t * 2) * LD + nt * 8 + g;
          mma16816(dv[nt], pa, pack_raw(ob[0], ob[LD]),
                   pack_raw(ob[8 * LD], ob[9 * LD]));
          const bf16* qb = Qs + (kk * 16 + t * 2) * LD + nt * 8 + g;
          mma16816(dk[nt], da, pack_raw(qb[0], qb[LD]),
                   pack_raw(qb[8 * LD], qb[9 * LD]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + warp * 16 + g + 8 * r;
    if (kj >= a.Skv) continue;
    const size_t at = (((size_t)b * a.Skv + kj) * a.Hkv + hk) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(a.out0 + at + nt * 8 + t * 2) =
          __floats2bfloat162_rn(dk[nt][2 * r], dk[nt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.out1 + at + nt * 8 + t * 2) =
          __floats2bfloat162_rn(dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* mask, const void* lse,
                  const void* delta, void* out0, void* out1, int Sq, int Skv,
                  int Hq, int Hkv, const long long* st, int causal,
                  float scale) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = static_cast<const uint8_t*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = static_cast<bf16*>(out0);
  a.out1 = static_cast<bf16*>(out1);
  a.Sq = Sq; a.Skv = Skv; a.Hq = Hq; a.Hkv = Hkv; a.G = Hq / Hkv;
  a.causal = causal; a.scale = scale;
  a.q_b = st[0]; a.q_s = st[1]; a.q_h = st[2];
  a.k_b = st[3]; a.k_s = st[4]; a.k_h = st[5];
  a.v_b = st[6]; a.v_s = st[7]; a.v_h = st[8];
  a.o_b = st[9]; a.o_s = st[10]; a.o_h = st[11];
  a.m_b = st[12]; a.m_q = st[13]; a.m_k = st[14];
  return a;
}

template <int HD>
int launch_dkv(const BwdArgs& a, int B, cudaStream_t st) {
  const size_t bytes = dkv_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Skv + KV_BK - 1) / KV_BK, a.Hkv, B);
  flash_bwd_dkv_kernel<HD><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Both entry points: q, dout (B, Sq, Hq, D), k / v (B, Skv, Hkv, D) bf16
// with the given element strides (q, k, v, dout, mask: batch, row, head;
// head dim contiguous, rows 16-byte aligned); mask (B, Sq, Skv) bool or
// NULL; lse and delta (B, Hq, Sq) fp32 contiguous. D is 64 or 128.
// dq: out0 = dq (B, Sq, Hq, D) bf16 contiguous; out1 unused.
int opus_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* lse, const void* delta, void* out0,
    void* out1, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    long long q_b, long long q_s, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_s, long long o_h,
    long long m_b, long long m_q, long long m_k, int causal, float scale,
    void* stream) {
  const long long st[15] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s,
                            v_h, o_b, o_s, o_h, m_b, m_q, m_k};
  BwdArgs a = make_args(q, k, v, dout, mask, lse, delta, out0, out1, Sq,
                        Skv, Hq, Hkv, st, causal, scale);
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, Hq, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    flash_bwd_dq_kernel<128><<<grid, THREADS, 0, s>>>(a);
  else if (D == 64)
    flash_bwd_dq_kernel<64><<<grid, THREADS, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dk/dv: out0 = dk, out1 = dv, (B, Skv, Hkv, D) bf16 contiguous.
int opus_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* lse, const void* delta, void* out0,
    void* out1, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    long long q_b, long long q_s, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_s, long long o_h,
    long long m_b, long long m_q, long long m_k, int causal, float scale,
    void* stream) {
  const long long st[15] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s,
                            v_h, o_b, o_s, o_h, m_b, m_q, m_k};
  BwdArgs a = make_args(q, k, v, dout, mask, lse, delta, out0, out1, Sq,
                        Skv, Hq, Hkv, st, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_dkv<128>(a, B, s);
  if (D == 64) return launch_dkv<64>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
