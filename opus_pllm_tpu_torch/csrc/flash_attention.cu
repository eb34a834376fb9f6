// Hopper (sm_90a) flash attention forward: GQA, optional bool mask,
// optional causal rule, optional logsumexp. TMA loads into an mbarrier
// ring, wgmma for both products.
//
// Replaces the Pallas kernel of opus_pllm_tpu/kernels/flash_attention.py
// (`_flash_impl` / `_kernel`, pallas_call at :257). Computes, per query row
// i of head h over the keys j of KV head h / G that the row may attend
// (the mask true and, causal, j <= i):
//   s_ij = (q_i . k_j) / sqrt(D) in fp32; online softmax with fp32 m and l
//   over those keys only (a key the row may not attend has p = 0 exactly);
//   out_i = sum_j p_ij v_j / max(l_i, 1e-30); lse_i = m_i + log(l_i).
// For every row with a valid key this is the TPU kernel's function
// (its -1e30 logits give exp(-1e30 - m) = 0). A row with no valid key
// gives out 0 and lse -1e30 (the TPU kernel averages v over whichever
// blocks ran; no caller reads such rows, and the backward gives them zero
// gradient). The softmax numerators are rounded to bf16 for P . V (the TPU
// kernel keeps them fp32).
// Layouts are the JAX package's: q (B, Sq, Hq, D), k and v (B, Skv, Hkv,
// D), read through their strides (the head dim contiguous) by 4-D tensor
// maps, so no transpose is made; mask (B, Sq, Skv) through its strides
// (a broadcast view costs nothing); out (B, Sq, Hq, D) contiguous; lse
// (B, Hq, Sq) fp32.
//
// Bound: 4 * D FLOP per mask-true (query, key) pair and
// head against q, k, v, mask and out read or written once: at the serving
// prefill (B = 16, Sq = Skv = 320, Hq = 32, Hkv = 8, D = 128, the admission
// mask) ~16 GFLOP (0.016 ms at 989 TFLOP/s) over ~106 MB (0.032 ms at
// 3.35 TB/s), so at that shape the bytes bound it.
// Design (csrc/hopper_attention.cuh has the pieces):
//   - One CTA per (128 query rows, GP query heads, batch row), GP the
//     largest power of two (at most 8) dividing the GQA group G: the GP
//     heads share their K/V head, so a K/V tile is loaded once for GP heads
//     (4x less K/V traffic at G = 4) and the CTA's 128 rows are QR = 128 /
//     GP query rows x GP heads (one TMA box: rows (query, head) in that
//     order, 128 B a panel row).
//   - The entry point first packs the mask into one 64-bit word per query
//     row and 64-key tile (causal rule and ragged edges folded in), reading
//     the byte mask once with the whole card; without a mask the words are
//     computed.
//   - 288 threads: two consumer warpgroups of 64 rows, then one producer
//     warp. The producer loads the Q tile once, then sweeps the 64-key
//     tiles: it reads the tile's words (one ahead), skips a tile that is
//     false everywhere (nothing loaded, nothing computed: the 40% of tiles
//     above the diagonal at the serving prefill), and sends the rest
//     through a 3-stage ring of K and V tiles by TMA with their words and
//     an "all true" flag (no per-element masking then).
//   - Each consumer warpgroup: S = Q . K^T by wgmma m64n64k16 with both
//     operands in shared memory (128-byte swizzle); the online softmax on
//     the fp32 accumulators in base 2; P packed to bf16 A fragments in
//     registers; O += P . V by wgmma m64nDk16 with V as the N-major B
//     operand (the transpose bit). O (D / 2 fp32 a thread), S (32) and P
//     (16) stay inside the 168 registers a thread of a 288-thread block
//     gets.
//   - The epilogue divides by l and stores O and the lse from registers.
//   - The grid runs the query tiles of one head group and batch row next
//     to each other (they share K/V tiles in L2), the last one first:
//     under a causal mask it has the most keys, so the long CTAs start
//     early and the short ones fill the tail.
// Rows past Sq and keys past Skv are zero-filled by TMA and masked.
//
// The entry point returns the cudaError_t of its launch (0 = success).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace opus_attn;
using opus_hopper::fence_regs;
using opus_hopper::mbar_wait;
using opus_hopper::wgmma_commit;
using opus_hopper::wgmma_fence;
using opus_hopper::wgmma_wait;

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct FwdArgs {
  MaskArgs m;
  bf16* out;
  float* lse;                   // nullptr: no lse
  int Hq, G;
  float scale;
};

template <int HD, int GP>
struct FwdPlan {
  static constexpr int QR = 128 / GP;               // query rows a CTA
  static constexpr int NP = HD / PANEL;             // panels a row
  static constexpr int Q_PANEL = 128 * PANEL_ROW_BYTES;
  static constexpr int KV_PANEL = 64 * PANEL_ROW_BYTES;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int STAGE_BYTES = 2 * NP * KV_PANEL;
  static constexpr int META_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF =
      META_OFF + ((STAGES * (int)sizeof(RowMeta<QR>) + 7) / 8) * 8;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
  static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block can use");
};

template <int HD>
__device__ __forceinline__ void pv_wgmma(float* o, const uint32_t* a,
                                         uint64_t db) {
  if (HD == 128)
    wgmma_rs_n128_mn(o, a, db, 1);
  else
    wgmma_rs_n64_mn(o, a, db, 1);
}

template <int HD, int GP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const FwdArgs a) {
  using P = FwdPlan<HD, GP>;
  constexpr int QR = P::QR;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* stages = smem + P::Q_BYTES;
  RowMeta<QR>* meta = reinterpret_cast<RowMeta<QR>*>(smem + P::META_OFF);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  // each head group's last query tiles (the most keys under a causal
  // mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QR;
  const int h0 = blockIdx.y * GP, b = blockIdx.z;
  const int hk = h0 / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    opus_hopper::mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      opus_hopper::mbar_init(&full[s], 32);
      opus_hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    opus_hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: the Q tile, then the K / V ring ----
    if (lane == 0) {
      opus_hopper::prefetch_map(&q_map);
      opus_hopper::prefetch_map(&k_map);
      opus_hopper::prefetch_map(&v_map);
      opus_hopper::mbar_arrive_expect_tx(qfull, P::Q_BYTES);
      tma_tile<HD>(qs, P::Q_PANEL, &q_map, qfull, h0, q0, b);
    }
    produce_kv<HD, QR, STAGES>(a.m, b, q0, hk, &k_map, &v_map, stages,
                               P::STAGE_BYTES, meta, full, empty, lane);
    return;
  }

  // ---- consumers: warpgroup wg owns packed rows 64 wg .. 64 wg + 63 ----
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;    // rows r0 and r0 + 8
  const int sq[2] = {r0 / GP, (r0 + 8) / GP};      // their query rows
  const float c = a.scale * LOG2E;                 // logits in base 2
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};

  mbar_wait(qfull, 0);
  for (int u = 0;; ++u) {
    const int s = u % STAGES;
    mbar_wait(&full[s], (u / STAGES) & 1);
    if (meta[s].k0 < 0) break;
    const uint8_t* ks = stages + s * P::STAGE_BYTES;
    const uint8_t* vs = ks + P::NP * P::KV_PANEL;

    // S = Q K^T (64 rows x 64 keys)
    float sacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int p = kk >> 2, ck = 2 * (kk & 3);
      wgmma_ss_n64(sacc, desc_k(qs + p * P::Q_PANEL + wg * 8192) + ck,
                   desc_k(ks + p * P::KV_PANEL) + ck, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc, 32);

    // online softmax (base 2); keys the row may not attend: -inf, p = 0
    const bool all_true = meta[s].full;
    const uint64_t bits[2] = {meta[s].bits[sq[0]], meta[s].bits[sq[1]]};
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
      float x = sacc[i] * c;
      if (!all_true && !((bits[r] >> col) & 1)) x = -INFINITY;
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

    // O += P V, P from the S accumulators (rounded to bf16)
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(sacc, kk, pa + 4 * kk);
    const uint64_t vd = desc_mn(vs, P::KV_PANEL);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)               // 16 keys: 2048 B of rows
      pv_wgmma<HD>(o, pa + 4 * kk, vd + kk * (2048 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o, HD / 2);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + sq[r], h = h0 + (r0 + 8 * r) % GP;
    if (qi >= a.m.Sq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* dst = a.out + (((size_t)b * a.m.Sq + qi) * a.Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    if (a.lse != nullptr && t == 0)
      a.lse[((size_t)b * a.Hq + h) * a.m.Sq + qi] =
          l_run[r] > 0.f ? m_run[r] * LN2 + logf(l_run[r]) : -1e30f;
  }
}

template <int HD, int GP>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a,
           int B, int Hkv, const long long* st, cudaStream_t stream) {
  using P = FwdPlan<HD, GP>;
  CUtensorMap qm, km, vm;
  int rc = make_map_bshd(&qm, q, B, a.m.Sq, a.Hq, HD, st[0], st[1], st[2],
                         GP, P::QR);
  if (rc) return rc;
  rc = make_map_bshd(&km, k, B, a.m.Skv, Hkv, HD, st[3], st[4], st[5], 1, 64);
  if (rc) return rc;
  rc = make_map_bshd(&vm, v, B, a.m.Skv, Hkv, HD, st[6], st[7], st[8], 1, 64);
  if (rc) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD, GP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.m.Sq + P::QR - 1) / P::QR, a.Hq / GP, B);
  flash_fwd_wgmma_kernel<HD, GP>
      <<<grid, THREADS, P::SMEM_BYTES, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_gp(int gp, const void* q, const void* k, const void* v,
              const FwdArgs& a, int B, int Hkv, const long long* st,
              cudaStream_t s) {
  switch (gp) {
    case 1: return launch<HD, 1>(q, k, v, a, B, Hkv, st, s);
    case 2: return launch<HD, 2>(q, k, v, a, B, Hkv, st, s);
    case 4: return launch<HD, 4>(q, k, v, a, B, Hkv, st, s);
    default: return launch<HD, 8>(q, k, v, a, B, Hkv, st, s);
  }
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D) bf16 with the given element
// strides (head dim contiguous, strides multiples of 8, bases 16-byte
// aligned); mask (B, Sq, Skv) bool with its strides, or NULL, and with a
// mask `words`, scratch for its packed words ((B, ceil(Skv / 64), Sq)
// 64-bit: the entry point packs them, then launches the kernel); out (B,
// Sq, Hq, D) bf16 contiguous; lse (B, Hq, Sq) fp32 or NULL. D is 64 or 128.
int opus_flash_attention(const void* q, const void* k, const void* v,
                         const void* mask, void* words, void* out, void* lse,
                         int B, int Sq, int Skv, int Hq, int Hkv, int D,
                         long long q_b, long long q_s, long long q_h,
                         long long k_b, long long k_s, long long k_h,
                         long long v_b, long long v_s, long long v_h,
                         long long m_b, long long m_q, long long m_k,
                         int causal, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || B < 1 || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.m.mask = static_cast<const uint8_t*>(mask);
  a.m.words = mask != nullptr ? static_cast<const uint64_t*>(words) : nullptr;
  a.m.m_b = m_b; a.m.m_q = m_q; a.m.m_k = m_k;
  a.m.Sq = Sq; a.m.Skv = Skv; a.m.causal = causal;
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.Hq = Hq; a.G = Hq / Hkv; a.scale = scale;
  const long long st[9] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  // the largest power of two dividing G, at most 8
  const int gp = (a.G & -a.G) > 8 ? 8 : (a.G & -a.G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 && D != 64) return (int)cudaErrorInvalidValue;
  if (mask != nullptr) {
    const int rc = pack_words(a.m, B, static_cast<uint64_t*>(words), true, s);
    if (rc) return rc;
  }
  if (D == 128) return launch_gp<128>(gp, q, k, v, a, B, Hkv, st, s);
  if (D == 64) return launch_gp<64>(gp, q, k, v, a, B, Hkv, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
