// Hopper (sm_90a) flash attention backward: dq, and dk/dv with the GQA
// group summed inside the CTA. TMA loads into mbarrier rings, wgmma for
// every product.
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
//   dk_j  = sum_{h in group, i} ds_ij q_i;
//   dv_j  = sum_{h in group, i} p_ij dO_i.
// Zeroing p where the mask is false (instead of exp(-1e30 - lse)) gives a
// query row with no valid key zero gradient, the TPU kernel's convention
// (flash_attention_bwd.py:37-46). p and ds are rounded to bf16 as the A
// operands of their products.
// Layouts are the JAX package's: q, dO (B, Sq, Hq, D), k, v (B, Skv, Hkv,
// D), all read through their strides (head dim contiguous) by 4-D tensor
// maps, so no transpose is made; mask (B, Sq, Skv) through its strides; dq
// (B, Sq, Hq, D), dk and dv (B, Skv, Hkv, D) contiguous, in bf16.
//
// Bound: the tensor cores. dq runs three products per mask-true (query,
// key) pair (q.k, dO.v, ds.k), dk/dv four (q.k, dO.v, p.dO, ds.q), each
// 2 D FLOP a pair and head.
// Design (csrc/hopper_attention.cuh has the pieces; every tile is 128-byte
// swizzled by TMA, zero-filled past Sq and Skv):
//   dq: one CTA per (128 query rows, GP heads of one KV head, batch row),
//   rows packed (query, head) as in the forward, so a K/V tile serves GP
//   heads. 288 threads: a producer warp loads the Q and dO tiles once and
//   sweeps the 64-key tiles as the forward does (the mask packed first into
//   64-bit words per query row, false-everywhere tiles skipped) through a
//   2-stage K / V ring;
//   two consumer warpgroups of 64 rows each take a tile in two 32-key
//   halves: S = Q.K^T and dP = dO.V^T by wgmma m64n32k16 from shared
//   memory, p and ds in registers, dq += ds.K by wgmma m64nDk16 with ds as
//   the register A operand and K as the N-major B (transpose bit). dq (D /
//   2 fp32 a thread), S and dP (16 each) and the ds fragments (8) fit the
//   168 registers of a 288-thread block.
//   dk/dv: one CTA per (64 keys, KV head, batch row), 160 threads: a
//   producer warp loads K and V once, then sweeps the G query heads of the
//   group and their 64-row query tiles: the mask, packed first into one
//   64-bit word per key and 64-row query tile, skips the tiles false
//   everywhere; the rest go through a 2-stage ring of Q and dO tiles with
//   their rows' lse and delta (read a tile ahead). One consumer warpgroup
//   takes a tile in two 32-row halves: S^T = K.Q^T and dP^T = V.dO^T by
//   wgmma m64n32k16, p^T and ds^T in registers, dv += p^T.dO and dk +=
//   ds^T.Q by wgmma m64nDk16 (register A, N-major B). dk and dv (D fp32 a thread together) sum the
//   whole group in registers: no per-head buffer, no atomics, so the
//   result is deterministic. A 160-thread block may hold up to 255
//   registers a thread, which the two accumulators need.
//   Both grids run the tiles of one head (group) and batch row next to each
//   other (they share tiles in L2), the longest under a causal mask first
//   (dq: the last query tile, dk/dv: the first key tile), so that the
//   short ones fill the tail.
//
// Each entry point returns the cudaError_t of its launch (0 = success).
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

constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;
constexpr int KV_PANEL = 64 * PANEL_ROW_BYTES;     // a 64-row tile's panel

struct BwdArgs {
  MaskArgs m;
  const float* lse;             // (B, Hq, Sq)
  const float* delta;           // (B, Hq, Sq)
  bf16* out0;                   // dq, or dk
  bf16* out1;                   // dv (dk/dv kernel only)
  int Hq, Hkv, G;
  float scale;
};

// d (64 x HD) += A (registers) . B (N-major, panels `panel` bytes apart)
template <int HD>
__device__ __forceinline__ void rs_mn(float* d, const uint32_t* a,
                                      uint64_t db) {
  if (HD == 128)
    wgmma_rs_n128_mn(d, a, db, 1);
  else
    wgmma_rs_n64_mn(d, a, db, 1);
}

// d (64 x 32) = A rows . B rows^T over HD, both K-major: A's 64 rows start
// at `a` in each of its panels (`a_panel` bytes apart), B's 32 at `b`
template <int HD>
__device__ __forceinline__ void ss_n32(float* d, const uint8_t* a,
                                       int a_panel, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk >> 2, ck = 2 * (kk & 3);
    wgmma_ss_n32(d, desc_k(a + p * a_panel) + ck,
                 desc_k(b + p * KV_PANEL) + ck, kk > 0);
  }
}

// The bf16 rows of a fp32 64 x HD accumulator into a (B, S, H, D) tensor
// at rows `row0`, `row0 + 8` (nullptr: not stored).
template <int HD>
__device__ __forceinline__ void store_rows(const float* acc, bf16* row0,
                                           bf16* row8, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dst = r ? row8 : row0;
    if (dst == nullptr) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

constexpr int DQ_CONSUMERS = 256;
constexpr int DQ_THREADS = DQ_CONSUMERS + 32;

template <int HD, int GP>
struct DqPlan {
  static constexpr int QR = 128 / GP;
  static constexpr int NP = HD / PANEL;
  static constexpr int Q_PANEL = 128 * PANEL_ROW_BYTES;
  static constexpr int Q_BYTES = NP * Q_PANEL;      // q; dO the same
  static constexpr int STAGE_BYTES = 2 * NP * KV_PANEL;
  static constexpr int STAGE_OFF = 2 * Q_BYTES;
  static constexpr int META_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF =
      META_OFF + ((STAGES * (int)sizeof(RowMeta<QR>) + 7) / 8) * 8;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
  static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block can use");
};

template <int HD, int GP>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const BwdArgs a) {
  using P = DqPlan<HD, GP>;
  constexpr int QR = P::QR;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* os = smem + P::Q_BYTES;
  uint8_t* stages = smem + P::STAGE_OFF;
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
      opus_hopper::mbar_init(&empty[s], DQ_CONSUMERS / 32);
    }
    opus_hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= DQ_CONSUMERS) {
    if (lane == 0) {
      opus_hopper::prefetch_map(&q_map);
      opus_hopper::prefetch_map(&o_map);
      opus_hopper::prefetch_map(&k_map);
      opus_hopper::prefetch_map(&v_map);
      opus_hopper::mbar_arrive_expect_tx(qfull, 2 * P::Q_BYTES);
      tma_tile<HD>(qs, P::Q_PANEL, &q_map, qfull, h0, q0, b);
      tma_tile<HD>(os, P::Q_PANEL, &o_map, qfull, h0, q0, b);
    }
    produce_kv<HD, QR, STAGES>(a.m, b, q0, hk, &k_map, &v_map, stages,
                               P::STAGE_BYTES, meta, full, empty, lane);
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;    // rows r0 and r0 + 8
  const int sq[2] = {r0 / GP, (r0 + 8) / GP};
  const int hh[2] = {h0 + r0 % GP, h0 + (r0 + 8) % GP};
  const float c = a.scale * LOG2E;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + sq[r];
    const size_t at = ((size_t)b * a.Hq + hh[r]) * a.m.Sq + qi;
    lse2[r] = qi < a.m.Sq ? a.lse[at] * LOG2E : 0.f;
    del[r] = qi < a.m.Sq ? a.delta[at] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  mbar_wait(qfull, 0);
  for (int u = 0;; ++u) {
    const int s = u % STAGES;
    mbar_wait(&full[s], (u / STAGES) & 1);
    if (meta[s].k0 < 0) break;
    const uint8_t* ks = stages + s * P::STAGE_BYTES;
    const uint8_t* vs = ks + P::NP * KV_PANEL;
    const bool all_true = meta[s].full;
    const uint64_t bits[2] = {meta[s].bits[sq[0]], meta[s].bits[sq[1]]};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {             // keys 32 hf .. 32 hf + 31
      float sacc[16], dp[16];
      wgmma_fence();
      ss_n32<HD>(sacc, qs + wg * 8192, P::Q_PANEL, ks + hf * 4096);
      ss_n32<HD>(dp, os + wg * 8192, P::Q_PANEL, vs + hf * 4096);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc, 16);
      fence_regs(dp, 16);
      // ds = p (dp - delta) scale, in place of s
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        const int col = 32 * hf + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool on = all_true || ((bits[r] >> col) & 1);
        const float p = on ? exp2_approx(sacc[i] * c - lse2[r]) : 0.f;
        sacc[i] = p * (dp[i] - del[r]) * a.scale;
      }
      uint32_t da[8];
      acc_to_a(sacc, 0, da);
      acc_to_a(sacc, 1, da + 4);
      // dq += ds K: K rows 32 hf + 16 kk .. as the N-major B
      const uint64_t kd = desc_mn(ks, KV_PANEL);
      wgmma_fence();
      rs_mn<HD>(dq, da, kd + ((32 * hf) * PANEL_ROW_BYTES >> 4));
      rs_mn<HD>(dq, da + 4, kd + ((32 * hf + 16) * PANEL_ROW_BYTES >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq, HD / 2);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  bf16* rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + sq[r];
    rows[r] = qi < a.m.Sq
                  ? a.out0 + (((size_t)b * a.m.Sq + qi) * a.Hq + hh[r]) * HD
                  : nullptr;
  }
  store_rows<HD>(dq, rows[0], rows[1], t);
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

constexpr int KV_CONSUMERS = 128;
constexpr int KV_THREADS = KV_CONSUMERS + 32;

// A stage of the Q / dO ring besides its tiles: whether the sweep is over,
// whether the tile's mask is true everywhere, its rows' lse (base 2) and
// delta, and the 64-bit query mask of each of the CTA's 64 keys.
struct ColMeta {
  int live;
  int full;
  float lse2[64];
  float delta[64];
  uint64_t bits[64];
};

template <int HD>
struct DkvPlan {
  static constexpr int NP = HD / PANEL;
  static constexpr int T_BYTES = NP * KV_PANEL;     // one 64-row tile
  static constexpr int STAGE_OFF = 2 * T_BYTES;     // after K and V
  static constexpr int STAGE_BYTES = 2 * T_BYTES;   // Q and dO
  static constexpr int META_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = META_OFF + STAGES * (int)sizeof(ColMeta);
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
  static_assert(sizeof(ColMeta) % 8 == 0, "mbarriers need 8-byte alignment");
  static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block can use");
};

template <int HD>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap o_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const BwdArgs a) {
  using P = DkvPlan<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;
  uint8_t* vs = smem + P::T_BYTES;
  uint8_t* stages = smem + P::STAGE_OFF;
  ColMeta* meta = reinterpret_cast<ColMeta*>(smem + P::META_OFF);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * 64, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    opus_hopper::mbar_init(kvfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      opus_hopper::mbar_init(&full[s], 32);
      opus_hopper::mbar_init(&empty[s], KV_CONSUMERS / 32);
    }
    opus_hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= KV_CONSUMERS) {
    // ---- producer warp: K and V once, then the group's Q / dO tiles ----
    if (lane == 0) {
      opus_hopper::prefetch_map(&q_map);
      opus_hopper::prefetch_map(&o_map);
      opus_hopper::prefetch_map(&k_map);
      opus_hopper::prefetch_map(&v_map);
      opus_hopper::mbar_arrive_expect_tx(kvfull, 2 * P::T_BYTES);
      tma_tile<HD>(ks, KV_PANEL, &k_map, kvfull, hk, k0, b);
      tma_tile<HD>(vs, KV_PANEL, &v_map, kvfull, hk, k0, b);
    }
    // tiles j = (head j / nqt, query tile qt0 + j % nqt); causal: query
    // rows below the first key see none of the CTA's keys. What a tile
    // needs besides its TMA boxes (the words of this lane's two keys, the
    // lse and delta of two rows) is read one tile ahead.
    const int qt0 = a.m.causal ? k0 / 64 : 0;
    const int nqt = (a.m.Sq + 63) / 64 - qt0;
    const int n = a.G * nqt;
    struct Fetch {
      uint64_t lo, hi;
      float lse2[2], delta[2];
    };
    auto fetch = [&](int j, Fetch& f) {
      const int h = hk * a.G + j / nqt, qt = qt0 + j % nqt;
      f.lo = col_word(a.m, b, k0 + lane, qt);
      f.hi = col_word(a.m, b, k0 + 32 + lane, qt);
      const size_t rows = ((size_t)b * a.Hq + h) * a.m.Sq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 64 * qt + lane + 32 * e;
        f.lse2[e] = qi < a.m.Sq ? a.lse[rows + qi] * LOG2E : 0.f;
        f.delta[e] = qi < a.m.Sq ? a.delta[rows + qi] : 0.f;
      }
    };
    Fetch cur, nxt;
    if (n > 0) fetch(0, nxt);
    int u = 0;
    for (int j = 0; j < n; ++j) {
      cur = nxt;
      if (j + 1 < n) fetch(j + 1, nxt);
      if (!__any_sync(0xffffffffu, (cur.lo | cur.hi) != 0))
        continue;                                // false everywhere: skipped
      const bool all = __all_sync(0xffffffffu, (cur.lo & cur.hi) == ~0ull);
      const int s = u % STAGES;
      mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
      ColMeta& mt = meta[s];
      mt.bits[lane] = cur.lo;
      mt.bits[lane + 32] = cur.hi;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mt.lse2[lane + 32 * e] = cur.lse2[e];
        mt.delta[lane + 32 * e] = cur.delta[e];
      }
      if (lane == 0) {
        const int h = hk * a.G + j / nqt, q0 = 64 * (qt0 + j % nqt);
        mt.live = 1;
        mt.full = all;
        uint8_t* st = stages + s * P::STAGE_BYTES;
        opus_hopper::mbar_arrive_expect_tx(&full[s], P::STAGE_BYTES);
        tma_tile<HD>(st, KV_PANEL, &q_map, &full[s], h, q0, b);
        tma_tile<HD>(st + P::T_BYTES, KV_PANEL, &o_map, &full[s], h, q0, b);
      } else {
        mbar_arrive(&full[s]);
      }
      ++u;
    }
    const int s = u % STAGES;
    mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
    if (lane == 0) meta[s].live = 0;
    mbar_arrive(&full[s]);
    return;
  }

  // ---- the consumer warpgroup: keys r0 and r0 + 8 of each warp's 16 ----
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  const float c = a.scale * LOG2E;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kvfull, 0);
  for (int u = 0;; ++u) {
    const int s = u % STAGES;
    mbar_wait(&full[s], (u / STAGES) & 1);
    const ColMeta& mt = meta[s];
    if (!mt.live) break;
    const uint8_t* qs = stages + s * P::STAGE_BYTES;
    const uint8_t* os = qs + P::T_BYTES;
    const bool all_true = mt.full;
    const uint64_t bits[2] = {mt.bits[r0], mt.bits[r0 + 8]};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {             // query rows 32 hf ..
      float st[16], dpt[16];
      wgmma_fence();
      ss_n32<HD>(st, ks, KV_PANEL, qs + hf * 4096);
      ss_n32<HD>(dpt, vs, KV_PANEL, os + hf * 4096);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st, 16);
      fence_regs(dpt, 16);
      // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        const int col = 32 * hf + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool on = all_true || ((bits[r] >> col) & 1);
        const float p = on ? exp2_approx(st[i] * c - mt.lse2[col]) : 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - mt.delta[col]) * a.scale;
      }
      uint32_t pa[8], da[8];
      acc_to_a(st, 0, pa);
      acc_to_a(st, 1, pa + 4);
      acc_to_a(dpt, 0, da);
      acc_to_a(dpt, 1, da + 4);
      // dv += p^T dO, dk += ds^T Q: rows 32 hf + 16 kk .. as N-major B
      const uint64_t od = desc_mn(os, KV_PANEL), qd = desc_mn(qs, KV_PANEL);
      const int off0 = (32 * hf) * PANEL_ROW_BYTES >> 4;
      const int off1 = (32 * hf + 16) * PANEL_ROW_BYTES >> 4;
      wgmma_fence();
      rs_mn<HD>(dv, pa, od + off0);
      rs_mn<HD>(dv, pa + 4, od + off1);
      rs_mn<HD>(dk, da, qd + off0);
      rs_mn<HD>(dk, da + 4, qd + off1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv, HD / 2);
      fence_regs(dk, HD / 2);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  bf16* rows0[2];
  bf16* rows1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + 8 * r;
    const size_t at = (((size_t)b * a.m.Skv + kj) * a.Hkv + hk) * HD;
    rows0[r] = kj < a.m.Skv ? a.out0 + at : nullptr;
    rows1[r] = kj < a.m.Skv ? a.out1 + at : nullptr;
  }
  store_rows<HD>(dk, rows0[0], rows0[1], t);
  store_rows<HD>(dv, rows1[0], rows1[1], t);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

BwdArgs make_args(const void* mask, const void* words, const void* lse,
                  const void* delta, void* out0, void* out1, int Sq, int Skv,
                  int Hq, int Hkv, const long long* st, int causal,
                  float scale) {
  BwdArgs a;
  a.m.mask = static_cast<const uint8_t*>(mask);
  a.m.words = mask != nullptr ? static_cast<const uint64_t*>(words) : nullptr;
  a.m.m_b = st[12]; a.m.m_q = st[13]; a.m.m_k = st[14];
  a.m.Sq = Sq; a.m.Skv = Skv; a.m.causal = causal;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = static_cast<bf16*>(out0);
  a.out1 = static_cast<bf16*>(out1);
  a.Hq = Hq; a.Hkv = Hkv; a.G = Hq / Hkv; a.scale = scale;
  return a;
}

// The largest power of two dividing the group G, at most 8: the heads a
// dq CTA packs.
inline int gp_of(int G) { return (G & -G) > 8 ? 8 : (G & -G); }

// The four tensor maps: q and dO in boxes of (qh heads, qr rows), k and v
// in boxes of (1 head, 64 rows).
template <int HD>
int make_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
              const void* dout, int B, int Sq, int Skv, int Hq, int Hkv,
              const long long* st, int qh, int qr) {
  int rc = make_map_bshd(&m[0], q, B, Sq, Hq, HD, st[0], st[1], st[2], qh,
                         qr);
  if (!rc) rc = make_map_bshd(&m[1], dout, B, Sq, Hq, HD, st[9], st[10],
                              st[11], qh, qr);
  if (!rc) rc = make_map_bshd(&m[2], k, B, Skv, Hkv, HD, st[3], st[4],
                              st[5], 1, 64);
  if (!rc) rc = make_map_bshd(&m[3], v, B, Skv, Hkv, HD, st[6], st[7],
                              st[8], 1, 64);
  return rc;
}

template <int HD, int GP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const BwdArgs& a, int B, const long long* st,
              cudaStream_t stream) {
  using P = DqPlan<HD, GP>;
  CUtensorMap m[4];
  int rc = make_maps<HD>(m, q, k, v, dout, B, a.m.Sq, a.m.Skv, a.Hq, a.Hkv,
                         st, GP, P::QR);
  if (rc) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD, GP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.m.Sq + P::QR - 1) / P::QR, a.Hq / GP, B);
  flash_bwd_dq_wgmma_kernel<HD, GP>
      <<<grid, DQ_THREADS, P::SMEM_BYTES, stream>>>(m[0], m[1], m[2], m[3],
                                                    a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_gp(const void* q, const void* k, const void* v,
                 const void* dout, const BwdArgs& a, int B,
                 const long long* st, cudaStream_t s) {
  switch (gp_of(a.G)) {
    case 1: return launch_dq<HD, 1>(q, k, v, dout, a, B, st, s);
    case 2: return launch_dq<HD, 2>(q, k, v, dout, a, B, st, s);
    case 4: return launch_dq<HD, 4>(q, k, v, dout, a, B, st, s);
    default: return launch_dq<HD, 8>(q, k, v, dout, a, B, st, s);
  }
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const BwdArgs& a, int B, const long long* st,
               cudaStream_t stream) {
  using P = DkvPlan<HD>;
  CUtensorMap m[4];
  int rc = make_maps<HD>(m, q, k, v, dout, B, a.m.Sq, a.m.Skv, a.Hq, a.Hkv,
                         st, 1, 64);
  if (rc) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.m.Skv + 63) / 64, a.Hkv, B);
  flash_bwd_dkv_wgmma_kernel<HD>
      <<<grid, KV_THREADS, P::SMEM_BYTES, stream>>>(m[0], m[1], m[2], m[3],
                                                    a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Both entry points: q, dout (B, Sq, Hq, D), k / v (B, Skv, Hkv, D) bf16
// with the given element strides (q, k, v, dout, mask: batch, row, head;
// head dim contiguous, strides multiples of 8, bases 16-byte aligned); mask
// (B, Sq, Skv) bool or NULL, and with a mask `words`, scratch for its
// packed words (dq: (B, ceil(Skv / 64), Sq), dk/dv: (B, ceil(Sq / 64),
// Skv) 64-bit; the entry point packs them, then launches the kernel); lse
// and delta (B, Hq, Sq) fp32 contiguous. D is 64 or 128.
// dq: out0 = dq (B, Sq, Hq, D) bf16 contiguous; out1 unused.
int opus_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, void* words, const void* lse, const void* delta,
    void* out0,
    void* out1, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    long long q_b, long long q_s, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_s, long long o_h,
    long long m_b, long long m_q, long long m_k, int causal, float scale,
    void* stream) {
  if (Hkv < 1 || Hq % Hkv || B < 1 || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const long long st[15] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s,
                            v_h, o_b, o_s, o_h, m_b, m_q, m_k};
  const BwdArgs a = make_args(mask, words, lse, delta, out0, out1, Sq, Skv,
                              Hq, Hkv, st, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 && D != 64) return (int)cudaErrorInvalidValue;
  if (mask != nullptr) {
    const int rc = pack_words(a.m, B, static_cast<uint64_t*>(words), true, s);
    if (rc) return rc;
  }
  if (D == 128) return launch_dq_gp<128>(q, k, v, dout, a, B, st, s);
  if (D == 64) return launch_dq_gp<64>(q, k, v, dout, a, B, st, s);
  return (int)cudaErrorInvalidValue;
}

// dk/dv: out0 = dk, out1 = dv, (B, Skv, Hkv, D) bf16 contiguous.
int opus_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, void* words, const void* lse, const void* delta,
    void* out0,
    void* out1, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    long long q_b, long long q_s, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_s, long long o_h,
    long long m_b, long long m_q, long long m_k, int causal, float scale,
    void* stream) {
  if (Hkv < 1 || Hq % Hkv || B < 1 || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const long long st[15] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s,
                            v_h, o_b, o_s, o_h, m_b, m_q, m_k};
  const BwdArgs a = make_args(mask, words, lse, delta, out0, out1, Sq, Skv,
                              Hq, Hkv, st, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 && D != 64) return (int)cudaErrorInvalidValue;
  if (mask != nullptr) {
    const int rc = pack_words(a.m, B, static_cast<uint64_t*>(words), false,
                              s);
    if (rc) return rc;
  }
  if (D == 128) return launch_dkv<128>(q, k, v, dout, a, B, st, s);
  if (D == 64) return launch_dkv<64>(q, k, v, dout, a, B, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
