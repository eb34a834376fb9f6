// Hopper (sm_90a) one-token decode attention over a quantized KV cache.
//
// Port of the Pallas kernels `_kernel` (decode_attention_int8) and
// `_kernel4` (decode_attention_int4) in
// opus_pllm_tpu/kernels/decode_attention.py. For each batch row b and KV
// head h, with the G = Hq/Hkv query heads g of that KV head:
//   logit[g, t] = (q_bf16[g] . k_int[t]) * (k_scale[t] / sqrt(D))   fp32
//   softmax over the valid slots t (mask true) in fp32
//   out[g]      = sum_t (p[g, t] * v_scale[t]) * v_int[t] / max(l, 1e-30)
// so the dequantized cache never exists in memory. A masked slot gets the
// weight 0 exactly, so a row with no valid slot gets out 0 (the TPU kernel
// averages v there; no path has such a row). Cache rows are head-major:
// (B, Hkv, S, D) int8, or (B, Hkv, S, D/2) packed int4 with the low nibble
// of byte j holding d = j and the high nibble d = j + D/2; scales
// (B, Hkv, S) fp32; mask (B, S) bytes.
//
// Bound: reading the valid slots' K and V rows (D or D/2 bytes each) and
// their two scales once; 4 G D FLOP a slot is 2G (int8) to 4G (int4) FLOP
// a byte, far below the tensor cores' ratio, so HBM bounds it. At decode
// shapes (B = 8, Hkv = 8, a few hundred slots) the work is a few MB, so the
// kernel must also fill the card and keep many loads in flight.
// Design:
//   - The 64-slot tiles of a (row, KV head) are dealt in turn to `splits`
//     CTAs (grid: split, KV head, row), so a ragged or left-padded row
//     loads every CTA alike; the CTAs of one (row, head) form a
//     thread-block cluster (at most 8, portable) and merge their (m, l, o)
//     through distributed shared memory in a fixed rank order after a
//     cluster barrier: one launch, no workspace, the same bits on every
//     call. The wrapper picks the splits
//     (kernels/decode_attention.decode_splits) so that the grid has ~2
//     CTAs an SM. With one split the launch is a plain one.
//   - Warp w of a CTA takes 16-slot slab w of each of the CTA's tiles and
//     runs its own online softmax over them: no block barrier until the
//     merge. A warp first reads the mask of its next 32 slabs (one slab a
//     lane, then a ballot) and skips every slab false everywhere: no load
//     and no product.
//   - Each warp keeps a ring of 3 stages in shared memory, filled with
//     16-byte cp.async (K and V slab, 4-byte copies of the scales): two
//     slabs in flight a warp while it computes one. Small stages leave
//     room for 4 CTAs an SM, whose warps hide each other's latency.
//   - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate), transposed so that the G <= 8 heads are the
//     8-wide N side and no fragment row is wasted; K and V are widened
//     exactly to bf16 in registers (the int8 fp32-magic and the nibble
//     lop3 of hopper_gemm.cuh). Logits: S^T (16 slots x 8 heads) = K q^T,
//     K as A; the order of D inside a 16-wide chunk is free, so a lane's
//     K bytes are one contiguous run of its row and q's B fragments follow
//     them. P . V: O^T (D x 8 heads) += V^T P^T, V as A (two slots'
//     bytes interleaved with one byte_perm), P^T as B: the logits' 8 x 8
//     accumulator blocks transposed in the warp (movmatrix). The weights
//     p * v_scale go in as a bf16 value and the bf16 of its remainder (two
//     products), so they keep ~16 bits.
//   - Shared-memory rows are swizzled (K: 16-byte halves by row parity
//     when a row is 128 bytes; V: 32-byte blocks by slot pair) so that
//     every fragment load is free of bank conflicts.
// Any capacity: a ragged last slab is zero-filled past S and masked.
// Entry point returns the cudaError_t of its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "mma_bf16.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using opus_hopper::smem_u32;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SLAB = 16;           // slots a warp takes per step
constexpr int TILE = 64;           // slots per tile: the unit of a split
constexpr int STAGES = 3;          // a warp's cp.async ring
constexpr int PASS = 32;           // slabs a warp screens with one ballot
constexpr int MAXG = 8;            // query heads per KV head
constexpr int MAX_CLUSTER = 8;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(WARPS * SLAB == TILE, "a tile is one slab for each warp");

template <int D, bool INT4>
struct Cfg {
  static constexpr int RB = INT4 ? D / 2 : D;   // bytes per cache row
  static constexpr int KB = RB / 4;    // K bytes a lane reads of a row
  static constexpr int VB = RB / 8;    // V bytes a lane reads of a row
  static constexpr int KW = KB / 4;    // ... as 32-bit words
  static constexpr int VW = VB / 4;
  static constexpr int KCH = D / 16;   // 16-deep chunks of the logits
  static constexpr int NM = D / 16;    // 16-row (d) tiles of P . V
  static constexpr int PLANE = SLAB * RB;
  static constexpr int STAGE = 2 * PLANE + 2 * SLAB * 4;
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int OS = D + 4;     // a head's row of o (+4: no
                                       // bank conflicts as lanes store)
  static constexpr int STATE = MAXG * OS + 2 * MAXG;  // floats: o, m, l
  static constexpr int CTA_OFF =
      RING > WARPS * STATE * 4 ? RING : WARPS * STATE * 4;
  static constexpr int SMEM = CTA_OFF + STATE * 4;
};

// Byte offset of (row r, byte x) in a stage's K plane: a 128-byte row
// swaps its 16-byte halves of each 32 bytes on odd rows.
template <int RB>
__device__ __forceinline__ int k_off(int r, int x) {
  return r * RB + (RB == 128 ? x ^ ((r & 1) << 4) : x);
}

// ... and in the V plane: 32-byte blocks XOR the slot pair (r / 2) mod 4.
template <int RB>
__device__ __forceinline__ int v_off(int r, int x) {
  return (r * RB + x) ^ (((r >> 1) & 3) << 5);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x in one MUFU instruction (-inf -> 0; relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An 8 x 8 matrix of 16-bit values, transposed across the warp (lane
// 4r + c holds row r, columns 2c and 2c + 1, before and after).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// fp32 at `p`'s offset in the shared memory of cluster CTA `cta`.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  float v;
  asm volatile(
      "{\n .reg .b32 r;\n mapa.shared::cluster.u32 r, %1, %2;\n"
      " ld.shared::cluster.f32 %0, [r];\n}\n"
      : "=f"(v) : "r"(smem_u32(p)), "r"(cta) : "memory");
  return v;
}

// A word of 4 cache bytes -> two bf16 B-fragment registers (bytes 0 and
// 2, bytes 1 and 3); int4: the low (shift 0) or high (4) nibbles.
template <bool INT4>
__device__ __forceinline__ void widen(uint32_t w, int shift, uint32_t& even,
                                      uint32_t& odd) {
  if (INT4)
    opus_hopper::nibble_pairs_to_bf16(w, shift, even, odd);
  else
    opus_hopper::int8_pairs_to_bf16(w, even, odd);
}

// Read N bytes (4, 8, 16 or 32) at a 16-byte-aligned run of shared memory
// into words; `off(x)` maps a byte offset of the run to its address.
template <int N, typename Off>
__device__ __forceinline__ void ld_words(const uint8_t* base, int x0,
                                         Off off, uint32_t* w) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int p = 0; p < N / 16; ++p) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(base + off(x0 + 16 * p));
      w[4 * p] = v.x;
      w[4 * p + 1] = v.y;
      w[4 * p + 2] = v.z;
      w[4 * p + 3] = v.w;
    }
  } else if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(base + off(x0));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(base + off(x0));
  }
}

// grid (splits, Hkv, B), cluster (splits, 1, 1): CTA x of the cluster
// takes tiles x, x + splits, x + 2 splits, ... of row b's slots.
template <int D, bool INT4>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const bf16* __restrict__ q,
                        const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const uint8_t* __restrict__ mask,
                        void* __restrict__ out, int G, int S,
                        float scale, int out_bf16) {
  using C = Cfg<D, INT4>;
  constexpr int RB = C::RB;
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.y, b = blockIdx.z, Hkv = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // head / slot column, quad lane
  const size_t row0 = ((size_t)b * Hkv + h) * S;
  const float sc = scale * LOG2E;          // logits in base 2

  // q's A fragments (rows = heads): chunk c's pairs follow the K bytes
  // lane t reads, (d of byte 0, byte 2) and (byte 1, byte 3) of a word
  uint32_t qa[C::KCH][2];
  {
    const bf16* qh = q + (((size_t)b * Hkv + h) * G + (g < G ? g : 0)) * D;
#pragma unroll
    for (int c = 0; c < C::KCH; ++c) {
      const int u = INT4 ? c / 2 : c;
      const int d0 = C::KB * t + 4 * u + (INT4 && (c & 1) ? D / 2 : 0);
      // q[d0 .. d0 + 3] in one 8-byte load (rows of heads past G: 0)
      const uint2 v = g < G ? *reinterpret_cast<const uint2*>(qh + d0)
                            : make_uint2(0u, 0u);
      qa[c][0] = __byte_perm(v.x, v.y, 0x5410);
      qa[c][1] = __byte_perm(v.x, v.y, 0x7632);
    }
  }

  // O^T tiles: acc[m] rows (d) g and g + 8, columns (heads) 2t, 2t + 1
  float acc[C::NM][4];
#pragma unroll
  for (int i = 0; i < C::NM; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // this warp's slabs: slab w of tiles x + splits k, k < n_mine (tiles
  // dealt in turn, so a ragged or left-padded row loads every CTA alike)
  const int n_slabs = (S + SLAB - 1) / SLAB;
  const int n_tiles = (S + TILE - 1) / TILE;
  const int splits = gridDim.x, x0 = blockIdx.x;
  const int my_tiles = x0 < n_tiles ? (n_tiles - x0 + splits - 1) / splits
                                    : 0;
  auto slab_of = [&](int k) { return (x0 + splits * k) * WARPS + warp; };
  const int n_mine =
      my_tiles - (my_tiles > 0 && slab_of(my_tiles - 1) >= n_slabs ? 1 : 0);
  uint8_t* ring = smem + warp * STAGES * C::STAGE;
  const uint8_t* mrow = mask + (size_t)b * S;

  for (int k0 = 0; k0 < n_mine; k0 += PASS) {
    // screen: lane i reads the mask bytes of slab k0 + i
    uint32_t bits = 0;
    if (k0 + lane < n_mine) {
      const int s0 = slab_of(k0 + lane) * SLAB;
#pragma unroll
      for (int e = 0; e < SLAB; ++e)
        if (s0 + e < S && mrow[s0 + e]) bits |= 1u << e;
    }
    const uint32_t todo = __ballot_sync(0xffffffffu, bits != 0);
    uint32_t to_issue = todo, to_run = todo;

    // one commit group per call, empty past the last valid slab
    auto issue = [&](int stage) {
      if (to_issue) {
        const int i = __ffs(to_issue) - 1;
        to_issue &= to_issue - 1;
        const int s0 = slab_of(k0 + i) * SLAB;
        uint8_t* st = ring + stage * C::STAGE;
#pragma unroll
        for (int j = 0; j < RB / 32; ++j) {
          const int c = lane + 32 * j;           // 16-byte chunk of a plane
          const int r = c / (RB / 16), x = (c % (RB / 16)) * 16;
          const bool ok = s0 + r < S;
          const size_t src = (row0 + (ok ? s0 + r : 0)) * RB + x;
          cp_async16(st + k_off<RB>(r, x), kq + src, ok);
          cp_async16(st + C::PLANE + v_off<RB>(r, x), vq + src, ok);
        }
        const int r = lane & 15;
        const bool ok = s0 + r < S;
        const size_t si = row0 + (ok ? s0 + r : 0);
        cp_async4(st + 2 * C::PLANE + 4 * lane, (lane < 16 ? ks : vs) + si,
                  ok);
      }
      cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    for (int k = 0; to_run; ++k) {
      const int i = __ffs(to_run) - 1;
      to_run &= to_run - 1;
      const uint32_t sbits = __shfl_sync(0xffffffffu, bits, i);
      cp_async_wait<STAGES - 2>();
      __syncwarp();
      const uint8_t* st = ring + (k % STAGES) * C::STAGE;
      const uint8_t* kp = st;
      const uint8_t* vp = st + C::PLANE;
      const float* ksp = reinterpret_cast<const float*>(st + 2 * C::PLANE);
      const float* vsp = ksp + SLAB;

      // logits S^T (16 slots x 8 heads) = K . q^T: lane (g, t) reads
      // rows g and g + 8 (A's rows) and ends with the logits of slots g,
      // g + 8 for heads 2t, 2t + 1 (two accumulator sets, even and odd
      // chunks: shorter mma chains)
      float sa[2][4] = {};
      {
        uint32_t k0w[C::KW], k1w[C::KW];
        ld_words<C::KB>(kp, C::KB * t,
                        [&](int x) { return k_off<RB>(g, x); }, k0w);
        ld_words<C::KB>(kp, C::KB * t,
                        [&](int x) { return k_off<RB>(g + 8, x); }, k1w);
#pragma unroll
        for (int u = 0; u < C::KW; ++u) {
#pragma unroll
          for (int half = 0; half < (INT4 ? 2 : 1); ++half) {
            const int c = INT4 ? 2 * u + half : u;
            uint32_t a[4];
            widen<INT4>(k0w[u], 4 * half, a[0], a[2]);
            widen<INT4>(k1w[u], 4 * half, a[1], a[3]);
            opus_mma::mma16816(sa[c & 1], a, qa[c][0], qa[c][1]);
          }
        }
      }
      // online softmax of heads 2t and 2t + 1 over slots g and g + 8 (the
      // lanes of one t hold the slab's 16)
      const float kg = ksp[g] * sc, kg8 = ksp[g + 8] * sc;
      const bool ok = (sbits >> g) & 1, ok8 = (sbits >> (g + 8)) & 1;
      float x[2][2];                               // [slot g, g + 8][head]
      x[0][0] = ok ? (sa[0][0] + sa[1][0]) * kg : -INFINITY;
      x[0][1] = ok ? (sa[0][1] + sa[1][1]) * kg : -INFINITY;
      x[1][0] = ok8 ? (sa[0][2] + sa[1][2]) * kg8 : -INFINITY;
      x[1][1] = ok8 ? (sa[0][3] + sa[1][3]) * kg8 : -INFINITY;
      float alpha[2], w[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(x[0][e], x[1][e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[e], mx);  // finite: a slot is valid
        alpha[e] = ex2(m_run[e] - m_new);        // 0 on the first slab
        m_run[e] = m_new;
        const float p0 = ex2(x[0][e] - m_new), p1 = ex2(x[1][e] - m_new);
        l_run[e] = l_run[e] * alpha[e] + (p0 + p1);
        // the weights p * v_scale (0 where masked, whatever the scale holds)
        w[0][e] = ok ? p0 * vsp[g] : 0.f;
        w[1][e] = ok8 ? p1 * vsp[g + 8] : 0.f;
      }
      // P^T as B: each 8 x 8 block (slots x heads) transposed in the warp
      // gives lane (g, t) head g at slots 2t, 2t + 1 (+ 8); a bf16 value
      // and the bf16 of its remainder, two products
      uint32_t ph[2], pl[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(w[j][0], w[j][1]);
        const float2 hf = __bfloat1622float2(hv);
        ph[j] = movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hv));
        pl[j] = movmatrix_trans(
            opus_mma::pack_bf16(w[j][0] - hf.x, w[j][1] - hf.y));
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int m = 0; m < C::NM; ++m) {        // a new max
          acc[m][0] *= alpha[0];
          acc[m][1] *= alpha[1];
          acc[m][2] *= alpha[0];
          acc[m][3] *= alpha[1];
        }
      }
      // O^T (D x 8 heads) += V^T . P^T: lane (g, t) reads rows 2t, 2t + 1,
      // 8 + 2t, 9 + 2t at bytes VB g .. VB g + VB - 1; m-tile rows g and
      // g + 8 are two neighbouring d of those bytes
      uint32_t wa[C::VW], wb[C::VW], wc[C::VW], wd[C::VW];
      ld_words<C::VB>(vp, C::VB * g,
                      [&](int x) { return v_off<RB>(2 * t, x); }, wa);
      ld_words<C::VB>(vp, C::VB * g,
                      [&](int x) { return v_off<RB>(2 * t + 1, x); }, wb);
      ld_words<C::VB>(vp, C::VB * g,
                      [&](int x) { return v_off<RB>(8 + 2 * t, x); }, wc);
      ld_words<C::VB>(vp, C::VB * g,
                      [&](int x) { return v_off<RB>(9 + 2 * t, x); }, wd);
#pragma unroll
      for (int u = 0; u < C::VW; ++u) {
        // byte e of the word pairs slot 2t (low) with 2t + 1 (high)
        const uint32_t xab = __byte_perm(wa[u], wb[u], 0x5410);
        const uint32_t yab = __byte_perm(wa[u], wb[u], 0x7632);
        const uint32_t xcd = __byte_perm(wc[u], wd[u], 0x5410);
        const uint32_t ycd = __byte_perm(wc[u], wd[u], 0x7632);
#pragma unroll
        for (int half = 0; half < (INT4 ? 2 : 1); ++half) {
          uint32_t a0[4], a1[4];     // d = 4u + 0, 1 and 4u + 2, 3
          widen<INT4>(xab, 4 * half, a0[0], a0[1]);
          widen<INT4>(xcd, 4 * half, a0[2], a0[3]);
          widen<INT4>(yab, 4 * half, a1[0], a1[1]);
          widen<INT4>(ycd, 4 * half, a1[2], a1[3]);
          const int m = half * (C::NM / 2) + 2 * u;
          opus_mma::mma16816(acc[m], a0, ph[0], ph[1]);
          opus_mma::mma16816(acc[m], a0, pl[0], pl[1]);
          opus_mma::mma16816(acc[m + 1], a1, ph[0], ph[1]);
          opus_mma::mma16816(acc[m + 1], a1, pl[0], pl[1]);
        }
      }
      __syncwarp();                 // the stage is read; refill it
      issue((k + STAGES - 1) % STAGES);
    }
  }

  // ---- merge: the warps of the CTA, then the CTAs of the cluster ----
  cp_async_wait<0>();
  __syncthreads();                  // the ring becomes the warps' states
  float* wst = reinterpret_cast<float*>(smem);
  float* mine = wst + warp * C::STATE;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 4);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 8);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 16);
  }
  // m-tile m = half NM/2 + 2u + p holds d = VB g + 4u + 2p (+ D/2: the
  // high nibbles) in row g and d + 1 in row g + 8
#pragma unroll
  for (int m = 0; m < C::NM; ++m) {
    const int half = INT4 ? m / (C::NM / 2) : 0;
    const int r = INT4 ? m % (C::NM / 2) : m;
    const int d = C::VB * g + 4 * (r / 2) + 2 * (r % 2) + half * (D / 2);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (2 * t + e < G) {
        mine[(2 * t + e) * C::OS + d] = acc[m][e];
        mine[(2 * t + e) * C::OS + d + 1] = acc[m][2 + e];
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (2 * t + e < G) {
        mine[MAXG * C::OS + 2 * t + e] = m_run[e];
        mine[MAXG * C::OS + MAXG + 2 * t + e] = l_run[e];
      }
    }
  }
  __syncthreads();
  float* cta = reinterpret_cast<float*>(smem + C::CTA_OFF);
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int gg = e / D;
    float mw[WARPS], mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = wst[w * C::STATE + MAXG * C::OS + gg];
      mx = fmaxf(mx, mw[w]);
    }
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = mw[w] == -INFINITY ? 0.f : ex2(mw[w] - mx);
      o += f * wst[w * C::STATE + gg * C::OS + e % D];
      l += f * wst[w * C::STATE + MAXG * C::OS + MAXG + gg];
    }
    cta[e] = o;
    if (e % D == 0) {
      cta[MAXG * D + gg] = mx;
      cta[MAXG * D + MAXG + gg] = l;
    }
  }
  opus_hopper::cluster_arrive();
  opus_hopper::cluster_wait();
  const int cs = gridDim.x;
  const uint32_t rank = opus_hopper::cluster_rank();
  for (int e = rank * THREADS + threadIdx.x; e < G * D; e += cs * THREADS) {
    const int gg = e / D;
    // every load issued before the first use, then summed in rank order
    float mc[MAX_CLUSTER], lc[MAX_CLUSTER], oc[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      mc[c] = c < cs ? ld_cluster(cta + MAXG * D + gg, c) : -INFINITY;
      lc[c] = c < cs ? ld_cluster(cta + MAXG * D + MAXG + gg, c) : 0.f;
      oc[c] = c < cs ? ld_cluster(cta + e, c) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) mx = fmaxf(mx, mc[c]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      const float f = mc[c] == -INFINITY ? 0.f : ex2(mc[c] - mx);
      o += f * oc[c];
      l += f * lc[c];
    }
    const float r = o / fmaxf(l, 1e-30f);      // 0 with no valid slot
    const size_t oi = ((size_t)b * Hkv + h) * G * D + e;
    if (out_bf16)
      static_cast<bf16*>(out)[oi] = __float2bfloat16(r);
    else
      static_cast<float*>(out)[oi] = r;
  }
  // no CTA leaves while a peer may still read its shared memory
  opus_hopper::cluster_arrive();
  opus_hopper::cluster_wait();
}

template <int D, bool INT4>
cudaError_t launch(const void* q, const void* kq, const void* ks,
                   const void* vq, const void* vs, const void* mask,
                   void* out, int B, int Hkv, int G, int S, int splits,
                   float scale, int out_bf16,
                   cudaStream_t st) {
  using C = Cfg<D, INT4>;
  auto kern = decode_attention_kernel<D, INT4>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;       // a plain launch saves ~1 us
  const bf16* qp = static_cast<const bf16*>(q);
  const int8_t* kp = static_cast<const int8_t*>(kq);
  const float* ksp = static_cast<const float*>(ks);
  const int8_t* vp = static_cast<const int8_t*>(vq);
  const float* vsp = static_cast<const float*>(vs);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  void* args[] = {&qp, &kp, &ksp, &vp, &vsp, &mp, &out, &G, &S,
                  &scale, &out_bf16};
  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, Hkv*G, D) bf16; kq/vq (B, Hkv, S, D) int8 or (B, Hkv, S, D/2)
// packed int4 (is_int4 = 1), 16-byte aligned; ks/vs (B, Hkv, S) fp32;
// mask (B, S) bytes; out (B, Hkv*G, D) bf16 (out_bf16 = 1) or fp32.
// D in {64, 128}, G <= 8. CTA x of a cluster of `splits` (1-8) takes the
// 64-slot tiles x, x + splits, ... (splits at most the tiles there are).
int opus_decode_attention(const void* q, const void* kq, const void* ks,
                          const void* vq, const void* vs, const void* mask,
                          void* out, int B, int Hkv, int G, int S, int D,
                          int is_int4, int out_bf16, int splits,
                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (S + TILE - 1) / TILE;
  if (B < 1 || Hkv < 1 || G < 1 || G > MAXG || S < 1 || B > 65535 ||
      Hkv > 65535 || splits < 1 || splits > MAX_CLUSTER || splits > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (D == 128)
    e = is_int4 ? launch<128, true>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                    S, splits, scale, out_bf16, st)
                : launch<128, false>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                     S, splits, scale, out_bf16,
                                     st);
  else if (D == 64)
    e = is_int4 ? launch<64, true>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                   S, splits, scale, out_bf16, st)
                : launch<64, false>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                    S, splits, scale, out_bf16,
                                    st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

}  // extern "C"
