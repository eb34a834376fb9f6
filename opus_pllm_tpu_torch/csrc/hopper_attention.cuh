// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), on top of the TMA, mbarrier
// and descriptor helpers of hopper_gemm.cuh.
//
// - A 4-D tensor map over a (B, S, H, D) bf16 tensor read through its
//   element strides (the head dim contiguous): dims (D, H, S, B), boxes of
//   64 head-dim columns (128 bytes: one 128-byte-swizzled panel) x `box_h`
//   heads x `box_s` rows. TMA zero-fills rows past S, so ragged tiles need
//   no branches; a D = 128 tile is two panels, one box each.
// - wgmma bf16 -> fp32 with both operands in shared memory (S = Q.K^T,
//   K-major A and B) at N = 64 and 32, and with A from registers and B
//   N-major (the transpose bit: P.V, dS.K, P^T.dO, dS^T.Q, where the B tile
//   is rows x D with D contiguous) at N = 128 and 64.
// - The mask as 64-bit words. A packing pass before the attention kernel
//   reads the byte mask once, through its strides, with the whole card
//   (consecutive lanes on consecutive keys: coalesced where the last stride
//   is 1; one generic strided read serves a stride-0 broadcast, a
//   transposed view and the 519-byte rows of the training mask, which no
//   vector load could align on) into words per query row over 64 keys
//   (`pack_row_words`) or per key over 64 query rows (`pack_col_words`),
//   with the causal rule and the ragged edges folded in; without a mask
//   the words are computed. A producer warp reads one word a row of a tile
//   and learns whether the tile is false everywhere (skipped: no load, no
//   product) or true everywhere (no per-element masking).

#pragma once

#include "hopper_gemm.cuh"

namespace opus_attn {

using opus_hopper::encode_tiled;
using opus_hopper::EncodeTiledFn;
using opus_hopper::smem_u32;

constexpr int PANEL = 64;            // bf16 columns of one swizzled panel
constexpr int PANEL_ROW_BYTES = 128;

// A (B, S, H, D) bf16 tensor with element strides (s_b, s_s, s_h) and a
// contiguous head dim; boxes of (64, box_h, box_s, 1). The base must be
// 16-byte aligned and the strides multiples of 8. Returns a cudaError_t.
inline int make_map_bshd(CUtensorMap* map, const void* base, int B, int S,
                         int H, int D, long long s_b, long long s_s,
                         long long s_h, int box_h, int box_s) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, (cuuint32_t)box_h,
                             (cuuint32_t)box_s, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One box of `map` at (column c0, head c1, row c2, batch c3); the bytes
// complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A tile of `rows` rows x D columns as D / 64 panels (rows x 128 B each,
// `panel_bytes` apart): one box per panel at head c1, row c2, batch c3.
template <int HD>
__device__ __forceinline__ void tma_tile(uint8_t* dst, int panel_bytes,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int c1, int c2,
                                         int c3) {
#pragma unroll
  for (int p = 0; p < HD / PANEL; ++p)
    tma_load_4d(dst + p * panel_bytes, map, bar, p * PANEL, c1, c2, c3);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// 2^x (ex2.approx: 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// K-major 128-byte-swizzled operand (rows of 128 B, 8-row groups 1024 B
// apart), from its 1024-byte-aligned start.
__device__ __forceinline__ uint64_t desc_k(const void* smem) {
  return opus_hopper::make_desc(smem, 16, 1024);
}

// N-major (transposed) 128-byte-swizzled B operand: K runs down the rows of
// 128 B (8-row groups 1024 B apart: the stride byte offset), N across the
// panels of 64 columns, `panel_bytes` apart (the leading byte offset).
__device__ __forceinline__ uint64_t desc_mn(const void* smem,
                                            uint32_t panel_bytes) {
  return opus_hopper::make_desc(smem, panel_bytes, 1024);
}

// Two floats -> a bf16 pair (round to nearest even), low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The k16 slice kk of a 64 x N fp32 wgmma accumulator as the A fragment of
// the next product (accumulator 4j + 2r + e is row g + 8r, column 8j + 2t +
// e; the A fragment holds rows g, g + 8 at columns 2t, 2t + 1, then + 8).
__device__ __forceinline__ void acc_to_a(const float* acc, int kk,
                                         uint32_t* a) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// d (64 x 64 fp32, 32 a thread) (+)= A (64 x 16, K-major in shared memory)
// . B (64 x 16, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 fp32, 16 a thread) (+)= A (64 x 16, K-major in shared memory)
// . B (32 x 16, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32, 64 a thread) (+)= A (64 x 16 bf16 in registers, the
// mma.m16n8k16 A layout per warp) . B (16 x 128, N-major in shared memory:
// the transpose bit set); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128_mn(float* d, const uint32_t* a,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The same with B 16 x 64 (32 accumulators a thread).
__device__ __forceinline__ void wgmma_rs_n64_mn(float* d, const uint32_t* a,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Masks
// ---------------------------------------------------------------------------

struct MaskArgs {
  const uint8_t* mask;          // (B, Sq, Skv) bool through its strides, or
  long long m_b, m_q, m_k;      // nullptr: no mask
  int Sq, Skv, causal;
  // the mask packed by pack_row_words / pack_col_words (nullptr: no mask)
  const uint64_t* words;
};

// May query row qi of batch row b attend key kj?
__device__ __forceinline__ bool keep(const MaskArgs& m, int b, int qi,
                                     int kj) {
  if (qi >= m.Sq || kj >= m.Skv || (m.causal && kj > qi)) return false;
  return m.mask == nullptr ||
         m.mask[b * m.m_b + (long long)qi * m.m_q + (long long)kj * m.m_k] !=
             0;
}

// Bits lo .. hi - 1 of a 64-bit word (empty if hi <= lo).
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 64);
  if (hi <= lo) return 0;
  const uint64_t top = hi == 64 ? ~0ull : (1ull << hi) - 1;
  return top & ~((1ull << lo) - 1);
}

// The mask as 64-bit words, once per call, before the attention kernel (the
// byte mask is read once, coalesced, by the whole card; the kernels' producer
// warps then read one word per row of a tile). Row words: (B, ceil(Skv /
// 64), Sq), bit j of word (b, t, i) = keep(b, i, 64 t + j). One warp per
// (b, i).
__global__ void __launch_bounds__(256)
pack_row_words(const MaskArgs m, int B, uint64_t* __restrict__ words) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B * m.Sq) return;
  const int b = row / m.Sq, qi = row % m.Sq;
  const int nt = (m.Skv + 63) / 64;
  for (int t = 0; t < nt; ++t) {
    const uint32_t lo =
        __ballot_sync(0xffffffffu, keep(m, b, qi, 64 * t + lane));
    const uint32_t hi =
        __ballot_sync(0xffffffffu, keep(m, b, qi, 64 * t + 32 + lane));
    if (lane == 0)
      words[((size_t)b * nt + t) * m.Sq + qi] =
          (uint64_t)lo | ((uint64_t)hi << 32);
  }
}

// Column words: (B, ceil(Sq / 64), Skv), bit i of word (b, t, j) =
// keep(b, 64 t + i, j). One thread per (b, t, j), consecutive threads on
// consecutive keys.
__global__ void __launch_bounds__(256)
pack_col_words(const MaskArgs m, int B, uint64_t* __restrict__ words) {
  const int nt = (m.Sq + 63) / 64;
  const long long at = (long long)blockIdx.x * 256 + threadIdx.x;
  if (at >= (long long)B * nt * m.Skv) return;
  const int kj = (int)(at % m.Skv), t = (int)((at / m.Skv) % nt);
  const int b = (int)(at / ((long long)m.Skv * nt));
  uint64_t w = 0;
#pragma unroll 16
  for (int i = 0; i < 64; ++i)
    w |= (uint64_t)keep(m, b, 64 * t + i, kj) << i;
  words[at] = w;
}

// Launch the packing pass for `m` into `words` (rows: row words, else
// column words). Returns a cudaError_t.
inline int pack_words(const MaskArgs& m, int B, uint64_t* words, bool rows,
                      cudaStream_t stream) {
  if (rows) {
    const long long n = (long long)B * m.Sq;
    pack_row_words<<<(unsigned)((n + 7) / 8), 256, 0, stream>>>(m, B, words);
  } else {
    const long long n = (long long)B * ((m.Sq + 63) / 64) * m.Skv;
    pack_col_words<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(m, B,
                                                                  words);
  }
  return (int)cudaGetLastError();
}

// The word of query row qi over keys 64 t .. 64 t + 63 (0 past Sq): from
// the row words, or from the causal rule and the edges when there is no
// mask.
__device__ __forceinline__ uint64_t row_word(const MaskArgs& m, int b, int qi,
                                             int t) {
  if (qi >= m.Sq) return 0;
  if (m.words != nullptr)
    return m.words[((size_t)b * ((m.Skv + 63) / 64) + t) * m.Sq + qi];
  return bit_range(0, min(m.Skv, m.causal ? qi + 1 : m.Skv) - 64 * t);
}

// The word of key kj over query rows 64 t .. 64 t + 63 (0 past Skv).
__device__ __forceinline__ uint64_t col_word(const MaskArgs& m, int b, int kj,
                                             int t) {
  if (kj >= m.Skv) return 0;
  if (m.words != nullptr)
    return m.words[((size_t)b * ((m.Sq + 63) / 64) + t) * m.Skv + kj];
  return bit_range(m.causal ? kj - 64 * t : 0, m.Sq - 64 * t);
}

// Rows q0 .. q0 + ROWS - 1 of key tile t, by one warp: row r's word lands
// in bits[r / 32] of lane r % 32.
template <int ROWS>
__device__ __forceinline__ void load_rows(const MaskArgs& m, int b, int q0,
                                          int t, int lane,
                                          uint64_t (&bits)[(ROWS + 31) / 32]) {
#pragma unroll
  for (int i = 0; i < (ROWS + 31) / 32; ++i)
    bits[i] = 32 * i + lane < ROWS ? row_word(m, b, q0 + 32 * i + lane, t)
                                   : 0;
}

// 0 if no bit of the tile is set, 2 if every row has all 64, else 1 (to
// every lane).
template <int ROWS>
__device__ __forceinline__ int tile_kind(
    const uint64_t (&bits)[(ROWS + 31) / 32], int lane) {
  uint64_t any = 0;
  bool all = true;
#pragma unroll
  for (int i = 0; i < (ROWS + 31) / 32; ++i) {
    any |= bits[i];
    all &= 32 * i + lane >= ROWS || bits[i] == ~0ull;
  }
  if (!__any_sync(0xffffffffu, any != 0)) return 0;
  return __all_sync(0xffffffffu, all) ? 2 : 1;
}

// ---------------------------------------------------------------------------
// The producer of the query-tile kernels (forward and dq)
// ---------------------------------------------------------------------------

// What a stage of the K / V ring carries besides the tiles: the key tile's
// first key (-1: the sweep is over), whether its mask is true everywhere,
// and the 64-bit key mask of each of the CTA's QR query rows.
template <int QR>
struct RowMeta {
  int k0;
  int full;
  uint64_t bits[QR];
};

// One warp keeps a ring of STAGES stages (K tile, then V tile: 64 keys x HD
// each) full by TMA: every 64-key tile of the sweep whose mask for query
// rows q0 .. q0 + QR - 1 is not false everywhere, in order, then a stage
// with k0 = -1. The words of the next tile are read while this one waits
// for its stage. `full` barriers count 32 arrivals (each lane, after
// writing its rows' words) plus the bytes; `empty` ones the consumer warps.
template <int HD, int QR, int STAGES>
__device__ __forceinline__ void produce_kv(
    const MaskArgs& m, int b, int q0, int hk, const CUtensorMap* k_map,
    const CUtensorMap* v_map, uint8_t* stages, int stage_bytes,
    RowMeta<QR>* meta, uint64_t* full, uint64_t* empty, int lane) {
  constexpr int KV_PANEL = 64 * PANEL_ROW_BYTES;
  constexpr int KV_BYTES = (HD / PANEL) * KV_PANEL;
  constexpr int NB = (QR + 31) / 32;
  const int nt = ((m.causal ? min(m.Skv, q0 + QR) : m.Skv) + 63) / 64;
  uint64_t bits[NB], next[NB];
  load_rows<QR>(m, b, q0, 0, lane, next);
  int u = 0;
  for (int t = 0; t < nt; ++t) {
#pragma unroll
    for (int i = 0; i < NB; ++i) bits[i] = next[i];
    if (t + 1 < nt) load_rows<QR>(m, b, q0, t + 1, lane, next);
    const int kind = tile_kind<QR>(bits, lane);
    if (kind == 0) continue;                 // false everywhere: skipped
    const int s = u % STAGES;
    opus_hopper::mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (32 * i + lane < QR) meta[s].bits[32 * i + lane] = bits[i];
    if (lane == 0) {
      meta[s].k0 = 64 * t;
      meta[s].full = kind == 2;
      uint8_t* st = stages + s * stage_bytes;
      opus_hopper::mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
      tma_tile<HD>(st, KV_PANEL, k_map, &full[s], hk, 64 * t, b);
      tma_tile<HD>(st + KV_BYTES, KV_PANEL, v_map, &full[s], hk, 64 * t, b);
    } else {
      mbar_arrive(&full[s]);
    }
    ++u;
  }
  const int s = u % STAGES;
  opus_hopper::mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
  if (lane == 0) meta[s].k0 = -1;
  mbar_arrive(&full[s]);
}

}  // namespace opus_attn
