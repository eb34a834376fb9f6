// Hopper (sm_90a) bf16 x bf16 GEMM core with both operands in shared
// memory, on the TMA, mbarrier, descriptor and wgmma helpers of
// hopper_gemm.cuh and hopper_attention.cuh. It carries the encoder's
// LN + QKV + rope, the out projection and both FFN products
// (fused_encoder.cu); an epilogue class gives what happens to each
// finished tile.
//
//   out tile (128 x BN) = A (M, K) bf16 . W (K, N) bf16, fp32 accumulation
//
// - A is the (M, K) activation, K-major, read by a 2-D tensor map in boxes
//   of 128 rows x 64 columns with the 128-byte swizzle. TMA zero-fills rows
//   past M, so the K loop has no mask.
// - W is row-major (K, N): N-major, wgmma's B with the transpose bit. A
//   stage holds BN / 64 (160: 3) boxes of 64 K rows x 64 columns, one
//   128-byte-swizzled panel (8 KB) each; the descriptor's leading byte
//   offset is the panel stride, its stride byte offset the 8-row group
//   (1024 B), as hopper_attention.cuh reads V. The columns come in groups
//   of `group_cols` (the (3, E, E) QKV weight as a (3 E, E) view: group
//   j's rows start at j K), and a tile never straddles a group.
// - 384 threads: two consumer warpgroups of 64 rows x BN columns
//   (m64nBNk16, BN / 2 fp32 accumulators a thread: 128 at BN = 256, inside
//   the 168 registers ptxas gives a thread of a 384-thread block) and a
//   producer warpgroup whose one thread keeps a ring of STAGES stages full
//   (setmaxnreg hands the rest of its registers to the consumers). Each
//   stage completes on a full mbarrier (bytes) and is released by one
//   arrival a consumer warp on an empty one, once wgmma.wait_group says
//   the step that read it is done. Every wait is bounded (mbar_wait).
// - Persistent: min(tiles, SMs) CTAs walk the tiles in a grouped order (8
//   row tiles share each column sweep, so the CTAs in flight share A and W
//   panels in L2). The producer runs on into the next tile's stages while
//   the consumers finish the last one's epilogue. (Clusters of two CTAs
//   multicasting the shared weight tile, which halve a stage's L2 reads,
//   measured 2-3% slower on the H100: the L2 is not what holds it back.)
// - Programmatic dependent launch: the CTAs may start while the kernel
//   before them on the stream (the LayerNorm pass, the attention, FC1)
//   drains; the producer waits for that kernel (griddepcontrol.wait)
//   before its first load, and the consumers, who store, wait for the
//   producer. Nothing else a CTA reads is written by that kernel: the
//   weights, biases, rope tables and the residual predate it.
// - Epilogue, tile-I/O (the out projection): the producer loads the tile
//   the epilogue adds (the residual) into a 128 x BN buffer by TMA while
//   the tile's K loop runs, once the last tile's output has left it; each
//   consumer thread combines its accumulators with its values there in
//   place, and one thread a warpgroup stores the warpgroup's 64 rows by
//   TMA (rows past M are not written). It waits for the TMA to have read
//   them behind the next tile's first product, then frees the buffer; the
//   stores drain while that K loop runs.
//   Staged (the others), per 64-column chunk (the last of a 160-wide
//   tile: 32) and warpgroup: the epilogue class turns the chunk's
//   accumulators (32 a thread) into values in a staging buffer of 64 rows
//   (its own rows, padded against bank conflicts), a named barrier of the
//   warpgroup, then
//   16-byte stores of whole 128-byte row pieces (rows >= M are not
//   stored), and a second barrier before the buffer is reused. In the
//   m64nNk16 accumulator a thread holds rows g, g + 8 (g = lane / 4) of
//   its warp's 16 and columns 8 j + 2 (lane % 4) + {0, 1}: accumulator
//   4 j + 2 r + e; chunk c is accumulators 32 c .. 32 c + 31. The tensor
//   cores wait meanwhile. (Staging the whole tile for the producer group's
//   idle warps to store during the next tile measured slower on the H100:
//   the staging tile leaves room for only three stages.)
// Deterministic: no split-K, no atomics; every output element is one
// thread's fp32 sum in a fixed order.

#pragma once

#include "hopper_attention.cuh"

namespace opus_bf16 {

using opus_attn::desc_k;
using opus_attn::desc_mn;
using opus_hopper::fence_regs;
using opus_hopper::mbar_arrive_expect_tx;
using opus_hopper::mbar_init;
using opus_hopper::mbar_wait;
using opus_hopper::smem_u32;
using opus_hopper::tma_load_2d;
using opus_hopper::wgmma_commit;
using opus_hopper::wgmma_fence;
using opus_hopper::wgmma_wait;

constexpr int BM = 128, BK = 64;           // rows a tile, K a stage
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int PANEL_BYTES = BK * 128;      // 64 K rows x 64 columns
constexpr int A_BYTES = BM * BK * 2;       // 128 rows x 64 columns
constexpr int GROUP_TILES_M = 8;           // grouped tile order
constexpr int SMEM_LIMIT = 232448;         // 227 KB a block can use

// d (64 x 128 fp32, 64 a thread) (+)= A (64 x 16, K-major in shared memory)
// . B (16 x 128, N-major in shared memory: the transpose bit set);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128_mn(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256 fp32, 128 a thread) (+)= A (64 x 16, K-major in shared memory)
// . B (16 x 256, N-major in shared memory: the transpose bit set);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n256_mn(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// d (64 x 160 fp32, 80 a thread) (+)= A (64 x 16, K-major in shared memory)
// . B (16 x 160, N-major in shared memory: the transpose bit set);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n160_mn(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}


// The bytes of the ring at tile width BN for an epilogue whose staging
// rows are STG_ROW bytes: as many stages (at most 6) as fit beside the
// staging buffers (2 warpgroups x 64 rows) and the barriers (IO_BARS more
// for a tile-I/O epilogue's buffer).
template <int BN, int STG_ROW, int IO_BARS = 0>
struct Plan {
  static constexpr int PANELS = (BN + 63) / 64;      // 160: 2.5, loaded 3
  static constexpr int STAGE_BYTES = A_BYTES + PANELS * PANEL_BYTES;
  static constexpr int STAGING_BYTES = 2 * 64 * STG_ROW;
  static constexpr int FREE =
      SMEM_LIMIT - 1024 - STAGING_BYTES - 2 * 6 * 8 - IO_BARS * 8;
  static constexpr int STAGES = FREE / STAGE_BYTES > 6 ? 6
                                                        : FREE / STAGE_BYTES;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES +
                                    STAGING_BYTES + 2 * STAGES * 8 +
                                    IO_BARS * 8;
  static_assert(BN == 128 || BN == 160 || BN == 256,
                "tile width 128, 160 or 256");
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "over the 227 KB a block can use");
};

template <int BN>
__device__ __forceinline__ void wgmma_ss_mn(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  if (BN == 256)
    wgmma_ss_n256_mn(d, da, db, scale_d);
  else if (BN == 160)
    wgmma_ss_n160_mn(d, da, db, scale_d);
  else
    wgmma_ss_n128_mn(d, da, db, scale_d);
}

// One 2-D box from shared memory to `map` at (column c0, row c1) (rows
// past the tensor are not written), in the thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}

// The thread's bulk stores so far, as one group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the thread's committed bulk stores have read their shared
// memory (the buffer may be written again).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's writes to shared memory, made visible to the TMA (the async
// proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15) over `count` threads (whole warps).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

struct GemmShape {
  int M, N, K;
  int group_cols;     // W's columns per group (N for a plain (K, N) weight)
};

// The base of an epilogue class that stages each chunk through shared
// memory (stage / store below): nothing to load before the K loop.
struct StagedEpi {
  static constexpr bool TILE_IO = false;
  static constexpr bool WIDE = true;         // takes 256-wide tiles
  template <int BN>
  struct Pre {};
  template <int BN, class Args>
  static __device__ __forceinline__ void prefetch(const Args&, Pre<BN>&, int,
                                                  int, int, int) {}
};

// Tile t of the grouped order -> its first row and column.
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n,
                                            int bn, int* m0, int* n0) {
  const int per_group = GROUP_TILES_M * tiles_n;
  const int first_m = (t / per_group) * GROUP_TILES_M;
  const int rows_in_group = min(tiles_m - first_m, GROUP_TILES_M);
  const int in_group = t % per_group;
  *m0 = (first_m + in_group % rows_in_group) * BM;
  *n0 = (in_group / rows_in_group) * bn;
}

// A tile-I/O epilogue's buffer holds the 128 x BN bf16 tile (2 BN bytes a
// row) and needs two more barriers.
template <int BN, class Epi>
constexpr int staging_row() {
  if constexpr (Epi::TILE_IO)
    return 2 * BN;
  else
    return Epi::STG_ROW;
}

template <int BN, class Epi>
using EpiPlan = Plan<BN, staging_row<BN, Epi>(), Epi::TILE_IO ? 2 : 0>;

constexpr int IO_BOX_BYTES = 64 * 64;      // 64 rows x 32 bf16 columns

// The kernel body (the notes at the top of the file). Epi provides
// TILE_IO, Pre<BN> and prefetch<BN>(args, pre, row0, n0, warp, lane),
// called before a tile's K loop (loads whose values wait in registers
// while the tensor cores run). A tile-I/O epilogue (TILE_IO = true;
// STG_ROW = 2 BN: its buffer holds the 128 x BN bf16 tile) gets the tile's
// input through `in_map` (loaded by the producer while the tile's K loop
// runs) and writes its output through `out_map`, both in boxes of 64 rows
// x 32 columns with the 64-byte swizzle, and provides
//   tile_io<BN>(args, acc, pre, half, warp, lane): the accumulators
//     combined with the input tile's warpgroup half (64 rows, BN / 32
//     boxes of 4 KB at `half`) into the output, in place;
// a staged one (StagedEpi) provides STG_ROW (staging bytes a row of 64
// columns), Args, and
//   tile<BN>(args, acc, row0, n0, warp, lane): once a tile, on all of a
//     thread's accumulators (rows row0 + 16 warp + g (+ 8));
//   stage<NC>(args, v, stg, row0, n, warp, lane): the accumulators v[NC /
//     2] of a chunk of NC (64, or 32 for the last of a 160-wide tile)
//     columns: rows row0 + 16 warp + g (+ 8), columns n + 8 j + 2 (lane %
//     4) (+ 1), into the staging rows 16 warp + g (+ 8);
//   store<NC>(args, stg, row0, n, tid): the chunk's 64 staged rows row0..
//     (tid 0..127 of the warpgroup) to global memory.
template <int BN, class Epi>
__device__ __forceinline__ void gemm_core(const CUtensorMap& a_map,
                                          const CUtensorMap& w_map,
                                          const CUtensorMap* in_map,
                                          const CUtensorMap* out_map,
                                          const GemmShape& g,
                                          const typename Epi::Args& ea) {
  using P = EpiPlan<BN, Epi>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + STAGES * P::STAGE_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + P::STAGING_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* io_full = empty + STAGES;      // tile-I/O: the input tile is in
  uint64_t* io_empty = io_full + 1;        // the output tile has been read

  const int tiles_m = (g.M + BM - 1) / BM, tiles_n = g.N / BN;
  const int tiles = tiles_m * tiles_n, nk = g.K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    if constexpr (Epi::TILE_IO) {
      mbar_init(io_full, 1);
      mbar_init(io_empty, 2);              // one thread a warpgroup
    }
    opus_hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the TMA ring full ----
    opus_hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      opus_hopper::prefetch_map(&a_map);
      opus_hopper::prefetch_map(&w_map);
      // A is the output of the kernel before this one (launched with
      // programmatic stream serialization): wait for it
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      int it = 0, tile_i = 0;
      // tile-I/O: the input tile goes in once the ring holds the tile's
      // first stages (by then the consumers are at the tile's first
      // product, behind which the last tile's output leaves the buffer)
      const int io_at = (nk < STAGES ? nk : STAGES) - 1;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++tile_i) {
        int m0, n0;
        tile_origin(t, tiles_m, tiles_n, BN, &m0, &n0);
        const int grp = n0 / g.group_cols;
        const int wrow = grp * g.K, wcol = n0 - grp * g.group_cols;
        for (int k0 = 0; k0 < g.K; k0 += BK, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * P::STAGE_BYTES;
          mbar_arrive_expect_tx(&full[s], P::STAGE_BYTES);
          tma_load_2d(st, &a_map, &full[s], k0, m0);
#pragma unroll
          for (int p = 0; p < P::PANELS; ++p)
            tma_load_2d(st + A_BYTES + p * PANEL_BYTES, &w_map, &full[s],
                        wcol + 64 * p, wrow + k0);
          if constexpr (Epi::TILE_IO) {
            if (k0 == io_at * BK) {
              mbar_wait(io_empty, (tile_i & 1) ^ 1);
              mbar_arrive_expect_tx(io_full, P::STAGING_BYTES);
#pragma unroll
              for (int b = 0; b < 2 * BN / 32; ++b)
                tma_load_2d(staging + b * IO_BOX_BYTES, in_map, io_full,
                            n0 + 32 * (b % (BN / 32)),
                            m0 + 64 * (b / (BN / 32)));
            }
          }
        }
      }
    }
  } else {
    opus_hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    uint8_t* stg = staging + wg * (P::STAGING_BYTES / 2);
    // stage `it`, once read: one arrival a warp
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) opus_attn::mbar_arrive(&empty[it % STAGES]);
    };
    float acc[BN / 2];
    int it = 0, tile_i = 0;
    bool stored = false;     // tile-I/O: this thread has stores to wait for
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++tile_i) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, BN, &m0, &n0);
      const int row0 = m0 + 64 * wg;
      typename Epi::template Pre<BN> pre;
      Epi::template prefetch<BN>(ea, pre, row0, n0, warp, lane);
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* st = smem + s * P::STAGE_BYTES;
        // A: this warpgroup's 64 rows (8 KB), 32 B along K a k16; B: 16 K
        // rows (2048 B) a k16
        const uint64_t da = desc_k(st + wg * (A_BYTES / 2));
        const uint64_t db = desc_mn(st + A_BYTES, PANEL_BYTES);
        fence_regs(acc, BN / 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_mn<BN>(acc, da + 2 * kk, db + kk * (2048 >> 4),
                          ks > 0 || kk > 0);
        wgmma_commit();
        if constexpr (Epi::TILE_IO) {
          // the last tile's output stores, waited for behind this tile's
          // first product: then the buffer is free for its input
          if (stored) {
            tma_store_wait_read();
            opus_attn::mbar_arrive(io_empty);
            stored = false;
          }
        }
        fence_regs(acc, BN / 2);
        wgmma_wait<1>();                     // step it - 1 is done
        if (ks > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc, BN / 2);
      release(it - 1);

      if constexpr (Epi::TILE_IO) {
        mbar_wait(io_full, tile_i & 1);
        Epi::template tile_io<BN>(ea, acc, pre, stg, warp, lane);
        fence_proxy_async();
        bar_sync(1 + wg, 128);
        if ((threadIdx.x & 127) == 0) {
#pragma unroll
          for (int b = 0; b < BN / 32; ++b)
            tma_store_2d(out_map, stg + b * IO_BOX_BYTES, n0 + 32 * b,
                         row0);
          tma_store_commit();
          stored = true;
        }
      } else {
        Epi::template tile<BN>(ea, acc, row0, n0, warp, lane);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          Epi::template stage<64>(ea, acc + 32 * c, stg, row0, n0 + 64 * c,
                                  warp, lane);
          bar_sync(1 + wg, 128);
          Epi::template store<64>(ea, stg, row0, n0 + 64 * c,
                                  threadIdx.x & 127);
          bar_sync(1 + wg, 128);
        }
        if constexpr (BN % 64 != 0) {      // 160: a last chunk of 32
          constexpr int c = BN / 64;
          Epi::template stage<32>(ea, acc + 32 * c, stg, row0, n0 + 64 * c,
                                  warp, lane);
          bar_sync(1 + wg, 128);
          Epi::template store<32>(ea, stg, row0, n0 + 64 * c,
                                  threadIdx.x & 127);
          bar_sync(1 + wg, 128);
        }
      }
    }
    if constexpr (Epi::TILE_IO)
      if (stored) tma_store_wait_read();     // before shared memory goes
  }
}

template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
bf16_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap w_map, const GemmShape g,
                 const typename Epi::Args ea) {
  gemm_core<BN, Epi>(a_map, w_map, nullptr, nullptr, g, ea);
}

// The same with a tile-I/O epilogue's two tensor maps.
template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
bf16_gemm_io_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap in_map,
                    const __grid_constant__ CUtensorMap out_map,
                    const GemmShape g, const typename Epi::Args ea) {
  gemm_core<BN, Epi>(a_map, w_map, &in_map, &out_map, g, ea);
}

// Build the tensor maps and launch min(tiles, SMs) CTAs of the core at
// tile width BN: a (M, K) bf16, w (N / group_cols groups of (K,
// group_cols)) bf16, both 16-byte aligned; a tile-I/O epilogue's input
// `res` and output `out` (M, N) bf16 (N % 8 == 0). Needs K % 64 == 0 and
// group_cols % BN == 0 (at BN = 160 the last panel's box reads 32 columns
// past the tile, zero-filled past the weight). Returns a cudaError_t.
template <int BN, class Epi>
inline int launch_bf16_gemm(const void* a, const void* w, const GemmShape& g,
                            const typename Epi::Args& ea,
                            cudaStream_t stream) {
  using P = EpiPlan<BN, Epi>;
  if (g.M < 1 || g.K < BK || g.K % BK || g.group_cols < BN ||
      g.group_cols % BN || g.N % g.group_cols)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, wm, im, om;
  int rc = opus_hopper::make_map_2d(&am, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                    2, g.M, g.K, BM, BK,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = opus_hopper::make_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                (uint64_t)(g.N / g.group_cols) * g.K,
                                g.group_cols, BK, 64,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const void* fn;
  if constexpr (!Epi::TILE_IO) {
    fn = reinterpret_cast<const void*>(bf16_gemm_kernel<BN, Epi>);
  } else {
    // the epilogue's input (Args::res) and output (Args::out), (M, N)
    rc = opus_hopper::make_map_2d(&im, ea.res,
                                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.M,
                                  g.N, 64, 32, CU_TENSOR_MAP_SWIZZLE_64B);
    if (rc) return rc;
    rc = opus_hopper::make_map_2d(&om, ea.out,
                                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.M,
                                  g.N, 64, 32, CU_TENSOR_MAP_SWIZZLE_64B);
    if (rc) return rc;
    fn = reinterpret_cast<const void*>(bf16_gemm_io_kernel<BN, Epi>);
  }
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((g.M + BM - 1) / BM) * (g.N / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles < sms ? tiles : sms, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = P::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (Epi::TILE_IO)
    e = cudaLaunchKernelEx(&cfg, bf16_gemm_io_kernel<BN, Epi>, am, wm, im,
                           om, g, ea);
  else
    e = cudaLaunchKernelEx(&cfg, bf16_gemm_kernel<BN, Epi>, am, wm, g, ea);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace opus_bf16
