// Hopper (sm_90a) building blocks in inline PTX, and the bf16 x low-bit
// weight GEMM core that int8_matmul.cu and int4_matmul_v1.cu share.
//
// Helpers: a 2-D tensor map built on the host (cuTensorMapEncodeTiled,
// looked up at run time by cudaGetDriverEntryPoint, so nothing links
// libcuda), the TMA tile load and its cluster multicast, mbarrier init /
// arrive (local or in a peer CTA) / arrive-expect-tx / parity wait
// (bounded: a wait that never completes traps instead of hanging the
// card), cluster barriers, the wgmma shared-memory descriptor for the
// 128-byte swizzle, wgmma fence / commit / wait, m64n128k16 and
// m64n256k16 bf16 with fp32 accumulators and A from registers, ldmatrix,
// setmaxnreg.
//
// The GEMM core (`mixed_gemm_core<kV1>`): out (M, N) = x (M, K) bf16 times
// low-bit weights W (K, N) with fp32 accumulation.
//   kV1 = false: int8 q (K, N) and an fp32 scale per column, applied to the
//     fp32 sums in the epilogue (quant.py `_kernel`).
//   kV1 = true: v1 nibble bytes (K/2, N), byte row 128b + r holding K row
//     256b + r (low nibble) and 256b + 128 + r (high nibble), and fp32
//     gscale (K/128, N): each 128-row group's fp32 partial times its fp32
//     column scales is added to the accumulator (quant4.py `_kernel`).
// It computes the transposed product, out^T = W^T x^T: the widened
// weights are wgmma's A operand, from registers, and x is B, read by
// descriptor from the 128-byte-swizzled tile TMA wrote. So the weights
// never go back to shared memory as bf16, and nothing transposes them.
// A CTA covers 128 weight columns x XROWS x rows (int8 256, v1 128) with
// 384 threads:
//   - two consumer warpgroups (threads 0-255), 64 weight columns each.
//     Each step (int8: 64 K rows, v1: 32) they ldmatrix.trans the raw
//     bytes and widen them exactly with bit tricks (int8: the fp32 2^23
//     magic; a nibble: one lop3 into the 0x4300 exponent, minus 136 in
//     bf16x2) into A fragments, and issue wgmma m64nXROWSk16 on them.
//     Two fragment buffers: step t + 1 is widened while step t runs, once
//     wgmma.wait_group 1 says step t - 1 is done.
//   - a producer warpgroup (threads 256-383; setmaxnreg hands its registers
//     to the consumers): one thread keeps a ring of STAGES stages full with
//     TMA loads, each stage completed on a full mbarrier and released by
//     one arrival a consumer warp on an empty one. TMA zero-fills rows and
//     columns past M, N and K, so the K loop has no masks.
//   - int8: a stage is 64 K rows: the x box and the raw int8 box. The two
//     CTAs of a cluster share x rows and take neighbouring column tiles:
//     each loads half the x box and multicasts it to both, which halves
//     the x traffic from L2. The scale multiplies the fp32 sums in the
//     registers, which are rounded once and stored from the registers.
//   - v1: a stage is half of a 256-row block: 64 byte rows, loaded once,
//     with the x boxes of both K slices they hold (low and high nibbles)
//     and the block's two rows of group scales. A block runs as the low
//     nibbles of both halves (group 2b), then the high ones (group
//     2b + 1): each byte feeds two wgmma chains, as the TPU kernel feeds
//     `lo` and `hi` from one load. A group's steps accumulate into an fp32
//     partial fragment (its first k16 overwrites it); at the group's end
//     wgmma.wait_group 0, then acc += part * gscale[g, n] in fp32. The sum
//     is rounded once to bf16, or stored as fp32. 64 + 64 accumulator
//     registers and 16 of fragments stay inside the 168 registers that
//     ptxas gives a thread of a 384-thread block (it spills past them, and
//     setmaxnreg does not raise that ceiling); a cluster does not pay here.
// Tiles go in a grouped order (8 x-row tiles share each column sweep) so
// that the CTAs in flight share x and W panels in L2. Deterministic: no
// split-K, no atomics.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace opus_hopper {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor of `elem` bytes per element, read in
// boxes of (box_rows, box_cols). The base must be 16-byte aligned and
// cols * elem a multiple of 16. Returns a cudaError_t (0 = success).
inline int make_map_2d(CUtensorMap* map, const void* base,
                       CUtensorMapDataType dtype, int elem, uint64_t rows,
                       uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, dtype, 2, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Device: TMA, mbarriers, fences, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait past
// ~2^36 cycles (tens of seconds) is a broken pipeline: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 36)) __trap();
}

// One 2-D box of `map` at (column c0, row c1) into shared memory; the
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same box written into every CTA of the cluster in `mask`, at the same
// shared-memory offset, completing bytes on each one's barrier at `bar`'s
// offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA in the cluster (warp-aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Arrive on the mbarrier at `bar`'s offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 r;\n mapa.shared::cluster.u32 r, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [r];\n}\n"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// Byte offset `off` (from a 1024-byte-aligned base) under the 128-byte
// swizzle of TMA and wgmma: the 16-byte chunk index XOR the row index mod 8
// (rows of 128 B).
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses of in-flight accumulators across
// a wgmma issue or wait.
__device__ __forceinline__ void fence_regs(float* d, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 fp32, 64 a thread) (+)= A (64 x 16 bf16 in registers, the
// mma.m16n8k16 A layout per warp) . B (128 x 16 bf16, K-major in shared
// memory); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// d (64 x 256 fp32, 128 a thread) (+)= A (64 x 16 bf16 in registers, the
// mma.m16n8k16 A layout per warp) . B (256 x 16 bf16, K-major in shared
// memory); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
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
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Widening to bf16 A fragments (exact)
// ---------------------------------------------------------------------------

// ldmatrix.trans of four 8 x 16-byte matrices of weight bytes: lane i gets,
// of matrix e, the bytes W[2t][2g], W[2t][2g + 1], W[2t + 1][2g],
// W[2t + 1][2g + 1] (K rows 2t, 2t + 1 of the matrix, weight columns 2g,
// 2g + 1 of its 16; g = i / 4, t = i % 4). Lane i addresses row i % 8 of
// matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// Four int8 weights as ldmatrix_x4_trans leaves them -> the bf16 pairs
// (W[2t][2g], W[2t+1][2g]) and (W[2t][2g+1], W[2t+1][2g+1]): each byte +
// 128 as the low mantissa byte of 2^23, minus 2^23 + 128, is the exact
// fp32 value, whose high half is the exact bf16 (|q| <= 128: 8 bits).
__device__ __forceinline__ void int8_pairs_to_bf16(uint32_t w,
                                                   uint32_t& even,
                                                   uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  even = __byte_perm(__float_as_uint(f0 - 8388736.f),
                     __float_as_uint(f2 - 8388736.f), 0x7632);
  odd = __byte_perm(__float_as_uint(f1 - 8388736.f),
                    __float_as_uint(f3 - 8388736.f), 0x7632);
}

// (a & b) ^ c in one instruction.
__device__ __forceinline__ uint32_t lop3_and_xor(uint32_t a, uint32_t b,
                                                 uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The same for one nibble of each byte (shift 0: the low one, 4: the
// high one): the nibble (two's complement) XOR 8 is q + 8, which in the
// low mantissa bits of 0x4300 (128.0) makes 136 + q, exact; minus 136 in
// bf16x2 leaves q exactly (|q| <= 8). Bytes 0 and 2 make the even pair,
// 1 and 3 the odd one.
__device__ __forceinline__ void nibble_pairs_to_bf16(uint32_t w, int shift,
                                                     uint32_t& even,
                                                     uint32_t& odd) {
  uint32_t a = lop3_and_xor(w >> shift, 0x000F000Fu, 0x43084308u);
  uint32_t b = lop3_and_xor(w >> (shift + 8), 0x000F000Fu, 0x43084308u);
  const __nv_bfloat162 bias = __float2bfloat162_rn(136.f);
  __nv_bfloat162 va = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), bias);
  __nv_bfloat162 vb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), bias);
  even = *reinterpret_cast<uint32_t*>(&va);
  odd = *reinterpret_cast<uint32_t*>(&vb);
}

// ---------------------------------------------------------------------------
// The GEMM core
// ---------------------------------------------------------------------------

constexpr int BN = 128, BK = 64;      // weight columns per CTA, K per step
// two consumer warpgroups, then the producer warpgroup
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int STAGES = 5;             // the TMA ring
constexpr int GROUP_TILES_M = 8;      // grouped tile order

// A stage holds the weights of 64 K rows (v1: 64 byte rows, so two 64-row
// K slices, one per nibble) and the x boxes they multiply.
template <bool kV1>
struct Plan {
  // CTAs of a cluster that share one x tile by multicast (on the H100,
  // int8 gains from it and v1 loses)
  static constexpr int CLUSTER = kV1 ? 1 : 2;
  static constexpr int XROWS = kV1 ? 128 : 256;      // x rows: wgmma's N
  static constexpr int XPART = XROWS / CLUSTER;      // x rows a CTA loads
  static constexpr int ACC = XROWS / 2;              // fp32 a thread
  static constexpr int BOXES = kV1 ? 2 : 1;          // x boxes a stage
  static constexpr int SCALE_ROWS = kV1 ? 2 : 0;     // group-scale rows
  // K rows a wgmma step takes; its A fragments (4 registers a k16), and
  // how many steps' fragments are live (v1's partial leaves less room)
  static constexpr int STEP_K = kV1 ? 32 : 64;
  static constexpr int FRAG = STEP_K / 4;
  static constexpr int STEPS = BOXES * BK / STEP_K;  // a stage's steps
  static constexpr int X_BOX_BYTES = XROWS * BK * 2;
  static constexpr int X_PART_BYTES = XPART * BK * 2;
  static constexpr int RAW_OFF = BOXES * X_BOX_BYTES;
  static constexpr int SCALE_OFF = RAW_OFF + BK * BN;
  static constexpr int STAGE_BYTES = SCALE_OFF + SCALE_ROWS * BN * 4;
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(X_PART_BYTES % 1024 == 0, "swizzled tiles need 1024 B");
  static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles need 1024 B");
  static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block can use");
};

template <bool kV1>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  if (kV1)
    wgmma_m64n128k16_rs(d, a, db, scale_d);
  else
    wgmma_m64n256k16_rs(d, a, db, scale_d);
}

template <bool kV1>
__device__ __forceinline__ void mixed_gemm_core(
    const CUtensorMap& x_map, const CUtensorMap& w_map,
    const CUtensorMap& s_map, const float* __restrict__ scale,
    void* __restrict__ out, int M, int N, int K, int out_f32) {
  using P = Plan<kV1>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * P::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // The CTAs of a cluster share x rows m0.. and take neighbouring column
  // tiles; cluster tiles go in a grouped order (GROUP_TILES_M x-row tiles
  // share each column sweep, so the clusters in flight share x and W
  // panels in L2).
  const int rank = P::CLUSTER > 1 ? (int)cluster_rank() : 0;
  const int tiles_n = (N + P::CLUSTER * BN - 1) / (P::CLUSTER * BN);
  const int tiles_m = (M + P::XROWS - 1) / P::XROWS;
  const int tile = blockIdx.x / P::CLUSTER;
  const int per_group = GROUP_TILES_M * tiles_n;
  const int first_m = (tile / per_group) * GROUP_TILES_M;
  const int rows_in_group = min(tiles_m - first_m, GROUP_TILES_M);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % rows_in_group) * P::XROWS;
  const int n0 = ((in_group / rows_in_group) * P::CLUSTER + rank) * BN;
  // stage u holds weight (byte) rows 64u..; int8: x columns 64u.., v1
  // (block b = u / 2, half h = u % 2): x columns 256b + 64h.. for the low
  // nibbles and 256b + 128 + 64h.. for the high ones
  const int n_stages = (kV1 ? K / 2 + BK - 1 : K + BK - 1) / BK;
  const int T = n_stages * P::STEPS;        // wgmma steps
  // step t: int8: stage t. v1: block b = t / 8 in 32-row steps j = t % 8
  // over (nibble, h) = (lo, 0), (lo, 1) [group 2b ends], (hi, 0), (hi, 1)
  // [group 2b + 1 ends], two steps each: stage 2b + h, x box lo / hi,
  // 32-row chunk j % 2
  auto stage_of = [](int t) {
    return kV1 ? 2 * (t >> 3) + ((t >> 1) & 1) : t;
  };
  auto box_of = [](int t) { return kV1 ? (t >> 2) & 1 : 0; };
  auto chunk_of = [](int t) { return kV1 ? t & 1 : 0; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::CLUSTER * CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  // the peers' barriers are initialised before any multicast or arrive
  if (P::CLUSTER > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the TMA ring full ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      prefetch_map(&x_map);
      prefetch_map(&w_map);
      if (kV1) prefetch_map(&s_map);
      for (int u = 0; u < n_stages; ++u) {
        const int s = u % STAGES;
        mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * P::STAGE_BYTES;
        // every byte of the stage lands here: this CTA's part of each x
        // box and the peers' parts (multicast), its weights and scales
        mbar_arrive_expect_tx(&full[s], P::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < P::BOXES; ++j) {
          uint8_t* dst = st + j * P::X_BOX_BYTES + rank * P::X_PART_BYTES;
          const int k0 = kV1 ? 256 * (u >> 1) + 64 * (u & 1) + 128 * j
                             : BK * u;
          const int r0 = m0 + rank * P::XPART;
          if (P::CLUSTER > 1)
            tma_load_2d_multicast(dst, &x_map, &full[s], k0, r0,
                                  (uint16_t)((1 << P::CLUSTER) - 1));
          else
            tma_load_2d(dst, &x_map, &full[s], k0, r0);
        }
        tma_load_2d(st + P::RAW_OFF, &w_map, &full[s], n0, BK * u);
        if (kV1)
          tma_load_2d(st + P::SCALE_OFF, &s_map, &full[s], n0, 2 * (u >> 1));
      }
    }
    // no CTA leaves while a peer may still arrive on its barriers
    if (P::CLUSTER > 1) {
      cluster_arrive();
      cluster_wait();
    }
  } else {
    setmaxnreg_inc<232>();
    const int ct = threadIdx.x;              // 0..255
    // ---- consumers: each warpgroup 64 weight columns x XROWS x rows ----
    const int lane = ct & 31;
    const int chunk = ct >> 5;               // this warp's 16 columns
    float acc[P::ACC], part[P::ACC];         // part: v1's group partial
#pragma unroll
    for (int i = 0; i < P::ACC; ++i) acc[i] = 0.f;

    // step t's weights -> A fragments: fragment 4kk + e of K rows 16kk..
    // A row g <-> weight column 2g, row g + 8 <-> column 2g + 1 of the
    // warp's 16, so that one ldmatrix register holds both rows' pairs
    auto widen = [&](int t, uint32_t* af) {
      const int u = stage_of(t), s = u % STAGES;
      if (!kV1 || (t & 7) == 0 || (t & 7) == 2)  // first use of stage u
        mbar_wait(&full[s], (u / STAGES) & 1);
      const uint8_t* raw = smem + s * P::STAGE_BYTES + P::RAW_OFF;
      const int shift = 4 * box_of(t);       // v1: the high nibbles
#pragma unroll
      for (int h = 0; h < P::STEP_K / 32; ++h) {
        const int k = 32 * (chunk_of(t) + h) + lane;  // the K row this lane
        uint32_t r[4];                             // points at (128 B rows)
        ldmatrix_x4_trans(r, raw + swizzle128(k * BN + chunk * 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) {              // K rows 32h + 8e ..
          uint32_t* f = af + 4 * (2 * h + (e >> 1)) + 2 * (e & 1);
          if (kV1)
            nibble_pairs_to_bf16(r[e], shift, f[0], f[1]);
          else
            int8_pairs_to_bf16(r[e], f[0], f[1]);
        }
      }
    };
    // stage u, once read: one arrival a warp on its empty barrier in every
    // CTA of the cluster (each one's producer refills it with a multicast
    // into all of them)
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < P::CLUSTER; ++c)
          mbar_arrive_cluster(&empty[u % STAGES], c);
      }
    };
    // issue step t from `cur` (widened) and widen step t + 1 into `nxt`
    // while it runs: with three buffers at once, with two once the step
    // that last read `nxt` is done
    auto step = [&](int t, const uint32_t* cur, uint32_t* nxt) {
      const int u = stage_of(t), s = u % STAGES;
      float* d = kV1 ? part : acc;
      const bool first_of_group = kV1 && (t & 3) == 0;
      const bool group_end = kV1 && (t & 3) == 3;
      // x: K-major rows of 128 B, 8-row groups 1024 B apart (SBO); 32 B
      // along K a k16
      const uint64_t db = make_desc(
          smem + s * P::STAGE_BYTES + box_of(t) * P::X_BOX_BYTES, 16, 1024) +
          4 * chunk_of(t);
      fence_regs(d, P::ACC);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::STEP_K / 16; ++kk)
        wgmma_rs<kV1>(d, cur + 4 * kk, db + 2 * kk,
                      !(first_of_group && kk == 0));
      wgmma_commit();
      fence_regs(d, P::ACC);
      wgmma_wait<1>();                       // step t - 1 is done
      if (!kV1 && t >= 1) release(t - 1);    // v1: at block ends
      if (t + 1 < T) widen(t + 1, nxt);      // while step t runs
      if (group_end) {
        // the group's partial times its fp32 column scales (both rows
        // are in every stage of the block)
        const float2 sc = *reinterpret_cast<const float2*>(
            reinterpret_cast<const float*>(smem + s * P::STAGE_BYTES +
                                           P::SCALE_OFF) +
            box_of(t) * BN + 16 * chunk + 2 * (lane >> 2));
        wgmma_wait<0>();
        fence_regs(part, P::ACC);
#pragma unroll
        for (int q = 0; q < P::ACC / 4; ++q) {
          acc[4 * q + 0] += part[4 * q + 0] * sc.x;
          acc[4 * q + 1] += part[4 * q + 1] * sc.x;
          acc[4 * q + 2] += part[4 * q + 2] * sc.y;
          acc[4 * q + 3] += part[4 * q + 3] * sc.y;
        }
        if ((t & 7) == 7) {                  // block t / 8 is read
          release(u - 1);
          release(u);
        }
      }
    };
    uint32_t a0[P::FRAG], a1[P::FRAG];       // two steps' A fragments
    widen(0, a0);
    for (int t = 0; t < T; t += 2) {
      step(t, a0, a1);
      if (t + 1 < T) step(t + 1, a1, a0);
    }
    wgmma_wait<0>();
    fence_regs(acc, P::ACC);
    if (P::CLUSTER > 1) cluster_arrive();       // every release is issued

    // epilogue: accumulator 4q + 2c + e is weight column 16 chunk + 2g + c
    // at x row 8q + 2 (lane % 4) + e
    const int col = n0 + 16 * chunk + 2 * (lane >> 2);
    if (col < N) {
      float s0 = 1.f, s1 = 1.f;
      if (!kV1) {
        s0 = scale[col];
        s1 = scale[col + 1];
      }
#pragma unroll
      for (int q = 0; q < P::ACC / 4; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * q + 2 * (lane & 3) + e;
          if (row >= M) continue;
          const float v0 = acc[4 * q + e] * s0;
          const float v1 = acc[4 * q + 2 + e] * s1;
          const size_t at = (size_t)row * N + col;
          if (out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
                make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(out) + at) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    if (P::CLUSTER > 1) cluster_wait();
  }
}

typedef void (*MixedGemmKernel)(const CUtensorMap, const CUtensorMap,
                                const CUtensorMap, const float*, void*, int,
                                int, int, int);

// Build the tensor maps and launch `kernel` (a __global__ wrapper of
// mixed_gemm_core<kV1> with cluster dims P::CLUSTER). int8: w (K, N) int8,
// scale (N,); v1: w (K/2, N) nibble bytes, scale = gscale (K/128, N).
// Needs N % 16 == 0 and K % 8 (int8) or K % 256 (v1) == 0, 16-byte-aligned
// bases. Returns a cudaError_t.
template <bool kV1>
inline int launch_mixed_gemm(MixedGemmKernel kernel, const void* x,
                             const void* w, const void* scale, void* out,
                             int M, int N, int K, int out_f32,
                             cudaStream_t stream) {
  using P = Plan<kV1>;
  if (M < 1 || N % 16 || K % (kV1 ? 256 : 8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm, sm;
  int rc = make_map_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K,
                       P::XPART, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = make_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                   kV1 ? K / 2 : K, N, BK, BN,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  if (kV1) {
    rc = make_map_2d(&sm, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / 128,
                     N, P::SCALE_ROWS, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  } else {
    sm = wm;                                   // unused
  }
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + P::XROWS - 1) / P::XROWS) *
                    ((N + P::CLUSTER * BN - 1) / (P::CLUSTER * BN));
  kernel<<<tiles * P::CLUSTER, THREADS, P::SMEM_BYTES, stream>>>(
      xm, wm, sm, static_cast<const float*>(scale), out, M, N, K, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace opus_hopper
