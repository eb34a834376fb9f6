// Hopper (sm_90a) one-token decode attention over a quantized KV cache.
//
// Port of the Pallas kernels `_kernel` (decode_attention_int8) and
// `_kernel4` (decode_attention_int4) in
// opus_pllm_tpu/kernels/decode_attention.py. For each batch row b and KV
// head h, with the G = Hq/Hkv query heads g of that KV head:
//   logit[g, t] = (q_bf16[g] . k_int[t]) * (k_scale[t] / sqrt(D))   fp32
//   masked slots -> -1e30; softmax in fp32
//   out[g]      = sum_t (p[g, t] * v_scale[t]) * v_int[t] / max(l, 1e-30)
// so the dequantized cache never exists in memory. Cache rows are
// head-major: (B, Hkv, S, D) int8, or (B, Hkv, S, D/2) packed int4 with the
// low nibble of byte j holding d = j and the high nibble d = j + D/2;
// scales (B, Hkv, S) fp32; mask (B, S) bytes.
//
// One CTA per (KV head, row), 256 threads, an online softmax over chunks of
// 256 slots:
//   1. logits: thread t reads slot t's K row once (16-byte loads) and
//      forms all G dot products against q held in shared memory as fp32;
//   2. warp g takes head g: chunk max, running max / sum update, and the
//      weights p * v_scale written back to shared memory;
//   3. values: thread (split, d) reads V[t, d] once for every G head and
//      accumulates G fp32 sums after rescaling them by the running max.
// Any capacity is taken: the ragged last chunk simply has fewer slots.
// Entry point returns the cudaError_t of its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = THREADS;   // slots per chunk: one per thread in step 1
constexpr int MAXG = 8;          // query heads per KV head
constexpr float MASKED = -1e30f;

template <bool INT4>
__device__ __forceinline__ float lo_val(int8_t b) {
  return INT4 ? static_cast<float>(static_cast<int8_t>(b << 4) >> 4)
              : static_cast<float>(b);
}

__device__ __forceinline__ float hi_val(int8_t b) {
  return static_cast<float>(b >> 4);         // arithmetic: sign-correct
}

template <int D, bool INT4>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const bf16* __restrict__ q,
                        const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const uint8_t* __restrict__ mask,
                        void* __restrict__ out, int Hkv, int G, int S,
                        float scale, int out_bf16) {
  constexpr int RB = INT4 ? D / 2 : D;       // bytes per cache row
  constexpr int TS = THREADS / D;            // slot splits in step 3
  __shared__ __align__(16) float qs[MAXG][D];
  __shared__ float pw[MAXG][CHUNK];
  __shared__ float comb[TS][MAXG][D];
  __shared__ float m_run[MAXG], l_run[MAXG], alpha[MAXG];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t row0 = ((size_t)b * Hkv + h) * S;   // first slot of (b, h)
  const bf16* qh = q + ((size_t)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += THREADS)
    qs[i / D][i % D] = __bfloat162float(qh[i]);
  if (tid < MAXG) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  const int d = tid % D, ts = tid / D;
  float o[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) o[g] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    const int n = min(CHUNK, S - c0);
    // 1. logits, one slot per thread
    if (tid < n) {
      const size_t t = row0 + c0 + tid;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
      const int8_t* kr = kq + t * RB;
#pragma unroll
      for (int j = 0; j < RB; j += 16) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + j);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        float kl[16], kh[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          kl[u] = lo_val<INT4>(e[u]);
          kh[u] = INT4 ? hi_val(e[u]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int u = 0; u < 16; u += 4) {
            const float4 a = *reinterpret_cast<const float4*>(&qs[g][j + u]);
            dot[g] += a.x * kl[u] + a.y * kl[u + 1] + a.z * kl[u + 2] +
                      a.w * kl[u + 3];
            if (INT4) {
              const float4 c =
                  *reinterpret_cast<const float4*>(&qs[g][j + u + D / 2]);
              dot[g] += c.x * kh[u] + c.y * kh[u + 1] + c.z * kh[u + 2] +
                        c.w * kh[u + 3];
            }
          }
        }
      }
      const float f = ks[t] * scale;
      const bool ok = mask[(size_t)b * S + c0 + tid] != 0;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) pw[g][tid] = ok ? dot[g] * f : MASKED;
    }
    __syncthreads();

    // 2. online softmax: warp g owns head g
    if (warp < G) {
      const float m_old = m_run[warp];
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pw[warp][t]);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(pw[warp][t] - m_new);
        sum += p;
        pw[warp][t] = p * vs[row0 + c0 + t];
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, s);
      if (lane == 0) {
        const float a = expf(m_old - m_new);     // 0 on the first chunk
        alpha[warp] = a;
        l_run[warp] = l_run[warp] * a + sum;
        m_run[warp] = m_new;
      }
    }
    __syncthreads();

    // 3. values: thread (ts, d) takes slots ts, ts + TS, ... of the chunk
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) o[g] *= alpha[g];
    const int8_t* vc = vq + (row0 + c0) * RB;
    for (int t = ts; t < n; t += TS) {
      float v;
      if (INT4) {
        const int8_t byte = vc[(size_t)t * RB + d % (D / 2)];
        v = d < D / 2 ? lo_val<true>(byte) : hi_val(byte);
      } else {
        v = static_cast<float>(vc[(size_t)t * RB + d]);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) o[g] += pw[g][t] * v;
    }
    __syncthreads();                 // pw is rewritten by the next chunk
  }

  // add the slot splits, normalise, store (B, Hq, D) with hq = h * G + g
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) comb[ts][g][d] = o[g];
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, dd = i % D;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TS; ++k) s += comb[k][g][dd];
    const float r = s / fmaxf(l_run[g], 1e-30f);
    const size_t oi = ((size_t)b * Hkv + h) * G * D + i;
    if (out_bf16)
      static_cast<bf16*>(out)[oi] = __float2bfloat16(r);
    else
      static_cast<float*>(out)[oi] = r;
  }
}

template <int D, bool INT4>
cudaError_t launch(const void* q, const void* kq, const void* ks,
                   const void* vq, const void* vs, const void* mask,
                   void* out, int B, int Hkv, int G, int S, float scale,
                   int out_bf16, cudaStream_t st) {
  decode_attention_kernel<D, INT4><<<dim3(Hkv, B), THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(mask), out,
      Hkv, G, S, scale, out_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* opus_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, Hkv*G, D) bf16; kq/vq (B, Hkv, S, D) int8 or (B, Hkv, S, D/2)
// packed int4 (is_int4 = 1); ks/vs (B, Hkv, S) fp32; mask (B, S) bytes;
// out (B, Hkv*G, D) bf16 (out_bf16 = 1) or fp32. D in {64, 128}, G <= 8.
int opus_decode_attention(const void* q, const void* kq, const void* ks,
                          const void* vq, const void* vs, const void* mask,
                          void* out, int B, int Hkv, int G, int S, int D,
                          int is_int4, int out_bf16, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || G < 1 || G > MAXG || S < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (D == 128)
    e = is_int4 ? launch<128, true>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                    S, scale, out_bf16, st)
                : launch<128, false>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                     S, scale, out_bf16, st);
  else if (D == 64)
    e = is_int4 ? launch<64, true>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                   S, scale, out_bf16, st)
                : launch<64, false>(q, kq, ks, vq, vs, mask, out, B, Hkv, G,
                                    S, scale, out_bf16, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

}  // extern "C"
