// Paged flash-decode attention over int4-resident K/V pages, for Hopper
// (sm_90a).
//
// Replaces the int4 body of src/repro/kernels/paged_attention.py
// (paged_decode_attention -> _kernel_int4): one query token per sequence,
// K/V pages dequantized inside the loop, f32 online softmax, pages at or
// past kv_len skipped, table entry 0 = the trash page.
//
// Shapes: q (B, Hkv, gq, hd) bf16 or f32; kp/vp (P, ps*ppr, g/2) u8;
// ks/kz/vs/vz (P, ps*ppr, 1) f32; page_table (B, W) i32; kv_len (B,) i32;
// out (B, Hkv, gq, hd) in q's type. Element (t, h, d) of a page sits at the
// flat index f = h*hd + d of token t: row t*ppr + f/g, byte (f%g)/2,
// nibble (f%g)&1. The group g may span several heads (reduced configs) or
// equal hd (LLaMA-30B: g = hd = 128), so nothing here assumes one group per
// head.
//
// Bound on the H100: memory. Per cached token and layer the kernel must
// read 2*ppr*(g/2 + 8) bytes of pages (plus q and out once); the arithmetic
// is ~4*gq*hd FLOP per token and head, far below the compute roof.
//
// Design: one thread block per (sequence, KV head), so the grid is B*Hkv
// blocks (208 at LLaMA-30B width and batch 4) and each block walks its own
// page list with a loop, where the TPU walked pages as a sequential grid
// axis. Per page, the block dequantizes only its head's hd columns of the
// ps tokens into shared memory (each thread one packed byte -> two values,
// neighbouring threads on neighbouring bytes), warps compute the gq*ps
// scores with shuffle reductions, one thread per query row updates the
// running max and sum, and the f32 accumulator (gq*hd) stays in shared
// memory. Pages past ceil(kv_len/ps) are never read. A simple first kernel:
// no cp.async/TMA prefetch of the next page and no split over the sequence
// yet, which leaves the card idle at small batch; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the plain version's mask value
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attn_int4_kernel(
    const T* __restrict__ q, const uint8_t* __restrict__ kp,
    const float* __restrict__ ks, const float* __restrict__ kz,
    const uint8_t* __restrict__ vp, const float* __restrict__ vs,
    const float* __restrict__ vz, const int* __restrict__ page_table,
    const int* __restrict__ kv_len, T* __restrict__ out, int Hkv, int gq,
    int hd, int W, int R, int g, int ps, float sm_scale) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kThreads / 32;
  const int ppr = R / ps;
  const int g2 = g / 2;

  extern __shared__ float smem[];
  float* sq = smem;                  // (gq, hd) query rows
  float* sacc = sq + gq * hd;        // (gq, hd) running numerators
  float* sk = sacc + gq * hd;        // (ps, hd) this page's K for head h
  float* sv = sk + ps * hd;          // (ps, hd) ... and V
  float* sp = sv + ps * hd;          // (gq, ps) scores, then probabilities
  float* sm = sp + gq * ps;          // (gq) running max
  float* sl = sm + gq;               // (gq) running sum
  float* sc = sl + gq;               // (gq) rescale factor of this page

  const size_t qoff = ((size_t)b * Hkv + h) * gq * hd;
  for (int i = tid; i < gq * hd; i += kThreads) {
    sq[i] = to_f(q[qoff + i]);
    sacc[i] = 0.0f;
  }
  for (int j = tid; j < gq; j += kThreads) {
    sm[j] = kNegInf;
    sl[j] = 0.0f;
  }
  const int len = kv_len[b];
  int n_pages = (len + ps - 1) / ps;
  if (n_pages > W) n_pages = W;
  __syncthreads();

  for (int pi = 0; pi < n_pages; ++pi) {
    int page = page_table[(size_t)b * W + pi];
    if (page < 0) page = 0;
    const size_t prow = (size_t)page * R;
    // dequantize head h of the page's ps tokens: one packed byte each
    for (int i = tid; i < ps * (hd / 2); i += kThreads) {
      const int t = i / (hd / 2);
      const int d = 2 * (i % (hd / 2));
      const int f = h * hd + d;
      const size_t row = prow + (size_t)t * ppr + f / g;
      const size_t byte = row * g2 + (f % g) / 2;
      const unsigned kb = kp[byte], vb = vp[byte];
      const float ksc = ks[row], kzp = kz[row];
      const float vsc = vs[row], vzp = vz[row];
      sk[t * hd + d] = __fadd_rn(__fmul_rn((float)(kb & 0xFu), ksc), kzp);
      sk[t * hd + d + 1] = __fadd_rn(__fmul_rn((float)(kb >> 4), ksc), kzp);
      sv[t * hd + d] = __fadd_rn(__fmul_rn((float)(vb & 0xFu), vsc), vzp);
      sv[t * hd + d + 1] = __fadd_rn(__fmul_rn((float)(vb >> 4), vsc), vzp);
    }
    __syncthreads();
    // scores: one warp per (query row, token) pair
    for (int pair = warp; pair < gq * ps; pair += n_warps) {
      const int j = pair / ps, t = pair % ps;
      float acc = 0.0f;
      for (int d = lane; d < hd; d += 32)
        acc += sq[j * hd + d] * sk[t * hd + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        sp[pair] = (pi * ps + t < len) ? acc * sm_scale : kNegInf;
    }
    __syncthreads();
    // online softmax bookkeeping: one thread per query row
    for (int j = tid; j < gq; j += kThreads) {
      const float m_prev = sm[j];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, sp[j * ps + t]);
      float psum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sp[j * ps + t] - m_new);
        sp[j * ps + t] = p;
        psum += p;
      }
      const float corr = expf(m_prev - m_new);
      sl[j] = sl[j] * corr + psum;
      sm[j] = m_new;
      sc[j] = corr;
    }
    __syncthreads();
    for (int i = tid; i < gq * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      float a = sacc[i] * sc[j];
      for (int t = 0; t < ps; ++t) a += sp[j * ps + t] * sv[t * hd + d];
      sacc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < gq * hd; i += kThreads) {
    const int j = i / hd;
    from_f(&out[qoff + i], sacc[i] / fmaxf(sl[j], 1e-30f));
  }
}

}  // namespace

extern "C" int paged_attention_int4_launch(
    const void* q, int q_is_bf16, const void* kp, const void* ks,
    const void* kz, const void* vp, const void* vs, const void* vz,
    const void* page_table, const void* kv_len, void* out, int B, int Hkv,
    int gq, int hd, int W, int R, int g, int ps, float sm_scale,
    void* stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)gq * hd + 2 * (size_t)ps * hd +
                       (size_t)gq * ps + 3 * (size_t)gq);
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && Hkv > 0) {
    if (q_is_bf16) {
      auto k = paged_attn_int4_kernel<__nv_bfloat16>;
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      k<<<B * Hkv, kThreads, smem, st>>>(
          (const __nv_bfloat16*)q, (const uint8_t*)kp, (const float*)ks,
          (const float*)kz, (const uint8_t*)vp, (const float*)vs,
          (const float*)vz, (const int*)page_table, (const int*)kv_len,
          (__nv_bfloat16*)out, Hkv, gq, hd, W, R, g, ps, sm_scale);
    } else {
      auto k = paged_attn_int4_kernel<float>;
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      k<<<B * Hkv, kThreads, smem, st>>>(
          (const float*)q, (const uint8_t*)kp, (const float*)ks,
          (const float*)kz, (const uint8_t*)vp, (const float*)vs,
          (const float*)vz, (const int*)page_table, (const int*)kv_len,
          (float*)out, Hkv, gq, hd, W, R, g, ps, sm_scale);
    }
  }
  return (int)cudaGetLastError();
}
