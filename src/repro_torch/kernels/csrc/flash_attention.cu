// Blocked flash-attention forward (causal / sliding window / GQA, and the
// suffix mask of partial-hit and chunked prefill) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py (flash_attention ->
// _flash_kernel): f32 online softmax over key tiles, wholly masked tiles
// skipped, GQA by q_head / group, NEG_INF = -1e30 and the max(l, 1e-30)
// clamp of the reference.
//
// Shapes: q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd), out (B, Sq, H, hd), all
// bf16 or all f32, read and written in place in the model's layout (no
// transposed copies); prefix_len (B,) i32 or null. Key rows [0, P) are a
// right-padded prefix (P = Sk - Sq when prefix_len is given, else 0) and
// rows [P, Sk) the keys aligned with the queries. Query i sees prefix key
// j iff j < prefix_len[b], and aligned key P + j iff j <= i (causal) and
// j > i - window (window > 0). With P = 0 this is the TPU kernel's
// contract.
//
// Bound on the H100: at the prefill bucket (B=4, S=256, 52 heads, hd 128,
// bf16) the kernel must move 54.5 MB (q, k, v, out once: 16.3 us at
// 3.35 TB/s) and do 3.49 GFLOP of causal products (3.5 us on the bf16
// tensor cores), so its bound is bytes; this first kernel computes in f32
// FMAs off shared memory, which caps it far lower (3.49 GFLOP at 67
// TFLOP/s is 52 us), and is meant to be right first.
//
// Design: the TPU ran (bh, q block, k block) as a sequential grid and kept
// (m, l, acc) in VMEM across the k axis. Here one CTA of 128 threads owns
// (q tile of 64 rows, q head, batch row) and walks its key tiles (32 keys)
// in a loop: first the prefix tiles below prefix_len, then the aligned
// tiles from the window's left edge to the causal diagonal, so wholly
// masked tiles are never loaded. Q (converted to f32) stays in shared
// memory; each key tile's K and V are staged there. Thread (ty, tx),
// ty = tid / 8, tx = tid % 8, owns query rows 4*ty .. 4*ty+3, key columns
// tx + 8*c of a tile and hd/8 output columns; the 8 threads of a row
// group are consecutive lanes of one warp, so row max and row sum are
// three xor-shuffles and the probabilities pass between them through
// shared memory with only a warp barrier. Rows keep m, l and the
// (4 x hd/8) accumulator in registers. Shared-memory operands are read
// as float4 (float2 for hd 16): one load feeds 4 (QK) or 16 (PV) FMAs.
// Masked probabilities are set to 0 explicitly, so a row whose first
// tiles are all masked (the window, a dummy row with prefix_len 0)
// carries nothing into its sum. Later work: bf16 tiles through TMA and
// wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the plain version's mask value
constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 32;            // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = kBQ / (kThreads / 8);  // 4 rows per thread
constexpr int kCols = kBK / 8;               // 4 key columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// shared rows are padded by 4 floats (Q and K rows: HD + 4, P rows:
// kPStride): 16-byte aligned for float4 reads, and the 8 lanes of a
// quarter-warp land on distinct banks
constexpr int kPad = 4;
constexpr int kPStride = kBK + kPad;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + kPad) +
                          (size_t)kBK * (HD + kPad) + (size_t)kBK * HD +
                          (size_t)kBQ * kPStride);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int VW>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
  __device__ static float get(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<2> {
  using type = float2;
  __device__ static float get(const float2& v, int e) {
    return e == 0 ? v.x : v.y;
  }
};

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ prefix_len,
    T* __restrict__ out, int Sq, int Sk, int H, int Hkv, int P, int causal,
    int window, float sm_scale) {
  constexpr int QS = HD + kPad;
  constexpr int kOut = HD / 8;            // output columns per thread
  constexpr int VW = HD >= 32 ? 4 : 2;    // ... read VW at a time
  constexpr int kGroups = kOut / VW;      // cols tx*VW + 8*VW*g + e
  using VT = typename Vec<VW>::type;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // (kBQ, QS)
  float* sK = sQ + kBQ * QS;                    // (kBK, QS)
  float* sV = sK + kBK * QS;                    // (kBK, HD)
  float* sP = sV + kBK * HD;                    // (kBQ, kPStride)

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float val = 0.0f;
    if (q0 + r < Sq)
      val = to_f(q[(((size_t)b * Sq + q0 + r) * H + h) * HD + d]);
    sQ[r * QS + d] = val;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.0f;
  }

  int plen = prefix_len ? prefix_len[b] : 0;
  plen = plen < 0 ? 0 : (plen > P ? P : plen);
  const int n_al = Sk - P;  // aligned keys
  const int hi = causal ? min(n_al, q0 + kBQ) : n_al;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_pre = (plen + kBK - 1) / kBK;
  const int n_tiles = n_pre + (hi > lo ? (hi - lo + kBK - 1) / kBK : 0);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const bool pre = t < n_pre;
    // key rows [k0, kend) of this segment; tile columns past kend are 0
    const int k0 = pre ? t * kBK : P + lo + (t - n_pre) * kBK;
    const int kend = pre ? plen : P + hi;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int j = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (j < kend) {
        const size_t off = (((size_t)b * Sk + j) * Hkv + hk) * HD + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      sK[c * QS + d] = kv;
      sV[c * HD + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&sQ[(ty * kRows + r) * QS +
                                                     d]);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&sK[(tx + 8 * c) * QS + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = dot4(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + ty * kRows + r;  // query index
      bool vis[kCols];
      float tmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = k0 + tx + 8 * c;
        if (pre) {
          vis[c] = j < kend;
        } else {
          const int ja = j - P;
          vis[c] = j < kend && (!causal || ja <= i) &&
                   (window <= 0 || ja > i - window);
        }
        s[r][c] = vis[c] ? s[r][c] * sm_scale : kNegInf;
        tmax = fmaxf(tmax, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group8_max(tmax));
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.0f;
        sP[(ty * kRows + r) * kPStride + tx + 8 * c] = p;
        psum += p;
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + group8_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= corr;
    }
    __syncwarp();  // a row group's probabilities come from its own warp

    for (int c = 0; c < kBK; c += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p4[r] = *reinterpret_cast<const float4*>(
            &sP[(ty * kRows + r) * kPStride + c]);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const VT vv = *reinterpret_cast<const VT*>(
              &sV[(c + e4) * HD + tx * VW + 8 * VW * g]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = Vec<4>::get(p4[r], e4);
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[r][g * VW + e] =
                  fmaf(p, Vec<VW>::get(vv, e), acc[r][g * VW + e]);
          }
        }
      }
    }
    __syncthreads();  // sK/sV/sP are overwritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + ty * kRows + r;
    if (i >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    T* orow = out + (((size_t)b * Sq + i) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        from_f(&orow[tx * VW + 8 * VW * g + e], acc[r][g * VW + e] * inv);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* prefix_len, void* out, int B, int Sq, int Sk,
                   int H, int Hkv, int P, int causal, int window,
                   float sm_scale, cudaStream_t st) {
  auto kern = flash_fwd_kernel<HD, T>;
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)prefix_len, (T*)out,
      Sq, Sk, H, Hkv, P, causal, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const void* prefix_len, void* out, int B, int Sq, int Sk,
                      int H, int Hkv, int P, int causal, int window,
                      float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<16, T>(q, k, v, prefix_len, out, B, Sq, Sk, H, Hkv, P,
                           causal, window, sm_scale, st);
    case 32:
      return launch<32, T>(q, k, v, prefix_len, out, B, Sq, Sk, H, Hkv, P,
                           causal, window, sm_scale, st);
    case 64:
      return launch<64, T>(q, k, v, prefix_len, out, B, Sq, Sk, H, Hkv, P,
                           causal, window, sm_scale, st);
    case 128:
      return launch<128, T>(q, k, v, prefix_len, out, B, Sq, Sk, H, Hkv, P,
                            causal, window, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* prefix_len,
                                      void* out, int is_bf16, int B, int Sq,
                                      int Sk, int H, int Hkv, int hd, int P,
                                      int causal, int window, float sm_scale,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || P < 0 || P > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, prefix_len, out, B, Sq,
                                         Sk, H, Hkv, P, causal, window,
                                         sm_scale, st)
              : launch_hd<float>(hd, q, k, v, prefix_len, out, B, Sq, Sk, H,
                                 Hkv, P, causal, window, sm_scale, st);
  return (int)e;
}
