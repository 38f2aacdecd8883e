// Flash-decode attention over a plain (16- or 32-bit) KV cache for Hopper
// (sm_90a): one templated body, two ways of finding a key.
//
// Replaces two TPU kernels:
//   * src/repro/kernels/decode_attention.py (decode_attention ->
//     _decode_kernel): the dense cache, key t of sequence b and KV head h
//     at k[b, h, t, :] -- here any strided view with a contiguous last
//     axis, so the port's (B, S, Hkv, hd) decode cache is read in place;
//   * src/repro/kernels/paged_attention.py (paged_decode_attention ->
//     _kernel_bf16): bf16 pages (P, ps, Hkv, hd), key t at row t % ps of
//     page page_table[b, t / ps] (entries clamped at >= 0; entry 0 is the
//     trash page).
// Both: one query token per sequence, the g query heads of a KV head, keys
// at or past kv_len[b] never loaded, masked scores -1e30, f32 online
// softmax, out = acc / max(l, 1e-30) in q's type (so kv_len = 0 gives 0).
//
// Shapes: q/out (B, Hkv, g, hd) contiguous, bf16 or f32; K/V bf16 or f32
// (dense) or bf16 (paged); kv_len (B,) i32; page_table (B, W) i32.
//
// Bound on the H100: memory. The work is ~4*g*hd FLOP for every key and
// head against 2*hd*sizeof(kv) bytes read (about 1 FLOP per byte at g = 1,
// far below the card's ~295): a LLaMA-30B decode step of 4 slots with 428
// cached tokens reads 428 * 52 * 128 * 2 * 2 = 11.4 MB per layer, 3.4 us at
// 3.35 TB/s.
//
// Design: one CTA of 256 threads per (sequence, KV head, query row), so 208
// CTAs at LLaMA-30B width and batch 4 (g = 1). The CTA's 16 half-warps
// stride over keys: a half-warp owns U = 4 keys per iteration, and each of
// its 16 lanes loads its hd/16 contiguous elements of every one of those
// keys' K and V rows before using any (one 16-byte load per lane and row
// at hd = 128 in bf16), so 8 independent loads per thread are in flight.
// Dot products are reduced with 4 shuffles inside the half-warp; each
// half-warp keeps its own running (max, sum, accumulator) in registers,
// and the 16 partial states are merged through shared memory at the end.
// The loop trip count is the same for every thread (keys past kv_len are
// masked, not branched around), so the shuffles never see a diverged warp.
// Nothing is read back to the host. Later work: split the sequence across
// CTAs (flash-decoding) and prefetch with cp.async/TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the plain version's mask value
constexpr int kThreads = 256;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kUnroll = 4;         // keys per half-warp per iteration

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Up to 16 raw bytes, read back as f32 or bf16 elements.
union Raw16 {
  uint4 u16;
  uint2 u8;
  unsigned u4;
  unsigned short u2;
  unsigned short h[8];
  float f[4];
};
__device__ __forceinline__ float elem(const Raw16& r, int j, const float*) {
  return r.f[j];
}
__device__ __forceinline__ float elem(const Raw16& r, int j,
                                      const __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(r.h[j]));
}

// N contiguous elements at p (aligned to min(16, N * sizeof(T)) bytes) into
// f32, in loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kVec = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kVec / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < kBytes / kVec; ++c) {
    Raw16 buf;
    if constexpr (kVec == 16) {
      buf.u16 = reinterpret_cast<const uint4*>(p)[c];
    } else if constexpr (kVec == 8) {
      buf.u8 = reinterpret_cast<const uint2*>(p)[c];
    } else if constexpr (kVec == 4) {
      buf.u4 = reinterpret_cast<const unsigned*>(p)[c];
    } else {
      buf.u2 = reinterpret_cast<const unsigned short*>(p)[c];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      out[c * kPer + j] = elem(buf, j, (const T*)nullptr);
  }
}

// Dense cache: key t of (b, h) at b*sb + t*ss + h*sh (elements).
template <typename T>
struct DenseKeys {
  using Elem = T;
  const T* k;
  const T* v;
  long long sb, ss, sh;
  int max_len;  // S
  __device__ __forceinline__ size_t off(int b, int h, int t) const {
    return (size_t)(b * sb + t * ss + h * sh);
  }
};

// bf16 pages (P, ps, Hkv, hd): key t of (b, h) on page page_table[b, t/ps].
struct PagedKeys {
  using Elem = __nv_bfloat16;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* page_table;
  int W, ps, Hkv, hd;
  int max_len;  // W * ps
  __device__ __forceinline__ size_t off(int b, int h, int t) const {
    int page = page_table[(size_t)b * W + t / ps];
    if (page < 0) page = 0;
    return (((size_t)page * ps + t % ps) * Hkv + h) * hd;
  }
};

template <int HD, typename Tq, typename Keys>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Tq* __restrict__ q, Keys keys,
                  const int* __restrict__ kv_len, Tq* __restrict__ out,
                  int Hkv, int g, float sm_scale) {
  using Tkv = typename Keys::Elem;
  constexpr int EPL = HD / 16;  // elements per lane of a half-warp
  __shared__ float s_m[kHalfWarps], s_l[kHalfWarps];
  __shared__ float s_acc[kHalfWarps][HD];

  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, hw = tid >> 4, l16 = tid & 15;
  int len = kv_len[b];
  if (len > keys.max_len) len = keys.max_len;
  if (len < 0) len = 0;

  const size_t qoff = ((size_t)bh * g + j) * HD;
  float qf[EPL];
  load_row<Tq, EPL>(q + qoff + l16 * EPL, qf);

  float m = kNegInf, l = 0.0f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.0f;

  for (int base = 0; base < len; base += kHalfWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + hw + u * kHalfWarps;
      ok[u] = t < len;
      if (ok[u]) {
        const size_t o = keys.off(b, h, t) + l16 * EPL;
        load_row<Tkv, EPL>(keys.k + o, kf[u]);
        load_row<Tkv, EPL>(keys.v + o, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.0f;
      }
    }
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d += qf[e] * kf[u][e];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = ok[u] ? d * sm_scale : kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = ok[u] ? expf(s[u] - m_new) : 0.0f;
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += p * vf[u][e];
    }
    m = m_new;
  }

  if (l16 == 0) {
    s_m[hw] = m;
    s_l[hw] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) s_acc[hw][l16 * EPL + e] = acc[e];
  __syncthreads();
  if (tid < HD) {
    float M = kNegInf;
#pragma unroll
    for (int i = 0; i < kHalfWarps; ++i) M = fmaxf(M, s_m[i]);
    float L = 0.0f, o = 0.0f;
#pragma unroll
    for (int i = 0; i < kHalfWarps; ++i) {
      const float w = expf(s_m[i] - M);
      L += s_l[i] * w;
      o += s_acc[i][tid] * w;
    }
    from_f(&out[qoff + tid], o / fmaxf(L, 1e-30f));
  }
}

template <typename Tq, typename Keys>
cudaError_t launch(int hd, const void* q, const Keys& keys,
                   const void* kv_len, void* out, int B, int Hkv, int g,
                   float sm_scale, cudaStream_t st) {
  const dim3 grid(B * Hkv, g);
  const Tq* qp = (const Tq*)q;
  const int* lp = (const int*)kv_len;
  Tq* op = (Tq*)out;
  switch (hd) {
    case 16:
      decode_kernel<16, Tq, Keys><<<grid, kThreads, 0, st>>>(
          qp, keys, lp, op, Hkv, g, sm_scale);
      break;
    case 32:
      decode_kernel<32, Tq, Keys><<<grid, kThreads, 0, st>>>(
          qp, keys, lp, op, Hkv, g, sm_scale);
      break;
    case 64:
      decode_kernel<64, Tq, Keys><<<grid, kThreads, 0, st>>>(
          qp, keys, lp, op, Hkv, g, sm_scale);
      break;
    case 128:
      decode_kernel<128, Tq, Keys><<<grid, kThreads, 0, st>>>(
          qp, keys, lp, op, Hkv, g, sm_scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename Tkv>
cudaError_t launch_dense(int q_is_bf16, const void* q, const void* k,
                         const void* v, const void* kv_len, void* out,
                         int B, int Hkv, int g, int hd, int S, long long sb,
                         long long ss, long long sh, float sm_scale,
                         cudaStream_t st) {
  DenseKeys<Tkv> keys{(const Tkv*)k, (const Tkv*)v, sb, ss, sh, S};
  return q_is_bf16
             ? launch<__nv_bfloat16>(hd, q, keys, kv_len, out, B, Hkv, g,
                                     sm_scale, st)
             : launch<float>(hd, q, keys, kv_len, out, B, Hkv, g, sm_scale,
                             st);
}

}  // namespace

// Dense decode attention; sb/ss/sh are K's and V's batch, sequence and head
// strides in elements (the head dimension is contiguous).
extern "C" int decode_attention_launch(
    const void* q, int q_is_bf16, const void* k, const void* v,
    int kv_is_bf16, const void* kv_len, void* out, int B, int Hkv, int g,
    int hd, int S, long long sb, long long ss, long long sh, float sm_scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kv_is_bf16
                   ? launch_dense<__nv_bfloat16>(q_is_bf16, q, k, v, kv_len,
                                                 out, B, Hkv, g, hd, S, sb,
                                                 ss, sh, sm_scale, st)
                   : launch_dense<float>(q_is_bf16, q, k, v, kv_len, out, B,
                                         Hkv, g, hd, S, sb, ss, sh, sm_scale,
                                         st));
}

// Paged decode attention over bf16 pages (P, ps, Hkv, hd).
extern "C" int paged_attention_bf16_launch(
    const void* q, int q_is_bf16, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, int B, int Hkv,
    int g, int hd, int W, int ps, float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  PagedKeys keys{(const __nv_bfloat16*)k_pages,
                 (const __nv_bfloat16*)v_pages,
                 (const int*)page_table, W, ps, Hkv, hd, W * ps};
  return (int)(q_is_bf16
                   ? launch<__nv_bfloat16>(hd, q, keys, kv_len, out, B, Hkv,
                                           g, sm_scale, st)
                   : launch<float>(hd, q, keys, kv_len, out, B, Hkv, g,
                                   sm_scale, st));
}
