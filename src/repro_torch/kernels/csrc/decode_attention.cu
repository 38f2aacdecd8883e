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
// Dense only: a logit softcap c > 0 replaces each scaled score s by
// c * tanh(s / c) before the mask, in a compile-time variant (CAP), so
// c = 0 runs the uncapped instantiation, bit for bit as without it.
//
// Partial mode (dense only; lse non-null): each row also writes the
// log-sum-exp of its scaled scores, lse = m + log(l) in f32 (-inf where
// the row saw no key, kv_len = 0), beside its normalised out, written in
// f32 whatever q's type (q is read as it is). A caller
// holding (out, lse) of disjoint key ranges -- the kv_seq decode cache,
// each rank a run of positions -- merges them exactly:
// out = sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M)
// (distributed/comm.py: merge_partials).
//
// Shapes: q/out (B, Hkv, g, hd) contiguous, bf16 or f32; K/V bf16 or f32
// (dense) or bf16 (paged); kv_len (B,) i32; page_table (B, W) i32; out f32
// in the partial mode.
//
// Bound on the H100: memory. The work is ~4*g*hd FLOP for every key and
// head against 2*hd*sizeof(kv) bytes read (about 1 FLOP per byte at g = 1,
// far below the card's ~295): a LLaMA-30B decode step of 4 slots with 428
// cached tokens reads 428 * 52 * 128 * 2 * 2 = 11.4 MB per layer, 3.4 us at
// 3.35 TB/s.
//
// Design: flash-decoding, as the int4 kernel (csrc/paged_attention.cu). The
// grid is (split, sequence x KV head, query row). A split is a fixed run of
// keys (kernels/decode_attention.py: split_plan and launch_shape, functions
// of host shapes only: S for the dense view, seen as S pages of one key,
// and W x page_size for pages), 64 keys at page sizes up to 64; CTAs whose
// split starts at or past kv_len exit at once, so the grid needs nothing
// read on the host and the launch is capturable in a CUDA graph. A CTA of
// 256 threads covers 64 keys an iteration, one round of loads: its 16
// half-warps own U = 4 keys each, and each of a half-warp's 16 lanes loads
// its hd/16 contiguous elements of every one of those keys' K and V rows
// before using any (one 16-byte load per lane and row at hd = 128 in
// bf16; at hd 80 and 120, where hd/16 is no whole vector, a lane reads 8
// elements and only hd/8 lanes, 10 or 15, hold any: Lanes below), so 8
// independent loads per thread are in flight, kept as raw
// words until used (RawRow: 58 registers at hd 128 in bf16 where f32
// copies took ~105, which let only two CTAs share an SM). Dot products are
// reduced with 4 shuffles inside the half-warp; each half-warp keeps its
// own running (max, sum, accumulator) in registers, and the 16 states are
// merged through shared memory. The loop trip count is the same for every
// thread (keys past the split's end are masked, not branched around), so
// the shuffles never see a diverged warp. A CTA whose row has one active
// split writes `out` directly; otherwise it writes its partial state (m,
// l, acc) in f32 to scratch, and the last CTA of the row to finish, found
// with __threadfence and an atomic counter that it resets to 0 itself,
// merges the partial states and writes `out`. One launch per call. The
// first design ran one CTA per row over all of its keys: the longest
// slot's CTAs set the time while the short slots' SMs idled. What is left
// is a chain of latencies (chip_smoke.py phase 3, "split anatomy"): the
// launch, kv_len, one round of loads, and for a row of several splits the
// merge (partial store, fence, counter, reload).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// N contiguous elements of T (bf16 or f32) kept as raw 32-bit words until
// they are used: a bf16 row takes half the registers of its f32 values.
// Loaded from p (aligned to min(16, N * sizeof(T)) bytes) in loads of up
// to 16 bytes.
template <typename T, int N>
struct RawRow {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  unsigned w[kWords];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[c];
        w[4 * c] = v.x, w[4 * c + 1] = v.y, w[4 * c + 2] = v.z,
                  w[4 * c + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  // element e as f32 (a bf16 is the high half of its f32)
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {
      return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u)
                                     : (w[e >> 1] << 16));
    }
  }
};

// How a half-warp's 16 lanes cover a row of HD: EPL contiguous elements a
// lane, hd/16 where that is a power of two (every lane busy: hd 16 to
// 128, and 256), else 8 (one 16-byte bf16 chunk), with lanes NL..15 idle
// (hd 80: 10 lanes, hd 120: 15). kernels/decode_attention.py: lane_elems.
template <int HD>
struct Lanes {
  static constexpr int kQ = HD / 16;
  static constexpr int EPL =
      HD % 16 == 0 && (kQ & (kQ - 1)) == 0 ? kQ : 8;
  static constexpr int NL = HD / EPL;
  static_assert(HD % EPL == 0 && NL <= 16, "no lane map for this head dim");
};

// Dense cache: key t of (b, h) at b*sb + t*ss + h*sh (elements).
template <typename T>
struct DenseKeys {
  using Elem = T;
  const T* k;
  const T* v;
  long long sb, ss, sh;
  int max_len;  // S
  static constexpr bool kCapable = true;  // has the softcap instantiation
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
  static constexpr bool kCapable = false;  // pages refuse a softcap
  __device__ __forceinline__ size_t off(int b, int h, int t) const {
    int page = page_table[(size_t)b * W + t / ps];
    if (page < 0) page = 0;
    return (((size_t)page * ps + t % ps) * Hkv + h) * hd;
  }
};

template <int HD, typename Tq, typename To, typename Keys, bool CAP>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Tq* __restrict__ q, Keys keys,
                  const int* __restrict__ kv_len, To* __restrict__ out,
                  float* __restrict__ lse, float* __restrict__ part,
                  int* __restrict__ counters, int Hkv, int g, int split_len,
                  float sm_scale, float softcap) {
  using Tkv = typename Keys::Elem;
  constexpr int EPL = Lanes<HD>::EPL;  // elements per lane of a half-warp
  __shared__ float s_m[kHalfWarps], s_l[kHalfWarps];
  __shared__ float s_acc[kHalfWarps][HD];
  __shared__ int s_last;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, hw = tid >> 4, l16 = tid & 15;
  const bool lane_on = l16 < Lanes<HD>::NL;  // holds elements of a row
  int len = kv_len[b];
  if (len > keys.max_len) len = keys.max_len;
  if (len < 0) len = 0;
  const int n_active = (len + split_len - 1) / split_len;
  // split 0 also serves kv_len = 0 (it writes zeros)
  if (split >= (n_active > 0 ? n_active : 1)) return;
  const int t0 = split * split_len;
  const int t_end = min(len, t0 + split_len);

  const size_t row = (size_t)bh * g + blockIdx.z;  // the query row
  float qf[EPL];
  {
    RawRow<Tq, EPL> qr;
    if (lane_on)
      qr.load(q + row * HD + l16 * EPL);
    else
      qr.zero();
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[e] = qr.get(e);
  }

  float m = kNegInf, l = 0.0f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.0f;

  for (int base = t0; base < t_end; base += kHalfWarps * kUnroll) {
    RawRow<Tkv, EPL> kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + hw + u * kHalfWarps;
      ok[u] = t < t_end;
      if (ok[u] && lane_on) {
        const size_t o = keys.off(b, h, t) + l16 * EPL;
        kr[u].load(keys.k + o);
        vr[u].load(keys.v + o);
      } else {
        kr[u].zero(), vr[u].zero();
      }
    }
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d += qf[e] * kr[u].get(e);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      float x = d * sm_scale;
      if constexpr (CAP) x = softcap * tanhf(x / softcap);
      s[u] = ok[u] ? x : kNegInf;
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
      for (int e = 0; e < EPL; ++e) acc[e] += p * vr[u].get(e);
    }
    m = m_new;
  }

  // merge the half-warps: thread d < HD sums column d
  if (l16 == 0) {
    s_m[hw] = m;
    s_l[hw] = l;
  }
  if (lane_on) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[hw][l16 * EPL + e] = acc[e];
  }
  __syncthreads();
  float M = kNegInf, L = 0.0f, o = 0.0f;
  if (tid < HD) {
#pragma unroll
    for (int i = 0; i < kHalfWarps; ++i) M = fmaxf(M, s_m[i]);
#pragma unroll
    for (int i = 0; i < kHalfWarps; ++i) {
      const float w = expf(s_m[i] - M);
      L += s_l[i] * w;
      o += s_acc[i][tid] * w;
    }
  }
  if (n_active <= 1) {
    if (tid < HD) from_f(&out[row * HD + tid], o / fmaxf(L, 1e-30f));
    if (lse != nullptr && tid == 0)
      lse[row] = L > 0.0f ? M + logf(L) : -INFINITY;
    return;
  }
  const int stride = HD + 2;  // (m, l, acc)
  if (tid < HD) {
    float* pr = part + (row * n_split + split) * stride;
    pr[2 + tid] = o;
    if (tid == 0) pr[0] = M, pr[1] = L;
  }
  __threadfence();  // partial state visible before the count
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + row, 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) counters[row] = 0;  // ready for the next launch
  if (tid < HD) {
    const float* pr = part + row * n_split * stride;
    // one pass over the splits, rescaling as the max grows (loads through
    // the L2, past the L1)
    float mx = kNegInf, sum = 0.0f, acc_o = 0.0f;
#pragma unroll 4
    for (int sp = 0; sp < n_active; ++sp) {
      const float m_s = __ldcg(pr + sp * stride);
      const float l_s = __ldcg(pr + sp * stride + 1);
      const float o_s = __ldcg(pr + sp * stride + 2 + tid);
      const float m_new = fmaxf(mx, m_s);
      const float a = expf(mx - m_new), w = expf(m_s - m_new);
      sum = sum * a + l_s * w;
      acc_o = acc_o * a + o_s * w;
      mx = m_new;
    }
    from_f(&out[row * HD + tid], acc_o / fmaxf(sum, 1e-30f));
    if (lse != nullptr && tid == 0)
      lse[row] = sum > 0.0f ? mx + logf(sum) : -INFINITY;
  }
}

// split_len/n_split: kernels/decode_attention.py launch_shape; part: (B*Hkv*g,
// n_split, hd + 2) f32 scratch; counters: B*Hkv*g i32, all 0 between
// launches (each launch leaves them at 0). out is To: q's type, or f32 in
// the partial mode.
template <typename Tq, typename To, typename Keys>
cudaError_t launch(int hd, const void* q, const Keys& keys,
                   const void* kv_len, void* out, void* lse, void* part,
                   void* counters, int B, int Hkv, int g, int split_len,
                   int n_split, float sm_scale, float softcap,
                   cudaStream_t st) {
  if (softcap < 0.0f || (softcap > 0.0f && !Keys::kCapable))
    return cudaErrorInvalidValue;
  if (split_len <= 0 || keys.max_len <= 0 ||
      n_split != (keys.max_len + split_len - 1) / split_len ||
      (long long)B * Hkv > 65535 || g > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(n_split, B * Hkv, g);
  const Tq* qp = (const Tq*)q;
  const int* lp = (const int*)kv_len;
  To* op = (To*)out;
  float* pp = (float*)part;
  int* cp = (int*)counters;
  float* ep = (float*)lse;
#define DECODE_HD(HD)                                                      \
  case HD:                                                                 \
    if constexpr (Keys::kCapable) {                                        \
      if (softcap > 0.0f) {                                                \
        decode_kernel<HD, Tq, To, Keys, true><<<grid, kThreads, 0, st>>>(  \
            qp, keys, lp, op, ep, pp, cp, Hkv, g, split_len, sm_scale,     \
            softcap);                                                      \
        break;                                                             \
      }                                                                    \
    }                                                                      \
    decode_kernel<HD, Tq, To, Keys, false><<<grid, kThreads, 0, st>>>(     \
        qp, keys, lp, op, ep, pp, cp, Hkv, g, split_len, sm_scale, 0.0f);  \
    break;
  switch (hd) {
    DECODE_HD(16)
    DECODE_HD(32)
    DECODE_HD(64)
    DECODE_HD(80)
    DECODE_HD(120)
    DECODE_HD(128)
    DECODE_HD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_HD
  return cudaGetLastError();
}

template <typename Tkv>
cudaError_t launch_dense(int q_is_bf16, const void* q, const void* k,
                         const void* v, const void* kv_len, void* out,
                         void* lse, void* part, void* counters, int B,
                         int Hkv, int g, int hd, int S, long long sb,
                         long long ss, long long sh, int split_len,
                         int n_split, float sm_scale, float softcap,
                         cudaStream_t st) {
  DenseKeys<Tkv> keys{(const Tkv*)k, (const Tkv*)v, sb, ss, sh, S};
  if (!q_is_bf16)
    return launch<float, float>(hd, q, keys, kv_len, out, lse, part,
                                counters, B, Hkv, g, split_len, n_split,
                                sm_scale, softcap, st);
  // the partial mode's out is f32 (the cross-rank merge reads it unrounded)
  return lse != nullptr
             ? launch<__nv_bfloat16, float>(hd, q, keys, kv_len, out, lse,
                                            part, counters, B, Hkv, g,
                                            split_len, n_split, sm_scale,
                                            softcap, st)
             : launch<__nv_bfloat16, __nv_bfloat16>(
                   hd, q, keys, kv_len, out, lse, part, counters, B, Hkv, g,
                   split_len, n_split, sm_scale, softcap, st);
}

}  // namespace

// Dense decode attention; sb/ss/sh are K's and V's batch, sequence and head
// strides in elements (the head dimension is contiguous). lse: null, or
// (B*Hkv*g) f32 for the partial mode's log-sum-exp of each row. softcap:
// 0, or the cap of the scores.
extern "C" int decode_attention_launch(
    const void* q, int q_is_bf16, const void* k, const void* v,
    int kv_is_bf16, const void* kv_len, void* out, void* lse, void* part,
    void* counters, int B, int Hkv, int g, int hd, int S, long long sb,
    long long ss, long long sh, int split_len, int n_split, float sm_scale,
    float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kv_is_bf16
                   ? launch_dense<__nv_bfloat16>(
                         q_is_bf16, q, k, v, kv_len, out, lse, part,
                         counters, B, Hkv, g, hd, S, sb, ss, sh, split_len,
                         n_split, sm_scale, softcap, st)
                   : launch_dense<float>(q_is_bf16, q, k, v, kv_len, out,
                                         lse, part, counters, B, Hkv, g, hd,
                                         S, sb, ss, sh, split_len, n_split,
                                         sm_scale, softcap, st));
}

// Paged decode attention over bf16 pages (P, ps, Hkv, hd).
extern "C" int paged_attention_bf16_launch(
    const void* q, int q_is_bf16, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, void* part,
    void* counters, int B, int Hkv, int g, int hd, int W, int ps,
    int split_len, int n_split, float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0) return (int)cudaGetLastError();
  if (ps <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PagedKeys keys{(const __nv_bfloat16*)k_pages,
                 (const __nv_bfloat16*)v_pages,
                 (const int*)page_table, W, ps, Hkv, hd, W * ps};
  return (int)(q_is_bf16
                   ? launch<__nv_bfloat16, __nv_bfloat16>(
                         hd, q, keys, kv_len, out, nullptr, part, counters,
                         B, Hkv, g, split_len, n_split, sm_scale, 0.0f, st)
                   : launch<float, float>(hd, q, keys, kv_len, out, nullptr,
                                          part, counters, B, Hkv, g,
                                          split_len, n_split, sm_scale,
                                          0.0f, st));
}
