// Paged flash-decode attention over int4-resident K/V pages, for Hopper
// (sm_90a), split across the sequence (flash-decoding).
//
// Replaces the int4 body of src/repro/kernels/paged_attention.py
// (paged_decode_attention -> _kernel_int4): one query token per sequence,
// K/V pages dequantized inside the loop, f32 online softmax with masked
// scores -1e30 and out = acc / max(l, 1e-30) in q's type (kv_len = 0 gives
// 0), pages at or past min(ceil(kv_len/ps), W) never read, table entries
// clamped at 0 (the trash page).
//
// Shapes: q (B, Hkv, gq, hd) bf16 or f32, hd in {16, 32, 64, 80, 128,
// 256}; kp/vp
// (P, ps*ppr, g/2) u8; ks/kz/vs/vz (P, ps*ppr, 1) f32; page_table (B, W)
// i32; kv_len (B,) i32; out (B, Hkv, gq, hd) in q's type. Element (t, h, d)
// of a page sits at the flat index f = h*hd + d of token t: row t*ppr +
// f/g, byte (f%g)/2, nibble (f%g)&1. The group g may span several heads
// (reduced configs: g = 64 over heads of 32), equal hd (LLaMA-30B: g =
// hd = 128), or end inside a head (stablelm-3b: g = 128 over heads of 80,
// a group and a half a head); a lane's chunk of EPC elements never
// crosses a row, because EPC divides both hd and g. Where hd / EPC lanes
// are not a power of two, a token takes the next power of two and the
// lanes past hd / EPC hold nothing (hd 80: 5 of 8 lanes at one query row,
// 10 of 16 at four).
//
// Bound on the H100: memory. Per cached token and layer the kernel must
// read 2*ppr*(g/2 + 8) bytes of pages (plus q and out once): at the main
// path's decode step (4 slots, kv_len 232/123/56/17, 52 KV heads, hd 128,
// 16-token pages) 428 tokens x 14,976 B = 3.2 MB, 0.96 us at 3.35 TB/s; the
// arithmetic, ~4*gq*hd FLOP per token and head, is far below the compute
// roof. The first kernel (81 us there on an H100 80GB HBM3 at 700 W,
// chip_smoke.py) ran one CTA per (slot, head) that walked its pages
// serially, a dependent page-table load and four barriers per page, so
// the longest slot's CTAs set the time while most SMs idled.
//
// Design: one launch a call, capturable in a CUDA graph: the grid is a
// function of host facts only (kernels/paged_attention.py: launch_shape):
// the SMs x the kernel's occupancy x 4 waves, capped by the work items the
// shapes allow. A work item is one (slot, split, KV head, query-row
// block). A slot's splits (split_pages; paged_attention.py: int4_split)
// are split_plan's 64-token runs of pages up to kSplits of them, else
// about kSplits runs of up to kMaxSplitTokens tokens, then more: a
// function of the slot's own kv_len and the shapes, so its split
// boundaries, its token groups and its merge order never depend on the
// other slots or on which CTA took an item, and its output bytes are the
// same alone or in any batch (and up to 256 tokens the same as the first
// split grid's). The grid is 1-D: every CTA loads kv_len, counts each
// slot's live splits and sums them into the first item of each slot (in
// each warp's registers up to 32 slots, else a block scan in shared
// memory), then strides over the live items alone, blockIdx.x first,
// gridDim.x apart; a grid-stride store writes the zero rows of the slots
// at kv_len 0. So a launch costs the work of the live KV, not of every
// page the table could hold (the first split grid ran 98,304 CTAs at 96
// slots of 256 16-token pages, nearly all of them to exit at once), and a
// long slot's splits amortize their fixed costs (page ids, the merge of
// token groups, the partial state, the merge of splits) over more keys.
//
// An item loads its split's page ids into shared memory up front, so no
// data load waits behind a page-table load. Its 4 warps dequantize in
// registers with no shared staging: a token's head is LPT lanes (each EPC
// elements: 16 packed bytes in one vector load when gq = 1), a warp covers
// 32/LPT tokens per step, and every lane issues kU steps' loads (packed K
// and V, scale and zero) before using any of them. Dequantization is the
// wire's own arithmetic (__fmul_rn then __fadd_rn, no FMA). Each token
// group keeps its own running (max, sum, accumulator); the CTA merges them
// through shared memory. An item whose slot has one active split writes
// `out` directly; otherwise it writes its partial state (m, l, acc) in f32
// to scratch, and the CTA that finishes the last split of the (slot, head,
// row block), found with __threadfence and an atomic counter that it
// resets to 0 itself, merges the partial states and writes `out`. No CTA
// waits on another, so the grid cannot deadlock.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the plain version's mask value
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kU = 2;              // token steps whose loads are in flight
// a slot's splits past split_plan's (paged_attention.py: INT4_SPLITS) and
// the tokens of its longest split (INT4_MAX_SPLIT_TOKENS)
constexpr int kSplits = 4;
constexpr int kMaxSplitTokens = 256;
constexpr int kMaxSplitPages = 256;  // >= pages per split

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

// Lane geometry for head dim HD and GQ query rows per CTA
// (kernels/paged_attention.py: lane_elems).
template <int HD, int GQ>
struct Geo {
  // elements per lane: 32 (16 packed bytes) for one query row, or the
  // widest of 16 and 8 that divides hd; 8 when a lane keeps GQ rows of q
  // and accumulator in registers
  static constexpr int EPC =
      GQ == 1 ? (HD < 32 ? HD : HD % 32 == 0 ? 32 : HD % 16 == 0 ? 16 : 8)
              : 8;
  static constexpr int NLA = HD / EPC;        // lanes that hold elements
  static constexpr int LPT = pow2_ceil(NLA);  // lanes per token
  static_assert(HD % EPC == 0 && LPT <= 32, "no lane map for this head dim");
  static constexpr int TPW = 32 / LPT;        // tokens per warp step
  static constexpr int G = kWarps * TPW;      // token groups (and tokens)
                                              // per step of a CTA
};

// EPC/2 packed bytes at p (aligned to that size)
template <int EPC>
struct Packed {
  static constexpr int N = EPC / 8 > 0 ? EPC / 8 : 1;  // 32-bit words
  unsigned w[N];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (EPC == 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (EPC == 16) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
      static_assert(EPC == 8, "EPC is 8, 16 or 32");
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = 0;
  }
  // element e: byte e/2, low nibble for even e (kv_layout.py)
  __device__ __forceinline__ float deq(int e, float scale, float zp) const {
    const unsigned nib = (w[e >> 3] >> (4 * (e & 7))) & 0xFu;
    return __fadd_rn(__fmul_rn((float)nib, scale), zp);
  }
};

// pages a split of a slot holding len tokens covers: its pages in about
// kSplits runs, each of pps to max_pps pages (kernels/paged_attention.py:
// int4_split); a function of the slot's own kv_len and the shapes
__device__ __forceinline__ int split_pages(int len, int ps, int pps,
                                           int max_pps) {
  if (len <= kSplits * pps * ps) return pps;  // no division for short slots
  const int per = ((len + ps - 1) / ps + kSplits - 1) / kSplits;
  return per < pps ? pps : (per > max_pps ? max_pps : per);
}

// the inclusive prefix sum of x over a warp's lanes
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

template <typename Tq, int HD, int GQ>
__global__ void __launch_bounds__(kThreads) paged_int4_kernel(
    const Tq* __restrict__ q, const uint8_t* __restrict__ kp,
    const float* __restrict__ ks, const float* __restrict__ kz,
    const uint8_t* __restrict__ vp, const float* __restrict__ vs,
    const float* __restrict__ vz, const int* __restrict__ page_table,
    const int* __restrict__ kv_len, Tq* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counters, int B, int Hkv,
    int gq, int W, int R, int g, int ps, int pps, int max_pps, int n_split,
    int n_rb, float sm_scale) {
  using Gm = Geo<HD, GQ>;
  constexpr int EPC = Gm::EPC, LPT = Gm::LPT, TPW = Gm::TPW, G = Gm::G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % LPT;                   // chunk of the head
  const bool lane_on = c < Gm::NLA;           // holds elements of a head
  const int grp = warp * TPW + lane / LPT;    // token group
  const int max_len = W * ps;
  // the live items: slot b's are [first(b), first(b) + n(b)), n(b) its live
  // splits x Hkv x n_rb, and len(b) its kv_len clamped to [0, W*ps]. Up to
  // 32 slots every warp lists them in registers, lane b holding slot b
  // (n_l, its inclusive prefix sum incl, len_l); past 32 the CTA scans them
  // into shared memory, kThreads slots at a time (s_first[b] = first(b),
  // s_first[B] = the total, s_len). The registers spare a launch over a
  // few slots the scan's barriers and shared round trips: ~0.7 of ~10 us
  // in the kernel table's 4-slot rows.
  const bool few = B <= 32;
  auto live = [&](int len) {
    const int sl = split_pages(len, ps, pps, max_pps) * ps;
    return (len + sl - 1) / sl * Hkv * n_rb;
  };
  extern __shared__ int s_first[];            // B + 1, then s_len: B
  int* s_len = s_first + B + 1;
  __shared__ int s_wsum[kWarps];
  int len_l = 0, n_l = 0, incl = 0, total;
  unsigned empty = 0;                         // few: the slots at kv_len 0
  if (few) {
    len_l = lane < B ? min(max(kv_len[lane], 0), max_len) : 0;
    n_l = live(len_l);
    incl = warp_scan(n_l, lane);
    total = __shfl_sync(0xffffffffu, incl, 31);
    empty = __ballot_sync(0xffffffffu, lane < B && n_l == 0);
  } else {
    if (tid == 0) s_first[0] = 0;             // seen after the barriers
    int carry = 0;
    for (int base = 0; base < B; base += kThreads) {
      const int b = base + tid;
      const int len = b < B ? min(max(kv_len[b], 0), max_len) : 0;
      const int x = warp_scan(live(len), lane);
      if (lane == 31) s_wsum[warp] = x;
      __syncthreads();
      int before = carry;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += s_wsum[w];
        carry += s_wsum[w];
      }
      if (b < B) s_first[b + 1] = before + x, s_len[b] = len;
      __syncthreads();                        // s_wsum is read
    }
    total = s_first[B];
  }

  // slots with no item (kv_len 0) get zero rows, 16 bytes a store
  const int per_slot = Hkv * gq * HD * (int)sizeof(Tq) / 16;
  uint4* o = reinterpret_cast<uint4*>(out);
  for (int i = blockIdx.x * kThreads + tid; i < B * per_slot;
       i += gridDim.x * kThreads) {
    const int b = i / per_slot;
    if (few ? (empty >> b & 1u) != 0 : s_first[b + 1] == s_first[b])
      o[i] = make_uint4(0, 0, 0, 0);
  }

  __shared__ int s_page[kMaxSplitPages];
  __shared__ float s_m[G][GQ], s_l[G][GQ];
  // accumulators by (row, element, thread): a warp's stores hit 32
  // consecutive words, and the column sums read them with a stride of
  // kThreads + 1 words, so neither side has bank conflicts
  __shared__ float s_acc[GQ * EPC][kThreads + 1];
  __shared__ float s_M[GQ], s_L[GQ];
  __shared__ int s_last;

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    // its slot b: the last with first(b) <= item (that slot owns items)
    int b = 0, first, len;
    if (few) {
      b = __popc(__ballot_sync(0xffffffffu, incl <= item));
      first = __shfl_sync(0xffffffffu, incl - n_l, b);
      len = __shfl_sync(0xffffffffu, len_l, b);
    } else {
      for (int hi = B; hi - b > 1;) {
        const int mid = (b + hi) >> 1;
        if (s_first[mid] <= item) b = mid; else hi = mid;
      }
      first = s_first[b], len = s_len[b];
    }
    // within the slot: (split, head, row block), so the items of one
    // split run together and read its pages once from memory
    const int k = item - first;
    const int rb = k % n_rb, h = (k / n_rb) % Hkv, split = k / (n_rb * Hkv);
    const int spp = split_pages(len, ps, pps, max_pps);
    const int split_len = spp * ps;
    const int n_active = (len + split_len - 1) / split_len;
    const int bh = b * Hkv + h;
    const int t0 = split * split_len;
    const int t_end = min(len, t0 + split_len);

    // the previous item read s_page in its token loop and the merge arrays
    // before the barrier below, which this item passes before writing them
    for (int i = tid; i < spp; i += kThreads) {
      const int pi = split * spp + i;
      int page = pi < W ? page_table[(size_t)b * W + pi] : 0;
      s_page[i] = page < 0 ? 0 : page;
    }
    float qf[GQ][EPC];
#pragma unroll
    for (int j = 0; j < GQ; ++j) {
      const int row = rb * GQ + j;
      const Tq* qr =
          q + ((size_t)bh * gq + (row < gq ? row : 0)) * HD + c * EPC;
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        qf[j][e] = row < gq && lane_on ? to_f(qr[e]) : 0.0f;
    }
    __syncthreads();

    float m[GQ], l[GQ], acc[GQ][EPC];
#pragma unroll
    for (int j = 0; j < GQ; ++j) {
      m[j] = kNegInf;
      l[j] = 0.0f;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[j][e] = 0.0f;
    }
    const int ppr = R / ps;
    const int f = h * HD + c * EPC;             // flat index of the chunk
    const int rrow = f / g;                     // its row within a token
    const size_t boff = (size_t)((f % g) / 2);  // and byte within the row
    const size_t g2 = (size_t)(g / 2);

    // the trip count is the same for every thread (tokens past t_end are
    // masked, not branched around), so the shuffles never see a diverged
    // warp
    for (int base = t0; base < t_end; base += kU * G) {
      Packed<EPC> kb[kU], vb[kU];
      float ksc[kU], kzp[kU], vsc[kU], vzp[kU];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = base + u * G + grp;
        ok[u] = t < t_end;
        if (ok[u] && lane_on) {
          const int tl = t - t0;
          const size_t row = (size_t)s_page[tl / ps] * R + (tl % ps) * ppr +
                             rrow;
          kb[u].load(kp + row * g2 + boff);
          vb[u].load(vp + row * g2 + boff);
          ksc[u] = ks[row], kzp[u] = kz[row];
          vsc[u] = vs[row], vzp[u] = vz[row];
        } else {
          kb[u].zero(), vb[u].zero();
          ksc[u] = kzp[u] = vsc[u] = vzp[u] = 0.0f;
        }
      }
      float s[kU][GQ];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float kf[EPC];
#pragma unroll
        for (int e = 0; e < EPC; ++e) kf[e] = kb[u].deq(e, ksc[u], kzp[u]);
#pragma unroll
        for (int j = 0; j < GQ; ++j) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < EPC; ++e) d += qf[j][e] * kf[e];
#pragma unroll
          for (int off = LPT / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          s[u][j] = ok[u] ? d * sm_scale : kNegInf;
        }
      }
#pragma unroll
      for (int j = 0; j < GQ; ++j) {
        float m_new = m[j];
#pragma unroll
        for (int u = 0; u < kU; ++u) m_new = fmaxf(m_new, s[u][j]);
        const float corr = expf(m[j] - m_new);
        l[j] *= corr;
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[j][e] *= corr;
        m[j] = m_new;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float vf[EPC];
#pragma unroll
        for (int e = 0; e < EPC; ++e) vf[e] = vb[u].deq(e, vsc[u], vzp[u]);
#pragma unroll
        for (int j = 0; j < GQ; ++j) {
          const float p = ok[u] ? expf(s[u][j] - m[j]) : 0.0f;
          l[j] += p;
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[j][e] += p * vf[e];
        }
      }
    }

    // merge the token groups: warp j finds row j's max and each group's
    // weight, then one thread per (row, column) sums the weighted columns
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < GQ; ++j) s_m[grp][j] = m[j], s_l[grp][j] = l[j];
    }
#pragma unroll
    for (int j = 0; j < GQ; ++j)
#pragma unroll
      for (int e = 0; e < EPC; ++e) s_acc[j * EPC + e][tid] = acc[j][e];
    __syncthreads();
    if (warp < GQ) {
      const int j = warp;
      float mx = kNegInf;
      for (int i = lane; i < G; i += 32) mx = fmaxf(mx, s_m[i][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int i = lane; i < G; i += 32) {
        const float w = expf(s_m[i][j] - mx);
        s_m[i][j] = w;  // the group's weight from here on
        sum += s_l[i][j] * w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) s_M[j] = mx, s_L[j] = sum;
    }
    __syncthreads();

    // row j's weighted column d = c*EPC + e: group gi's part is at thread
    // gi*LPT + c
    auto column = [&](int j, int d) {
      const float* a = s_acc[j * EPC + d % EPC] + d / EPC;
      float o = 0.0f;
      for (int gi = 0; gi < G; ++gi) o += a[gi * LPT] * s_m[gi][j];
      return o;
    };
    const size_t prow0 = (size_t)bh * n_rb * GQ + rb * GQ;  // partial rows
    const int stride = HD + 2;                              // (m, l, acc)
    if (n_active == 1) {
      for (int i = tid; i < GQ * HD; i += kThreads) {
        const int j = i / HD, d = i % HD, row = rb * GQ + j;
        if (row >= gq) continue;
        from_f(&out[((size_t)bh * gq + row) * HD + d],
               column(j, d) / fmaxf(s_L[j], 1e-30f));
      }
      continue;
    }
    for (int i = tid; i < GQ * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const float o = column(j, d);
      float* pr = part + ((prow0 + j) * n_split + split) * stride;
      pr[2 + d] = o;
      if (d == 0) pr[0] = s_M[j], pr[1] = s_L[j];
    }
    __threadfence();  // partial state visible before the count
    __syncthreads();
    int* counter = counters + (size_t)bh * n_rb + rb;
    if (tid == 0) s_last = atomicAdd(counter, 1) == n_active - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    if (tid == 0) *counter = 0;  // ready for the next launch
    for (int i = tid; i < GQ * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, row = rb * GQ + j;
      if (row >= gq) continue;
      const float* pr = part + (prow0 + j) * n_split * stride;
      // one pass over the splits, rescaling as the max grows: the loads of
      // several splits are in flight together (L2, past the L1)
      float mx = kNegInf, sum = 0.0f, o = 0.0f;
#pragma unroll 4
      for (int sp = 0; sp < n_active; ++sp) {
        const float m_s = __ldcg(pr + sp * stride);
        const float l_s = __ldcg(pr + sp * stride + 1);
        const float o_s = __ldcg(pr + sp * stride + 2 + d);
        const float m_new = fmaxf(mx, m_s);
        const float a = expf(mx - m_new), w = expf(m_s - m_new);
        sum = sum * a + l_s * w;
        o = o * a + o_s * w;
        mx = m_new;
      }
      from_f(&out[((size_t)bh * gq + row) * HD + d], o / fmaxf(sum, 1e-30f));
    }
  }
}

size_t smem_bytes(int B) { return (size_t)(2 * B + 1) * sizeof(int); }

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// f(Type<Tq>{}, Int<HD>{}, Int<GQ>{}) for the kernel instantiation of q's
// type, the head dim and the query rows a CTA keeps (1 or 4)
template <typename F>
cudaError_t with_kernel(int q_is_bf16, int hd, int rows, F f) {
  auto by_hd = [&](auto tq, auto gq) -> cudaError_t {
    switch (hd) {
      case 16: return f(tq, Int<16>{}, gq);
      case 32: return f(tq, Int<32>{}, gq);
      case 64: return f(tq, Int<64>{}, gq);
      case 80: return f(tq, Int<80>{}, gq);
      case 128: return f(tq, Int<128>{}, gq);
      case 256: return f(tq, Int<256>{}, gq);
      default: return cudaErrorInvalidValue;
    }
  };
  auto by_rows = [&](auto tq) {
    return rows == 1 ? by_hd(tq, Int<1>{}) : by_hd(tq, Int<4>{});
  };
  return q_is_bf16 ? by_rows(Type<__nv_bfloat16>{}) : by_rows(Type<float>{});
}

}  // namespace

// The kernel's residency: the card's SMs (read once) and the CTAs of one
// instantiation an SM holds at once with B slots' work list in shared
// memory. The wrapper sizes the grid from them (launch_shape).
extern "C" int paged_attention_int4_occupancy(int q_is_bf16, int hd,
                                              int rows, int B, int* sms,
                                              int* per_sm) {
  static const int n_sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  *sms = n_sms;
  if (B <= 0 || (rows != 1 && rows != 4)) return (int)cudaErrorInvalidValue;
  return (int)with_kernel(
      q_is_bf16, hd, rows, [&](auto tq, auto hd_c, auto gq_c) {
        using Tq = typename decltype(tq)::type;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm,
            paged_int4_kernel<Tq, decltype(hd_c)::value,
                              decltype(gq_c)::value>,
            kThreads, smem_bytes(B));
      });
}

// rows: query rows per CTA, 1 or 4 (paged_attention.py: rows_per_cta);
// pps/n_split: split_plan's pages a split and splits; ctas: the grid
// (launch_shape); part: (B*Hkv*ceil(gq/rows)*rows, n_split, hd + 2) f32
// scratch; counters: B*Hkv*ceil(gq/rows) i32, all 0 between launches (each
// launch leaves them at 0); out 16-byte aligned.
extern "C" int paged_attention_int4_launch(
    const void* q, int q_is_bf16, const void* kp, const void* ks,
    const void* kz, const void* vp, const void* vs, const void* vz,
    const void* page_table, const void* kv_len, void* out, void* part,
    void* counters, int B, int Hkv, int gq, int hd, int W, int R, int g,
    int ps, int pps, int n_split, int rows, int ctas, float sm_scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || gq <= 0) return (int)cudaGetLastError();
  // int4_split's longest split
  const int max_pps = ps > 0 && kMaxSplitTokens / ps > pps
                          ? kMaxSplitTokens / ps : pps;
  if (ps <= 0 || R % ps != 0 || W <= 0 || pps <= 0 ||
      max_pps > kMaxSplitPages || n_split != (W + pps - 1) / pps ||
      (rows != 1 && rows != 4) || ctas <= 0 || (uintptr_t)out % 16 != 0 ||
      (long long)B * Hkv * gq * hd >= (1ll << 27))  // int offsets of out
    return (int)cudaErrorInvalidValue;
  return (int)with_kernel(
      q_is_bf16, hd, rows, [&](auto tq, auto hd_c, auto gq_c) {
        using Tq = typename decltype(tq)::type;
        constexpr int HD = decltype(hd_c)::value, GQ = decltype(gq_c)::value;
        constexpr int EPC = Geo<HD, GQ>::EPC;
        // a lane's chunk must stay inside one group row and be a whole
        // vector
        if (g % EPC != 0 || ((uintptr_t)kp | (uintptr_t)vp) % (EPC / 2) != 0)
          return cudaErrorInvalidValue;
        paged_int4_kernel<Tq, HD, GQ>
            <<<ctas, kThreads, smem_bytes(B), (cudaStream_t)stream>>>(
                (const Tq*)q, (const uint8_t*)kp, (const float*)ks,
                (const float*)kz, (const uint8_t*)vp, (const float*)vs,
                (const float*)vz, (const int*)page_table,
                (const int*)kv_len, (Tq*)out, (float*)part, (int*)counters,
                B, Hkv, gq, W, R, g, ps, pps, max_pps, n_split,
                (gq + GQ - 1) / GQ, sm_scale);
        return cudaGetLastError();
      });
}
