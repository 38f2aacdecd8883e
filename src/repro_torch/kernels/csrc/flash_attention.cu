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
// contract. A logit softcap c > 0 replaces each scaled score s by
// c * tanh(s / c) before the mask (the reference's attention_ref): a
// compile-time variant of each body (CAP), so c = 0 runs the uncapped
// instantiations, bit for bit the kernel without the option. Both bodies
// walk the same two segments: the prefix tiles below
// prefix_len[b], then the aligned tiles from the window's left edge to the
// causal diagonal, so wholly masked tiles are never loaded; masked
// probabilities are exactly 0, so a row whose first tiles are all masked
// (the window, a dummy row with prefix_len 0) carries nothing into its sum.
//
// Bound on the H100: at the prefill bucket (B=4, S=256, 52 heads, hd 128,
// bf16, causal) the kernel must move 54.5 MB (q, k, v, out once: 16.3 us
// at 3.35 TB/s) and do 3.49 GFLOP of causal products (3.5 us at the bf16
// tensor cores' 989 TFLOP/s), so its bound is bytes. What kept the first
// kernel (379 us there on an H100 80GB HBM3 at 700 W, chip_smoke.py) far
// from it was latency, not arithmetic: every element converted to f32 in
// shared memory, scalar FMAs off shared memory, and each K/V tile loaded
// synchronously between two barriers.
//
// The dtype picks the body inside the one entry point:
//
// * bf16 (the model's prefill): a FlashAttention-2 forward on the tensor
//   cores. One CTA of 4 warps owns 64 query rows (16 per warp) of one
//   (batch row, q head); q tiles run heaviest first (the grid's slowest
//   axis, reversed), so the causal diagonal's long tiles do not straggle.
//   Q is loaded once, straight into its A fragments, which stay in
//   registers. K and V tiles of 64 keys, in bf16, go through a 2-stage
//   ring in shared memory filled by 16-byte cp.async (rows past the
//   segment's end zero-filled), so the next tile's load overlaps this
//   tile's math; rows are padded by 16 bytes, which makes every ldmatrix
//   conflict-free. 70 KB of shared memory at hd 128: 3 CTAs per SM.
//   S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 in, f32
//   accumulate); V's B fragments come from ldmatrix.trans. The online
//   softmax runs in registers in the log2 domain: a row's max is two quad
//   shuffles, its sum stays per thread until the end. P is rounded to
//   bf16 in registers and fed straight back as the A fragment of P V (the
//   plain version also rounds probabilities to bf16 before P V).
//   Head dims 16, 32, 64, 80, 120, 128 and 256 (tc::Tile): hd 120 pads
//   the Q K^T contraction to 128 with zero columns (P V has 15 column
//   blocks, the last one loaded by ldmatrix .x2); hd 256 takes 32-key
//   tiles and keeps Q in shared memory (99 KB: 2 CTAs per SM).
// * f32 (the reduced float32 model): the first kernel's FMA body,
//   unchanged, so its rounding (and the reduced model's tokens on the
//   card) stay as they were. One CTA of 128 threads owns 64 query rows;
//   Q (f32) stays in shared memory and each 32-key tile's K and V are
//   staged there. Thread (ty, tx), ty = tid / 8, tx = tid % 8, owns query
//   rows 4*ty .. 4*ty+3, key columns tx + 8*c of a tile and hd/8 output
//   columns; row max and row sum are three xor-shuffles among the 8 lanes
//   of a row group, and the probabilities pass between them through shared
//   memory with only a warp barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the plain version's mask value

// Operands of one launch, as the entry point receives them.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* prefix_len;
  void* out;
  int B, Sq, Sk, H, Hkv, P, causal, window;
  float sm_scale;
  float softcap;  // > 0: scores capped (the CAP instantiations)
};

// The key segments of one q tile (rows q0 .. q0+bq-1) in tiles of bk keys:
// tiles [0, n_pre) walk the padded prefix below plen, the rest the aligned
// keys [P + lo, P + hi), from the window's left edge to the diagonal.
struct Segments {
  int plen, lo, hi, n_pre, n_tiles;
  __device__ Segments(const int* prefix_len, int P, int Sk, int causal,
                      int window, int b, int q0, int bq, int bk) {
    plen = prefix_len ? prefix_len[b] : 0;
    plen = plen < 0 ? 0 : (plen > P ? P : plen);
    const int n_al = Sk - P;  // aligned keys
    hi = causal ? min(n_al, q0 + bq) : n_al;
    lo = window > 0 ? max(0, q0 - window + 1) : 0;
    n_pre = (plen + bk - 1) / bk;
    n_tiles = n_pre + (hi > lo ? (hi - lo + bk - 1) / bk : 0);
  }
  // first key row of tile t, and the end of its segment
  __device__ int k0(int t, int P, int bk) const {
    return t < n_pre ? t * bk : P + lo + (t - n_pre) * bk;
  }
  __device__ int kend(int t, int P) const {
    return t < n_pre ? plen : P + hi;
  }
};

// ---- f32: the first kernel's FMA body ---------------------------------------

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 32;            // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = kBQ / (kThreads / 8);  // 4 rows per thread
constexpr int kCols = kBK / 8;               // 4 key columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }

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
struct Vec<1> {
  using type = float;
  __device__ static float get(const float& v, int) { return v; }
};
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

template <int HD, typename T, bool CAP>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ prefix_len,
    T* __restrict__ out, int Sq, int Sk, int H, int Hkv, int P, int causal,
    int window, float sm_scale, float softcap) {
  constexpr int QS = HD + kPad;
  constexpr int kOut = HD / 8;            // output columns per thread
  // ... read VW at a time (the widest vector that divides kOut)
  constexpr int VW = HD >= 32 && kOut % 4 == 0 ? 4 : kOut % 2 == 0 ? 2 : 1;
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

  const Segments seg(prefix_len, P, Sk, causal, window, b, q0, kBQ, kBK);
  __syncthreads();

  for (int t = 0; t < seg.n_tiles; ++t) {
    const bool pre = t < seg.n_pre;
    // key rows [k0, kend) of this segment; tile columns past kend are 0
    const int k0 = seg.k0(t, P, kBK);
    const int kend = seg.kend(t, P);
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
        float x = s[r][c] * sm_scale;
        if constexpr (CAP) x = softcap * tanhf(x / softcap);
        s[r][c] = vis[c] ? x : kNegInf;
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

template <int HD>
struct F32Body {
  template <bool CAP>
  static cudaError_t run(const Args& a, cudaStream_t st) {
    auto kern = flash_f32_kernel<HD, float, CAP>;
    constexpr size_t smem = smem_bytes<HD>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
    kern<<<grid, kThreads, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        a.prefix_len, (float*)a.out, a.Sq, a.Sk, a.H, a.Hkv, a.P, a.causal,
        a.window, a.sm_scale, a.softcap);
    return cudaGetLastError();
  }
};

// ---- bf16: FlashAttention-2 forward on the tensor cores ----------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;      // query rows per CTA, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;   // K/V ring depth

// Tiling by head dim.
// * HDP: the Q K^T contraction, hd rounded up to mma's depth of 16 (hd
//   120 -> 128). The columns past hd are zeros: Q's fragments read 0
//   there, and the K tile's last 16-byte chunk of a row is zero-filled by
//   cp.async, so they add nothing to S. P V reads only the hd columns.
// * S: shared rows of HDP bf16 padded by 8 (16 bytes), past those zero
//   columns: cp.async destinations stay 16-byte aligned, and S / 8 is odd
//   for every head dim, so the 8 rows an ldmatrix phase reads fall on 8
//   distinct 4-bank groups.
// * BK: keys per tile, 64; 32 at hd 256, where a 64-key K/V ring would
//   take 135 KB (one CTA an SM) and S's accumulators with O's 128 would
//   crowd the registers.
// * QS: Q's A fragments live in registers (KD x 4 a thread) up to hd
//   128; at hd 256 (64 registers) they are staged once in shared memory
//   and read with ldmatrix at every key tile instead, which leaves the
//   registers to O's 128 accumulators.
template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 15) / 16 * 16;
  static constexpr int S = HDP + 8;
  static constexpr int BK = HD > 128 ? 32 : 64;
  static constexpr bool QS = HD > 128;
  static_assert(HD % 8 == 0 && (S / 8) % 2 == 1, "head dim off the grid");
};

template <int HD>
constexpr size_t smem_bytes() {  // kStages K tiles, kStages V tiles, [Q]
  using T = Tile<HD>;
  return sizeof(bf16) *
         (size_t)(2 * kStages * T::BK + (T::QS ? kBQ : 0)) * T::S;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of one head of a (rows, row_stride) bf16 matrix
// into a padded shared tile of HDP columns; rows at or past rend, and the
// columns past hd, are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          size_t row_stride, int r0,
                                          int rend, int tid) {
  constexpr int kChunks = Tile<HD>::HDP / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = r0 + r < rend && (kChunks == HD / 8 || c < HD / 8);
    const bf16* g = src + (size_t)(valid ? r0 + r : 0) * row_stride + c * 8;
    cp_async16(smem_addr(tile + r * Tile<HD>::S + c * 8), g, valid);
  }
}

// CAP: s = softcap * tanh(s * sm_scale / softcap), then into the log2
// domain (cap_log2 = softcap * log2 e); else s * scale_log2 alone
template <int HD, bool CAP>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ prefix_len,
                      bf16* __restrict__ out, int Sq, int Sk, int H, int Hkv,
                      int P, int causal, int window, float scale_log2,
                      float sm_scale, float softcap, float cap_log2) {
  using T = Tile<HD>;
  constexpr int S = T::S, BK = T::BK;
  constexpr int KD = T::HDP / 16;  // k steps of Q K^T
  constexpr int ND = HD / 8;       // 8-wide column blocks of O
  constexpr int NK = BK / 8;       // 8-key column blocks of S
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint4 smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kStages tiles
  bf16* sV = sK + kStages * BK * S;              // kStages tiles
  bf16* sQ = sV + kStages * BK * S;              // QS: kBQ rows of Q

  const Segments seg(prefix_len, P, Sk, causal, window, b, q0, kBQ, BK);
  const size_t kv_stride = (size_t)Hkv * HD;
  const bf16* kb = k + (size_t)b * Sk * kv_stride + (size_t)hk * HD;
  const bf16* vb = v + (size_t)b * Sk * kv_stride + (size_t)hk * HD;
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    const int k0 = seg.k0(t, P, BK), kend = seg.kend(t, P);
    load_tile<HD, BK>(sK + st * BK * S, kb, kv_stride, k0, kend, tid);
    load_tile<HD, BK>(sV + st * BK * S, vb, kv_stride, k0, kend, tid);
  };

  // group s: tile s (groups are committed even when empty, so "all but
  // the newest kStages-1 groups" is tile t); QS: group 0 also holds Q
  if constexpr (T::QS)
    load_tile<HD, kBQ>(sQ, q + ((size_t)b * Sq * H + h) * HD,
                       (size_t)H * HD, q0, Sq, tid);
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < seg.n_tiles) load_kv(t);
    cp_async_commit();
  }

  // thread (lane) holds rows r_lo = lane/4 and r_lo + 8 of its warp's 16,
  // and columns 2*(lane%4) + {0, 1} of every 8-wide block. Up to hd 128
  // Q's A fragments come straight from global memory (rows past Sq and
  // columns past hd are 0): read once, they need no shared tile, which
  // leaves room for 3 CTAs per SM at hd 128
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  uint32_t qf[T::QS ? 1 : KD][4];
  if constexpr (!T::QS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r_lo + (i & 1) * 8;
        const int col = kk * 16 + (i >> 1) * 8 + (lane & 3) * 2;
        qf[kk][i] = row < Sq && (T::HDP == HD || col < HD)
                        ? *reinterpret_cast<const uint32_t*>(
                              q + (((size_t)b * Sq + row) * H + h) * HD +
                              col)
                        : 0u;
      }
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < seg.n_tiles; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* cK = sK + (t % kStages) * BK * S;
    const bf16* cV = sV + (t % kStages) * BK * S;

    // S = Q K^T: B fragments of two 8-key blocks per ldmatrix
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (T::QS) {
        ldmatrix_x4(qa, smem_addr(sQ + (warp * 16 + (lane & 15)) * S +
                                  kk * 16 + (lane >> 4) * 8));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(cK + (np * 16 + (lane & 7) +
                                       (lane >> 4) * 8) * S +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma(s[2 * np], qa, r[0], r[1]);
        mma(s[2 * np + 1], qa, r[2], r[3]);
      }
    }

    // scale into the log2 domain and mask; a tile every row of this CTA
    // sees in full skips the per-element test
    const bool pre = t < seg.n_pre;
    const int k0 = seg.k0(t, P, BK), kend = seg.kend(t, P);
    const bool full =
        k0 + BK <= kend &&
        (pre || ((!causal || k0 + BK - 1 - P <= q0) &&
                 (window <= 0 || k0 - P > q0 + kBQ - 1 - window)));
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if constexpr (CAP)
          x = cap_log2 * tanhf(s[n][e] * sm_scale / softcap);
        else
          x = s[n][e] * scale_log2;
        if (!full) {
          const int i = r_lo + (e >> 1) * 8;  // query row
          const int j = k0 + n * 8 + (lane & 3) * 2 + (e & 1);  // key row
          bool vis = j < kend;
          if (!pre) {
            const int ja = j - P;
            vis = vis && (!causal || ja <= i) &&
                  (window <= 0 || ja > i - window);
          }
          x = vis ? x : kNegInf;
        }
        s[n][e] = x;
      }

    // online softmax, rows r_lo (e = 0, 1) and r_lo + 8 (e = 2, 3)
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hf], s[n][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[hf] = exp2f(m[hf] - mx);
      m[hf] = mx;
      l[hf] *= corr[hf];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float p =
            s[n][e] == kNegInf ? 0.0f : exp2f(s[n][e] - m[hf]);
        l[hf] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P (bf16) is the A fragment straight from S's accumulator
    // layout; V's B fragments of two 8-wide column blocks per
    // ldmatrix.trans (an odd last block, hd 120's 15th, through .x2)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(cV + (kk * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * S +
                                       np * 16 + (lane >> 4) * 8));
        mma(o[2 * np], a, r[0], r[1]);
        mma(o[2 * np + 1], a, r[2], r[3]);
      }
      if constexpr (ND % 2 == 1) {
        uint32_t r[2];
        ldmatrix_x2_trans(r, smem_addr(cV + (kk * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * S +
                                       (ND - 1) * 8));
        mma(o[ND - 1], a, r[0], r[1]);
      }
    }

    __syncthreads();  // every warp is done with stage t % kStages
    if (t + kStages < seg.n_tiles) load_kv(t + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    const int i = r_lo + hf * 8;
    if (i >= Sq) continue;
    bf16* orow = out + (((size_t)b * Sq + i) * H + h) * HD + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * hf] * inv, o[n][2 * hf + 1] * inv);
  }
}

}  // namespace tc

template <int HD>
struct Bf16Body {
  template <bool CAP>
  static cudaError_t run(const Args& a, cudaStream_t st) {
    auto kern = tc::flash_bf16_kernel<HD, CAP>;
    constexpr size_t smem = tc::smem_bytes<HD>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    // q tiles on the slowest axis, walked in reverse by the kernel
    dim3 grid(a.H, a.B, (a.Sq + tc::kBQ - 1) / tc::kBQ);
    kern<<<grid, tc::kThreads, smem, st>>>(
        (const tc::bf16*)a.q, (const tc::bf16*)a.k, (const tc::bf16*)a.v,
        a.prefix_len, (tc::bf16*)a.out, a.Sq, a.Sk, a.H, a.Hkv, a.P,
        a.causal, a.window, a.sm_scale * 1.4426950408889634f, a.sm_scale,
        a.softcap, a.softcap * 1.4426950408889634f);
    return cudaGetLastError();
  }
};

// a softcap picks the CAP instantiation, so the common path carries no tanh
template <template <int> class Body, int HD>
cudaError_t launch_cap(const Args& a, cudaStream_t st) {
  return a.softcap > 0.0f ? Body<HD>::template run<true>(a, st)
                          : Body<HD>::template run<false>(a, st);
}

template <template <int> class Body>
cudaError_t launch_hd(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_cap<Body, 16>(a, st);
    case 32:
      return launch_cap<Body, 32>(a, st);
    case 64:
      return launch_cap<Body, 64>(a, st);
    case 80:
      return launch_cap<Body, 80>(a, st);
    case 120:
      return launch_cap<Body, 120>(a, st);
    case 128:
      return launch_cap<Body, 128>(a, st);
    case 256:
      return launch_cap<Body, 256>(a, st);
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
                                      float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || P < 0 || P > Sk || softcap < 0.0f)
    return (int)cudaErrorInvalidValue;
  const Args a{q,      k,      v,        (const int*)prefix_len,
               out,    B,      Sq,       Sk,
               H,      Hkv,    P,        causal,
               window, sm_scale, softcap};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_hd<Bf16Body>(hd, a, st)
                       : launch_hd<F32Body>(hd, a, st));
}
