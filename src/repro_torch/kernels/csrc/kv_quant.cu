// Group-wise int4 KV quantization and dequantization for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/kv_quant.py:
//   kv_quant   (_quant_kernel)   x (N, G) -> packed (N, G/2) u8, scale (N, 1)
//                                f32, zero (N, 1) f32; per-row min/max affine
//                                int4, two nibbles per byte, low nibble first
//   kv_dequant (_dequant_kernel) packed + scale + zero -> (N, G) bf16 or f32
// and adds the paged decode step's append in one launch:
//   kv_quant_append              this step's K and V (B, 1, Hkv, hd) of B
//                                slots, read through their strides,
//                                quantized as kv_quant and written into each
//                                slot's tail page (the reference quantizes
//                                with kv_quant_ref and scatters with six
//                                .at[].set in src/repro/models/paged.py)
//
// Bound on the H100: memory, with arithmetic close behind. kv_quant reads
// N*G*sizeof(x) bytes and writes N*G/2 + 8N; kv_dequant reads N*G/2 + 8N and
// writes N*G*sizeof(out). Each does a handful of operations per byte, far
// below the ~295 FLOP/byte the card needs before compute limits it, but
// kv_quant's true division per element is a dozen instructions (one of them
// on the quarter-rate MUFU pipe), as long as the memory time at the prefill
// bucket: so loads have to stay in flight while the divisions run.
//
// Design. Each kernel has a vector body, picked by the wrapper from the
// shape and the alignment, and a scalar body for everything else:
//
// * kv_quant, vector body (G % 8 == 0, G <= 256, a 16-byte aligned x): a
//   row gets G/8 lanes (rounded up to a power of two, LPR), each lane one
//   16-byte load of 8 bf16 (two for f32) kept in registers, so x is read
//   once. Min/max go through xor shuffles inside the lane group (exact in
//   any order); each lane packs its 8 nibbles into one 32-bit store, so a
//   row's G/2 bytes go out coalesced; the scale and zero of a warp's rows
//   are gathered into consecutive lanes and stored coalesced. Grid-stride
//   over the card's resident blocks; each lane takes U rows a step and
//   issues all U loads before the first division. The quotient comes from
//   the row's reciprocal, with the true division wherever the product lies
//   within 2^-17 of a half-integer (nibble_fast: bit-exact, see there); a
//   true division for every element took 0.35 ms at the prefill bucket on
//   an H100, against 0.26-0.27 ms this way.
// * kv_quant_append: the same body with U = 1 (a decode step is ~400 rows:
//   latency, not bandwidth), rows addressed through the step's strides and
//   written to row tail_off * ppr + r of page page_table[b, min(len_b / ps,
//   W - 1)] (clamped at 0, the trash page, where inactive slots' writes
//   race as they do in the plain version). Nothing is read on the host, so
//   the launch replays in a CUDA graph with other lengths.
// * kv_quant, scalar body: one warp per row, two passes, byte pairs.
// * kv_dequant, vector body (G % 8 == 0, G <= 1024, a 4-byte aligned
//   packed): a thread takes the packed bytes of 16 output bytes (4 for
//   bf16, 2 for f32) of one row, its scale and zero once, and writes them
//   with one 16-byte store, so a warp stores 512 contiguous bytes (8 bytes
//   a thread and two 16-byte stores at a 32-byte stride took 0.30 ms at the
//   prefill bucket on an H100, this layout 0.19); a thread's row and column
//   come from threadIdx once, outside the grid-stride loop.
// * kv_dequant, scalar body: one packed byte a thread.
// Nothing is reused, so nothing is staged in shared memory.
//
// Bit-exactness with the plain PyTorch version (kernels/ref.py) is the
// contract: the wire, the pages and the decode append must produce the same
// bytes whichever path quantized a token. So the arithmetic is spelled with
// round-to-nearest intrinsics that the compiler may not contract or
// approximate: __fsub_rn / __fdiv_rn (true IEEE division, no reciprocal
// multiply, except where provably the same, nibble_fast), rintf (round
// half to even, like torch.round), and
// __fmul_rn + __fadd_rn for dequantization (an FMA would round once where
// PyTorch rounds twice). Integers 0..15 move between float and int through
// the exponent of 2^23 (exact), which keeps the conversion pipe for rintf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr float kTwo23 = 8388608.0f;

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// 8 consecutive values from a 16-byte aligned address
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {            // bf16 is the top half of an f32
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// rint((x - mn) / s) clamped to [0, 15], as kv_quant_ref; returned as an
// unsigned through 2^23's exponent (the value is an exact integer)
__device__ __forceinline__ unsigned nibble(float x, float mn, float s) {
  const float q =
      fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(x, mn), s)), 0.0f), 15.0f);
  return __float_as_uint(__fadd_rn(q, kTwo23)) & 0xFu;
}

// The same nibble from the row's reciprocal r = 1/s (rounded): only rint of
// the quotient is kept, so the true division is needed only where the
// approximate quotient qa = (x - mn) * r lies near a half-integer. With
// u = 2^-24, q = (x - mn)/s <= 15 (1 + u): |qa - q| <= 16 * 2u = 2^-19 and
// the rounded true quotient Q has |Q - q| <= 16u = 2^-20, so |qa - Q| <
// 2^-18. Where qa is at least 2^-17 away from every half-integer, Q lies on
// the same side of each of them, and rint(Q) = rint(qa). Elsewhere, and for
// a NaN qa (an infinite or NaN row), the true quotient decides.
__device__ __forceinline__ unsigned nibble_fast(float x, float mn, float s,
                                                float r) {
  const float d = __fsub_rn(x, mn);
  const float qa = __fmul_rn(d, r);
  float t = rintf(qa);
  // |qa - t| <= 0.5 is exact (Sterbenz); 0.5 - 2^-17 is representable
  if (!(fabsf(__fsub_rn(qa, t)) <= 0.5f - 7.62939453125e-06f))
    t = rintf(__fdiv_rn(d, s));
  const float q = fminf(fmaxf(t, 0.0f), 15.0f);
  return __float_as_uint(__fadd_rn(q, kTwo23)) & 0xFu;
}

// the nibble n as a float, exactly
__device__ __forceinline__ float nibble_f(unsigned n) {
  return __fsub_rn(__uint_as_float(0x4B000000u | n), kTwo23);
}

// ---------------------------------------------------------------------------
// kv_quant: vector body and the decode append

struct Dst {            // where a row's packed bytes, scale and zero go
  uint8_t* p;
  float* s;
  float* z;
};

template <typename T>
struct DenseRows {      // x (N, G) row-major -> packed (N, G/2), scale/zero
  static constexpr bool kMaySkip = false;   // every row has a destination
  const T* x;
  uint8_t* packed;
  float* scale;
  float* zero;
  int G;
  __device__ const T* src(long long row, int e) const {
    return x + row * G + e;
  }
  __device__ Dst dst(long long row) const {
    return {packed + row * (G >> 1), scale + row, zero + row};
  }
};

template <typename T>
struct AppendRows {     // row = kv * B * ppr + b * ppr + r: group r of slot
                        // b's new K (kv = 0) or V (kv = 1)
  static constexpr bool kMaySkip = true;    // a page past the pool
  const T* k;
  const T* v;
  long long k_sb, k_sh, v_sb, v_sh;       // element strides: slot, head
  int B, hd, G, ppr;
  uint8_t* kp;
  float* ks;
  float* kz;
  uint8_t* vp;
  float* vs;
  float* vz;
  int P, R;                               // pages, rows a page
  const int* page_table;                  // (B, W)
  int W;
  const int* lengths;                     // (B,)
  int ps;                                 // tokens a page
  __device__ const T* src(long long row, int e) const {
    const int n = (int)row, kv = n >= B * ppr, m = n - kv * B * ppr;
    const int b = m / ppr, r = m - b * ppr;
    const int f = r * G + e;               // element of the token's Hkv*hd
    const int h = f / hd, d = f - h * hd;  // 8 elements never cross a head
    return kv ? v + b * v_sb + h * v_sh + d : k + b * k_sb + h * k_sh + d;
  }
  __device__ Dst dst(long long row) const {
    const int n = (int)row, kv = n >= B * ppr, m = n - kv * B * ppr;
    const int b = m / ppr, r = m - b * ppr;
    const int len = lengths[b];
    const int pi = max(min(len / ps, W - 1), 0);
    const int page = max(page_table[b * W + pi], 0);
    if (page >= P) return {nullptr, nullptr, nullptr};
    const long long o = (long long)page * R + (len % ps) * ppr + r;
    const long long ob = o * (G >> 1);
    return kv ? Dst{vp + ob, vs + o, vz + o} : Dst{kp + ob, ks + o, kz + o};
  }
};

// LPR lanes a row (a power of two, >= G/8), U rows a lane per step; a warp
// takes U * 32 / LPR <= 32 consecutive rows a step
template <typename T, int LPR, int U, class Rows>
__global__ void __launch_bounds__(kThreads)
    quant_vec_kernel(Rows rows, long long n_rows, int G) {
  constexpr int RPW = 32 / LPR;
  constexpr int TR = U * RPW;
  static_assert(TR <= 32, "a warp's rows must fit its lanes");
  const int lane = threadIdx.x & 31, sub = lane % LPR, grp = lane / LPR;
  const bool active = sub < (G >> 3);
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * (kThreads / 32);
  // warp-uniform trip count: every lane reaches every shuffle
  for (long long row0 = warp * TR; row0 < n_rows; row0 += n_warps * TR) {
    float v[U][8];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {           // all loads before any division
      const long long row = row0 + u * RPW + grp;
      ok[u] = active && row < n_rows;
      if (ok[u]) {
        load8(rows.src(row, 8 * sub), v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = 0.0f;
      }
    }
    float mn[U], s[U], rs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float a = INFINITY, b = -INFINITY;
      if (ok[u]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a = fminf(a, v[u][i]);
          b = fmaxf(b, v[u][i]);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        a = fminf(a, __shfl_xor_sync(kFull, a, off));
        b = fmaxf(b, __shfl_xor_sync(kFull, b, off));
      }
      mn[u] = a;
      s[u] = __fdiv_rn(fmaxf(__fsub_rn(b, a), 1e-8f), 15.0f);
      rs[u] = __frcp_rn(s[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const Dst d = rows.dst(row0 + u * RPW + grp);
      if (Rows::kMaySkip && d.p == nullptr) continue;
      // low nibble first: element 2j in bits 0-3 of byte j, 2j+1 in 4-7
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w |= nibble_fast(v[u][i], mn[u], s[u], rs[u]) << (4 * i);
      reinterpret_cast<uint32_t*>(d.p)[sub] = w;
    }
    // lane l takes row row0 + l: step l / RPW of group l % RPW
    float so = 0.0f, zo = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = __shfl_sync(kFull, s[u], (lane % RPW) * LPR);
      const float b = __shfl_sync(kFull, mn[u], (lane % RPW) * LPR);
      if (lane / RPW == u) {
        so = a;
        zo = b;
      }
    }
    if (lane < TR && row0 + lane < n_rows) {
      const Dst d = rows.dst(row0 + lane);
      if (!Rows::kMaySkip || d.p != nullptr) {
        *d.s = so;
        *d.z = zo;
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// blocks a kernel keeps resident on one SM (asked once per kernel, by the
// caller's function-local static)
template <typename K>
int occupancy(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return n > 0 ? n : 1;
}

// blocks to launch: enough for the work, at most what the card holds at once
long long grid_for(long long blocks_needed, int per_sm) {
  const long long cap = (long long)sm_count() * per_sm;
  return blocks_needed < cap ? blocks_needed : cap;
}

template <typename T, int LPR, int U, class Rows>
void quant_vec(Rows rows, long long n_rows, int G, cudaStream_t st) {
  constexpr int rows_per_block = (kThreads / 32) * U * (32 / LPR);
  static const int per_sm = occupancy(quant_vec_kernel<T, LPR, U, Rows>);
  const long long blocks =
      grid_for((n_rows + rows_per_block - 1) / rows_per_block, per_sm);
  quant_vec_kernel<T, LPR, U, Rows><<<(unsigned)blocks, kThreads, 0, st>>>(
      rows, n_rows, G);
}

// LPR from G; bulk work takes 2 rows a lane per step, the decode append
// one (its ~400 rows want parallelism, not depth)
template <typename T, bool kBulk, class Rows>
void quant_vec_dispatch(Rows rows, long long n_rows, int G, cudaStream_t st) {
  constexpr int U = kBulk ? 2 : 1;
  const int lanes = G >> 3;
  if (lanes <= 1)
    quant_vec<T, 1, 1>(rows, n_rows, G, st);
  else if (lanes <= 2)
    quant_vec<T, 2, U>(rows, n_rows, G, st);
  else if (lanes <= 4)
    quant_vec<T, 4, U>(rows, n_rows, G, st);
  else if (lanes <= 8)
    quant_vec<T, 8, U>(rows, n_rows, G, st);
  else if (lanes <= 16)
    quant_vec<T, 16, U>(rows, n_rows, G, st);
  else
    quant_vec<T, 32, U>(rows, n_rows, G, st);
}

// ---------------------------------------------------------------------------
// kv_quant: scalar body (G % 8 != 0, G > 256, or a misaligned x)

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void quant_scalar_kernel(const T* __restrict__ x,
                                    uint8_t* __restrict__ packed,
                                    float* __restrict__ scale,
                                    float* __restrict__ zero,
                                    long long n_rows, int G) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp leaves together
  const T* xr = x + (size_t)row * G;
  const int half = G >> 1;
  float mn = INFINITY, mx = -INFINITY;
  for (int j = lane; j < half; j += 32) {
    const float a = load_f(xr, 2 * j), b = load_f(xr, 2 * j + 1);
    mn = fminf(mn, fminf(a, b));
    mx = fmaxf(mx, fmaxf(a, b));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
  const float s = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), 1e-8f), 15.0f);
  uint8_t* pr = packed + (size_t)row * half;
  for (int j = lane; j < half; j += 32) {
    const float a = load_f(xr, 2 * j), b = load_f(xr, 2 * j + 1);
    pr[j] = (uint8_t)(nibble(a, mn, s) | (nibble(b, mn, s) << 4));
  }
  if (lane == 0) {
    scale[row] = s;
    zero[row] = mn;
  }
}

// ---------------------------------------------------------------------------
// kv_dequant

// 16 bytes of output from one 16-byte store: 8 bf16 or 4 f32
__device__ __forceinline__ void store16B(__nv_bfloat16* p,
                                         const float (&y)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store16B(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

template <typename T>
struct PackedWord;      // the packed bytes behind 16 bytes of output
template <>
struct PackedWord<__nv_bfloat16> {
  using W = uint32_t;
};
template <>
struct PackedWord<float> {
  using W = uint16_t;
};

// vector body: a thread takes NB = 8 / sizeof(T) packed bytes of one row
// (4 for bf16, 2 for f32) and writes their 2 NB values with one 16-byte
// store, so a warp's store is 512 contiguous bytes. Needs G % 8 == 0 (a
// thread's bytes never straddle a row), a 4-byte aligned packed and
// G / (2 NB) <= kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequant_vec_kernel(const uint8_t* __restrict__ packed,
                       const float* __restrict__ scale,
                       const float* __restrict__ zero, T* __restrict__ out,
                       long long n_rows, int half) {
  constexpr int NB = 8 / (int)sizeof(T);
  using W = typename PackedWord<T>::W;
  const int cpr = half / NB;                // threads a row
  const int rpb = kThreads / cpr;           // rows a block holds at once
  const int lr = threadIdx.x / cpr, c = threadIdx.x - lr * cpr;
  if (lr >= rpb) return;                    // no barrier below
  for (long long row = (long long)blockIdx.x * rpb + lr; row < n_rows;
       row += (long long)gridDim.x * rpb) {
    const unsigned w =
        *reinterpret_cast<const W*>(packed + row * half + NB * c);
    const float s = scale[row], z = zero[row];
    float y[2 * NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const unsigned byte = w >> (8 * j);
      y[2 * j] = __fadd_rn(__fmul_rn(nibble_f(byte & 0xFu), s), z);
      y[2 * j + 1] = __fadd_rn(__fmul_rn(nibble_f((byte >> 4) & 0xFu), s), z);
    }
    store16B(out + row * (2 * half) + 2 * NB * c, y);
  }
}

// scalar body: one packed byte a thread
template <typename T>
__global__ void dequant_scalar_kernel(const uint8_t* __restrict__ packed,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ zero,
                                      T* __restrict__ out, long long n_bytes,
                                      int half) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bytes; i += stride) {
    const long long row = i / half;
    const float s = scale[row], z = zero[row];
    const unsigned byte = packed[i];
    store_f(out, 2 * (size_t)i,
            __fadd_rn(__fmul_rn(nibble_f(byte & 0xFu), s), z));
    store_f(out, 2 * (size_t)i + 1,
            __fadd_rn(__fmul_rn(nibble_f(byte >> 4), s), z));
  }
}

template <typename T>
void dequant(const uint8_t* packed, const float* scale, const float* zero,
             T* out, long long n_rows, int G, int vector, cudaStream_t st) {
  const int half = G / 2;
  if (vector) {
    static const int per_sm = occupancy(dequant_vec_kernel<T>);
    const int rows_per_block = kThreads / (half / (8 / (int)sizeof(T)));
    const long long blocks =
        grid_for((n_rows + rows_per_block - 1) / rows_per_block, per_sm);
    dequant_vec_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        packed, scale, zero, out, n_rows, half);
  } else {
    const long long n_bytes = n_rows * half;
    long long blocks = (n_bytes + kThreads - 1) / kThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
    dequant_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        packed, scale, zero, out, n_bytes, half);
  }
}

template <typename T>
void quant(const T* x, uint8_t* packed, float* scale, float* zero,
           long long n_rows, int G, int vector, cudaStream_t st) {
  if (vector) {
    quant_vec_dispatch<T, true>(DenseRows<T>{x, packed, scale, zero, G},
                                n_rows, G, st);
  } else {
    const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    quant_scalar_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, st>>>(
        x, packed, scale, zero, n_rows, G);
  }
}

}  // namespace

// vector = 1 picks the vector body; the wrapper checks its conditions
extern "C" int kv_quant_launch(const void* x, int x_is_bf16, void* packed,
                               void* scale, void* zero, long long n_rows,
                               int G, int vector, void* stream) {
  if (n_rows > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (x_is_bf16)
      quant((const __nv_bfloat16*)x, (uint8_t*)packed, (float*)scale,
            (float*)zero, n_rows, G, vector, st);
    else
      quant((const float*)x, (uint8_t*)packed, (float*)scale, (float*)zero,
            n_rows, G, vector, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int kv_dequant_launch(const void* packed, const void* scale,
                                 const void* zero, void* out,
                                 int out_is_bf16, long long n_rows, int G,
                                 int vector, void* stream) {
  if (n_rows > 0 && G > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (out_is_bf16)
      dequant((const uint8_t*)packed, (const float*)scale,
              (const float*)zero, (__nv_bfloat16*)out, n_rows, G, vector, st);
    else
      dequant((const uint8_t*)packed, (const float*)scale,
              (const float*)zero, (float*)out, n_rows, G, vector, st);
  }
  return (int)cudaGetLastError();
}

// k/v: (B, 1, Hkv, hd) with element strides (sb, sh) and a unit last one;
// kp/vp (P, R, G/2) u8 and ks/kz/vs/vz (P, R, 1) f32 pages, R = ps * ppr;
// page_table (B, W) and lengths (B,) int32, all on the card
extern "C" int kv_quant_append_launch(
    const void* k, const void* v, int is_bf16, long long k_sb, long long k_sh,
    long long v_sb, long long v_sh, int B, int hd, int G, int ppr, void* kp,
    void* ks, void* kz, void* vp, void* vs, void* vz, int P, int R,
    const void* page_table, int W, const void* lengths, int page_size,
    void* stream) {
  const long long n_rows = 2LL * B * ppr;
  if (n_rows > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16) {
      using T = __nv_bfloat16;
      const AppendRows<T> rows{
          (const T*)k, (const T*)v, k_sb, k_sh, v_sb, v_sh, B, hd, G, ppr,
          (uint8_t*)kp, (float*)ks, (float*)kz, (uint8_t*)vp, (float*)vs,
          (float*)vz, P, R, (const int*)page_table, W, (const int*)lengths,
          page_size};
      quant_vec_dispatch<T, false>(rows, n_rows, G, st);
    } else {
      using T = float;
      const AppendRows<T> rows{
          (const T*)k, (const T*)v, k_sb, k_sh, v_sb, v_sh, B, hd, G, ppr,
          (uint8_t*)kp, (float*)ks, (float*)kz, (uint8_t*)vp, (float*)vs,
          (float*)vz, P, R, (const int*)page_table, W, (const int*)lengths,
          page_size};
      quant_vec_dispatch<T, false>(rows, n_rows, G, st);
    }
  }
  return (int)cudaGetLastError();
}
