// RMSNorm with a (1 + scale) gain for Hopper (sm_90a), with the residual add
// in front of it fused in.
//
// Replaces src/repro/kernels/rmsnorm.py (rmsnorm -> _rmsnorm_kernel):
// y = h * rsqrt(mean(h^2) + eps) * (1 + scale), f32 arithmetic, h and y bf16
// or f32, scale f32. With a residual r (add_rmsnorm): h = x + r, added in
// f32 and rounded once to x's type (PyTorch's `x + r`, byte for byte),
// stored, and normed; without one (rmsnorm: r, h null) h = x and only y is
// stored. In the port's decode step layer 0's norm1 is an rmsnorm, and
// every other norm follows a residual add and is an add_rmsnorm: the
// attention residual with norm2, the MLP residual with the next layer's
// norm1 or the final norm (models/transformer.py: run_layers).
//
// Bound on the H100: memory. add_rmsnorm reads x and r (N*d*sizeof(x)
// each) and scale (4d) and writes h and y: at 1024 x 6656 bf16, 54.5 MB,
// 16.3 us at 3.35 TB/s. At the decode step's 4 rows the bound is 0.06 us;
// what is left is latency: the launch, one round of loads, one reduction,
// the stores.
//
// Design: one CTA per row, the row held in registers. A thread owns VPT
// vectors of VEC elements (16 bytes: 8 bf16 or 4 f32) at vector indices
// tid + k * blockDim.x, and issues every load of x, r and scale before any
// arithmetic. The sum of squares is taken per thread in order, then with
// warp xor-shuffles; the warps' partials meet in shared memory behind the
// kernel's one barrier, and every warp sums them in the same order, so no
// second barrier and no broadcast. Then y (and h) are stored from
// registers. The block size and VPT are a function of d and the body alone
// (kernels/rmsnorm.py: norm_plan), never of N, so a row's bytes do not
// depend on how many rows share the launch: chunked vs one-shot prefill,
// step() vs step_reference() and a prefix hit vs its donor stay bit for
// bit. The vector body runs when d is a multiple of VEC and every pointer
// is 16-byte aligned; otherwise the scalar body, the same code at one
// element a vector. The per-element product is (h * rs) * (1 + s), the
// plain version's order; the row sum is taken in another order than
// PyTorch's, so f32 results agree to rounding and bf16 ones to one ulp.
// Nothing is read back to the host: the launch is legal inside the decode
// chunk's no-sync region and in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxElemsPerThread = 32;  // registers: v and s, 64 floats

// An element's storage, read as and written from f32.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using E = float;
  static __device__ __forceinline__ float get(E b) { return b; }
  static __device__ __forceinline__ E put(float v) { return v; }
};
template <>
struct Bits<__nv_bfloat16> {
  using E = unsigned short;
  static __device__ __forceinline__ float get(E b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ E put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// VEC elements of T: one 16-byte word, or one element
template <typename T, int VEC>
union Pack {
  static_assert(VEC * sizeof(T) == 16, "16 bytes or one element");
  uint4 u;
  typename Bits<T>::E e[VEC];
};
template <typename T>
union Pack<T, 1> {
  typename Bits<T>::E e[1];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> r;
  if constexpr (VEC == 1) {
    r.e[0] = *reinterpret_cast<const typename Bits<T>::E*>(p);
  } else {
    r.u = *reinterpret_cast<const uint4*>(p);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& r) {
  if constexpr (VEC == 1) {
    *reinterpret_cast<typename Bits<T>::E*>(p) = r.e[0];
  } else {
    *reinterpret_cast<uint4*>(p) = r.u;
  }
}

// VEC f32 scales at p (16-byte aligned when VEC > 1)
template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float (&s)[VEC]) {
  if constexpr (VEC == 1) {
    s[0] = *p;
  } else {
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      const float4 f = reinterpret_cast<const float4*>(p)[c];
      s[4 * c] = f.x, s[4 * c + 1] = f.y, s[4 * c + 2] = f.z,
             s[4 * c + 3] = f.w;
    }
  }
}

template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const float* __restrict__ scale, T* __restrict__ h,
                   T* __restrict__ y, int d, float eps) {
  __shared__ float red[kMaxThreads / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = d / VEC;

  // every load first: x, r and scale of all VPT vectors
  Pack<T, VEC> xv[VPT], rv[VPT];
  float s[VPT][VEC];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * blockDim.x;
    if (i < nvec) {
      xv[k] = load<T, VEC>(x + base + (size_t)i * VEC);
      if (r != nullptr) rv[k] = load<T, VEC>(r + base + (size_t)i * VEC);
      load_scale<VEC>(scale + (size_t)i * VEC, s[k]);
    }
  }

  // h = x + r rounded to T (stored), and the sum of its squares
  float v[VPT][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * blockDim.x;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = 0.0f;
      if (i < nvec) {
        a = Bits<T>::get(xv[k].e[e]);
        if (r != nullptr) {
          xv[k].e[e] = Bits<T>::put(a + Bits<T>::get(rv[k].e[e]));
          a = Bits<T>::get(xv[k].e[e]);
        }
      }
      v[k][e] = a;
      ss = fmaf(a, a, ss);
    }
    if (h != nullptr && i < nvec)
      store<T, VEC>(h + base + (size_t)i * VEC, xv[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tot += __shfl_xor_sync(0xffffffffu, tot, off);
  const float rs = 1.0f / sqrtf(tot / (float)d + eps);

#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * blockDim.x;
    if (i >= nvec) continue;
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out.e[e] = Bits<T>::put((v[k][e] * rs) * (1.0f + s[k][e]));
    store<T, VEC>(y + base + (size_t)i * VEC, out);
  }
}

template <typename T, int VEC>
cudaError_t launch_vpt(int vpt, const void* x, const void* r,
                       const void* scale, void* h, void* y,
                       unsigned n_rows, int threads, int d, float eps,
                       cudaStream_t st) {
#define RMSNORM_VPT(V)                                                      \
  case V:                                                                   \
    if constexpr (V * VEC <= kMaxElemsPerThread) {                          \
      rmsnorm_kernel<T, VEC, V><<<n_rows, threads, 0, st>>>(                \
          (const T*)x, (const T*)r, (const float*)scale, (T*)h, (T*)y, d,   \
          eps);                                                             \
      return cudaGetLastError();                                            \
    }                                                                       \
    return cudaErrorInvalidValue;
  switch (vpt) {
    RMSNORM_VPT(1)
    RMSNORM_VPT(2)
    RMSNORM_VPT(4)
    RMSNORM_VPT(8)
    RMSNORM_VPT(16)
    RMSNORM_VPT(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef RMSNORM_VPT
}

template <typename T>
cudaError_t launch(int vec, int vpt, const void* x, const void* r,
                   const void* scale, void* h, void* y, unsigned n_rows,
                   int threads, int d, float eps, cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (vec == 1)
    return launch_vpt<T, 1>(vpt, x, r, scale, h, y, n_rows, threads, d, eps,
                            st);
  if (vec != kVec || d % kVec != 0 ||
      ((uintptr_t)x | (uintptr_t)r | (uintptr_t)scale | (uintptr_t)h |
       (uintptr_t)y) % 16 != 0)
    return cudaErrorInvalidValue;
  return launch_vpt<T, kVec>(vpt, x, r, scale, h, y, n_rows, threads, d,
                             eps, st);
}

}  // namespace

// r and h both null (rmsnorm) or both set (add_rmsnorm); vec/vpt/threads:
// the plan of kernels/rmsnorm.py (norm_plan), which must cover the row.
extern "C" int rmsnorm_launch(const void* x, const void* r,
                              const void* scale, void* h, void* y,
                              int is_bf16, long long n_rows, int d, int vec,
                              int vpt, int threads, float eps,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  if (n_rows > 2147483647LL || (r == nullptr) != (h == nullptr) ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      (long long)threads * vpt * vec < d)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? launch<__nv_bfloat16>(vec, vpt, x, r, scale, h, y,
                                               (unsigned)n_rows, threads, d,
                                               eps, st)
                       : launch<float>(vec, vpt, x, r, scale, h, y,
                                       (unsigned)n_rows, threads, d, eps,
                                       st));
}
