// RMSNorm with a (1 + scale) gain for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py (rmsnorm -> _rmsnorm_kernel):
// out = x * rsqrt(mean(x^2) + eps) * (1 + scale), f32 arithmetic, x and out
// bf16 or f32, scale f32. In the port it is every norm of the model: two
// per layer and the final norm, in prefill (rows = B*S) and in each decode
// step (rows = decode slots).
//
// Bound on the H100: memory. A call reads N*d*sizeof(x) + 4d bytes and
// writes N*d*sizeof(x), at ~4 operations per element: at the prefill
// bucket (1024 x 6656 bf16, 27.3 MB) that is 8.1 us at 3.35 TB/s. At the
// decode step's 4 rows the work is a few microseconds of launch latency
// whatever the kernel does.
//
// Design: the TPU kernel normalised blocks of 256 rows in VMEM. Here one
// CTA of 256 threads owns one row: a strided pass sums the squares in f32
// (neighbouring threads on neighbouring elements), a warp-shuffle and
// shared-memory reduction gives the row's sum, and a second strided pass
// re-reads the row (13 KB at LLaMA-30B width, an L1/L2 hit) and writes the
// output. The per-element product is spelled (x * r) * (1 + s), the plain
// version's order; the row sum is taken in another order than PyTorch's,
// so f32 results agree to rounding and bf16 ones to one ulp. Nothing is
// read back to the host: the launch is legal inside the decode chunk's
// no-sync region. Later work: 16-byte vector loads, the row kept in
// registers, and fusion with the residual add before it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float ss = 0.0f;
  for (int i = tid; i < d; i += kThreads) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[0] = ss;
  }
  __syncthreads();
  const float r = 1.0f / sqrtf(red[0] / (float)d + eps);

  for (int i = tid; i < d; i += kThreads) {
    const float v = to_f(xr[i]) * r;
    from_f(&orow[i], v * (1.0f + scale[i]));
  }
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int is_bf16, long long n_rows, int d, float eps,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows > 0 && d > 0) {
    if (n_rows > 2147483647LL) return (int)cudaErrorInvalidValue;
    if (is_bf16)
      rmsnorm_kernel<__nv_bfloat16><<<(unsigned)n_rows, kThreads, 0, st>>>(
          (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out,
          d, eps);
    else
      rmsnorm_kernel<float><<<(unsigned)n_rows, kThreads, 0, st>>>(
          (const float*)x, (const float*)scale, (float*)out, d, eps);
  }
  return (int)cudaGetLastError();
}
