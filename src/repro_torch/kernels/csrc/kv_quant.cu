// Group-wise int4 KV quantization and dequantization for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/kv_quant.py:
//   kv_quant   (_quant_kernel)   x (N, G) -> packed (N, G/2) u8, scale (N, 1)
//                                f32, zero (N, 1) f32; per-row min/max affine
//                                int4, two nibbles per byte, low nibble first
//   kv_dequant (_dequant_kernel) packed + scale + zero -> (N, G) bf16 or f32
//
// Bound on the H100: memory. kv_quant reads N*G*sizeof(x) bytes and writes
// N*G/2 + 8N; kv_dequant reads N*G/2 + 8N and writes N*G*sizeof(out). Each
// does a handful of operations per byte, far below the ~295 FLOP/byte the
// card needs before compute limits it.
//
// Design: kv_quant gives one warp to a row (G <= 128 on every path, so a
// lane holds at most two byte pairs); loads are byte pairs from
// neighbouring lanes, min/max go through warp shuffles (exact in any order),
// and each lane writes the bytes it packed. kv_dequant is a grid-stride
// elementwise pass with one packed byte (two outputs) per thread. Neither
// reuses data, so neither stages anything in shared memory.
//
// Bit-exactness with the plain PyTorch version (kernels/ref.py) is the
// contract: the wire, the pages and the decode append must produce the same
// bytes whichever path quantized a token. So the arithmetic is spelled with
// round-to-nearest intrinsics that the compiler may not contract or
// approximate: __fsub_rn / __fdiv_rn (true IEEE division, no reciprocal
// multiply), rintf (round half to even, like torch.round), and
// __fmul_rn + __fadd_rn for dequantization (an FMA would round once where
// PyTorch rounds twice).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void kv_quant_kernel(const T* __restrict__ x,
                                uint8_t* __restrict__ packed,
                                float* __restrict__ scale,
                                float* __restrict__ zero, long long n_rows,
                                int G) {
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
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const float s = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), 1e-8f), 15.0f);
  uint8_t* pr = packed + (size_t)row * half;
  for (int j = lane; j < half; j += 32) {
    const float a = load_f(xr, 2 * j), b = load_f(xr, 2 * j + 1);
    const float qa =
        fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(a, mn), s)), 0.0f), 15.0f);
    const float qb =
        fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(b, mn), s)), 0.0f), 15.0f);
    // low nibble first: element 2j in bits 0-3, 2j+1 in bits 4-7
    pr[j] = (uint8_t)((unsigned)qa | ((unsigned)qb << 4));
  }
  if (lane == 0) {
    scale[row] = s;
    zero[row] = mn;
  }
}

template <typename T>
__global__ void kv_dequant_kernel(const uint8_t* __restrict__ packed,
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
    const float lo = (float)(byte & 0xFu), hi = (float)(byte >> 4);
    store_f(out, 2 * (size_t)i, __fadd_rn(__fmul_rn(lo, s), z));
    store_f(out, 2 * (size_t)i + 1, __fadd_rn(__fmul_rn(hi, s), z));
  }
}

}  // namespace

extern "C" int kv_quant_launch(const void* x, int x_is_bf16, void* packed,
                               void* scale, void* zero, long long n_rows,
                               int G, void* stream) {
  if (n_rows > 0) {
    const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);
    cudaStream_t st = (cudaStream_t)stream;
    if (x_is_bf16)
      kv_quant_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
          (const __nv_bfloat16*)x, (uint8_t*)packed, (float*)scale,
          (float*)zero, n_rows, G);
    else
      kv_quant_kernel<float><<<grid, block, 0, st>>>(
          (const float*)x, (uint8_t*)packed, (float*)scale, (float*)zero,
          n_rows, G);
  }
  return (int)cudaGetLastError();
}

extern "C" int kv_dequant_launch(const void* packed, const void* scale,
                                 const void* zero, void* out,
                                 int out_is_bf16, long long n_rows, int G,
                                 void* stream) {
  const long long n_bytes = n_rows * (G / 2);
  if (n_bytes > 0) {
    const int threads = 256;
    long long blocks = (n_bytes + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
    cudaStream_t st = (cudaStream_t)stream;
    if (out_is_bf16)
      kv_dequant_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
          (const uint8_t*)packed, (const float*)scale, (const float*)zero,
          (__nv_bfloat16*)out, n_bytes, G / 2);
    else
      kv_dequant_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
          (const uint8_t*)packed, (const float*)scale, (const float*)zero,
          (float*)out, n_bytes, G / 2);
  }
  return (int)cudaGetLastError();
}
