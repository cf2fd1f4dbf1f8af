// Row normalisation kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// K4  k4_rms_norm    replaces audiolab_tpu/kernels/norms.py::_rmsnorm_kernel:
//                    x * rsqrt(mean(x^2) + eps) * w over the last axis.
// K5  k5_layer_norm  replaces audiolab_tpu/kernels/norms.py::_layernorm_kernel:
//                    (x - mu) * rsqrt(var + eps) * w + b, with var the mean
//                    of the CENTRED (x - mu)^2 (E[x^2] - mu^2 differs from it
//                    in bf16-sized ways).
//
// Both compute in fp32 and write the output in x's type; w and b are read as
// fp32.  Entry points take device pointers to a contiguous (rows, d) x and
// output and a CUDA stream, launch on that stream without synchronising,
// allocate nothing, and return cudaGetLastError().
//
// Bound and design.  At the RoFormer time-axis activation (342,240 rows x
// 512, bf16) a call reads 350 MB and writes 350 MB: 0.21 ms at 3.35 TB/s,
// against a few operations per element, so it is bound by bytes.  The TPU
// kernel tiled ~2 MB of rows into VMEM; here one warp owns one row and
// holds it in registers from the load to the store, so x is read from
// device memory once:
//   - loads and stores are 16 bytes a lane (8 bf16/fp16 or 4 fp32) when d
//     fills whole vectors and the rows are 16-byte aligned, else one
//     element a lane; lanes take consecutive vectors, so a warp's access is
//     contiguous;
//   - each lane holds E = 8..128 values (E*32 >= d, the tail masked), so the
//     largest row is NORM_MAX_D = 4096 elements; the wrapper refuses more;
//   - sums are fp32 and reduced across the warp with shuffles; LayerNorm
//     takes two passes over the registers, first mu, then the variance of
//     x - mu;
//   - the output products are rounded one at a time ((x*r)*w, then + b) as
//     the TPU kernel's jnp expression is, with no contracted multiply-add.
// Not done yet: several rows per warp for short d, and a split row for d
// above the register limit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NORM_WARPS = 8;      // rows per CTA, one per warp
constexpr int NORM_MAX_D = 4096;   // 32 lanes x 128 values

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// VW: elements a lane moves at once; NV: moves a lane makes over the row
template <typename T, int VW, int NV>
__global__ void __launch_bounds__(32 * NORM_WARPS)
norm_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
            T* __restrict__ o, long long rows, int d, float eps, int layer) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * NORM_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = o + row * d;

  float v[NV][VW];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (j * 32 + lane) * VW;  // VW divides d, so a vector is whole or absent
    alignas(16) T pk[VW];  // one 16-byte load when VW > 1
    if (c0 < d) {
      if constexpr (VW > 1)
        *reinterpret_cast<uint4*>(pk) = *reinterpret_cast<const uint4*>(xr + c0);
      else
        pk[0] = xr[c0];
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) v[j][e] = c0 < d ? to_f<T>(pk[e]) : 0.f;
  }

  const float n = (float)d;
  float mu = 0.f;
  if (layer) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VW; ++e) s += v[j][e];
    mu = warp_sum(s) / n;
  }
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool in_row = (j * 32 + lane) * VW < d;
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      v[j][e] = in_row ? v[j][e] - mu : 0.f;
      s2 = fmaf(v[j][e], v[j][e], s2);
    }
  }
  const float var = warp_sum(s2) / n;
  const float rs = 1.f / sqrtf(var + eps);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (j * 32 + lane) * VW;
    if (c0 >= d) continue;
    alignas(16) T pk[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      float y = __fmul_rn(__fmul_rn(v[j][e], rs), w[c0 + e]);
      if (layer) y = __fadd_rn(y, b[c0 + e]);
      pk[e] = from_f<T>(y);
    }
    if constexpr (VW > 1)
      *reinterpret_cast<uint4*>(orow + c0) = *reinterpret_cast<const uint4*>(pk);
    else
      orow[c0] = pk[0];
  }
}

template <typename T, int VW, int E>
cudaError_t norm_launch(const void* x, const float* w, const float* b, void* o, long long rows,
                        int d, float eps, int layer, cudaStream_t s) {
  const long long blocks = (rows + NORM_WARPS - 1) / NORM_WARPS;
  norm_kernel<T, VW, E / VW><<<(unsigned)blocks, 32 * NORM_WARPS, 0, s>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(o), rows, d, eps, layer);
  return cudaGetLastError();
}

// the smallest E (values a lane holds) with 32 * E >= d
template <typename T, int VW>
cudaError_t norm_by_width(const void* x, const float* w, const float* b, void* o,
                          long long rows, int d, float eps, int layer, cudaStream_t s) {
  const int per_lane = (d + 31) / 32;
  if (per_lane <= 8) return norm_launch<T, VW, 8>(x, w, b, o, rows, d, eps, layer, s);
  if (per_lane <= 16) return norm_launch<T, VW, 16>(x, w, b, o, rows, d, eps, layer, s);
  if (per_lane <= 32) return norm_launch<T, VW, 32>(x, w, b, o, rows, d, eps, layer, s);
  if (per_lane <= 64) return norm_launch<T, VW, 64>(x, w, b, o, rows, d, eps, layer, s);
  return norm_launch<T, VW, 128>(x, w, b, o, rows, d, eps, layer, s);
}

template <typename T>
cudaError_t norm_dispatch(const void* x, const float* w, const float* b, void* o,
                          long long rows, int d, float eps, int layer, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned = d % VW == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (aligned) return norm_by_width<T, VW>(x, w, b, o, rows, d, eps, layer, s);
  return norm_by_width<T, 1>(x, w, b, o, rows, d, eps, layer, s);
}

// dtype codes shared with audiolab_tpu_torch/kernels/norms.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

int norm_entry(const void* x, const float* w, const float* b, void* o, long long rows, int d,
               float eps, int dtype, int layer, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || d > NORM_MAX_D || w == nullptr || (layer && b == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((rows + NORM_WARPS - 1) / NORM_WARPS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return (int)norm_dispatch<float>(x, w, b, o, rows, d, eps, layer, s);
  if (dtype == DT_BF16)
    return (int)norm_dispatch<__nv_bfloat16>(x, w, b, o, rows, d, eps, layer, s);
  if (dtype == DT_F16) return (int)norm_dispatch<__half>(x, w, b, o, rows, d, eps, layer, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int k4_rms_norm(const void* x, const float* w, void* o, long long rows, int d,
                           float eps, int dtype, void* stream) {
  return norm_entry(x, w, nullptr, o, rows, d, eps, dtype, 0, stream);
}

extern "C" int k5_layer_norm(const void* x, const float* w, const float* b, void* o,
                             long long rows, int d, float eps, int dtype, void* stream) {
  return norm_entry(x, w, b, o, rows, d, eps, dtype, 1, stream);
}
