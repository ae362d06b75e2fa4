// Helpers shared by the kernels of this directory: element conversion and
// 16-byte loads and stores of float32 and bfloat16 rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Element type codes of the C interface.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Error codes the C entries return for arguments they do not take. CUDA's
// own codes are positive, so these are negative.
constexpr int kBadDtype = -1;
constexpr int kBadShape = -2;
// cuTensorMapEncodeTiled is missing or refused the tensor's layout.
constexpr int kNoTensorMap = -3;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Number of elements in 16 bytes.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// Load Vec<T>::n elements from a 16-byte aligned address into floats.
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Store Vec<T>::n floats to a 16-byte aligned address as T.
__device__ __forceinline__ void store16(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&in)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// Store four floats to a 16-byte aligned address.
__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

}  // namespace rt
