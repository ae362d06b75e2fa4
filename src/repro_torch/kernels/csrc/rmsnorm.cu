// RMSNorm with an optional residual add, one thread block per row.
//
//   out = (x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * scale
//
// Statistics and arithmetic in float32, output in the type of x. The row is
// read from device memory once, kept in shared memory as float32 while the
// block reduces its sum of squares, and written once. Rows whose length and
// addresses allow it move as 16-byte vectors; any other row length takes the
// scalar path. The kernel is bound by bytes: nothing here is worth a tensor
// core.
#include "common.cuh"

namespace rt {

constexpr int kMaxThreads = 512;
constexpr size_t kStaticSmem = 32 * sizeof(float);  // warp_sums
constexpr size_t kMaxSmem = 227 * 1024;             // a block's share on sm_90

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  float total = (lane < n_warps) ? warp_sums[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, off);
  }
  return total;
}

template <typename T, typename TS, bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                   const TS* __restrict__ scale, T* __restrict__ out, int d,
                   float eps) {
  extern __shared__ __align__(16) float row[];  // d floats (padded to 4)
  __shared__ float warp_sums[32];
  constexpr int V = Vec<T>::n;

  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  const T* rr = residual ? residual + base : nullptr;
  T* outr = out + base;

  float ss = 0.0f;
  if (kVector) {
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      float v[V];
      load16(xr + i, v);
      if (rr) {
        float r[V];
        load16(rr + i, r);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] += r[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) ss += v[j] * v[j];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(row + i + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float v = to_float(xr[i]);
      if (rr) v += to_float(rr[i]);
      ss += v * v;
      row[i] = v;
    }
  }

  // Each thread reads back only what it wrote itself, so the barrier inside
  // block_sum is the only one the row needs.
  const float total = block_sum(ss, warp_sums);
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  if (kVector) {
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      float y[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + i + j);
        y[j] = v.x;
        y[j + 1] = v.y;
        y[j + 2] = v.z;
        y[j + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        y[j] = y[j] * inv * to_float(scale[i + j]);
      }
      store16(outr + i, y);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      outr[i] = from_float<T>(row[i] * inv * to_float(scale[i]));
    }
  }
}

template <typename T, typename TS>
int launch_rmsnorm(const void* x, const void* residual, const void* scale,
                   void* out, long long rows, int d, float eps, int vector,
                   cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int per_thread = vector ? V : 1;
  int threads = (d + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>((d + 3) / 4) * 4 * sizeof(float);
  auto kernel = vector ? rmsnorm_kernel<T, TS, true>
                       : rmsnorm_kernel<T, TS, false>;
  // 48 KB is the most a block gets unasked, static shared memory included
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const TS*>(scale), static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// x, residual (may be null), out: (rows, d) contiguous, of x_dtype.
// scale: (d,) of scale_dtype. vector != 0 promises that d is a multiple of
// 16 bytes' worth of elements and that x, residual and out are 16-byte
// aligned. Returns 0, a CUDA error code, or a negative code for arguments
// the kernel does not take.
extern "C" int rt_rmsnorm(const void* x, const void* residual,
                          const void* scale, void* out, long long rows, int d,
                          float eps, int x_dtype, int scale_dtype, int vector,
                          void* stream) {
  using namespace rt;
  if (rows <= 0 || d <= 0 || rows > 2147483647LL) return kBadShape;
  // The row is held in shared memory as float32.
  if ((static_cast<size_t>(d) + 4) * sizeof(float) + kStaticSmem > kMaxSmem) {
    return kBadShape;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && scale_dtype == kFloat32) {
    return launch_rmsnorm<float, float>(x, residual, scale, out, rows, d, eps,
                                        vector, s);
  }
  if (x_dtype == kFloat32 && scale_dtype == kBFloat16) {
    return launch_rmsnorm<float, __nv_bfloat16>(x, residual, scale, out, rows,
                                                d, eps, vector, s);
  }
  if (x_dtype == kBFloat16 && scale_dtype == kFloat32) {
    return launch_rmsnorm<__nv_bfloat16, float>(x, residual, scale, out, rows,
                                                d, eps, vector, s);
  }
  if (x_dtype == kBFloat16 && scale_dtype == kBFloat16) {
    return launch_rmsnorm<__nv_bfloat16, __nv_bfloat16>(
        x, residual, scale, out, rows, d, eps, vector, s);
  }
  return kBadDtype;
}
