// RMSNorm with an optional residual add.
//
//   out = (x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * scale
//
// Statistics and arithmetic in float32, output in the type of x. The kernel
// is bound by bytes: each element is read once and written once, and the
// arithmetic is a handful of operations an element. Two kernels:
//
// - rmsnorm_reg_kernel, for rows that split into 16-byte vectors with no
//   idle lane: a row is held in registers by `tpr` threads (a power of two
//   up to kRegRowThreads),
//   `nv` vectors each (at most kMaxVec), thread t holding the vectors
//   t, t + tpr, ... so that a warp's loads are contiguous. A block holds
//   `rpb` rows and walks over the rows with a stride of the grid; `scale`
//   is read from device memory once a block into shared memory, for every
//   row the block handles. The sum
//   of squares is reduced with warp shuffles, and across the warps of a row
//   through a named barrier of that row's threads only: no row waits for
//   another. The host chooses tpr (kernels/rmsnorm.py, launch_shape); nv
//   and rpb follow from it.
// - rmsnorm_smem_kernel, for every other row: one block a row, the row in
//   shared memory as float32 between the reduction and the scaling, 16-byte
//   vectors where the length and the addresses allow, else scalars.
//
// The backward (rmsnorm_bwd_rows_kernel, then rmsnorm_dscale_kernel), for
// h = x [+ residual], rstd = rsqrt(mean(h^2) + eps), x_hat = h * rstd and
// the output's gradient g:
//
//   dx     = rstd * (g * scale - x_hat * mean(g * scale * x_hat))
//   dscale = sum over rows of g * x_hat
//
// (the residual's gradient is dx as well). It is bound by bytes too: x and g
// are read once and dx written once, so at (8192, 4096) bf16 it moves
// 3 x 67 MB, ~0.060 ms at 3.35 TB/s (twice that in float32). A block walks
// over rows with the stride of the grid; each thread owns the same columns
// of every row (16-byte vectors where the row and the addresses allow),
// holds h and g of the current row in shared memory as float32 between the
// reduction (sum of h^2 and of g * scale * h, one block reduction for both)
// and the write of dx, and keeps its columns' running sum of g * x_hat in
// shared memory too, laid out so that a warp's accesses hit no bank twice.
// No column is shared between threads, so the only barriers are the
// reduction's. Each block writes its
// sums to a (blocks, d) float32 buffer and a second kernel adds the rows of
// that buffer in a fixed order: dscale is the same to the bit from run to
// run (no atomics), for a grid the caller fixes.
#include "common.cuh"

namespace rt {

constexpr int kMaxThreads = 512;      // of the shared-memory kernel
constexpr int kMaxVec = 8;            // 16-byte vectors a thread holds
constexpr int kRegThreads = 256;     // threads of a block of the register kernel
constexpr int kRegRowThreads = 512;  // threads of a float32 row at most (one a block)
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
    rmsnorm_smem_kernel(const T* __restrict__ x, const T* __restrict__ residual,
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

// The scale of one 16-byte vector of x (Vec<T>::n elements of TS), kept as
// 32-bit words: 2 to 8 registers instead of a float each.
template <typename T, typename TS>
struct ScaleVec {
  static constexpr int V = Vec<T>::n;
  static constexpr int W = V * static_cast<int>(sizeof(TS)) / 4;
  uint32_t w[W];

  // p is aligned to V * sizeof(TS) bytes
  __device__ __forceinline__ void load(const TS* p) {
    if constexpr (W == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = u.x;
        w[4 * k + 1] = u.y;
        w[4 * k + 2] = u.z;
        w[4 * k + 3] = u.w;
      }
    }
  }

  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(TS) == 4) {
      return __uint_as_float(w[j]);
    } else {  // bfloat16: the upper half of a float32
      return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u)
                                     : (w[j >> 1] << 16));
    }
  }
};

// Wait for the `count` threads that use barrier `id` (1..15; 0 is
// __syncthreads's).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Raw 16-byte vector of x as floats.
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// kThreads bounds the block: 256, or 512 for a float32 row of 512 threads.
// Without a residual the row stays in registers as it arrived (16 bytes a
// vector: 32 registers for 8 vectors), which leaves room for several blocks
// on an SM; with one, the sum x + residual is kept in float32.
template <typename T, typename TS, int kThreads, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_reg_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                       const TS* __restrict__ scale, T* __restrict__ out,
                       long long rows, int d, int tpr, int nv, int rpb,
                       float eps) {
  constexpr int V = Vec<T>::n;
  // scale, read from device memory once a block for all the rows it
  // handles (d * sizeof(TS) bytes, a multiple of 8)
  extern __shared__ __align__(16) unsigned char scale_raw[];
  // warp sums of a row spread over several warps, two sets so that a row
  // may be written while the last one is still read
  __shared__ float partial[2][32];
  const int g = threadIdx.x / tpr;  // the block's row this thread works on
  const int t = threadIdx.x - g * tpr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_warps = tpr >> 5;   // 0 when a row is part of one warp

  const int scale_words = d * static_cast<int>(sizeof(TS)) / 8;
  for (int i = threadIdx.x; i < scale_words; i += blockDim.x) {
    reinterpret_cast<uint2*>(scale_raw)[i] =
        reinterpret_cast<const uint2*>(scale)[i];
  }
  __syncthreads();
  const TS* scale_sm = reinterpret_cast<const TS*>(scale_raw);

  int set = 0;
  // The loop is the same for every thread of the block, so that every lane
  // of a warp takes part in its shuffles; a row past the end does no loads.
  for (long long r0 = static_cast<long long>(blockIdx.x) * rpb; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * rpb) {
    const long long row = r0 + g;
    const bool live = row < rows;
    const size_t base = static_cast<size_t>(live ? row : 0) * d;
    uint4 raw[kMaxVec];
    float sum[kResidual ? kMaxVec : 1][V];
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      if (j < nv && live) {
        const size_t i = base + static_cast<size_t>(j * tpr + t) * V;
        raw[j] = *reinterpret_cast<const uint4*>(x + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      if (j < nv && live) {
        float v[V];
        unpack16(raw[j], v);
        if constexpr (kResidual) {
          float r[V];
          load16(residual + base + static_cast<size_t>(j * tpr + t) * V, r);
#pragma unroll
          for (int e = 0; e < V; ++e) sum[j][e] = v[e] + r[e];
#pragma unroll
          for (int e = 0; e < V; ++e) ss = fmaf(sum[j][e], sum[j][e], ss);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) ss = fmaf(v[e], v[e], ss);
        }
      }
    }
    // rows of fewer than 32 threads are aligned groups of lanes: the xor
    // shuffles stay inside the row
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (row_warps > 1) {
      if (lane == 0) partial[set][warp] = ss;
      named_barrier(1 + g, tpr);
      ss = 0.0f;
      for (int k = 0; k < row_warps; ++k) ss += partial[set][g * row_warps + k];
      set ^= 1;
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      if (j < nv && live) {
        const int col = (j * tpr + t) * V;
        ScaleVec<T, TS> sc;
        sc.load(scale_sm + col);
        float v[V];
        if constexpr (kResidual) {
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = sum[j][e];
        } else {
          unpack16(raw[j], v);
        }
        float yv[V];
#pragma unroll
        for (int e = 0; e < V; ++e) yv[e] = v[e] * inv * sc.get(e);
        store16(out + base + col, yv);
      }
    }
  }
}

// Streaming multiprocessors of the current card, looked up once a card.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

template <typename T, typename TS>
int launch_rmsnorm_reg(const void* x, const void* residual, const void* scale,
                       void* out, long long rows, int d, float eps, int tpr,
                       cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const bool pow2 = (tpr & (tpr - 1)) == 0;
  const int nv = d / V / tpr;
  // a block of kRegThreads threads holds kRegThreads / tpr rows, or one
  const int rpb = tpr < kRegThreads ? kRegThreads / tpr : 1;
  if (!pow2 || tpr > kRegRowThreads || nv < 1 || nv > kMaxVec ||
      static_cast<long long>(tpr) * nv * V != d) {
    return kBadShape;
  }
  const int threads = tpr * rpb;
  long long blocks = (rows + rpb - 1) / rpb;
  // enough blocks to fill the card; each then walks over several rows
  const long long fill = static_cast<long long>(sm_count()) * (2048 / threads);
  if (blocks > fill) blocks = fill;
  const bool res = residual != nullptr;
  auto kernel = res ? rmsnorm_reg_kernel<T, TS, kRegThreads, true>
                    : rmsnorm_reg_kernel<T, TS, kRegThreads, false>;
  if constexpr (sizeof(T) == 4) {
    if (threads > kRegThreads) {
      kernel = res ? rmsnorm_reg_kernel<T, TS, kRegRowThreads, true>
                   : rmsnorm_reg_kernel<T, TS, kRegRowThreads, false>;
    }
  } else if (threads > kRegThreads) {
    return kBadShape;
  }
  const size_t smem = static_cast<size_t>(d) * sizeof(TS);
  if (smem + 2 * 32 * sizeof(float) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const TS*>(scale), static_cast<T*>(out), rows, d, tpr, nv,
      rpb, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS>
int launch_rmsnorm(const void* x, const void* residual, const void* scale,
                   void* out, long long rows, int d, float eps, int mode,
                   cudaStream_t stream) {
  if (mode > 0) {
    return launch_rmsnorm_reg<T, TS>(x, residual, scale, out, rows, d, eps,
                                     mode, stream);
  }
  const bool vector = mode == 0;
  // The row is held in shared memory as float32.
  if ((static_cast<size_t>(d) + 4) * sizeof(float) + kStaticSmem > kMaxSmem) {
    return kBadShape;
  }
  constexpr int V = Vec<T>::n;
  const int per_thread = vector ? V : 1;
  int threads = (d + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>((d + 3) / 4) * 4 * sizeof(float);
  auto kernel = vector ? rmsnorm_smem_kernel<T, TS, true>
                       : rmsnorm_smem_kernel<T, TS, false>;
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;

// The h = x [+ residual] and the g of Vec<T>::n columns (kVector) or of one
// column at i, as float32.
template <typename T, bool kVector>
__device__ __forceinline__ void load_cols(const T* __restrict__ x,
                                          const T* __restrict__ residual,
                                          const T* __restrict__ g, size_t i,
                                          float (&h)[kVector ? Vec<T>::n : 1],
                                          float (&gv)[kVector ? Vec<T>::n : 1]) {
  if constexpr (kVector) {
    load16(x + i, h);
    load16(g + i, gv);
    if (residual) {
      float r[Vec<T>::n];
      load16(residual + i, r);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) h[j] += r[j];
    }
  } else {
    h[0] = to_float(x[i]);
    if (residual) h[0] += to_float(residual[i]);
    gv[0] = to_float(g[i]);
  }
}

// 4 or 8 scale values at p as floats; p is aligned to their size.
__device__ __forceinline__ void load_scale(const float* p, float (&s)[4]) {
  load16(p, s);
}
__device__ __forceinline__ void load_scale(const float* p, float (&s)[8]) {
  float a[4], b[4];
  load16(p, a);
  load16(p + 4, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = a[j];
    s[4 + j] = b[j];
  }
}
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p,
                                           float (&s)[8]) {
  load16(p, s);
}
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p,
                                           float (&s)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  s[0] = __uint_as_float(raw.x << 16);
  s[1] = __uint_as_float(raw.x & 0xffff0000u);
  s[2] = __uint_as_float(raw.y << 16);
  s[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// Thread t of a block of nt threads owns the groups of W columns that
// start at (t + k * nt) * W, k = 0, 1, ... (W = Vec<T>::n with kVector,
// else 1), the same in every row. Its k-th group sits in shared memory at
// the float4s (k * W / 4 + c) * nt + t (c < W / 4), or at the float
// k * nt + t: a warp's accesses are contiguous, with no bank conflict.
// Nothing in shared memory is read by a thread other than its writer.
template <bool kVector, int W>
struct BwdSlots {
  float* base;
  int nt, t;

  __device__ __forceinline__ void put(int k, const float (&v)[W]) const {
    if constexpr (kVector) {
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        reinterpret_cast<float4*>(base)[(k * (W / 4) + c) * nt + t] =
            make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
      }
    } else {
      base[k * nt + t] = v[0];
    }
  }

  __device__ __forceinline__ void get(int k, float (&v)[W]) const {
    if constexpr (kVector) {
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const float4 u =
            reinterpret_cast<const float4*>(base)[(k * (W / 4) + c) * nt + t];
        v[4 * c] = u.x;
        v[4 * c + 1] = u.y;
        v[4 * c + 2] = u.z;
        v[4 * c + 3] = u.w;
      }
    } else {
      v[0] = base[k * nt + t];
    }
  }
};

// Groups of W columns a thread of a block of nt threads owns, at most.
template <bool kVector, int W>
__host__ __device__ __forceinline__ int bwd_groups(int d, int nt) {
  return (d / W + nt - 1) / nt;
}

// One block of kBwdThreads threads walks over rows blockIdx.x,
// blockIdx.x + gridDim.x, ... Dynamic shared memory: h and g of the
// current row and this block's running sum of g * x_hat, each
// groups * W * nt floats, laid out by BwdSlots. partial: (gridDim.x, d)
// float32, row b the block b's sums.
template <typename T, typename TS, bool kVector>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                            const T* __restrict__ residual,
                            const TS* __restrict__ scale,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ partial, long long rows, int d,
                            float eps) {
  extern __shared__ __align__(16) float bwd_smem[];
  // the block's two sums (of h^2 and of g * scale * h) a warp, two sets so
  // that a row may write while the last one is still read
  __shared__ float sums[2][2][32];
  constexpr int W = kVector ? Vec<T>::n : 1;
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int groups = bwd_groups<kVector, W>(d, nt);
  const int span = groups * W * nt;
  const BwdSlots<kVector, W> hs{bwd_smem, nt, t};
  const BwdSlots<kVector, W> gs{bwd_smem + span, nt, t};
  const BwdSlots<kVector, W> acc{bwd_smem + 2 * span, nt, t};
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = nt >> 5;
  // this thread's groups: k < mine
  int mine = 0;
  while (mine < groups && (t + mine * nt) * W < d) ++mine;

  const float zero[W] = {};
  for (int k = 0; k < mine; ++k) acc.put(k, zero);
  int set = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.0f, dot = 0.0f;
    for (int k = 0; k < mine; ++k) {
      const int col = (t + k * nt) * W;
      float h[W], gv[W], s[W];
      load_cols<T, kVector>(x, residual, g, base + col, h, gv);
      if constexpr (kVector) {
        load_scale(scale + col, s);
      } else {
        s[0] = to_float(scale[col]);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        ss = fmaf(h[j], h[j], ss);
        dot = fmaf(gv[j] * s[j], h[j], dot);
      }
      hs.put(k, h);
      gs.put(k, gv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (lane == 0) {
      sums[set][0][warp] = ss;
      sums[set][1][warp] = dot;
    }
    __syncthreads();
    ss = lane < n_warps ? sums[set][0][lane] : 0.0f;
    dot = lane < n_warps ? sums[set][1][lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    set ^= 1;
    const float inv_d = 1.0f / static_cast<float>(d);
    const float rstd = rsqrtf(ss * inv_d + eps);
    // dx = rstd * g * scale - h * rstd^3 * mean(g * scale * h)
    const float kh = rstd * rstd * rstd * dot * inv_d;
    for (int k = 0; k < mine; ++k) {
      const int col = (t + k * nt) * W;
      float h[W], gv[W], s[W], a[W], out[W];
      hs.get(k, h);
      gs.get(k, gv);
      acc.get(k, a);
      if constexpr (kVector) {
        load_scale(scale + col, s);
      } else {
        s[0] = to_float(scale[col]);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        out[j] = rstd * gv[j] * s[j] - h[j] * kh;
        a[j] = fmaf(gv[j], h[j] * rstd, a[j]);
      }
      acc.put(k, a);
      if constexpr (kVector) {
        store16(dx + base + col, out);
      } else {
        dx[base + col] = from_float<T>(out[0]);
      }
    }
  }
  float* own = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int k = 0; k < mine; ++k) {
    const int col = (t + k * nt) * W;
    float a[W];
    acc.get(k, a);
    if constexpr (kVector) {
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        store4(own + col + 4 * c,
               make_float4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]));
      }
    } else {
      own[col] = a[0];
    }
  }
}

// dscale[c] = sum over b of partial[b][c], b in a fixed order: four running
// sums over b = 0, 4, 8, ... / 1, 5, ... added at the end, the same order
// on every run.
template <typename TS>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_dscale_kernel(const float* __restrict__ partial,
                          TS* __restrict__ dscale, int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int b = 0;
  for (; b + 4 <= blocks; b += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += partial[static_cast<size_t>(b + j) * d + c];
    }
  }
  for (; b < blocks; ++b) s[0] += partial[static_cast<size_t>(b) * d + c];
  dscale[c] = from_float<TS>((s[0] + s[1]) + (s[2] + s[3]));
}

template <typename T, typename TS>
int launch_rmsnorm_bwd(const void* x, const void* residual, const void* scale,
                       const void* g, void* dx, float* partial, void* dscale,
                       long long rows, int d, float eps, int blocks,
                       bool vector, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  if (vector && d % V) return kBadShape;
  const int per_thread = vector ? V : 1;
  int threads = (d + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kBwdThreads) threads = kBwdThreads;
  const int groups = vector ? bwd_groups<true, V>(d, threads)
                            : bwd_groups<false, 1>(d, threads);
  const size_t smem =
      3 * static_cast<size_t>(groups) * per_thread * threads * sizeof(float);
  const size_t static_smem = sizeof(float) * 2 * 2 * 32;
  if (smem + static_smem > kMaxSmem) return kBadShape;
  auto kernel = vector ? rmsnorm_bwd_rows_kernel<T, TS, true>
                       : rmsnorm_bwd_rows_kernel<T, TS, false>;
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const TS*>(scale), static_cast<const T*>(g),
      static_cast<T*>(dx), partial, rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<TS>
      <<<static_cast<unsigned>((d + kBwdThreads - 1) / kBwdThreads),
         kBwdThreads, 0, stream>>>(partial, static_cast<TS*>(dscale), blocks,
                                   d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// The arguments of rt_rmsnorm, packed by the caller into one struct
// (kernels/rmsnorm.py, _ARGS): one argument to convert instead of nine,
// which is most of the cost of a call from Python at a decode step.
// x, residual (may be null), out: (rows, d) contiguous, of the type of
// dtypes & 1; scale: (d,) of the type of dtypes >> 1 (0 float32, 1
// bfloat16). mode > 0 takes the register kernel with `mode` threads a row
// (kernels/rmsnorm.py, launch_shape) and promises d a multiple of mode
// 16-byte vectors and x, residual, out and scale 16-byte aligned. mode == 0
// takes the shared-memory kernel with 16-byte vectors and promises d a
// multiple of 16 bytes' worth of elements and x, residual and out 16-byte
// aligned; mode < 0 takes it with scalars.
struct RmsnormArgs {
  const void* x;
  const void* residual;
  const void* scale;
  void* out;
  long long rows;
  int d;
  float eps;
  int dtypes;
  int mode;
};
static_assert(sizeof(RmsnormArgs) == 56, "the layout kernels/rmsnorm.py packs");

// Returns 0, a CUDA error code, or a negative code for arguments the
// kernels do not take.
extern "C" int rt_rmsnorm(const RmsnormArgs* args, void* stream) {
  using namespace rt;
  const RmsnormArgs a = *args;
  if (a.rows <= 0 || a.d <= 0 || a.rows > 2147483647LL) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dtypes) {
    case kFloat32 | kFloat32 << 1:
      return launch_rmsnorm<float, float>(a.x, a.residual, a.scale, a.out,
                                          a.rows, a.d, a.eps, a.mode, s);
    case kFloat32 | kBFloat16 << 1:
      return launch_rmsnorm<float, __nv_bfloat16>(
          a.x, a.residual, a.scale, a.out, a.rows, a.d, a.eps, a.mode, s);
    case kBFloat16 | kFloat32 << 1:
      return launch_rmsnorm<__nv_bfloat16, float>(
          a.x, a.residual, a.scale, a.out, a.rows, a.d, a.eps, a.mode, s);
    case kBFloat16 | kBFloat16 << 1:
      return launch_rmsnorm<__nv_bfloat16, __nv_bfloat16>(
          a.x, a.residual, a.scale, a.out, a.rows, a.d, a.eps, a.mode, s);
    default:
      return kBadDtype;
  }
}

// The backward of rt_rmsnorm. x, residual (may be null), g (the output's
// gradient), dx: (rows, d) contiguous, of the type of dtypes & 1; scale and
// dscale: (d,) of the type of dtypes >> 1; partial: (blocks, d) float32
// scratch, blocks in 1 .. rows, the grid of the first kernel (the caller
// fixes it, so dscale sums in the same order on every call). vector != 0
// promises d a multiple of 16 bytes' worth of elements and x, residual, g
// and dx 16-byte aligned. Returns 0, a CUDA error code, or a negative code
// for arguments the kernels do not take (a row of more than ~19,000
// elements does not fit in shared memory).
extern "C" int rt_rmsnorm_backward(const void* x, const void* residual,
                                   const void* scale, const void* g, void* dx,
                                   void* partial, void* dscale, long long rows,
                                   int d, float eps, int dtypes, int blocks,
                                   int vector, void* stream) {
  using namespace rt;
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows ||
      blocks > 2147483647LL / d) {
    return kBadShape;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const bool vec = vector != 0;
  switch (dtypes) {
    case kFloat32 | kFloat32 << 1:
      return launch_rmsnorm_bwd<float, float>(x, residual, scale, g, dx, part,
                                              dscale, rows, d, eps, blocks,
                                              vec, s);
    case kFloat32 | kBFloat16 << 1:
      return launch_rmsnorm_bwd<float, __nv_bfloat16>(
          x, residual, scale, g, dx, part, dscale, rows, d, eps, blocks, vec,
          s);
    case kBFloat16 | kFloat32 << 1:
      return launch_rmsnorm_bwd<__nv_bfloat16, float>(
          x, residual, scale, g, dx, part, dscale, rows, d, eps, blocks, vec,
          s);
    case kBFloat16 | kBFloat16 << 1:
      return launch_rmsnorm_bwd<__nv_bfloat16, __nv_bfloat16>(
          x, residual, scale, g, dx, part, dscale, rows, d, eps, blocks, vec,
          s);
    default:
      return kBadDtype;
  }
}
