// Mamba2 SSD (state space dual) scan, chunked, scalar decay per head.
//
//   xs (B, S, H, P), dt (B, S, H) float32, A (H,) float32 < 0,
//   Bm and Cm (B, S, H, N)  ->  y (B, S, H, P) float32
//
// Per head, with h_t the (N, P) state:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t
//
// One block owns one (batch, head) and walks over the sequence in tiles of
// 64 rows: the loop takes the place of the TPU kernel's sequential grid
// dimension, and the state stays in shared memory from the first tile to the
// last. Per tile, with cum the running sum of dt * A inside the tile:
//   M[i, j] = (C_i . B_j) exp(min(cum_i - cum_j, 0)) dt_j      j <= i, else 0
//   y       = M x + exp(cum) * (C h)
//   h      <- exp(cum[last]) h + (B * (exp(cum[last] - cum) dt))^T x
// The closed form is exact for any tile length, so y does not depend on the
// tile but through rounding; the reference's chunk of 256 would need a
// 256 x 256 float32 tile (256 KB) against the 227 KB a block may have. A
// tile cut short by the end of the sequence runs over its real rows only,
// which is what the TPU kernel's padding with dt = 0 computes.
//
// The three products of a tile (C B^T, M x and C h, and the state update)
// are done by all 256 threads as 16 x 16, each thread a 4 x 4 piece of
// rows r0 + 16 a and columns c0 + 16 b, so that a warp's reads of one
// operand fall on consecutive banks and of the other on one or two
// addresses. float32 FMAs throughout, as the TPU kernel casts everything to
// float32. xs, Bm and Cm are float32 or bfloat16, read through their batch,
// sequence and head strides: Bm and Cm may have a zero head stride (one
// group shared by every head), so no repeated copy of them is made.
#include "common.cuh"

namespace rt {

constexpr int kSsdQ = 64;          // rows of a tile
constexpr int kSsdMaxDim = 64;     // P and N at most (a 4 x 16 thread tile)
constexpr int kSsdThreads = 256;   // 16 x 16

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_kernel(const T* __restrict__ xs, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y, int S, int H,
               int P, int N, long long x_sb, long long x_ss, long long x_sh,
               long long d_sb, long long d_ss, long long d_sh, long long b_sb,
               long long b_ss, long long b_sh, long long c_sb, long long c_ss,
               long long c_sh) {
  constexpr int Q = kSsdQ;
  constexpr int QP = Q + 1;
  const int PP = P + 1;  // padded rows
  const int NP = N + 1;
  extern __shared__ float smem[];
  float* xsm = smem;            // Q x PP
  float* bsm = xsm + Q * PP;    // Q x NP
  float* csm = bsm + Q * NP;    // Q x NP
  float* msm = csm + Q * NP;    // Q x QP
  float* hsm = msm + Q * QP;    // N x PP
  float* dts = hsm + N * PP;    // Q
  float* cum = dts + Q;         // Q
  float* wts = cum + Q;         // Q: exp(cum[last] - cum) dt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float a_h = A[h];

  const T* xb = xs + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const T* bb = Bm + b * b_sb + h * b_sh;
  const T* cb = Cm + b * c_sb + h * c_sh;
  // y is contiguous (B, S, H, P)
  float* yb = y + (static_cast<long long>(b) * S * H + h) * P;
  const long long y_ss = static_cast<long long>(H) * P;

  // column indices of this thread, clamped so that a thread past the edge
  // reads inside its own row (its results are never stored)
  int colP[4], rowN[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    colP[q] = min(tx + 16 * q, P - 1);
    rowN[q] = min(ty + 16 * q, N - 1);
  }

  for (int i = tid; i < N * PP; i += kSsdThreads) hsm[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();  // the state is in place; the last tile is done with
    for (int i = tid; i < rows * P; i += kSsdThreads) {
      const int t = i / P;
      const int p = i % P;
      xsm[t * PP + p] = to_float(xb[(c0 + t) * x_ss + p]);
    }
    for (int i = tid; i < rows * N; i += kSsdThreads) {
      const int t = i / N;
      const int n = i % N;
      bsm[t * NP + n] = to_float(bb[(c0 + t) * b_ss + n]);
      csm[t * NP + n] = to_float(cb[(c0 + t) * c_ss + n]);
    }
    if (tid < Q) dts[tid] = tid < rows ? db[(c0 + tid) * d_ss] : 0.0f;
    __syncthreads();

    if (tid < 32) {  // running sum of dt * A over the tile's 64 rows
      float lo = dts[tid] * a_h;
      float hi = dts[tid + 32] * a_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float l = __shfl_up_sync(0xffffffffu, lo, off);
        const float u = __shfl_up_sync(0xffffffffu, hi, off);
        if (tid >= off) {
          lo += l;
          hi += u;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      cum[tid] = lo;
      cum[tid + 32] = hi;
    }
    __syncthreads();

    // M = tril(C B^T * decay) * dt_j; the weights of the state update
    {
      const float last = cum[rows - 1];
      if (tid < Q) {
        wts[tid] = tid < rows ? expf(last - cum[tid]) * dts[tid] : 0.0f;
      }
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cv[q] = csm[(ty + 16 * q) * NP + n];
          bv[q] = bsm[(tx + 16 * q) * NP + n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = tx + 16 * j;
          float m = 0.0f;
          if (ri < rows && cj <= ri) {
            m = acc[i][j] * expf(fminf(cum[ri] - cum[cj], 0.0f)) * dts[cj];
          }
          msm[ri * QP + cj] = m;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(cum) (C h): rows ty + 16 i, columns tx + 16 j
    {
      float acc[4][4] = {};
      float ach[4][4] = {};
      for (int j = 0; j < rows; ++j) {
        float mv[4], xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          mv[q] = msm[(ty + 16 * q) * QP + j];
          xv[q] = xsm[j * PP + colP[q]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(mv[i], xv[k], acc[i][k]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cv[q] = csm[(ty + 16 * q) * NP + n];
          hv[q] = hsm[n * PP + colP[q]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) ach[i][k] = fmaf(cv[i], hv[k], ach[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = ty + 16 * i;
        if (ri >= rows) continue;
        const float e = expf(cum[ri]);
        float* yrow = yb + (c0 + ri) * y_ss;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (p < P) yrow[p] = fmaf(e, ach[i][k], acc[i][k]);
        }
      }
    }
    __syncthreads();  // every read of the state is done

    // h = exp(cum[last]) h + (B * wts)^T x: rows n = ty + 16 i, columns p
    {
      const float decay = expf(cum[rows - 1]);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = hsm[rowN[i] * PP + colP[k]] * decay;
      }
      for (int j = 0; j < rows; ++j) {
        const float w = wts[j];
        float bv[4], xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bv[q] = bsm[j * NP + rowN[q]] * w;
          xv[q] = xsm[j * PP + colP[q]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(bv[i], xv[k], acc[i][k]);
        }
      }
      // No barrier before the writes: a thread reads only the entries it
      // owns, except a thread past the edge (clamped indices), whose
      // results are never stored.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty + 16 * i;
        if (n >= N) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (p < P) hsm[n * PP + p] = acc[i][k];
        }
      }
    }
  }
}

inline size_t ssd_smem(int P, int N) {
  const int Q = kSsdQ;
  return sizeof(float) *
         (static_cast<size_t>(Q) * (P + 1) + 2 * Q * (N + 1) + Q * (Q + 1) +
          static_cast<size_t>(N) * (P + 1) + 3 * Q);
}

struct SsdArgs {
  const void *xs, *dt, *A, *Bm, *Cm;
  void* y;
  int B, S, H, P, N;
  long long s[12];
  cudaStream_t stream;
};

template <typename T>
int launch_ssd(const SsdArgs& a) {
  const size_t smem = ssd_smem(a.P, a.N);
  auto kernel = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.H, a.B);
  kernel<<<grid, kSsdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.xs), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<float*>(a.y), a.S, a.H, a.P,
      a.N, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7],
      a.s[8], a.s[9], a.s[10], a.s[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// xs (B, S, H, P), Bm and Cm (B, S, H, N) of `dtype`, dt (B, S, H) float32,
// read through their batch, sequence and head strides (in elements; the last
// dimension of xs, Bm and Cm is contiguous; a head stride may be 0). A (H,)
// and y (B, S, H, P) are contiguous float32. P and N are at most 64.
// Returns 0, a CUDA error code, or a negative code for arguments the kernel
// does not take.
extern "C" int rt_ssd(const void* xs, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, int B, int S,
                      int H, int P, int N, long long x_sb, long long x_ss,
                      long long x_sh, long long d_sb, long long d_ss,
                      long long d_sh, long long b_sb, long long b_ss,
                      long long b_sh, long long c_sb, long long c_ss,
                      long long c_sh, int dtype, void* stream) {
  using namespace rt;
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || P <= 0 || N <= 0 ||
      P > kSsdMaxDim || N > kSsdMaxDim) {
    return kBadShape;
  }
  const SsdArgs a{xs, dt, A, Bm, Cm, y, B, S, H, P, N,
                  {x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sh, c_sb,
                   c_ss, c_sh},
                  static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return launch_ssd<float>(a);
  if (dtype == kBFloat16) return launch_ssd<__nv_bfloat16>(a);
  return kBadDtype;
}
