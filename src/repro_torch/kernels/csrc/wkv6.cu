// RWKV6 WKV recurrence, chunked, with the incoming and the final state.
//
//   r, k, v (B, S, H, K), lw (B, S, H, K) float32 <= 0, u (H, K) float32,
//   state_in (B, H, K, K) float32 or null (zeros)
//     ->  y (B, S, H, K) float32, state_out (B, H, K, K) float32
//
// Per head, with S_t the (K, K) state (key channel x value channel):
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//
// One block owns one (batch, head) and walks over the sequence in chunks of
// 16 rows: the loop takes the place of the TPU kernel's sequential grid
// dimension, and the state stays in shared memory from the first chunk to
// the last. Per chunk, with cum the running sum of lw down each channel
// inside the chunk and cum_prev[t] = cum[t-1]:
//   A[t, j] = sum_c r_t[c] k_j[c] exp(min(cum_prev[t, c] - cum[j, c], 0))  j < t
//   A[t, t] = r_t . (u * k_t)
//   y       = A V + (r * exp(cum_prev)) S
//   S      <- diag(exp(cum[last])) S + (k * exp(cum[last] - cum))^T V
// Every exponent is <= 0. A chunk cut short by the end of the sequence runs
// over its real rows only, which is what the TPU kernel's padding with
// log w = 0 and zero r, k, v computes. r, k and v are float32 or bfloat16;
// all arithmetic is float32. The arrays are read through their batch,
// sequence and head strides, so no moved or padded copy is made.
//
// state_in may be state_out (the decode path updates its cache in place):
// each block reads its own state whole before it writes it.
#include "common.cuh"

namespace rt {

constexpr int kWkvQ = 16;           // rows of a chunk
constexpr int kWkvThreads = 256;

template <typename T, int K>
__global__ void __launch_bounds__(kWkvThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* state_in,
                float* state_out, float* __restrict__ y, int S, int H,
                long long r_sb, long long r_ss, long long r_sh, long long k_sb,
                long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                long long v_sh, long long w_sb, long long w_ss,
                long long w_sh) {
  constexpr int Q = kWkvQ;
  constexpr int KP = K + 1;  // padded rows: a column walk hits 32 banks
  __shared__ float rs[Q][KP], ks[Q][KP], vs[Q][KP];
  __shared__ float cs[Q][KP];   // lw, then its running sum
  __shared__ float re[Q][KP];   // r * exp(cum_prev)
  __shared__ float kt[Q][KP];   // k * exp(cum[last] - cum)
  __shared__ float As[Q][Q + 1];
  __shared__ float Ss[K][KP];
  __shared__ float dec[K];      // exp(cum[last])
  __shared__ float us[K];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  const long long sbase = (static_cast<long long>(b) * H + h) * K * K;
  for (int i = tid; i < K * K; i += kWkvThreads) {
    Ss[i / K][i % K] = state_in ? state_in[sbase + i] : 0.0f;
  }
  for (int c = tid; c < K; c += kWkvThreads) us[c] = u[h * K + c];

  const T* rb = r + b * r_sb + h * r_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* wb = lw + b * w_sb + h * w_sh;
  // y is contiguous (B, S, H, K)
  float* yb = y + (static_cast<long long>(b) * S * H + h) * K;
  const long long y_ss = static_cast<long long>(H) * K;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();  // the state is in place; the last chunk is done with the tiles
    for (int i = tid; i < rows * K; i += kWkvThreads) {
      const int t = i / K;
      const int c = i % K;
      const long long pos = c0 + t;
      rs[t][c] = to_float(rb[pos * r_ss + c]);
      ks[t][c] = to_float(kb[pos * k_ss + c]);
      vs[t][c] = to_float(vb[pos * v_ss + c]);
      cs[t][c] = wb[pos * w_ss + c];
    }
    __syncthreads();
    for (int c = tid; c < K; c += kWkvThreads) {
      float run = 0.0f;
      for (int t = 0; t < rows; ++t) {
        run += cs[t][c];
        cs[t][c] = run;
      }
      dec[c] = expf(run);
    }
    __syncthreads();

    for (int i = tid; i < Q * Q; i += kWkvThreads) {
      const int t = i / Q;
      const int j = i % Q;
      float acc = 0.0f;
      if (t < rows && j < t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c) {
          const float e = fminf(cs[t - 1][c] - cs[j][c], 0.0f);
          acc = fmaf(rs[t][c] * ks[j][c], expf(e), acc);
        }
      } else if (t < rows && j == t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c) acc = fmaf(rs[t][c] * us[c], ks[t][c], acc);
      }
      As[t][j] = acc;
    }
    for (int i = tid; i < rows * K; i += kWkvThreads) {
      const int t = i / K;
      const int c = i % K;
      const float prev = t > 0 ? cs[t - 1][c] : 0.0f;
      re[t][c] = rs[t][c] * expf(prev);
      kt[t][c] = ks[t][c] * expf(cs[rows - 1][c] - cs[t][c]);
    }
    __syncthreads();

    // y: row t, value channel vv
    for (int i = tid; i < rows * K; i += kWkvThreads) {
      const int t = i / K;
      const int vv = i % K;
      float acc = 0.0f;
      for (int j = 0; j <= t; ++j) acc = fmaf(As[t][j], vs[j][vv], acc);
#pragma unroll 8
      for (int c = 0; c < K; ++c) acc = fmaf(re[t][c], Ss[c][vv], acc);
      yb[(c0 + t) * y_ss + vv] = acc;
    }
    __syncthreads();  // every read of the state is done

    for (int i = tid; i < K * K; i += kWkvThreads) {
      const int c = i / K;
      const int vv = i % K;
      float acc = Ss[c][vv] * dec[c];
      for (int j = 0; j < rows; ++j) acc = fmaf(kt[j][c], vs[j][vv], acc);
      Ss[c][vv] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * K; i += kWkvThreads) {
    state_out[sbase + i] = Ss[i / K][i % K];
  }
}

struct WkvArgs {
  const void *r, *k, *v;
  const float *lw, *u, *state_in;
  float *state_out, *y;
  int B, S, H;
  long long s[12];
  cudaStream_t stream;
};

template <typename T, int K>
int launch_wkv6(const WkvArgs& a) {
  const dim3 grid(a.H, a.B);
  wkv6_kernel<T, K><<<grid, kWkvThreads, 0, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lw, a.u, a.state_in, a.state_out, a.y,
      a.S, a.H, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6],
      a.s[7], a.s[8], a.s[9], a.s[10], a.s[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wkv6_k(const WkvArgs& a, int K) {
  switch (K) {
    case 8:
      return launch_wkv6<T, 8>(a);
    case 16:
      return launch_wkv6<T, 16>(a);
    case 32:
      return launch_wkv6<T, 32>(a);
    case 64:
      return launch_wkv6<T, 64>(a);
    default:
      return kBadShape;
  }
}

}  // namespace rt

// r, k, v of `dtype` and lw float32, all (B, S, H, K), read through their
// batch, sequence and head strides (in elements; the last dimension is
// contiguous). u (H, K), state_in and state_out (B, H, K, K) and y
// (B, S, H, K) are contiguous float32; state_in may be null (zeros) and may
// be state_out. Returns 0, a CUDA error code, or a negative code for
// arguments the kernel does not take.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v,
                       const void* lw, const void* u, const void* state_in,
                       void* state_out, void* y, int B, int S, int H, int K,
                       long long r_sb, long long r_ss, long long r_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long w_sb, long long w_ss, long long w_sh,
                       int dtype, void* stream) {
  using namespace rt;
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535) return kBadShape;
  const WkvArgs a{r,
                  k,
                  v,
                  static_cast<const float*>(lw),
                  static_cast<const float*>(u),
                  static_cast<const float*>(state_in),
                  static_cast<float*>(state_out),
                  static_cast<float*>(y),
                  B,
                  S,
                  H,
                  {r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb,
                   w_ss, w_sh},
                  static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return launch_wkv6_k<float>(a, K);
  if (dtype == kBFloat16) return launch_wkv6_k<__nv_bfloat16>(a, K);
  return kBadDtype;
}
