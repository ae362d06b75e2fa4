// RWKV6 WKV recurrence, chunked, with the incoming and the final state.
//
//   r, k, v (B, S, H, K), lw (B, S, H, K) float32 <= 0, u (H, K) float32,
//   state_in (B, H, K, K) float32 or null (zeros)
//     ->  y (B, S, H, K) float32, state_out (B, H, K, K) float32
//
// Per head, with S_t the (K, K) state (key channel x value channel):
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//
// Both kernels walk over the sequence in chunks of 16 rows: the loop takes
// the place of the TPU kernel's sequential grid dimension, and the state
// stays on the SM from the first chunk to the last. Per chunk, with cum the
// running sum of lw down each channel inside the chunk and
// cum_prev[t] = cum[t-1]:
//   A[t, j] = sum_c r_t[c] k_j[c] exp(min(cum_prev[t, c] - cum[j, c], 0))  j < t
//   A[t, t] = r_t . (u * k_t)
//   y       = A V + (r * exp(cum_prev)) S
//   S      <- diag(exp(cum[last])) S + (k * exp(cum[last] - cum))^T V
// Every exponent is <= 0. A chunk cut short by the end of the sequence runs
// over its real rows only, which is what the TPU kernel's padding with
// log w = 0 and zero r, k, v computes. All arithmetic is float32. The
// arrays are read through their batch, sequence and head strides, so no
// moved or padded copy is made. state_in may be state_out (the decode path
// updates its cache in place): each block reads its own part of the state
// whole before it writes it.
//
// wkv6_kernel, for float32 r, k, v (held to 1e-4 / 5e-4): one block of 256
// threads owns a (batch, head), keeps the state in shared memory, and does
// every product as float32 FMAs from shared memory.
//
// wkv6_bf16_kernel, for bfloat16 r, k, v. At rwkv6-7b's prefill shape the
// function is bound by bytes on an H100 (0.47 GB, y and lw in float32,
// against 10.2 GFLOP); the float32 design does those 10 GFLOP as FMAs from
// shared memory. This one:
// - one block of K / 8 warps (four at least) owns a (batch, head): warp w
//   computes columns 8w..8w+7 of y. Splitting the value columns over two
//   blocks (columns of the state and of y are independent) doubles the
//   grid but computes each chunk's A twice, and measured 2x slower.
// - A stays exact: each (t, j, channel) takes its own 2^min(e, 0) in
//   float32, with e = cum_prev[t] - cum[j] summed directly as
//   lw[j + 1] + .. + lw[t - 1] while a lane walks j down from t - 1, so no
//   difference of two running sums loses it to cancellation and A needs
//   no pass of its own before it. Warp w takes the rows w and 15 - w in one
//   walk of 15 steps with no branch (each lane K / 32 of the channels), so
//   that every warp has the same work; the sums over channels are reduced
//   by shuffles.
// - the two K x K products run on the tensor cores, mma.sync m16n8k16 bf16
//   with float32 sums: r~ S with r~ = r 2^cum_prev, and the update k~^T V
//   with k~ = k 2^(cum[last] - cum). Every decay in them is <= 1, so
//   |r~| <= |r| and |k~| <= |k|. The float32 operands (r~, k~, the state)
//   are each split into a high and a low bfloat16 half, which keeps about
//   16 bits of their mantissa: r~ S takes hi hi + hi lo + lo hi, k~^T V
//   takes k~ hi + lo against V exact in bf16, and A V, with A computed
//   exactly, takes A hi + lo against V.
// - the state's float32 master stays in registers, in the mma accumulator
//   layout: warp w owns key rows 16 (w % 4).. and half (w / 4) of the
//   columns; its hi/lo halves go through shared memory for the next
//   chunk's r~ S, and a block reads and writes only its own (batch, head)
//   of the state, so the in-place decode is free of races.
// - r, k, v (bf16) and lw (f32) of the next chunk are copied by cp.async
//   (16 bytes a thread, zero fill past the sequence) into the second of two
//   buffers while this chunk computes; a row, stride or base that is no
//   multiple of 16 bytes takes element-wise loads into the same buffers.
#include "mma.cuh"

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


// ---- the bfloat16 kernel ----------------------------------------------------

// Warps of a block: one n-tile of 8 columns of y each, at least four.
template <int K>
struct WkvWarps {
  static constexpr int n = K > 32 ? K / 8 : 4;
};

// Shared memory of wkv6_bf16_kernel, in bytes from the start: two stages of
// the r, k, v and lw tiles, then the chunk's work arrays. Rows of the v tile
// and of the bf16 halves of r~, k~ and the state are padded by 8 elements,
// so that the eight rows an ldmatrix reads fall on different banks.
template <int K>
struct WkvLayout {
  static constexpr int Q = kWkvQ;
  static constexpr int KP = K < 16 ? 16 : K;  // channels, padded to 16
  static constexpr int VS = K + 8;            // v tile and state row (bf16)
  static constexpr int RS = KP + 8;           // r~, k~ halves row (bf16)
  static constexpr int AS = Q + 8;            // A halves row (bf16)
  static constexpr int kR = 0;                       // bf16 [2][Q][K]
  static constexpr int kK = kR + 2 * Q * K * 2;      // bf16 [2][Q][K]
  static constexpr int kV = kK + 2 * Q * K * 2;      // bf16 [2][Q][VS]
  static constexpr int kW = kV + 2 * Q * VS * 2;     // f32 [2][Q][K]
  static constexpr int kRT = kW + 2 * Q * K * 4;     // bf16 [hi, lo][Q][RS] r~
  static constexpr int kKT = kRT + 2 * Q * RS * 2;   // bf16 [hi, lo][Q][RS] k~
  static constexpr int kS = kKT + 2 * Q * RS * 2;    // bf16 [hi, lo][KP][VS] state
  static constexpr int kA = kS + 2 * KP * VS * 2;    // bf16 [hi, lo][Q][AS] A
  static constexpr int kDec = kA + 2 * Q * AS * 2;   // f32 [KP]
  static constexpr int kBytes = kDec + KP * 4;
};

// One step of reduce_scatter16: lanes with bit O set keep the upper O of
// the 2 O values, the others the lower, each adding its partner's half.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[16], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[0..15] of the lanes l of a half warp (l % 16), summed over the half
// warp and scattered: v[0] of lane l then holds the sum of v[l % 16].
// (Every index is a constant, so v stays in registers.)
__device__ __forceinline__ void reduce_scatter16(float (&v)[16], int lane) {
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
}

// N consecutive bfloat16 or float32 from shared memory (N in 1, 2, the
// address a multiple of N elements), as floats.
template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N == 2) {
    const float2 a = unpack2(*reinterpret_cast<const uint32_t*>(p));
    o[0] = a.x;
    o[1] = a.y;
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x;
    o[1] = a.y;
  } else {
    o[0] = p[0];
  }
}

template <int K>
__global__ void __launch_bounds__(32 * WkvWarps<K>::n, 16 / WkvWarps<K>::n)
    wkv6_bf16_kernel(const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ lw, const float* __restrict__ u,
                     const float* state_in, float* state_out,
                     float* __restrict__ y, int S, int H, int vec,
                     long long r_sb, long long r_ss, long long r_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long w_sb, long long w_ss, long long w_sh) {
  using bf16 = __nv_bfloat16;
  using L = WkvLayout<K>;
  constexpr int Q = kWkvQ;
  constexpr int KP = L::KP;
  constexpr int VS = L::VS;
  constexpr int RS = L::RS;
  constexpr int AS = L::AS;
  constexpr int NW = WkvWarps<K>::n;
  constexpr int T = 32 * NW;
  constexpr int NT = K / 8;                     // n-tiles of 8 value columns
  constexpr int NTW = NT * 4 / NW;              // of them in a warp's state
  constexpr int NP = 8 / NW;                    // pairs of rows a warp takes in A
  constexpr int CPG = K >= 32 ? K / 32 : 1;     // channels of a lane in A
  constexpr int NCG = K / CPG;                  // lanes of a warp in A
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* rtl = reinterpret_cast<bf16*>(smem_raw + L::kR);
  bf16* ktl = reinterpret_cast<bf16*>(smem_raw + L::kK);
  bf16* vtl = reinterpret_cast<bf16*>(smem_raw + L::kV);
  float* wtl = reinterpret_cast<float*>(smem_raw + L::kW);
  bf16* r_hi = reinterpret_cast<bf16*>(smem_raw + L::kRT);
  bf16* r_lo = r_hi + Q * RS;
  bf16* k_hi = reinterpret_cast<bf16*>(smem_raw + L::kKT);
  bf16* k_lo = k_hi + Q * RS;
  bf16* s_hi = reinterpret_cast<bf16*>(smem_raw + L::kS);
  bf16* s_lo = s_hi + KP * VS;
  bf16* a_hi = reinterpret_cast<bf16*>(smem_raw + L::kA);
  bf16* a_lo = a_hi + Q * AS;
  float* dec = reinterpret_cast<float*>(smem_raw + L::kDec);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const bf16* rb = r + b * r_sb + h * r_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const float* wb = lw + b * w_sb + h * w_sh;
  // y is contiguous (B, S, H, K)
  float* yb = y + (static_cast<long long>(b) * S * H + h) * K;
  const long long y_ss = static_cast<long long>(H) * K;
  const long long sbase = (static_cast<long long>(b) * H + h) * K * K;

  // r, k, v, lw of the chunk at row c0 into buffer `stage`
  auto load_chunk = [&](int stage, int c0) {
    bf16* rd = rtl + stage * Q * K;
    bf16* kd = ktl + stage * Q * K;
    bf16* vd = vtl + stage * Q * VS;
    float* wd = wtl + stage * Q * K;
    if (vec) {
      for (int i = tid; i < Q * (K / 8); i += T) {
        const int row = i / (K / 8);
        const int c = 8 * (i % (K / 8));
        const bool ok = c0 + row < S;
        const long long pos = c0 + row;
        cp_async16(rd + row * K + c, ok ? rb + pos * r_ss + c : rb, ok);
        cp_async16(kd + row * K + c, ok ? kb + pos * k_ss + c : kb, ok);
        cp_async16(vd + row * VS + c, ok ? vb + pos * v_ss + c : vb, ok);
      }
      for (int i = tid; i < Q * (K / 4); i += T) {
        const int row = i / (K / 4);
        const int c = 4 * (i % (K / 4));
        const bool ok = c0 + row < S;
        cp_async16(wd + row * K + c, ok ? wb + (c0 + row) * w_ss + c : wb, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.0f);
      for (int i = tid; i < Q * K; i += T) {
        const int row = i / K;
        const int c = i % K;
        const bool ok = c0 + row < S;
        const long long pos = c0 + row;
        rd[i] = ok ? rb[pos * r_ss + c] : zero;
        kd[i] = ok ? kb[pos * k_ss + c] : zero;
        vd[row * VS + c] = ok ? vb[pos * v_ss + c] : zero;
        wd[i] = ok ? wb[pos * w_ss + c] : 0.0f;
      }
    }
    cp_async_commit();
  };

  // padded channels (K < 16) of r~ and k~ stay zero, and so does the decay
  // of padded state rows
  for (int i = tid; i < 2 * Q * RS; i += T) {
    r_hi[i] = __float2bfloat16_rn(0.0f);
    k_hi[i] = __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < KP; i += T) dec[i] = 0.0f;

  // this lane's channels in A and their bonus
  const int cc = (lane < NCG ? lane : NCG - 1) * CPG;
  const bool act = lane < NCG;
  float uu[CPG];
#pragma unroll
  for (int i = 0; i < CPG; ++i) uu[i] = act ? u[h * K + cc + i] : 0.0f;

  // the state: warp w owns key rows 16 (w % 4) + g and 16 (w % 4) + g + 8,
  // value columns n0 + 8 nt + 2 t4 and the next
  const int rg = warp & 3;
  const bool owner = 16 * rg < KP;
  const int row0 = 16 * rg + g;
  const int n0 = 8 * NTW * (warp >> 2);
  float sacc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      const int col = n0 + 8 * nt + 2 * t4;
      float2 s2 = make_float2(0.0f, 0.0f);
      if (owner && state_in != nullptr && row < K) {
        s2 = *reinterpret_cast<const float2*>(state_in + sbase + row * K + col);
      }
      sacc[nt][2 * half] = s2.x;
      sacc[nt][2 * half + 1] = s2.y;
      if (owner) {
        uint32_t hi, lo;
        split2(s2.x, s2.y, hi, lo);
        *reinterpret_cast<uint32_t*>(s_hi + row * VS + col) = hi;
        *reinterpret_cast<uint32_t*>(s_lo + row * VS + col) = lo;
      }
    }
  }
  load_chunk(0, 0);

  const int n_chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int st = ci & 1;
    const int c0 = ci * Q;
    const int rows = min(Q, S - c0);
    cp_async_wait_all();
    // This chunk's tiles and the state are in place, and every read of the
    // other buffer (the last chunk's) is done.
    __syncthreads();
    if (ci + 1 < n_chunks) load_chunk(st ^ 1, c0 + Q);
    const bf16* R = rtl + st * Q * K;
    const bf16* Kt = ktl + st * Q * K;
    const bf16* V = vtl + st * Q * VS;
    const float* W = wtl + st * Q * K;

    // running sum of lw down channel c = tid % K, over all rows, and r~,
    // k~ (as hi and lo halves) of rows t = tid / K, + T / K, ..; the decay
    // of the chunk. Every thread adds the rows in the same order, so the
    // sums agree across threads.
    {
      constexpr int PARTS = T / K;
      const int c = tid % K;
      const int part = tid / K;
      float cum[Q];
#pragma unroll
      for (int t = 0; t < Q; ++t) cum[t] = W[t * K + c];
#pragma unroll
      for (int t = 1; t < Q; ++t) cum[t] += cum[t - 1];
      const float last = cum[Q - 1] * kLog2e;
      if (part == 0) dec[c] = ex2(last);
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        if (t % PARTS != part) continue;
        const float prev = t > 0 ? cum[t - 1] * kLog2e : 0.0f;
        const float re = to_float(R[t * K + c]) * ex2(prev);
        const float ke = to_float(Kt[t * K + c]) * ex2(last - cum[t] * kLog2e);
        const bf16 rh = __float2bfloat16_rn(re);
        const bf16 kh = __float2bfloat16_rn(ke);
        r_hi[t * RS + c] = rh;
        r_lo[t * RS + c] = __float2bfloat16_rn(re - __bfloat162float(rh));
        k_hi[t * RS + c] = kh;
        k_lo[t * RS + c] = __float2bfloat16_rn(ke - __bfloat162float(kh));
      }
    }

    // A: warp w takes the rows t = w + NW p and 15 - t, each lane K / 32
    // channels of them, in one walk of 15 steps i: row t's pairs (t, j) for
    // j = t - 1 down to 0, then row 15 - t's for j = 14 - t down to 0. Step
    // i is pair slot i; the exponent cum_prev[row] - cum[j] =
    // lw[j + 1] + .. + lw[row - 1] is summed as the walk goes down a row (no
    // difference of two running sums, so no cancellation). Every warp takes
    // 15 steps, and the row in a step is the same across the warp: no
    // branch. Then the warp sums over channels, and writes A[t, .] and
    // A[15 - t, .], with the bonus r . (u * k) on their diagonals.
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int t = warp + NW * p;
      const int tb = Q - 1 - t;
      if (t >= rows && tb >= rows) continue;  // both rows past the sequence
      float ra[CPG], rb_[CPG], d2[CPG], a[Q];
      lds(R + t * K + cc, ra);
      lds(R + tb * K + cc, rb_);
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        if (!act) ra[c] = rb_[c] = 0.0f;
        d2[c] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) a[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < Q - 1; ++i) {
        const bool first = i < t;
        const int m = first ? i : i - t;      // step down its row
        const int j = first ? t - 1 - i : Q - 2 - i;
        float kj[CPG], wj[CPG];
        lds(Kt + j * K + cc, kj);
        lds(W + (j + 1) * K + cc, wj);
#pragma unroll
        for (int c = 0; c < CPG; ++c) {
          d2[c] = m == 0 ? 0.0f : fmaf(wj[c], kLog2e, d2[c]);
          const float e = ex2(fminf(d2[c], 0.0f));
          a[i] = fmaf((first ? ra[c] : rb_[c]) * kj[c], e, a[i]);
        }
      }
      // the bonus of row tb in the free slot 15, of row t over the warp
      float kt_[CPG];
      lds(Kt + tb * K + cc, kt_);
#pragma unroll
      for (int c = 0; c < CPG; ++c) a[Q - 1] = fmaf(rb_[c] * uu[c], kt_[c], a[Q - 1]);
      lds(Kt + t * K + cc, kt_);
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < CPG; ++c) d = fmaf(ra[c] * uu[c], kt_[c], d);
#pragma unroll
      for (int i = 0; i < Q; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], 16);
      d += __shfl_xor_sync(0xffffffffu, d, 16);
      d += __shfl_xor_sync(0xffffffffu, d, 8);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      reduce_scatter16(a, lane);
      // lanes 0..15: slot s: row t's A[t, t - 1 - s] (s < t), row tb's
      // A[tb, 14 - s] (t <= s < 15), tb's bonus (s = 15). Lanes 16 + e:
      // row t's bonus (e = 0) and zeros A[t, t + e] (e < 16 - t), then
      // zeros A[tb, e].
      const int s2 = lane & (Q - 1);
      int row, j;
      float x;
      if (lane < Q) {
        row = s2 < t ? t : tb;
        j = s2 < t ? t - 1 - s2 : (s2 < Q - 1 ? Q - 2 - s2 : tb);
        x = a[0];
      } else {
        row = s2 < Q - t ? t : tb;
        j = s2 < Q - t ? t + s2 : s2;
        x = s2 == 0 ? d : 0.0f;
      }
      const bf16 xh = __float2bfloat16_rn(x);
      a_hi[row * AS + j] = xh;
      a_lo[row * AS + j] = __float2bfloat16_rn(x - __bfloat162float(xh));
    }
    __syncthreads();

    // S <- diag(2^cum[last]) S + k~^T V over the warp's rows and columns
    if (owner) {
      const float dg = dec[row0];
      const float dg8 = dec[row0 + 8];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        sacc[nt][0] *= dg;
        sacc[nt][1] *= dg;
        sacc[nt][2] *= dg8;
        sacc[nt][3] *= dg8;
      }
      // k~^T as A fragments (rows: the warp's key channels, k = the chunk's
      // rows), hi and lo; V exact in bf16
      const int a_off = ((lane & 7) + (lane >> 4) * 8) * RS + 16 * rg +
                        ((lane >> 3) & 1) * 8;
      uint32_t kh[4], kl[4];
      ldsm_x4_t(kh, k_hi + a_off);
      ldsm_x4_t(kl, k_lo + a_off);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint32_t vf[2];
        ldsm_x2_t(vf, V + ((lane & 7) + ((lane >> 3) & 1) * 8) * VS + n0 + 8 * nt);
        mma16816(sacc[nt], kh, vf[0], vf[1]);
        mma16816(sacc[nt], kl, vf[0], vf[1]);
      }
    }

    // y = A V + r~ S: warp w takes n-tile w; rows g and g + 8, columns
    // 8 w + 2 t4 and the next. All on the tensor cores: A V as A hi V +
    // A lo V (V exact in bf16), r~ S as hi hi + hi lo + lo hi, each product
    // into a sum of its own so that none waits on the one before.
    for (int nt = warp; nt < NT; nt += NW) {
      const int col = 8 * nt + 2 * t4;
      const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8);
      float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float hl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float lh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      {
        uint32_t ah[4], al[4], vf[2];
        ldsm_x4(ah, a_hi + a_off * AS + (lane >> 4) * 8);
        ldsm_x4(al, a_lo + a_off * AS + (lane >> 4) * 8);
        ldsm_x2_t(vf, V + a_off * VS + 8 * nt);
        mma16816(av, ah, vf[0], vf[1]);
        mma16816(hl, al, vf[0], vf[1]);
      }
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        ldsm_x4(ah, r_hi + a_off * RS + 16 * ks + (lane >> 4) * 8);
        ldsm_x4(al, r_lo + a_off * RS + 16 * ks + (lane >> 4) * 8);
        ldsm_x2_t(bh, s_hi + (16 * ks + a_off) * VS + 8 * nt);
        ldsm_x2_t(bl, s_lo + (16 * ks + a_off) * VS + 8 * nt);
        mma16816(hh, ah, bh[0], bh[1]);
        mma16816(hl, ah, bl[0], bl[1]);
        mma16816(lh, al, bh[0], bh[1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = g + 8 * half;
        if (t < rows) {
          const int e = 2 * half;
          *reinterpret_cast<float2*>(yb + (c0 + t) * y_ss + col) =
              make_float2(av[e] + (hh[e] + (hl[e] + lh[e])),
                          av[e + 1] + (hh[e + 1] + (hl[e + 1] + lh[e + 1])));
        }
      }
    }
    __syncthreads();  // every read of the state's halves is done
    if (owner) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (row0 + 8 * half) * VS + n0 + 8 * nt + 2 * t4;
          uint32_t hi, lo;
          split2(sacc[nt][2 * half], sacc[nt][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
        }
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row < K) {
          *reinterpret_cast<float2*>(state_out + sbase + row * K + n0 +
                                     8 * nt + 2 * t4) =
              make_float2(sacc[nt][2 * half], sacc[nt][2 * half + 1]);
        }
      }
    }
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

// Whether every row of r, k, v and lw the bfloat16 kernel reads starts on
// 16 bytes: bases, and strides along dimensions of more than one element,
// multiples of 16 bytes (K is a multiple of 8).
inline bool wkv6_rows_aligned(const WkvArgs& a) {
  const auto base_ok = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!base_ok(a.r) || !base_ok(a.k) || !base_ok(a.v) || !base_ok(a.lw)) {
    return false;
  }
  const int sizes[3] = {a.B, a.S, a.H};
  for (int t = 0; t < 12; ++t) {
    const long long per16 = t < 9 ? 8 : 4;  // bf16 r, k, v; float32 lw
    if (sizes[t % 3] > 1 && a.s[t] % per16) return false;
  }
  return true;
}

template <int K>
int launch_wkv6_bf16(const WkvArgs& a) {
  using bf16 = __nv_bfloat16;
  const size_t smem = WkvLayout<K>::kBytes;
  auto kernel = wkv6_bf16_kernel<K>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.H, a.B);
  kernel<<<grid, 32 * WkvWarps<K>::n, smem, a.stream>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lw, a.u, a.state_in, a.state_out, a.y,
      a.S, a.H, static_cast<int>(wkv6_rows_aligned(a)), a.s[0], a.s[1],
      a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7], a.s[8], a.s[9],
      a.s[10], a.s[11]);
  return static_cast<int>(cudaGetLastError());
}

int launch_wkv6_f32(const WkvArgs& a, int K) {
  switch (K) {
    case 8:
      return launch_wkv6<float, 8>(a);
    case 16:
      return launch_wkv6<float, 16>(a);
    case 32:
      return launch_wkv6<float, 32>(a);
    case 64:
      return launch_wkv6<float, 64>(a);
    default:
      return kBadShape;
  }
}

int launch_wkv6_bf16_k(const WkvArgs& a, int K) {
  switch (K) {
    case 8:
      return launch_wkv6_bf16<8>(a);
    case 16:
      return launch_wkv6_bf16<16>(a);
    case 32:
      return launch_wkv6_bf16<32>(a);
    case 64:
      return launch_wkv6_bf16<64>(a);
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
  if (dtype == kFloat32) return launch_wkv6_f32(a, K);
  if (dtype == kBFloat16) return launch_wkv6_bf16_k(a, K);
  return kBadDtype;
}
