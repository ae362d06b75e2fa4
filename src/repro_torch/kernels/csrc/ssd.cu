// Mamba2 SSD (state space dual) scan, chunked, scalar decay per head.
//
//   xs (B, S, H, P), dt (B, S, H) float32, A (H,) float32 < 0,
//   Bm and Cm (B, S, H, N)  ->  y (B, S, H, P) float32
//
// Per head, with h_t the (N, P) state:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t
//
// Both kernels walk over the sequence in tiles of 64 rows: the loop takes
// the place of the TPU kernel's sequential grid dimension, and the state
// stays on the SM from the first tile to the last. Per tile, with cum the
// running sum of dt * A inside the tile:
//   M[i, j] = (C_i . B_j) exp(min(cum_i - cum_j, 0)) dt_j      j <= i, else 0
//   y       = M x + exp(cum) * (C h)
//   h      <- exp(cum[last]) h + (B * (exp(cum[last] - cum) dt))^T x
// The closed form is exact for any tile length, so y does not depend on the
// tile but through rounding; the reference's chunk of 256 would need a
// 256 x 256 float32 tile (256 KB) against the 227 KB a block may have. A
// tile cut short by the end of the sequence runs as if its missing rows had
// dt = 0 and zero inputs, which is what the TPU kernel's padding computes.
// xs, Bm and Cm are read through their batch, sequence and head strides: Bm
// and Cm may have a zero head stride (one group shared by every head), so no
// repeated copy of them is made.
//
// ssd_tc_kernel, for bfloat16 xs, Bm, Cm. The function is bound by bytes on
// an H100 (y alone is float32), so the design moves the products to the
// tensor cores and keeps the loads going while they run:
// - one block of four warps owns a (batch, head, block of PB columns of P):
//   the columns of the state and of y are independent, so splitting P gives
//   more blocks than (batch, head) alone. Warp w owns rows 16w..16w+15 of
//   the tile for C B^T, M x and C h, and rows 16w.. of the state.
// - the four products run as mma.sync m16n8k16 bf16 with float32 sums.
//   C B^T takes C and B as they arrive and is exact. The float32 operands
//   (M; the state h; B scaled by w = exp(cum[last] - cum) dt) are each split
//   into a high and a low bfloat16 and go through two products, which keeps
//   about 16 bits of their mantissa: with mamba2's dt and A the state grows
//   to hundreds and y is a sum of terms that cancel. M never leaves the
//   registers: the sums of C B^T are laid out as the A operand of M x.
// - x, B, C and dt of the next tile are copied by cp.async (16 bytes a
//   thread, zero fill past the sequence and past P, N) into the second of
//   two buffers while this tile computes. The state's float32 master stays
//   in the registers of the warp that owns its rows; its hi/lo halves go
//   through shared memory for C h of the next tile.
// - registers and shared memory are kept to what lets four blocks share an
//   SM (128 registers a thread, 52.5 KB): M is built 16 columns at a time
//   and consumed at once, and B and C rows of 64 are swizzled, not padded.
// A row, stride or base that is no multiple of 16 bytes takes element-wise
// loads into the same buffers instead of cp.async.
//
// ssd_kernel, for float32 xs, Bm, Cm (held to 2e-5, which TF32 could not
// meet): all 256 threads do the products as 16 x 16, each a 4 x 4 piece of
// rows r0 + 16 a and columns c0 + 16 b, float32 FMAs from shared memory,
// with the (N, P) state in shared memory; one block owns one (batch, head).
// The running sum of dt * A is taken in float64: with the reference test's
// dt and A it reaches hundreds within a tile, and in float32 the difference
// of two such sums for neighbouring rows loses ~1e-4 of the decay to
// cancellation, which put y up to 1.8e-4 off a float64 recurrence.
#include "mma.cuh"

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
  extern __shared__ double smem_d[];
  double* cum = smem_d;         // Q
  float* smem = reinterpret_cast<float*>(cum + Q);
  float* xsm = smem;            // Q x PP
  float* bsm = xsm + Q * PP;    // Q x NP
  float* csm = bsm + Q * NP;    // Q x NP
  float* msm = csm + Q * NP;    // Q x QP
  float* hsm = msm + Q * QP;    // N x PP
  float* dts = hsm + N * PP;    // Q
  float* wts = dts + Q;         // Q: exp(cum[last] - cum) dt

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
      double lo = static_cast<double>(dts[tid]) * a_h;
      double hi = static_cast<double>(dts[tid + 32]) * a_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double l = __shfl_up_sync(0xffffffffu, lo, off);
        const double u = __shfl_up_sync(0xffffffffu, hi, off);
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
      const double last = cum[rows - 1];
      if (tid < Q) {
        wts[tid] = tid < rows ? expf(static_cast<float>(last - cum[tid])) * dts[tid]
                              : 0.0f;
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
            m = acc[i][j] *
                expf(static_cast<float>(fmin(cum[ri] - cum[cj], 0.0))) *
                dts[cj];
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
        const float e = expf(static_cast<float>(cum[ri]));
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
      const float decay = expf(static_cast<float>(cum[rows - 1]));
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

// ---- the bfloat16 tensor-core kernel ----------------------------------------

constexpr int kTcThreads = 128;  // four warps, 16 rows of the tile each

// Layout of the tiles in shared memory. Rows of x and of the state's halves
// are padded by 8 elements (16 bytes), and so are rows of B and C below 64
// columns, so the eight rows an ldmatrix reads fall on different banks.
// Rows of 64 columns of B and C are not padded but swizzled: the 16-byte
// chunk k of row r sits at chunk k ^ (r % 8). That keeps a block at 52.5 KB
// for P blocks of 32 and N = 64, so that four blocks share an SM.
template <int PB, int NP>
struct TcLayout {
  static constexpr int XS = PB + 8;                      // x, h row stride
  static constexpr bool kSwizzle = NP == 64;
  static constexpr int NS = kSwizzle ? NP : NP + 8;      // B, C row stride
  static constexpr int kX = 2 * kSsdQ * XS;              // two stages
  static constexpr int kBC = 2 * kSsdQ * NS;             // two stages
  static constexpr int kH = 2 * NP * XS;                 // hi and lo halves
  static constexpr size_t kBytes =
      2 * static_cast<size_t>(kX + 2 * kBC + kH) + 4 * 2 * kSsdQ;

  // offset of element (row, col) of a B or C tile, col a multiple of 8
  __device__ static __forceinline__ int bc(int row, int col) {
    if constexpr (kSwizzle) {
      return row * NS + (((col >> 3) ^ (row & 7)) << 3);
    } else {
      return row * NS + col;
    }
  }
};

template <int PB, int NP>
__global__ void __launch_bounds__(kTcThreads, 4)
    ssd_tc_kernel(const __nv_bfloat16* __restrict__ xs,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const __nv_bfloat16* __restrict__ Bm,
                  const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
                  int S, int H, int P, int N, int n_pblk, int vec,
                  long long x_sb, long long x_ss, long long x_sh,
                  long long d_sb, long long d_ss, long long d_sh,
                  long long b_sb, long long b_ss, long long b_sh,
                  long long c_sb, long long c_ss, long long c_sh) {
  using bf16 = __nv_bfloat16;
  using L = TcLayout<PB, NP>;
  constexpr int Q = kSsdQ;
  constexpr int XS = L::XS;
  constexpr int NS = L::NS;
  constexpr int NT = PB / 8;   // n-tiles of 8 columns of P
  constexpr int KC = NP / 16;  // k-chunks of 16 over the state
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xt = reinterpret_cast<bf16*>(smem_raw);  // [2][Q][XS]
  bf16* bt = xt + L::kX;                         // [2][Q][NS]
  bf16* ct = bt + L::kBC;                        // [2][Q][NS]
  bf16* ht = ct + L::kBC;                        // [hi, lo][NP][XS]
  float* dts = reinterpret_cast<float*>(ht + L::kH);  // [2][Q]

  const int pblk = blockIdx.x % n_pblk;
  const int h = blockIdx.x / n_pblk;
  const int b = blockIdx.y;
  const int p0 = pblk * PB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float a2 = A[h] * kLog2e;  // decays as powers of two

  const bf16* xb = xs + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const bf16* bb = Bm + b * b_sb + h * b_sh;
  const bf16* cb = Cm + b * c_sb + h * c_sh;
  float* yb = y + (static_cast<long long>(b) * S * H + h) * P;
  const long long y_ss = static_cast<long long>(H) * P;

  // x, B, C, dt of the tile at row c0 into buffer `stage`
  auto load_tile = [&](int stage, int c0) {
    bf16* xd = xt + stage * Q * XS;
    bf16* bd = bt + stage * Q * NS;
    bf16* cd = ct + stage * Q * NS;
    if (vec) {
      for (int i = tid; i < Q * (PB / 8); i += kTcThreads) {
        const int r = i / (PB / 8);
        const int k = 8 * (i % (PB / 8));
        const bool ok = c0 + r < S && p0 + k < P;
        cp_async16(xd + r * XS + k, ok ? xb + (c0 + r) * x_ss + p0 + k : xb,
                   ok);
      }
      for (int i = tid; i < Q * (NP / 8); i += kTcThreads) {
        const int r = i / (NP / 8);
        const int k = 8 * (i % (NP / 8));
        const bool ok = c0 + r < S && k < N;
        cp_async16(bd + L::bc(r, k), ok ? bb + (c0 + r) * b_ss + k : bb, ok);
        cp_async16(cd + L::bc(r, k), ok ? cb + (c0 + r) * c_ss + k : cb, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.0f);
      for (int i = tid; i < Q * PB; i += kTcThreads) {
        const int r = i / PB;
        const int k = i % PB;
        const bool ok = c0 + r < S && p0 + k < P;
        xd[r * XS + k] = ok ? xb[(c0 + r) * x_ss + p0 + k] : zero;
      }
      for (int i = tid; i < Q * NP; i += kTcThreads) {
        const int r = i / NP;
        const int k = i % NP;
        const bool ok = c0 + r < S && k < N;
        const int o = L::bc(r, k & ~7) + (k & 7);
        bd[o] = ok ? bb[(c0 + r) * b_ss + k] : zero;
        cd[o] = ok ? cb[(c0 + r) * c_ss + k] : zero;
      }
    }
    if (tid < Q) {
      const bool ok = c0 + tid < S;
      cp_async4(dts + stage * Q + tid, ok ? db + (c0 + tid) * d_ss : db, ok);
    }
    cp_async_commit();
  };

  bf16* Hhi = ht;            // the state as of the tile's first row
  bf16* Hlo = ht + NP * XS;
  for (int i = tid; i < L::kH; i += kTcThreads) {
    ht[i] = __float2bfloat16_rn(0.0f);
  }
  load_tile(0, 0);

  float hacc[NT][4] = {};  // state rows 16 warp + (g, g + 8), float32 master
  const int n_tiles = (S + Q - 1) / Q;
  for (int c = 0; c < n_tiles; ++c) {
    const int st = c & 1;
    const int c0 = c * Q;
    cp_async_wait_all();
    // This tile's buffers and the state are in place, and every read of
    // the other buffer (the last tile's) is done.
    __syncthreads();
    if (c + 1 < n_tiles) load_tile(st ^ 1, c0 + Q);

    const bf16* X = xt + st * Q * XS;
    const bf16* Bt = bt + st * Q * NS;
    const bf16* Ct = ct + st * Q * NS;
    const float* D = dts + st * Q;

    // running sum of dt * A (in powers of two) over the tile's 64 rows, in
    // every warp: rows lane (lo) and lane + 32 (hi)
    const float d_lo = D[lane];
    const float d_hi = D[lane + 32];
    float s_lo = d_lo * a2;
    float s_hi = d_hi * a2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float l = __shfl_up_sync(0xffffffffu, s_lo, off);
      const float u = __shfl_up_sync(0xffffffffu, s_hi, off);
      if (lane >= off) {
        s_lo += l;
        s_hi += u;
      }
    }
    s_hi += __shfl_sync(0xffffffffu, s_lo, 31);
    const float c_last = __shfl_sync(0xffffffffu, s_hi, 31);
    const int i0 = 16 * warp + g;  // this thread's rows i0 and i0 + 8
    const float ci0 = __shfl_sync(0xffffffffu, warp < 2 ? s_lo : s_hi, i0 & 31);
    const float ci1 =
        __shfl_sync(0xffffffffu, warp < 2 ? s_lo : s_hi, (i0 + 8) & 31);
    // per row j = lane (lo) and lane + 32 (hi): the weight of the state
    // update, w_j = 2^(c_last - c_j) dt_j, and the column factor of M below
    // the diagonal chunks, 2^(c_b - c_j) dt_j with c_b the running sum at
    // the last row of j's chunk of 16 (with A < 0, c_b <= c_j: no overflow;
    // the exponents are clamped at 0 as the diagonal's are)
    const float w_lo = exp2f(c_last - s_lo) * d_lo;
    const float w_hi = exp2f(c_last - s_hi) * d_hi;
    const float f_lo = exp2f(fminf(
        __shfl_sync(0xffffffffu, s_lo, lane | 15) - s_lo, 0.0f)) * d_lo;
    const float f_hi = exp2f(fminf(
        __shfl_sync(0xffffffffu, s_hi, lane | 15) - s_hi, 0.0f)) * d_hi;

    // C of the warp's rows as A fragments over k = n, for C B^T and C h
    uint32_t cf[KC][4];
#pragma unroll
    for (int ks = 0; ks < KC; ++ks) {
      ldsm_x4(cf[ks], Ct + L::bc(16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 16 * ks + (lane >> 4) * 8));
    }

    // y1 = M x, one chunk of 16 columns j of M at a time, up to the warp's
    // last row: S = C B^T for the chunk, then M = S 2^min(c_i - c_j, 0) dt_j
    // for j <= i (else 0) as the hi and lo A fragments of M x over k = j
    float y1[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (kc > warp) continue;
      float sacc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KC; ++ks) {
        uint32_t bf[4];
        ldsm_x4(bf, Bt + L::bc(16 * kc + (lane & 7) + (lane >> 4) * 8,
                               16 * ks + ((lane >> 3) & 1) * 8));
        mma16816(sacc[0], cf[ks], bf[0], bf[1]);
        mma16816(sacc[1], cf[ks], bf[2], bf[3]);
      }
      const float src_c = kc < 2 ? s_lo : s_hi;
      uint32_t mhi[4], mlo[4];
      if (kc < warp) {
        // below the diagonal every i > j: 2^(c_i - c_j) = 2^(c_i - c_b)
        // 2^(c_b - c_j), a factor a row times one a column, both <= 1
        const float cb = __shfl_sync(0xffffffffu, src_c, (16 * kc + 15) & 31);
        const float r0 = exp2f(fminf(ci0 - cb, 0.0f));
        const float r1 = exp2f(fminf(ci1 - cb, 0.0f));
        const float src_f = kc < 2 ? f_lo : f_hi;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kc + 8 * half + 2 * t4;
          const float fj0 = __shfl_sync(0xffffffffu, src_f, j & 31);
          const float fj1 = __shfl_sync(0xffffffffu, src_f, (j + 1) & 31);
          // rows g (a[0], a[2]) and g + 8 (a[1], a[3]); columns 8 half on
          split2(sacc[half][0] * r0 * fj0, sacc[half][1] * r0 * fj1,
                 mhi[2 * half], mlo[2 * half]);
          split2(sacc[half][2] * r1 * fj0, sacc[half][3] * r1 * fj1,
                 mhi[2 * half + 1], mlo[2 * half + 1]);
        }
      } else {
        // the diagonal chunk: masked, 2^min(c_i - c_j, 0) element by element
        const float src_d = kc < 2 ? d_lo : d_hi;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kc + 8 * half + 2 * t4;
          const float cj0 = __shfl_sync(0xffffffffu, src_c, j & 31);
          const float cj1 = __shfl_sync(0xffffffffu, src_c, (j + 1) & 31);
          const float dj0 = __shfl_sync(0xffffffffu, src_d, j & 31);
          const float dj1 = __shfl_sync(0xffffffffu, src_d, (j + 1) & 31);
          const float m0 = j <= i0 ? sacc[half][0] * exp2f(fminf(ci0 - cj0, 0.0f)) * dj0 : 0.0f;
          const float m1 = j + 1 <= i0 ? sacc[half][1] * exp2f(fminf(ci0 - cj1, 0.0f)) * dj1 : 0.0f;
          const float m2 = j <= i0 + 8 ? sacc[half][2] * exp2f(fminf(ci1 - cj0, 0.0f)) * dj0 : 0.0f;
          const float m3 = j + 1 <= i0 + 8 ? sacc[half][3] * exp2f(fminf(ci1 - cj1, 0.0f)) * dj1 : 0.0f;
          split2(m0, m1, mhi[2 * half], mlo[2 * half]);
          split2(m2, m3, mhi[2 * half + 1], mlo[2 * half + 1]);
        }
      }
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t xf[4];
        ldsm_x4_t(xf, X + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                          16 * pp + (lane >> 4) * 8);
        mma16816(y1[2 * pp], mhi, xf[0], xf[1]);
        mma16816(y1[2 * pp], mlo, xf[0], xf[1]);
        mma16816(y1[2 * pp + 1], mhi, xf[2], xf[3]);
        mma16816(y1[2 * pp + 1], mlo, xf[2], xf[3]);
      }
    }

    // y2 = C h, then y = y1 + 2^c_i y2
    float y2[NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < KC; ++ks) {
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        const int off = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                        16 * pp + (lane >> 4) * 8;
        uint32_t hf[4], lf[4];
        ldsm_x4_t(hf, Hhi + off);
        ldsm_x4_t(lf, Hlo + off);
        mma16816(y2[2 * pp], cf[ks], hf[0], hf[1]);
        mma16816(y2[2 * pp], cf[ks], lf[0], lf[1]);
        mma16816(y2[2 * pp + 1], cf[ks], hf[2], hf[3]);
        mma16816(y2[2 * pp + 1], cf[ks], lf[2], lf[3]);
      }
    }
    {
      const float e0 = exp2f(ci0);
      const float e1 = exp2f(ci1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = c0 + i0 + 8 * half;
        if (r >= S) continue;
        const float e = half ? e1 : e0;
        float* yrow = yb + r * y_ss;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int p = p0 + 8 * nt + 2 * t4;
          const float v0 = fmaf(e, y2[nt][2 * half], y1[nt][2 * half]);
          const float v1 = fmaf(e, y2[nt][2 * half + 1], y1[nt][2 * half + 1]);
          if ((P & 1) == 0 && p + 1 < P) {
            *reinterpret_cast<float2*>(yrow + p) = make_float2(v0, v1);
          } else {
            if (p < P) yrow[p] = v0;
            if (p + 1 < P) yrow[p + 1] = v1;
          }
        }
      }
    }

    // h = 2^c_last h + (B w)^T x with w_j = 2^(c_last - c_j) dt_j: rows n of
    // the warp, k = j over the tile
    const bool owns_state = 16 * warp < NP;
    if (owns_state) {
      const float decay = exp2f(c_last);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] *= decay;
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        // B^T as A fragments: rows n = 16 warp.., columns j = 16 kc..
        uint32_t bf[4];
        ldsm_x4_t(bf, Bt + L::bc(16 * kc + (lane & 7) + (lane >> 4) * 8,
                                 16 * warp + ((lane >> 3) & 1) * 8));
        const int j = 16 * kc + 2 * t4;
        const float src_w = kc < 2 ? w_lo : w_hi;
        float w[4];  // columns j, j + 1, j + 8, j + 9
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[q] = __shfl_sync(0xffffffffu, src_w,
                             (j + (q & 1) + 8 * (q >> 1)) & 31);
        }
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a[0], a[1]: columns j, j + 1
          const float2 f = unpack2(bf[q]);
          const int wq = 2 * (q >> 1);
          split2(f.x * w[wq], f.y * w[wq + 1], ahi[q], alo[q]);
        }
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          uint32_t xf[4];
          ldsm_x4_t(xf, X + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                            16 * pp + (lane >> 4) * 8);
          mma16816(hacc[2 * pp], ahi, xf[0], xf[1]);
          mma16816(hacc[2 * pp], alo, xf[0], xf[1]);
          mma16816(hacc[2 * pp + 1], ahi, xf[2], xf[3]);
          mma16816(hacc[2 * pp + 1], alo, xf[2], xf[3]);
        }
      }
    }
    __syncthreads();  // every read of the state of this tile is done
    if (owns_state) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (16 * warp + g + 8 * half) * XS + 8 * nt + 2 * t4;
          uint32_t hi, lo;
          split2(hacc[nt][2 * half], hacc[nt][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(Hhi + off) = hi;
          *reinterpret_cast<uint32_t*>(Hlo + off) = lo;
        }
      }
    }
  }
}

inline size_t ssd_smem(int P, int N) {
  const int Q = kSsdQ;
  return sizeof(double) * Q +
         sizeof(float) *
             (static_cast<size_t>(Q) * (P + 1) + 2 * Q * (N + 1) + Q * (Q + 1) +
              static_cast<size_t>(N) * (P + 1) + 2 * Q);
}

struct SsdArgs {
  const void *xs, *dt, *A, *Bm, *Cm;
  void* y;
  int B, S, H, P, N;
  long long s[12];
  cudaStream_t stream;
};

int launch_ssd_f32(const SsdArgs& a) {
  const size_t smem = ssd_smem(a.P, a.N);
  auto kernel = ssd_kernel<float>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.H, a.B);
  kernel<<<grid, kSsdThreads, smem, a.stream>>>(
      static_cast<const float*>(a.xs), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.Bm),
      static_cast<const float*>(a.Cm), static_cast<float*>(a.y), a.S, a.H,
      a.P, a.N, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6],
      a.s[7], a.s[8], a.s[9], a.s[10], a.s[11]);
  return static_cast<int>(cudaGetLastError());
}

// Whether every row of xs, Bm and Cm the tensor-core kernel reads starts on
// 16 bytes: P and N multiples of 8, bases and strides along dimensions of
// more than one element multiples of 16 bytes.
inline bool ssd_rows_aligned(const SsdArgs& a) {
  const auto base_ok = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const auto stride_ok = [](long long stride, int size) {
    return size == 1 || stride % 8 == 0;
  };
  if (a.P % 8 || a.N % 8 || !base_ok(a.xs) || !base_ok(a.Bm) ||
      !base_ok(a.Cm)) {
    return false;
  }
  const int firsts[3] = {0, 6, 9};  // xs, Bm, Cm: batch, sequence, head
  for (int t : firsts) {
    if (!stride_ok(a.s[t], a.B) || !stride_ok(a.s[t + 1], a.S) ||
        !stride_ok(a.s[t + 2], a.H)) {
      return false;
    }
  }
  return true;
}

template <int PB, int NP>
int launch_ssd_tc(const SsdArgs& a) {
  const int n_pblk = (a.P + PB - 1) / PB;
  if (static_cast<long long>(a.H) * n_pblk > 2147483647LL) return kBadShape;
  const size_t smem = TcLayout<PB, NP>::kBytes;
  auto kernel = ssd_tc_kernel<PB, NP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  using bf16 = __nv_bfloat16;
  const dim3 grid(a.H * n_pblk, a.B);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.xs), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const bf16*>(a.Bm),
      static_cast<const bf16*>(a.Cm), static_cast<float*>(a.y), a.S, a.H, a.P,
      a.N, n_pblk, static_cast<int>(ssd_rows_aligned(a)), a.s[0], a.s[1],
      a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7], a.s[8], a.s[9],
      a.s[10], a.s[11]);
  return static_cast<int>(cudaGetLastError());
}

// N padded to 16: the template's NP
template <int PB>
int launch_ssd_tc_n(const SsdArgs& a) {
  switch ((a.N + 15) / 16) {
    case 1: return launch_ssd_tc<PB, 16>(a);
    case 2: return launch_ssd_tc<PB, 32>(a);
    case 3: return launch_ssd_tc<PB, 48>(a);
    case 4: return launch_ssd_tc<PB, 64>(a);
    default: return kBadShape;
  }
}

}  // namespace rt

// xs (B, S, H, P), Bm and Cm (B, S, H, N) of `dtype`, dt (B, S, H) float32,
// read through their batch, sequence and head strides (in elements; the last
// dimension of xs, Bm and Cm is contiguous; a head stride may be 0). A (H,)
// and y (B, S, H, P) are contiguous float32. P and N are at most 64.
// `p_block` is the columns of P a block of the bfloat16 kernel takes (16 or
// 32; kernels/ssd.py, p_block); the float32 kernel takes all of P.
// Returns 0, a CUDA error code, or a negative code for arguments the kernel
// does not take.
extern "C" int rt_ssd(const void* xs, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, int B, int S,
                      int H, int P, int N, long long x_sb, long long x_ss,
                      long long x_sh, long long d_sb, long long d_ss,
                      long long d_sh, long long b_sb, long long b_ss,
                      long long b_sh, long long c_sb, long long c_ss,
                      long long c_sh, int dtype, int p_block, void* stream) {
  using namespace rt;
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || P <= 0 || N <= 0 ||
      P > kSsdMaxDim || N > kSsdMaxDim) {
    return kBadShape;
  }
  const SsdArgs a{xs, dt, A, Bm, Cm, y, B, S, H, P, N,
                  {x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sh, c_sb,
                   c_ss, c_sh},
                  static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return launch_ssd_f32(a);
  if (dtype != kBFloat16) return kBadDtype;
  if (p_block == 16) return launch_ssd_tc_n<16>(a);
  if (p_block == 32) return launch_ssd_tc_n<32>(a);
  return kBadShape;
}
