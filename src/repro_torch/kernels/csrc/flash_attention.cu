// Softmax attention with an online softmax: the score matrix never reaches
// device memory.
//
//   q (B, Sq, H, D), k and v (B, Skv, Hkv, D)  ->  out (B, Sq, H, D)
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention). Query head h reads kv head h / (H / Hkv). The causal
// mask is qpos >= kpos, aligned top-left when Sq != Skv. A row with no
// visible key gives zeros. Inputs are float32 or bfloat16; the running
// maximum, the denominator and the accumulator are float32; the output has
// the inputs' type. q, k and v are read through their strides, so no
// transposed or padded copy is made. Under the causal mask the walk over the
// keys stops at the diagonal, and the query tiles with the longest walks
// start first.
//
// The function is bound by operations, so the two element types get the
// arithmetic that suits them:
//
//  * bfloat16 (flash_attention_wgmma_kernel), for Hopper: one block owns 128
//    query rows of one (batch, head). A producer warp loads Q once and then
//    K and V tiles of 128 keys by TMA into a ring of stages in shared
//    memory (64 keys at D = 192, where a stage of 128 would leave room for
//    one), each stage guarded by a full and an empty mbarrier; it gives
//    its registers to the two consumer warpgroups (setmaxnreg), which own
//    64 query rows each. A consumer computes S = Q K^T with wgmma
//    m64n128k16 (m64n64k16 at D = 192; Q and K from shared memory, both
//    K-major), the online
//    softmax in exp2 with scale * log2(e) folded into one multiply (masks
//    only on tiles that cross the diagonal or the end of Skv), and
//    O += P V with wgmma whose A operand is the score accumulator itself,
//    rounded to bfloat16 in registers (as the plain full_attention rounds
//    the probabilities before P V), and whose B operand is the V tile read
//    MN-major through the transpose bit. A consumer issues tile t's S
//    together with tile t - 1's P V and runs tile t's softmax while P V is
//    on the tensor cores; the two consumers take turns to issue (two named
//    barriers), so that one's softmax runs beside the other's products.
//    The softmax's exp2 (16 a clock an SM) costs about half the time of the
//    products of a tile at D = 128. Tiles are 64 columns (128 bytes)
//    wide with the 128-byte swizzle; TMA fills columns past D and rows past
//    S with zeros, so every D of HEAD_DIMS takes the same code: D = 112 runs
//    7 k-steps of Q K^T and P V with N = 112, D = 192 (MLA's 128 + 64) 12
//    k-steps and P V with N = 192 over three 64-column boxes of V.
//  * float32 (flash_attention_fma_kernel): plain float32 FMAs from
//    shared-memory tiles, exact to rounding (the parity checks at 2e-5 rule
//    out TF32). 256 threads; each keeps a 4x4 piece of the scores and a
//    4 x (D/16) piece of the output in registers, rows are reduced with
//    shuffles across the 16 threads that share them, and K and V take turns
//    in one buffer so that two blocks fit on a multiprocessor, 64 query rows
//    a block, keys in tiles of 64. At D = 192 the tiles take 117,760 bytes,
//    so one block fits an SM, and its register cap is lifted to match.
#include "common.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per step of the loop
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBKP = kBK + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -0.5e30f;  // anything below this counts as masked

// Blocks of the float32 kernel an SM holds: its tiles of 64 query and 64 key
// rows of D + 4 floats, and the 64 x 68 probabilities, take 82,944 bytes at
// D = 128 and 117,760 at D = 192, over half of an SM's 233,472.
template <int D>
constexpr int fma_blocks() {
  return D > 128 ? 1 : 2;
}

// Copy `rows` rows of D elements, starting at sequence position row0, into a
// float32 tile with padded rows. Positions at or past `limit` become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          long long stride_s, int row0,
                                          int limit, int rows) {
  constexpr int V = Vec<float>::n;
  constexpr int kChunks = D / V;
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int pos = row0 + r;
    float v[V];
    if (pos < limit) {
      load16(src + static_cast<long long>(pos) * stride_s + c * V, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.0f;
    }
    float* out = dst + r * DP + c * V;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(out + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
}

// Reduce over the 16 lanes that share a query row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads, fma_blocks<D>())
    flash_attention_fma_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                           int Sq, int Skv, int H, int Hkv,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           int causal, float scale) {
  constexpr int DP = D + 4;                         // padded tile row
  constexpr int kOutChunks = (D / 4 + 15) / 16;     // float4s of output a thread owns per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // kBQ x DP
  float* KVs = Qs + kBQ * DP;      // kBK x DP, K then V
  float* Ps = KVs + kBK * DP;      // kBQ x kBKP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // The last query tiles have the longest loops under the causal mask: start
  // them first.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = q_tile * kBQ;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  load_tile<D>(Qs, qb, q_ss, q0, Sq, kBQ);

  float m[4], l[4];
  float4 o[4][kOutChunks];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int kv_end = Skv;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq);  // one past the tile's last row
    kv_end = min(Skv, last_q);
  }
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    load_tile<D>(KVs, kb, k_ss, k0, Skv, kBK);
    __syncthreads();  // K (and, the first time, Q) is in place

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * DP + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // online softmax of the 64 x 64 tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool visible = (kpos < Skv) && (!causal || qpos >= kpos);
        s[i][j] = visible ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = (m_new > kMasked) ? m_new : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] > kMasked) ? expf(s[i][j] - m_safe) : 0.0f;
        Ps[(ty + 16 * i) * kBKP + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float corr = (m[i] > kMasked) ? expf(m[i] - m_safe) : 0.0f;
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutChunks; ++c) {
        o[i][c].x *= corr;
        o[i][c].y *= corr;
        o[i][c].z *= corr;
        o[i][c].w *= corr;
      }
    }
    __syncthreads();  // every thread is done with K; the probabilities are written

    load_tile<D>(KVs, vb, v_ss, k0, Skv, kBK);
    __syncthreads();  // V is in place

    // out += P V: rows ty + 16 i, columns 4 (tx + 16 c) .. + 3
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kBKP + kk);
      }
#pragma unroll
      for (int c = 0; c < kOutChunks; ++c) {
        const int chunk = tx + 16 * c;
        if (chunk < D / 4) {
          float4 vv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            vv[u] = *reinterpret_cast<const float4*>(KVs + (kk + u) * DP + 4 * chunk);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              o[i][c].x = fmaf(p[u], vv[u].x, o[i][c].x);
              o[i][c].y = fmaf(p[u], vv[u].y, o[i][c].y);
              o[i][c].z = fmaf(p[u], vv[u].z, o[i][c].z);
              o[i][c].w = fmaf(p[u], vv[u].w, o[i][c].w);
            }
          }
        }
      }
    }
    __syncthreads();  // done with V and the probabilities before the next tile
  }

  // out is contiguous (B, Sq, H, D)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int chunk = tx + 16 * c;
      if (chunk < D / 4) {
        store4(orow + 4 * chunk,
               make_float4(o[i][c].x * inv, o[i][c].y * inv, o[i][c].z * inv,
                           o[i][c].w * inv));
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA, mbarrier ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBQ = 128;           // query rows per block, 64 per consumer warpgroup
constexpr int kThreads = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int kRowBytes = 128;     // a swizzled row: 64 bf16
constexpr int kBox = 64;           // columns of one TMA box
constexpr int kQBox = kBQ * kRowBytes;  // 128 rows of one 64-column box of Q
constexpr int kSmemLimit = 232448;      // a block's shared memory on an H100
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kTurn = 1;           // named barriers kTurn, kTurn + 1

// Up to D = 128 a stage holds K and V tiles of 128 keys, and three stages
// fit beside Q. At D = 192 a tile of 128 keys is three boxes of 16 KB, which
// leaves room for one stage: there a stage holds 64 keys (two tiles of 24 KB)
// and three stages fit beside Q's 48 KB.
template <int D>
struct Cfg {
  static constexpr int kBK = D > 128 ? 64 : 128;        // keys per stage
  static constexpr int kBoxes = (D + kBox - 1) / kBox;  // 64-column boxes per row
  static constexpr int kKSteps = (D + 15) / 16;         // k-steps of Q K^T
  static constexpr int kKVBox = kBK * kRowBytes;        // one box of K or V
  static constexpr int kQBytes = kBoxes * kQBox;        // the Q tile
  static constexpr int kKVBytes = kBoxes * kKVBox;      // a K or a V tile
  static constexpr int kBarBytes = 8 * 16;  // room for 1 + 3 x kStages barriers
  static constexpr int kFit =
      (kSmemLimit - 1024 - kBarBytes - kQBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes in the kernel
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kKVBytes * kStages + kBarBytes;
  static_assert(kStages >= 2, "a ring needs two stages");
  static_assert(1 + 3 * kStages <= kBarBytes / 8, "barrier room");
  static_assert(kKVBox % 1024 == 0, "tiles start on the swizzle's 1024 bytes");
};

// Key tiles of BK keys a block walks; the producer and both consumers use
// this count.
template <int BK>
__device__ __forceinline__ int kv_tiles(int q0, int Skv, int causal) {
  const int end = causal ? min(Skv, q0 + kBQ) : Skv;
  return (end + BK - 1) / BK;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// What a consumer thread needs to know of its two rows (qpos0 and
// qpos0 + 8) and of the mask.
struct Rows {
  int quad;          // the thread's column pairs: 8 j + 2 quad, + 1
  int qpos0, qpos1;  // its rows
  int first;         // the warpgroup's first row
  int Skv, causal;
  float scale_log2;  // scale * log2(e)
};

// Online softmax of one tile of BK scores a row, in place: the masks (only
// where the tile crosses the diagonal or the end of Skv), row maxima over the
// 4 lanes of a quad, p = exp2(s * scale_log2 - m) in sc, the running maximum
// m and denominator share l updated, and in corr the factor for what the
// output accumulated before this tile.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, const Rows& r) {
  constexpr int kCols = BK / 8;  // column pairs of the accumulator layout
  if (k0 + BK > r.Skv || (r.causal && k0 + BK - 1 > r.first)) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * r.quad + (e & 1);
        const int qpos = e < 2 ? r.qpos0 : r.qpos1;
        if (kpos >= r.Skv || (r.causal && kpos > qpos)) sc[4 * j + e] = -INFINITY;
      }
    }
  }
  // maxima and sums in 4 partial chains a row: two warps an SM sub-partition
  // leave little to hide a long dependent chain behind
  float pm[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pm[0][c] = fmaxf(sc[4 * c], sc[4 * c + 1]);
    pm[1][c] = fmaxf(sc[4 * c + 2], sc[4 * c + 3]);
  }
#pragma unroll
  for (int j = 4; j < kCols; ++j) {
    pm[0][j % 4] = fmaxf(pm[0][j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    pm[1][j % 4] = fmaxf(pm[1][j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mx[2], m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(fmaxf(pm[i][0], pm[i][1]), fmaxf(pm[i][2], pm[i][3]));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * r.scale_log2);
    m_use[i] = m_new == -INFINITY ? 0.0f : m_new;  // a row masked so far
    corr[i] = exp2_approx(m[i] - m_use[i]);
    m[i] = m_new;
  }
  float ps[2][4] = {};
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] =
          exp2_approx(fmaf(sc[4 * j + e], r.scale_log2, -m_use[e / 2]));
      ps[e / 2][j % 4] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * corr[i] + ((ps[i][0] + ps[i][1]) + (ps[i][2] + ps[i][3]));
  }
}

// P rounded to bf16 and packed: the accumulator layout of keys 16 kk ..
// 16 kk + 15 is the A-register layout of k-step kk of P V.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ out, int Sq,
                                 int Skv, int H, int Hkv, int causal,
                                 float scale) {
  using C = Cfg<D>;
  using namespace hopper;
  constexpr int S = C::kStages;
  constexpr int BK = C::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* Qs = base;
  unsigned char* KV = base + C::kQBytes;  // stage s: K, then V
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(KV + 2 * S * C::kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + S;
  uint64_t* empty = bars + 1 + 2 * S;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = q_tile * kBQ;
  const int n_tiles = kv_tiles<BK>(q0, Skv, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread issues every copy --------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_4d(Qs + x * kQBox, &qmap, q_full, x * kBox, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        // the consumers' release of this stage's previous fill
        if (t >= S) mbar_wait(&empty[s], ((t / S) - 1) & 1);
        unsigned char* Ks = KV + 2 * s * C::kKVBytes;
        unsigned char* Vs = Ks + C::kKVBytes;
        mbar_arrive_expect_tx(&k_full[s], C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_4d(Ks + x * C::kKVBox, &kmap, &k_full[s], x * kBox,
                      t * BK, hk, b);
        }
        mbar_arrive_expect_tx(&v_full[s], C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_4d(Vs + x * C::kKVBox, &vmap, &v_full[s], x * kBox,
                      t * BK, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns query rows q0 + 64 wgi .. + 63 -----
    // Tile t's S = Q K^T is issued together with tile t - 1's O += P V, and
    // tile t's softmax runs while P V is on the tensor cores.
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    Rows rows;
    rows.quad = lane % 4;
    rows.qpos0 = q0 + 64 * wgi + 16 * (tid / 32) + lane / 4;
    rows.qpos1 = rows.qpos0 + 8;
    rows.first = q0 + 64 * wgi;
    rows.Skv = Skv;
    rows.causal = causal;
    rows.scale_log2 = scale * 1.4426950408889634f;
    const uint32_t q_addr = smem_addr(Qs) + wgi * 64 * kRowBytes;
    auto k_addr = [&](int s) { return smem_addr(KV + 2 * s * C::kKVBytes); };

    // S = Q K^T for the K tile of stage s: 64 rows x BK keys
    auto issue_qk = [&](float (&sc)[BK / 2], int s) {
#pragma unroll
      for (int ks = 0; ks < C::kKSteps; ++ks) {
        const uint32_t step = (ks % 4) * 32;
        wgmma_m64k16_ss<BK>(
            sc, make_desc_sw128(q_addr + (ks / 4) * kQBox + step, 16, 1024),
            make_desc_sw128(k_addr(s) + (ks / 4) * C::kKVBox + step, 16, 1024),
            ks > 0);
      }
      wgmma_commit();
    };
    // O += P V for the V tile of stage s: V is MN-major, 16 keys a k-step
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                        int s) {
      const uint32_t v_addr = k_addr(s) + C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64k16_rs<D>(
            o, pa[kk],
            make_desc_sw128(v_addr + kk * 16 * kRowBytes, C::kKVBox, 1024));
      }
      wgmma_commit();
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running maximum, scaled by scale_log2
    float l[2] = {0.0f, 0.0f};            // this thread's share of the denominator
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float corr[2];

    // The two warpgroups take turns to issue their products (named barriers
    // kTurn + 0 and + 1), so that one's softmax runs beside the other's
    // products; warpgroup 0 starts.
    const int my_turn = kTurn + wgi, other_turn = kTurn + 1 - wgi;
    if (wgi == 1) named_bar_arrive(other_turn, 256);
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_qk(sc, 0);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    fence_operands(sc);
    softmax_tile<BK>(sc, m, l, corr, 0, rows);
    pack_p<BK>(sc, pa);
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % S;
      const int prev = (t - 1) % S;
      mbar_wait(&k_full[s], (t / S) & 1);
      mbar_wait(&v_full[prev], ((t - 1) / S) & 1);
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_qk(sc, s);
      issue_pv(o, pa, prev);
      named_bar_arrive(other_turn, 256);
      wgmma_wait<1>();  // S of tile t; P V of tile t - 1 runs on
      fence_operands(sc);
      softmax_tile<BK>(sc, m, l, corr, t * BK, rows);
      wgmma_wait<0>();
      fence_operands(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);  // this warp is done with it
      rescale(o, corr);
      pack_p<BK>(sc, pa);
    }
    const int last = (n_tiles - 1) % S;
    mbar_wait(&v_full[last], ((n_tiles - 1) / S) & 1);
    wgmma_fence();
    issue_pv(o, pa, last);
    wgmma_wait<0>();
    fence_operands(o);

    // out is contiguous (B, Sq, H, D)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r == 0 ? rows.qpos0 : rows.qpos1;
      if (qpos >= Sq) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * rows.quad) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * l[r],
                                  o[4 * j + 2 * r + 1] * l[r]);
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct AttnArgs {
  const void *q, *k, *v;
  void* out;
  int B, Sq, Skv, H, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_fma(const AttnArgs& a) {
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (D + 4) + kBQ * kBKP) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_attention_fma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.Sq, a.Skv,
      a.H, a.Hkv, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
      a.v_ss, a.v_sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D map (D, S, heads, B) of a bf16 tensor with the given strides in
// elements, read in boxes of 64 columns x `rows` rows with the 128-byte
// swizzle.
// TMA wants every stride a multiple of 16 bytes, also that of a dimension of
// size 1 (the wrapper replaces such strides). Columns past D and rows past S
// read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
             int B, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoTensorMap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {wg::kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

template <int D>
int launch_wgmma(const AttnArgs& a) {
  constexpr int kv_rows = wg::Cfg<D>::kBK;
  CUtensorMap qmap, kmap, vmap;
  int code = make_map(&qmap, a.q, D, a.Sq, a.H, a.B, a.q_sb, a.q_ss, a.q_sh,
                      wg::kBQ);
  if (code == 0) {
    code = make_map(&kmap, a.k, D, a.Skv, a.Hkv, a.B, a.k_sb, a.k_ss, a.k_sh,
                    kv_rows);
  }
  if (code == 0) {
    code = make_map(&vmap, a.v, D, a.Skv, a.Hkv, a.B, a.v_sb, a.v_ss, a.v_sh,
                    kv_rows);
  }
  if (code != 0) return code;
  constexpr int smem = wg::Cfg<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      wg::flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + wg::kBQ - 1) / wg::kBQ, a.H, a.B);
  wg::flash_attention_wgmma_kernel<D><<<grid, wg::kThreads, smem, a.stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Skv, a.H,
      a.Hkv, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_head_dim(const AttnArgs& a, int dtype) {
  return dtype == kBFloat16 ? launch_wgmma<D>(a) : launch_fma<D>(a);
}

}  // namespace rt

// q (B, Sq, H, D), k and v (B, Skv, Hkv, D), all of `dtype`, read through
// their batch, sequence and head strides (in elements; the last dimension is
// contiguous, every stride a multiple of 16 bytes' worth of elements, also
// for a dimension of size 1, every base address 16-byte aligned). out is
// contiguous (B, Sq, H, D). Returns 0, a CUDA error code, or a negative code
// for arguments the kernel does not take.
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Skv, int H, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    int dtype, void* stream) {
  using namespace rt;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H > 65535 || B > 65535) {
    return kBadShape;
  }
  const AttnArgs a{q,    k,    v,    out,  B,    Sq,   Skv,  H,      Hkv,
                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,   v_sh,
                   causal, scale, static_cast<cudaStream_t>(stream)};
  if (dtype != kFloat32 && dtype != kBFloat16) return kBadDtype;
  switch (D) {
    case 16:
      return launch_head_dim<16>(a, dtype);
    case 32:
      return launch_head_dim<32>(a, dtype);
    case 64:
      return launch_head_dim<64>(a, dtype);
    case 112:  // zamba2-7b: 3584 / 32 heads
      return launch_head_dim<112>(a, dtype);
    case 128:
      return launch_head_dim<128>(a, dtype);
    case 192:  // deepseek-v3's MLA: q and k of 128 + 64, v padded to 192
      return launch_head_dim<192>(a, dtype);
    default:
      return kBadShape;
  }
}
