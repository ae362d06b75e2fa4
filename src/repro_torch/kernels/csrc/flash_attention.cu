// Softmax attention with an online softmax: the score matrix never reaches
// device memory.
//
//   q (B, Sq, H, D), k and v (B, Skv, Hkv, D)  ->  out (B, Sq, H, D)
//
// Query head h reads kv head h / (H / Hkv). The causal mask is
// qpos >= kpos, aligned top-left when Sq != Skv. A row with no visible key
// gives zeros. Inputs are float32 or bfloat16; the running maximum, the
// denominator and the accumulator are float32; the output has the inputs'
// type.
//
// Common to both kernels below: one block owns a tile of query rows of one
// (batch, head) and walks over the keys in tiles of 64, which is the
// loop that takes the place of a sequential grid dimension. Under the causal
// mask the loop stops at the diagonal. q, k and v are read through their
// strides, so no transposed or padded copy is made; ragged edges are masked
// here. The function is bound by operations, so the two element types get
// the arithmetic that suits them:
//
//  * bfloat16 (flash_attention_mma_kernel): both products run on the tensor
//    cores as mma.sync m16n8k16 with float32 accumulation. Eight warps, 16
//    query rows each (128 rows a block, so that a K and V tile fetched
//    through the L2 cache serves twice the rows); K and V tiles arrive by
//    cp.async into two stages, the next tile loading while this one is
//    computed on; a warp keeps its Q fragments in registers for the
//    whole loop, reads K fragments straight from the shared-memory tile and
//    V fragments through ldmatrix.trans; the scores never leave registers:
//    the accumulator layout of Q K^T is the A-operand layout of P V, so the
//    probabilities are rounded to bfloat16 in place (as the plain
//    full_attention rounds them before P V).
//  * float32 (flash_attention_fma_kernel): plain float32 FMAs from
//    shared-memory tiles, exact to rounding. 256 threads; each keeps a 4x4
//    piece of the scores and a 4 x (D/16) piece of the output in registers,
//    rows are reduced with shuffles across the 16 threads that share them,
//    and K and V take turns in one buffer so that two blocks fit on a
//    multiprocessor, 64 query rows a block.
//
// The head dim D is a template parameter: 16, 32, 64, 112 or 128. Every
// loop over D steps by 16 (bf16 k-steps; 8-column output blocks in pairs) or
// by 4 (float32), and 112 = 7 x 16, so 112 takes the same code with no
// padded copy of q, k or v.
//
// Neither kernel uses wgmma or TMA yet.
#include "common.cuh"

namespace rt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per step of the loop
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBKP = kBK + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -0.5e30f;  // anything below this counts as masked

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
__global__ void __launch_bounds__(kThreads, 2)
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
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaBQ = 16 * kMmaWarps;      // query rows per block
constexpr int kMmaThreads = 32 * kMmaWarps;

// D (16x8, float32) += A (16x16, bf16, row-major) * B (16x8, bf16, "col").
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way:
// lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes from device memory to shared memory without passing through
// registers; completion is awaited with cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start the copy of `rows` rows of D bf16 elements, from sequence position
// row0 on, into a tile with padded rows. Positions at or past `limit`
// become zeros.
template <int D>
__device__ __forceinline__ void copy_tile_async(
    __nv_bfloat16* __restrict__ dst, const __nv_bfloat16* __restrict__ src,
    long long stride_s, int row0, int limit, int rows) {
  constexpr int kChunks = D / 8;
  constexpr int DP = D + 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int pos = row0 + r;
    __nv_bfloat16* to = dst + r * DP + c * 8;
    if (pos < limit) {
      cp_async16(to, src + static_cast<long long>(pos) * stride_s + c * 8);
    } else {
      *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int Sq,
                               int Skv, int H, int Hkv, long long q_sb,
                               long long q_ss, long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, int causal,
                               float scale) {
  // Rows padded by 8 elements (16 bytes): a fragment's 8 rows then fall on
  // 8 different groups of banks, and every row stays 16-byte aligned.
  constexpr int DP = D + 8;
  constexpr int kKSteps = D / 16;     // k-steps of Q K^T
  constexpr int kSBlocks = kBK / 8;   // 8-key blocks of the score tile
  constexpr int kPSteps = kBK / 16;   // k-steps of P V
  constexpr int kOBlocks = D / 8;     // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = kBK * DP;  // elements of one K or V tile
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMmaBQ x DP
  // two stages, each a K tile then a V tile: one is computed on while the
  // next is on its way
  __nv_bfloat16* KVs = Qs + kMmaBQ * DP;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;    // row of the fragment this lane holds (and g + 8)
  const int tig = lane & 3;   // its pair of columns: 2 tig, 2 tig + 1
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest loops first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = q_tile * kMmaBQ;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + kMmaBQ, Sq));
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  copy_tile_async<D>(Qs, qb, q_ss, q0, Sq, kMmaBQ);
  if (n_tiles > 0) {
    copy_tile_async<D>(KVs, kb, k_ss, 0, Skv, kBK);
    copy_tile_async<D>(KVs + kTile, vb, v_ss, 0, Skv, kBK);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept for the whole loop.
  uint32_t qa[kKSteps][4];
  {
    const __nv_bfloat16* r0 = Qs + (warp * 16 + g) * DP + tig * 2;
    const __nv_bfloat16* r1 = r0 + 8 * DP;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(r0 + ks * 16);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(r1 + ks * 16);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + ks * 16 + 8);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(r1 + ks * 16 + 8);
    }
  }

  // Rows g and g + 8 of the warp's 16: running maximum, this lane's share of
  // the denominator (summed over the 4 lanes of a row at the end), output.
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float o[kOBlocks][4];
#pragma unroll
  for (int nb = 0; nb < kOBlocks; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
  }

  const int qrow = q0 + warp * 16 + g;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const __nv_bfloat16* Ks = KVs + (t & 1) * 2 * kTile;
    const __nv_bfloat16* Vs = Ks + kTile;
    // Tile t is in place (awaited below, or before the loop for t = 0) and
    // every warp is past tile t - 1, whose stage the next copy overwrites.
    if (t + 1 < n_tiles) {
      __nv_bfloat16* next = KVs + ((t + 1) & 1) * 2 * kTile;
      copy_tile_async<D>(next, kb, k_ss, k0 + kBK, Skv, kBK);
      copy_tile_async<D>(next + kTile, vb, v_ss, k0 + kBK, Skv, kBK);
      cp_async_commit();
    }

    // scores: 16 rows x 64 keys, in 8 blocks of 8 keys
    float s[kSBlocks][4];
#pragma unroll
    for (int nb = 0; nb < kSBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
      // B fragment: key nb*8 + g, the pair of d at ks*16 + 2 tig (and + 8)
      const __nv_bfloat16* krow = Ks + (nb * 8 + g) * DP + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
        mma_bf16(s[nb], qa[ks], b0, b1);
      }
    }

    // online softmax; element e of a block: row g + 8 (e / 2), key 2 tig + e % 2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kSBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nb * 8 + tig * 2 + (e & 1);
        const int qpos = qrow + (e >> 1) * 8;
        const bool visible = (kpos < Skv) && (!causal || qpos >= kpos);
        s[nb][e] = visible ? s[nb][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = (m_new > kMasked) ? m_new : 0.0f;
      corr[r] = (m[r] > kMasked) ? __expf(m[r] - m_safe[r]) : 0.0f;
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < kSBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (s[nb][e] > kMasked) ? __expf(s[nb][e] - m_safe[e >> 1]) : 0.0f;
        s[nb][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int nb = 0; nb < kOBlocks; ++nb) {
      o[nb][0] *= corr[0];
      o[nb][1] *= corr[0];
      o[nb][2] *= corr[1];
      o[nb][3] *= corr[1];
    }

    // out += P V. Two neighbouring score blocks are one A fragment.
#pragma unroll
    for (int kb2 = 0; kb2 < kPSteps; ++kb2) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kb2][0], s[2 * kb2][1]);
      pa[1] = pack_bf16(s[2 * kb2][2], s[2 * kb2][3]);
      pa[2] = pack_bf16(s[2 * kb2 + 1][0], s[2 * kb2 + 1][1]);
      pa[3] = pack_bf16(s[2 * kb2 + 1][2], s[2 * kb2 + 1][3]);
      // ldmatrix: lane -> matrix lane / 8, row lane % 8. Matrices 0, 1 are
      // keys 0-7 and 8-15 of this k-step at column block nb, matrices 2, 3
      // the same keys at column block nb + 1.
      const int key = kb2 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const __nv_bfloat16* vrow = Vs + key * DP + (lane >> 4) * 8;
#pragma unroll
      for (int nb = 0; nb < kOBlocks; nb += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vrow + nb * 8);
        mma_bf16(o[nb], pa, vb4[0], vb4[1]);
        mma_bf16(o[nb + 1], pa, vb4[2], vb4[3]);
      }
    }
    cp_async_wait<0>();  // this thread's part of tile t + 1 has landed
    __syncthreads();     // ... and everyone's; all warps are done with tile t
  }

  // out is contiguous (B, Sq, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = l[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const int qpos = qrow + r * 8;
    if (qpos >= Sq) continue;
    const float inv = 1.0f / fmaxf(total, 1e-30f);
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int nb = 0; nb < kOBlocks; ++nb) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8 + tig * 2) =
          __floats2bfloat162_rn(o[nb][2 * r] * inv, o[nb][2 * r + 1] * inv);
    }
  }
}

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

template <typename T, typename Kernel>
int launch(Kernel kernel, int block_q, int threads, size_t smem,
           const AttnArgs& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + block_q - 1) / block_q, a.H, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Skv, a.H,
      a.Hkv, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_head_dim(const AttnArgs& a, int dtype) {
  if (dtype == kBFloat16) {
    const size_t smem = static_cast<size_t>(kMmaBQ + 4 * kBK) * (D + 8) *
                        sizeof(__nv_bfloat16);
    return launch<__nv_bfloat16>(flash_attention_mma_kernel<D>, kMmaBQ,
                                 kMmaThreads, smem, a);
  }
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (D + 4) + kBQ * kBKP) * sizeof(float);
  return launch<float>(flash_attention_fma_kernel<D>, kBQ, kThreads, smem, a);
}

}  // namespace rt

// q (B, Sq, H, D), k and v (B, Skv, Hkv, D), all of `dtype`, read through
// their batch, sequence and head strides (in elements; the last dimension is
// contiguous, every stride a multiple of 16 bytes' worth of elements, every
// base address 16-byte aligned). out is contiguous (B, Sq, H, D). Returns 0,
// a CUDA error code, or a negative code for arguments the kernel does not
// take.
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
    default:
      return kBadShape;
  }
}
