// The tensor-core tile routine shared by the bf16 flash-attention kernel
// (flash_attention.cu) and the bf16/int8 paged-attention kernels
// (paged_attention.cu), for Hopper (sm_90a).
//
// A warp owns 16 query rows.  Their Q fragments (bf16, the A operand of
// mma.sync.m16n8k16) and their online-softmax state (m, l, acc) live in
// registers for the whole walk over the keys (at DP = 256, Q lives in
// shared memory instead: see kSmemQ).  One call of `tile_step`
// takes a tile of kKeys = 64 keys, bf16, with their V, in shared memory
// (rows padded by 8 elements, so the ldmatrix loads of K and the
// transposed loads of V hit 8 distinct 16-byte bank groups: no conflicts),
// and for each of the warp's rows the half-open range [lo, hi) of key
// positions it may see, and updates (m, l, acc) with one online-softmax
// step:
//
//   - S = Q.K^T on the tensor cores, bf16 x bf16 -> f32: the products are
//     exact and only the order of the f32 sums differs from a plain f32
//     dot product;
//   - the scale is applied in f32 (for int8 keys, the per-slot K scale
//     first, to the f32 score, then sm_scale); masked scores are *set* to
//     NEG_INF = -1e30, as the TPU kernels do;
//   - row max and row sum by shuffles within the quad of lanes that holds
//     a row; exp(s - m) is taken as 2^((s - m) log2e) by ex2.approx
//     (relative error ~1e-6 at the scores that matter, far inside the
//     bf16 output tolerance); with MASK_P the probabilities are multiplied by the mask
//     (paged rows: a row with no visible key keeps (m, l) = (NEG_INF, 0)
//     and acc = 0 exactly), without it a fully masked step adds
//     exp(0) = 1 per key, as the TPU flash kernel does, which the first
//     visible key then wipes (corr = exp(-1e30 - m) = 0);
//   - acc += P.V on the tensor cores with P kept in registers: the f32
//     accumulator layout of two n8 score tiles is the A-operand layout of
//     one k16 product.  P goes in as two bf16 terms, hi = bf16(P) and
//     lo = bf16(P - hi), both multiplied into the one f32 accumulator, so
//     P keeps 16 significant bits.  (P in bf16 alone puts outputs near
//     zero ~130x past the one-bf16-step tolerance against the f32
//     reference at S = 1024; tests/test_torch_tile_numerics.py.)  For int8
//     values the per-slot V scale is folded into P before the split.
//
// Everything is `__device__ __forceinline__`; the including kernel owns
// the loads (cp.async), the walk and the epilogue.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_tile {

constexpr float kNegInf = -1e30f;
constexpr int kKeys = 64;                  // keys per tile step
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;         // query rows (or row, head pairs) per block
constexpr int kPad = 8;                    // bf16 elements of padding per smem row

// DP: the head dim the tile is built for (32, 64, 128 or 256); narrower
// heads are zero-padded up to it.
template <int DP>
struct Dims {
  static_assert(DP == 32 || DP == 64 || DP == 128 || DP == 256, "tile width");
  static constexpr int kStride = DP + kPad;          // smem row stride (bf16)
  static constexpr int kTileElems = kKeys * kStride;  // one K or V tile
  static constexpr int kChunks = DP / 8;              // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `valid` false writes 16 zero
// bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  ldmatrix_x4(r, smem_u32(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 2^x by the special-function unit (ex2.approx, relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a . b, one m16n8k16 tile, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as hi = bf16(x) and lo = bf16(x - hi), packed in pairs
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Where Q's A fragments live.  Up to DP = 128 in registers, DP / 4 of
// them.  At DP = 256 the 64 fragment registers beside the 128 f32
// accumulators, the 32 scores and the V fragments pass the 255 registers
// a thread may hold, so the warp's 16 Q rows go to a tile in shared
// memory (kQTileElems bf16, rows padded as the K tiles are) and each
// k16 step loads its fragment with one ldmatrix; and tile_step loads each
// pair of V fragments once for both the lo and hi products instead of
// holding all DP / 8 of them (the same products into each accumulator in
// the same order: the same bits).
template <int DP>
constexpr bool kSmemQ = DP > 128;
constexpr int kQTileElems = 16 * Dims<256>::kStride;   // one warp's Q rows at DP = 256

// The registers of one warp: rows g = lane / 4 and g + 8 of its 16.
template <int DP, bool SMEM_Q = kSmemQ<DP>>
struct RowState {
  uint32_t q[DP / 16][4];   // A fragments of Q, one per k16 step
  float acc[DP / 8][4];     // C fragments of the output, one per n8 block
  float m[2], l[2];         // rows g and g + 8
};

template <int DP>
struct RowState<DP, true> {
  uint32_t q_addr;          // shared address of this lane's ldmatrix row of Q, k16 step 0
  float acc[DP / 8][4];
  float m[2], l[2];
};

// Q rows `qa` (row g) and `qb` (row g + 8), `D` bf16 each, into the A
// fragments (zeros for a null row and for d >= D); resets (m, l, acc).
// kSmemQ: into the warp's tile `q_tile` (kQTileElems bf16) instead, the
// same values at the same (row, d).
template <int DP>
__device__ __forceinline__ void init_rows(RowState<DP>& st, const __nv_bfloat16* qa,
                                          const __nv_bfloat16* qb, int D, int lane,
                                          __nv_bfloat16* q_tile = nullptr) {
  const int t = lane & 3;
  if constexpr (kSmemQ<DP>) {
    constexpr int S = Dims<DP>::kStride;
    const int g = lane >> 2;
    __syncwarp();                            // the warp's last reads of the tile are done
#pragma unroll 4
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kk * 16 + half * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(q_tile + g * S + d) =
            (qa != nullptr && d < D) ? *reinterpret_cast<const uint32_t*>(qa + d) : 0u;
        *reinterpret_cast<uint32_t*>(q_tile + (g + 8) * S + d) =
            (qb != nullptr && d < D) ? *reinterpret_cast<const uint32_t*>(qb + d) : 0u;
      }
    }
    __syncwarp();
    const int mi = lane >> 3, mr = lane & 7;   // matrices: rows 0-7 / 8-15, k 0-7 / 8-15
    st.q_addr = smem_u32(q_tile + ((mi & 1) * 8 + mr) * S + (mi >> 1) * 8);
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kk * 16 + half * 8 + 2 * t;
        st.q[kk][2 * half] =
            (qa != nullptr && d < D) ? *reinterpret_cast<const uint32_t*>(qa + d) : 0u;
        st.q[kk][2 * half + 1] =
            (qb != nullptr && d < D) ? *reinterpret_cast<const uint32_t*>(qb + d) : 0u;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;
}

// One online-softmax step of a warp's 16 rows over the tile's keys, at
// positions key0 + [0, kKeys).  Keys at or past key0 + 8 * nj must be
// masked for every row of the warp (their scores are not computed);
// 1 <= nj <= 8.  QUANT: ks / vs hold the tile's per-key K and V scales
// (f32, shared memory).
template <int DP, bool MASK_P, bool QUANT>
__device__ __forceinline__ void tile_step(RowState<DP>& st, const __nv_bfloat16* Ks,
                                          const __nv_bfloat16* Vs, const float* ks,
                                          const float* vs, int key0, int nj, const int lo[2],
                                          const int hi[2], float sm_scale, int lane) {
  constexpr int S = Dims<DP>::kStride;
  const int t = lane & 3;
  const int mi = lane >> 3;                 // which 8x8 matrix this lane addresses
  const int mr = lane & 7;                  // which row of it

  // 1. S = Q . K^T: per k16 step, two n8 key blocks per ldmatrix.x4, the
  // eight accumulators independent
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const __nv_bfloat16* krow = Ks + ((mi >> 1) * 8 + mr) * S + (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t* a;
    uint32_t qf[4];
    if constexpr (kSmemQ<DP>) {
      ldmatrix_x4(qf, st.q_addr + kk * 32u);   // 16 bf16 per k16 step
      a = qf;
    } else {
      a = st.q[kk];
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (2 * jp < nj) {
        uint32_t b[4];
        ldmatrix_x4(b, krow + jp * 16 * S + kk * 16);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }

  // 2. scale, mask, row max
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = j * 8 + 2 * t + (e & 1);
      const int pos = key0 + col;
      float v = s[j][e];
      if (QUANT) v = __fmul_rn(v, ks[col]);
      v = __fmul_rn(v, sm_scale);
      s[j][e] = (pos >= lo[r] && pos < hi[r]) ? v : kNegInf;
      mx[r] = fmaxf(mx[r], s[j][e]);
    }
  // exp(x - m) as exp2((x - m) * log2e): x - m is the reference's own f32
  // difference (exactly 0 where a fully masked row has x = m = NEG_INF)
  constexpr float kLog2e = 1.4426950408889634f;
  float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(st.m[r], mx[r]);
    corr[r] = ex2(__fmul_rn(st.m[r] - m_new[r], kLog2e));
  }

  // 3. probabilities (times the mask for paged rows) and row sums
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(__fmul_rn(s[j][e] - m_new[r], kLog2e));
      if (MASK_P) {
        const int pos = key0 + j * 8 + 2 * t + (e & 1);
        p = (pos >= lo[r] && pos < hi[r]) ? p : 0.f;
      }
      s[j][e] = p;
      sum[r] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    st.l[r] = __fmaf_rn(st.l[r], corr[r], sum[r]);
    st.m[r] = m_new[r];
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    st.acc[n][0] *= corr[0];
    st.acc[n][1] *= corr[0];
    st.acc[n][2] *= corr[1];
    st.acc[n][3] *= corr[1];
  }

  // 4. acc += P . V, P as hi + lo bf16, 16 keys per k16 step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (2 * kk < nj) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[jj][e] = s[2 * kk + jj][e];
          if (QUANT) p[jj][e] = __fmul_rn(p[jj][e], vs[(2 * kk + jj) * 8 + 2 * t + (e & 1)]);
        }
      uint32_t ah[4], al[4];
      split_pair(p[0][0], p[0][1], ah[0], al[0]);   // row g,     keys 0-7
      split_pair(p[0][2], p[0][3], ah[1], al[1]);   // row g + 8, keys 0-7
      split_pair(p[1][0], p[1][1], ah[2], al[2]);   // row g,     keys 8-15
      split_pair(p[1][2], p[1][3], ah[3], al[3]);   // row g + 8, keys 8-15
      const __nv_bfloat16* vrow = Vs + (kk * 16 + (mi & 1) * 8 + mr) * S + (mi >> 1) * 8;
      if constexpr (kSmemQ<DP>) {
        // one pair of V fragments at a time, lo then hi into each
        // accumulator: the order of the loops below
#pragma unroll
        for (int n = 0; n < DP / 8; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + n * 8);
          mma_bf16(st.acc[n], al, bv[0], bv[1]);
          mma_bf16(st.acc[n + 1], al, bv[2], bv[3]);
          mma_bf16(st.acc[n], ah, bv[0], bv[1]);
          mma_bf16(st.acc[n + 1], ah, bv[2], bv[3]);
        }
      } else {
        uint32_t bv[DP / 16][4];
#pragma unroll
        for (int n = 0; n < DP / 8; n += 2) {
          ldmatrix_x4_trans(bv[n / 2], vrow + n * 8);
          mma_bf16(st.acc[n], al, bv[n / 2][0], bv[n / 2][1]);
          mma_bf16(st.acc[n + 1], al, bv[n / 2][2], bv[n / 2][3]);
        }
#pragma unroll
        for (int n = 0; n < DP / 8; n += 2) {
          mma_bf16(st.acc[n], ah, bv[n / 2][0], bv[n / 2][1]);
          mma_bf16(st.acc[n + 1], ah, bv[n / 2][2], bv[n / 2][3]);
        }
      }
    }
  }
}

// The tile width for head dims D and Dv: narrower heads are zero-padded
// up to it; 0 past 256 (no tile takes them).
inline int tile_width(int D, int Dv) {
  const int d = D > Dv ? D : Dv;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// Block-wide exclusive prefix sum of one int per thread (blockDim.x a
// multiple of 32, at most 1024); `total` gets the sum over the block.
// `warp_sums` is 32 ints of shared memory.  Contains __syncthreads.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;                     // inclusive over warps
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[31];
  __syncthreads();                         // warp_sums may be reused
  return base + incl - v;
}

}  // namespace attn_tile
