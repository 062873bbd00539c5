// The backward of blockwise attention (causal, windowed or full, with
// GQA), for Hopper (sm_90a).
//
// Replaces the jnp custom VJP _flash_core_bwd of
// src/repro/models/attention.py:205 (the gradient of the reference's flash
// attention, which trains through it); the forward it differentiates is
// flash_attention.cu, which writes the per-row log-sum-exp this file reads.
//
// What it computes, from the forward's inputs q (B, Sq, Hq, D), k
// (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), its output o (B, Sq, Hq, Dv),
// lse (B, Sq, Hq) f32 and the output's gradient do (B, Sq, Hq, Dv): with
// s = (q . k) * sm_scale in f32, the forward's mask (kpos < Skv, causal
// kpos <= qpos, windowed kpos > qpos - window, aligned top-left) and
//   P  = mask ? exp(s - lse) : 0          (the forward's probabilities)
//   dP = do . v^T
//   dS = P * (dP - delta) * sm_scale,     delta = rowsum(do * o)
// the gradients dV = P^T . do, dK = dS^T . q and dQ = dS . k, summed over
// the G query heads of a kv head for dK and dV, accumulated in f32 and
// rounded once to the input type (the reference's astype).  A masked key
// (past Skv, above the diagonal, outside the band) and a query row past Sq
// contribute exactly zero.
//
// The FlashAttention-2 split, so that no block adds into another's output
// (no atomics, the same bits on every run):
//   (a) delta, one warp per (b, row, head);
//   (b) dK/dV: one block per (64-key tile, kv head, b); it walks the query
//       tiles of each of the G heads that the causal or window band
//       leaves, recomputes P and dS for the tile pair and accumulates dK
//       and dV in registers;
//   (c) dQ: one block per (64-row query tile, query head, b); it walks the
//       key tiles of the band, recomputes P and dS and accumulates dQ.
//
// Bound: the five products S, dP, dV, dK, dQ take 2 D (or 2 Dv)
// operations each per (query, key) pair the mask keeps, against reading
// q, k, v, o, do once and writing dq, dk, dv once: at Granite-3-2B's
// training shape (B 4, S 2048, 32 query heads over 8 kv heads of 64,
// causal) 172 GFLOP against 0.17 GB, about a thousand operations per
// byte, so it is bound by operations: 0.174 ms at the bf16 peak; at
// Llama-2-7B's (B 1, S 4096, 32 heads of 128, causal) 0.348 ms; at
// RecurrentGemma-2B's (B 1, S 4096, 10 query heads over one kv head of
// 256, window 2048) 0.163 ms.  The bf16 path therefore runs on the tensor
// cores; f32 stays on the FMA units (TF32 would miss its 1e-4 tolerance),
// and no path trains in f32 on the card.
//
// bf16 (flash_bwd_*_mma_kernel<DP>, DP = attn_tile::tile_width(D, Dv):
// 32, 64, 128 or 256; narrower heads are zero-padded up to it):
//   - Tiles of 64 rows stay bf16 in shared memory, rows padded as
//     attention_tile.cuh pads them (conflict-free ldmatrix), loaded with
//     16-byte cp.async; the tile the walk advances is double-buffered (Q,
//     dO and the query rows' f32 lse and delta in (b); K and V in (c)), so
//     the next one loads while this one computes.
//   - Every product is mma.sync.m16n8k16 bf16 x bf16 -> f32 on
//     attention_tile.cuh's fragments.  In (b) a warp owns 16 keys and
//     computes S^T = K.Q^T or dP^T = V.dO^T against the tile's 64 query
//     rows (Q and dO as B operands by ldmatrix); the C fragments of two
//     n8 tiles are the A fragment of one k16 product, so P^T and dS^T
//     feed dV += P^T.dO and dK += dS^T.Q straight from registers, with dO
//     and Q as B operands by ldmatrix.trans: no transpose goes through
//     shared memory.  In (c) a warp owns 16 query rows: S = Q.K^T,
//     dP = dO.V^T, and dS in C layout is the A operand of dQ += dS.K (K
//     by ldmatrix.trans).
//   - S and dP need no rounding: their operands are the bf16 inputs and
//     the products are exact.  P and dS (f32) go into their products as
//     two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), into one f32
//     accumulator (attn_tile::split_pair), so they keep 16 significant
//     bits, as the forward's P does (tests/test_torch_bwd_tile_numerics.py
//     emulates both choices).  P = exp2((s * scale - lse) * log2e) by
//     ex2.approx where the forward's mask keeps the pair, else exactly 0.
//   - The register budget decides the split of (b) across warps.  One warp
//     holding both dK and dV for 16 keys needs 16 x DP x 2 f32
//     accumulators, DP registers a thread: 256 at DP = 256, past the 255 a
//     thread may hold before any fragment.  So (b) runs 8 warps as 4 pairs
//     over the same 16 keys: the first warp of a pair computes S^T, P (put
//     in shared memory, 4 KiB a pair, in fragment order) and dV; the
//     second dP^T, then dS from that P, and dK.  Each holds one set of
//     DP / 2 accumulators (128 registers at DP = 256, beside the 32 of
//     its 16 x 64 score tile and a few fragments: ptxas gives 236
//     registers at DP = 256 and no spill at any DP; see
//     scripts/ptxas_report.py), and each does three of the six
//     products of a tile pair (S^T then dV twice; dP^T then dK twice), so
//     the pair is balanced; one block barrier hands P over.  Chosen over
//     a dV kernel and a dK kernel (S recomputed in both: seven products
//     where six do) and over halving the columns per pass (S and dP
//     recomputed per half).  One layout for every DP: at DP <= 64 it also
//     keeps the block's registers low enough for two blocks per SM.
//     Shared memory: K, V, two stages of Q and dO, the P exchange and two
//     stages of lse and delta, 215 KiB at DP = 256 (one block per SM).
//   - (c) keeps 4 warps; dQ's DP / 2 accumulators, S, dP and fragments
//     fit one warp at every DP (251 registers at DP = 256, no spill); 198
//     KiB of shared memory at DP = 256.
//   A warp skips a tile pair that holds no visible (query, key) of its 16
//   rows (P and dS would be exact zeros), and tests the mask per element
//   only on tile pairs the mask cuts.  Blocks go out longest walk first
//   across every head (tiles on gridDim.z: causal key tile 0 in (b), the
//   last query tile in (c)), so the short walks fill the last wave.  With
//   the split, a tile pair costs ten m16n8k16 product-equivalents (S^T,
//   dP^T, 2 dV, 2 dK in (b); S, dP, 2 dQ in (c)) where the bound counts
//   five.
//
// f32 (flash_bwd_*_fma_kernel): the f32 FMA units, 256 threads a block,
// each a 4 x 4 tile of scores and a 4 x 8 tile of its gradient rows; the
// tiles of q, k, v, do, P and dS in shared memory as f32 (rows padded by 4
// floats: conflict-free float4 reads); head dims up to 128 (the 4 x 8
// tile of 16 threads spans 128 columns); the wrapper refuses wider ones by
// name.  P and dS are computed in f32 and used unrounded.
//
// Accumulate mode (both variants): the dQ and dK/dV kernels add their f32
// accumulators into caller-given f32 dq, dk, dv (+=) in place of writing
// them in the input type.  A ring of sequence shards runs one backward per
// shard pair and sums the partials in f32 this way, rounding once at the
// end, as one call over the whole sequence does; a tile of dQ (64 rows of
// a head) or of dK/dV (64 keys of a kv head) belongs to one block, so the
// add needs no atomics.  Added into zeros and rounded once, it gives the
// default mode's bits.
//
// Plain C interface (loaded with ctypes); the three launches are on the
// caller's stream, allocate nothing and return the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int kT = 64;             // query rows per q tile, keys per kv tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kMaxD = 128;         // largest D and Dv
constexpr int kPStride = kT + 4;   // f32 row stride of the P and dS tiles

struct Shape {
  int B, Sq, Skv, Hq, Hkv, G, D, Dv, causal, window;
  float sm_scale;
  int accumulate;  // 1: add the f32 gradients into f32 dq, dk, dv (+=)
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// An f32 gradient's four values: written, or added to what is there
// (accumulate mode; the block owns these rows, so no atomics)
__device__ __forceinline__ void put4(float* p, float4 v, int accumulate) {
  if (accumulate) {
    const float4 o = *reinterpret_cast<const float4*>(p);
    v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
  }
  store4(p, v);
}

// Rows [row0, row0 + 64) of head h of a (B, S, H, width) tensor into a
// 64-row f32 tile of `stride`; rows at or past S read as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, int b, int row0,
                                          int S, int H, int h, int width) {
  const int per_row = width / 4;
  for (int idx = threadIdx.x; idx < kT * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const int s = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) v = load4(src + ((static_cast<int64_t>(b) * S + s) * H + h) * width + c);
    store4(dst + r * stride + c, v);
  }
}

// 64 f32 values per row of a (B, S, H) tensor for rows [row0, row0 + 64)
// of head h; rows past S read as zeros.
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int b, int row0, int S, int H, int h) {
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const int s = row0 + r;
    dst[r] = s < S ? src[(static_cast<int64_t>(b) * S + s) * H + h] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Shape& P, int qpos, int kpos) {
  bool ok = kpos < P.Skv && qpos < P.Sq;
  if (P.causal) ok = ok && kpos <= qpos;
  if (P.window > 0) ok = ok && kpos > qpos - P.window;
  return ok;
}

// For one (q tile, kv tile) pair in shared memory, rows q0 + ty*4 + i and
// keys k0 + tx + 16*j of this thread: P and dS into p_s / ds_s (row-major,
// [row][key]); p_s may be null (the dQ kernel needs dS only).
__device__ __forceinline__ void probs_and_ds(const Shape& P, const float* __restrict__ q_s,
                                             const float* __restrict__ do_s,
                                             const float* __restrict__ k_s,
                                             const float* __restrict__ v_s, int qk_stride,
                                             int v_stride, const float* __restrict__ lse_s,
                                             const float* __restrict__ delta_s, int q0, int k0,
                                             float* __restrict__ p_s, float* __restrict__ ds_s) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < P.D; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = load4(q_s + (ty * 4 + i) * qk_stride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = load4(k_s + (tx + 16 * j) * qk_stride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmaf_rn(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = __fmaf_rn(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = __fmaf_rn(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, s[i][j]);
      }
  }
  for (int c = 0; c < P.Dv; c += 4) {
    float4 ov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ov[i] = load4(do_s + (ty * 4 + i) * v_stride + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = load4(v_s + (tx + 16 * j) * v_stride + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dp[i][j] = __fmaf_rn(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = __fmaf_rn(ov[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = __fmaf_rn(ov[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = __fmaf_rn(ov[i].w, vv[j].w, dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx + 16 * j;
      // the reference's order: s * scale, then exp(s - lse); masked -> 0
      const float p = visible(P, q0 + r, k0 + key)
                          ? expf(__fmul_rn(s[i][j], P.sm_scale) - lse_s[r])
                          : 0.f;
      const float ds = __fmul_rn(__fmul_rn(p, dp[i][j] - delta_s[r]), P.sm_scale);
      if (p_s != nullptr) p_s[r * kPStride + key] = p;
      ds_s[r * kPStride + key] = ds;
    }
  }
}

// (a) delta = rowsum(do * o) in f32: one warp per (b, row, head)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int Dv) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  float acc = 0.f;
  for (int c = lane * 4; c < Dv; c += 128) {
    const float4 o = load4(out + w * Dv + c);
    const float4 d = load4(dout + w * Dv + c);
    acc = __fmaf_rn(o.x, d.x, acc);
    acc = __fmaf_rn(o.y, d.y, acc);
    acc = __fmaf_rn(o.z, d.z, acc);
    acc = __fmaf_rn(o.w, d.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[w] = acc;
}

// shared-memory layout of (b) and (c): four f32 tiles of 64 rows (q, do,
// k, v; strides D + 4 and Dv + 4), the dS tile, for (b) the P tile, and
// lse and delta of the q tile
__host__ __device__ constexpr size_t bwd_smem_floats(int D, int Dv, bool with_p) {
  return 2 * kT * (D + 4) + 2 * kT * (Dv + 4) + (with_p ? 2 : 1) * kT * kPStride + 2 * kT;
}

// (b) dK and dV of one 64-key tile of kv head hk, summed over its G query
// heads and every query tile the band leaves
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, Shape P) {
  extern __shared__ float4 smem_raw[];
  const int qk_stride = P.D + 4, v_stride = P.Dv + 4;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kT * qk_stride;
  float* do_s = k_s + kT * qk_stride;
  float* v_s = do_s + kT * v_stride;
  float* p_s = v_s + kT * v_stride;
  float* ds_s = p_s + kT * kPStride;
  float* lse_s = ds_s + kT * kPStride;
  float* delta_s = lse_s + kT;

  const int k0 = blockIdx.x * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(k_s, qk_stride, k, b, k0, P.Skv, P.Hkv, hk, P.D);
  load_tile(v_s, v_stride, v, b, k0, P.Skv, P.Hkv, hk, P.Dv);

  // query tiles that see a key of this tile: causal rows >= k0, windowed
  // rows < k0 + 63 + window
  const int q_lo = P.causal ? k0 : 0;
  int q_hi = P.Sq;
  if (P.window > 0) q_hi = min(q_hi, k0 + kT - 1 + P.window);

  // this thread's keys k0 + ty*4 + i, columns tx*4 + c and 64 + tx*4 + c
  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  const bool wide_k = P.D > 64, wide_v = P.Dv > 64;

  for (int g = 0; g < P.G; ++g) {
    const int h = hk * P.G + g;
    for (int q0 = (q_lo / kT) * kT; q0 < q_hi; q0 += kT) {
      load_tile(q_s, qk_stride, q, b, q0, P.Sq, P.Hq, h, P.D);
      load_tile(do_s, v_stride, dout, b, q0, P.Sq, P.Hq, h, P.Dv);
      load_rows(lse_s, lse, b, q0, P.Sq, P.Hq, h);
      load_rows(delta_s, delta, b, q0, P.Sq, P.Hq, h);
      __syncthreads();
      probs_and_ds(P, q_s, do_s, k_s, v_s, qk_stride, v_stride, lse_s, delta_s, q0, k0, p_s,
                   ds_s);
      __syncthreads();
      // dV += P^T . do, dK += dS^T . q over the tile's 64 rows
      for (int r = 0; r < kT; ++r) {
        const float4 pv = load4(p_s + r * kPStride + ty * 4);
        const float4 sv = load4(ds_s + r * kPStride + ty * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
        const float4 o0 = load4(do_s + r * v_stride + tx * 4);
        const float4 o1 = wide_v ? load4(do_s + r * v_stride + 64 + tx * 4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 x0 = load4(q_s + r * qk_stride + tx * 4);
        const float4 x1 = wide_k ? load4(q_s + r * qk_stride + 64 + tx * 4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float ov[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            acc_v[i][c] = __fmaf_rn(pr[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = __fmaf_rn(sr[i], xv[c], acc_k[i][c]);
          }
      }
      __syncthreads();                     // before the next q tile's loads
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= P.Skv) continue;
    const int64_t row = (static_cast<int64_t>(b) * P.Skv + key) * P.Hkv + hk;
    T* dst_k = dk + row * P.D;
    T* dst_v = dv + row * P.Dv;
    if (tx * 4 < P.D)
      put4(dst_k + tx * 4, make_float4(acc_k[i][0], acc_k[i][1], acc_k[i][2], acc_k[i][3]),
           P.accumulate);
    if (64 + tx * 4 < P.D)
      put4(dst_k + 64 + tx * 4, make_float4(acc_k[i][4], acc_k[i][5], acc_k[i][6], acc_k[i][7]),
           P.accumulate);
    if (tx * 4 < P.Dv)
      put4(dst_v + tx * 4, make_float4(acc_v[i][0], acc_v[i][1], acc_v[i][2], acc_v[i][3]),
           P.accumulate);
    if (64 + tx * 4 < P.Dv)
      put4(dst_v + 64 + tx * 4, make_float4(acc_v[i][4], acc_v[i][5], acc_v[i][6], acc_v[i][7]),
           P.accumulate);
  }
}

// (c) dQ of one 64-row query tile of head h over the key tiles of its band
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Shape P) {
  extern __shared__ float4 smem_raw[];
  const int qk_stride = P.D + 4, v_stride = P.Dv + 4;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kT * qk_stride;
  float* do_s = k_s + kT * qk_stride;
  float* v_s = do_s + kT * v_stride;
  float* ds_s = v_s + kT * v_stride;
  float* lse_s = ds_s + kT * kPStride;
  float* delta_s = lse_s + kT;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int q0 = qt * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / P.G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(q_s, qk_stride, q, b, q0, P.Sq, P.Hq, h, P.D);
  load_tile(do_s, v_stride, dout, b, q0, P.Sq, P.Hq, h, P.Dv);
  load_rows(lse_s, lse, b, q0, P.Sq, P.Hq, h);
  load_rows(delta_s, delta, b, q0, P.Sq, P.Hq, h);

  // key tiles that hold a visible key for some row of this tile
  int kv_lo = 0, kv_hi = P.Skv;
  if (P.causal) kv_hi = min(P.Skv, q0 + kT);
  if (P.window > 0) kv_lo = max(0, q0 - P.window + 1);

  // this thread's rows q0 + ty*4 + i, columns tx*4 + c and 64 + tx*4 + c
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  const bool wide = P.D > 64;

  for (int k0 = (kv_lo / kT) * kT; k0 < kv_hi; k0 += kT) {
    load_tile(k_s, qk_stride, k, b, k0, P.Skv, P.Hkv, hk, P.D);
    load_tile(v_s, v_stride, v, b, k0, P.Skv, P.Hkv, hk, P.Dv);
    __syncthreads();
    probs_and_ds(P, q_s, do_s, k_s, v_s, qk_stride, v_stride, lse_s, delta_s, q0, k0, nullptr,
                 ds_s);
    __syncthreads();
    // dQ += dS . k over the tile's 64 keys
    for (int j = 0; j < kT; j += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = load4(ds_s + (ty * 4 + i) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 k0v = load4(k_s + (j + jj) * qk_stride + tx * 4);
        const float4 k1v = wide ? load4(k_s + (j + jj) * qk_stride + 64 + tx * 4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float kv[8] = {k0v.x, k0v.y, k0v.z, k0v.w, k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = jj == 0 ? sv[i].x : jj == 1 ? sv[i].y : jj == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = __fmaf_rn(s, kv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                       // before the next tile's loads
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= P.Sq) continue;
    T* dst = dq + ((static_cast<int64_t>(b) * P.Sq + row) * P.Hq + h) * P.D;
    if (tx * 4 < P.D)
      put4(dst + tx * 4, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]), P.accumulate);
    if (64 + tx * 4 < P.D)
      put4(dst + 64 + tx * 4, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]),
           P.accumulate);
  }
}

// (a) over every (b, row, head): one warp each
template <typename T>
cudaError_t launch_delta(const T* out, const T* dout, float* delta, const Shape& P,
                         cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(P.B) * P.Sq * P.Hq;
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      out, dout, delta, rows, P.Dv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (attention_tile.cuh's fragments)
// ---------------------------------------------------------------------------
namespace at = attn_tile;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;          // tiles in flight of the walk
constexpr int kTileRows = at::kKeys;  // rows of every tile: 64 keys or 64 query rows
constexpr int kPairs = 4;           // (b): warp pairs, 16 keys each
constexpr int kDkdvThreads = 64 * kPairs;
constexpr int kDqThreads = 32 * 4;  // (c): 4 warps of 16 query rows
constexpr int kPairValues = 32 * 32;  // P of one pair: 32 values per lane, 4 per float4
constexpr float kLog2e = 1.4426950408889634f;

// blocks per SM: shared memory allows these, registers are capped to fit
template <int DP>
constexpr int kDkdvMinBlocks = DP <= 64 ? 2 : 1;
template <int DP>
constexpr int kDqMinBlocks = DP <= 64 ? 3 : DP <= 128 ? 2 : 1;

// (b): K, V, kStages x (Q, dO), the P exchange, kStages x (lse, delta)
template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * (2 + 2 * kStages) * at::Dims<DP>::kTileElems +
         sizeof(float) * (kPairs * kPairValues + kStages * 2 * kTileRows);
}

// (c): Q, dO, kStages x (K, V)
template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 + 2 * kStages) * at::Dims<DP>::kTileElems;
}

// Does the mask keep every (query, key) of query rows [q_a, q_b] and keys
// [k_a, k_b]?  Then a tile pair needs no per-element mask.
__device__ __forceinline__ bool all_visible(const Shape& P, int q_a, int q_b, int k_a,
                                            int k_b) {
  bool ok = q_b < P.Sq && k_b < P.Skv;
  if (P.causal) ok = ok && k_b <= q_a;
  if (P.window > 0) ok = ok && k_a > q_b - P.window;
  return ok;
}

// 4-byte asynchronous copy global -> shared (an f32 of a (B, S, H)
// tensor); `valid` false writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(at::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Rows [row0, row0 + 64) of head h of a (B, S, H, width) bf16 tensor into
// a 64-row tile of Dims<DP>::kStride by cp.async; rows at or past S and
// columns at or past width (up to DP) are zero-filled.  NT threads.
template <int DP, int NT>
__device__ __forceinline__ void load_tile_async(bf16* __restrict__ dst,
                                                const bf16* __restrict__ src, int b, int row0,
                                                int S, int H, int h, int width) {
  using Dm = at::Dims<DP>;
  for (int idx = threadIdx.x; idx < kTileRows * Dm::kChunks; idx += NT) {
    const int r = idx / Dm::kChunks, c = idx % Dm::kChunks;
    const int s = row0 + r;
    const bool ok = s < S && c * 8 < width;
    const bf16* p = ok ? src + ((static_cast<int64_t>(b) * S + s) * H + h) * width + c * 8 : src;
    at::cp_async16(dst + r * Dm::kStride + c * 8, p, ok);
  }
}

// The f32 values of rows [row0, row0 + 64) of head h of a (B, S, H) tensor
// by cp.async; rows at or past S read as zeros.  NT threads.
template <int NT>
__device__ __forceinline__ void load_rows_async(float* __restrict__ dst,
                                                const float* __restrict__ src, int b, int row0,
                                                int S, int H, int h) {
  for (int r = threadIdx.x; r < kTileRows; r += NT) {
    const int s = row0 + r;
    const bool ok = s < S;
    cp_async4(dst + r, ok ? src + (static_cast<int64_t>(b) * S + s) * H + h : src, ok);
  }
}

// x = A . B^T for one warp: A the 16 rows at `a` (its k16 fragments by
// ldmatrix), B the 64 rows of the tile `bt` (B operands by ldmatrix, rows
// as n), over `depth` columns (past it both are zero-padded); x in C
// layout: x[j][e] is row g + 8 (e >> 1), column 8 j + 2 t + (e & 1).
template <int DP>
__device__ __forceinline__ void rows_dot_rows(float x[8][4], const bf16* __restrict__ a,
                                              const bf16* __restrict__ bt, int depth, int lane) {
  constexpr int S = at::Dims<DP>::kStride;
  const int mi = lane >> 3, mr = lane & 7;   // which 8x8 matrix this lane addresses, which row
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
  const bf16* arow = a + ((mi & 1) * 8 + mr) * S + (mi >> 1) * 8;
  const bf16* brow = bt + ((mi >> 1) * 8 + mr) * S + (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 < depth) {
      uint32_t af[4];
      at::ldmatrix_x4(af, arow + kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        at::ldmatrix_x4(bf, brow + jp * 16 * S + kk * 16);
        at::mma_bf16(x[2 * jp], af, bf[0], bf[1]);
        at::mma_bf16(x[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc += X . B for one warp: X (16 x 64, C layout as rows_dot_rows gives
// it) as the A operand, each k16 step as hi + lo bf16 terms (lo first, then
// hi, into the same accumulator); B the 64-row tile `bt` ([k][n], by
// ldmatrix.trans); acc[n] holds output columns 8 n .. 8 n + 7, those at or
// past `width` are not computed.
template <int DP>
__device__ __forceinline__ void accumulate_split(float acc[DP / 8][4], const float x[8][4],
                                                 const bf16* __restrict__ bt, int width,
                                                 int lane) {
  constexpr int S = at::Dims<DP>::kStride;
  const int mi = lane >> 3, mr = lane & 7;
  const bf16* brow = bt + ((mi & 1) * 8 + mr) * S + (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ah[4], al[4];
    at::split_pair(x[2 * kk][0], x[2 * kk][1], ah[0], al[0]);           // row g,     k 0-7
    at::split_pair(x[2 * kk][2], x[2 * kk][3], ah[1], al[1]);           // row g + 8, k 0-7
    at::split_pair(x[2 * kk + 1][0], x[2 * kk + 1][1], ah[2], al[2]);   // row g,     k 8-15
    at::split_pair(x[2 * kk + 1][2], x[2 * kk + 1][3], ah[3], al[3]);   // row g + 8, k 8-15
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      if (n * 8 < width) {
        uint32_t bv[4];
        at::ldmatrix_x4_trans(bv, brow + kk * 16 * S + n * 8);
        at::mma_bf16(acc[n], al, bv[0], bv[1]);
        at::mma_bf16(acc[n + 1], al, bv[2], bv[3]);
        at::mma_bf16(acc[n], ah, bv[0], bv[1]);
        at::mma_bf16(acc[n + 1], ah, bv[2], bv[3]);
      }
    }
  }
}

// The warp's rows `row0` + g and + g + 8 of a (B, S, H, width) output from
// acc (C layout, columns below width): rounded once to bf16 into a bf16
// `out`, or, in accumulate mode, added in f32 to an f32 `out`; rows at or
// past S are not written.
template <int DP>
__device__ __forceinline__ void store_rows(void* __restrict__ out, const float acc[DP / 8][4],
                                           int b, int row0, int S, int H, int h, int width,
                                           int accumulate, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + g + 8 * r;
    if (s >= S) continue;
    const int64_t base = ((static_cast<int64_t>(b) * S + s) * H + h) * width;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c >= width) continue;
      if (accumulate) {
        float2* dst = reinterpret_cast<float2*>(static_cast<float*>(out) + base + c);
        const float2 o = *dst;
        *dst = make_float2(o.x + acc[n][2 * r], o.y + acc[n][2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + base + c) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

// (b) dK and dV of one 64-key tile of kv head hk, summed over its G query
// heads and every query tile the band leaves.  Warp w < 4 ("P warp")
// computes S^T, P and dV for keys k0 + 16 w .. + 15; warp w + 4 ("dS warp")
// dP^T, dS and dK for the same keys.
template <int DP>
__global__ void __launch_bounds__(kDkdvThreads, kDkdvMinBlocks<DP>)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          void* __restrict__ dk, void* __restrict__ dv, Shape P) {
  using Dm = at::Dims<DP>;
  constexpr int T = Dm::kTileElems;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(bwd_smem);
  bf16* v_s = k_s + T;
  bf16* qdo_s = v_s + T;                                       // [stage][Q, dO]
  float* p_x = reinterpret_cast<float*>(qdo_s + kStages * 2 * T);   // [pair][n8][lane][4]
  float* rows_s = p_x + kPairs * kPairValues;                  // [stage][lse, delta][64]

  const int kt = blockIdx.z;                                    // low key tiles walk longest
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = kt * kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp % kPairs;
  const bool p_warp = warp < kPairs;
  const int kw = k0 + 16 * pair;                                // the pair's first key
  const int g = lane >> 2, t = lane & 3;
  const int width = p_warp ? P.Dv : P.D;                        // of dV or dK

  load_tile_async<DP, kDkdvThreads>(k_s, k, b, k0, P.Skv, P.Hkv, hk, P.D);
  load_tile_async<DP, kDkdvThreads>(v_s, v, b, k0, P.Skv, P.Hkv, hk, P.Dv);

  // query tiles that see a key of this tile: causal rows >= k0, windowed
  // rows < k0 + 63 + window; walked head by head
  const int qt0 = P.causal ? k0 / kTileRows : 0;
  int q_hi = P.Sq;
  if (P.window > 0) q_hi = min(q_hi, k0 + kTileRows - 1 + P.window);
  const int n_qt = max(0, (q_hi + kTileRows - 1) / kTileRows - qt0);
  const int n_items = P.G * n_qt;

  auto load_item = [&](int i, int buf) {
    const int h = hk * P.G + i / n_qt;
    const int q0 = (qt0 + i % n_qt) * kTileRows;
    bf16* q_s = qdo_s + 2 * buf * T;
    load_tile_async<DP, kDkdvThreads>(q_s, q, b, q0, P.Sq, P.Hq, h, P.D);
    load_tile_async<DP, kDkdvThreads>(q_s + T, dout, b, q0, P.Sq, P.Hq, h, P.Dv);
    float* r_s = rows_s + 2 * buf * kTileRows;
    load_rows_async<kDkdvThreads>(r_s, lse, b, q0, P.Sq, P.Hq, h);
    load_rows_async<kDkdvThreads>(r_s + kTileRows, delta, b, q0, P.Sq, P.Hq, h);
  };
  if (n_items > 0) load_item(0, 0);
  at::cp_async_commit();

  float acc[DP / 8][4];                 // dV (P warps) or dK (dS warps), keys kw + g, + g + 8
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* px = p_x + pair * kPairValues + 4 * lane;   // this lane's float4 of each n8 block

  for (int i = 0; i < n_items; ++i) {
    // item i has landed, and every warp is done with item i - 1: its
    // stage and the P exchange may be written again
    at::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_items) load_item(i + 1, (i + 1) % kStages);
    at::cp_async_commit();
    const int buf = i % kStages;
    const int q0 = (qt0 + i % n_qt) * kTileRows;
    const bf16* q_s = qdo_s + 2 * buf * T;
    const bf16* do_s = q_s + T;
    const float* lse_s = rows_s + 2 * buf * kTileRows;
    const float* delta_s = lse_s + kTileRows;
    // does the mask keep any (query, key) of the tile's rows and the
    // pair's keys?  (both warps of a pair decide alike)
    bool work = kw < P.Skv;
    if (P.causal) work = work && kw <= min(q0 + kTileRows, P.Sq) - 1;
    if (P.window > 0) work = work && kw + 15 > q0 - P.window;

    float x[8][4];                      // S^T then P (P warps); dP^T then dS (dS warps)
    if (work) {
      if (p_warp) {
        rows_dot_rows<DP>(x, k_s + 16 * pair * Dm::kStride, q_s, P.D, lane);
        // the reference's order: s * scale, then exp(s - lse); P = 0 where
        // the forward's mask drops the pair (tested per element only on
        // tile pairs the mask cuts)
        auto probs = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = j * 8 + 2 * t;                        // query rows c, c + 1 of the tile
            const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = at::ex2(
                  __fmul_rn(__fmul_rn(x[j][e], P.sm_scale) - ((e & 1) ? l.y : l.x), kLog2e));
              if (decltype(masked)::value && !visible(P, q0 + c + (e & 1), kw + g + 8 * (e >> 1)))
                p = 0.f;
              x[j][e] = p;
            }
            *reinterpret_cast<float4*>(px + 128 * j) =
                make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
          }
        };
        if (all_visible(P, q0, q0 + kTileRows - 1, kw, kw + 15))
          probs(std::false_type{});
        else
          probs(std::true_type{});
      } else {
        rows_dot_rows<DP>(x, v_s + 16 * pair * Dm::kStride, do_s, P.Dv, lane);
      }
    }
    __syncthreads();                    // the pairs' P is in p_x
    if (work) {
      if (!p_warp) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(delta_s + j * 8 + 2 * t);
          const float4 p = *reinterpret_cast<const float4*>(px + 128 * j);
          x[j][0] = __fmul_rn(__fmul_rn(p.x, x[j][0] - d.x), P.sm_scale);
          x[j][1] = __fmul_rn(__fmul_rn(p.y, x[j][1] - d.y), P.sm_scale);
          x[j][2] = __fmul_rn(__fmul_rn(p.z, x[j][2] - d.x), P.sm_scale);
          x[j][3] = __fmul_rn(__fmul_rn(p.w, x[j][3] - d.y), P.sm_scale);
        }
      }
      // dV += P^T . dO or dK += dS^T . Q
      accumulate_split<DP>(acc, x, p_warp ? do_s : q_s, width, lane);
    }
  }
  at::cp_async_wait<0>();               // nothing in flight at exit (no query tile walked)

  store_rows<DP>(p_warp ? dv : dk, acc, b, kw, P.Skv, P.Hkv, hk, width, P.accumulate, lane);
}

// (c) dQ of one 64-row query tile of head h over the key tiles of its
// band; warp w owns rows q0 + 16 w .. + 15
template <int DP>
__global__ void __launch_bounds__(kDqThreads, kDqMinBlocks<DP>)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        void* __restrict__ dq, Shape P) {
  using Dm = at::Dims<DP>;
  constexpr int T = Dm::kTileElems;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(bwd_smem);
  bf16* do_s = q_s + T;
  bf16* kv_s = do_s + T;                                        // [stage][K, V]

  const int qt = gridDim.z - 1 - blockIdx.z;                    // longest causal rows first
  const int q0 = qt * kTileRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / P.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = q0 + 16 * warp;                                // the warp's first row
  const int g = lane >> 2, t = lane & 3;

  load_tile_async<DP, kDqThreads>(q_s, q, b, q0, P.Sq, P.Hq, h, P.D);
  load_tile_async<DP, kDqThreads>(do_s, dout, b, q0, P.Sq, P.Hq, h, P.Dv);
  // lse and delta of rows w0 + g and w0 + g + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    const int64_t idx = (static_cast<int64_t>(b) * P.Sq + row) * P.Hq + h;
    lse_r[r] = row < P.Sq ? lse[idx] : 0.f;
    delta_r[r] = row < P.Sq ? delta[idx] : 0.f;
  }

  // key tiles that hold a visible key for some row of this tile
  int kv_lo = 0, kv_hi = P.Skv;
  if (P.causal) kv_hi = min(P.Skv, q0 + kTileRows);
  if (P.window > 0) kv_lo = max(0, q0 - P.window + 1);
  const int t_begin = kv_lo / kTileRows;
  const int n_tiles = max(0, (kv_hi + kTileRows - 1) / kTileRows - t_begin);

  auto load_kv = [&](int i, int buf) {
    const int kv0 = (t_begin + i) * kTileRows;
    bf16* k_t = kv_s + 2 * buf * T;
    load_tile_async<DP, kDqThreads>(k_t, k, b, kv0, P.Skv, P.Hkv, hk, P.D);
    load_tile_async<DP, kDqThreads>(k_t + T, v, b, kv0, P.Skv, P.Hkv, hk, P.Dv);
  };
  if (n_tiles > 0) load_kv(0, 0);
  at::cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    at::cp_async_wait<0>();
    __syncthreads();                    // tile i landed; every warp is done with i - 1
    if (i + 1 < n_tiles) load_kv(i + 1, (i + 1) % kStages);
    at::cp_async_commit();
    const int kv0 = (t_begin + i) * kTileRows;
    const bf16* k_t = kv_s + 2 * (i % kStages) * T;
    const bf16* v_t = k_t + T;
    bool work = w0 < P.Sq;
    if (P.causal) work = work && kv0 <= w0 + 15;
    if (P.window > 0) work = work && kv0 + kTileRows - 1 > w0 - P.window;
    if (!work) continue;

    // S = Q . K^T, then P in place
    float x[8][4], dp[8][4];
    rows_dot_rows<DP>(x, q_s + 16 * warp * Dm::kStride, k_t, P.D, lane);
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = at::ex2(__fmul_rn(__fmul_rn(x[j][e], P.sm_scale) - lse_r[r], kLog2e));
          if (decltype(masked)::value &&
              !visible(P, w0 + g + 8 * r, kv0 + j * 8 + 2 * t + (e & 1)))
            p = 0.f;
          x[j][e] = p;
        }
    };
    if (all_visible(P, w0, w0 + 15, kv0, kv0 + kTileRows - 1))
      probs(std::false_type{});
    else
      probs(std::true_type{});
    // dP = dO . V^T, then dS in place of P
    rows_dot_rows<DP>(dp, do_s + 16 * warp * Dm::kStride, v_t, P.Dv, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = __fmul_rn(__fmul_rn(x[j][e], dp[j][e] - delta_r[e >> 1]), P.sm_scale);
    // dQ += dS . K
    accumulate_split<DP>(acc, x, k_t, P.D, lane);
  }
  at::cp_async_wait<0>();

  store_rows<DP>(dq, acc, b, w0, P.Sq, P.Hq, h, P.D, P.accumulate, lane);
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, const Shape& P,
               cudaStream_t stream) {
  static bool configured = false;          // opt in to > 48 KiB once per width
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(dkdv_smem_bytes<DP>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem_bytes<DP>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const bf16* q_t = static_cast<const bf16*>(q);
  const bf16* k_t = static_cast<const bf16*>(k);
  const bf16* v_t = static_cast<const bf16*>(v);
  const bf16* do_t = static_cast<const bf16*>(dout);

  cudaError_t err = launch_delta(static_cast<const bf16*>(out), do_t, delta, P, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  // tiles on z, heads on x: the longest walks go out first across heads
  const dim3 grid_kv(P.Hkv, P.B, (P.Skv + kTileRows - 1) / kTileRows);
  flash_bwd_dkdv_mma_kernel<DP><<<grid_kv, kDkdvThreads, dkdv_smem_bytes<DP>(), stream>>>(
      q_t, k_t, v_t, do_t, lse, delta, dk, dv, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q(P.Hq, P.B, (P.Sq + kTileRows - 1) / kTileRows);
  flash_bwd_dq_mma_kernel<DP><<<grid_q, kDqThreads, dq_smem_bytes<DP>(), stream>>>(
      q_t, k_t, v_t, do_t, lse, delta, dq, P);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------
int launch_fma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, const Shape& P,
               cudaStream_t stream) {
  using T = float;
  static bool configured = false;          // opt in to > 48 KiB once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * bwd_smem_floats(kMaxD, kMaxD, true)));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        flash_bwd_dq_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * bwd_smem_floats(kMaxD, kMaxD, false)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* do_t = static_cast<const T*>(dout);

  cudaError_t err = launch_delta(static_cast<const T*>(out), do_t, delta, P, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = sizeof(float) * bwd_smem_floats(P.D, P.Dv, true);
  const dim3 grid_kv((P.Skv + kT - 1) / kT, P.Hkv, P.B);
  flash_bwd_dkdv_fma_kernel<T><<<grid_kv, kThreads, smem_kv, stream>>>(
      q_t, k_t, v_t, do_t, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = sizeof(float) * bwd_smem_floats(P.D, P.Dv, false);
  const dim3 grid_q((P.Sq + kT - 1) / kT, P.Hq, P.B);
  flash_bwd_dq_fma_kernel<T><<<grid_q, kThreads, smem_q, stream>>>(q_t, k_t, v_t, do_t, lse,
                                                                   delta, static_cast<T*>(dq), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one block of the dK/dV kernel (kernel = 0) or the dQ
// kernel (kernel = 1) at head dims D and Dv, for dtype 0 = f32 (FMA) or
// 1 = bf16 (tensor cores), bytes; 0 for head dims no kernel takes.
size_t flash_attention_bwd_smem_bytes(int D, int Dv, int dtype, int kernel) {
  if (dtype == 0)
    return D <= kMaxD && Dv <= kMaxD ? sizeof(float) * bwd_smem_floats(D, Dv, kernel == 0) : 0;
  switch (at::tile_width(D, Dv)) {
    case 32: return kernel == 0 ? dkdv_smem_bytes<32>() : dq_smem_bytes<32>();
    case 64: return kernel == 0 ? dkdv_smem_bytes<64>() : dq_smem_bytes<64>();
    case 128: return kernel == 0 ? dkdv_smem_bytes<128>() : dq_smem_bytes<128>();
    case 256: return kernel == 0 ? dkdv_smem_bytes<256>() : dq_smem_bytes<256>();
    default: return 0;
  }
}

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out and dout
// (B, Sq, Hq, Dv) in one type (dtype 0 = f32: D, Dv multiples of 4 up to
// 128, the FMA kernels; 1 = bf16: multiples of 8 up to 256, the tensor
// cores), lse (B, Sq, Hq) f32 from the forward, delta an f32 (B, Sq, Hq)
// scratch buffer; writes dq, dk, dv shaped and typed as q, k, v, or, with
// accumulate = 1, adds the f32 gradients into f32 dq, dk, dv shaped as q,
// k, v (each element once, by the one block that owns it: a ring of
// shards sums its partials in f32 and rounds once).  All contiguous,
// 16-byte aligned.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv,
                        int causal, int window, int accumulate, int dtype, float sm_scale,
                        void* stream) {
  const int step = dtype == 1 ? 8 : 4;
  const int max_d = dtype == 1 ? 256 : kMaxD;
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D % step || Dv % step ||
      D < step || Dv < step || D > max_d || Dv > max_d || window < 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1) || (accumulate != 0 && accumulate != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape P{B, Sq, Skv, Hq, Hkv, Hq / Hkv, D, Dv, causal, window, sm_scale, accumulate};
  const auto st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0) return launch_fma(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
  switch (at::tile_width(D, Dv)) {
    case 32: return launch_mma<32>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
    case 64: return launch_mma<64>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
    case 128: return launch_mma<128>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
    case 256: return launch_mma<256>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
