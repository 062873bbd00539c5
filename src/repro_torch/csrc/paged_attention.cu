// Paged decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   - the serial kernel <- paged_attention_pallas (_paged_kernel,
//     _flash_step): one online-softmax chain over every page of a row;
//   - the split-K kernel + paged_attention_combine_kernel
//     <- paged_attention_splitk_pallas (_splitk_kernel and the jnp combine):
//     flash decoding, private (acc, m, l) partials per split of
//     `pages_per_split` pages, merged by m = max_s m_s and exp(m_s - m).
//
// What they compute (the contract of tests/test_paged_kernels.py):
//   row b of q (B, Hq, D) attends the first ctx_lens[b] tokens of table row
//   row_map[b] of block_tables (T, W); token t lives in slot t % page of
//   pool page block_tables[row_map[b], t / page].  Query head h reads kv
//   head h / G (G = Hq / Hkv).  sm_scale = D^-0.5.  NEG_INF = -1e30 is
//   finite, the probabilities are multiplied by the mask and l is clamped
//   at 1e-30, so a row with ctx 0 returns exact zeros.  int8 pools carry
//   bf16 per-(slot, head) scales.
//
// Bound: device-memory bytes.  Every K/V element a row reads is used for
// 2 * G multiply-adds, far below the H100's ~295 operations per byte, so
// the time floor is the K/V pages read over 3.35 TB/s, counted once per
// table row: the rows of one prefill chunk share their table row.
//
// Two variants, chosen by dtype (the wrapper picks; both always built):
//
//   - bf16 queries over bf16 or int8 pages (paged_attention_mma, the
//     serving path).  A plan kernel cuts the launch into M tiles of
//     consecutive rows that share a table row (the rows of a prefill chunk;
//     at most 64 (row, query head) pairs) on the device, with no host
//     sync, and lists the (tile, split) work.  A tile of more than one
//     pair runs on the tensor cores (attention_tile.cuh), so each page is
//     loaded once per tile, not once per row: 4 warps of 16 pairs, the
//     pages of a step (64 slots) copied with 16-byte cp.async, three steps
//     in flight, and consecutive splits of a tile walked by one block when
//     the launch has work enough for the card.  A tile of one pair (a
//     decode row of an MHA stack) keeps a block per (row, head, split)
//     and takes a one-row FMA step over the same landed pages, many
//     blocks per SM: its gain is vectorised copies and pages in
//     flight, not the tensor cores.  At head dim 256 (RecurrentGemma-2B,
//     G = 10) the tensor-core walk keeps Q in shared memory
//     (attention_tile.cuh, kSmemQ) and two page steps in flight, not
//     three (three would pass the 227 KB a block may take), and the
//     one-row walk gives each thread two output columns.  int8 pages
//     are widened to bf16
//     exactly (|x| <= 127); the K scale multiplies the f32 score after the
//     product, the V scale is folded into P.  The serial kernel is the same
//     walk over one split that spans the table, so serial and split-K
//     compute every score alike and their m agree bit for bit (max is
//     exact).
//   - f32 queries or f32 pools (the FMA kernels): one block per (query
//     row, kv head[, split]), scores as FMA dot products (one warp per
//     token, lanes over D) through the one routine `token_score`, the
//     online-softmax state in shared memory, plain loads; f32 holds 1e-5.
//
// Both walk only the pages a row's (tile's) ctx reaches: for a fully
// masked page p = 0 and m is unchanged, so stopping early gives the same
// result bit for bit.
//
// Plain C interface (loaded with ctypes); every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Problem {
  int B, Hq, Hkv, G, D, Dv, page, T, W, n_pool;
  float sm_scale;
};

// Score of query head g (already in shared memory, f32) against the K row
// of pool page `pg`, slot `t`, kv head `h`.  Called by one whole warp;
// the result is valid in lane 0.  Lanes take d = lane, lane + 32, ... and
// the partial sums are folded with shfl_down: a fixed order, so the same
// inputs give the same bits in both kernels.
template <typename TKV, bool QUANT>
__device__ __forceinline__ float token_score(const float* __restrict__ q_g,
                                             const TKV* __restrict__ k_pool,
                                             const __nv_bfloat16* __restrict__ k_scale,
                                             int pg, int t, int h, const Problem& P,
                                             int lane) {
  const int64_t slot = static_cast<int64_t>(pg) * P.page + t;
  const TKV* k_row = k_pool + (slot * P.Hkv + h) * P.D;
  float ks = 1.f;
  if (QUANT) ks = __bfloat162float(k_scale[slot * P.Hkv + h]);
  float acc = 0.f;
  for (int d = lane; d < P.D; d += 32) {
    float k = to_f(k_row[d]);
    if (QUANT) k = __fmul_rn(k, ks);
    acc = __fmaf_rn(q_g[d], k, acc);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  return __fmul_rn(acc, P.sm_scale);
}

// Shared-memory layout of one block (all f32):
//   q_s [G][D]  acc_s [G][Dv]  s_s [G][page]  p_s [G][page]  m_s, l_s, c_s [G]
struct Smem {
  float *q, *acc, *s, *p, *m, *l, *c;
  __device__ Smem(float* base, const Problem& P) {
    q = base;
    acc = q + P.G * P.D;
    s = acc + P.G * P.Dv;
    p = s + P.G * P.page;
    m = p + P.G * P.page;
    l = m + P.G;
    c = l + P.G;
  }
};

// Load the G query heads of (row b, kv head h) as f32 and reset the
// online-softmax state.
template <typename TQ>
__device__ void init_block(const TQ* __restrict__ q, int b, int h, const Problem& P,
                           Smem& S) {
  const TQ* q_b = q + (static_cast<int64_t>(b) * P.Hq + h * P.G) * P.D;
  for (int i = threadIdx.x; i < P.G * P.D; i += blockDim.x) S.q[i] = to_f(q_b[i]);
  for (int i = threadIdx.x; i < P.G * P.Dv; i += blockDim.x) S.acc[i] = 0.f;
  for (int g = threadIdx.x; g < P.G; g += blockDim.x) {
    S.m[g] = kNegInf;
    S.l[g] = 0.f;
  }
  __syncthreads();
}

// One page's online-softmax update of (m, l, acc): the Pallas _flash_step.
// `page_start` is the absolute position of the page's slot 0.
template <typename TKV, bool QUANT>
__device__ void flash_page(const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
                           const __nv_bfloat16* __restrict__ k_scale,
                           const __nv_bfloat16* __restrict__ v_scale, int pg,
                           int page_start, int ctx, int h, const Problem& P, Smem& S) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // 1. scores, masked to NEG_INF beyond ctx
  for (int i = warp; i < P.G * P.page; i += kWarps) {
    const int g = i / P.page, t = i % P.page;
    float sc = kNegInf;  // warp-uniform branch: masked slots load no K
    if (page_start + t < ctx)
      sc = token_score<TKV, QUANT>(S.q + g * P.D, k_pool, k_scale, pg, t, h, P, lane);
    if (lane == 0) S.s[i] = sc;
  }
  __syncthreads();
  // 2. running max, masked probabilities, l and the rescale factor
  for (int g = threadIdx.x; g < P.G; g += blockDim.x) {
    const float m_prev = S.m[g];
    float m_new = m_prev;
    for (int t = 0; t < P.page; ++t) m_new = fmaxf(m_new, S.s[g * P.page + t]);
    float psum = 0.f;
    for (int t = 0; t < P.page; ++t) {
      const float mask = (page_start + t < ctx) ? 1.f : 0.f;
      const float pt = __fmul_rn(expf(S.s[g * P.page + t] - m_new), mask);
      S.p[g * P.page + t] = pt;
      psum += pt;
    }
    const float corr = expf(m_prev - m_new);
    S.l[g] = __fmaf_rn(S.l[g], corr, psum);
    S.c[g] = corr;
    S.m[g] = m_new;
  }
  __syncthreads();
  // 3. acc = acc * corr + p @ V; masked slots have p = 0 and are skipped
  const int n_valid = min(P.page, ctx - page_start);
  for (int i = threadIdx.x; i < P.G * P.Dv; i += blockDim.x) {
    const int g = i / P.Dv, dv = i % P.Dv;
    float a = S.acc[i] * S.c[g];
    for (int t = 0; t < n_valid; ++t) {
      const int64_t slot = static_cast<int64_t>(pg) * P.page + t;
      float v = to_f(v_pool[(slot * P.Hkv + h) * P.Dv + dv]);
      if (QUANT) v = __fmul_rn(v, __bfloat162float(v_scale[slot * P.Hkv + h]));
      a = __fmaf_rn(S.p[g * P.page + t], v, a);
    }
    S.acc[i] = a;
  }
  // the next page's step 1 writes only s_s; its __syncthreads orders
  // step 3 here before step 2 there rewrites p_s and c_s
}

// Indices are clamped into range, as XLA clamps gathers, so a bad table
// or row map reads a wrong page but never memory outside the pool.
__device__ __forceinline__ int table_row(const int* __restrict__ row_map, int b,
                                         const Problem& P) {
  return min(max(row_map[b], 0), P.T - 1);
}

__device__ __forceinline__ int table_page(const int* __restrict__ tables, int row, int j,
                                          const Problem& P) {
  // pages past the table's width read page 0 (the split-K padding of the
  // Pallas kernel); ctx masks them whenever ctx <= W * page
  const int pg = j < P.W ? tables[static_cast<int64_t>(row) * P.W + j] : 0;
  return min(max(pg, 0), P.n_pool - 1);
}

template <typename TQ, typename TKV, bool QUANT, bool STATS>
__global__ void __launch_bounds__(kThreads)
paged_attention_serial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                              const TKV* __restrict__ v_pool,
                              const __nv_bfloat16* __restrict__ k_scale,
                              const __nv_bfloat16* __restrict__ v_scale,
                              const int* __restrict__ tables, const int* __restrict__ row_map,
                              const int* __restrict__ ctx_lens, TQ* __restrict__ out,
                              float* __restrict__ m_out, float* __restrict__ l_out, Problem P) {
  extern __shared__ float smem[];
  Smem S(smem, P);
  const int b = blockIdx.x, h = blockIdx.y;
  const int row = table_row(row_map, b, P), ctx = ctx_lens[b];
  init_block(q, b, h, P, S);
  const int n_pages = min(P.W, (max(ctx, 0) + P.page - 1) / P.page);
  for (int j = 0; j < n_pages; ++j)
    flash_page<TKV, QUANT>(k_pool, v_pool, k_scale, v_scale, table_page(tables, row, j, P),
                           j * P.page, ctx, h, P, S);
  __syncthreads();
  const int64_t head0 = static_cast<int64_t>(b) * P.Hq + h * P.G;
  for (int i = threadIdx.x; i < P.G * P.Dv; i += blockDim.x) {
    const int g = i / P.Dv, dv = i % P.Dv;
    out[(head0 + g) * P.Dv + dv] = from_f<TQ>(S.acc[i] / fmaxf(S.l[g], 1e-30f));
  }
  if (STATS) {
    for (int g = threadIdx.x; g < P.G; g += blockDim.x) {
      m_out[head0 + g] = S.m[g];
      l_out[head0 + g] = S.l[g];
    }
  }
}

// Partials: acc_p (B, Hkv, S, G, Dv), m_p / l_p (B, Hkv, S, G), all f32.
template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                             const TKV* __restrict__ v_pool,
                             const __nv_bfloat16* __restrict__ k_scale,
                             const __nv_bfloat16* __restrict__ v_scale,
                             const int* __restrict__ tables, const int* __restrict__ row_map,
                             const int* __restrict__ ctx_lens, int pages_per_split,
                             float* __restrict__ acc_p, float* __restrict__ m_p,
                             float* __restrict__ l_p, Problem P) {
  extern __shared__ float smem[];
  Smem S(smem, P);
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z, n_splits = gridDim.z;
  const int row = table_row(row_map, b, P), ctx = ctx_lens[b];
  init_block(q, b, h, P, S);
  const int j0 = s * pages_per_split;
  const int j1 = min(j0 + pages_per_split, (max(ctx, 0) + P.page - 1) / P.page);
  for (int j = j0; j < j1; ++j)
    flash_page<TKV, QUANT>(k_pool, v_pool, k_scale, v_scale, table_page(tables, row, j, P),
                           j * P.page, ctx, h, P, S);
  __syncthreads();
  const int64_t part = (static_cast<int64_t>(b) * P.Hkv + h) * n_splits + s;
  for (int i = threadIdx.x; i < P.G * P.Dv; i += blockDim.x) acc_p[part * P.G * P.Dv + i] = S.acc[i];
  for (int g = threadIdx.x; g < P.G; g += blockDim.x) {
    m_p[part * P.G + g] = S.m[g];
    l_p[part * P.G + g] = S.l[g];
  }
}

// One warp per (row, query head), four per block: m = max_s m_s,
// partials rescaled by exp(m_s - m), one division.  Lane s holds split s
// (and s + 32, ...) for the max and the sum; each lane owns 4 output
// columns of every 128.
//
// Only the splits that start below ctx are read: a split at or past ctx
// is (NEG_INF, 0, 0), whose terms are exact zeros (exp(-1e30 - m) = 0),
// so leaving it out changes no bit; the tensor-core kernels do not write
// such splits at all.  A row with ctx 0 reads none and gets m = NEG_INF,
// l = 0 and exact zeros.
template <typename TQ, bool STATS>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ acc_p, const float* __restrict__ m_p,
                               const float* __restrict__ l_p,
                               const int* __restrict__ ctx_lens, int n_splits,
                               int split_len, TQ* __restrict__ out,
                               float* __restrict__ m_out, float* __restrict__ l_out,
                               Problem P) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= static_cast<int64_t>(P.B) * P.Hq) return;
  const int b = static_cast<int>(pair / P.Hq), hq = static_cast<int>(pair % P.Hq);
  const int h = hq / P.G, g = hq % P.G;
  const int64_t base = (static_cast<int64_t>(b) * P.Hkv + h) * n_splits;
  const int ctx = min(max(ctx_lens[b], 0), n_splits * split_len);
  const int n_valid = (ctx + split_len - 1) / split_len;
  float m = kNegInf;
  for (int s = lane; s < n_valid; s += 32) m = fmaxf(m, m_p[(base + s) * P.G + g]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float l = 0.f;
  for (int s = lane; s < n_valid; s += 32)
    l = __fmaf_rn(l_p[(base + s) * P.G + g], expf(m_p[(base + s) * P.G + g] - m), l);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  const int64_t o = (static_cast<int64_t>(b) * P.Hq + hq) * P.Dv;
  // 4 columns a lane; every lane runs every pass, since each pass
  // shuffles the split weights across the whole warp (at Dv < 128 the
  // lanes past Dv only relay them)
  for (int d0 = 0; d0 < P.Dv; d0 += 128) {
    const int dv0 = d0 + 4 * lane;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < n_valid; s0 += 32) {
      const int s = s0 + lane;
      const float alpha = s < n_valid ? expf(m_p[(base + s) * P.G + g] - m) : 0.f;
      const int n = min(32, n_valid - s0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {          // independent loads: unrolled, in flight together
        const float al = __shfl_sync(0xffffffffu, alpha, k);
        const float* src = acc_p + ((base + s0 + k) * P.G + g) * P.Dv + dv0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (dv0 + e < P.Dv) a[e] = __fmaf_rn(src[e], al, a[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (dv0 + e < P.Dv) out[o + dv0 + e] = from_f<TQ>(a[e] * inv_l);
  }
  if (STATS && lane == 0) {
    m_out[pair] = m;
    l_out[pair] = l;
  }
}

size_t smem_bytes(const Problem& P) {
  return sizeof(float) *
         (static_cast<size_t>(P.G) * (P.D + P.Dv + 2 * P.page) + 3 * static_cast<size_t>(P.G));
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale;
  const int *tables, *row_map, *ctx_lens;
};

template <typename TQ, typename TKV, bool QUANT>
void launch_serial(const Args& a, void* out, float* m_out, float* l_out, const Problem& P,
                   cudaStream_t st) {
  const dim3 grid(P.B, P.Hkv);
  const size_t sm = smem_bytes(P);
  const auto* q = static_cast<const TQ*>(a.q);
  const auto* kp = static_cast<const TKV*>(a.k_pool);
  const auto* vp = static_cast<const TKV*>(a.v_pool);
  const auto* ks = static_cast<const __nv_bfloat16*>(a.k_scale);
  const auto* vs = static_cast<const __nv_bfloat16*>(a.v_scale);
  if (m_out != nullptr)
    paged_attention_serial_kernel<TQ, TKV, QUANT, true><<<grid, kThreads, sm, st>>>(
        q, kp, vp, ks, vs, a.tables, a.row_map, a.ctx_lens, static_cast<TQ*>(out), m_out,
        l_out, P);
  else
    paged_attention_serial_kernel<TQ, TKV, QUANT, false><<<grid, kThreads, sm, st>>>(
        q, kp, vp, ks, vs, a.tables, a.row_map, a.ctx_lens, static_cast<TQ*>(out), m_out,
        l_out, P);
}

template <typename TQ>
void launch_combine(const float* acc_p, const float* m_p, const float* l_p,
                    const int* ctx_lens, int n_splits, int split_len, void* out,
                    float* m_out, float* l_out, const Problem& P, cudaStream_t st) {
  const int64_t pairs = static_cast<int64_t>(P.B) * P.Hq;
  const dim3 grid(static_cast<unsigned>((pairs + kWarps - 1) / kWarps));
  if (m_out != nullptr)
    paged_attention_combine_kernel<TQ, true><<<grid, kThreads, 0, st>>>(
        acc_p, m_p, l_p, ctx_lens, n_splits, split_len, static_cast<TQ*>(out), m_out, l_out,
        P);
  else
    paged_attention_combine_kernel<TQ, false><<<grid, kThreads, 0, st>>>(
        acc_p, m_p, l_p, ctx_lens, n_splits, split_len, static_cast<TQ*>(out), m_out, l_out,
        P);
}

template <typename TQ, typename TKV, bool QUANT>
void launch_splitk(const Args& a, int pages_per_split, int n_splits, float* acc_p, float* m_p,
                   float* l_p, void* out, float* m_out, float* l_out, const Problem& P,
                   cudaStream_t st) {
  const size_t sm = smem_bytes(P);
  paged_attention_split_kernel<TQ, TKV, QUANT><<<dim3(P.B, P.Hkv, n_splits), kThreads, sm, st>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), a.tables, a.row_map, a.ctx_lens,
      pages_per_split, acc_p, m_p, l_p, P);
  launch_combine<TQ>(acc_p, m_p, l_p, a.ctx_lens, n_splits, pages_per_split * P.page, out,
                     m_out, l_out, P, st);
}

// Expand the runtime (q dtype, kv dtype, quant) triple into a template
// instantiation of the FMA kernels: f32 queries over every pool type, and
// bf16 queries over f32 pools (bf16 queries over bf16 or int8 pools take
// the tensor-core path).  Returns false for a combination they do not take.
template <typename F>
bool dispatch(int q_dtype, int kv_dtype, int quant, F&& f) {
  auto with_quant = [&](auto q_tag, auto kv_tag) {
    if (quant)
      f(q_tag, kv_tag, std::true_type{});
    else
      f(q_tag, kv_tag, std::false_type{});
    return true;
  };
  if (q_dtype == kF32) {
    if (kv_dtype == kF32) return with_quant(float{}, float{});
    if (kv_dtype == kBF16) return with_quant(float{}, __nv_bfloat16{});
    if (kv_dtype == kI8) return with_quant(float{}, int8_t{});
  }
  if (q_dtype == kBF16 && kv_dtype == kF32) return with_quant(__nv_bfloat16{}, float{});
  return false;
}

Problem make_problem(int B, int Hq, int Hkv, int D, int Dv, int page, int T, int W,
                     int n_pool, float sm_scale) {
  Problem P;
  P.B = B;
  P.Hq = Hq;
  P.Hkv = Hkv;
  P.G = Hq / Hkv;
  P.D = D;
  P.Dv = Dv;
  P.page = page;
  P.T = T;
  P.W = W;
  P.n_pool = n_pool;
  P.sm_scale = sm_scale;
  return P;
}

// ---------------------------------------------------------------------------
// bf16 queries over bf16 or int8 pages: the tensor-core path
// ---------------------------------------------------------------------------
namespace at = attn_tile;
using bf16 = __nv_bfloat16;

// Where a walk goes.  Split-K: splits of `pps` pages over n_pages =
// n_splits * pps (pages past W read page 0, the Pallas kernel's padding,
// and ctx masks them).  Serial (`direct`): one split of pps = n_pages = W
// pages, written straight to the output.
struct Walk {
  int pps, n_splits, n_pages;
  int cap_rows;   // rows per M tile: kRows / G, so a tile's (row, head) pairs fill 64
  int direct;
};

// The plan, written on the device by paged_plan_kernel (no host sync):
// M tiles of consecutive rows that share a table row, at most cap_rows
// each, and two lists of work units, each a run of consecutive splits of
// one tile that hold a visible key: wide units (tiles of more than one
// (row, query head) pair: the tensor cores) and thin units (tiles of one
// pair, decode rows of an MHA stack: one FMA row).
struct Plan {
  int* tile_row0;     // [B] first row of each tile
  int* tile_nrows;    // [B]
  int* tile_maxctx;   // [B] largest ctx of the tile's rows, clamped to [0, n_pages * page]
  int* units[2];      // [wide, thin], each [B * n_splits]: tile * n_splits + first split
  int* n_units;       // [2]
  int* group;         // [1] splits per wide unit (a thin unit is one split)
};

Plan carve_plan(int* ws, int B, int n_splits) {
  int* wide = ws + 3 * B;
  int* thin = wide + static_cast<int64_t>(B) * n_splits;
  int* tail = thin + static_cast<int64_t>(B) * n_splits;
  return Plan{ws, ws + B, ws + 2 * B, {wide, thin}, tail, tail + 2};
}

// A row leads a tile where its table row differs from the previous row's,
// or at every cap_rows-th row of the launch: a local rule, so each thread
// finds its tiles without a scan.  The rows of one prefill chunk (the
// engine lowers them together, sharing row_map) fill whole tiles; decode
// rows (each its own table row) are tiles of one row, so they keep their
// own block per (row, head, split).  A tile whose rows all have ctx 0 (the
// padding rows) yields no split-K unit and loads no page.
//
// Wide items (tile, split) are grouped into units of `group` consecutive
// splits, so one block walks a run of pages pipelined and writes each
// split's partials as it ends; `group` is the largest that still leaves
// `target` (unit, head) pairs for the wide kernel's blocks.
//
// The rows are planned a block of rows at a time, staged in shared memory:
// each row's clamped ctx and whether it leads a tile, then each leader's
// tile extent (rows, largest ctx).  A block of rows is a whole number of
// cap_rows, so no tile crosses one.  The first pass counts the wide
// tiles' splits (for `group`), the second writes the tiles and units in row
// order; a launch of one block of rows (every launch of the engine) is
// staged once.
constexpr int kPlanRows = 2048;
constexpr int kPlanThreads = 1024;

__global__ void __launch_bounds__(kPlanThreads)
paged_plan_kernel(const int* __restrict__ row_map, const int* __restrict__ ctx_lens, Walk Wk,
                  int B, int G, int page, int Hkv, int target, Plan plan) {
  __shared__ int warp_sums[32];
  __shared__ int ctx_s[kPlanRows], maxctx_s[kPlanRows];
  __shared__ unsigned char n_s[kPlanRows];   // leaders: the tile's rows (<= 64); others 0
  const int cap_tok = Wk.n_pages * page;
  const int split_len = Wk.pps * page;
  const int block_rows = kPlanRows / Wk.cap_rows * Wk.cap_rows;
  const int per = (block_rows + kPlanThreads - 1) / kPlanThreads;   // rows per thread
  auto n_splits_of = [&](int maxctx) {
    return Wk.direct ? 1 : (maxctx + split_len - 1) / split_len;
  };
  auto stage = [&](int b0, int b1) {
    __syncthreads();                          // the previous block's readers are done
    for (int r = b0 + threadIdx.x; r < b1; r += kPlanThreads) {
      ctx_s[r - b0] = min(max(ctx_lens[r], 0), cap_tok);
      n_s[r - b0] = r % Wk.cap_rows == 0 || row_map[r] != row_map[r - 1];   // b0 % cap_rows == 0
    }
    __syncthreads();
    for (int r = threadIdx.x; r < b1 - b0; r += kPlanThreads) {
      if (!n_s[r]) continue;
      int n = 1, maxctx = ctx_s[r];
      while (r + n < b1 - b0 && !n_s[r + n]) maxctx = max(maxctx, ctx_s[r + n++]);
      maxctx_s[r] = maxctx;
      n_s[r] = n;                             // stays nonzero: other leaders' walks unchanged
    }
    __syncthreads();
  };
  // this thread's rows of the staged block [b0, b1): [r0, r1), offsets
  auto my_rows = [&](int b0, int b1, int& r0, int& r1) {
    r0 = min(b1 - b0, static_cast<int>(threadIdx.x) * per);
    r1 = min(b1 - b0, r0 + per);
  };

  int total_wide = 0;                         // splits of the wide tiles
  for (int b0 = 0; b0 < B; b0 += block_rows) {
    const int b1 = min(B, b0 + block_rows);
    stage(b0, b1);
    int r0, r1, n_wide = 0;
    my_rows(b0, b1, r0, r1);
    for (int r = r0; r < r1; ++r)
      if (n_s[r] * G > 1) n_wide += n_splits_of(maxctx_s[r]);
    int sum;
    at::block_exclusive_scan(n_wide, &sum, warp_sums);
    total_wide += sum;
  }
  const int group =
      Wk.direct ? 1
                : max(1, min(Wk.n_splits, static_cast<int>(static_cast<int64_t>(total_wide) *
                                                           Hkv / max(target, 1))));
  int t_base = 0, u_base = 0, v_base = 0;
  for (int b0 = 0; b0 < B; b0 += block_rows) {
    const int b1 = min(B, b0 + block_rows);
    if (B > block_rows) stage(b0, b1);
    int r0, r1, n_t = 0, n_u = 0, n_thin = 0;
    my_rows(b0, b1, r0, r1);
    for (int r = r0; r < r1; ++r) {
      if (!n_s[r]) continue;
      ++n_t;
      const int k = n_splits_of(maxctx_s[r]);
      if (n_s[r] * G > 1)
        n_u += (k + group - 1) / group;
      else
        n_thin += k;
    }
    int sum_t, sum_u, sum_v;
    int t = t_base + at::block_exclusive_scan(n_t, &sum_t, warp_sums);
    int u = u_base + at::block_exclusive_scan(n_u, &sum_u, warp_sums);
    int v = v_base + at::block_exclusive_scan(n_thin, &sum_v, warp_sums);
    for (int r = r0; r < r1; ++r) {
      if (!n_s[r]) continue;
      const int n = n_s[r], maxctx = maxctx_s[r];
      plan.tile_row0[t] = b0 + r;
      plan.tile_nrows[t] = n;
      plan.tile_maxctx[t] = maxctx;
      const int k = n_splits_of(maxctx);
      if (n * G > 1)
        for (int s = 0; s < k; s += group) plan.units[0][u++] = t * Wk.n_splits + s;
      else
        for (int s = 0; s < k; ++s) plan.units[1][v++] = t * Wk.n_splits + s;
      ++t;
    }
    t_base += sum_t;
    u_base += sum_u;
    v_base += sum_v;
  }
  if (threadIdx.x == 0) {
    plan.n_units[0] = u_base;
    plan.n_units[1] = v_base;
    *plan.group = group;
  }
}

// Page steps in flight per block: the wide kernel keeps a ring of three
// (two ahead of the one that computes), two at DP = 256; the thin kernel
// loads one step at a time and keeps many blocks on each SM instead.
template <int DP, bool THIN>
constexpr int kStagesOf = THIN ? 1 : at::kSmemQ<DP> ? 2 : 3;

// Output columns per thread of the thin kernel: one, two at DP = 256.
template <int DP>
constexpr int kThinCols = DP > at::kThreads ? DP / at::kThreads : 1;

// Shared memory of one block, bytes.  bf16 pages land straight in the K/V
// tiles; int8 pages land in int8 staging with their per-slot scales as f32
// (the wide kernel widens them into one bf16 tile for ldmatrix; the thin
// kernel reads them as they are).  The thin kernel adds its query row and
// scores (f32); the wide kernel at DP = 256 its warps' Q rows (bf16).
template <int DP, bool QUANT, bool THIN>
constexpr size_t mma_smem_bytes() {
  constexpr size_t tile = sizeof(bf16) * at::Dims<DP>::kTileElems;
  constexpr size_t land = QUANT ? 2 * at::kKeys * (DP + sizeof(float)) : 2 * tile;
  return (QUANT && !THIN ? 2 * tile : 0) + kStagesOf<DP, THIN> * land +
         (THIN ? sizeof(float) * (DP + at::kKeys) : 0) +
         (!THIN && at::kSmemQ<DP> ? sizeof(bf16) * at::kWarps * at::kQTileElems : 0);
}

__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float f[8]) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = static_cast<float>(b[e]);
}

// One online-softmax step of a thin tile (one query row) over a landed
// step of n_keys slots at positions key0 + [0, n_keys), visible below hi.
// Scores: two threads per key, each an FMA chain over half of D in a fixed
// order, then their sum; every warp takes the softmax of the 64 scores
// alike, so (m, l) live in every thread; thread t holds output column t.
// f32 throughout (bf16 and int8 values are exact in f32), so no hi/lo.
// At DP = 256 thread t holds columns t and t + 128.
template <int DP, bool QUANT, typename TKV>
__device__ __forceinline__ void thin_step(const TKV* K, const TKV* V, const float* ks,
                                          const float* vs, const float* q_s, float* s_s,
                                          int key0, int n_keys, int hi, float sm_scale,
                                          float& m, float& l, float (&acc)[kThinCols<DP>]) {
  constexpr int LS = QUANT ? DP : at::Dims<DP>::kStride;   // landed row stride
  constexpr float kLog2e = 1.4426950408889634f;
  const int key = threadIdx.x >> 1, half = threadIdx.x & 1, lane = threadIdx.x & 31;
  float dot = 0.f;
  if (key < n_keys) {
    const TKV* kr = K + key * LS + half * (DP / 2);
    const float* qh = q_s + half * (DP / 2);
#pragma unroll
    for (int c = 0; c < DP / 2; c += 8) {
      float f[8];
      load8(kr + c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = __fmaf_rn(qh[c + e], f[e], dot);
    }
  }
  dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 1));   // a + b == b + a
  if (half == 0) {
    float sc = dot;
    if (QUANT) sc = __fmul_rn(sc, ks[key]);
    sc = __fmul_rn(sc, sm_scale);
    s_s[key] = key0 + key < hi ? sc : at::kNegInf;
  }
  __syncthreads();
  const float a = s_s[lane], b = s_s[lane + 32];
  float mx = fmaxf(a, b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_new = fmaxf(m, mx);
  const float corr = at::ex2(__fmul_rn(m - m_new, kLog2e));
  float pa = key0 + lane < hi ? at::ex2(__fmul_rn(a - m_new, kLog2e)) : 0.f;
  float pb = key0 + lane + 32 < hi ? at::ex2(__fmul_rn(b - m_new, kLog2e)) : 0.f;
  float sum = pa + pb;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  l = __fmaf_rn(l, corr, sum);
  m = m_new;
  if (QUANT) {
    pa = __fmul_rn(pa, vs[lane]);
    pb = __fmul_rn(pb, vs[lane + 32]);
  }
#pragma unroll
  for (int c = 0; c < kThinCols<DP>; ++c) acc[c] *= corr;
  const TKV* vc = V + min(static_cast<int>(threadIdx.x), DP - 1);
  for (int k = 0; k < n_keys; ++k) {
    const float pk = __shfl_sync(0xffffffffu, k < 32 ? pa : pb, k & 31);
#pragma unroll
    for (int c = 0; c < kThinCols<DP>; ++c)
      acc[c] = __fmaf_rn(pk, to_f(vc[k * LS + c * at::kThreads]), acc[c]);
  }
}

// One block of 4 warps walks (unit, kv head) pairs, as many blocks as the
// card holds at once, each striding over its list of units.  A step is
// kKeys slots (64 / page whole pages), copied with 16-byte cp.async for
// all of the step's pages at once (the wide kernel two steps ahead of the
// one that computes, across split boundaries).  In the wide kernel each
// warp holds 16 of the tile's (row, query head) pairs and runs the shared
// tile routine with each pair's own range [0, min(ctx, split end)); the
// thin kernel runs thin_step over the whole block.  At the end of a split
// the block writes that split's partials (or, serial, the output) and
// starts the next split afresh.  Slots at or past the tile's largest ctx
// are zero-filled, never read.
template <int DP, bool QUANT, bool THIN>
__global__ void __launch_bounds__(at::kThreads)
paged_attention_mma_kernel(const bf16* __restrict__ q, const void* __restrict__ k_pool,
                           const void* __restrict__ v_pool,
                           const bf16* __restrict__ k_scale, const bf16* __restrict__ v_scale,
                           const int* __restrict__ tables, const int* __restrict__ row_map,
                           const int* __restrict__ ctx_lens, Plan plan, Walk Wk,
                           float* __restrict__ acc_p, float* __restrict__ m_p,
                           float* __restrict__ l_p, bf16* __restrict__ out,
                           float* __restrict__ m_out, float* __restrict__ l_out, Problem P) {
  using Dm = at::Dims<DP>;
  using TKV = typename std::conditional<QUANT, int8_t, bf16>::type;
  constexpr int kStages = kStagesOf<DP, THIN>;
  constexpr bool kWiden = QUANT && !THIN;            // int8 -> one bf16 tile for ldmatrix
  constexpr int kElemsPerChunk = 16 / sizeof(TKV);
  constexpr int kChunks = DP / kElemsPerChunk;       // per landed slot row
  constexpr int kLandStride = QUANT ? DP : Dm::kStride;   // landed row stride, elements
  constexpr int kLandTile = at::kKeys * kLandStride;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(mma_smem);
  TKV* landing = reinterpret_cast<TKV*>(tiles + (kWiden ? 2 * Dm::kTileElems : 0));
  float* scales = reinterpret_cast<float*>(landing + kStages * 2 * kLandTile);
  float* q_s = scales + (QUANT ? kStages * 2 * at::kKeys : 0);   // thin: [DP]
  float* s_s = q_s + DP;                                           // thin: [kKeys]
  const TKV* kp = static_cast<const TKV*>(k_pool);
  const TKV* vp = static_cast<const TKV*>(v_pool);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  // the wide kernel at DP = 256: this warp's Q rows, where q_s would be
  bf16* q_tile = reinterpret_cast<bf16*>(q_s) + warp * at::kQTileElems;
  const int cap_tok = Wk.n_pages * P.page;
  const int split_len = Wk.pps * P.page;
  const int step_pages = at::kKeys / P.page;
  const int steps_per_split = (Wk.pps + step_pages - 1) / step_pages;
  const int n_pairs = plan.n_units[THIN] * P.Hkv;
  const int group = THIN ? 1 : *plan.group;
  const int* units = plan.units[THIN];

  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int unit = units[pair / P.Hkv], h = pair % P.Hkv;
    const int tile = unit / Wk.n_splits, s0 = unit % Wk.n_splits;
    const int row0 = plan.tile_row0[tile], n_entries = plan.tile_nrows[tile] * P.G;
    const int maxctx = plan.tile_maxctx[tile];
    const int trow = table_row(row_map, row0, P);
    const int pages_ctx = min(Wk.n_pages, (maxctx + P.page - 1) / P.page);
    const int n_split_total = Wk.direct ? 1 : (maxctx + split_len - 1) / split_len;
    const int s_last = min(s0 + group, n_split_total) - 1;
    // every split of the unit but the tile's last is whole (pps pages)
    const int last_steps =
        (min((s_last + 1) * Wk.pps, pages_ctx) - s_last * Wk.pps + step_pages - 1) / step_pages;
    const int n_steps = (s_last - s0) * steps_per_split + max(last_steps, 0);

    // the wide kernel: this lane's two (row, query head) pairs, entries g
    // and g + 8 of the warp; the thin kernel: the one pair, in every thread
    int row[2], hq[2], ctx[2];
    const bf16* qrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = THIN ? 0 : warp * 16 + (lane >> 2) + 8 * r;
      const bool ok = e < n_entries && (!THIN || r == 0);
      row[r] = row0 + (ok ? e / P.G : 0);
      hq[r] = h * P.G + (ok ? e % P.G : 0);
      ctx[r] = ok ? min(max(ctx_lens[row[r]], 0), cap_tok) : 0;
      qrow[r] = ok ? q + (static_cast<int64_t>(row[r]) * P.Hq + hq[r]) * P.D : nullptr;
    }
    const bool warp_live = warp * 16 < n_entries;
    at::RowState<DP> st;
    float m1 = at::kNegInf, l1 = 0.f;                  // the thin kernel's state
    float acc1[kThinCols<DP>] = {};
    if constexpr (THIN) {
#pragma unroll
      for (int c = 0; c < kThinCols<DP>; ++c) {
        const int d = threadIdx.x + c * at::kThreads;
        if (d < DP) q_s[d] = d < P.D ? __bfloat162float(qrow[0][d]) : 0.f;
      }
    } else {
      at::init_rows(st, qrow[0], qrow[1], P.D, lane, q_tile);
    }

    // first page of step `i` and the page where it stops
    auto step_pages_of = [&](int i, int& jb, int& je) {
      const int s = s0 + i / steps_per_split;
      jb = s * Wk.pps + (i % steps_per_split) * step_pages;
      je = min(min(jb + step_pages, (s + 1) * Wk.pps), pages_ctx);
    };
    // the slots of step `i` into landing stage `buf` (no commit)
    auto load_step = [&](int i, int buf) {
      int jb, je;
      step_pages_of(i, jb, je);
      const int key0 = jb * P.page;
      const int n_slots = min((je - jb) * P.page, maxctx - key0);
      TKV* dst0 = landing + buf * 2 * kLandTile;
      for (int idx = threadIdx.x; idx < 2 * at::kKeys * kChunks; idx += at::kThreads) {
        const bool is_v = idx >= at::kKeys * kChunks;
        const int rem = is_v ? idx - at::kKeys * kChunks : idx;
        const int slot_i = rem / kChunks, c = rem % kChunks;
        const int width = is_v ? P.Dv : P.D;
        const bool ok = slot_i < n_slots && c * kElemsPerChunk < width;
        const TKV* src = is_v ? vp : kp;
        if (ok) {
          const int64_t slot =
              static_cast<int64_t>(table_page(tables, trow, jb + slot_i / P.page, P)) *
                  P.page + slot_i % P.page;
          src += (slot * P.Hkv + h) * width + c * kElemsPerChunk;
        }
        at::cp_async16(dst0 + (is_v ? kLandTile : 0) + slot_i * kLandStride +
                           c * kElemsPerChunk,
                       src, ok);
      }
      if (QUANT && threadIdx.x < 2 * at::kKeys) {
        const bool is_v = threadIdx.x >= at::kKeys;
        const int slot_i = threadIdx.x & (at::kKeys - 1);
        float sc = 0.f;
        if (slot_i < n_slots) {
          const int64_t slot =
              static_cast<int64_t>(table_page(tables, trow, jb + slot_i / P.page, P)) *
                  P.page + slot_i % P.page;
          sc = __bfloat162float((is_v ? v_scale : k_scale)[slot * P.Hkv + h]);
        }
        scales[buf * 2 * at::kKeys + threadIdx.x] = sc;
      }
    };
    // the finished state of split `s`: partials, or (serial) the output;
    // then a fresh state for the next split
    auto flush = [&](int s) {
      if constexpr (THIN) {
        const int dv = threadIdx.x;
        if (Wk.direct) {
          const int64_t head = static_cast<int64_t>(row[0]) * P.Hq + hq[0];
#pragma unroll
          for (int c = 0; c < kThinCols<DP>; ++c)
            if (dv + c * at::kThreads < P.Dv)
              out[head * P.Dv + dv + c * at::kThreads] =
                  __float2bfloat16_rn(acc1[c] / fmaxf(l1, 1e-30f));
          if (m_out != nullptr && dv == 0) {
            m_out[head] = m1;
            l_out[head] = l1;
          }
        } else if (ctx[0] > s * split_len) {
          const int64_t part = (static_cast<int64_t>(row[0]) * P.Hkv + h) * Wk.n_splits + s;
#pragma unroll
          for (int c = 0; c < kThinCols<DP>; ++c)
            if (dv + c * at::kThreads < P.Dv) acc_p[part * P.Dv + dv + c * at::kThreads] = acc1[c];
          if (dv == 0) {
            m_p[part] = m1;
            l_p[part] = l1;
          }
        }
        m1 = at::kNegInf;
        l1 = 0.f;
#pragma unroll
        for (int c = 0; c < kThinCols<DP>; ++c) acc1[c] = 0.f;
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (qrow[r] == nullptr) continue;
          if (Wk.direct) {
            const int64_t head = static_cast<int64_t>(row[r]) * P.Hq + hq[r];
            const float lc = fmaxf(st.l[r], 1e-30f);
#pragma unroll
            for (int n = 0; n < DP / 8; ++n) {
              const int dv = n * 8 + 2 * t4;
              if (dv < P.Dv)
                *reinterpret_cast<__nv_bfloat162*>(out + head * P.Dv + dv) =
                    __floats2bfloat162_rn(st.acc[n][2 * r] / lc, st.acc[n][2 * r + 1] / lc);
            }
            if (m_out != nullptr && t4 == 0) {
              m_out[head] = st.m[r];
              l_out[head] = st.l[r];
            }
          } else if (ctx[r] > s * split_len) {   // the combine reads exactly these splits
            const int64_t part =
                ((static_cast<int64_t>(row[r]) * P.Hkv + h) * Wk.n_splits + s) * P.G +
                (hq[r] - h * P.G);
#pragma unroll
            for (int n = 0; n < DP / 8; ++n) {
              const int dv = n * 8 + 2 * t4;
              if (dv < P.Dv)
                *reinterpret_cast<float2*>(acc_p + part * P.Dv + dv) =
                    make_float2(st.acc[n][2 * r], st.acc[n][2 * r + 1]);
            }
            if (t4 == 0) {
              m_p[part] = st.m[r];
              l_p[part] = st.l[r];
            }
          }
        }
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
        st.m[0] = st.m[1] = at::kNegInf;
        st.l[0] = st.l[1] = 0.f;
      }
    };

    if (n_steps == 0) flush(s0);             // serial rows with ctx 0: zeros
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_steps) load_step(i, i);
      at::cp_async_commit();
    }
    for (int i = 0; i < n_steps; ++i) {
      const int ahead = i + kStages - 1;
      if (ahead < n_steps) load_step(ahead, ahead % kStages);
      at::cp_async_commit();
      at::cp_async_wait<kStages - 1>();
      __syncthreads();
      const int buf = i % kStages;
      const TKV* land = landing + buf * 2 * kLandTile;
      const float* ks = scales + buf * 2 * at::kKeys;
      if constexpr (kWiden) {
        // widen the landed int8 rows to bf16 (exact: |x| <= 127); pad
        // columns D..DP of the landing rows were zero-filled
        const int8_t* src = reinterpret_cast<const int8_t*>(land);
        for (int idx = threadIdx.x; idx < 2 * at::kKeys * (DP / 8); idx += at::kThreads) {
          const int r = idx / (DP / 8), c = idx % (DP / 8);    // r in [0, 128): K rows, V rows
          const int2 raw = *reinterpret_cast<const int2*>(src + r * DP + c * 8);
          const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
          uint4 o;
          uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o32[e] = at::as_u32(__floats2bfloat162_rn(static_cast<float>(b8[2 * e]),
                                                      static_cast<float>(b8[2 * e + 1])));
          *reinterpret_cast<uint4*>(tiles + r * Dm::kStride + c * 8) = o;
        }
        __syncthreads();
      }
      const int s = s0 + i / steps_per_split;
      int jb, je;
      step_pages_of(i, jb, je);
      const int key0 = jb * P.page;
      const int key_end = min(je * P.page, maxctx);
      const int split_end = min((s + 1) * Wk.pps, Wk.n_pages) * P.page;
      if constexpr (THIN) {
        thin_step<DP, QUANT>(land, land + kLandTile, ks, ks + at::kKeys, q_s, s_s, key0,
                             key_end - key0, min(ctx[0], split_end), P.sm_scale, m1, l1, acc1);
      } else if (warp_live) {
        const bf16* k_s = kWiden ? tiles : reinterpret_cast<const bf16*>(land);
        const int lo[2] = {0, 0};
        const int hi[2] = {min(ctx[0], split_end), min(ctx[1], split_end)};
        at::tile_step<DP, true, QUANT>(st, k_s, k_s + Dm::kTileElems, ks, ks + at::kKeys, key0,
                                       min(8, (key_end - key0 + 7) / 8), lo, hi, P.sm_scale,
                                       lane);
      }
      if (i + 1 == n_steps || (i + 1) % steps_per_split == 0) flush(s);
      __syncthreads();                     // before this stage is loaded again
    }
  }
}

// Blocks of one walk kernel the card holds at once (asked once per
// instantiation; 0 if the query failed).
template <int DP, bool QUANT, bool THIN>
int walk_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    auto kernel = paged_attention_mma_kernel<DP, QUANT, THIN>;
    constexpr size_t smem = mma_smem_bytes<DP, QUANT, THIN>();
    int dev = 0, n_sm = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, at::kThreads, smem) !=
            cudaSuccess)
      return 0;
    blocks = per_sm * n_sm;
  }
  return blocks;
}

template <int DP, bool QUANT, bool THIN>
int launch_walk(const Args& a, const Plan& plan, const Walk& Wk, float* acc_p, float* m_p,
                float* l_p, void* out, float* m_out, float* l_out, const Problem& P,
                cudaStream_t st) {
  const int blocks = walk_blocks<DP, QUANT, THIN>();
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t most = static_cast<int64_t>(P.B) * Wk.n_splits * P.Hkv;
  const int grid = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(most, blocks)));
  paged_attention_mma_kernel<DP, QUANT, THIN>
      <<<grid, at::kThreads, mma_smem_bytes<DP, QUANT, THIN>(), st>>>(
          static_cast<const bf16*>(a.q), a.k_pool, a.v_pool,
          static_cast<const bf16*>(a.k_scale), static_cast<const bf16*>(a.v_scale), a.tables,
          a.row_map, a.ctx_lens, plan, Wk, acc_p, m_p, l_p, static_cast<bf16*>(out), m_out,
          l_out, P);
  return static_cast<int>(cudaGetLastError());
}

// plan, the wide (tensor-core) walk, the thin (one-row) walk (only where
// G = 1: a tile of one (row, head) pair needs it), and for split-K the
// combine: at most four launches, none of which waits for the host
template <int DP, bool QUANT>
int launch_mma(const Args& a, int* workspace, const Walk& Wk, float* acc_p, float* m_p,
               float* l_p, void* out, float* m_out, float* l_out, const Problem& P,
               cudaStream_t st) {
  const int wide_blocks = walk_blocks<DP, QUANT, false>();
  if (wide_blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Plan plan = carve_plan(workspace, P.B, Wk.n_splits);
  paged_plan_kernel<<<1, kPlanThreads, 0, st>>>(a.row_map, a.ctx_lens, Wk, P.B, P.G, P.page, P.Hkv,
                                        4 * wide_blocks, plan);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0)
    err = launch_walk<DP, QUANT, false>(a, plan, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
  if (err == 0 && P.G == 1)
    err = launch_walk<DP, QUANT, true>(a, plan, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
  if (err != 0) return err;
  if (!Wk.direct)
    launch_combine<bf16>(acc_p, m_p, l_p, a.ctx_lens, Wk.n_splits, Wk.pps * P.page, out,
                         m_out, l_out, P, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory the kernels need for these shapes, in bytes (the wrapper
// refuses shapes above the 48 KiB a block gets without opting in).
size_t paged_attention_smem_bytes(int Hq, int Hkv, int D, int Dv, int page) {
  return smem_bytes(make_problem(1, Hq, Hkv, D, Dv, page, 1, 1, 1, 1.f));
}

int paged_attention_serial(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale, const int* tables,
                           const int* row_map, const int* ctx_lens, void* out, float* m_out,
                           float* l_out, int B, int Hq, int Hkv, int D, int Dv, int page, int T,
                           int W, int n_pool, float sm_scale, int q_dtype, int kv_dtype,
                           int quant, void* stream) {
  const Problem P = make_problem(B, Hq, Hkv, D, Dv, page, T, W, n_pool, sm_scale);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, row_map, ctx_lens};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(q_dtype, kv_dtype, quant, [&](auto tq, auto tkv, auto qt) {
    launch_serial<decltype(tq), decltype(tkv), decltype(qt)::value>(a, out, m_out, l_out, P, st);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int paged_attention_splitk(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale, const int* tables,
                           const int* row_map, const int* ctx_lens, int pages_per_split,
                           int n_splits, float* acc_p, float* m_p, float* l_p, void* out,
                           float* m_out, float* l_out, int B, int Hq, int Hkv, int D, int Dv,
                           int page, int T, int W, int n_pool, float sm_scale, int q_dtype,
                           int kv_dtype, int quant, void* stream) {
  const Problem P = make_problem(B, Hq, Hkv, D, Dv, page, T, W, n_pool, sm_scale);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, row_map, ctx_lens};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(q_dtype, kv_dtype, quant, [&](auto tq, auto tkv, auto qt) {
    launch_splitk<decltype(tq), decltype(tkv), decltype(qt)::value>(
        a, pages_per_split, n_splits, acc_p, m_p, l_p, out, m_out, l_out, P, st);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core path: bf16 q over bf16 (kv_dtype 1) or int8 (2) pools.
// direct = 1: the serial kernel (one split over the whole table, out and
// optional m, l written directly); direct = 0: split-K partials of
// pages_per_split pages and the combine.  `workspace`: 3 * B + 2 * B *
// n_splits + 3 int32 (n_splits = 1 when direct).  Head dims up to 256,
// multiples of 8 (bf16) or 16 (int8); G <= 64; page <= 64.
int paged_attention_mma(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale, const int* tables,
                        const int* row_map, const int* ctx_lens, int* workspace,
                        int pages_per_split, int n_splits, int direct, float* acc_p,
                        float* m_p, float* l_p, void* out, float* m_out, float* l_out, int B,
                        int Hq, int Hkv, int D, int Dv, int page, int T, int W, int n_pool,
                        float sm_scale, int kv_dtype, void* stream) {
  const Problem P = make_problem(B, Hq, Hkv, D, Dv, page, T, W, n_pool, sm_scale);
  const int step = kv_dtype == kI8 ? 16 : 8;
  if ((kv_dtype != kBF16 && kv_dtype != kI8) || B < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      P.G > at::kRows || D % step || Dv % step || D < step || Dv < step || D > 256 ||
      Dv > 256 || page < 1 || page > at::kKeys || W < 1 || T < 1 || n_pool < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk Wk;
  Wk.direct = direct != 0;
  Wk.pps = Wk.direct ? W : pages_per_split;
  Wk.n_splits = Wk.direct ? 1 : n_splits;
  Wk.n_pages = Wk.direct ? W : n_splits * pages_per_split;
  Wk.cap_rows = at::kRows / P.G;
  if (Wk.pps < 1 || Wk.n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, row_map, ctx_lens};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool quant = kv_dtype == kI8;
  switch (at::tile_width(D, Dv) * 2 + quant) {
    case 64: return launch_mma<32, false>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 65: return launch_mma<32, true>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 128: return launch_mma<64, false>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 129: return launch_mma<64, true>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 256: return launch_mma<128, false>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 257: return launch_mma<128, true>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 512: return launch_mma<256, false>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    case 513: return launch_mma<256, true>(a, workspace, Wk, acc_p, m_p, l_p, out, m_out, l_out, P, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of one block of the wide (thin = 0) or thin (1) walk for
// these head dims, bytes (0 for head dims no tile takes).
size_t paged_attention_mma_smem_bytes(int D, int Dv, int quant, int thin) {
  switch (at::tile_width(D, Dv) * 4 + (quant != 0) * 2 + (thin != 0)) {
    case 128: return mma_smem_bytes<32, false, false>();
    case 129: return mma_smem_bytes<32, false, true>();
    case 130: return mma_smem_bytes<32, true, false>();
    case 131: return mma_smem_bytes<32, true, true>();
    case 256: return mma_smem_bytes<64, false, false>();
    case 257: return mma_smem_bytes<64, false, true>();
    case 258: return mma_smem_bytes<64, true, false>();
    case 259: return mma_smem_bytes<64, true, true>();
    case 512: return mma_smem_bytes<128, false, false>();
    case 513: return mma_smem_bytes<128, false, true>();
    case 514: return mma_smem_bytes<128, true, false>();
    case 515: return mma_smem_bytes<128, true, true>();
    case 1024: return mma_smem_bytes<256, false, false>();
    case 1025: return mma_smem_bytes<256, false, true>();
    case 1026: return mma_smem_bytes<256, true, false>();
    case 1027: return mma_smem_bytes<256, true, true>();
    default: return 0;
  }
}

}  // extern "C"
