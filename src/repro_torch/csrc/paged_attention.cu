// Paged decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   - paged_attention_serial_kernel  <- paged_attention_pallas (_paged_kernel,
//     _flash_step): one online-softmax chain over every page of a row;
//   - paged_attention_split_kernel + paged_attention_combine_kernel
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
//   bf16 per-(slot, head) scales; each K/V element is dequantized right
//   after it is loaded.
//
// Bound: device-memory bytes.  Every K/V element a row reads is used for
// 2 * G multiply-adds, far below the H100's ~295 operations per byte, so
// the time floor is the K/V pages read over 3.35 TB/s.
//
// This first version is simple on purpose: one thread block per (query
// row, kv head[, split]), scores as FMA dot products (one warp per token,
// lanes over D), the online-softmax state in shared memory, plain global
// loads.  No wgmma, TMA or cp.async pipelining.  Llama-2-7B is MHA (G = 1),
// so a tensor-core product would need rows that share a table row (the
// rows of one prefill chunk) packed into one tile: later work.
//
// Both kernels compute every score through the one __device__ routine
// `token_score`, with explicit round-to-nearest FMA and multiply
// intrinsics, so the split-K kernel's m equals the serial kernel's m bit
// for bit (max is exact).  A block walks only the pages its ctx reaches:
// for a fully masked page p = 0 and m is unchanged, so stopping early
// gives the same result bit for bit.
//
// Plain C interface (loaded with ctypes); every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// One block per (row, query head): m = max_s m_s, partials rescaled by
// exp(m_s - m), one division.  Splits beyond ctx carry (NEG_INF, 0, 0)
// and vanish; a fully masked row keeps l = 0 and the clamp gives zeros.
template <typename TQ, bool STATS>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ acc_p, const float* __restrict__ m_p,
                               const float* __restrict__ l_p, int n_splits,
                               TQ* __restrict__ out, float* __restrict__ m_out,
                               float* __restrict__ l_out, Problem P) {
  const int b = blockIdx.x, hq = blockIdx.y;
  const int h = hq / P.G, g = hq % P.G;
  const int64_t base = (static_cast<int64_t>(b) * P.Hkv + h) * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, m_p[(base + s) * P.G + g]);
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s)
    l = __fmaf_rn(l_p[(base + s) * P.G + g], expf(m_p[(base + s) * P.G + g] - m), l);
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  const int64_t o = (static_cast<int64_t>(b) * P.Hq + hq) * P.Dv;
  for (int dv = threadIdx.x; dv < P.Dv; dv += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a = __fmaf_rn(acc_p[((base + s) * P.G + g) * P.Dv + dv],
                    expf(m_p[(base + s) * P.G + g] - m), a);
    out[o + dv] = from_f<TQ>(a * inv_l);
  }
  if (STATS && threadIdx.x == 0) {
    m_out[static_cast<int64_t>(b) * P.Hq + hq] = m;
    l_out[static_cast<int64_t>(b) * P.Hq + hq] = l;
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
  if (m_out != nullptr)
    paged_attention_combine_kernel<TQ, true><<<dim3(P.B, P.Hq), kThreads, 0, st>>>(
        acc_p, m_p, l_p, n_splits, static_cast<TQ*>(out), m_out, l_out, P);
  else
    paged_attention_combine_kernel<TQ, false><<<dim3(P.B, P.Hq), kThreads, 0, st>>>(
        acc_p, m_p, l_p, n_splits, static_cast<TQ*>(out), m_out, l_out, P);
}

// Expand the runtime (q dtype, kv dtype, quant) triple into a template
// instantiation.  Returns false for a combination the kernels do not take.
template <typename F>
bool dispatch(int q_dtype, int kv_dtype, int quant, F&& f) {
  auto with_kv = [&](auto q_tag) {
    using TQ = decltype(q_tag);
    auto with_quant = [&](auto kv_tag) {
      using TKV = decltype(kv_tag);
      if (quant)
        f(TQ{}, TKV{}, std::true_type{});
      else
        f(TQ{}, TKV{}, std::false_type{});
      return true;
    };
    if (kv_dtype == kF32) return with_quant(float{});
    if (kv_dtype == kBF16) return with_quant(__nv_bfloat16{});
    if (kv_dtype == kI8) return with_quant(int8_t{});
    return false;
  };
  if (q_dtype == kF32) return with_kv(float{});
  if (q_dtype == kBF16) return with_kv(__nv_bfloat16{});
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

}  // extern "C"
