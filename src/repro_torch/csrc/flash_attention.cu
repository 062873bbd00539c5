// Blockwise prefill attention (causal, windowed or full, with GQA), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, _flash_kernel).
//
// What it computes (the TPU kernel's contract): q (B, Sq, Hq, D) attends
// k (B, Skv, Hkv, D) and v (B, Skv, Hkv, Dv); query head h reads kv head
// h / G (G = Hq / Hkv).  Sq and Skv may differ (prefill: Sq == Skv; the
// cross-attention of an encoder-decoder: Sq prompt rows over Skv encoder
// frames).  Scores are (q . k) * sm_scale in f32; a masked score is *set*
// to NEG_INF = -1e30, which is finite.  The mask is kpos < Skv, plus
// kpos <= qpos when causal, plus kpos > qpos - window when window > 0,
// both aligned top-left (qpos and kpos count from 0, as in the TPU
// kernel).  The online softmax keeps (m, l, acc) in f32 and the output is
// acc / max(l, 1e-30), rounded once to q's type.  Query rows are bounded
// by Sq; key rows, the kv tiles walked and the K/V offsets by Skv.  When
// the caller passes an lse buffer (training: the backward kernels of
// flash_attention_bwd.cu recompute the probabilities from it), each row
// also writes lse = m + log(max(l, 1e-30)) in f32, (B, Sq, Hq), as the
// reference's _flash_fwd_impl defines it; the serving calls pass null.
//
// Bound: at the serving shape (S up to 1024, D = 128) the work is
// 4 * S^2/2 * D operations per head against 4 * S * D bytes, hundreds of
// operations per byte: bound by operations, so the products belong on the
// tensor cores.  Two kernels, chosen by the input type:
//
//   - bf16 (flash_attention_mma_kernel, the serving path): one block per
//     (q tile of 64 rows, query head, batch row), 4 warps of 16 rows each,
//     three blocks per SM at head dims up to 128 (registers capped at 168:
//     the third block hides more of the mma and ex2 latency than the few
//     spilled bytes cost).  At head dim 256 (RecurrentGemma-2B) the tile
//     keeps Q in shared memory (attention_tile.cuh, kSmemQ) and the block
//     takes 165 KiB of shared memory: one block per SM, registers up to
//     255.
//     K/V tiles of 64 keys in bf16 are double-buffered in shared memory
//     with cp.async, so the next tile loads while this one computes; each
//     warp runs the shared tensor-core tile routine (attention_tile.cuh:
//     mma.sync m16n8k16 for Q.K^T and for P.V, P as hi + lo bf16 in
//     registers, the online softmax in registers).  A warp skips the tiles
//     that hold no visible key for any of its rows, and computes only the
//     key columns below its last row's causal limit.
//   - f32 (flash_attention_fma_kernel): the f32 FMA units, no tensor cores
//     (TF32 would miss the 1e-5 f32 tolerance): 256 threads, each a 4 x 4
//     tile of scores and a 4 x 8 tile of the output; Q, K and V tiles in
//     shared memory (the P tile reuses the K buffer), plain loads.
//
// The TPU kernel runs every kv tile, fully masked ones included.  These
// kernels walk only the kv tiles that hold a valid key for some row of the
// block (below the diagonal, inside the band).  Skipping changes nothing
// for a row with a valid key: that key lies in a walked tile, so the first
// valid score sets corr = exp(-1e30 - m) = 0 and wipes whatever fully
// masked entries had added before it.  Every row has one unless a window
// ends before key 0 or past key Skv - 1 (Sq >= Skv + window): the wrapper
// refuses such calls.  q tiles are taken in reverse order, so the longest
// causal rows start first.
//
// Plain C interface (loaded with ctypes); the launch is on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per kv tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kMaxD = 128;         // largest D and Dv of the f32 kernel
constexpr int kMaxMmaD = 256;      // largest D and Dv of the bf16 kernel
constexpr int kQKStride = kMaxD + 4;   // f32 row stride of the Q and K tiles
constexpr int kVStride = kMaxD;        // f32 row stride of the V tile
constexpr int kPStride = kBKV + 4;     // f32 row stride of the P tile
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kBQ * kQKStride + kBKV * kVStride);

static_assert(kBQ == kBKV, "the P tile lives in the K buffer");
static_assert(kBQ * kPStride <= kBKV * kQKStride, "P fits the K buffer");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

struct Shape {
  int B, Sq, Skv, Hq, Hkv, G, D, Dv, causal, window;
  float sm_scale;
};

// Copy rows [row0, row0 + 64) of head `h` of a (B, S, H, width) tensor into
// a 64-row f32 tile of `stride`; rows at or past S read as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, int b, int row0,
                                          int S, int H, int h, int width) {
  const int per_row = width / 4;
  for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const int s = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) v = load4(src + ((static_cast<int64_t>(b) * S + s) * H + h) * width + c);
    store4(dst + r * stride + c, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, Shape P) {
  extern __shared__ float4 smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kBQ * kQKStride;      // K tile, then the P tile
  float* v_s = k_s + kBKV * kQKStride;
  float* p_s = k_s;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / P.G;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile(q_s, kQKStride, q, b, q0, P.Sq, P.Hq, h, P.D);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that hold a valid key for some row of this block
  int kv_lo = 0, kv_hi = P.Skv;
  if (P.causal) kv_hi = min(P.Skv, q0 + kBQ);
  if (P.window > 0) kv_lo = max(0, q0 - P.window + 1);
  const bool wide_v = P.Dv > 64;

  for (int kv0 = (kv_lo / kBKV) * kBKV; kv0 < kv_hi; kv0 += kBKV) {
    load_tile(k_s, kQKStride, k, b, kv0, P.Skv, P.Hkv, hk, P.D);
    load_tile(v_s, kVStride, v, b, kv0, P.Skv, P.Hkv, hk, P.Dv);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < P.D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(q_s + (ty * 4 + i) * kQKStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(k_s + (tx + 16 * j) * kQKStride + d);
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

    // mask, then the online softmax of each row over its 16 threads
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv0 + tx + 16 * j;
        bool ok = kpos < P.Skv;
        if (P.causal) ok = ok && kpos <= qpos;
        if (P.window > 0) ok = ok && kpos > qpos - P.window;
        s[i][j] = ok ? s[i][j] * P.sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();                       // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * kPStride + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc = acc * corr + P . V; columns tx*4.. and 64 + tx*4..
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr[i];
    for (int j = 0; j < kBKV; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(p_s + (ty * 4 + i) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v0 = load4(v_s + (j + jj) * kVStride + tx * 4);
        float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (wide_v) v1 = load4(v_s + (j + jj) * kVStride + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = __fmaf_rn(p, v0.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(p, v0.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(p, v0.z, acc[i][2]);
          acc[i][3] = __fmaf_rn(p, v0.w, acc[i][3]);
          acc[i][4] = __fmaf_rn(p, v1.x, acc[i][4]);
          acc[i][5] = __fmaf_rn(p, v1.y, acc[i][5]);
          acc[i][6] = __fmaf_rn(p, v1.z, acc[i][6]);
          acc[i][7] = __fmaf_rn(p, v1.w, acc[i][7]);
        }
      }
    }
    __syncthreads();                       // before the next tile's loads
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_row = q0 + ty * 4 + i;
    if (s_row >= P.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const int64_t o_row = (static_cast<int64_t>(b) * P.Sq + s_row) * P.Hq + h;
    if (lse != nullptr && tx == 0) lse[o_row] = m[i] + logf(lc);
    T* dst = out + o_row * P.Dv;
    if (tx * 4 < P.Dv)
      store4(dst + tx * 4, make_float4(acc[i][0] / lc, acc[i][1] / lc,
                                       acc[i][2] / lc, acc[i][3] / lc));
    if (64 + tx * 4 < P.Dv)
      store4(dst + 64 + tx * 4, make_float4(acc[i][4] / lc, acc[i][5] / lc,
                                            acc[i][6] / lc, acc[i][7] / lc));
  }
}

template <typename T>
int launch_fma(const void* q, const void* k, const void* v, void* out, float* lse,
               const Shape& P, cudaStream_t stream) {
  static bool configured = false;          // opt in to > 48 KiB once per type
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((P.Sq + kBQ - 1) / kBQ, P.Hq, P.B);
  flash_attention_fma_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, P);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (attention_tile.cuh)
// ---------------------------------------------------------------------------
namespace at = attn_tile;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;        // K/V tiles in flight per block
// blocks per SM: three cap registers at 168; at DP = 256 shared memory
// holds one block, which may take 255
template <int DP>
constexpr int kMinBlocks = at::kSmemQ<DP> ? 1 : 3;

template <int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kStages * 2 /* K, V */ * at::Dims<DP>::kTileElems +
                         (at::kSmemQ<DP> ? at::kWarps * at::kQTileElems : 0));
}

template <int DP>
__global__ void __launch_bounds__(at::kThreads, kMinBlocks<DP>)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, Shape P) {
  using Dm = at::Dims<DP>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(mma_smem);   // [stage][K, V][64][kStride]
  // kSmemQ: then each warp's Q rows
  bf16* q_tiles = tiles + kStages * 2 * Dm::kTileElems;

  const int qt = gridDim.x - 1 - blockIdx.x;          // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / P.G;
  const int q0 = qt * at::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16;                      // the warp's first row
  const int row[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};

  at::RowState<DP> st;
  const bf16* qrow[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = row[r] < P.Sq
                  ? q + ((static_cast<int64_t>(b) * P.Sq + row[r]) * P.Hq + h) * P.D
                  : nullptr;
    lo[r] = P.window > 0 ? max(0, row[r] - P.window + 1) : 0;
    hi[r] = P.causal ? min(P.Skv, row[r] + 1) : P.Skv;
  }
  at::init_rows(st, qrow[0], qrow[1], P.D, lane, q_tiles + warp * at::kQTileElems);

  // kv tiles that hold a valid key for some row of this block
  int kv_lo = 0, kv_hi = P.Skv;
  if (P.causal) kv_hi = min(P.Skv, q0 + at::kRows);
  if (P.window > 0) kv_lo = max(0, q0 - P.window + 1);
  const int t_begin = kv_lo / at::kKeys;
  const int t_end = (kv_hi + at::kKeys - 1) / at::kKeys;
  // the warp's last visible key + 1, over its rows
  const int w_hi = P.causal ? min(P.Skv, w0 + 16) : P.Skv;

  const int64_t k_row = static_cast<int64_t>(P.Hkv) * P.D;    // elements per position
  const int64_t v_row = static_cast<int64_t>(P.Hkv) * P.Dv;
  const bf16* k_base = k + (static_cast<int64_t>(b) * P.Skv * P.Hkv + hk) * P.D;
  const bf16* v_base = v + (static_cast<int64_t>(b) * P.Skv * P.Hkv + hk) * P.Dv;

  // K and V rows [kv0, kv0 + 64) into stage `buf`; rows past Skv and columns
  // past D (Dv) are zero-filled
  auto load_step = [&](int kv0, int buf) {
    bf16* k_s = tiles + (2 * buf) * Dm::kTileElems;
    bf16* v_s = k_s + Dm::kTileElems;
    for (int idx = threadIdx.x; idx < 2 * at::kKeys * Dm::kChunks; idx += at::kThreads) {
      const bool is_v = idx >= at::kKeys * Dm::kChunks;
      const int rem = is_v ? idx - at::kKeys * Dm::kChunks : idx;
      const int r = rem / Dm::kChunks, c = rem % Dm::kChunks;
      const int s = kv0 + r;
      const int width = is_v ? P.Dv : P.D;
      const bool ok = s < P.Skv && c * 8 < width;
      const bf16* src = is_v ? v_base : k_base;
      if (ok) src += s * (is_v ? v_row : k_row) + c * 8;
      at::cp_async16((is_v ? v_s : k_s) + r * Dm::kStride + c * 8, src, ok);
    }
  };

  // a kStages-deep ring: tile i + kStages - 1 loads while tile i computes
  // (one commit group per tile, empty past the end, so the wait is fixed)
  const int n_tiles = t_end - t_begin;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_step((t_begin + i) * at::kKeys, i);
    at::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int ahead = i + kStages - 1;
    if (ahead < n_tiles) load_step((t_begin + ahead) * at::kKeys, ahead % kStages);
    at::cp_async_commit();
    at::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kv0 = (t_begin + i) * at::kKeys;
    bool work = w0 < P.Sq;
    if (P.causal) work = work && kv0 < w_hi;
    if (P.window > 0) work = work && kv0 + at::kKeys > w0 - P.window + 1;
    if (work) {
      const int nj = min(8, (w_hi - kv0 + 7) / 8);
      const bf16* k_s = tiles + (2 * (i % kStages)) * Dm::kTileElems;
      at::tile_step<DP, false, false>(st, k_s, k_s + Dm::kTileElems, nullptr, nullptr, kv0,
                                      nj, lo, hi, P.sm_scale, lane);
    }
    __syncthreads();                       // before this stage is loaded again
  }

  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= P.Sq) continue;
    const float lc = fmaxf(st.l[r], 1e-30f);
    const int64_t o_row = (static_cast<int64_t>(b) * P.Sq + row[r]) * P.Hq + h;
    if (lse != nullptr && t4 == 0) lse[o_row] = st.m[r] + logf(lc);
    bf16* dst = out + o_row * P.Dv;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int dv = n * 8 + 2 * t4;
      if (dv < P.Dv)
        *reinterpret_cast<__nv_bfloat162*>(dst + dv) =
            __floats2bfloat162_rn(st.acc[n][2 * r] / lc, st.acc[n][2 * r + 1] / lc);
    }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
               const Shape& P, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((P.Sq + at::kRows - 1) / at::kRows, P.Hq, P.B);
  flash_attention_mma_kernel<DP><<<grid, at::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory the bf16 kernel's block takes for these head dims, bytes
// (0 for head dims no tile takes).
size_t flash_attention_mma_smem_bytes(int D, int Dv) {
  switch (at::tile_width(D, Dv)) {
    case 32: return mma_smem_bytes<32>();
    case 64: return mma_smem_bytes<64>();
    case 128: return mma_smem_bytes<128>();
    case 256: return mma_smem_bytes<256>();
    default: return 0;
  }
}

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv) and out
// (B, Sq, Hq, Dv), all contiguous; dtype 0 = f32 (FMA kernel; D, Dv
// multiples of 4 up to 128), 1 = bf16 (tensor-core kernel; D, Dv multiples
// of 8 up to 256, 16-byte aligned rows); all four alike.  lse: null, or an
// f32 (B, Sq, Hq) buffer for each row's log-sum-exp.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv, int causal,
                        int window, int dtype, float sm_scale, void* stream) {
  const int step = dtype == 1 ? 8 : 4;
  const int max_d = dtype == 1 ? kMaxMmaD : kMaxD;
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D % step || Dv % step || D < step ||
      Dv < step || D > max_d || Dv > max_d || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape P{B, Sq, Skv, Hq, Hkv, Hq / Hkv, D, Dv, causal, window, sm_scale};
  const auto st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) return launch_fma<float>(q, k, v, out, lse_f, P, st);
  if (dtype == 1) {
    switch (at::tile_width(D, Dv)) {
      case 32: return launch_mma<32>(q, k, v, out, lse_f, P, st);
      case 64: return launch_mma<64>(q, k, v, out, lse_f, P, st);
      case 128: return launch_mma<128>(q, k, v, out, lse_f, P, st);
      case 256: return launch_mma<256>(q, k, v, out, lse_f, P, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
