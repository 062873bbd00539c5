// The backward of blockwise attention (causal, windowed or full, with
// GQA), for Hopper (sm_90a).
//
// Replaces the jnp custom VJP _flash_core_bwd of
// src/repro/models/attention.py (the gradient of the reference's flash
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
//   (a) flash_bwd_delta_kernel: delta, one warp per (b, row, head);
//   (b) flash_bwd_dkdv_kernel: one block per (64-key tile, kv head, b);
//       it walks the query tiles of each of the G heads that the causal
//       or window band leaves, recomputes P and dS for the tile pair and
//       accumulates dK and dV in registers;
//   (c) flash_bwd_dq_kernel: one block per (64-row query tile, query
//       head, b); it walks the key tiles of the band, recomputes P and dS
//       and accumulates dQ.
// P and dS are recomputed in both (b) and (c): seven products of a tile
// pair where one pass with atomics on dQ would need five.
//
// Bound: at Granite-3-2B's training shape (S 2048, D 64, causal) a head
// needs ~5 * S^2/2 * 2D operations against ~8 S D bytes: thousands of
// operations per byte, so it is bound by operations.  This first version
// runs them on the f32 FMA units for both input types (bf16 inputs are
// widened to f32 as they are loaded into shared memory): 256 threads per
// block, each a 4 x 4 tile of scores and a 4 x 8 tile of its gradient
// rows; the tiles of q, k, v, do, P and dS in shared memory as f32 (rows
// padded by 4 floats: conflict-free float4 reads).  Head dims up to 128
// (the 4 x 8 tile of 16 threads spans 128 columns); the wrapper refuses
// wider ones by name.  Tensor cores (mma.sync, then wgmma) are later work.
//
// Plain C interface (loaded with ctypes); the three launches are on the
// caller's stream, allocate nothing and return the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;             // query rows per q tile, keys per kv tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kMaxD = 128;         // largest D and Dv
constexpr int kPStride = kT + 4;   // f32 row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;

struct Shape {
  int B, Sq, Skv, Hq, Hkv, G, D, Dv, causal, window;
  float sm_scale;
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

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
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
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      store4(dst_k + tx * 4, make_float4(acc_k[i][0], acc_k[i][1], acc_k[i][2], acc_k[i][3]));
    if (64 + tx * 4 < P.D)
      store4(dst_k + 64 + tx * 4,
             make_float4(acc_k[i][4], acc_k[i][5], acc_k[i][6], acc_k[i][7]));
    if (tx * 4 < P.Dv)
      store4(dst_v + tx * 4, make_float4(acc_v[i][0], acc_v[i][1], acc_v[i][2], acc_v[i][3]));
    if (64 + tx * 4 < P.Dv)
      store4(dst_v + 64 + tx * 4,
             make_float4(acc_v[i][4], acc_v[i][5], acc_v[i][6], acc_v[i][7]));
  }
}

// (c) dQ of one 64-row query tile of head h over the key tiles of its band
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      store4(dst + tx * 4, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    if (64 + tx * 4 < P.D)
      store4(dst + 64 + tx * 4, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, const Shape& P,
           cudaStream_t stream) {
  static bool configured = false;          // opt in to > 48 KiB once per type
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * bwd_smem_floats(kMaxD, kMaxD, true)));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * bwd_smem_floats(kMaxD, kMaxD, false)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* do_t = static_cast<const T*>(dout);

  const int64_t rows = static_cast<int64_t>(P.B) * P.Sq * P.Hq;
  const int64_t delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(out), do_t, delta, rows, P.Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = sizeof(float) * bwd_smem_floats(P.D, P.Dv, true);
  const dim3 grid_kv((P.Skv + kT - 1) / kT, P.Hkv, P.B);
  flash_bwd_dkdv_kernel<T><<<grid_kv, kThreads, smem_kv, stream>>>(
      q_t, k_t, v_t, do_t, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = sizeof(float) * bwd_smem_floats(P.D, P.Dv, false);
  const dim3 grid_q((P.Sq + kT - 1) / kT, P.Hq, P.B);
  flash_bwd_dq_kernel<T><<<grid_q, kThreads, smem_q, stream>>>(q_t, k_t, v_t, do_t, lse, delta,
                                                               static_cast<T*>(dq), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one block of the dK/dV kernel (with_p = 1) or the dQ
// kernel (with_p = 0) at head dims D and Dv, bytes.
size_t flash_attention_bwd_smem_bytes(int D, int Dv, int with_p) {
  return sizeof(float) * bwd_smem_floats(D, Dv, with_p != 0);
}

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out and dout
// (B, Sq, Hq, Dv) in one type (dtype 0 = f32, 1 = bf16), lse (B, Sq, Hq)
// f32 from the forward, delta an f32 (B, Sq, Hq) scratch buffer; writes
// dq, dk, dv shaped and typed as q, k, v.  All contiguous, 16-byte
// aligned; D and Dv multiples of 4 (f32) or 8 (bf16), at most 128.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv,
                        int causal, int window, int dtype, float sm_scale, void* stream) {
  const int step = dtype == 1 ? 8 : 4;
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D % step || Dv % step ||
      D < step || Dv < step || D > kMaxD || Dv > kMaxD || window < 0 || B > 65535 ||
      Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape P{B, Sq, Skv, Hq, Hkv, Hq / Hkv, D, Dv, causal, window, sm_scale};
  const auto st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return launch<float>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
