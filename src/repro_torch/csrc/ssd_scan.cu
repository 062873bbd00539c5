// Mamba-2 chunked SSD scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_pallas, _ssd_kernel).
//
// What it computes: x (B, S, H, P), la (B, S, H) f32 log decay, Bm and Cm
// (B, S, G, N); head h reads group h / (H / G).  For each (b, h) the
// chunks of Q positions follow one another, the (P, N) state carried in
// f32 from one to the next (zeros, or the caller's initial state):
//   la_cum = cumsum(la) over the chunk, la_tot = la_cum[Q - 1];
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(la_cum[i] - la_cum[j]) x[j]
//          + exp(la_cum[i]) (C_i . state^T);
//   state  = exp(la_tot) state + sum_j (x[j] exp(la_tot - la_cum[j]))^T B_j.
// The decay L[i][j] is selected to 0 for i < j, never multiplied: there
// the exponent is positive and may overflow, and inf * 0 is NaN.
// Positions at or past S read as x = 0, la = 0, B = C = 0, which leaves
// the state unchanged.  y is rounded once to x's type; the final state is
// f32.  Training also asks for the state entering each chunk (B, n_chunks,
// H, P, N) f32, S_{c-1} (zeros or the initial state for chunk 0), which
// the backward (ssd_scan_bwd.cu) reads; serving passes a null pointer and
// writes nothing more.
//
// Two kernels, chosen by x's type:
//
// * bf16 x: ssd_scan_mma_kernel, the chunks in parallel on the tensor
//   cores.  Bound: at Mamba-2-2.7B's shape (H = 80, P = 64, N = 128,
//   chunk 128) and S = 1024 the call must move 24.4 MB (0.0073 ms at
//   3.35 TB/s) and do 4.7 GFLOP (0.0048 ms at the bf16 tensor-core peak):
//   bytes bound it, barely, so the design keeps every intermediate out of
//   device memory and gets the operations off the f32 FMA units, which
//   alone would need 0.070 ms.  Only the state handed from chunk c - 1 to
//   chunk c is serial; everything else of a chunk is not.  One block of 4
//   warps per (chunk, head, batch row), 640 blocks at S = 1024:
//     (a) x (Q x P), B and C (Q x N) by cp.async into padded shared
//         memory (zero-padded up to 128 x 64 and 128 x 128; 16-byte
//         copies where P and N are multiples of 8, else 8-byte ones; each
//         thread keeps one column and steps its address by a constant);
//     (b) la_cum by one warp's scan (its la asked for before the copies),
//         kept as hi + lo f32 (compensated sums: the decays are
//         exponentials of differences of la_cum, which cancel), with
//         exp(la_cum) and w = exp(la_tot - la_cum);
//     (c) y = (C B^T o L) x: each warp owns two 16-row tiles, r and 7 - r,
//         so the causal work is even; C B^T by mma.sync m16n8k16 (bf16
//         products are exact, f32 sums), two key tiles at a time; L by
//         ex2.approx of the compensated exponent (an accurate expf per
//         element took two fifths of the block's time); M = S o L goes
//         into the second product from registers, as hi + lo bf16 terms
//         into one f32 accumulator (the accumulator-to-A-fragment reuse of
//         attention_tile.cuh's P.V);
//     (d) U = (x o w)^T B, each warp 16 rows of P, x o w split hi + lo;
//     (e) the hand-off: one thread waits (acquire) for chunk c - 1's flag
//         of this (b, h), the block reads S_{c-1} (the initial state or
//         zeros for c = 0) from L2, all loads before any store, writes
//         S_c = exp(la_tot) S_{c-1} + U to a workspace slot (state_out
//         for the last chunk) and publishes its own flag (release); only
//         then does it keep S_{c-1} as hi + lo bf16 in the shared memory
//         B held, off the chain's path;
//     (f) y += exp(la_cum) o (C S_{c-1}^T) on the tensor cores, y written
//         once as bf16.
//   Blocks take their (chunk, head, row) from a ticket (an atomic counter)
//   in chunk-major order, so a block waits only on blocks that took their
//   tickets before it and are therefore resident: the chain always
//   progresses, with no cooperative launch.  Two state slots per (b, h)
//   suffice (chunk c writes slot c mod 2 only after chunk c - 1, the last
//   reader of that slot's previous state, published).  The ticket, the
//   flags and the slots live in one workspace that the wrapper keeps
//   zeroed once and reuses: each call passes the ticket's start and a
//   sequence base, chunk c publishes base + c + 1, so a flag of an earlier
//   call is never taken for a fresh one and no memset is launched per
//   call.  Shared memory: 90,112 bytes of dynamic shared memory per
//   block; 255 registers per thread (252, and 254 with 8-byte copies,
//   before the chunk-state store); 2 blocks (8 warps) per SM.  What still holds it back (PERF.md,
//   scripts/ssd_phases.py): a block spends a fifth of its time getting
//   its 80 KB (B and C are read again for every head) and a sixth in the
//   hand-off's trips to L2, and its mma.sync products run far below the
//   tensor cores' rate.
//
// * f32 x: ssd_scan_kernel, full f32 on the FMA units (TF32 would miss the
//   f32 tolerance).  One thread block per (head, batch row), 256 threads,
//   walking its chunks; the chunk's B, C and x and the state live in
//   shared memory as f32 (about 215 KB, dynamic shared memory), and the
//   Q x Q masked scores are built 32 rows at a time so they fit beside
//   them.  At 80 heads and batch 1 the grid is 80 blocks, under one wave
//   of the H100's 132 SMs.  (It also takes bf16 x through ssd_scan_fwd;
//   the wrapper sends bf16 to the tensor-core kernel.)
//
// Plain C interface (loaded with ctypes); the launches are on the caller's
// stream, allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kMaxQ = 128;             // chunk length
constexpr int kMaxP = 64;              // head dim
constexpr int kMaxN = 128;             // state dim
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kRowTile = 32;           // score rows built at a time
constexpr int kBStride = kMaxN + 4;    // f32 row stride of B, C and the state
constexpr int kXStride = kMaxP;        // f32 row stride of x
constexpr int kMStride = kMaxQ + 4;    // f32 row stride of the score tile
constexpr size_t kSmemFloats = 2 * kMaxQ * kBStride     // B, C
                               + kMaxQ * kXStride       // x
                               + kMaxP * kBStride       // state
                               + kRowTile * kMStride    // score tile
                               + 3 * kMaxQ;             // la_cum, exp(la_cum), w
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kThreads == 256, "the thread tiles below assume 16 x 16");
static_assert(kMaxQ == 16 * 8 && kMaxP == 16 * 4 && kMaxN == 16 * 8, "tile shapes");
static_assert(kRowTile == 2 * 16, "each thread owns two rows of a score tile");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Shape {
  int B, S, H, P, G, N, Q;
};

// Copy rows [t0, t0 + kMaxQ) of one head or group of a (B, S, Hx, width)
// tensor into an f32 tile; rows at or past S, or at or past t0 + Q, are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, int b, int t0,
                                          int n_valid, int S, int Hx, int hx, int width) {
  const int per_row = width / 4;
  for (int idx = threadIdx.x; idx < kMaxQ * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const int s = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && s < S)
      v = load4(src + ((static_cast<int64_t>(b) * S + s) * Hx + hx) * width + c);
    store4(dst + r * stride + c, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ la,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ state_out, float* __restrict__ chunk_states,
                Shape P) {
  extern __shared__ float4 smem_raw[];
  float* B_s = reinterpret_cast<float*>(smem_raw);
  float* C_s = B_s + kMaxQ * kBStride;
  float* x_s = C_s + kMaxQ * kBStride;
  float* st_s = x_s + kMaxQ * kXStride;
  float* M_s = st_s + kMaxP * kBStride;
  float* cum_s = M_s + kRowTile * kMStride;
  float* ecum_s = cum_s + kMaxQ;
  float* w_s = ecum_s + kMaxQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (P.H / P.G);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int Q = P.Q;

  // the carried state: zeros or the caller's
  for (int idx = threadIdx.x; idx < P.P * P.N; idx += kThreads) {
    const int p = idx / P.N, n = idx - p * P.N;
    st_s[p * kBStride + n] =
        init ? init[((static_cast<int64_t>(b) * P.H + h) * P.P + p) * P.N + n] : 0.f;
  }

  for (int t0 = 0; t0 < P.S; t0 += Q) {
    load_rows(x_s, kXStride, x, b, t0, Q, P.S, P.H, h, P.P);
    load_rows(B_s, kBStride, Bm, b, t0, Q, P.S, P.G, g, P.N);
    load_rows(C_s, kBStride, Cm, b, t0, Q, P.S, P.G, g, P.N);
    // la_cum: one warp, each lane a run of consecutive positions, then a
    // scan of the lanes' totals
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int per = (Q + 31) / 32;
      const int lo = min(Q, lane * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        const int s = t0 + i;
        run += s < P.S ? la[(static_cast<int64_t>(b) * P.S + s) * P.H + h] : 0.f;
        cum_s[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) cum_s[i] += base;
    }
    __syncthreads();
    if (chunk_states) {                    // S_{c-1}, as it enters this chunk
      float* dst = chunk_states + ((static_cast<int64_t>(b) * ((P.S + Q - 1) / Q) + t0 / Q) *
                                       P.H + h) * P.P * P.N;
      for (int idx = threadIdx.x; idx < P.P * P.N; idx += kThreads) {
        const int p = idx / P.N, n = idx - p * P.N;
        dst[idx] = st_s[p * kBStride + n];
      }
    }
    const float la_tot = cum_s[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kThreads) {
      ecum_s[i] = expf(cum_s[i]);
      w_s[i] = expf(la_tot - cum_s[i]);
    }

    // y rows ty + 16 r, columns tx + 16 e; first exp(la_cum) (C . state^T)
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    for (int n = 0; n < P.N; n += 4) {
      float4 sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[e] = load4(st_s + (tx + 16 * e) * kBStride + n);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 cv = load4(C_s + (ty + 16 * r) * kBStride + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[r][e] = __fmaf_rn(cv.x, sv[e].x, acc[r][e]);
          acc[r][e] = __fmaf_rn(cv.y, sv[e].y, acc[r][e]);
          acc[r][e] = __fmaf_rn(cv.z, sv[e].z, acc[r][e]);
          acc[r][e] = __fmaf_rn(cv.w, sv[e].w, acc[r][e]);
        }
      }
    }
    __syncthreads();                       // ecum_s is written
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float ec = ty + 16 * r < Q ? ecum_s[ty + 16 * r] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= ec;
    }

    // then the intra-chunk term, 32 score rows at a time (unrolled, so
    // that acc[] is indexed by constants and stays in registers)
#pragma unroll
    for (int t = 0; t < kMaxQ / kRowTile; ++t) {
      const int i0 = t * kRowTile;
      if (i0 >= Q) break;
      const int jmax = min(Q, i0 + kRowTile);      // keys past it are masked
      const int jmax4 = (jmax + 3) & ~3;
      // M[i][j] = (C_i . B_j) * exp(la_cum[i] - la_cum[j]) for j <= i, else 0;
      // this thread: rows i0 + 2 ty + a, keys tx + 16 c
      float dot[2][8];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) dot[a][c] = 0.f;
      for (int n = 0; n < P.N; n += 4) {
        const float4 c0 = load4(C_s + (i0 + 2 * ty) * kBStride + n);
        const float4 c1 = load4(C_s + (i0 + 2 * ty + 1) * kBStride + n);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (tx + 16 * c >= jmax4) continue;
          const float4 bv = load4(B_s + (tx + 16 * c) * kBStride + n);
          dot[0][c] = __fmaf_rn(c0.x, bv.x, dot[0][c]);
          dot[0][c] = __fmaf_rn(c0.y, bv.y, dot[0][c]);
          dot[0][c] = __fmaf_rn(c0.z, bv.z, dot[0][c]);
          dot[0][c] = __fmaf_rn(c0.w, bv.w, dot[0][c]);
          dot[1][c] = __fmaf_rn(c1.x, bv.x, dot[1][c]);
          dot[1][c] = __fmaf_rn(c1.y, bv.y, dot[1][c]);
          dot[1][c] = __fmaf_rn(c1.z, bv.z, dot[1][c]);
          dot[1][c] = __fmaf_rn(c1.w, bv.w, dot[1][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = i0 + 2 * ty + a;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tx + 16 * c;
          if (j >= jmax4) continue;
          const bool ok = i < Q && j <= i;
          M_s[(2 * ty + a) * kMStride + j] =
              ok ? dot[a][c] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
      __syncthreads();
      // acc += M x over the rows of this tile that the thread owns:
      // i = ty + 16 r with r = i0 / 16 and i0 / 16 + 1
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * t + rr;
        const float* m_row = M_s + (ty + 16 * rr) * kMStride;
        for (int j = 0; j < jmax4; j += 4) {
          const float4 mv = load4(m_row + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = tx + 16 * e;
            float a = acc[r][e];
            a = __fmaf_rn(mv.x, x_s[(j + 0) * kXStride + p], a);
            a = __fmaf_rn(mv.y, x_s[(j + 1) * kXStride + p], a);
            a = __fmaf_rn(mv.z, x_s[(j + 2) * kXStride + p], a);
            a = __fmaf_rn(mv.w, x_s[(j + 3) * kXStride + p], a);
            acc[r][e] = a;
          }
        }
      }
      __syncthreads();                     // before the next tile's scores
    }

    // y out
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const int s = t0 + i;
      if (i >= Q || s >= P.S) continue;
      T* dst = y + ((static_cast<int64_t>(b) * P.S + s) * P.H + h) * P.P;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (tx + 16 * e < P.P) store1(dst + tx + 16 * e, acc[r][e]);
    }

    // state = exp(la_tot) state + sum_j (x_j w_j)^T B_j; rows ty*4 + a,
    // columns tx + 16 c
    const float decay = expf(la_tot);
    if (ty * 4 < P.P) {
      float upd[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) upd[a][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float4 xv = load4(x_s + j * kXStride + ty * 4);
        const float wj = w_s[j];
        const float xw[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float bv = B_s[j * kBStride + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) upd[a][c] = __fmaf_rn(xw[a], bv, upd[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = tx + 16 * c;
          if (n < P.N) {
            float* sp = st_s + (ty * 4 + a) * kBStride + n;
            *sp = __fmaf_rn(decay, *sp, upd[a][c]);
          }
        }
    }
    __syncthreads();                       // before the next chunk's loads
  }

  for (int idx = threadIdx.x; idx < P.P * P.N; idx += kThreads) {
    const int p = idx / P.N, n = idx - p * P.N;
    state_out[((static_cast<int64_t>(b) * P.H + h) * P.P + p) * P.N + n] =
        st_s[p * kBStride + n];
  }
}

template <typename T>
int launch(const void* x, const float* la, const void* Bm, const void* Cm,
           const float* init, void* y, float* state, float* chunk_states, const Shape& P,
           cudaStream_t stream) {
  static bool configured = false;          // opt in to > 48 KiB once per type
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(P.H, P.B);
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), la, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init, static_cast<T*>(y), state, chunk_states, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 x: chunks in parallel on the tensor cores, the state handed on
// ---------------------------------------------------------------------------
namespace ssd_mma {

using bf16 = __nv_bfloat16;
using attn_tile::ldmatrix_x4;
using attn_tile::ldmatrix_x4_trans;
using attn_tile::mma_bf16;
using attn_tile::split_pair;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 128;                    // chunk tile: rows and keys
constexpr int kP = 64;                     // head-dim tile
constexpr int kN = 128;                    // state-dim tile
constexpr int kXS = kP + 8;                // bf16 row strides (144 and 272 bytes:
constexpr int kBS = kN + 8;                // ldmatrix rows hit distinct bank groups)
constexpr size_t kXBytes = size_t(kQ) * kXS * sizeof(bf16);
constexpr size_t kBBytes = size_t(kQ) * kBS * sizeof(bf16);
constexpr size_t kSmemBytes = kXBytes + 2 * kBBytes + 4 * kQ * sizeof(float);
constexpr int kFlagsOffset = 64;           // words: the ticket, then the flags
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kQ == 16 * 2 * kWarps, "each warp owns two 16-row tiles");
static_assert(kP == 16 * kWarps, "each warp owns 16 rows of the state");
static_assert(2 * kP * kBS * sizeof(bf16) == kBBytes, "S_prev hi + lo fill B's tile");

// What chains the chunks of one call: the ticket counter, one flag per
// (b, h), two state slots per (b, h) (slot k of head bh at
// slots + (k * BH + bh) * P * N), and this call's bases.
struct Chain {
  unsigned* ticket;
  unsigned* flags;
  float* slots;
  unsigned ticket_base, seq_base;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   attn_tile::smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// a + b = s + e exactly (two-sum; explicit roundings, nothing contracted)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// (ah + al) += (bh + bl), renormalized so that |al| <= ulp(ah) / 2
__device__ __forceinline__ void dd_add(float& ah, float& al, float bh, float bl) {
  float e;
  const float s = two_sum(ah, bh, e);
  e = __fadd_rn(e, __fadd_rn(al, bl));
  ah = __fadd_rn(s, e);
  al = __fsub_rn(e, __fsub_rn(ah, s));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Rows [row0, row0 + kQ) of head or group hx of a (rows, Hx, width) bf16
// tensor into a kQ x W tile of row stride `stride`, in copies of STEP
// elements (16 bytes need width % 8 == 0, 8 bytes width % 4 == 0); rows at
// or past `rows` and columns at or past `width` are zeros.  A thread keeps
// one column and walks rows a fixed distance apart, so its addresses
// advance by a constant.
template <int W, int STEP>
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const bf16* src,
                                          int64_t row0, int rows, int Hx, int hx,
                                          int width) {
  constexpr int kPer = W / STEP;           // copies per row
  constexpr int kRowStep = kThreads / kPer;
  static_assert(kThreads % kPer == 0 && kQ % kRowStep == 0, "copy layout");
  const int col = (threadIdx.x % kPer) * STEP;
  const int r0 = threadIdx.x / kPer;
  const int64_t pitch = static_cast<int64_t>(Hx) * width;
  const bf16* s = src + (row0 + r0) * pitch + static_cast<int64_t>(hx) * width + col;
  bf16* d = dst + r0 * stride + col;
#pragma unroll
  for (int k = 0; k < kQ / kRowStep; ++k) {
    const bool ok = col < width && r0 + k * kRowStep < rows;
    if (STEP == 8)
      attn_tile::cp_async16(d, ok ? s : src, ok);
    else
      cp_async8(d, ok ? s : src, ok);
    s += kRowStep * pitch;
    d += kRowStep * stride;
  }
}

template <int STEP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const float* __restrict__ init, bf16* __restrict__ y,
                    float* __restrict__ state_out, float* __restrict__ chunk_states,
                    Chain ch, Shape P) {
  extern __shared__ float4 smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* B_s = x_s + kQ * kXS;
  bf16* C_s = B_s + kQ * kBS;
  float* cum_s = reinterpret_cast<float*>(C_s + kQ * kBS);   // la_cum, high part
  float* cuml_s = cum_s + kQ;                                  // and low part
  float* ecum_s = cuml_s + kQ;
  float* w_s = ecum_s + kQ;
  bf16* Shi_s = B_s;                       // (e): S_{c-1} where B was
  bf16* Slo_s = B_s + kP * kBS;
  __shared__ unsigned item_s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) item_s = atomicAdd(ch.ticket, 1u) - ch.ticket_base;
  __syncthreads();
  const int BH = P.B * P.H;
  const int c = static_cast<int>(item_s / BH);          // chunk-major
  const int bh = static_cast<int>(item_s) - c * BH;
  const int b = bh / P.H, h = bh - b * P.H;
  const int grp = h / (P.H / P.G);
  const int Q = P.Q;
  const int n_chunks = (P.S + Q - 1) / Q;
  const int rows = min(Q, P.S - c * Q);   // positions of this chunk
  const int64_t row0 = static_cast<int64_t>(b) * P.S + static_cast<int64_t>(c) * Q;

  // (a) the chunk's x, B and C, in flight while warp 0 does (b); warp 0
  // asks for its la first
  float lav[4];
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * 4 + k;
      lav[k] = i < rows ? la[(row0 + i) * P.H + h] : 0.f;
    }
  }
  load_tile<kP, STEP>(x_s, kXS, x, row0, rows, P.H, h, P.P);
  load_tile<kN, STEP>(B_s, kBS, Bm, row0, rows, P.G, grp, P.N);
  load_tile<kN, STEP>(C_s, kBS, Cm, row0, rows, P.G, grp, P.N);
  attn_tile::cp_async_commit();
  // (b) la_cum as an unevaluated sum hi + lo: four consecutive positions
  // per lane, then a scan of the lanes' totals; padded positions add 0.
  // The decays are exponentials of differences of these sums, which
  // cancel: a plain f32 sum near -3000 would carry an error of 2.4e-4 into
  // every such difference, 2.4e-4 relative in the decay.
  if (warp == 0) {
    float vh[4], vl[4], rh = 0.f, rl = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dd_add(rh, rl, lav[k], 0.f);
      vh[k] = rh;
      vl[k] = rl;
    }
    float ih = rh, il = rl;                // inclusive over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float oh = __shfl_up_sync(0xffffffffu, ih, off);
      float ol = __shfl_up_sync(0xffffffffu, il, off);
      if (lane >= off) {
        dd_add(oh, ol, ih, il);
        ih = oh;
        il = ol;
      }
    }
    float eh = __shfl_up_sync(0xffffffffu, ih, 1);   // exclusive prefix
    float el = __shfl_up_sync(0xffffffffu, il, 1);
    if (lane == 0) eh = el = 0.f;
    const float th = __shfl_sync(0xffffffffu, ih, 31);
    const float tl = __shfl_sync(0xffffffffu, il, 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * 4 + k;
      float sh = eh, sl = el;
      dd_add(sh, sl, vh[k], vl[k]);
      cum_s[i] = sh;
      cuml_s[i] = sl;
      ecum_s[i] = expf(sh + sl);
      w_s[i] = expf((th - sh) + (tl - sl));
    }
  }
  attn_tile::cp_async_wait<0>();
  __syncthreads();

  const int gq = lane >> 2, tq = lane & 3;  // accumulator row, column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int n16 = (rows + 15) >> 4;         // 16-row tiles that hold positions

  // (c) y = (C B^T o L) x, over each of the warp's row tiles and the key
  // tiles at or below it
  float yacc[2][8][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[rr][n][e] = 0.f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int rt = rr == 0 ? warp : 2 * kWarps - 1 - warp;
    if (rt >= n16) continue;
    uint32_t cf[kN / 16][4];                // C's A fragments, all of N
    const bf16* crow = C_s + (rt * 16 + (mi & 1) * 8 + mr) * kBS + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) ldmatrix_x4(cf[kk], crow + kk * 16);
    const int ia = rt * 16 + gq, ib = ia + 8;
    const float ca = cum_s[ia], cb = cum_s[ib], cla = cuml_s[ia], clb = cuml_s[ib];
    // two key tiles (32 keys) at a time: four independent score chains; a
    // second tile past rt is wholly above the diagonal and masked
    for (int kb = 0; kb <= rt; kb += 2) {
      const int j0 = kb * 16;
      float s[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
      const bf16* krow = B_s + (j0 + (mi >> 1) * 8 + mr) * kBS + (mi & 1) * 8;
      const bool two = kb + 1 <= rt;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t b0[4], b1[4];
        ldmatrix_x4(b0, krow + kk * 16);
        mma_bf16(s[0], cf[kk], b0[0], b0[1]);
        mma_bf16(s[1], cf[kk], b0[2], b0[3]);
        if (two) {
          ldmatrix_x4(b1, krow + 16 * kBS + kk * 16);
          mma_bf16(s[2], cf[kk], b1[0], b1[1]);
          mma_bf16(s[3], cf[kk], b1[2], b1[3]);
        }
      }
      // M = S o L, L selected to 0 above the diagonal and past the chunk
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          const int j = j0 + jj * 8 + 2 * tq + (e & 1);
          const bool keep = j <= i && i < rows;
          const float ex = e < 2 ? (ca - cum_s[j]) + (cla - cuml_s[j])
                                 : (cb - cum_s[j]) + (clb - cuml_s[j]);
          s[jj][e] = keep ? s[jj][e] * attn_tile::ex2(ex * kLog2e) : 0.f;
        }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        if (kb + kt > rt) break;
        uint32_t ah[4], al[4];
        split_pair(s[2 * kt][0], s[2 * kt][1], ah[0], al[0]);          // row g,     keys 0-7
        split_pair(s[2 * kt][2], s[2 * kt][3], ah[1], al[1]);          // row g + 8, keys 0-7
        split_pair(s[2 * kt + 1][0], s[2 * kt + 1][1], ah[2], al[2]);  // row g,     keys 8-15
        split_pair(s[2 * kt + 1][2], s[2 * kt + 1][3], ah[3], al[3]);  // row g + 8, keys 8-15
        const bf16* vrow = x_s + (j0 + 16 * kt + (mi & 1) * 8 + mr) * kXS + (mi >> 1) * 8;
#pragma unroll
        for (int n = 0; n < kP / 8; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + n * 8);
          mma_bf16(yacc[rr][n], al, bv[0], bv[1]);
          mma_bf16(yacc[rr][n + 1], al, bv[2], bv[3]);
          mma_bf16(yacc[rr][n], ah, bv[0], bv[1]);
          mma_bf16(yacc[rr][n + 1], ah, bv[2], bv[3]);
        }
      }
    }
  }

  // (d) U = (x o w)^T B: this warp's 16 rows of P, all of N
  float u[kN / 8][4];
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) u[n][e] = 0.f;
  const int p0 = warp * 16;
  if (p0 < P.P) {
    const bf16* arow = x_s + ((mi >> 1) * 8 + mr) * kXS + p0 + (mi & 1) * 8;
    const bf16* brow = B_s + ((mi & 1) * 8 + mr) * kBS + (mi >> 1) * 8;
#pragma unroll
    for (int kb = 0; kb < kQ / 16; ++kb) {
      if (kb >= n16) break;
      uint32_t a[4], ah[4], al[4];
      ldmatrix_x4_trans(a, arow + kb * 16 * kXS);
#pragma unroll
      for (int i = 0; i < 4; ++i) {        // a[i]: keys kb*16 + 8 (i >> 1) + 2 tq, + 1
        const int j = kb * 16 + (i >> 1) * 8 + 2 * tq;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
        split_pair(xv.x * w_s[j], xv.y * w_s[j + 1], ah[i], al[i]);
      }
#pragma unroll
      for (int n = 0; n < kN / 8; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, brow + kb * 16 * kBS + n * 8);
        mma_bf16(u[n], al, bv[0], bv[1]);
        mma_bf16(u[n + 1], al, bv[2], bv[3]);
        mma_bf16(u[n], ah, bv[0], bv[1]);
        mma_bf16(u[n + 1], ah, bv[2], bv[3]);
      }
    }
  }

  // (e) the hand-off
  const bool last = c == n_chunks - 1;
  if (threadIdx.x == 0 && c > 0) {         // chunk c - 1 publishes seq_base + c
    const unsigned want = ch.seq_base + static_cast<unsigned>(c);
    while (static_cast<int>(ld_acquire(ch.flags + bh) - want) < 0) __nanosleep(32);
  }
  __syncthreads();                         // the flag is seen; B_s is free
  const bool carry = c > 0 || init != nullptr;
  const int64_t head = static_cast<int64_t>(bh) * P.P * P.N;
  const int64_t slot = static_cast<int64_t>(BH) * P.P * P.N;
  const float* prev = c == 0 ? init : ch.slots + ((c - 1) & 1) * slot;
  float* next = last ? state_out : ch.slots + (c & 1) * slot;
  const float decay = expf(cum_s[kQ - 1] + cuml_s[kQ - 1]);
  // S_{c-1}: all of this thread's loads are issued before any store (the
  // compiler may not move a load of `prev` past a store to `next`, so
  // interleaving them would serialize 32 trips to L2)
  float2 sp[kN / 8][2];
#pragma unroll
  for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + gq + 8 * half;
      const int n = n8 * 8 + 2 * tq;
      sp[n8][half] = make_float2(0.f, 0.f);
      if (carry && p < P.P && n < P.N)     // L2 only: another SM wrote it
        sp[n8][half] = __ldcg(reinterpret_cast<const float2*>(
            prev + head + static_cast<int64_t>(p) * P.N + n));
    }
#pragma unroll
  for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + gq + 8 * half;
      const int n = n8 * 8 + 2 * tq;
      const float2 v = sp[n8][half];
      if (p < P.P && n < P.N)
        *reinterpret_cast<float2*>(next + head + static_cast<int64_t>(p) * P.N + n) =
            make_float2(__fmaf_rn(decay, v.x, u[n8][2 * half]),
                        __fmaf_rn(decay, v.y, u[n8][2 * half + 1]));
    }
  // every thread's S_c is written; one thread makes them visible at gpu
  // scope (cumulative over the barrier) and publishes
  __syncthreads();
  if (threadIdx.x == 0 && !last) {
    __threadfence();
    st_release(ch.flags + bh, ch.seq_base + c + 1);
  }
  // training: S_{c-1} as it enters this chunk, off the chain's path
  if (chunk_states) {
    float* cs = chunk_states + (static_cast<int64_t>(b) * n_chunks + c) * P.H * P.P * P.N +
                static_cast<int64_t>(h) * P.P * P.N;
#pragma unroll
    for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + gq + 8 * half;
        const int n = n8 * 8 + 2 * tq;
        if (p < P.P && n < P.N)
          *reinterpret_cast<float2*>(cs + static_cast<int64_t>(p) * P.N + n) = sp[n8][half];
      }
  }
  // then S_{c-1} as hi + lo bf16 for (f), off the chain's path
  if (carry) {
#pragma unroll
    for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + gq + 8 * half;
        const int n = n8 * 8 + 2 * tq;
        uint32_t hi, lo;
        split_pair(sp[n8][half].x, sp[n8][half].y, hi, lo);
        *reinterpret_cast<uint32_t*>(Shi_s + p * kBS + n) = hi;
        *reinterpret_cast<uint32_t*>(Slo_s + p * kBS + n) = lo;
      }
  }
  __syncthreads();

  // (f) y += exp(la_cum) o (C S_{c-1}^T), then y out
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int rt = rr == 0 ? warp : 2 * kWarps - 1 - warp;
    if (rt >= n16) continue;
    const int ia = rt * 16 + gq, ib = ia + 8;
    if (carry) {
      float acc[kP / 8][4];
#pragma unroll
      for (int n = 0; n < kP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      const bf16* crow = C_s + (rt * 16 + (mi & 1) * 8 + mr) * kBS + (mi >> 1) * 8;
      const int srow = ((mi >> 1) * 8 + mr) * kBS + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t cf[4];
        ldmatrix_x4(cf, crow + kk * 16);
#pragma unroll
        for (int pp = 0; pp < kP / 16; ++pp) {
          uint32_t bl[4], bhi[4];
          ldmatrix_x4(bl, Slo_s + srow + pp * 16 * kBS + kk * 16);
          ldmatrix_x4(bhi, Shi_s + srow + pp * 16 * kBS + kk * 16);
          mma_bf16(acc[2 * pp], cf, bl[0], bl[1]);
          mma_bf16(acc[2 * pp + 1], cf, bl[2], bl[3]);
          mma_bf16(acc[2 * pp], cf, bhi[0], bhi[1]);
          mma_bf16(acc[2 * pp + 1], cf, bhi[2], bhi[3]);
        }
      }
      const float ea = ecum_s[ia], eb = ecum_s[ib];
#pragma unroll
      for (int n = 0; n < kP / 8; ++n) {
        yacc[rr][n][0] = __fmaf_rn(ea, acc[n][0], yacc[rr][n][0]);
        yacc[rr][n][1] = __fmaf_rn(ea, acc[n][1], yacc[rr][n][1]);
        yacc[rr][n][2] = __fmaf_rn(eb, acc[n][2], yacc[rr][n][2]);
        yacc[rr][n][3] = __fmaf_rn(eb, acc[n][3], yacc[rr][n][3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? ib : ia;
      if (i >= rows) continue;
      bf16* dst = y + ((row0 + i) * P.H + h) * P.P;
#pragma unroll
      for (int n = 0; n < kP / 8; ++n) {
        const int p = n * 8 + 2 * tq;
        if (p < P.P)
          *reinterpret_cast<__nv_bfloat162*>(dst + p) = __floats2bfloat162_rn(
              yacc[rr][n][2 * half], yacc[rr][n][2 * half + 1]);
      }
    }
  }
}

int configure() {
  static bool done = false;                // opt in to > 48 KiB once
  if (!done) {
    for (const void* k : {reinterpret_cast<const void*>(ssd_scan_mma_kernel<8>),
                          reinterpret_cast<const void*>(ssd_scan_mma_kernel<4>)}) {
      const cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = true;
  }
  return 0;
}

int launch(const void* x, const float* la, const void* Bm, const void* Cm,
           const float* init, void* y, float* state, float* chunk_states, unsigned* ws,
           long long slots_offset,
           unsigned ticket_base, unsigned seq_base, const Shape& P, cudaStream_t stream) {
  const int rc = configure();
  if (rc) return rc;
  const int64_t n_chunks = (P.S + P.Q - 1) / P.Q;
  const int64_t grid = n_chunks * P.B * P.H;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Chain ch{ws, ws + kFlagsOffset, reinterpret_cast<float*>(ws + slots_offset),
                 ticket_base, seq_base};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm);
  const auto kernel = (P.P % 8 == 0 && P.N % 8 == 0 && addr % 16 == 0)
                          ? ssd_scan_mma_kernel<8>     // 16-byte copies
                          : ssd_scan_mma_kernel<4>;    // 8-byte copies
  kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), la, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), init, static_cast<bf16*>(y), state, chunk_states, ch, P);
  return static_cast<int>(cudaGetLastError());
}

int attrs(int* out) {
  const int rc = configure();
  if (rc) return rc;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, ssd_scan_mma_kernel<8>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_scan_mma_kernel<8>,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(kSmemBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace ssd_mma

extern "C" {

// x, Bm, Cm, y contiguous in one dtype (0 = f32, 1 = bf16); la, init (may
// be null), state and chunk_states (may be null; else B x n_chunks x H x P
// x N) f32.
int ssd_scan_fwd(const void* x, const void* la, const void* Bm, const void* Cm,
                 const void* init, void* y, void* state, void* chunk_states, int B, int S,
                 int H, int P, int G, int N, int chunk, int dtype, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || P % 4 || N % 4 || P < 4 || N < 4 ||
      P > kMaxP || N > kMaxN || chunk < 1 || chunk > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape shp{B, S, H, P, G, N, chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* laf = static_cast<const float*>(la);
  const auto* initf = static_cast<const float*>(init);
  auto* sf = static_cast<float*>(state);
  auto* cs = static_cast<float*>(chunk_states);
  if (dtype == 0) return launch<float>(x, laf, Bm, Cm, initf, y, sf, cs, shp, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, laf, Bm, Cm, initf, y, sf, cs, shp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 x, Bm, Cm and y, f32 la, init (may be null), state and
// chunk_states (may be null; else B x n_chunks x H x P x N), all
// contiguous, 8-byte aligned (16 for 16-byte copies).  `workspace` is
// kFlagsOffset words (the ticket first), then one flag per (b, h), then
// `slots` (16-byte aligned; room for 2 B H P N floats) at word offset
// `slots_offset`; ticket_base is the ticket's value before this call and
// seq_base the sequence base, both advanced by the caller (by the grid and
// by the number of chunks).
int ssd_scan_mma_fwd(const void* x, const void* la, const void* Bm, const void* Cm,
                     const void* init, void* y, void* state, void* chunk_states,
                     void* workspace,
                     long long slots_offset, unsigned ticket_base, unsigned seq_base,
                     int B, int S, int H, int P, int G, int N, int chunk, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || P % 4 || N % 4 || P < 4 || N < 4 ||
      P > ssd_mma::kP || N > ssd_mma::kN || chunk < 1 || chunk > ssd_mma::kQ)
    return static_cast<int>(cudaErrorInvalidValue);
  return ssd_mma::launch(x, static_cast<const float*>(la), Bm, Cm,
                         static_cast<const float*>(init), y, static_cast<float*>(state),
                         static_cast<float*>(chunk_states), static_cast<unsigned*>(workspace),
                         slots_offset, ticket_base,
                         seq_base, Shape{B, S, H, P, G, N, chunk},
                         static_cast<cudaStream_t>(stream));
}

// The tensor-core kernel's registers per thread, dynamic shared memory per
// block, resident blocks per SM and local-memory (spill) bytes per thread,
// into out[0..3].
int ssd_scan_mma_attrs(int* out) { return ssd_mma::attrs(out); }

}  // extern "C"
