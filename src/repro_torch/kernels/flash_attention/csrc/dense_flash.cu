// Dense flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_tpu (Pallas body _kernel). Query row i sits at position i
// and kv column j at position j; row i sees column j iff
//   (!causal || j <= i) && (window == 0 || j > i - window).
// Masked scores are -1e30 with no zero-row guard, as in the TPU kernel and
// flash_attention_ref: a row that sees nothing (possible only when T > S
// and window > 0) gets mean(V) over all S columns. q is scaled by
// 1/sqrt(D) in fp32; scores, the online softmax and every product run in
// fp32 from bf16 inputs; out = acc / max(l, 1e-30) rounded to bf16.
//
// One change of contract, as in the varlen kernel: k/v carry BH/G heads and
// q head h reads kv head h / G, so K/V are never repeated per q head. Any
// T and S are accepted: the kernels mask the ragged tile edges themselves.
//
// Entry points:
//  * forward: out (BH, T, D) bf16 and lse (BH, T) fp32 = m + log(l);
//  * backward: a pre-pass delta = rowsum(dO * O) (BH, T) fp32, then
//      dK/dV: one block per (kv head, kv tile); it loops over the G q heads
//        of that kv head and over the q tiles that can see the tile, so the
//        GQA sum is taken inside the block: no atomics, and gradients repeat
//        bit for bit;
//      dQ: one block per (q head, q tile), looping over its kv tiles.
//    P is recomputed as exp(s - lse) from the same fp32 FMA chain as the
//    forward, so it equals the forward's probabilities up to one rounding.
//
// Design (simple and right first): 128 threads per block as a 16 x 8 grid.
// A block stages its tiles in shared memory as fp32 rows padded to D + 1
// floats (conflict-free column reads); each thread owns R rows (ty + 16a)
// and the columns tx + 8b of every tile product, so the 8 threads of a row
// are 8 neighbouring lanes of one warp: row max and sum are three xor
// shuffles, and the probability tile a warp writes is read back by the same
// warp (__syncwarp, not __syncthreads). Fully masked kv tiles are skipped
// (causal and window ranges); a q tile holding a row that sees nothing
// scans every kv tile so that row gets its mean(V).
//
// What bounds it on the H100. At the training shape (granite-3-2b:
// B=2, H=32, KVL=8, D=64, T=S=2048, causal) the forward does 4*D FLOPs per
// visible (q head, slot) pair, 34.4 GFLOP against 50 MB of bf16 in and out:
// ~690 FLOP/byte, far above the card's ~295 balance point, so the bound is
// the operations at the 989 TFLOP/s bf16 tensor-core peak (~0.035 ms); the
// backward does 10*D per pair (~0.087 ms). This design runs every product
// on the CUDA cores in fp32 (67 TFLOP/s peak) from shared memory, so it
// sits one to two orders of magnitude above that bound. Left on the table:
// wgmma tensor-core products in bf16, a TMA + mbarrier pipeline that
// overlaps the next tile's load with this tile's math, and a persistent
// grid that balances the causal triangle over the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTx = 8;             // threads across a tile's columns
constexpr int kTy = 16;            // threads across a tile's rows
constexpr int kCols = 64;          // columns of a score tile
constexpr int kCpt = kCols / kTx;  // score columns per thread
constexpr int kLdP = kCols + 1;    // padded row of a probability tile
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// Rows a block owns: 64 q (or kv) rows, 32 at head dim 128 to bound the
// registers and shared memory per block.
template <int D>
struct Tiles {
  static constexpr int kRows = D >= 128 ? 32 : 64;
  static constexpr int kR = kRows / kTy;   // rows per thread
  static constexpr int kDc = D / kTx;      // head-dim columns per thread
  static constexpr int kLd = D + 1;        // padded fp32 row
};

// Stage `rows` rows of D bf16 values (row r at src + (r0 + r) * D) as
// padded fp32 rows dst[r * (D + 1) + d], times `mul`; rows at or past
// `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const bf16* src, int r0,
                                          int rows, int limit, float mul) {
  constexpr int kVec = D / 8;
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e % kVec) * 8;
    float f[8];
    if (r0 + r < limit) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * D + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(p[i]);
        f[2 * i] = t.x * mul;
        f[2 * i + 1] = t.y * mul;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    float* row = dst + r * (D + 1) + c;
#pragma unroll
    for (int i = 0; i < 8; ++i) row[i] = f[i];
  }
}

__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window) {
  return j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// max / sum over the 8 neighbouring lanes that share a row
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ float q_scale(int D) {
  return (float)(1.0 / sqrt((double)D));
}

// ------------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(kThreads)
dense_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int T, int S, int G, int causal,
                 int window) {
  using L = Tiles<D>;
  constexpr int BR = L::kRows, R = L::kR, DC = L::kDc, LD = L::kLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BR x LD
  float* ks = qs + BR * LD;                      // kCols x LD
  float* vs = ks + kCols * LD;                   // kCols x LD
  float* ps = vs + kCols * LD;                   // BR x kLdP

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int h = blockIdx.y, kvh = h / G;
  const int q0 = blockIdx.x * BR;
  const bf16* kh = k + (int64_t)kvh * S * D;
  const bf16* vh = v + (int64_t)kvh * S * D;
  load_tile<D>(qs, q + (int64_t)h * T * D, q0, BR, T, q_scale(D));

  const int q_last = min(q0 + BR, T) - 1;
  int lo = 0, hi = causal ? min(S, q_last + 1) : S;
  if (window > 0) {
    if (q_last >= S + window - 1) {
      hi = S;   // a row that sees nothing: its mean(V) needs every column
    } else {
      lo = max(0, q0 - window + 1);
    }
  }

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int j0 = (lo / kCols) * kCols; j0 < hi; j0 += kCols) {
    __syncthreads();   // every warp is done with the previous tile
    load_tile<D>(ks, kh, j0, kCols, S, 1.f);
    load_tile<D>(vs, vh, j0, kCols, S, 1.f);
    __syncthreads();

    float s[R][kCpt];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < kCpt; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[R], kb[kCpt];
#pragma unroll
      for (int a = 0; a < R; ++a) qa[a] = qs[(ty + kTy * a) * LD + d];
#pragma unroll
      for (int b = 0; b < kCpt; ++b) kb[b] = ks[(tx + kTx * b) * LD + d];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < kCpt; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = q0 + ty + kTy * a;
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < kCpt; ++b) {
        const int j = j0 + tx + kTx * b;
        // columns past S do not exist (weight 0); masked ones score -1e30
        const float x = j >= S ? -INFINITY
                        : visible(i, j, S, causal, window) ? s[a][b]
                                                           : kNegInf;
        s[a][b] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float mn = fmaxf(m[a], mx);
      const float corr = expf(m[a] - mn);
      float psum = 0.f;
#pragma unroll
      for (int b = 0; b < kCpt; ++b) {
        const float p = expf(s[a][b] - mn);
        ps[(ty + kTy * a) * kLdP + tx + kTx * b] = p;
        psum += p;
      }
      l[a] = l[a] * corr + row_sum(psum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
      m[a] = mn;
    }
    __syncwarp();   // a row's probabilities come from lanes of this warp

#pragma unroll 4
    for (int jj = 0; jj < kCols; ++jj) {
      float pa[R], vb[DC];
#pragma unroll
      for (int a = 0; a < R; ++a) pa[a] = ps[(ty + kTy * a) * kLdP + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = vs[jj * LD + tx + kTx * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pa[a], vb[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= T) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
    bf16* orow = out + ((int64_t)h * T + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      orow[tx + kTx * c] = __float2bfloat16_rn(acc[a][c] * inv);
    }
    if (tx == 0) lse[(int64_t)h * T + i] = m[a] + logf(l[a]);
  }
}

// ------------------------------------------------------ backward pre-pass
template <int D>
__global__ void __launch_bounds__(kThreads)
dense_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const uint4* op = reinterpret_cast<const uint4*>(o + r * D);
  const uint4* gp = reinterpret_cast<const uint4*>(dout + r * D);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 ro = op[c], rg = gp[c];
    const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&ro);
    const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&rg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(po[i]);
      const float2 b = __bfloat1622float2(pg[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
  delta[r] = acc;
}

// ------------------------------------------------------------ backward dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
dense_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int T, int S, int G, int causal, int window) {
  using L = Tiles<D>;
  constexpr int BR = L::kRows, R = L::kR, DC = L::kDc, LD = L::kLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BR x LD (scaled q)
  float* os = qs + BR * LD;                      // BR x LD (dO)
  float* ks = os + BR * LD;                      // kCols x LD
  float* vs = ks + kCols * LD;                   // kCols x LD
  float* dss = vs + kCols * LD;                  // BR x kLdP

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int h = blockIdx.y, kvh = h / G;
  const int q0 = blockIdx.x * BR;
  const float scale = q_scale(D);
  const bf16* kh = k + (int64_t)kvh * S * D;
  const bf16* vh = v + (int64_t)kvh * S * D;
  load_tile<D>(qs, q + (int64_t)h * T * D, q0, BR, T, scale);
  load_tile<D>(os, dout + (int64_t)h * T * D, q0, BR, T, 1.f);

  float lr[R], dr[R], acc[R][DC];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ty + kTy * a;
    lr[a] = i < T ? lse[(int64_t)h * T + i] : 0.f;
    dr[a] = i < T ? delta[(int64_t)h * T + i] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  // a row that sees nothing has dQ = 0: only the visible range is scanned
  const int q_last = min(q0 + BR, T) - 1;
  const int hi = causal ? min(S, q_last + 1) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int j0 = (lo / kCols) * kCols; j0 < hi; j0 += kCols) {
    __syncthreads();
    load_tile<D>(ks, kh, j0, kCols, S, 1.f);
    load_tile<D>(vs, vh, j0, kCols, S, 1.f);
    __syncthreads();

    float s[R][kCpt], dp[R][kCpt];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < kCpt; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qa[R], oa[R], kb[kCpt], vb[kCpt];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        qa[a] = qs[(ty + kTy * a) * LD + d];
        oa[a] = os[(ty + kTy * a) * LD + d];
      }
#pragma unroll
      for (int b = 0; b < kCpt; ++b) {
        kb[b] = ks[(tx + kTx * b) * LD + d];
        vb[b] = vs[(tx + kTx * b) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < kCpt; ++b) {
          s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
          dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = q0 + ty + kTy * a;
#pragma unroll
      for (int b = 0; b < kCpt; ++b) {
        const int j = j0 + tx + kTx * b;
        float ds = 0.f;
        if (i < T && visible(i, j, S, causal, window)) {
          ds = expf(s[a][b] - lr[a]) * (dp[a][b] - dr[a]);
        }
        dss[(ty + kTy * a) * kLdP + tx + kTx * b] = ds;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int jj = 0; jj < kCols; ++jj) {
      float da[R], kb[DC];
#pragma unroll
      for (int a = 0; a < R; ++a) da[a] = dss[(ty + kTy * a) * kLdP + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) kb[c] = ks[jj * LD + tx + kTx * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(da[a], kb[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= T) continue;
    bf16* row = dq + ((int64_t)h * T + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      row[tx + kTx * c] = __float2bfloat16_rn(acc[a][c] * scale);
    }
  }
}

// --------------------------------------------------------- backward dK/dV
template <int D>
__global__ void __launch_bounds__(kThreads)
dense_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int T, int S, int G, int causal,
                 int window) {
  using L = Tiles<D>;
  constexpr int BK = L::kRows, R = L::kR, DC = L::kDc, LD = L::kLd;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // BK x LD
  float* vs = ks + BK * LD;                      // BK x LD
  float* qs = vs + BK * LD;                      // kCols x LD (scaled q)
  float* os = qs + kCols * LD;                   // kCols x LD (dO)
  float* ps = os + kCols * LD;                   // BK x kLdP (P^T, then dS^T)
  float* ls = ps + BK * kLdP;                    // kCols lse
  float* dls = ls + kCols;                       // kCols delta
  float* tail = dls + kCols;                     // D

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int kvh = blockIdx.y;
  const int j0 = blockIdx.x * BK;
  const float scale = q_scale(D);
  load_tile<D>(ks, k + (int64_t)kvh * S * D, j0, BK, S, 1.f);
  load_tile<D>(vs, v + (int64_t)kvh * S * D, j0, BK, S, 1.f);

  // q rows that can see a column of this tile
  const int j_last = min(j0 + BK, S) - 1;
  const int i_lo = causal ? j0 : 0;
  const int i_hi = window > 0 ? min(T, j_last + window) : T;

  float gk[R][DC], gv[R][DC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[a][c] = gv[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int64_t h = (int64_t)kvh * G + g;
    for (int i0 = (i_lo / kCols) * kCols; i0 < i_hi; i0 += kCols) {
      __syncthreads();
      load_tile<D>(qs, q + h * T * D, i0, kCols, T, scale);
      load_tile<D>(os, dout + h * T * D, i0, kCols, T, 1.f);
      if (tid < kCols) {
        const int i = i0 + tid;
        ls[tid] = i < T ? lse[h * T + i] : 0.f;
        dls[tid] = i < T ? delta[h * T + i] : 0.f;
      }
      __syncthreads();

      float st[R][kCpt], dpt[R][kCpt];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < kCpt; ++b) st[a][b] = dpt[a][b] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float ka[R], va[R], qb[kCpt], ob[kCpt];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          ka[a] = ks[(ty + kTy * a) * LD + d];
          va[a] = vs[(ty + kTy * a) * LD + d];
        }
#pragma unroll
        for (int b = 0; b < kCpt; ++b) {
          qb[b] = qs[(tx + kTx * b) * LD + d];
          ob[b] = os[(tx + kTx * b) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < kCpt; ++b) {
            // fmaf(k, q, s) == fmaf(q, k, s): the forward's score, bitwise
            st[a][b] = fmaf(ka[a], qb[b], st[a][b]);
            dpt[a][b] = fmaf(va[a], ob[b], dpt[a][b]);
          }
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int j = j0 + ty + kTy * a;
#pragma unroll
        for (int b = 0; b < kCpt; ++b) {
          const int ib = tx + kTx * b;
          const int i = i0 + ib;
          float p = 0.f, ds = 0.f;
          if (i < T && visible(i, j, S, causal, window)) {
            p = expf(st[a][b] - ls[ib]);
            ds = p * (dpt[a][b] - dls[ib]);
          }
          st[a][b] = ds;
          ps[(ty + kTy * a) * kLdP + ib] = p;
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int ii = 0; ii < kCols; ++ii) {
        float pa[R], ob[DC];
#pragma unroll
        for (int a = 0; a < R; ++a) pa[a] = ps[(ty + kTy * a) * kLdP + ii];
#pragma unroll
        for (int c = 0; c < DC; ++c) ob[c] = os[ii * LD + tx + kTx * c];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) gv[a][c] = fmaf(pa[a], ob[c], gv[a][c]);
      }
      __syncwarp();
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < kCpt; ++b)
          ps[(ty + kTy * a) * kLdP + tx + kTx * b] = st[a][b];
      __syncwarp();
#pragma unroll 4
      for (int ii = 0; ii < kCols; ++ii) {
        float da[R], qb[DC];
#pragma unroll
        for (int a = 0; a < R; ++a) da[a] = ps[(ty + kTy * a) * kLdP + ii];
#pragma unroll
        for (int c = 0; c < DC; ++c) qb[c] = qs[ii * LD + tx + kTx * c];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) gk[a][c] = fmaf(da[a], qb[c], gk[a][c]);
      }
    }
  }

  // rows that see nothing (i >= S + window - 1) weigh every column 1/S:
  // their dO sum, over the G q heads, adds to every dV row
  if (window > 0 && S + window - 1 < T) {
    __syncthreads();
    if (tid < D) {
      float e = 0.f;
      for (int g = 0; g < G; ++g) {
        const bf16* og = dout + ((int64_t)kvh * G + g) * T * D;
        for (int i = S + window - 1; i < T; ++i) {
          e += __bfloat162float(og[(int64_t)i * D + tid]);
        }
      }
      tail[tid] = e;
    }
    __syncthreads();
    const float inv_s = 1.f / (float)S;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        gv[a][c] = fmaf(tail[tx + kTx * c], inv_s, gv[a][c]);
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = j0 + ty + kTy * a;
    if (j >= S) continue;
    bf16* krow = dk + ((int64_t)kvh * S + j) * D;
    bf16* vrow = dv + ((int64_t)kvh * S + j) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + kTx * c] = __float2bfloat16_rn(gk[a][c]);
      vrow[tx + kTx * c] = __float2bfloat16_rn(gv[a][c]);
    }
  }
}

// ---------------------------------------------------------------- launches
template <int D>
constexpr size_t fwd_bytes() {
  using L = Tiles<D>;
  return sizeof(float) * (L::kRows * L::kLd + 2 * kCols * L::kLd +
                          L::kRows * kLdP);
}

template <int D>
constexpr size_t dq_bytes() {
  using L = Tiles<D>;
  return sizeof(float) * (2 * L::kRows * L::kLd + 2 * kCols * L::kLd +
                          L::kRows * kLdP);
}

template <int D>
constexpr size_t dkv_bytes() {
  using L = Tiles<D>;
  return sizeof(float) * (2 * L::kRows * L::kLd + 2 * kCols * L::kLd +
                          L::kRows * kLdP + 2 * kCols + D);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int T, int S, int G, int causal,
               int window, cudaStream_t stream) {
  constexpr size_t bytes = fwd_bytes<D>();
  cudaError_t err = allow_smem(dense_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + Tiles<D>::kRows - 1) / Tiles<D>::kRows, BH);
  dense_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, S, G, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int BH, int T, int S, int G, int causal,
               int window, cudaStream_t stream) {
  using L = Tiles<D>;
  const int64_t rows = (int64_t)BH * T;
  dense_delta_kernel<D><<<(unsigned)((rows + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t kv_bytes = dkv_bytes<D>();
  err = allow_smem(dense_dkv_kernel<D>, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((S + L::kRows - 1) / L::kRows, BH / G);
  dense_dkv_kernel<D><<<kv_grid, kThreads, kv_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, S, G, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t q_bytes = dq_bytes<D>();
  err = allow_smem(dense_dq_kernel<D>, q_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid((T + L::kRows - 1) / L::kRows, BH);
  dense_dq_kernel<D><<<q_grid, kThreads, q_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), T, S, G, causal, window);
  return (int)cudaGetLastError();
}

bool bad_args(int BH, int T, int S, int G, int window) {
  return BH < 1 || T < 1 || S < 1 || G < 1 || BH % G != 0 || BH > 65535 ||
         window < 0;
}

}  // namespace

// q: (BH, T, D) bf16; k/v: (BH/G, S, D) bf16; out: (BH, T, D) bf16; lse:
// (BH, T) fp32. All contiguous, 16-byte aligned, on the device of `stream`.
// Returns a cudaError_t code (0 on a successful launch); does not
// synchronise.
extern "C" int dense_flash_fwd_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int BH, int T, int S, int D, int G,
                                    int causal, int window, void* stream) {
  if (bad_args(BH, T, S, G, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_fwd<16>(q, k, v, out, lse, BH, T, S, G, causal, window, cs);
    case 32:
      return launch_fwd<32>(q, k, v, out, lse, BH, T, S, G, causal, window, cs);
    case 64:
      return launch_fwd<64>(q, k, v, out, lse, BH, T, S, G, causal, window, cs);
    case 128:
      return launch_fwd<128>(q, k, v, out, lse, BH, T, S, G, causal, window,
                             cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Gradients of the forward above. out/lse: the forward's outputs; dout:
// (BH, T, D) bf16; delta: (BH, T) fp32 scratch; dq: (BH, T, D) bf16;
// dk/dv: (BH/G, S, D) bf16. Three launches on `stream` (delta, dK/dV, dQ);
// returns the first cudaError_t code that is not 0.
extern "C" int dense_flash_bwd_bf16(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv,
                                    int BH, int T, int S, int D, int G,
                                    int causal, int window, void* stream) {
  if (bad_args(BH, T, S, G, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_bwd<16>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, T,
                            S, G, causal, window, cs);
    case 32:
      return launch_bwd<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, T,
                            S, G, causal, window, cs);
    case 64:
      return launch_bwd<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, T,
                            S, G, causal, window, cs);
    case 128:
      return launch_bwd<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH,
                             T, S, G, causal, window, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dense_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
