// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a), in the contract
// of mamba_chunk_scan_varlen (kernel.py) with zero initial states: ragged
// token runs ("rows") [row_start[r], row_start[r] + row_len[r]) of one
// stream, chunk length L = 64 from each row's first token.
//
// It replaces no TPU kernel. The reference trains through the jnp
// mamba2_chunked (src/repro/models/blocks_seq.py :: mamba2_chunked, its
// chunk_step), which JAX differentiates; the Pallas kernel
// src/repro/kernels/mamba_scan/kernel.py :: mamba_chunk_scan has no
// backward. The port runs the scan's forward through mamba_scan.cu, so its
// gradient needs a kernel of its own.
//
// The maths, per row, head and chunk (a = -exp(a_log), lc = cumsum(dt a)
// over the chunk, lc_last at the chunk's last token, W_ts = exp(min(lc_t -
// lc_s, 0)) for s <= t else 0, S_in the state entering the chunk, dS the
// gradient of the state leaving it):
//   forward  y_t   = sum_s (C_t.B_s) W_ts dt_s x_s + exp(lc_t) S_in C_t
//            S_out = exp(lc_last) S_in + sum_s exp(lc_last - lc_s) dt_s x_s B_s^T
//   backward dS_in = exp(lc_last) dS + sum_t exp(lc_t) dy_t C_t^T
//            dx_s  = sum_t score_ts dy_t + exp(lc_last - lc_s) dt_s dS B_s
//            dC_t  = sum_s dG_ts B_s + exp(lc_t) S_in^T dy_t      (summed over heads)
//            dB_s  = sum_t dG_ts C_t + exp(lc_last - lc_s) dt_s dS^T x_s
//   with score_ts = (C_t.B_s) W_ts dt_s, dG_ts = (dy_t.x_s) W_ts dt_s; the
//   decay's gradient dlc_t (from W, the state read, the state update and
//   S_in's decay) flows back through the cumsum to dt (times a) and, summed
//   over tokens, to a_log (times a).
//
// Design. Three launches, each a fixed-order sum, no atomics: two calls give
// the same bytes (exact resume needs bitwise-repeatable gradients).
//  1. mamba_bwd_states_kernel, one block per (row, head): the chunk states
//     are recomputed, chunk by chunk in order, and each chunk's S_in stored;
//     then, in reverse, each chunk's dS stored. Recomputing costs one L x P x
//     N product a chunk (about a tenth of the backward's arithmetic) and
//     leaves the forward kernel, which the serve path runs, untouched; under
//     the per-super-block recomputation of training the forward runs twice
//     anyway, and saved states would hold P x N fp32 a chunk and head across
//     the checkpoint.
//  2. mamba_bwd_chunk_kernel, one block per (chunk, head), all chunks in
//     parallel: with S_in and dS known every intra-chunk gradient is local.
//     dx and ddt belong to one block each; dB and dC are summed over heads,
//     so each block writes its head's part, and da_log's part per chunk.
//  3. mamba_bwd_reduce_kernel: dB and dC summed over heads, da_log over
//     chunks, in index order.
//  Products are fp32 FMAs on the CUDA cores, 4 x 4 outputs a thread from
//  shared memory (the tensor cores, TMA and a persistent grid are later
//  work).
//
// What bounds it on the H100. It reads x, B, C, dt and dy once and writes
// dx, dB, dC, dt's and a_log's gradients once; about 10 L x 64 x 64
// multiply-adds a chunk and head is ~40 FLOP a byte, below the ~295 of the
// balance point, so the bound is the bytes at 3.35 TB/s. This version runs
// its products from shared memory on the CUDA cores and is far from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;          // chunk length
constexpr int kThreads = 256;

__device__ __forceinline__ float decay(float d) { return expf(fminf(d, 0.f)); }

// The chunks before row r (rows in index order, ceil(len / L) chunks each).
__device__ int chunks_before(const int* row_len, int r, int* red) {
  int tid = threadIdx.x, acc = 0;
  for (int i = tid; i < r; i += kThreads) acc += (row_len[i] + kL - 1) / kL;
  red[tid] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  int out = red[0];
  __syncthreads();
  return out;
}

// acc[a][b] += sum_{k0 <= k < k1} A[(i0 + a) * ai + k * ak] * B[(j0 + b) * bj + k * bk]
__device__ __forceinline__ void mm4(float (&acc)[4][4], const float* A, int ai,
                                    int ak, const float* B, int bj, int bk,
                                    int i0, int j0, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(i0 + a) * ai + k * ak];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(j0 + b) * bj + k * bk];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// This thread's 4 x 4 tile of an M x NC output: false if it has none.
__device__ __forceinline__ bool tile(int M, int NC, int& i0, int& j0) {
  int tj = NC / 4;
  if ((int)threadIdx.x >= (M / 4) * tj) return false;
  i0 = (threadIdx.x / tj) * 4;
  j0 = (threadIdx.x % tj) * 4;
  return true;
}

// Chunk [t0, t0 + l) of head h: rows of width W (stride W + 1) in shared
// memory from a (token, W) view, zero past l. bf16 or fp32 sources.
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride, int t0, int l) {
  for (int i = threadIdx.x; i < kL * W; i += kThreads) {
    int s = i / W, c = i % W;
    float v = 0.f;
    if (s < l) {
      if constexpr (sizeof(T) == 2)
        v = __bfloat162float(src[(int64_t)(t0 + s) * stride + c]);
      else
        v = src[(int64_t)(t0 + s) * stride + c];
    }
    dst[s * (W + 1) + c] = v;
  }
}

// dt of chunk [t0, t0 + l), head h, into dtl (zero past l) and its
// cumulative log-decay into lc (serial, one thread: the order of the plain
// version's cumsum). Ends with a barrier.
__device__ __forceinline__ void load_decay(float* dtl, float* lc,
                                           const float* dt, int H, int h,
                                           int t0, int l, float a) {
  if (threadIdx.x < kL)
    dtl[threadIdx.x] =
        (int)threadIdx.x < l ? dt[(int64_t)(t0 + threadIdx.x) * H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int s = 0; s < kL; ++s) {
      acc += dtl[s] * a;
      lc[s] = acc;
    }
  }
  __syncthreads();
}

// ----------------------------------------------------------------- pass 1
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba_bwd_states_kernel(const __nv_bfloat16* __restrict__ x, int64_t x_stride,
                        const __nv_bfloat16* __restrict__ bm,
                        const __nv_bfloat16* __restrict__ cm,
                        int64_t bc_stride, const float* __restrict__ dt,
                        const float* __restrict__ a_log,
                        const int* __restrict__ row_start,
                        const int* __restrict__ row_len,
                        const float* __restrict__ dy, float* __restrict__ states,
                        float* __restrict__ dstates, int H) {
  __shared__ float vs[kL * (P + 1)];     // x (pass a) or dy (pass b), scaled
  __shared__ float ms[kL * (N + 1)];     // B (pass a) or C (pass b)
  __shared__ float dtl[kL], lc[kL];
  __shared__ int red[kThreads];
  const int r = blockIdx.x, h = blockIdx.y;
  const int len = row_len[r];
  const int base = chunks_before(row_len, r, red);
  if (len == 0) return;
  const int start = row_start[r], nch = (len + kL - 1) / kL;
  const float a = -expf(a_log[h]);
  int i0, j0;
  const bool mine = tile(P, N, i0, j0);
  float acc[4][4], part[4][4];
  zero4(acc);
  // (a) S_in of every chunk, in order
  for (int c = 0; c < nch; ++c) {
    const int t0 = start + c * kL, l = min(kL, len - c * kL);
    load_rows<P>(vs, x + h * P, x_stride, t0, l);
    load_rows<N>(ms, bm, bc_stride, t0, l);
    load_decay(dtl, lc, dt, H, h, t0, l, a);
    const float last = lc[kL - 1];
    for (int i = threadIdx.x; i < kL * P; i += kThreads) {
      int s = i / P;
      vs[s * (P + 1) + i % P] *= decay(last - lc[s]) * dtl[s];
    }
    __syncthreads();
    if (mine) {
      float* out = states + ((int64_t)(base + c) * H + h) * P * N;
      const float e = expf(last);
      zero4(part);
      mm4(part, vs, 1, P + 1, ms, 1, N + 1, i0, j0, 0, kL);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          out[(i0 + p) * N + j0 + n] = acc[p][n];
          acc[p][n] = fmaf(e, acc[p][n], part[p][n]);
        }
    }
    __syncthreads();
  }
  // (b) dS leaving every chunk, in reverse (zero after the row's last)
  zero4(acc);
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = start + c * kL, l = min(kL, len - c * kL);
    load_rows<P>(vs, dy + h * P, (int64_t)H * P, t0, l);
    load_rows<N>(ms, cm, bc_stride, t0, l);
    load_decay(dtl, lc, dt, H, h, t0, l, a);
    const float last = lc[kL - 1];
    for (int i = threadIdx.x; i < kL * P; i += kThreads) {
      int t = i / P;
      vs[t * (P + 1) + i % P] *= expf(lc[t]);
    }
    __syncthreads();
    if (mine) {
      float* out = dstates + ((int64_t)(base + c) * H + h) * P * N;
      const float e = expf(last);
      zero4(part);
      mm4(part, vs, 1, P + 1, ms, 1, N + 1, i0, j0, 0, kL);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          out[(i0 + p) * N + j0 + n] = acc[p][n];
          acc[p][n] = fmaf(e, acc[p][n], part[p][n]);
        }
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------- pass 2
template <int P, int N>
struct ChunkSmem {
  float xs[kL * (P + 1)], dys[kL * (P + 1)];
  float bs[kL * (N + 1)], cs[kL * (N + 1)];
  float sin[P * (N + 1)], dso[P * (N + 1)];
  float sc[kL * (kL + 1)], dg[kL * (kL + 1)], vv[kL * (kL + 1)];
  float sy[kL * (N + 1)], sx[kL * (N + 1)];
  float dtl[kL], lc[kL], cf[kL], dlc[kL], ud[kL];
  float red[kThreads];
  int where[2];
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ x, int64_t x_stride,
                       const __nv_bfloat16* __restrict__ bm,
                       const __nv_bfloat16* __restrict__ cm, int64_t bc_stride,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const int* __restrict__ row_start,
                       const int* __restrict__ row_len,
                       const float* __restrict__ dy,
                       const float* __restrict__ states,
                       const float* __restrict__ dstates,
                       float* __restrict__ dx, float* __restrict__ dbp,
                       float* __restrict__ dcp, float* __restrict__ ddt,
                       float* __restrict__ da_part, int R, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<P, N>& sm = *reinterpret_cast<ChunkSmem<P, N>*>(smem_raw);
  const int g = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {             // (row, chunk) of chunk g, rows in order
    int acc = 0, row = -1, c = 0;
    for (int r = 0; r < R; ++r) {
      int k = (row_len[r] + kL - 1) / kL;
      if (g < acc + k) {
        row = r;
        c = g - acc;
        break;
      }
      acc += k;
    }
    sm.where[0] = row;
    sm.where[1] = c;
  }
  __syncthreads();
  const int row = sm.where[0], c = sm.where[1];
  if (row < 0) return;
  const int t0 = row_start[row] + c * kL;
  const int l = min(kL, row_len[row] - c * kL);
  const float a = -expf(a_log[h]);
  const int64_t sidx = ((int64_t)g * H + h) * P * N;
  load_rows<P>(sm.xs, x + h * P, x_stride, t0, l);
  load_rows<P>(sm.dys, dy + h * P, (int64_t)H * P, t0, l);
  load_rows<N>(sm.bs, bm, bc_stride, t0, l);
  load_rows<N>(sm.cs, cm, bc_stride, t0, l);
  for (int i = tid; i < P * N; i += kThreads) {
    int p = i / N, n = i % N;
    sm.sin[p * (N + 1) + n] = states[sidx + i];
    sm.dso[p * (N + 1) + n] = dstates[sidx + i];
  }
  load_decay(sm.dtl, sm.lc, dt, H, h, t0, l, a);
  const float last = sm.lc[kL - 1];
  if (tid < kL) sm.cf[tid] = decay(last - sm.lc[tid]) * sm.dtl[tid];
  int i0, j0;
  float acc[4][4], acc2[4][4];
  // score, dG and V = (dy.x) (C.B) W over the causal (t, s) pairs
  if (tile(kL, kL, i0, j0)) {
    zero4(acc);
    zero4(acc2);
    if (i0 + 3 >= j0) {
      mm4(acc, sm.cs, N + 1, 1, sm.bs, N + 1, 1, i0, j0, 0, N);
      mm4(acc2, sm.dys, P + 1, 1, sm.xs, P + 1, 1, i0, j0, 0, P);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = i0 + u, s = j0 + v;
        const float w = t >= s ? decay(sm.lc[t] - sm.lc[s]) : 0.f;
        const float gw = acc[u][v] * w, dw = acc2[u][v] * w;
        sm.sc[t * (kL + 1) + s] = gw * sm.dtl[s];
        sm.dg[t * (kL + 1) + s] = dw * sm.dtl[s];
        sm.vv[t * (kL + 1) + s] = dw * acc[u][v];
      }
  }
  __syncthreads();
  // dx_s = sum_{t >= s} score_ts dy_t + cf_s dS B_s
  if (tile(kL, P, i0, j0)) {
    zero4(acc);
    zero4(acc2);
    mm4(acc, sm.sc, 1, kL + 1, sm.dys, 1, P + 1, i0, j0, i0, kL);
    mm4(acc2, sm.bs, N + 1, 1, sm.dso, N + 1, 1, i0, j0, 0, N);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = i0 + u;
      if (s < l) {
        float* o = dx + ((int64_t)(t0 + s) * H + h) * P + j0;
#pragma unroll
        for (int v = 0; v < 4; ++v) o[v] = fmaf(sm.cf[s], acc2[u][v], acc[u][v]);
      }
    }
  }
  // dC_t (this head's part) = sum_{s <= t} dG_ts B_s + exp(lc_t) S_in^T dy_t
  if (tile(kL, N, i0, j0)) {
    zero4(acc);
    zero4(acc2);
    mm4(acc, sm.dg, kL + 1, 1, sm.bs, 1, N + 1, i0, j0, 0, min(kL, i0 + 4));
    mm4(acc2, sm.dys, P + 1, 1, sm.sin, 1, N + 1, i0, j0, 0, P);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = i0 + u;
      const float e = expf(sm.lc[t]);
#pragma unroll
      for (int v = 0; v < 4; ++v) sm.sy[t * (N + 1) + j0 + v] = acc2[u][v];
      if (t < l) {
        float* o = dcp + ((int64_t)(t0 + t) * H + h) * N + j0;
#pragma unroll
        for (int v = 0; v < 4; ++v) o[v] = fmaf(e, acc2[u][v], acc[u][v]);
      }
    }
  }
  // dB_s (this head's part) = sum_{t >= s} dG_ts C_t + cf_s dS^T x_s
  if (tile(kL, N, i0, j0)) {
    zero4(acc);
    zero4(acc2);
    mm4(acc, sm.dg, 1, kL + 1, sm.cs, 1, N + 1, i0, j0, i0, kL);
    mm4(acc2, sm.xs, P + 1, 1, sm.dso, 1, N + 1, i0, j0, 0, P);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = i0 + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) sm.sx[s * (N + 1) + j0 + v] = acc2[u][v];
      if (s < l) {
        float* o = dbp + ((int64_t)(t0 + s) * H + h) * N + j0;
#pragma unroll
        for (int v = 0; v < 4; ++v) o[v] = fmaf(sm.cf[s], acc2[u][v], acc[u][v]);
      }
    }
  }
  // <dS, S_in>, for the decay of S_in into S_out
  float part = 0.f;
  for (int i = tid; i < P * N; i += kThreads) {
    int p = i / N, n = i % N;
    part = fmaf(sm.dso[p * (N + 1) + n], sm.sin[p * (N + 1) + n], part);
  }
  sm.red[tid] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) sm.red[tid] += sm.red[tid + w];
    __syncthreads();
  }
  // per token: the gradient of lc, and the direct part of dt's
  float colv = 0.f, ud = 0.f;
  if (tid < kL) {
    const int t = tid;
    float rowq = 0.f, rr = 0.f, uu = 0.f;
    for (int s = 0; s <= t; ++s) rowq = fmaf(sm.vv[t * (kL + 1) + s], sm.dtl[s], rowq);
    for (int s = t; s < kL; ++s) colv += sm.vv[s * (kL + 1) + t];
    for (int n = 0; n < N; ++n) {
      rr = fmaf(sm.cs[t * (N + 1) + n], sm.sy[t * (N + 1) + n], rr);
      uu = fmaf(sm.bs[t * (N + 1) + n], sm.sx[t * (N + 1) + n], uu);
    }
    ud = decay(last - sm.lc[t]) * uu;
    sm.ud[t] = ud * sm.dtl[t];
    sm.dlc[t] = rowq - colv * sm.dtl[t] + expf(sm.lc[t]) * rr - sm.ud[t];
  }
  __syncthreads();
  if (tid == 0) {
    float tail = expf(last) * sm.red[0];
    for (int s = 0; s < kL; ++s) tail += sm.ud[s];
    sm.dlc[l - 1] += tail;
    float run = 0.f, da = 0.f;
    for (int s = kL - 1; s >= 0; --s) {   // reverse cumsum: d lc -> d ldec
      run += sm.dlc[s];
      sm.cf[s] = run;
      da = fmaf(run, sm.dtl[s], da);
    }
    da_part[(int64_t)g * H + h] = da;
  }
  __syncthreads();
  if (tid < l)
    ddt[(int64_t)(t0 + tid) * H + h] = colv + ud + sm.cf[tid] * a;
}

// ----------------------------------------------------------------- pass 3
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba_bwd_reduce_kernel(const float* __restrict__ dbp,
                        const float* __restrict__ dcp,
                        const float* __restrict__ da_part,
                        const float* __restrict__ a_log, float* __restrict__ dbm,
                        float* __restrict__ dcm, float* __restrict__ da_log,
                        int TT, int H, int G) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < (int64_t)TT * N) {
    const int64_t t = i / N, n = i % N;
    float b = 0.f, c = 0.f;
    for (int h = 0; h < H; ++h) {
      b += dbp[(t * H + h) * N + n];
      c += dcp[(t * H + h) * N + n];
    }
    dbm[i] = b;
    dcm[i] = c;
  } else if (i < (int64_t)TT * N + H) {
    const int h = (int)(i - (int64_t)TT * N);
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += da_part[(int64_t)k * H + h];
    da_log[h] = s * -expf(a_log[h]);
  }
}

template <int P, int N>
int launch(const void* x, int64_t x_stride, const void* bm, const void* cm,
           int64_t bc_stride, const void* dt, const void* a_log,
           const void* row_start, const void* row_len, const void* dy,
           void* states, void* dstates, void* dx, void* dbp, void* dcp,
           void* ddt, void* da_part, void* dbm, void* dcm, void* da_log,
           int TT, int R, int H, int G, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* bb = static_cast<const bf*>(bm);
  const bf* cb = static_cast<const bf*>(cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_log);
  const int* rs = static_cast<const int*>(row_start);
  const int* rl = static_cast<const int*>(row_len);
  const float* dyf = static_cast<const float*>(dy);
  mamba_bwd_states_kernel<P, N><<<dim3(R, H), kThreads, 0, stream>>>(
      xb, x_stride, bb, cb, bc_stride, dtf, af, rs, rl, dyf,
      static_cast<float*>(states), static_cast<float*>(dstates), H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)sizeof(ChunkSmem<P, N>);
  err = cudaFuncSetAttribute(mamba_bwd_chunk_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mamba_bwd_chunk_kernel<P, N><<<dim3(G, H), kThreads, smem, stream>>>(
      xb, x_stride, bb, cb, bc_stride, dtf, af, rs, rl, dyf,
      static_cast<const float*>(states), static_cast<const float*>(dstates),
      static_cast<float*>(dx), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(ddt),
      static_cast<float*>(da_part), R, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)TT * N + H;
  mamba_bwd_reduce_kernel<P, N>
      <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          static_cast<const float*>(dbp), static_cast<const float*>(dcp),
          static_cast<const float*>(da_part), af, static_cast<float*>(dbm),
          static_cast<float*>(dcm), static_cast<float*>(da_log), TT, H, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of y = scan(x, bm, cm, dt, a_log) over the rows, zero initial
// states, for the upstream gradient dy (TT, H, P) fp32 contiguous:
//   dx (TT, H, P), dbm, dcm (TT, N), ddt (TT, H), da_log (H,), all fp32 and
//   contiguous; dx, ddt, dbp and dcp zero-filled by the caller (tokens in no
//   row keep 0). Scratch: states and dstates (G, H, P, N) fp32, dbp and dcp
//   (TT, H, N) fp32, da_part (G, H) fp32 zero-filled; G >= the rows' chunk
//   count (TT / 64 + R always is). Returns a cudaError_t code.
extern "C" int mamba_scan_bwd(const void* x, int64_t x_stride, const void* bm,
                              const void* cm, int64_t bc_stride,
                              const void* dt, const void* a_log,
                              const void* row_start, const void* row_len,
                              const void* dy, void* states, void* dstates,
                              void* dx, void* dbp, void* dcp, void* ddt,
                              void* da_part, void* dbm, void* dcm,
                              void* da_log, int TT, int R, int H, int P, int N,
                              int G, void* stream) {
  if (R < 1 || H < 1 || TT < 1 || R > 65535 || H > 65535 ||
      G < TT / kL + R)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define MAMBA_BWD(PP, NN)                                                    \
  if (P == PP && N == NN)                                                    \
    return launch<PP, NN>(x, x_stride, bm, cm, bc_stride, dt, a_log,        \
                          row_start, row_len, dy, states, dstates, dx, dbp, \
                          dcp, ddt, da_part, dbm, dcm, da_log, TT, R, H, G,  \
                          cs);
  MAMBA_BWD(16, 16)
  MAMBA_BWD(32, 32)
  MAMBA_BWD(64, 64)
#undef MAMBA_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
