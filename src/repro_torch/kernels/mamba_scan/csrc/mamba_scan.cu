// Mamba2 SSD chunk scan for Hopper (sm_90a) over ragged token runs ("rows"),
// each with its own carried state.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py ::
// mamba_chunk_scan (Pallas body _kernel). What it computes, per row and head,
// chunk by chunk (chunk length L = 64, cumulative log-decay lc over the
// chunk's tokens, ldec_t = dt_t * -exp(a_log)):
//   y_t  = sum_{s<=t} (C_t . B_s) exp(min(lc_t - lc_s, 0)) dt_s x_s
//        + exp(lc_t) C_t . S                         (read of the carried state)
//   S   <- S exp(lc_last) + sum_s exp(min(lc_last - lc_s, 0)) dt_s x_s B_s^T
// The TPU kernel takes (B, T) rows of equal length with a zero initial state;
// this one takes the wider contract its two callers need: rows
// [row_start[r], row_start[r] + row_len[r]) of one token stream, an fp32
// initial state per row (s0) and the final state per row out (s1). A row of
// length 0 copies its state through. y is written only inside rows; the
// wrapper zeroes the rest.
//   x (TT, H, P) bf16, token stride x_stride (H*P inner elements contiguous);
//   bm, cm (TT, N) bf16, token stride bc_stride; dt (TT, H) fp32 (after
//   softplus); a_log (H,) fp32; row_start, row_len (R,) int32;
//   s0 (R, H, P, N) fp32 with row stride s0_stride; y (TT, H, P) fp32;
//   s1 (R, H, P, N) fp32 with row stride s1_stride (may alias s0).
//
// Design (simple and right first):
//  * one 256-thread block per (head, row); a loop over the row's chunks inside
//    the block takes the place of the TPU's sequential grid axis, and the
//    (P, N) fp32 state lives in shared memory for the whole row;
//  * per chunk, x, B and C are staged in shared memory as fp32 (rows padded to
//    an odd pitch so that the 16 threads of a half-warp reading 16 rows of one
//    column hit 16 banks), and one thread takes the cumulative log-decay;
//  * the 16 x 16 threads each own a strided 4 x 4 tile of the (t, s) scores,
//    then of the (t, p) outputs, then a (p, n) tile of the state: every
//    product runs in fp32 on the CUDA cores with a fixed summation order and
//    no atomics, so two calls give the same bytes;
//  * every decay exponent is clamped at <= 0, as on the TPU; tokens past the
//    row's end inside its last chunk are staged as zeros (dt = 0: no decay,
//    no contribution), and threads whose rows all lie past it skip the work,
//    so a one-token decode row costs one row of scores, not 64.
//
// What bounds it on the H100. Per token and head it reads P bf16 values of x
// and writes P fp32 values of y, and per row and head it reads and writes the
// P x N fp32 state; the FLOPs (about 4 (L/2 + 2 N) P per token and head at
// N ~ P) are a few per byte, far below the ~295 FLOP/byte balance point, so
// the bound is the bytes at 3.35 TB/s. What this design leaves on the table:
// C B^T is the same for every head yet is recomputed by each head's block;
// the products run on CUDA cores from shared memory (tensor cores would do
// them in bf16/tf32); there is no copy pipeline overlapping the next chunk's
// loads with this chunk's math; a long row is one block's serial loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;          // chunk length
constexpr int kG = 16;          // the threads form a kG x kG grid
constexpr int kTi = kL / kG;    // chunk rows per thread

template <int P, int N>
struct Smem {
  static constexpr int kPx = P + 1;    // x row pitch (floats)
  static constexpr int kPn = N + 1;    // B, C and state row pitch
  static constexpr int kPs = kL + 1;   // score row pitch
  // xs[kL][kPx], bs[kL][kPn], cs[kL][kPn], ss[P][kPn], sc[kL][kPs],
  // dts[kL], lc[kL]
  static constexpr int kFloats =
      kL * kPx + 2 * kL * kPn + P * kPn + kL * kPs + 2 * kL;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const __nv_bfloat16* __restrict__ x, int64_t x_stride,
                  const __nv_bfloat16* __restrict__ bm,
                  const __nv_bfloat16* __restrict__ cm, int64_t bc_stride,
                  const float* __restrict__ dt,
                  const float* __restrict__ a_log,
                  const int* __restrict__ row_start,
                  const int* __restrict__ row_len, const float* s0,
                  int64_t s0_stride, float* __restrict__ y, float* s1,
                  int64_t s1_stride, int H) {
  static_assert(P % kG == 0 && N % kG == 0, "P and N: multiples of 16");
  constexpr int kJp = P / kG;
  constexpr int kJn = N / kG;
  using S = Smem<P, N>;
  extern __shared__ float smem[];
  float* xs = smem;
  float* bs = xs + kL * S::kPx;
  float* cs = bs + kL * S::kPn;
  float* ss = cs + kL * S::kPn;
  float* sc = ss + P * S::kPn;
  float* dts = sc + kL * S::kPs;
  float* lc = dts + kL;

  const int tid = threadIdx.x;
  const int tx = tid % kG;
  const int ty = tid / kG;
  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int start = row_start[r];
  const int len = row_len[r];
  const float a = -expf(a_log[h]);

  const float* sin = s0 + (int64_t)r * s0_stride + (int64_t)h * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    ss[(e / N) * S::kPn + e % N] = sin[e];
  }

  for (int c0 = 0; c0 < len; c0 += kL) {
    const int cl = min(kL, len - c0);   // tokens of the row in this chunk
    const int64_t tok0 = (int64_t)start + c0;
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < kL * P; e += kThreads) {
      const int t = e / P, p = e % P;
      xs[t * S::kPx + p] =
          t < cl ? __bfloat162float(x[(tok0 + t) * x_stride + h * P + p])
                 : 0.f;
    }
    for (int e = tid; e < kL * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const int64_t off = (tok0 + t) * bc_stride + n;
      bs[t * S::kPn + n] = t < cl ? __bfloat162float(bm[off]) : 0.f;
      cs[t * S::kPn + n] = t < cl ? __bfloat162float(cm[off]) : 0.f;
    }
    if (tid < kL) dts[tid] = tid < cl ? dt[(tok0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < kL; ++t) {
        acc += dts[t] * a;
        lc[t] = acc;
      }
    }
    __syncthreads();

    // scores: sc[t][s] = (C_t . B_s) exp(min(lc_t - lc_s, 0)) dt_s, s <= t
    {
      float acc[kTi][kTi];
#pragma unroll
      for (int i = 0; i < kTi; ++i)
#pragma unroll
        for (int j = 0; j < kTi; ++j) acc[i][j] = 0.f;
      if (ty < cl) {
        for (int n = 0; n < N; ++n) {
          float cv[kTi], bv[kTi];
#pragma unroll
          for (int i = 0; i < kTi; ++i) cv[i] = cs[(ty + kG * i) * S::kPn + n];
#pragma unroll
          for (int j = 0; j < kTi; ++j) bv[j] = bs[(tx + kG * j) * S::kPn + n];
#pragma unroll
          for (int i = 0; i < kTi; ++i)
#pragma unroll
            for (int j = 0; j < kTi; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTi; ++i) {
        const int t = ty + kG * i;
#pragma unroll
        for (int j = 0; j < kTi; ++j) {
          const int s = tx + kG * j;
          float v = 0.f;
          if (s <= t && t < cl) {
            v = acc[i][j] * expf(fminf(lc[t] - lc[s], 0.f)) * dts[s];
          }
          sc[t * S::kPs + s] = v;
        }
      }
    }
    __syncthreads();

    // outputs: y[t][p] = sum_s sc[t][s] x[s][p] + exp(lc_t) C_t . S[p]
    if (ty < cl) {
      float yi[kTi][kJp], ys[kTi][kJp];
#pragma unroll
      for (int i = 0; i < kTi; ++i)
#pragma unroll
        for (int j = 0; j < kJp; ++j) yi[i][j] = ys[i][j] = 0.f;
      for (int s = 0; s < cl; ++s) {
        float sv[kTi], xv[kJp];
#pragma unroll
        for (int i = 0; i < kTi; ++i) sv[i] = sc[(ty + kG * i) * S::kPs + s];
#pragma unroll
        for (int j = 0; j < kJp; ++j) xv[j] = xs[s * S::kPx + tx + kG * j];
#pragma unroll
        for (int i = 0; i < kTi; ++i)
#pragma unroll
          for (int j = 0; j < kJp; ++j) yi[i][j] = fmaf(sv[i], xv[j], yi[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[kTi], sv[kJp];
#pragma unroll
        for (int i = 0; i < kTi; ++i) cv[i] = cs[(ty + kG * i) * S::kPn + n];
#pragma unroll
        for (int j = 0; j < kJp; ++j) sv[j] = ss[(tx + kG * j) * S::kPn + n];
#pragma unroll
        for (int i = 0; i < kTi; ++i)
#pragma unroll
          for (int j = 0; j < kJp; ++j) ys[i][j] = fmaf(cv[i], sv[j], ys[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTi; ++i) {
        const int t = ty + kG * i;
        if (t < cl) {
          const float f = expf(lc[t]);
          float* yrow = y + ((tok0 + t) * H + h) * P;
#pragma unroll
          for (int j = 0; j < kJp; ++j) yrow[tx + kG * j] = yi[i][j] + ys[i][j] * f;
        }
      }
    }
    __syncthreads();   // every read of ss and dts for y is done

    const float lend = lc[kL - 1];   // pads past the row add no decay
    if (tid < kL) dts[tid] = expf(fminf(lend - lc[tid], 0.f)) * dts[tid];
    __syncthreads();

    // state: S[p][n] = S[p][n] exp(lend) + sum_s sfac_s x[s][p] B[s][n]
    {
      const float decay = expf(lend);
      float acc[kJp][kJn];
#pragma unroll
      for (int i = 0; i < kJp; ++i)
#pragma unroll
        for (int j = 0; j < kJn; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < cl; ++s) {
        const float f = dts[s];
        float uv[kJp], bv[kJn];
#pragma unroll
        for (int i = 0; i < kJp; ++i) uv[i] = xs[s * S::kPx + ty + kG * i] * f;
#pragma unroll
        for (int j = 0; j < kJn; ++j) bv[j] = bs[s * S::kPn + tx + kG * j];
#pragma unroll
        for (int i = 0; i < kJp; ++i)
#pragma unroll
          for (int j = 0; j < kJn; ++j) acc[i][j] = fmaf(uv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kJp; ++i)
#pragma unroll
        for (int j = 0; j < kJn; ++j) {
          float* e = ss + (ty + kG * i) * S::kPn + tx + kG * j;
          *e = *e * decay + acc[i][j];
        }
    }
  }
  __syncthreads();
  float* sout = s1 + (int64_t)r * s1_stride + (int64_t)h * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    sout[e] = ss[(e / N) * S::kPn + e % N];
  }
}

template <int P, int N>
int launch(const void* x, int64_t x_stride, const void* bm, const void* cm,
           int64_t bc_stride, const void* dt, const void* a_log,
           const void* row_start, const void* row_len, const void* s0,
           int64_t s0_stride, void* y, void* s1, int64_t s1_stride, int R,
           int H, cudaStream_t stream) {
  const size_t bytes = Smem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, R);
  mamba_scan_kernel<P, N><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_stride,
      static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), bc_stride,
      static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const int*>(row_start), static_cast<const int*>(row_len),
      static_cast<const float*>(s0), s0_stride, static_cast<float*>(y),
      static_cast<float*>(s1), s1_stride, H);
  return (int)cudaGetLastError();
}

template <int P>
int launch_n(int N, const void* x, int64_t x_stride, const void* bm,
             const void* cm, int64_t bc_stride, const void* dt,
             const void* a_log, const void* row_start, const void* row_len,
             const void* s0, int64_t s0_stride, void* y, void* s1,
             int64_t s1_stride, int R, int H, cudaStream_t stream) {
#define MAMBA_N(NN)                                                          \
  case NN:                                                                   \
    return launch<P, NN>(x, x_stride, bm, cm, bc_stride, dt, a_log,          \
                         row_start, row_len, s0, s0_stride, y, s1, s1_stride, \
                         R, H, stream);
  switch (N) {
    MAMBA_N(16)
    MAMBA_N(32)
    MAMBA_N(64)
    MAMBA_N(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAMBA_N
}

}  // namespace

// Pointers are device pointers on the device of `stream`; strides count
// elements. Returns a cudaError_t code (0 on a successful launch); the launch
// does not synchronise. P (head dim) and N (state dim) are 16, 32, 64 or 128.
extern "C" int mamba_scan_varlen(const void* x, int64_t x_stride,
                                 const void* bm, const void* cm,
                                 int64_t bc_stride, const void* dt,
                                 const void* a_log, const void* row_start,
                                 const void* row_len, const void* s0,
                                 int64_t s0_stride, void* y, void* s1,
                                 int64_t s1_stride, int R, int H, int P,
                                 int N, void* stream) {
  if (R < 1 || H < 1 || R > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define MAMBA_P(PP)                                                          \
  case PP:                                                                   \
    return launch_n<PP>(N, x, x_stride, bm, cm, bc_stride, dt, a_log,        \
                        row_start, row_len, s0, s0_stride, y, s1, s1_stride, \
                        R, H, cs);
  switch (P) {
    MAMBA_P(16)
    MAMBA_P(32)
    MAMBA_P(64)
    MAMBA_P(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAMBA_P
}

extern "C" const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
