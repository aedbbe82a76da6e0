// Varlen (token-packed) segment-id flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_varlen_tpu (Pallas body _varlen_kernel). The T axis is one
// packed stream of concatenated segments: query token i sees kv slot j iff
//   kv_seg[j] == q_seg[i] && kv_pos[j] <= q_pos[i]
//   (&& kv_pos[j] > q_pos[i] - window when window != 0).
// Pads carry q seg -1 and kv seg -2. Scores and the online softmax run in
// fp32 with q pre-scaled by 1/sqrt(D) in fp32; fully masked tiles contribute
// nothing; the output is acc / max(l, 1e-30), so a row with no visible slot
// comes out exactly 0.
//
// GQA: q carries BH heads, k/v carry BH/G heads, and q head h reads kv head
// h / G (the (KVL, G) flattening of the packed serve path), so K/V are never
// repeated per q head.
//
// Design (simple and right first):
//  * one 128-thread block per (q head, up to 32 rows of a q tile of blk_q
//    rows); blk_q and blk_k are the sparse_blocks sizes the caller passes;
//  * per kv tile of blk_k slots the block reduces the tile's segment-id
//    interval (pads excluded) and skips the tile when it does not overlap the
//    q tile's interval -- the TPU kernel's skip test;
//  * a hit tile is staged 64 slots at a time in shared memory, K and V
//    widened to fp32 in padded rows;
//  * each thread owns one q row (q and its fp32 accumulator in registers);
//    the 128/rows threads of a row split the staged slots and their partial
//    softmax states are merged through shared memory.
//
// What bounds it on the H100. For the main path (granite-3-2b: H=32, KVL=8,
// G=4, D=64) each scanned kv tile moves blk_k*KVL*D*2*2 bytes of bf16 K+V
// from device memory, and each visible (query, slot) pair costs 4*D = 256
// FLOPs (QK^T and PV). A mixed step (T=512 over ~4.6k slots) does a few
// GFLOP per layer against ~1-10 MB of K/V, far above the H100's ~295
// FLOP/byte balance point: the bound is the operations, at the 989 TFLOP/s
// bf16 tensor-core peak. A decode-only step (T=16 over 8k slots) does ~16
// FLOPs per byte and is bound by the bytes.
//
// What this simple design leaves on the table: it does the arithmetic on
// the CUDA cores in fp32 (67 TFLOP/s peak) from shared memory instead of
// wgmma/mma.sync tensor-core products; it loads with plain vector loads and
// __syncthreads instead of a TMA + mbarrier pipeline that overlaps the next
// tile's load with this tile's math; each of the G q heads of a kv head
// re-stages the same K/V tiles (one block per kv head could serve all G);
// and the grid is not persistent over the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // kv slots staged in shared memory at a time
constexpr int kSub = 8;         // slots scored per online-softmax rescale
constexpr int kRowsPerBlock = 32;
constexpr float kNegInf = -1e30f;
constexpr int kBig = 1 << 30;
constexpr int kNoSeg = -0x7fffffff;   // matches no q or kv segment id

// Element strides of the (head, token) axes of q, k, v and out; the head
// dim is contiguous. Every row starts 16-byte aligned.
struct Strides {
  int64_t qh, qt, kh, kt, vh, vt, oh, ot;
};

template <int D>
struct Layout {
  static constexpr int kLd = D + 4;   // padded fp32 row: float4-aligned, banks shift by 4
  static constexpr int kStageFloats = 2 * kChunk * kLd;
  static constexpr int kMergeFloats = 2 * kThreads + kThreads * (D + 1);
  static constexpr int kFloats =
      kStageFloats > kMergeFloats ? kStageFloats : kMergeFloats;
  static constexpr int kInts = 2 * kChunk + 2 * kWarps;
  static constexpr size_t kBytes =
      kFloats * sizeof(float) + kInts * sizeof(int);
};

// Block-wide (min, max) of one int pair; every thread gets the result.
__device__ __forceinline__ void block_minmax(int lo, int hi, int* red,
                                             int& out_lo, int& out_hi) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = lo;
    red[kWarps + warp] = hi;
  }
  __syncthreads();
  out_lo = red[0];
  out_hi = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    out_lo = min(out_lo, red[w]);
    out_hi = max(out_hi, red[kWarps + w]);
  }
  __syncthreads();
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
varlen_flash_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    __nv_bfloat16* __restrict__ out, Strides st, int T,
                    int S, int G, int window, int blk_q, int blk_k, int rows,
                    int rows_p2) {
  using L = Layout<D>;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;
  float* vs = smem + kChunk * L::kLd;
  int* sseg = reinterpret_cast<int*>(smem + L::kFloats);
  int* spos = sseg + kChunk;
  int* red = spos + kChunk;

  // block -> (q tile of blk_q rows, its sub-block of `rows` rows)
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int kvh = h / G;
  const int n_sub = (blk_q + rows - 1) / rows;
  const int tile0 = (blockIdx.x / n_sub) * blk_q;
  const int sub0 = (blockIdx.x % n_sub) * rows;
  const int nsplit = kThreads / rows_p2;
  const int r = tid & (rows_p2 - 1);
  const int split = tid / rows_p2;
  const int row = tile0 + sub0 + r;
  const bool in_tile = r < rows && sub0 + r < blk_q && row < T;
  const int my_seg = in_tile ? q_seg[row] : kNoSeg;
  const int my_pos = in_tile ? q_pos[row] : 0;

  const float scale = (float)(1.0 / sqrt((double)D));
  float qr[D];
  if (in_tile) {
    const uint4* qp = reinterpret_cast<const uint4*>(
        q + (int64_t)h * st.qh + (int64_t)row * st.qt);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      bf16x8_to_float(qp[i], qr + 8 * i);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] *= scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }

  // the skip test uses the segment interval of the WHOLE q tile, so tile
  // pairs are scanned or skipped exactly as at the sparse_blocks sizes
  int qlo, qhi;
  {
    const int tr = tile0 + tid;
    const int s = (tid < blk_q && tr < T) ? q_seg[tr] : -1;
    block_minmax(s >= 0 ? s : kBig, s >= 0 ? s : -kBig, red, qlo, qhi);
  }

  float m = kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  if (qlo <= qhi) {   // block-uniform: an all-pad q tile scans nothing
    for (int k0 = 0; k0 < S; k0 += blk_k) {
      const int k1 = min(k0 + blk_k, S);
      int lo = kBig, hi = -kBig;
      for (int j = k0 + tid; j < k1; j += kThreads) {
        const int s = kv_seg[j];
        if (s >= 0) {
          lo = min(lo, s);
          hi = max(hi, s);
        }
      }
      int klo, khi;
      block_minmax(lo, hi, red, klo, khi);
      if (klo > qhi || khi < qlo) continue;   // block-uniform tile skip

      for (int c0 = k0; c0 < k1; c0 += kChunk) {
        const int n = min(kChunk, k1 - c0);
        constexpr int kVecPerRow = D / 8;
        for (int e = tid; e < kChunk * kVecPerRow; e += kThreads) {
          const int j = e / kVecPerRow;
          const int c = (e % kVecPerRow) * 8;
          float kf[8], vf[8];
          if (j < n) {
            const int64_t slot = c0 + j;
            bf16x8_to_float(*reinterpret_cast<const uint4*>(
                k + kvh * st.kh + slot * st.kt + c), kf);
            bf16x8_to_float(*reinterpret_cast<const uint4*>(
                v + kvh * st.vh + slot * st.vt + c), vf);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
          }
          float4* kd = reinterpret_cast<float4*>(ks + j * L::kLd + c);
          float4* vd = reinterpret_cast<float4*>(vs + j * L::kLd + c);
          kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
          kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
          vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
          vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
        }
        if (tid < kChunk) {
          const bool ok = tid < n;
          sseg[tid] = ok ? kv_seg[c0 + tid] : kNoSeg;
          spos[tid] = ok ? kv_pos[c0 + tid] : 0;
        }
        __syncthreads();

        for (int jb = split; jb < kChunk; jb += nsplit * kSub) {
          float s[kSub];
          float mx = m;
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int j = jb + u * nsplit;
            float x = kNegInf;
            if (j < kChunk) {
              const int ksg = sseg[j];
              const int kps = spos[j];
              bool vis = ksg == my_seg && kps <= my_pos;
              if (window != 0) vis = vis && kps > my_pos - window;
              if (vis) {
                const float4* kr =
                    reinterpret_cast<const float4*>(ks + j * L::kLd);
                // four independent sums: one serial chain of D FMAs
                // would stall on FMA latency
                float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
                for (int i = 0; i < D / 4; ++i) {
                  const float4 kk = kr[i];
                  d0 = fmaf(qr[4 * i], kk.x, d0);
                  d1 = fmaf(qr[4 * i + 1], kk.y, d1);
                  d2 = fmaf(qr[4 * i + 2], kk.z, d2);
                  d3 = fmaf(qr[4 * i + 3], kk.w, d3);
                }
                x = (d0 + d1) + (d2 + d3);
              }
            }
            s[u] = x;
            mx = fmaxf(mx, x);
          }
          // a fully masked group leaves the state as it was: p = 0, and
          // corr = exp(0) = 1 while no slot has been visible yet
          const float corr = expf(m - mx);
          const bool live = mx > kNegInf * 0.5f;
          float psum = 0.f;
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            s[u] = live ? expf(s[u] - mx) : 0.f;
            psum += s[u];
          }
          l = l * corr + psum;
          if (corr != 1.f) {
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] *= corr;
          }
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            if (s[u] != 0.f) {
              const float4* vr = reinterpret_cast<const float4*>(
                  vs + (jb + u * nsplit) * L::kLd);
#pragma unroll
              for (int i = 0; i < D / 4; ++i) {
                const float4 vv = vr[i];
                acc[4 * i] = fmaf(s[u], vv.x, acc[4 * i]);
                acc[4 * i + 1] = fmaf(s[u], vv.y, acc[4 * i + 1]);
                acc[4 * i + 2] = fmaf(s[u], vv.z, acc[4 * i + 2]);
                acc[4 * i + 3] = fmaf(s[u], vv.w, acc[4 * i + 3]);
              }
            }
          }
          m = mx;
        }
        __syncthreads();   // the next chunk overwrites the staged slots
      }
    }
  }

  float lt = l;
  if (nsplit > 1) {
    // merge the row's per-split partial states (staging buffers are free)
    float* mb = smem;
    float* lb = smem + kThreads;
    float* ab = smem + 2 * kThreads;
    mb[tid] = m;
    lb[tid] = l;
#pragma unroll
    for (int d = 0; d < D; ++d) ab[tid * (D + 1) + d] = acc[d];
    __syncthreads();
    if (split != 0 || !in_tile) return;
    float mt = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp) mt = fmaxf(mt, mb[r + sp * rows_p2]);
    lt = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const int t2 = r + sp * rows_p2;
      const float c = expf(mb[t2] - mt);
      lt = fmaf(lb[t2], c, lt);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ab[t2 * (D + 1) + d], c, acc[d]);
    }
  }
  if (!in_tile) return;
  const float inv_den = 1.f / fmaxf(lt, 1e-30f);
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
      out + (int64_t)h * st.oh + (int64_t)row * st.ot);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    op[i] = __floats2bfloat162_rn(acc[2 * i] * inv_den,
                                  acc[2 * i + 1] * inv_den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* kv_seg, const void* q_pos, const void* kv_pos,
           void* out, const Strides& st, int BH, int T, int S, int G,
           int window, int blk_q, int blk_k, cudaStream_t stream) {
  // a block takes up to kRowsPerBlock rows of a tile, so a mixed step has
  // several blocks per SM; the 128/rows_p2 threads of a row split the slots
  const int rows = blk_q < kRowsPerBlock ? blk_q : kRowsPerBlock;
  int rows_p2 = 1;
  while (rows_p2 < rows) rows_p2 <<= 1;
  const int n_tiles = (T + blk_q - 1) / blk_q;
  const int n_sub = (blk_q + rows - 1) / rows;
  const size_t bytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      varlen_flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles * n_sub, BH);
  varlen_flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out), st,
      T, S, G, window, blk_q, blk_k, rows, rows_p2);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, T, D) bf16; k/v: (BH/G, S, D) bf16; q_seg/q_pos: (T,) int32;
// kv_seg/kv_pos: (S,) int32; out: (BH, T, D) bf16. strides[8]: element
// strides of the (head, token) axes of q, k, v, out (head dim contiguous,
// every row 16-byte aligned). Device pointers on the device of `stream`.
// Returns a cudaError_t code (0 on a successful launch); the launch does not
// synchronise.
extern "C" int varlen_flash_bf16(const void* q, const void* k, const void* v,
                                 const void* q_seg, const void* kv_seg,
                                 const void* q_pos, const void* kv_pos,
                                 void* out, const int64_t* strides, int BH,
                                 int T, int S, int D, int G, int window,
                                 int blk_q, int blk_k, void* stream) {
  if (BH < 1 || T < 1 || S < 1 || G < 1 || BH % G != 0 || blk_q < 1 ||
      blk_q > kThreads || blk_k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, out, st, BH,
                        T, S, G, window, blk_q, blk_k, cs);
    case 32:
      return launch<32>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, out, st, BH,
                        T, S, G, window, blk_q, blk_k, cs);
    case 64:
      return launch<64>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, out, st, BH,
                        T, S, G, window, blk_q, blk_k, cs);
    case 128:
      return launch<128>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, out, st, BH,
                         T, S, G, window, blk_q, blk_k, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* varlen_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
