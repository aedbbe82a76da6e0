// Paged decode attention for Hopper (sm_90a): one query token per sequence
// reads its pages IN PLACE through the block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py ::
// paged_decode_attention (Pallas body _kernel). Contract, as there:
//   q (B, KVL, G, D) bf16; kv_view (VP, 2, TPP, KVL, D) bf16 -- ONE layer of
//   the unified buffer, a strided view (its page stride is L*2*TPP*KVL*D);
//   tables / page_pos (B, P) int32; positions (B,) int32 -> out (B, KVL, G, D)
//   bf16. Table entries < 0 clamp to page 0. Slot t of table entry p sits at
//   position page_pos[b, p] + t and is visible iff slot_pos <= qpos (and
//   slot_pos > qpos - window when window != 0). Scores and the online softmax
//   run in fp32 with q scaled by 1/sqrt(D) in fp32; masked scores are the
//   finite -1e30 and there is NO zero-row guard, so a row with no visible slot
//   returns mean(V) over all P*TPP slots, exactly as the TPU kernel and its
//   ref do.
//
// Design (simple and right first):
//  * one 128-thread block per (kv head, row); the G q heads of the kv head
//    share every K/V slot the block stages;
//  * the block first asks whether any table entry has a visible slot. If one
//    has, only entries with a visible slot are read: an all-masked entry
//    contributes exp(-1e30 - m) = 0 once a visible score has set m, and
//    everything accumulated while m was still -1e30 is scaled by
//    exp(-1e30 - m) = 0 when it is, so skipping such entries changes nothing.
//    If none has (every slot lies past the row's position or outside its
//    window), every entry is read, clamped, for the mean(V) contract. Pad
//    and killed rows (position and page starts both SENTINEL) see slot 0 of
//    each clamped entry, as in the ref;
//  * entries are compacted in table order (ballot + prefix counts, so the
//    result is deterministic) 128 at a time, and their slots are staged 64 at
//    a time in shared memory, K and V widened to fp32;
//  * scores for (q head, slot) pairs are spread over the threads; one warp
//    per q head takes the chunk's max and sum; each thread owns fixed
//    (q head, d) outputs of the fp32 accumulator. bf16 out.
//
// What bounds it on the H100. Each visible slot moves 2*D*2 bytes of K+V per
// kv head and costs 4*D*G FLOPs over the kv head's G q heads: G FLOPs per
// byte, far below the ~295 FLOP/byte balance point. The bound is the bytes
// of the visible pages (plus q/out) at 3.35 TB/s. What this design leaves on
// the table: B*KVL blocks only (64 at the granite decode shape, under one
// wave of 132 SMs) with no split of a long row over several blocks
// (flash-decoding); no cp.async/TMA pipeline overlapping the next chunk's
// loads with this chunk's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;       // slots staged in shared memory at a time
constexpr int kMaxG = 16;        // q heads per kv head
constexpr float kNegInf = -1e30f;

// Element strides of kv_view's (page, K/V, slot, kv head) axes; D is
// contiguous and every row starts 16-byte aligned.
struct KvStrides {
  int64_t page, sel, slot, head;
};

template <int D>
struct Layout {
  static constexpr int kLd = D + 4;    // padded fp32 K row: float4 reads by
                                       // rows of 8 lanes hit distinct banks
  static constexpr int kOut = (kMaxG * D + kThreads - 1) / kThreads;
  // floats: ks[kChunk][kLd], vs[kChunk][D], qs[G][D], ps[G][kChunk],
  // m/l/corr[G]; then ints: list_eid[kThreads], list_pos[kThreads],
  // warp counts
  static size_t bytes(int G) {
    const size_t floats = (size_t)kChunk * kLd + (size_t)kChunk * D +
                          (size_t)G * D + (size_t)G * kChunk + 3 * (size_t)G;
    return floats * sizeof(float) + (2 * kThreads + kWarps) * sizeof(int);
  }
};

__device__ __forceinline__ bool page_visible(int ppos, int qpos, int tpp,
                                             int window) {
  // some slot of [ppos, ppos + tpp) is <= qpos (and > qpos - window)
  return ppos <= qpos && (window == 0 || ppos + tpp - 1 > qpos - window);
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kv,
                    const int* __restrict__ tables,
                    const int* __restrict__ page_pos,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, KvStrides st, int P,
                    int KVL, int G, int TPP, int window) {
  using L = Layout<D>;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kChunk * L::kLd;
  float* qs = vs + kChunk * D;
  float* ps = qs + G * D;
  float* m_s = ps + G * kChunk;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* list_eid = reinterpret_cast<int*>(c_s + G);
  int* list_pos = list_eid + kThreads;
  int* wcount = list_pos + kThreads;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qpos = positions[b];
  const int* tab = tables + (int64_t)b * P;
  const int* ppos = page_pos + (int64_t)b * P;

  const float scale = (float)(1.0 / sqrt((double)D));
  const __nv_bfloat16* qb = q + ((int64_t)b * KVL + h) * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    qs[e] = __bfloat162float(qb[e]) * scale;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[L::kOut];
#pragma unroll
  for (int i = 0; i < L::kOut; ++i) acc[i] = 0.f;

  int any = 0;
  for (int p = tid; p < P; p += kThreads) {
    any |= page_visible(ppos[p], qpos, TPP, window);
  }
  const bool any_visible = __syncthreads_or(any) != 0;   // also orders qs

  for (int p0 = 0; p0 < P; p0 += kThreads) {
    // ordered compaction of this round's entries (table order kept)
    const int p = p0 + tid;
    int eid = 0, pp = 0;
    bool take = false;
    if (p < P) {
      eid = max(tab[p], 0);
      pp = ppos[p];
      take = !any_visible || page_visible(pp, qpos, TPP, window);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int off = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w];
      if (w < warp) off += c;
      total += c;
    }
    if (take) {
      list_eid[off] = eid;
      list_pos[off] = pp;
    }
    __syncthreads();

    const int n_slots = total * TPP;
    for (int c0 = 0; c0 < n_slots; c0 += kChunk) {
      const int n = min(kChunk, n_slots - c0);
      constexpr int kVecPerRow = D / 8;
      for (int e = tid; e < kChunk * kVecPerRow; e += kThreads) {
        const int j = e / kVecPerRow;
        const int c = (e % kVecPerRow) * 8;
        float kf[8], vf[8];
        if (j < n) {
          const int slot = c0 + j;
          const int li = slot / TPP;
          const __nv_bfloat16* base = kv + (int64_t)list_eid[li] * st.page +
                                      (int64_t)(slot - li * TPP) * st.slot +
                                      (int64_t)h * st.head + c;
          bf16x8_to_float(*reinterpret_cast<const uint4*>(base), kf);
          bf16x8_to_float(*reinterpret_cast<const uint4*>(base + st.sel), vf);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
        }
        float4* kd = reinterpret_cast<float4*>(ks + j * L::kLd + c);
        float4* vd = reinterpret_cast<float4*>(vs + j * D + c);
        kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
        kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
        vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
        vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
      }
      __syncthreads();

      // scores: masked -> -1e30 (finite, as the TPU kernel); past the
      // chunk's end -> -inf, which never contributes
      for (int e = tid; e < G * kChunk; e += kThreads) {
        const int g = e / kChunk;
        const int j = e % kChunk;
        float s = -INFINITY;
        if (j < n) {
          const int slot = c0 + j;
          const int li = slot / TPP;
          const int spos = list_pos[li] + (slot - li * TPP);
          bool vis = spos <= qpos;
          if (window != 0) vis = vis && spos > qpos - window;
          s = kNegInf;
          if (vis) {
            const float4* kr = reinterpret_cast<const float4*>(ks + j * L::kLd);
            const float4* qr = reinterpret_cast<const float4*>(qs + g * D);
            float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
            for (int i = 0; i < D / 4; ++i) {
              const float4 kk = kr[i];
              const float4 qq = qr[i];
              d0 = fmaf(qq.x, kk.x, d0);
              d1 = fmaf(qq.y, kk.y, d1);
              d2 = fmaf(qq.z, kk.z, d2);
              d3 = fmaf(qq.w, kk.w, d3);
            }
            s = (d0 + d1) + (d2 + d3);
          }
        }
        ps[g * kChunk + j] = s;
      }
      __syncthreads();

      // online softmax update, one warp per q head
      for (int g = warp; g < G; g += kWarps) {
        float* row = ps + g * kChunk;
        const float s0 = row[lane];
        const float s1 = row[lane + 32];
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0v = expf(s0 - m_new);
        const float p1v = expf(s1 - m_new);
        row[lane] = p0v;
        row[lane + 32] = p1v;
        const float sum = warp_sum(p0v + p1v);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
          c_s[g] = corr;
        }
      }
      __syncthreads();

      // acc = acc * corr + P V over the chunk's slots
#pragma unroll
      for (int i = 0; i < L::kOut; ++i) {
        const int o = tid + i * kThreads;
        if (o < G * D) {
          const int g = o / D;
          const int d = o - g * D;
          const float* prow = ps + g * kChunk;
          float a = acc[i] * c_s[g];
          for (int j = 0; j < n; ++j) a = fmaf(prow[j], vs[j * D + d], a);
          acc[i] = a;
        }
      }
      __syncthreads();   // the next chunk overwrites ks, vs, ps and c_s
    }
  }

  __nv_bfloat16* ob = out + ((int64_t)b * KVL + h) * G * D;
#pragma unroll
  for (int i = 0; i < L::kOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * D) {
      const int g = o / D;
      ob[o] = __float2bfloat16(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <int D>
int launch(const void* q, const void* kv, const void* tables,
           const void* page_pos, const void* positions, void* out,
           const KvStrides& st, int B, int KVL, int G, int P, int TPP,
           int window, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes(G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<D>::bytes(kMaxG));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KVL, B);
  paged_decode_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), static_cast<const int*>(tables),
      static_cast<const int*>(page_pos), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), st, P, KVL, G, TPP, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, KVL, G, D) bf16 contiguous; kv: one layer's (VP, 2, TPP, KVL, D)
// view, strides[4] = element strides of its (page, K/V, slot, kv head) axes
// (D contiguous, rows 16-byte aligned); tables/page_pos: (B, P) int32;
// positions: (B,) int32; out: (B, KVL, G, D) bf16 contiguous. Device
// pointers on the device of `stream`. Returns a cudaError_t code (0 on a
// successful launch); the launch does not synchronise.
extern "C" int paged_decode_bf16(const void* q, const void* kv,
                                 const void* tables, const void* page_pos,
                                 const void* positions, void* out,
                                 const int64_t* strides, int B, int KVL,
                                 int G, int D, int P, int TPP, int window,
                                 void* stream) {
  if (B < 1 || KVL < 1 || G < 1 || G > kMaxG || P < 1 || TPP < 1 ||
      window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const KvStrides st{strides[0], strides[1], strides[2], strides[3]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, kv, tables, page_pos, positions, out, st, B, KVL,
                        G, P, TPP, window, cs);
    case 32:
      return launch<32>(q, kv, tables, page_pos, positions, out, st, B, KVL,
                        G, P, TPP, window, cs);
    case 64:
      return launch<64>(q, kv, tables, page_pos, positions, out, st, B, KVL,
                        G, P, TPP, window, cs);
    case 128:
      return launch<128>(q, kv, tables, page_pos, positions, out, st, B, KVL,
                         G, P, TPP, window, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
