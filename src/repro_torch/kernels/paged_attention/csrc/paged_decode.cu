// Paged decode attention for Hopper (sm_90a): one query token per sequence
// reads its pages IN PLACE through the block table, the pages brought into
// shared memory by asynchronous TMA copies through a ring of stages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py ::
// paged_decode_attention (Pallas body _kernel). Contract, as there:
//   q (B, KVL, G, D) bf16; kv_view (VP, 2, TPP, KVL, D) bf16 -- ONE layer of
//   the unified buffer, a strided view (its page stride is L*2*TPP*KVL*D);
//   tables / page_pos (B, P) int32; positions (B,) int32 -> out (B, KVL, G, D)
//   bf16. Table entries < 0 clamp to page 0. Slot t of table entry p sits at
//   position page_pos[b, p] + t and is visible iff slot_pos <= qpos (and
//   slot_pos > qpos - window when window != 0). Scores and the online softmax
//   run in fp32 with the 1/sqrt(D) scale applied in fp32; masked scores are
//   the finite -1e30 and there is NO zero-row guard, so a row with no visible
//   slot returns mean(V) over all P*TPP slots, exactly as the TPU kernel and
//   its ref do.
//
// What bounds it on the H100. Each visible slot moves 2*D*2 bytes of K+V per
// kv head and costs 4*D*G FLOPs over the kv head's G q heads: G FLOPs per
// byte (granite 4, qwen2.5-32b 5, zamba2 1), far below the ~295 FLOP/byte
// balance point, so the bound is the bytes of the visible pages at 3.35 TB/s
// (granite's decode case: ~8 MB, 2.4 us). A decode call is short: what keeps
// it from that bound is latency -- the dependent steps of a block (its work
// item, page ids, the first copy, the math of each page, the combine of
// split partials) and too few bytes in flight -- and, for short batches,
// blocks too few for the card's 132 SMs. The design:
//  * The per-step plan (kernel.py paged_decode_plan, built once per serve
//    step with torch ops and shared by every layer) lists each row's table
//    entries with a visible slot, compacted in table order (all P entries
//    for a row that sees nothing: the mean(V) contract), splits a row of n
//    entries into blocks of pps = max(8, ceil(n / max_splits(B))) pages and
//    lists the splits as work items, real items first, each with its first
//    page, so a block's first copy waits on no other read. An entry with no
//    visible slot is never read: its scores would weigh exp(-1e30 - m) = 0.
//  * One block per (work item, unit); a unit is a group of HG kv heads (and,
//    for G > 8, a group of 8 q heads). The grid, B x n_splits(B, P) items x
//    units, is what the host knows; a block past the plan's items exits at
//    once.
//  * A page's K and V rows of the unit's heads are ONE TMA box of a 5-d map
//    (D, slot, head, K/V, page) over the strided layer view (two boxes at D
//    128, one per 64 columns), swizzled so that the 8 slot rows an ldmatrix
//    reads hit distinct banks. A 1-D cp.async.bulk of the page's contiguous
//    run was tried first: a whole page lands unswizzled, slots 1 KB apart,
//    and every ldmatrix of 8 slots is an 8-way bank conflict; one bulk copy
//    per padded slot row avoided that but issued 32 copies a page, which
//    took warp 0 most of a page's time (scripts/paged_decode_timeline.py
//    traces a block's phases). Warp 0 issues pages ahead of the math into a
//    ring of stages (up to 8 in ~100 KB: two blocks an SM), each completed
//    on its mbarrier. HG (kernel.py head_group) is the largest power of two
//    <= 8 dividing KVL whose stage stays within 40 KB and that leaves the
//    batch at least 16 (row, unit) pairs: granite-3-2b's 8 rows HG 4 (16 KB
//    a stage; 8 gave too few blocks), qwen2.5-32b's D 128 HG 4 (32 KB),
//    zamba2-1.2b (KVL 32, TPP 19) HG 8 (38 KB: its whole 152 KB page would
//    not fit a two-stage ring); the constants were chosen by timing the
//    alternatives on the card (scripts/sweep_paged_split.py).
//  * 8 warps; warp w takes kv head w % HG of the unit. A step takes 8 / HG
//    pages, one to each of a head's warps, so a head's pages are worked on
//    in parallel; a __syncthreads ends the step and warp 0 refills the
//    stages it freed.
//  * The products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    sums) with the slots on the 16-row side: S^T = K q^T (q^T a constant B
//    fragment of N = 8 >= the block's q heads) and O^T += V^T P^T (V^T by
//    ldmatrix.trans, P rounded to bf16 and passed through shared memory),
//    16 slots a tile; the online softmax runs in base 2 (ex2) on the fp32
//    scores, column-wise over the tile's slots. The first form's fp32
//    CUDA-core products, with each score summed over a lane group by
//    shuffles and its softmax repeated in every lane, were most of its time.
//  * A row of one split writes out directly. Otherwise every split writes
//    fp32 (m, l, acc) partials; the last block of the (row, unit) to finish
//    (a counter in kernels/scratch.py's per-stream buffer, reset to 0 by
//    that block) combines them in split order, up to 8 threads an output
//    reading the splits in turn: one launch, no atomics on the data,
//    byte-identical repeats.
//  * On request (a non-null `lse`), each (row, kv head, q head)'s
//    natural-log log-sum-exp of its scaled scores over the slots it sees
//    goes to lse (B, KVL, G) fp32: ln 2 (m + log2 l) of the final base-2
//    pair, written beside the output. A row that sees nothing keeps its
//    mean(V) output and gets -inf (its m is the masked score, -1e30), so
//    partial results of a split page set (sequence-parallel decode, K/V
//    replica groups) combine through it. Without it nothing else changes.
//  * Head dim 120 (h2o-danube-3-4b) runs the D 128 instance with the true
//    head dim `dh` at run time: the page map's first dimension is 120, so
//    TMA lands columns 120-127 of K and V as zeros, q's are zeroed in its
//    fragments, the scale is 1/sqrt(120), and out and the split partials
//    hold dh columns. Pages stay 120 wide in the unified buffer: nothing is
//    padded or copied.

#include <atomic>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBlock = 32 * kWarps;
constexpr int kMaxStages = 8;
constexpr int kQHeads = 8;       // q heads of a kv head a block takes: N = 8
constexpr int kList = 64;        // plan entries warp 0 holds at a time
constexpr int kMerge = 8;        // split partials read at once by the merge
constexpr int kMaxDynSmem = 220 << 10;   // + the static arrays <= 227 KB
constexpr float kNegInf = -1e30f;

// Element strides of kv_view's (page, K/V, slot, kv head) axes; a slot's
// (KVL, D) is contiguous and every slot row starts 16-byte aligned.
struct KvStrides {
  int64_t page, sel, slot, head;
};

struct Params {
  const bf16* q;
  const int2* pages;      // plan: (B, P) (page id, page start)
  const int4* work;       // plan: the split work list
  const int* positions;
  bf16* out;
  float* lse;             // (B, KVL, G) log-sum-exp, or null
  float* part;            // split partials: acc, then (m, l)
  int* counters;          // (B x units), zero between launches
  int B, P, KVL, G, dh, TPP, window, HG, q_groups, n_units, stages;
  int n_split;            // the most splits of a row
  uint32_t box_bytes;     // a page's K and V rows of the unit's heads
  uint32_t chunk_bytes;   // a column chunk's rows in a stage (1024-aligned)
  uint32_t stage_bytes;
};

// The natural-log log-sum-exp of a base-2 running max m and sum l of
// 2^(score - m); -inf when m is the masked score (nothing seen).
__device__ __forceinline__ float row_lse(float m, float l) {
  return m <= 0.5f * kNegInf ? -INFINITY
                             : (m + log2f(l)) * 0.6931471805599453f;
}

// One 5-d box of the page map (D, slot, head, K/V, page) into shared
// memory at `dst`; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c2,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(0),
      "r"(c2), "r"(0), "r"(c4)
      : "memory");
}

// Four 8x8 bf16 matrices from shared memory (lanes 8m..8m+7 address matrix
// m's rows), as mma.sync fragments; .trans transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D(16 x 8) += A(16 x 16) B(16 x 8), bf16 in, fp32 sums: thread t holds
// D[t / 4][2 (t % 4) + {0, 1}] in d[0..1] and rows + 8 in d[2..3].
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// max / sum over the 8 lanes that share t % 4 (one column of a fragment)
__device__ __forceinline__ float col_max(float x) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ float col_sum(float x) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte offset of (row r, column col) in a stage: column chunks of CW values
// one after the other, rows of CW values as the page map's 128/64/32-byte
// swizzle stores them (the 16-byte unit index XORed with the row bits).
template <int D>
__device__ __forceinline__ uint32_t stage_off(uint32_t chunk_bytes, int r,
                                              int col) {
  using Gm = Geo<D>;
  const uint32_t off = (col / Gm::kCw) * chunk_bytes + r * Gm::kW +
                       (col % Gm::kCw) * 2;
  return off ^ (((off >> 7) & (Gm::kW / 16 - 1)) << 4);
}

template <int D>
__global__ void __launch_bounds__(kBlock)
paged_decode_kernel(const __grid_constant__ CUtensorMap map,
                    const __grid_constant__ Params p) {
  constexpr int KS = D / 16;         // k-steps of S, d tiles of O
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int pos_s[kMaxStages];
  __shared__ int2 list[kList];
  __shared__ __align__(16) bf16 pt[kWarps][kQHeads][16];   // P^T
  __shared__ int last;

  const int unit = blockIdx.x % p.n_units;
  // this block's work item: (row, split | the row's splits << 16, first
  // page, pages; its first page's id and start), or row -1 past the
  // plan's items
  const int4 item = p.work[2 * (blockIdx.x / p.n_units)];
  const int4 page0 = p.work[2 * (blockIdx.x / p.n_units) + 1];
  const int b = item.x;
  if (b < 0) return;                 // block-uniform: no pages here
  const int split = item.y & 0xffff, splits = item.y >> 16;
  const int first = item.z, n = item.w;
  if (splits < 1 || splits > p.n_split || n < 1) __trap();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = unit / p.q_groups;
  const int g0 = (unit % p.q_groups) * kQHeads;
  const int gn = min(kQHeads, p.G - g0);   // q heads of this block
  const int gq = min(p.G, kQHeads);        // q heads of a partial
  const int HG = p.HG, WH = kWarps / HG;
  const int hh = warp % HG, sp = warp / HG;
  const int qpos = p.positions[b];
  uint8_t* smem = smem_base(smem_raw);
  const uint32_t ring = smem_u32(smem);
  const int2* plist = p.pages + (int64_t)b * p.P + first;

  // one thread: page i's K and V rows of the unit's heads into stage
  // i % stages (one box a column chunk), and its start
  auto copy = [&](int i, int2 e) {
    const int s = i % p.stages;
    const uint32_t bar = smem_u32(&full[s]);
    pos_s[s] = e.y;
    bar_expect(bar, p.box_bytes);
#pragma unroll
    for (int c = 0; c < Geo<D>::kChunks; ++c) {
      tma_load_5d(ring + s * p.stage_bytes + c * p.chunk_bytes, &map, bar,
                  c * Geo<D>::kCw, grp * HG, e.x);
    }
  };
  // warp 0: the same from the split's page list, 64 entries at a time
  auto issue = [&](int i) {
    if (i % kList == 0) {
      for (int k = lane; k < kList && i + k < n; k += 32) {
        list[k] = plist[i + k];
      }
      __syncwarp();
    }
    if (lane == 0) copy(i, list[i % kList]);
    __syncwarp();
  };
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) bar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    copy(0, make_int2(page0.x, page0.y));   // before the page list is read
  }
  if (warp == 0) {
    for (int k = lane; k < kList && k < n; k += 32) list[k] = plist[k];
  }
  __syncthreads();
  if (warp == 0) {
    for (int i = 1; i < min(n, p.stages); ++i) issue(i);
  }

  // q^T as the B fragments of S^T = K q^T (k = d, n = q head lane / 4)
  uint32_t qb[KS][2];
  {
    const int g = lane >> 2;
    const bf16* qr = p.q + (((int64_t)b * p.KVL + grp * HG + hh) * p.G +
                            g0 + g) * p.dh + 2 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qb[kk][0] = g < gn && 16 * kk < p.dh ? ld_u32(qr + 16 * kk) : 0u;
      qb[kk][1] = g < gn && 16 * kk + 8 < p.dh ? ld_u32(qr + 16 * kk + 8)
                                                : 0u;
    }
  }
  // scores in log2 units: the softmax runs in base 2 (ex2)
  const float scale = attn_scale(p.dh) * kLog2e;
  // this lane's columns: q heads 2 (lane % 4) and 2 (lane % 4) + 1
  float o[KS][4], m[2], l[2];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  }
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  // a stage's rows: K of head h, slot t at h * TPP + t; V after HG * TPP.
  // ldmatrix rows: K tiles take slot (lane & 7) + 8 ((lane >> 3) & 1) and
  // columns + 8 (lane >> 4); V^T tiles slot (lane & 7) + 8 (lane >> 4) and
  // columns + 8 ((lane >> 3) & 1)
  const int k_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int k_col = 8 * (lane >> 4);
  const int v_row = (lane & 7) + 8 * (lane >> 4);
  const int v_col = 8 * ((lane >> 3) & 1);
  const int k_r0 = hh * p.TPP, v_r0 = (HG + hh) * p.TPP;
  bf16(*ptw)[16] = pt[warp];
  const int n_mt = (p.TPP + 15) / 16;            // 16-slot tiles a page
  // a step takes WH pages, one to each of a head's warps
  for (int i0 = 0; i0 < n; i0 += WH) {
    const int i = i0 + sp;
    const int s = i % p.stages;
    if (i < n) bar_wait(smem_u32(&full[s]), (i / p.stages) & 1);
    const int ppos = pos_s[s];
    const uint32_t st = ring + s * p.stage_bytes;
    for (int mt = 0; mt < (i < n ? n_mt : 0); ++mt) {
      const int t0 = 16 * mt;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const int r = k_r0 + min(t0 + k_row, p.TPP - 1);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[4];
          ldsm_x4(st + stage_off<D>(p.chunk_bytes, r, 16 * kk + k_col), a);
          mma16816(sc, a, qb[kk][0], qb[kk][1]);
        }
      }
      // sc: slots t, t + 8 x q heads 2 (lane % 4) + {0, 1}. Masked -> -1e30
      // (finite, as the TPU kernel); past the page -> -inf, which never
      // contributes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + (lane >> 2) + 8 * h;
        const int spos = ppos + t;
        const bool vis =
            spos <= qpos && (p.window == 0 || spos > qpos - p.window);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = sc[2 * h + c];
          v = t < p.TPP ? (vis ? v * scale : kNegInf) : -INFINITY;
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float mn = fmaxf(m[c], col_max(fmaxf(sc[c], sc[2 + c])));
        const float corr = ex2(m[c] - mn);
        m[c] = mn;
        sc[c] = ex2(sc[c] - mn);
        sc[2 + c] = ex2(sc[2 + c] - mn);
        l[c] = l[c] * corr + (sc[c] + sc[2 + c]);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          o[dt][c] *= corr;
          o[dt][2 + c] *= corr;
        }
      }
      // P^T through shared memory: the B fragments of O^T += V^T P^T
      {
        const int ga = 2 * (lane & 3), t = lane >> 2;
        ptw[ga][t] = __float2bfloat16(sc[0]);
        ptw[ga + 1][t] = __float2bfloat16(sc[1]);
        ptw[ga][t + 8] = __float2bfloat16(sc[2]);
        ptw[ga + 1][t + 8] = __float2bfloat16(sc[3]);
      }
      __syncwarp();
      const uint32_t pb0 = ld_u32(&ptw[lane >> 2][2 * (lane & 3)]);
      const uint32_t pb1 = ld_u32(&ptw[lane >> 2][2 * (lane & 3) + 8]);
      __syncwarp();
      {
        const int r = v_r0 + min(t0 + v_row, p.TPP - 1);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          uint32_t a[4];
          ldsm_x4_t(st + stage_off<D>(p.chunk_bytes, r, 16 * dt + v_col), a);
          mma16816(o[dt], a, pb0, pb1);
        }
      }
    }
    __syncthreads();                 // every warp is done with the step
    if (warp == 0) {
      for (int j = i0; j < min(i0 + WH, n - p.stages); ++j) {
        issue(j + p.stages);
      }
    }
  }

  // each warp's partial to shared memory (the ring is free now)
  float* red = reinterpret_cast<float*>(smem);    // [warp][8][D]
  float* red_ml = red + kWarps * kQHeads * D;     // [warp][8][2]
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l[c] = col_sum(l[c]);
    const int g = 2 * (lane & 3) + c;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      const int d = 16 * dt + (lane >> 2);
      red[(warp * kQHeads + g) * D + d] = o[dt][c];
      red[(warp * kQHeads + g) * D + d + 8] = o[dt][2 + c];
    }
    if (lane < 4) {
      red_ml[(warp * kQHeads + g) * 2] = m[c];
      red_ml[(warp * kQHeads + g) * 2 + 1] = l[c];
    }
  }
  __syncthreads();

  // per (kv head, q head, 8 columns; those past dh are skipped): the
  // head's warps in order; then out, or this split's partial
  constexpr int NC = D / 8;
  const int items = HG * gn * NC;
  const int64_t slot0 = ((int64_t)b * p.n_units + unit) * p.n_split;
  const int64_t part_el = (int64_t)HG * gq * p.dh;   // acc floats a partial
  float* part_ml = p.part + (int64_t)p.B * p.n_units * p.n_split * part_el;
  for (int it = tid; it < items; it += kBlock) {
    const int h = it / (gn * NC), g = it / NC % gn, cc = it % NC;
    if (8 * cc >= p.dh) continue;
    float mm = kNegInf;
    for (int w = h; w < kWarps; w += HG) {
      mm = fmaxf(mm, red_ml[(w * kQHeads + g) * 2]);
    }
    float a[8] = {}, lt = 0.f;
    for (int w = h; w < kWarps; w += HG) {
      const float wt = ex2(red_ml[(w * kQHeads + g) * 2] - mm);
      lt = fmaf(red_ml[(w * kQHeads + g) * 2 + 1], wt, lt);
      const float* r = red + (w * kQHeads + g) * D + cc * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = fmaf(r[e], wt, a[e]);
    }
    if (splits == 1) {
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      if (p.lse != nullptr && cc == 0) {
        p.lse[((int64_t)b * p.KVL + grp * HG + h) * p.G + g0 + g] =
            row_lse(mm, lt);
      }
      uint4 pk;
      pk.x = pack_bf16(a[0] * inv, a[1] * inv);
      pk.y = pack_bf16(a[2] * inv, a[3] * inv);
      pk.z = pack_bf16(a[4] * inv, a[5] * inv);
      pk.w = pack_bf16(a[6] * inv, a[7] * inv);
      *reinterpret_cast<uint4*>(
          p.out + (((int64_t)b * p.KVL + grp * HG + h) * p.G + g0 + g) * p.dh +
          cc * 8) = pk;
    } else {
      const int64_t ps = slot0 + split;
      float4* dst = reinterpret_cast<float4*>(
          p.part + ps * part_el + (h * gq + g) * p.dh + cc * 8);
      dst[0] = make_float4(a[0], a[1], a[2], a[3]);
      dst[1] = make_float4(a[4], a[5], a[6], a[7]);
      if (cc == 0) {
        *reinterpret_cast<float2*>(part_ml +
                                   (ps * HG * gq + h * gq + g) * 2) =
            make_float2(mm, lt);
      }
    }
  }
  if (splits == 1) return;

  // the last split of the (row, unit) to finish combines them all in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = p.counters + (int64_t)b * p.n_units + unit;
    last = atomicAdd(ctr, 1) == splits - 1;
    if (last) *ctr = 0;              // every split has counted: ready again
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // tpi threads an item (consecutive lanes) take its splits in turn; their
  // sums are then combined by shuffles in a fixed order
  int tpi = 1;
  while (tpi < 8 && 2 * tpi * items <= kBlock) tpi *= 2;
  const int j = tid % tpi;
  const unsigned gmask = (0xffffffffu >> (32 - tpi)) << (lane & ~(tpi - 1));
  for (int it = tid / tpi; it < items; it += kBlock / tpi) {
    const int h = it / (gn * NC), g = it / NC % gn, cc = it % NC;
    if (8 * cc >= p.dh) continue;    // uniform over the item's tpi lanes
    const float* ml = part_ml + (slot0 * HG * gq + h * gq + g) * 2;
    const int64_t ml_step = (int64_t)HG * gq * 2;
    const float* pa =
        p.part + slot0 * part_el + (h * gq + g) * p.dh + cc * 8;
    float mm = kNegInf, a[8] = {}, lt = 0.f;
    for (int s0 = j; s0 < splits; s0 += kMerge * tpi) {
      float2 w[kMerge];
      float4 x0[kMerge], x1[kMerge];
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        const int sx = s0 + u * tpi;
        if (sx < splits) {
          w[u] = __ldcg(reinterpret_cast<const float2*>(ml + sx * ml_step));
          const float4* x = reinterpret_cast<const float4*>(pa + sx * part_el);
          x0[u] = __ldcg(x);
          x1[u] = __ldcg(x + 1);
        } else {
          w[u] = make_float2(-INFINITY, 0.f);
          x0[u] = x1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      float mc = mm;
#pragma unroll
      for (int u = 0; u < kMerge; ++u) mc = fmaxf(mc, w[u].x);
      const float corr = ex2(mm - mc);
      mm = mc;
      lt *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] *= corr;
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        const float wt = ex2(w[u].x - mm);
        lt = fmaf(w[u].y, wt, lt);
        a[0] = fmaf(x0[u].x, wt, a[0]);
        a[1] = fmaf(x0[u].y, wt, a[1]);
        a[2] = fmaf(x0[u].z, wt, a[2]);
        a[3] = fmaf(x0[u].w, wt, a[3]);
        a[4] = fmaf(x1[u].x, wt, a[4]);
        a[5] = fmaf(x1[u].y, wt, a[5]);
        a[6] = fmaf(x1[u].z, wt, a[6]);
        a[7] = fmaf(x1[u].w, wt, a[7]);
      }
    }
    for (int o = 1; o < tpi; o <<= 1) {
      const float mo = __shfl_xor_sync(gmask, mm, o);
      const float lo = __shfl_xor_sync(gmask, lt, o);
      const float mn = fmaxf(mm, mo);
      const float wa = ex2(mm - mn), wb = ex2(mo - mn);
      lt = lt * wa + lo * wb;
      mm = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[e] = a[e] * wa + __shfl_xor_sync(gmask, a[e], o) * wb;
      }
    }
    if (j != 0) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (p.lse != nullptr && cc == 0) {
      p.lse[((int64_t)b * p.KVL + grp * HG + h) * p.G + g0 + g] =
          row_lse(mm, lt);
    }
    uint4 pk;
    pk.x = pack_bf16(a[0] * inv, a[1] * inv);
    pk.y = pack_bf16(a[2] * inv, a[3] * inv);
    pk.z = pack_bf16(a[4] * inv, a[5] * inv);
    pk.w = pack_bf16(a[6] * inv, a[7] * inv);
    *reinterpret_cast<uint4*>(
        p.out + (((int64_t)b * p.KVL + grp * HG + h) * p.G + g0 + g) * p.dh +
        cc * 8) = pk;
  }
}

// Launch one instance; its shared-memory limit is raised once per device.
template <int D>
int launch(const CUtensorMap& map, const Params& p, dim3 grid, size_t smem,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(paged_decode_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  paged_decode_kernel<D><<<grid, kBlock, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}


// The tensor map of one layer's (VP, 2, TPP, KVL, dh) view as the 5-d
// (dh, slot, head, K/V, page), read in boxes of CW x TPP x HG x 2 x 1 (a
// page's K and V rows of HG heads, slots fastest) and swizzled for
// conflict-free ldmatrix rows; columns dh..D-1 of a box read as zeros.
template <int D>
bool make_page_map(CUtensorMap* map, const void* kv, const KvStrides& st,
                   int VP, int KVL, int dh, int TPP, int HG) {
  using Gm = Geo<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)dh, (cuuint64_t)TPP,
                              (cuuint64_t)KVL, 2, (cuuint64_t)VP};
  const cuuint64_t strides[4] = {(cuuint64_t)st.slot * 2,
                                 (cuuint64_t)st.head * 2,
                                 (cuuint64_t)st.sel * 2,
                                 (cuuint64_t)st.page * 2};
  const cuuint32_t box[5] = {(cuuint32_t)Gm::kCw, (cuuint32_t)TPP,
                             (cuuint32_t)HG, 2, 1};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Gm::kW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Gm::kW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(kv),
             dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* kv, const KvStrides& st, int VP, Params& p,
             dim3 grid, cudaStream_t stream) {
  using Gm = Geo<D>;
  CUtensorMap map;
  if (!make_page_map<D>(&map, kv, st, VP, p.KVL, p.dh, p.TPP, p.HG)) {
    return (int)cudaErrorInvalidValue;
  }
  // a stage: per column chunk the page's 2 x HG x TPP rows of CW values,
  // each chunk 1024-byte aligned (the swizzle's period)
  const uint32_t chunk = 2u * p.HG * p.TPP * Gm::kW;
  p.box_bytes = Gm::kChunks * chunk;
  p.chunk_bytes = (chunk + 1023u) & ~1023u;
  p.stage_bytes = Gm::kChunks * p.chunk_bytes;
  const size_t ring = (size_t)p.stages * p.stage_bytes;
  const size_t red = (size_t)kWarps * kQHeads * (D + 2) * sizeof(float);
  const size_t smem = (ring > red ? ring : red) + 1024;   // + alignment
  if (smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
  return launch<D>(map, p, grid, smem, stream);
}

}  // namespace

// q: (B, KVL, G, D) bf16 contiguous; kv: one layer's (VP, 2, TPP, KVL, D)
// view, strides[4] = element strides of its (page, K/V, slot, kv head) axes
// (a slot's (KVL, D) contiguous, the others multiples of 8, 16-byte
// aligned); pages (B, P, 2) and work (B x n_split, 8): the step's plan
// (kernel.py paged_decode_plan), int32, 16-byte aligned; positions: (B,)
// int32; out: (B, KVL, G, D) bf16 contiguous; lse: (B, KVL, G) fp32, or
// null for no log-sum-exp output. D is 16, 32, 64, 120 or 128. HG: kv heads a block (a power
// of two <= 8 dividing KVL); n_split: the most splits of a row in the plan;
// stages: ring stages, 2 to 8 and at least 8 / HG. With n_split > 1, part
// holds B x units x n_split x HG x min(G, 8) x (D + 2) floats of scratch
// and counters B x units int32 that must be zero; the kernel leaves them
// zero. Device pointers on the device of `stream`. Returns a cudaError_t
// code (0 on a successful launch); the launch does not synchronise.
extern "C" int paged_decode_bf16(const void* q, const void* kv,
                                 const void* pages, const void* work,
                                 const void* positions, void* out, void* lse,
                                 void* part,
                                 void* counters, const int64_t* strides,
                                 int B, int VP, int KVL, int G, int D, int P,
                                 int TPP, int window, int HG, int n_split,
                                 int stages, void* stream) {
  const KvStrides st{strides[0], strides[1], strides[2], strides[3]};
  if (B < 1 || VP < 1 || KVL < 1 || G < 1 || G > 2 * kQHeads || P < 1 ||
      TPP < 1 || TPP > 256 || window < 0 || HG < 1 || HG > kWarps ||
      (HG & (HG - 1)) != 0 || KVL % HG != 0 || n_split < 1 ||
      n_split > 0xffff || stages < 2 || stages < kWarps / HG ||
      stages > kMaxStages || st.head != D ||
      (n_split > 1 && (part == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.pages = static_cast<const int2*>(pages);
  p.work = static_cast<const int4*>(work);
  p.positions = static_cast<const int*>(positions);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.P = P;
  p.KVL = KVL;
  p.G = G;
  p.dh = D;
  p.TPP = TPP;
  p.window = window;
  p.HG = HG;
  p.q_groups = (G + kQHeads - 1) / kQHeads;
  p.n_units = KVL / HG * p.q_groups;
  p.stages = stages;
  p.n_split = n_split;
  // one block per (work item, unit): the plan's items come first
  const int64_t blocks = (int64_t)B * n_split * p.n_units;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(kv, st, VP, p, grid, cs);
    case 32:
      return launch_d<32>(kv, st, VP, p, grid, cs);
    case 64:
      return launch_d<64>(kv, st, VP, p, grid, cs);
    case 120:
    case 128:
      return launch_d<128>(kv, st, VP, p, grid, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
