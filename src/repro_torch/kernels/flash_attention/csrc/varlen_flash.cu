// Varlen (token-packed) segment-id flash attention for Hopper (sm_90a), on
// the tensor cores (wgmma) and fed by TMA copies through a ring of
// shared-memory stages.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_varlen_tpu (Pallas body _varlen_kernel). The T axis is one
// packed stream of concatenated segments: query token i sees kv slot j iff
//   kv_seg[j] == q_seg[i] && kv_pos[j] <= q_pos[i]
//   (&& kv_pos[j] > q_pos[i] - window when window != 0).
// Pads carry q seg -1 and kv seg -2. A row with no visible slot comes out
// exactly 0. GQA: q carries BH heads, k/v carry BH/G heads, and q head h
// reads kv head h / G, so K/V are never repeated per q head. q, k, v and
// out may be strided views (head dim contiguous, the other strides
// multiples of 16 bytes), as the packed serve path passes them.
//
// Arithmetic (as the dense kernels of dense_flash.cu): every product is
// bf16 x bf16 into fp32; the 1/sqrt(D) scale and log2(e) go on the fp32
// scores after the product; the softmax runs in base 2 (ex2.approx); P is
// rounded to bf16 before P V while l sums the unrounded fp32 P; masked
// scores are -inf, and a row that has seen nothing yet keeps weight 0, so
// out = acc / max(l, 1e-30) is exactly 0 for a row with no visible slot.
//
// Design.
//  * One block per (kv head, q tile, kv split). Its 128 wgmma rows are GQA
//    packed: row r of a warpgroup's 64 is token r / G, q head r % G, so
//    every K/V tile staged in shared memory serves all G q heads of its kv
//    head. A warpgroup takes floor(64 / G) tokens (G = 5: 12 tokens, rows
//    60-63 masked); a q tile is two warpgroups' tokens. One 3-d tensor map
//    over (D, heads, tokens) loads a (tokens x G x D) box per warpgroup, for
//    the serve path's token-major views and contiguous head-major tensors
//    alike.
//  * Two consumer warpgroups and one producer warpgroup (setmaxnreg 232 /
//    40, as in dense_flash.cu). One producer thread issues the TMA copies
//    of K and V tiles (128 slots) into a ring of stages guarded by full /
//    empty mbarriers; the producer's first warp stages each tile's segment
//    ids and positions beside it. S = Q K^T and O += P V are wgmma products
//    (Q in registers at D <= 64), tile i + 1's scores issued before tile
//    i's P V, the two warpgroups taking turns to issue; the mask is applied
//    with selects on the fp32 scores, never a branch per score.
//  * Only kv tiles that can hit are loaded: a tile is skipped unless its
//    live slots' segment-id interval (pads excluded) meets the q tile's and
//    its positions can be seen (some slot at or before the q tile's last
//    position and, with a window, inside the first token's window). The
//    per-tile intervals (kv_tiles: seg lo/hi, pos lo/hi) are computed once
//    per serve step, beside the step's other varlen metadata, and shared
//    by every layer; each block builds its q tile's hit list from them.
//  * Long kv ranges are split across blocks (flash-decoding): the host
//    sets n_splits from T, S and the heads; a q tile whose hit list is
//    longer than split_tiles uses up to n_splits blocks, each over a
//    contiguous run of the list, writing fp32 partials (m, l, acc) to
//    scratch. The last block of the q tile to finish (a self-resetting
//    counter) combines them in split order: one launch, no atomics on the
//    data, bitwise-repeatable outputs.
//  * Outputs leave through shared memory as 16-byte stores into the
//    strided out.
//
// What bounds it on the H100. For the main path (granite-3-2b: H=32, KVL=8,
// G=4, D=64) a mixed serve step (T=512 over ~4.6k slots) needs ~1 GFLOP of
// visible products against ~10 MB of K/V, q and out: the bytes bound it
// (~0.004 ms at 3.35 TB/s), as they do a decode step (16 tokens over 8k
// slots). The tiles a block computes are wider than the visible pairs
// (128 slots x 128 rows, masked), so the tensor cores do several times the
// visible products; what keeps the kernel from the bound is latency: a few
// tiles per block, each a TMA round trip, a product pair and a masked
// softmax, and the combine of split partials. Left on the table: a
// persistent grid that balances q tiles of unequal hit counts, and a
// combine spread over several blocks.

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kQRows = 128;           // q rows per block: two warpgroups
constexpr int kTile = 128;            // kv slots per tile
constexpr int kMaxTiles = 2048;       // kv tiles of a stream (S <= 262144)
constexpr int kBig = 1 << 30;
constexpr int kNoSeg = -0x7fffffff;   // a q row past the tile: matches nothing
constexpr int kNoKv = -0x7ffffffe;    // a slot past S: matches nothing

// Element strides of the (head, token) axes of q, k, v and out.
struct Strides {
  int64_t qh, qt, kh, kt, vh, vt, oh, ot;
};

// Shared memory: Q (128 rows x D), kStages x (K, V) (128 slots x D each),
// kStages x the tile's segment ids and positions, output staging (128
// rows), the hit list, barriers.
template <int D>
struct VarlenSmem {
  static constexpr int kStages = D >= 128 ? 2 : 4;
  static constexpr uint32_t kQ = kQRows * D * 2;
  static constexpr uint32_t kKV = kTile * D * 2;
  static constexpr uint32_t kK = kQ;
  static constexpr uint32_t kV = kK + kStages * kKV;
  static constexpr uint32_t kMeta = kV + kStages * kKV;
  static constexpr uint32_t kMetaBytes = 2 * kTile * 4;
  static constexpr uint32_t kStage = kMeta + kStages * kMetaBytes;
  static constexpr uint32_t kHits = kStage + kQRows * Geo<D>::kPitch;
  static constexpr uint32_t kBars = kHits + kMaxTiles * 4;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// One kv tile's step of the online softmax over a warpgroup's 64 x kTile
// scores (fp32 products of the unscaled inputs) for this thread's rows
// (segment qs[h], position qp[h]; h 1 is 8 rows below h 0): mask with the
// tile's segment ids and positions (`meta`: seg[kTile], pos[kTile]), scale
// into log2 units, update the row maxima m and this thread's partial row
// sums l, and leave P in sc. corr gets the factors that rescale the rows'
// earlier output. Until a row has seen a slot its maximum stays -inf and
// every weight it gets is 0.
template <int NR>
__device__ __forceinline__ void softmax_step(float (&sc)[NR], const int* meta,
                                             const int (&qs)[2],
                                             const int (&qp)[2], int window,
                                             int lane, float sl2,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < NR / 4; ++n) {
    const int c = 8 * n + 2 * (lane & 3);     // acc_col(4 n, lane)
    const int2 sg = *reinterpret_cast<const int2*>(meta + c);
    const int2 ps = *reinterpret_cast<const int2*>(meta + kTile + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int ks = (e & 1) ? sg.y : sg.x;
      const int kp = (e & 1) ? ps.y : ps.x;
      // bitwise, not short-circuit: the tile's loop stays free of branches
      const bool vis = (ks == qs[h]) & (kp <= qp[h]) &
                       ((window == 0) | (kp > qp[h] - window));
      sc[4 * n + e] = vis ? sc[4 * n + e] * sl2 : -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    mu[r] = mn == -INFINITY ? 0.f : mn;
    corr[r] = ex2(m[r] - mu[r]);
    m[r] = mn;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    sc[i] = ex2(sc[i] - mu[(i >> 1) & 1]);
    ps[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
}

// The first `rows` staged rows of a warpgroup to out: row r is token tok0 +
// r / G, head h0 + r % G; 16 bytes a thread per step.
template <int D>
__device__ __forceinline__ void store_rows(const uint8_t* st, bf16* out,
                                           int64_t oh, int64_t ot, int rows,
                                           int tok0, int h0, int G, int t) {
  constexpr int kVec = D / 8;
  for (int e = t; e < rows * kVec; e += 128) {
    const int r = e / kVec, v = e % kVec;
    bf16* dst = out + (int64_t)(h0 + r % G) * oh +
                (int64_t)(tok0 + r / G) * ot + 8 * v;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(st + r * Geo<D>::kPitch + 16 * v);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
varlen_flash_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    const int4* __restrict__ kv_tiles,
                    bf16* __restrict__ out, int64_t out_h, int64_t out_t,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ counters,
                    int T, int S, int G, int window, int n_splits,
                    int split_tiles) {
  using Gm = Geo<D>;
  using L = VarlenSmem<D>;
  constexpr int NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int red[kThreads / 32][4];
  __shared__ int info[2];   // hit count; last block of the q tile
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t base = smem_u32(sm);
  int* hits = reinterpret_cast<int*>(sm + L::kHits);

  const int tq_w = 64 / G;                       // tokens per warpgroup
  const int qt = blockIdx.x / n_splits, sp = blockIdx.x % n_splits;
  const int kvh = blockIdx.y;
  const int t0 = qt * 2 * tq_w;
  const int n_kt = (S + kTile - 1) / kTile;

  // ---- the q tile's segment and position intervals, pads excluded
  {
    const int tok = t0 + threadIdx.x;
    int s = -1, p = 0;
    if ((int)threadIdx.x < 2 * tq_w && tok < T) {
      s = q_seg[tok];
      p = q_pos[tok];
    }
    const bool ok = s >= 0;
    const int w = threadIdx.x >> 5;
    const int v0 = __reduce_min_sync(0xffffffffu, ok ? s : kBig);
    const int v1 = __reduce_max_sync(0xffffffffu, ok ? s : -kBig);
    const int v2 = __reduce_min_sync(0xffffffffu, ok ? p : kBig);
    const int v3 = __reduce_max_sync(0xffffffffu, ok ? p : -kBig);
    if ((threadIdx.x & 31) == 0) {
      red[w][0] = v0;
      red[w][1] = v1;
      red[w][2] = v2;
      red[w][3] = v3;
    }
  }
  __syncthreads();
  // ---- the hit list: kv tiles whose slots this q tile may see, in order
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int qlo = kBig, qhi = -kBig, plo = kBig, phi = -kBig;
    for (int w = 0; w < kThreads / 32; ++w) {
      qlo = min(qlo, red[w][0]);
      qhi = max(qhi, red[w][1]);
      plo = min(plo, red[w][2]);
      phi = max(phi, red[w][3]);
    }
    int n = 0;
    if (qlo <= qhi) {
      for (int k0 = 0; k0 < n_kt; k0 += 32) {
        const int k = k0 + lane;
        bool hit = false;
        if (k < n_kt) {
          const int4 b = kv_tiles[k];
          hit = (b.x <= qhi) & (b.y >= qlo) & (b.z <= phi) &
                ((window == 0) | (b.w > plo - window));
        }
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) hits[n + __popc(mask & ((1u << lane) - 1u))] = k;
        n += __popc(mask);
      }
    }
    if (lane == 0) info[0] = n;
  }
  __syncthreads();
  const int nhit = info[0];
  const int used =
      max(1, min(n_splits, (nhit + split_tiles - 1) / split_tiles));
  if (sp >= used) return;   // block-uniform: this split has no tiles
  const int first = (int)((int64_t)sp * nhit / used);
  const int n_tiles = (int)((int64_t)(sp + 1) * nhit / used) - first;

  // valid rows of each warpgroup (tokens before T)
  const int rows0 = max(0, min(tq_w, T - t0)) * G;
  const int rows1 = max(0, min(tq_w, T - t0 - tq_w)) * G;
  const int n_live = (rows0 > 0) + (rows1 > 0);
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * NS + s); };
  auto meta = [&](int s) {
    return reinterpret_cast<int*>(sm + L::kMeta + s * L::kMetaBytes);
  };

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(k_full(s), 1 + 32);   // the copies' arrival + 32 meta writers
      bar_init(v_full(s), 1);
      bar_init(empty(s), 128 * n_live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first thread issues every copy, its
    // first warp stages each tile's segment ids and positions
    producer_regs();
    const int lane = threadIdx.x - kConsumers;
    if (lane >= 32 || n_tiles == 0) return;
    if (lane == 0) {
      bar_expect(q_full, 4 * D * G * tq_w);   // two boxes of tq_w x G x D
#pragma unroll
      for (int w = 0; w < 2; ++w) {
#pragma unroll
        for (int c = 0; c < Gm::kChunks; ++c) {
          tma_load(base + c * kQRows * Gm::kW + 64 * w * Gm::kW, &map_q,
                   q_full, c * Gm::kCw, kvh * G, t0 + w * tq_w);
        }
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS;
      const int j0 = hits[first + it] * kTile;
      bar_wait(empty(s), ((it / NS) & 1) ^ 1);
      if (lane == 0) {
        bar_expect(k_full(s), L::kKV);
        tma_tile<D, kTile>(base + L::kK + s * L::kKV, &map_k, k_full(s), j0,
                           kvh);
        bar_expect(v_full(s), L::kKV);
        tma_tile<D, kTile>(base + L::kV + s * L::kKV, &map_v, v_full(s), j0,
                           kvh);
      }
      int* ms = meta(s);
      for (int c = lane; c < kTile; c += 32) {
        const int j = j0 + c;
        ms[c] = j < S ? kv_seg[j] : kNoKv;
        ms[kTile + c] = j < S ? kv_pos[j] : 0;
      }
      bar_arrive(k_full(s));
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 (tokens tw0 ..)
  consumer_regs();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int rows = wg ? rows1 : rows0;
  const int tw0 = t0 + wg * tq_w;
  const int r0 = 16 * warp + lane / 4;          // this thread's rows r0, r0 + 8
  int qs[2], qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    qs[h] = r < rows ? q_seg[tw0 + r / G] : kNoSeg;
    qp[h] = r < rows ? q_pos[tw0 + r / G] : 0;
  }
  const float sl2 = attn_scale(D) * kLog2e;
  const uint32_t qa = base + 64 * wg * Gm::kW;

  float o[Gm::kChunks][Gm::kCw / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  if (rows > 0 && n_tiles > 0) {
    const bool turns = n_live == 2;
    uint32_t pa[kTile / 16][4];
    // at D <= 64 the warpgroup's Q rows sit in registers (A of S = Q K^T)
    constexpr bool kRegA = D <= 64;
    uint32_t qf[kRegA ? D / 16 : 1][4];
    // S = Q K^T of tile `it` (committed, not waited for)
    auto scores = [&](float (&sc)[kTile / 2], int it) {
      const int s = it % NS;
      const uint32_t ks = base + L::kK + s * L::kKV;
      bar_wait(k_full(s), (it / NS) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (kRegA) {
          wgmma_rs<0>(sc, qf[kk], desc_k<D, kTile>(ks, kk), kk > 0);
        } else {
          wgmma_ss(sc, desc_k<D, kQRows>(qa, kk), desc_k<D, kTile>(ks, kk),
                   kk > 0);
        }
      }
      wg_commit();
    };
    // O += P V of tile `it`, P from pa (committed, not waited for)
    auto pv = [&](int it) {
      const int s = it % NS;
      const uint32_t vs = base + L::kV + s * L::kKV;
      bar_wait(v_full(s), (it / NS) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < Gm::kChunks; ++c) {
          wgmma_rs<1>(o[c], pa[kk], desc_mn<D, kTile>(vs, kk, c), 1);
        }
      }
      wg_commit();
    };

    bar_wait(q_full, 0);
    if constexpr (kRegA) load_frags<D, kQRows>(sm, 64 * wg, qf, warp, lane);
    if (turns && wg == 1) turn_pass(wg);
    {
      float sc[kTile / 2];
      if (turns) turn_wait(wg);
      scores(sc, 0);
      if (turns) turn_pass(wg);
      wg_wait<0>();
      keep(sc);
      softmax_step(sc, meta(0), qs, qp, window, lane, sl2, m, l, corr);
      to_frags(sc, pa);
    }
    // tile it's P V runs on the tensor cores beside tile it + 1's S, then
    // beside tile it + 1's softmax; P is rounded into pa only once P V is
    // done (dense_flash.cu: ptxas would otherwise serialise the products)
    for (int it = 0; it + 1 < n_tiles; ++it) {
      float sc[kTile / 2];
      if (turns) turn_wait(wg);
      scores(sc, it + 1);
      pv(it);
      if (turns) turn_pass(wg);
      wg_wait<1>();
      keep(sc);
      softmax_step(sc, meta((it + 1) % NS), qs, qp, window, lane, sl2, m, l,
                   corr);
      wg_wait<0>();
      keep(o);
      bar_arrive(empty(it % NS));
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < Gm::kCw / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];
      to_frags(sc, pa);
    }
    if (turns) turn_wait(wg);
    pv(n_tiles - 1);
    if (turns) turn_pass(wg);
    wg_wait<0>();
    keep(o);
    bar_arrive(empty((n_tiles - 1) % NS));
    if (turns && wg == 0) turn_wait(wg);
  }
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);

  if (used == 1) {
    if (rows > 0) {
      uint8_t* st = sm + L::kStage + 64 * wg * Gm::kPitch;
      stage_rows<D>(st, o, 1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f),
                    warp, lane);
      named_sync(1 + wg, 128);
      store_rows<D>(st, out, out_h, out_t, rows, tw0, kvh * G, G, t);
    }
    return;
  }

  // ---- split: this block's fp32 partials (unnormalised acc, m, l) to
  // scratch; the q tile's last block to finish combines them in split order
  const int n_qt = gridDim.x / n_splits;
  const int64_t tile_slot = ((int64_t)kvh * n_qt + qt) * n_splits;
  if (rows > 0) {
    float* pa_ = part_acc + (tile_slot + sp) * kQRows * D;
    float* pm_ = part_ml + (tile_slot + sp) * kQRows * 2;
    const int rb = 64 * wg + r0;
#pragma unroll
    for (int c = 0; c < Gm::kChunks; ++c) {
#pragma unroll
      for (int n = 0; n < Gm::kCw / 8; ++n) {
        const int col = c * Gm::kCw + acc_col(4 * n, lane);
        *reinterpret_cast<float2*>(pa_ + (int64_t)rb * D + col) =
            make_float2(o[c][4 * n], o[c][4 * n + 1]);
        *reinterpret_cast<float2*>(pa_ + (int64_t)(rb + 8) * D + col) =
            make_float2(o[c][4 * n + 2], o[c][4 * n + 3]);
      }
    }
    if ((lane & 3) == 0) {
      pm_[2 * rb] = m[0];
      pm_[2 * rb + 1] = l0;
      pm_[2 * (rb + 8)] = m[1];
      pm_[2 * (rb + 8) + 1] = l1;
    }
    __threadfence();
  }
  named_sync(3, kConsumers);
  if (threadIdx.x == 0) {
    int* ctr = counters + (int64_t)kvh * n_qt + qt;
    const int last = atomicAdd(ctr, 1) == used - 1;
    if (last) *ctr = 0;    // every split has counted: ready for the next call
    info[1] = last;
  }
  named_sync(3, kConsumers);
  if (!info[1]) return;
  __threadfence();
  const float* acc_in = part_acc + tile_slot * kQRows * D;
  const float* ml_in = part_ml + tile_slot * kQRows * 2;
  constexpr int kVec = D / 8;
  for (int e = threadIdx.x; e < kQRows * kVec; e += kConsumers) {
    const int rb = e / kVec, v = e % kVec;
    const int w = rb / 64, r = rb % 64;
    if (r >= (w ? rows1 : rows0)) continue;
    float mm = -INFINITY;
    for (int s = 0; s < used; ++s) {
      mm = fmaxf(mm, __ldcg(ml_in + ((int64_t)s * kQRows + rb) * 2));
    }
    const float mu = mm == -INFINITY ? 0.f : mm;
    float acc[8], lt = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* ml = ml_in + ((int64_t)s * kQRows + rb) * 2;
      const float wt = ex2(__ldcg(ml) - mu);
      lt = fmaf(__ldcg(ml + 1), wt, lt);
      const float4* a = reinterpret_cast<const float4*>(
          acc_in + ((int64_t)s * kQRows + rb) * D + 8 * v);
      const float4 x0 = __ldcg(a), x1 = __ldcg(a + 1);
      acc[0] = fmaf(x0.x, wt, acc[0]);
      acc[1] = fmaf(x0.y, wt, acc[1]);
      acc[2] = fmaf(x0.z, wt, acc[2]);
      acc[3] = fmaf(x0.w, wt, acc[3]);
      acc[4] = fmaf(x1.x, wt, acc[4]);
      acc[5] = fmaf(x1.y, wt, acc[5]);
      acc[6] = fmaf(x1.z, wt, acc[6]);
      acc[7] = fmaf(x1.w, wt, acc[7]);
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    uint4 pk;
    pk.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    pk.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    pk.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    pk.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    bf16* dst = out + (int64_t)(kvh * G + r % G) * out_h +
                (int64_t)(t0 + w * tq_w + r / G) * out_t + 8 * v;
    *reinterpret_cast<uint4*>(dst) = pk;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* kv_seg, const void* q_pos, const void* kv_pos,
           const void* kv_tiles, void* out, void* part_acc, void* part_ml,
           void* counters, const Strides& st, int BH, int T, int S, int G,
           int window, int n_splits, int split_tiles, cudaStream_t stream) {
  using L = VarlenSmem<D>;
  const int KVH = BH / G, tq_w = 64 / G;
  const int n_qt = cdiv(T, 2 * tq_w);
  if ((int64_t)n_qt * n_splits > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // q/out: (D, heads, tokens), a box of tq_w tokens x G heads; k/v: (D,
  // slots, kv heads), a box of kTile slots
  const cuuint64_t qd[3] = {(cuuint64_t)D, (cuuint64_t)BH, (cuuint64_t)T};
  const cuuint64_t qs[2] = {(cuuint64_t)st.qh * 2, (cuuint64_t)st.qt * 2};
  const cuuint64_t kd[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)KVH};
  const cuuint64_t ks[2] = {(cuuint64_t)st.kt * 2, (cuuint64_t)st.kh * 2};
  const cuuint64_t vs[2] = {(cuuint64_t)st.vt * 2, (cuuint64_t)st.vh * 2};
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, q, qd, qs, G, tq_w) ||
      !make_map<D>(&mk, k, kd, ks, kTile, 1) ||
      !make_map<D>(&mv, v, kd, vs, kTile, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(varlen_flash_kernel<D>, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_qt * n_splits, KVH);
  varlen_flash_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const int4*>(kv_tiles),
      static_cast<bf16*>(out), st.oh, st.ot, static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counters), T, S, G,
      window, n_splits, split_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, T, D) bf16; k/v: (BH/G, S, D) bf16; q_seg/q_pos: (T,) int32;
// kv_seg/kv_pos: (S,) int32; kv_tiles: (ceil(S / 128), 4) int32, per
// 128-slot tile the (min, max) segment id and (min, max) position of its
// slots with segment id >= 0 ((2^30, -2^30, 2^30, -2^30) when it has none);
// out: (BH, T, D) bf16. strides[8]: element strides of the (head, token)
// axes of q, k, v, out (head dim contiguous, every other stride a multiple
// of 8 elements, pointers 16-byte aligned). With n_splits > 1, part_acc
// (KVH x n_q_tiles x n_splits x 128 x D fp32) and part_ml (the same x 2)
// are scratch, and counters (KVH x n_q_tiles int32) must be zero; the
// kernel leaves them zero. Device pointers on the device of `stream`.
// Returns a cudaError_t code (0 on a successful launch); the launch does not
// synchronise.
extern "C" int varlen_flash_bf16(const void* q, const void* k, const void* v,
                                 const void* q_seg, const void* kv_seg,
                                 const void* q_pos, const void* kv_pos,
                                 const void* kv_tiles, void* out,
                                 void* part_acc, void* part_ml,
                                 void* counters, const int64_t* strides,
                                 int BH, int T, int S, int D, int G,
                                 int window, int n_splits, int split_tiles,
                                 void* stream) {
  if (BH < 1 || T < 1 || S < 1 || G < 1 || G > 64 || BH % G != 0 ||
      BH / G > 65535 || n_splits < 1 || split_tiles < 1 ||
      cdiv(S, kTile) > kMaxTiles ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr ||
                        counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, kv_tiles, out,
                        part_acc, part_ml, counters, st, BH, T, S, G, window,
                        n_splits, split_tiles, cs);
    case 32:
      return launch<32>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, kv_tiles, out,
                        part_acc, part_ml, counters, st, BH, T, S, G, window,
                        n_splits, split_tiles, cs);
    case 64:
      return launch<64>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, kv_tiles, out,
                        part_acc, part_ml, counters, st, BH, T, S, G, window,
                        n_splits, split_tiles, cs);
    case 128:
      return launch<128>(q, k, v, q_seg, kv_seg, q_pos, kv_pos, kv_tiles,
                         out, part_acc, part_ml, counters, st, BH, T, S, G,
                         window, n_splits, split_tiles, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* varlen_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
