// Dense flash attention for Hopper (sm_90a): forward and backward on the
// tensor cores (wgmma), fed by TMA copies through a ring of shared-memory
// stages.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_tpu (Pallas body _kernel). Query row i sits at position i
// and kv column j at position j; row i sees column j iff
//   (!causal || j <= i) && (window == 0 || j > i - window).
// Masked scores are -1e30 with no zero-row guard, as in the TPU kernel and
// flash_attention_ref: a row that sees nothing (possible only when T > S
// and window > 0) gets mean(V) over all S columns. Columns past S weigh 0.
//
// One change of contract, as in the varlen kernel: k/v carry BH/G heads and
// q head h reads kv head h / G, so K/V are never repeated per q head. Any
// T and S are accepted: TMA fills rows past the end with zeros and the
// kernels mask the ragged tile edges themselves.
//
// Entry points:
//  * forward: out (BH, T, D) bf16 and lse (BH, T) fp32 = m + log(l);
//  * backward: a pre-pass delta = rowsum(dO * O) (BH, T) fp32 (CUDA cores,
//    memory-bound, coalesced 16-byte loads), then
//      dK/dV: one block per (kv head, 128 kv rows); it loops over the G q
//        heads of that kv head and over the 64-row q tiles that can see the
//        tile, so the GQA sum is taken inside the block: no atomics, and
//        gradients repeat bit for bit;
//      dQ: one block per (q head, 128 q rows), looping over 64-row kv tiles.
//
// Arithmetic. q, k, v, dO stay the bf16 inputs; every product is bf16 x
// bf16 into fp32 (wgmma). The 1/sqrt(D) scale and log2(e) are applied to
// the fp32 scores after the product (the scale is not a power of two at D
// 32 and 128, so q is never pre-scaled in bf16) and the softmax runs in
// base 2 (ex2.approx). P (forward and backward) and dS are rounded to bf16
// before their products; the row sum l adds the unrounded fp32 P. out =
// acc / max(l, 1e-30) and the gradients are rounded to bf16 once, at the
// end.
//
// Design. Each block has two consumer warpgroups (threads 0-255) that own
// 64 rows each and one producer warpgroup (256-383); setmaxnreg moves the
// producer's registers to the consumers (40 and 232 a thread). One
// producer thread issues cp.async.bulk.tensor (TMA) copies of whole tiles
// from tensor maps built on the host with cuTensorMapEncodeTiled (reached
// through cudaGetDriverEntryPointByVersion, so nothing links against
// libcuda) and passed as __grid_constant__. Tiles land in shared memory as
// bf16 in the swizzled layout the wgmma descriptors read: a tile of R rows
// x D is stored as D / CW column chunks of R rows x CW values, CW = min(D,
// 64), swizzled over 128 bytes at D 64 and 128, 64 bytes at D 32 and 32
// bytes at D 16. The streamed tiles go through a ring of stages (4 at D <=
// 64; 2 for the forward and 3 for the backward at D 128, as shared memory
// allows) guarded by mbarriers: "full" completes when the copies' bytes
// have landed (TMA complete_tx), "empty" when all 256 consumer threads are
// done with the stage. Score tiles S = Q K^T (and dP = dO V^T) are wgmma
// products with K-major operands; at D <= 64 the operand a block keeps for
// its whole life (Q, dO, or K, V) sits in registers, elsewhere in shared
// memory. The softmax or the gradient terms run in registers on the fp32
// accumulator, and the rounded bf16 tile is the *register* A operand of
// the next product, whose B operand (V, dO, Q or K) is read through an
// MN-major (transposed) descriptor. Within a warpgroup the products of
// tile i + 1's scores are issued before tile i's second product, so the
// tensor cores work on both while the threads run tile i + 1's softmax
// (wgmma.wait_group 1); the bf16 rounding waits for the second product to
// finish, since ptxas would otherwise hand the new fragments the registers
// that product still reads and serialise the two. In the forward and dQ
// the two warpgroups also take turns to issue their products (ping-pong on
// named barriers), so one's softmax runs beside the other's products.
// Only tiles that cross
// the causal diagonal, the window edge or the ragged T / S edge are masked,
// with selects: a branch per score would serialise the exponentials.
// Tiles no row can see are not loaded. Causal q tiles of the forward and
// of dQ launch heaviest first (the grid's slow axis runs them in
// descending order). Outputs go through shared memory and leave as
// coalesced 16-byte stores.
//
// What bounds it on the H100. At the training shape (granite-3-2b:
// B=2, H=32, KVL=8, D=64, T=S=2048, causal) the forward does 4*D FLOPs per
// visible (q head, slot) pair, 34.4 GFLOP against 50 MB of bf16 in and out:
// ~690 FLOP/byte, far above the card's ~295 balance point, so the bound is
// the operations at the 989 TFLOP/s bf16 tensor-core peak (~0.035 ms); the
// backward's bound counts 10*D per pair (~0.087 ms). Two limits sit below
// that peak. At D 64 a score costs as much on the special-function unit
// (one exponential, 16 a clock per SM) and the FP32 pipes as its D-deep
// products cost on the tensor cores, so the forward cannot pass about
// half the peak without hiding one behind the other. And the backward as
// designed does 14*D per pair: dQ recomputes S and dP (7 products against
// the 5 the bound counts), the price of deterministic gradients without
// atomics, so the best it can reach is ~1.4x its bound. Left on the table:
// a persistent grid that balances the causal triangle over the 132 SMs,
// the delta pre-pass as a separate launch, and the spill of the D 128
// dK/dV instance (its two 64 x 128 accumulators), which also keeps the
// ping-pong turns out of dK/dV.
//
// The Hopper building blocks (mbarriers, TMA, wgmma descriptors and
// products, setmaxnreg, register tiles, the tensor-map encoder) are in
// kernels/csrc/hopper.cuh, shared with varlen_flash.cu and the Mamba2 scan.

#include "../../csrc/hopper.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = -1e30f * kLog2e;   // a masked score, log2 units

// Bitwise, not short-circuit: the unrolled tile loops stay free of
// branches, so the exponentials of a tile can overlap.
__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window) {
  return (j < S) & (!causal | (j <= i)) & ((window <= 0) | (j > i - window));
}

// The first `rows` staged rows to dst (rows of D values), 16 bytes a
// thread per step, by the warpgroup's 128 threads.
template <int D>
__device__ __forceinline__ void copy_out(const uint8_t* st, bf16* dst,
                                         int rows, int t) {
  constexpr int kVec = D / 8;
  for (int e = t; e < 64 * kVec; e += 128) {
    const int r = e / kVec, v = e % kVec;
    if (r < rows) {
      *reinterpret_cast<uint4*>(dst + (int64_t)r * D + 8 * v) =
          *reinterpret_cast<const uint4*>(st + r * Geo<D>::kPitch + 16 * v);
    }
  }
}

// One kv tile's step of the online softmax over a warpgroup's 64 x BN
// scores (fp32 products of the unscaled inputs; this thread's rows i0 and
// i0 + 8): scale into log2 units, mask the tile if it crosses the
// diagonal, the window edge or S, update the row maxima m and this
// thread's partial row sums l, and leave P in sc. corr gets the factors
// that rescale the rows' earlier output.
template <int NR>
__device__ __forceinline__ void softmax_step(float (&sc)[NR], int j0, int rb,
                                             int i0, int lane, int S,
                                             int causal, int window,
                                             float sl2, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  constexpr int BN = 2 * NR;
  const bool need = j0 + BN > S || (causal && j0 + BN - 1 > rb) ||
                    (window > 0 && j0 <= rb + 63 - window);
  if (need) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int j = j0 + acc_col(i, lane);
      const int row = i0 + ((i & 2) ? 8 : 0);
      // columns past S do not exist (weight 0); masked ones score -1e30
      const float x = visible(row, j, S, causal, window) ? sc[i] * sl2
                                                         : kMasked2;
      sc[i] = j < S ? x : -INFINITY;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NR; ++i) sc[i] *= sl2;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
    ps[(i >> 1) & 1] += sc[i];
  }
  // per-thread partial sums, reduced over the row's 4 threads at the end
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
}

// ------------------------------------------------------------------ forward
// Shared memory: Q (128 x D), kStages x (K, V) (128 x D each), output
// staging (128 rows), barriers.
template <int D>
struct FwdSmem {
  static constexpr int kRows = 128;   // q rows per block
  static constexpr int kCols = 128;   // kv rows per tile
  static constexpr int kStages = D >= 128 ? 2 : 4;
  static constexpr uint32_t kQ = kRows * D * 2;
  static constexpr uint32_t kKV = kCols * D * 2;
  static constexpr uint32_t kK = kQ;
  static constexpr uint32_t kV = kK + kStages * kKV;
  static constexpr uint32_t kStage = kV + kStages * kKV;
  static constexpr uint32_t kBars = kStage + kRows * Geo<D>::kPitch;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dense_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 bf16* __restrict__ out, float* __restrict__ lse, int T,
                 int S, int G, int causal, int window) {
  using Gm = Geo<D>;
  using L = FwdSmem<D>;
  constexpr int BM = L::kRows, BN = L::kCols, NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * NS + s); };

  const int h = blockIdx.x, kvh = h / G;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const int q_last = min(q0 + BM, T) - 1;
  int lo = 0, hi = causal ? min(S, q_last + 1) : S;
  if (window > 0) {
    if (q_last >= S + window - 1) {
      hi = S;   // a row that sees nothing: its mean(V) needs every column
    } else {
      lo = max(0, q0 - window + 1);
    }
  }
  const int j_begin = (lo / BN) * BN;
  const int n_tiles = hi > j_begin ? (hi - j_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every copy
    producer_regs();
    if (threadIdx.x == kConsumers) {
      bar_expect(q_full, L::kQ);
      tma_tile<D, BM>(base, &map_q, q_full, q0, h);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int j0 = j_begin + it * BN;
        bar_wait(empty(s), ((it / NS) & 1) ^ 1);
        bar_expect(k_full(s), L::kKV);
        tma_tile<D, BN>(base + L::kK + s * L::kKV, &map_k, k_full(s), j0, kvh);
        bar_expect(v_full(s), L::kKV);
        tma_tile<D, BN>(base + L::kV + s * L::kKV, &map_v, v_full(s), j0, kvh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64wg .. + 63
  consumer_regs();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int rb = q0 + 64 * wg;                 // the warpgroup's first row
  const int i0 = rb + 16 * warp + lane / 4;    // this thread's rows i0, i1
  const int i1 = i0 + 8;
  const float sl2 = attn_scale(D) * kLog2e;
  const uint32_t qa = base + 64 * wg * Gm::kW;

  float o[Gm::kChunks][Gm::kCw / 2];
  zero(o);
  float m[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[BN / 16][4];
  // at D <= 64 the warpgroup's Q rows sit in registers (A of S = Q K^T),
  // which halves what the products read from shared memory
  constexpr bool kRegA = D <= 64;
  uint32_t qf[kRegA ? D / 16 : 1][4];
  // S = Q K^T of tile `it` (committed, not waited for)
  auto scores = [&](float (&sc)[BN / 2], int it) {
    const int s = it % NS;
    const uint32_t ks = base + L::kK + s * L::kKV;
    bar_wait(k_full(s), (it / NS) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kRegA) {
        wgmma_rs<0>(sc, qf[kk], desc_k<D, BN>(ks, kk), kk > 0);
      } else {
        wgmma_ss(sc, desc_k<D, BM>(qa, kk), desc_k<D, BN>(ks, kk), kk > 0);
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
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c) {
        wgmma_rs<1>(o[c], pa[kk], desc_mn<D, BN>(vs, kk, c), 1);
      }
    }
    wg_commit();
  };

  bar_wait(q_full, 0);
  if constexpr (kRegA) load_frags<D, BM>(sm, 64 * wg, qf, warp, lane);
  if (wg == 1) turn_pass(wg);
  if (n_tiles > 0) {
    {
      float sc[BN / 2];
      turn_wait(wg);
      scores(sc, 0);
      turn_pass(wg);
      wg_wait<0>();
      keep(sc);
      softmax_step(sc, j_begin, rb, i0, lane, S, causal, window, sl2, m, l,
                   corr);
      to_frags(sc, pa);
    }
    // tile it's P V runs on the tensor cores beside tile it + 1's S, then
    // beside tile it + 1's softmax. P is rounded into pa only once P V is
    // done: ptxas would otherwise give the new fragments the registers the
    // product still reads, and serialise the products.
    for (int it = 0; it + 1 < n_tiles; ++it) {
      float sc[BN / 2];
      turn_wait(wg);
      scores(sc, it + 1);
      pv(it);
      turn_pass(wg);
      wg_wait<1>();
      keep(sc);
      softmax_step(sc, j_begin + (it + 1) * BN, rb, i0, lane, S, causal,
                   window, sl2, m, l, corr);
      wg_wait<0>();
      keep(o);
      bar_arrive(empty(it % NS));
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < Gm::kCw / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];
      to_frags(sc, pa);
    }
    turn_wait(wg);
    pv(n_tiles - 1);
    turn_pass(wg);
    wg_wait<0>();
    keep(o);
    bar_arrive(empty((n_tiles - 1) % NS));
  }
  if (wg == 0) turn_wait(wg);

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  uint8_t* st = sm + L::kStage + 64 * wg * Gm::kPitch;
  stage_rows<D>(st, o, 1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f),
                warp, lane);
  named_sync(1 + wg, 128);
  copy_out<D>(st, out + ((int64_t)h * T + rb) * D, min(64, T - rb), t);
  if ((lane & 3) == 0) {
    if (i0 < T) lse[(int64_t)h * T + i0] = (m[0] + log2f(l0)) * kLn2;
    if (i1 < T) lse[(int64_t)h * T + i1] = (m[1] + log2f(l1)) * kLn2;
  }
}

// ------------------------------------------------------ backward pre-pass
// delta = rowsum(dO * O): D / 8 neighbouring threads per row, 16 bytes each
// (coalesced), summed over those lanes in a fixed order.
template <int D>
__global__ void __launch_bounds__(128)
dense_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, int64_t rows) {
  constexpr int kLanes = D / 8;
  const int64_t e = (int64_t)blockIdx.x * 128 + threadIdx.x;
  const int64_t r = e / kLanes;
  float acc = 0.f;
  if (r < rows) {
    const uint4 ro = reinterpret_cast<const uint4*>(o)[e];
    const uint4 rg = reinterpret_cast<const uint4*>(dout)[e];
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
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (r < rows && e % kLanes == 0) delta[r] = acc;
}

// ------------------------------------------------------------ backward dQ
// Shared memory: Q and dO (128 x D each), kStages x (K, V) (64 x D each),
// staging (128 rows), barriers.
template <int D>
struct DqSmem {
  static constexpr int kRows = 128;   // q rows per block
  static constexpr int kCols = 64;    // kv rows per tile
  static constexpr int kStages = D >= 128 ? 3 : 4;
  static constexpr uint32_t kQ = kRows * D * 2;
  static constexpr uint32_t kKV = kCols * D * 2;
  static constexpr uint32_t kDo = kQ;
  static constexpr uint32_t kK = 2 * kQ;
  static constexpr uint32_t kV = kK + kStages * kKV;
  static constexpr uint32_t kStage = kV + kStages * kKV;
  static constexpr uint32_t kBars = kStage + kRows * Geo<D>::kPitch;
  // in_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dense_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int T, int S, int G, int causal, int window) {
  using Gm = Geo<D>;
  using L = DqSmem<D>;
  constexpr int BM = L::kRows, BN = L::kCols, NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t in_full = base + L::kBars;
  auto k_full = [&](int s) { return in_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return in_full + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return in_full + 8 * (1 + 2 * NS + s); };

  const int h = blockIdx.x, kvh = h / G;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  // a row that sees nothing has dQ = 0: only the visible range is scanned
  const int q_last = min(q0 + BM, T) - 1;
  const int hi = causal ? min(S, q_last + 1) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j_begin = (lo / BN) * BN;
  const int n_tiles = hi > j_begin ? (hi - j_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    bar_init(in_full, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers) {
      bar_expect(in_full, 2 * L::kQ);
      tma_tile<D, BM>(base, &map_q, in_full, q0, h);
      tma_tile<D, BM>(base + L::kDo, &map_do, in_full, q0, h);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int j0 = j_begin + it * BN;
        bar_wait(empty(s), ((it / NS) & 1) ^ 1);
        bar_expect(k_full(s), L::kKV);
        tma_tile<D, BN>(base + L::kK + s * L::kKV, &map_k, k_full(s), j0, kvh);
        bar_expect(v_full(s), L::kKV);
        tma_tile<D, BN>(base + L::kV + s * L::kKV, &map_v, v_full(s), j0, kvh);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int rb = q0 + 64 * wg;
  const int i0 = rb + 16 * warp + lane / 4, i1 = i0 + 8;
  const float scale = attn_scale(D), sl2 = scale * kLog2e;
  const float lse2[2] = {i0 < T ? lse[(int64_t)h * T + i0] * kLog2e : 0.f,
                         i1 < T ? lse[(int64_t)h * T + i1] * kLog2e : 0.f};
  const float dl[2] = {i0 < T ? delta[(int64_t)h * T + i0] : 0.f,
                       i1 < T ? delta[(int64_t)h * T + i1] : 0.f};
  const uint32_t qa = base + 64 * wg * Gm::kW;
  const uint32_t oa = base + L::kDo + 64 * wg * Gm::kW;

  float acc[Gm::kChunks][Gm::kCw / 2];
  zero(acc);
  uint32_t da[BN / 16][4];
  // at D <= 64 the warpgroup's Q and dO rows sit in registers (the A
  // operands of S and dP)
  constexpr bool kRegA = D <= 64;
  uint32_t qf[kRegA ? D / 16 : 1][4], of[kRegA ? D / 16 : 1][4];
  // S = Q K^T and dP = dO V^T of tile `it` (committed, not waited for)
  auto products = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int it) {
    const int s = it % NS;
    const uint32_t ks = base + L::kK + s * L::kKV;
    const uint32_t vs = base + L::kV + s * L::kKV;
    bar_wait(k_full(s), (it / NS) & 1);
    bar_wait(v_full(s), (it / NS) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kRegA) {
        wgmma_rs<0>(sc, qf[kk], desc_k<D, BN>(ks, kk), kk > 0);
      } else {
        wgmma_ss(sc, desc_k<D, BM>(qa, kk), desc_k<D, BN>(ks, kk), kk > 0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kRegA) {
        wgmma_rs<0>(dp, of[kk], desc_k<D, BN>(vs, kk), kk > 0);
      } else {
        wgmma_ss(dp, desc_k<D, BM>(oa, kk), desc_k<D, BN>(vs, kk), kk > 0);
      }
    }
    wg_commit();
  };
  // dS = P (dP - delta) of tile `it` into sc, P = 2^(S scale log2e -
  // lse log2e)
  auto grad_s = [&](float (&sc)[BN / 2], const float (&dp)[BN / 2], int it) {
    const int j0 = j_begin + it * BN;
    const bool need = j0 + BN > S || rb + 64 > T ||
                      (causal && j0 + BN - 1 > rb) ||
                      (window > 0 && j0 <= rb + 63 - window);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(sc[i] * sl2 - lse2[r]) * (dp[i] - dl[r]);
    }
    if (need) {   // masked entries (whose exponential may be inf) give 0
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int row = i0 + ((i & 2) ? 8 : 0);
        const bool vis = (row < T) &
                         visible(row, j0 + acc_col(i, lane), S, causal, window);
        sc[i] = vis ? sc[i] : 0.f;
      }
    }
  };
  // dQ += dS K of tile `it`, dS from da (committed, not waited for)
  auto dq_step = [&](int it) {
    const uint32_t ks = base + L::kK + (it % NS) * L::kKV;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c) {
        wgmma_rs<1>(acc[c], da[kk], desc_mn<D, BN>(ks, kk, c), 1);
      }
    }
    wg_commit();
  };

  bar_wait(in_full, 0);
  if constexpr (kRegA) {
    load_frags<D, BM>(sm, 64 * wg, qf, warp, lane);
    load_frags<D, BM>(sm + L::kDo, 64 * wg, of, warp, lane);
  }
  if (wg == 1) turn_pass(wg);
  if (n_tiles > 0) {
    {
      float sc[BN / 2], dp[BN / 2];
      turn_wait(wg);
      products(sc, dp, 0);
      turn_pass(wg);
      wg_wait<0>();
      keep(sc);
      keep(dp);
      grad_s(sc, dp, 0);
      to_frags(sc, da);
    }
    // tile it's dS K runs beside tile it + 1's S and dP, then beside its
    // dS; dS is rounded into da once dS K is done (see the forward)
    for (int it = 0; it + 1 < n_tiles; ++it) {
      float sc[BN / 2], dp[BN / 2];
      turn_wait(wg);
      products(sc, dp, it + 1);
      dq_step(it);
      turn_pass(wg);
      wg_wait<1>();
      keep(sc);
      keep(dp);
      grad_s(sc, dp, it + 1);
      wg_wait<0>();
      keep(acc);
      bar_arrive(empty(it % NS));
      to_frags(sc, da);
    }
    turn_wait(wg);
    dq_step(n_tiles - 1);
    turn_pass(wg);
    wg_wait<0>();
    keep(acc);
    bar_arrive(empty((n_tiles - 1) % NS));
  }
  if (wg == 0) turn_wait(wg);

  uint8_t* st = sm + L::kStage + 64 * wg * Gm::kPitch;
  stage_rows<D>(st, acc, scale, scale, warp, lane);
  named_sync(1 + wg, 128);
  copy_out<D>(st, dq + ((int64_t)h * T + rb) * D, min(64, T - rb), t);
}

// --------------------------------------------------------- backward dK/dV
// Shared memory: K and V (128 x D each), kStages x (Q, dO (64 x D each),
// lse * log2(e) and delta (64 floats each)), staging (128 rows), the tail
// row (D floats), barriers.
template <int D>
struct DkvSmem {
  static constexpr int kRows = 128;   // kv rows per block
  static constexpr int kCols = 64;    // q rows per tile
  static constexpr int kStages = D >= 128 ? 3 : 4;
  static constexpr uint32_t kKV = kRows * D * 2;
  static constexpr uint32_t kQ = kCols * D * 2;
  // a stage stays a multiple of 1024 bytes (the swizzle's period)
  static constexpr uint32_t kStageBytes =
      (2 * kQ + 2 * 64 * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t kV = kKV;
  static constexpr uint32_t kRing = 2 * kKV;   // Q, dO, lse, delta
  static constexpr uint32_t kStage = kRing + kStages * kStageBytes;
  static constexpr uint32_t kTail = kStage + kRows * Geo<D>::kPitch;
  static constexpr uint32_t kBars = kTail + 4 * D;
  // kv_full, full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dense_dkv_kernel(const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const bf16* __restrict__ dout, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int T, int S, int G, int causal,
                 int window) {
  using Gm = Geo<D>;
  using L = DkvSmem<D>;
  constexpr int BK = L::kRows, BQ = L::kCols, NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t kv_full = base + L::kBars;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + NS + s); };
  auto ring = [&](int s) { return L::kRing + s * L::kStageBytes; };

  const int kvh = blockIdx.x;
  const int j0 = blockIdx.y * BK;
  // q rows that can see a column of this tile
  const int j_last = min(j0 + BK, S) - 1;
  const int i_lo = causal ? j0 : 0;
  const int i_hi = window > 0 ? min(T, j_last + window) : T;
  const int i_begin = (i_lo / BQ) * BQ;
  const int n_qt = i_hi > i_begin ? (i_hi - i_begin + BQ - 1) / BQ : 0;
  const int n_iter = G * n_qt;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(full(s), 1 + 32);   // the copies' arrival + 32 lse writers
      bar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first thread issues the copies, its
    // first warp stages the tile's lse and delta
    producer_regs();
    const int lane = threadIdx.x - kConsumers;
    if (lane >= 32) return;
    if (lane == 0) {
      bar_expect(kv_full, 2 * L::kKV);
      tma_tile<D, BK>(base, &map_k, kv_full, j0, kvh);
      tma_tile<D, BK>(base + L::kV, &map_v, kv_full, j0, kvh);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % NS;
      const int hq = kvh * G + it / n_qt;
      const int i0 = i_begin + (it % n_qt) * BQ;
      bar_wait(empty(s), ((it / NS) & 1) ^ 1);
      if (lane == 0) {
        bar_expect(full(s), 2 * L::kQ);
        tma_tile<D, BQ>(base + ring(s), &map_q, full(s), i0, hq);
        tma_tile<D, BQ>(base + ring(s) + L::kQ, &map_do, full(s), i0, hq);
      }
      float* ls = reinterpret_cast<float*>(sm + ring(s) + 2 * L::kQ);
      for (int r = lane; r < BQ; r += 32) {
        const int i = i0 + r;
        ls[r] = i < T ? lse[(int64_t)hq * T + i] * kLog2e : 0.f;
        ls[BQ + r] = i < T ? delta[(int64_t)hq * T + i] : 0.f;
      }
      bar_arrive(full(s));
    }
    return;
  }

  // ---- consumers: warpgroup wg owns kv rows kb .. kb + 63
  consumer_regs();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int kb = j0 + 64 * wg;
  const int jr0 = kb + 16 * warp + lane / 4;   // this thread's rows jr0, +8
  const float scale = attn_scale(D), sl2 = scale * kLog2e;
  const uint32_t ka = base + 64 * wg * Gm::kW;
  const uint32_t va = base + L::kV + 64 * wg * Gm::kW;

  float gk[Gm::kChunks][Gm::kCw / 2], gv[Gm::kChunks][Gm::kCw / 2];
  zero(gk);
  zero(gv);
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  // at D <= 64 the warpgroup's K and V rows sit in registers (the A
  // operands of S^T and dP^T)
  constexpr bool kRegA = D <= 64;
  uint32_t kf[kRegA ? D / 16 : 1][4], vf[kRegA ? D / 16 : 1][4];
  // S^T = K Q^T and dP^T = V dO^T of q tile `it` (committed, not waited for)
  auto products = [&](float (&st)[BQ / 2], float (&dpt)[BQ / 2], int it) {
    const int s = it % NS;
    const uint32_t qs = base + ring(s), os = qs + L::kQ;
    bar_wait(full(s), (it / NS) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kRegA) {
        wgmma_rs<0>(st, kf[kk], desc_k<D, BQ>(qs, kk), kk > 0);
      } else {
        wgmma_ss(st, desc_k<D, BK>(ka, kk), desc_k<D, BQ>(qs, kk), kk > 0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kRegA) {
        wgmma_rs<0>(dpt, vf[kk], desc_k<D, BQ>(os, kk), kk > 0);
      } else {
        wgmma_ss(dpt, desc_k<D, BK>(va, kk), desc_k<D, BQ>(os, kk), kk > 0);
      }
    }
    wg_commit();
  };
  // P^T = 2^(S^T scale log2e - lse log2e) into st and dS^T = P^T (dP^T -
  // delta) into dpt, of q tile `it`
  auto grad_terms = [&](float (&st)[BQ / 2], float (&dpt)[BQ / 2], int it) {
    const int i0 = i_begin + (it % n_qt) * BQ;
    const float* ls =
        reinterpret_cast<const float*>(sm + ring(it % NS) + 2 * L::kQ);
    // tiles that cross the diagonal, the window edge, S or T are masked
    const bool need = kb + 64 > S || i0 + BQ > T ||
                      (causal && i0 < kb + 63) ||
                      (window > 0 && i0 + BQ - 1 >= kb + window);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = acc_col(i, lane);
      st[i] = ex2(st[i] * sl2 - ls[c]);
      dpt[i] = st[i] * (dpt[i] - ls[BQ + c]);
    }
    if (need) {   // masked entries (whose exponential may be inf) give 0
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int iq = i0 + acc_col(i, lane);
        const int jr = jr0 + ((i & 2) ? 8 : 0);
        const bool vis = (iq < T) & visible(iq, jr, S, causal, window);
        st[i] = vis ? st[i] : 0.f;
        dpt[i] = vis ? dpt[i] : 0.f;
      }
    }
  };
  // dV += P^T dO and dK += dS^T Q of q tile `it` (committed, not waited for)
  auto kv_step = [&](int it) {
    const uint32_t qs = base + ring(it % NS), os = qs + L::kQ;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c) {
        wgmma_rs<1>(gv[c], pa[kk], desc_mn<D, BQ>(os, kk, c), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c) {
        wgmma_rs<1>(gk[c], da[kk], desc_mn<D, BQ>(qs, kk, c), 1);
      }
    }
    wg_commit();
  };

  bar_wait(kv_full, 0);
  if constexpr (kRegA) {
    load_frags<D, BK>(sm, 64 * wg, kf, warp, lane);
    load_frags<D, BK>(sm + L::kV, 64 * wg, vf, warp, lane);
  }
  if (n_iter > 0) {
    {
      float st[BQ / 2], dpt[BQ / 2];
      products(st, dpt, 0);
      wg_wait<0>();
      keep(st);
      keep(dpt);
      grad_terms(st, dpt, 0);
      to_frags(st, pa);
      to_frags(dpt, da);
    }
    // q tile it's dV and dK products run beside tile it + 1's S^T and
    // dP^T, then beside its gradient terms, which are rounded into pa and
    // da once those products are done (see the forward)
    for (int it = 0; it + 1 < n_iter; ++it) {
      float st[BQ / 2], dpt[BQ / 2];
      products(st, dpt, it + 1);
      kv_step(it);
      wg_wait<1>();
      keep(st);
      keep(dpt);
      grad_terms(st, dpt, it + 1);
      wg_wait<0>();
      keep(gv);
      keep(gk);
      bar_arrive(empty(it % NS));
      to_frags(st, pa);
      to_frags(dpt, da);
    }
    kv_step(n_iter - 1);
    wg_wait<0>();
    keep(gv);
    keep(gk);
    bar_arrive(empty((n_iter - 1) % NS));
  }

  // rows that see nothing (i >= S + window - 1) weigh every column 1/S:
  // their dO sum, over the G q heads, adds to every dV row
  if (window > 0 && S + window - 1 < T) {
    float* tail = reinterpret_cast<float*>(sm + L::kTail);
    for (int d = threadIdx.x; d < D; d += kConsumers) {
      float e = 0.f;
      for (int g = 0; g < G; ++g) {
        const bf16* og = dout + ((int64_t)kvh * G + g) * T * D;
        for (int i = S + window - 1; i < T; ++i) {
          e += __bfloat162float(og[(int64_t)i * D + d]);
        }
      }
      tail[d] = e;
    }
    named_sync(3, kConsumers);
    const float inv_s = 1.f / (float)S;
#pragma unroll
    for (int c = 0; c < Gm::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < Gm::kCw / 2; ++i)
        gv[c][i] = fmaf(tail[c * Gm::kCw + acc_col(i, lane)], inv_s,
                        gv[c][i]);
  }

  uint8_t* stg = sm + L::kStage + 64 * wg * Gm::kPitch;
  const int rows = min(64, S - kb);
  stage_rows<D>(stg, gk, scale, scale, warp, lane);
  named_sync(1 + wg, 128);
  copy_out<D>(stg, dk + ((int64_t)kvh * S + kb) * D, rows, t);
  named_sync(1 + wg, 128);
  stage_rows<D>(stg, gv, 1.f, 1.f, warp, lane);
  named_sync(1 + wg, 128);
  copy_out<D>(stg, dv + ((int64_t)kvh * S + kb) * D, rows, t);
}

// ---------------------------------------------------------------- launches

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int T, int S, int G, int causal,
               int window, cudaStream_t stream) {
  using L = FwdSmem<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, q, T, BH, L::kRows) ||
      !make_map<D>(&mk, k, S, BH / G, L::kCols) ||
      !make_map<D>(&mv, v, S, BH / G, L::kCols)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(dense_fwd_kernel<D>, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, cdiv(T, L::kRows));
  dense_fwd_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), T, S,
      G, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int BH, int T, int S, int G, int causal,
               int window, cudaStream_t stream) {
  using Lq = DqSmem<D>;
  using Lk = DkvSmem<D>;
  const int KVH = BH / G;
  CUtensorMap dq_q, dq_do, dq_k, dq_v, kv_k, kv_v, kv_q, kv_do;
  if (!make_map<D>(&dq_q, q, T, BH, Lq::kRows) ||
      !make_map<D>(&dq_do, dout, T, BH, Lq::kRows) ||
      !make_map<D>(&dq_k, k, S, KVH, Lq::kCols) ||
      !make_map<D>(&dq_v, v, S, KVH, Lq::kCols) ||
      !make_map<D>(&kv_k, k, S, KVH, Lk::kRows) ||
      !make_map<D>(&kv_v, v, S, KVH, Lk::kRows) ||
      !make_map<D>(&kv_q, q, T, BH, Lk::kCols) ||
      !make_map<D>(&kv_do, dout, T, BH, Lk::kCols)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = (int64_t)BH * T;
  dense_delta_kernel<D><<<(unsigned)((rows * (D / 8) + 127) / 128), 128, 0,
                          stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = prepare(dense_dkv_kernel<D>, Lk::kBytes);
  if (err != cudaSuccess) return (int)err;
  dense_dkv_kernel<D><<<dim3(KVH, cdiv(S, Lk::kRows)), kThreads, Lk::kBytes,
                        stream>>>(
      kv_k, kv_v, kv_q, kv_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, S, G, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = prepare(dense_dq_kernel<D>, Lq::kBytes);
  if (err != cudaSuccess) return (int)err;
  dense_dq_kernel<D><<<dim3(BH, cdiv(T, Lq::kRows)), kThreads, Lq::kBytes,
                       stream>>>(
      dq_q, dq_do, dq_k, dq_v, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), T, S, G,
      causal, window);
  return (int)cudaGetLastError();
}

bool bad_args(int BH, int T, int S, int G, int window) {
  return BH < 1 || T < 1 || S < 1 || G < 1 || BH % G != 0 || BH > 65535 ||
         window < 0 || cdiv(T, 128) > 65535 || cdiv(S, 128) > 65535;
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
