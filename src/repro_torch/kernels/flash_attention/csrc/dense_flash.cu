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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
// setmaxnreg moves registers from the producer warpgroup to the consumers:
// 128 x 40 + 256 x 232 = 384 x 168, the registers the launch gives a block
// of 384 threads (ptxas caps it at 168 a thread).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = -1e30f * kLog2e;   // a masked score, log2 units
// A barrier wait that has not completed after this many cycles (~17 s)
// traps: a fault is reported instead of a hung card.
constexpr long long kHangCycles = 1LL << 35;

// Layout of a head dim's tiles in shared memory.
template <int D>
struct Geo {
  static constexpr int kCw = D >= 64 ? 64 : D;   // values per chunk row
  static constexpr int kChunks = D / kCw;
  static constexpr int kW = 2 * kCw;             // bytes per chunk row
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint32_t kLayout = kW == 128 ? 1 : kW == 64 ? 2 : 3;
  static constexpr int kPitch = 2 * D + 16;      // staging row bytes
};

// Bitwise, not short-circuit: the unrolled tile loops stay free of
// branches, so the exponentials of a tile can overlap.
__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window) {
  return (j < S) & (!causal | (j <= i)) & ((window <= 0) | (j > i - window));
}

__device__ __forceinline__ float attn_scale(int D) {
  return (float)(1.0 / sqrt((double)D));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to 1024 bytes (the 128-byte
// swizzle's period); every launch asks for 1024 bytes of slack.
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return raw + pad;
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kHangCycles) {
      __trap();
    }
  }
}

// Named barrier over `count` threads (ids 1-5; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Ping-pong between the two consumer warpgroups (forward and dQ): each
// issues its products only in its turn (barrier 4 + wg) and then hands the
// turn over, so one warpgroup's softmax runs beside the other's products.
// Warpgroup 1 gives warpgroup 0 the first turn; warpgroup 0 takes the one
// turn left over at the end. (dK/dV goes without: its D 128 instance,
// which spills, ran slower with the turns.)
__device__ __forceinline__ void turn_wait(int wg) {
  named_sync(4 + wg, kConsumers);
}
__device__ __forceinline__ void turn_pass(int wg) {
  named_arrive(5 - wg, kConsumers);
}

// ------------------------------------------------------------------- TMA
// One box of a 3-d tensor map (D, rows, heads) into shared memory at
// `dst`; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A tile of ROWS rows x D from row `row` of head `head`: one box per
// column chunk (the map's box is CW x ROWS).
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
  using G = Geo<D>;
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c) {
    tma_load(dst + c * ROWS * G::kW, map, bar, c * G::kCw, row, head);
  }
}

// ----------------------------------------------------------------- wgmma
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// K-major operand (rows x D, D contiguous; 16 values of D per k-step) of
// a tile whose chunks are ROWS rows apart; `tile` may point at a row
// offset that is a multiple of 8 inside it.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  return make_desc(tile + (col / G::kCw) * ROWS * G::kW + (col % G::kCw) * 2,
                   16, 8 * G::kW, G::kLayout);
}

// MN-major operand (the tile's rows are the product's k, its D columns
// the product's n): rows 16kk..16kk+15 of column chunk c.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int c) {
  using G = Geo<D>;
  return make_desc(tile + c * ROWS * G::kW + kk * 16 * G::kW, ROWS * G::kW,
                   8 * G::kW, G::kLayout);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers per thread of the calling warpgroup (see kProducerRegs).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// 2^x on the SFU (ex2.approx, flushing subnormals): -inf gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads of wgmma accumulators above the wait
// for their products (emits no instruction).
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void keep(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) keep(d[i]);
}

// D(64 x 64) += A(64 x 16) B(64 x 16)^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) += A(64 x 16) B(128 x 16)^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 16) += A(64 x 16) B, A in registers (bf16 pairs), B in shared
// memory: B is 16 x 16 K-major (TRANS_B 0) or 16 x 16 MN-major (1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TRANS_B));
}

// D(64 x 32) += A(64 x 16) B, A in registers (bf16 pairs), B in shared
// memory: B is 32 x 16 K-major (TRANS_B 0) or 16 x 32 MN-major (1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TRANS_B));
}

// D(64 x 64) += A(64 x 16) B, A in registers (bf16 pairs), B in shared
// memory: B is 64 x 16 K-major (TRANS_B 0) or 16 x 64 MN-major (1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TRANS_B));
}

// D(64 x 128) += A(64 x 16) B, A in registers (bf16 pairs), B in shared
// memory: B is 128 x 16 K-major (TRANS_B 0) or 16 x 128 MN-major (1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TRANS_B));
}

// ------------------------------------------------------- register tiles
// A warpgroup's fp32 accumulator of a 64 x N product: thread t (warp w =
// t / 32, lane l) holds element i at row 16w + l/4 + 8*((i >> 1) & 1),
// column 8*(i >> 2) + 2*(l & 3) + (i & 1).
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator rounded to bf16 as the A operand of the next product
// (k-step kk = its columns 16kk..16kk+15): the accumulator's layout is the
// A fragment's.
template <int NR>
__device__ __forceinline__ void to_frags(const float (&s)[NR],
                                         uint32_t (&a)[NR / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NR / 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    }
  }
}

// A warpgroup's A fragments (k-steps over D) of rows row0 .. row0 + 63 of
// a tile of ROWS rows as TMA stored it (chunk-major, swizzled: the 16-byte
// unit index of an offset is XORed with its bits 7 and up).
template <int D, int ROWS>
__device__ __forceinline__ void load_frags(const uint8_t* tile, int row0,
                                           uint32_t (&a)[D / 16][4],
                                           int warp, int lane) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + 16 * warp + lane / 4 + 8 * (j & 1);
      const int col = 16 * kk + 8 * (j >> 1) + 2 * (lane & 3);
      const uint32_t off = (col / G::kCw) * ROWS * G::kW + r * G::kW +
                           (col % G::kCw) * 2;
      a[kk][j] = *reinterpret_cast<const uint32_t*>(
          tile + (off ^ (((off >> 7) & (G::kW / 16 - 1)) << 4)));
    }
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) d[i][j] = 0.f;
}

// A warpgroup's 64 x D accumulator (column chunks of CW) times mul0 (its
// rows r) and mul1 (rows r + 8), as bf16 rows of the staging area `st`.
template <int D>
__device__ __forceinline__ void stage_rows(
    uint8_t* st, const float (&o)[Geo<D>::kChunks][Geo<D>::kCw / 2],
    float mul0, float mul1, int warp, int lane) {
  using G = Geo<D>;
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c) {
#pragma unroll
    for (int n = 0; n < G::kCw / 8; ++n) {
      const int col = c * G::kCw + acc_col(4 * n, lane);
      *reinterpret_cast<uint32_t*>(st + r * G::kPitch + 2 * col) =
          pack_bf16(o[c][4 * n] * mul0, o[c][4 * n + 1] * mul0);
      *reinterpret_cast<uint32_t*>(st + (r + 8) * G::kPitch + 2 * col) =
          pack_bf16(o[c][4 * n + 2] * mul1, o[c][4 * n + 3] * mul1);
    }
  }
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The tensor map of a (heads, rows, D) bf16 array read in boxes of `box`
// rows x CW columns, swizzled as the wgmma descriptors expect; rows past
// the end read as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads,
              int box) {
  using G = Geo<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t boxes[3] = {(cuuint32_t)G::kCw, (cuuint32_t)box, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = G::kW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : G::kW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, boxes, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allow `bytes` of dynamic shared memory, and refuse a kernel whose block
// would not hold the registers setmaxnreg hands the consumers (the request
// would stall forever).
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kThreads <
      kConsumers * kConsumerRegs + (kThreads - kConsumers) * kProducerRegs) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

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
