// Hopper (sm_90a) building blocks shared by the port's kernels (the
// attention kernels dense_flash.cu and varlen_flash.cu, and the Mamba2
// scan mamba_scan.cu): mbarriers, TMA tile loads
// from tensor maps encoded on the host, wgmma descriptors and products
// (bf16 x bf16 into fp32, A from shared memory or registers), setmaxnreg,
// register-tile helpers and the host-side tensor-map encoder.
//
// Everything here has internal linkage: each kernel library is one
// translation unit that includes this header once.
#pragma once

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- host side
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

// The tensor map of a bf16 array of dims[0] = D (contiguous) x dims[1] x
// dims[2], whose second and third axes are `strides` bytes apart (any
// order, each a multiple of 16), read in boxes of CW x box1 x box2 and
// swizzled as the wgmma descriptors expect: a box lands as box1 * box2
// rows of CW values, the first axis fastest. Coordinates past an end read
// as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[3],
              const cuuint64_t (&strides)[2], int box1, int box2) {
  using G = Geo<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t boxes[3] = {(cuuint32_t)G::kCw, (cuuint32_t)box1,
                               (cuuint32_t)box2};
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

// The tensor map of a contiguous (heads, rows, dh) bf16 array, dh <= D,
// read in boxes of `box` rows x CW columns; columns dh..D-1 read as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads,
              int box, int dh) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)rows * dh * 2};
  return make_map<D>(map, ptr, dims, strides, box, 1);
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

}  // namespace
