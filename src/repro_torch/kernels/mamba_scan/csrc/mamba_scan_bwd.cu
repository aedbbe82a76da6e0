// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a), in the contract
// of mamba_chunk_scan_varlen (kernel.py) with zero initial states: ragged
// token runs ("rows") [row_start[r], row_start[r] + row_len[r]) of one
// stream, chunk length L = 64 from each row's first token, P == N == D.
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
// lc_s, 0)) for s <= t else 0, cf_s = exp(lc_last - lc_s) dt_s, S_in the
// state entering the chunk, dS the gradient of the state leaving it):
//   forward  y_t   = sum_s (C_t.B_s) W_ts dt_s x_s + exp(lc_t) S_in C_t
//            S_out = exp(lc_last) S_in + U,  U = sum_s cf_s x_s B_s^T
//   backward dS_in = exp(lc_last) dS + V,    V = sum_t exp(lc_t) dy_t C_t^T
//            dx_s  = sum_t score_ts dy_t + cf_s dS B_s
//            dC_t  = sum_s dG_ts B_s + exp(lc_t) S_in^T dy_t  (over heads)
//            dB_s  = sum_t dG_ts C_t + cf_s dS^T x_s
//   with score_ts = (C_t.B_s) W_ts dt_s, dG_ts = (dy_t.x_s) W_ts dt_s; the
//   decay's gradient dlc_t (from W, the state read, the state update and
//   S_in's decay) flows back through the cumsum to dt (times a) and, summed
//   over tokens, to a_log (times a).
//
// Design: two launches of one warpgroup a block, no float atomics and every
// sum in a fixed order, so two calls give the same bytes (exact resume needs
// bitwise-repeatable gradients).
//  * Work items are found on the device from a ticket (a self-resetting
//    per-stream counter) and the row lengths (find_unit): the host never
//    reads the lengths. The chunks of all rows are numbered level by level
//    (every row's first chunk, then every row's second, ...), so the
//    chains of all rows advance together. A block waits only on its row's
//    previous chunk, whose ticket is smaller and which has started, so no
//    block can starve the one it waits for.
//  * Launch A (mamba_bwd_states_kernel), one block per (unit of up to 4
//    chunks, head) over every chunk but a row's last, a row's units in
//    order: the block computes its chunks' U on the tensor cores, then
//    waits for its predecessor's flag and forms S_in(c + 1) = exp(lc_last)
//    S_in(c) + U chunk by chunk in `states`, publishing the last (a chain
//    of 8 hops for a 2048-token row, not 31). `states` is both the
//    hand-off and launch B's S_in: one fp32 round trip of (chunks, H, P,
//    N), the price of not changing the forward kernel, which the serve
//    path runs.
//  * Launch B (mamba_bwd_chunk_kernel), one block per (chunk, group of
//    kGroup heads), a row's chunks in reverse. The block computes C B^T
//    once (an exact bf16 product, kept in shared memory) and walks its
//    heads in order: V on the tensor cores, the wait for its successor's
//    flag, dS(c - 1) = exp(lc_last) dS + V into the per-(row, head) slot
//    `carry` and the flag; then, with S_in and dS as bf16 hi + lo tiles in
//    shared memory, every gradient of the chunk. dS goes through device
//    memory only in the hand-off slot. dx is written in bf16, ddt in fp32;
//    dB and dC are summed over the group's heads in registers and written
//    as the group's fp32 part; the last block of a chunk (a per-chunk
//    counter) sums the groups' parts in index order and writes dB and dC
//    in bf16 (one rounding), and the last block of the launch sums
//    da_log's per-(chunk, head) parts over chunks in order. Tickets below
//    ceil(TT / 16) zero the outputs of tokens in no row, so the wrapper
//    allocates nothing zero-filled.
//  * Products: bf16 wgmma with the 64-token chunk (or the head's state
//    rows) as M. x, B and C enter as they are; each fp32 operand (dy,
//    the scores, dG, S_in, dS, cf B, exp(lc) C) as a bf16 hi + lo pair:
//    hi.hi + hi.lo + lo.hi where both sides are fp32, two products where
//    one is bf16 (the CPU emulation in tests/test_torch_mamba_bwd.py holds
//    this rounding within the card's tolerance; ddt, whose terms cancel,
//    stays within 1e-5 of its largest value). U = x^T (cf B) and V = dy^T
//    (exp(lc) C) take both operands MN-major from shared memory, the
//    per-token scale on the B side. The decay's token sums are row sums of
//    the accumulators: rowq_t = sum_s vv_ts dt_s and colv_s = sum_t vv_ts
//    (from dM = dy x^T in both orientations), rr_t = sum_n C (S_in^T dy)
//    and uu_s = sum_n B (dS^T x).
//  * TMA brings the 64-token tiles of x, B and C (strided views, as the
//    forward's tensor maps take them) into swizzled shared memory, and a
//    head's dy and S_in (fp32, unswizzled) a head ahead; x of the next
//    head too. The log-decay cumsum and its reverse are warp scans, every
//    token sum a warp-shuffle reduction in a fixed order; the decay
//    matrix's exponentials run on ex2.approx.
//
// What bounds it on the H100. It must read x, B, C, dt and dy (fp32) once
// and write dx, dB, dC (bf16), ddt and da_log once: 138 MB at zamba2-1.2b's
// training shape (2 rows of 2048, H = P = N = 64), 0.0413 ms at 3.35 TB/s,
// the roofline (chip_smoke.py phase 2c counts each input byte once, whatever
// the kernel reads again). About 20 bf16 64 x 64 x 64 products per (chunk,
// head) are ~43 GFLOP, 0.044 ms at 989 TFLOP/s (launch A adds 2). The
// design target was 0.25 ms a call; this version takes ~0.40 (PERF.md).
// What keeps it from the bound: each head's chain of dependent phases
// (loads, products, barriers) at 2 blocks an SM (255 registers, 110 KB of
// shared memory in launch B; 224 registers in launch A), the S_in round
// trip (67 MB each way) and the dB/dC parts (34 MB each way).

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kT = 128;          // one warpgroup a block
constexpr int kL = 64;           // chunk length
constexpr int kZeroTile = 16;    // tokens a zeroing block checks
constexpr int kFlagBase = 32;    // sync[0] ticket, sync[1] done counter
constexpr int kGroup = 4;        // heads a launch-B block walks in order

__host__ __device__ constexpr uint32_t align1k(uint32_t v) {
  return (v + 1023u) / 1024u * 1024u;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until the flag reads `want` (trapping after kHangCycles, as the
// barrier waits do), then acquire what its writer published.
__device__ __forceinline__ void wait_flag(const int* f, int want) {
  long long start = 0;
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(f)
                 : "memory");
    if (v == want) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kHangCycles) {
      __trap();
    }
  }
}

__device__ __forceinline__ void publish_flag(int* f, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(f), "r"(v)
               : "memory");
}

// Byte offset of (row, col) in a swizzled tile of ROWS rows x D bf16, as TMA
// stores it and load_frags reads it.
template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  using Gm = Geo<D>;
  const uint32_t off = (col / Gm::kCw) * ROWS * Gm::kW + row * Gm::kW +
                       (col % Gm::kCw) * 2;
  return off ^ (((off >> 7) & (Gm::kW / 16 - 1)) << 4);
}

template <int D, int ROWS>
__device__ __forceinline__ float tile_at(const uint8_t* tile, int row,
                                         int col) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(tile + swz<D, ROWS>(row, col)));
}

// Zero rows cl .. 63 of a 64-row TMA tile of D columns (tokens past a row's
// end: whatever the stream holds there never enters a product).
template <int D>
__device__ __forceinline__ void zero_tail(uint8_t* tile, int cl, int tid) {
  using Gm = Geo<D>;
  constexpr int kUnits = Gm::kW / 16;
  const int n = Gm::kChunks * (kL - cl) * kUnits;
  for (int e = tid; e < n; e += kT) {
    const int u = e % kUnits, rc = e / kUnits;
    const int c = rc / (kL - cl), r = cl + rc % (kL - cl);
    *reinterpret_cast<uint4*>(tile + c * kL * Gm::kW + r * Gm::kW + 16 * u) =
        make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// D(64 x N) += A(64 x 16) B(16 x N) with both operands MN-major in shared
// memory (A's 64 rows and B's N columns contiguous, desc_mn): a product
// over tokens of two token-row tiles, such as x^T (cf B) or dy^T (e C).
__device__ __forceinline__ void wgmma_tt(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
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

// A 64-token tile of D bf16 (as TMA stores it) times a per-token scale,
// as bf16 hi + lo tiles of the same layout; `hi` may be `src`.
template <int D>
__device__ __forceinline__ void scaled_pair_tiles(const uint8_t* src,
                                                  const float* scale,
                                                  uint8_t* hi, uint8_t* lo,
                                                  int tid) {
  for (int e = tid; e < kL * D / 2; e += kT) {
    const int t = e / (D / 2), n = 2 * (e % (D / 2));
    const uint32_t off = swz<D, kL>(t, n);
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(src + off);
    uint32_t h, l;
    split_pair(scale[t] * __low2float(v), scale[t] * __high2float(v), h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// A warpgroup's 64 x 64 fp32 accumulator as bf16 hi + lo A fragments.
__device__ __forceinline__ void split_frags(const float (&s)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_pair(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], hi[kk][j],
                 lo[kk][j]);
}

// A row of len tokens has nc = ceil(len / 64) chunks. In launch B (KA = 0)
// each chunk is a unit, unit k being chunk nc - 1 - k; in launch A the
// chunks but the last are cut into units of KA, unit k holding chunks kKA
// .. min(kKA + KA, nc - 1) - 1 (none for a row of one chunk or none).
// Units are numbered level by level: every row's unit 0 in row order,
// then every row's unit 1, and so on, so the chains of all rows advance
// together and unit k - 1 of a row always has the smaller number.
// find_unit maps unit number u to its row (info[0], -1 past the real
// count) and k (info[1]), with the chunks of the rows before that row
// (info[2]) and of all rows (info[3]): level k starts after F(k) = sum_r
// min(units_r, k) units (a binary search over k), and the row is the
// (u - F(k))-th in order with more than k units (a scan). Warp 0 does it
// all with shuffles, 32 rows a step (one step for a training batch of up
// to 32 rows, whose lengths stay in registers); it shares no memory with
// the other warps but info. Ends with a barrier.
template <int KA>
__device__ void find_unit(const int* __restrict__ row_len, int R, int u,
                          int* info) {
  if (threadIdx.x < 32) {
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x;
    auto units = [](int nc) {
      return KA == 0 ? nc : (max(nc - 1, 0) + KA - 1) / KA;
    };
    const int nc0 = lane < R ? (row_len[lane] + kL - 1) / kL : 0;
    auto chunks = [&](int base) {   // chunks of row base + lane, 0 past R
      const int r = base + lane;
      return base == 0 ? nc0 : r < R ? (row_len[r] + kL - 1) / kL : 0;
    };
    auto warp_sum = [&](int v) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(all, v, o);
      return v;
    };
    int top = 0, all_units = 0, all_chunks = 0;
    for (int base = 0; base < R; base += 32) {
      const int nc = chunks(base);
      top = max(top, units(nc));
      all_units += units(nc);
      all_chunks += nc;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      top = max(top, __shfl_xor_sync(all, top, o));
    all_units = warp_sum(all_units);
    all_chunks = warp_sum(all_chunks);
    int row = -1, k = 0, before = 0;
    if (u < all_units) {
      int lo = 0, hi = top - 1, f_lo = 0;   // F(lo) <= u
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        int f = 0;
        for (int base = 0; base < R; base += 32)
          f += min(units(chunks(base)), mid);
        f = warp_sum(f);
        if (f <= u) {
          lo = mid;
          f_lo = f;
        } else {
          hi = mid - 1;
        }
      }
      const int j = u - f_lo;
      int run_n = 0, run_c = 0;   // earlier steps: rows past lo, chunks
      for (int base = 0; base < R; base += 32) {
        const int nc = chunks(base);
        const int in = units(nc) > lo;
        int sn = in, sc = nc;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int vn = __shfl_up_sync(all, sn, o);
          const int vc = __shfl_up_sync(all, sc, o);
          if (lane >= o) {
            sn += vn;
            sc += vc;
          }
        }
        const unsigned hit = __ballot_sync(all, in && run_n + sn - 1 == j);
        if (hit) {
          const int src = __ffs(hit) - 1;
          row = base + src;
          k = lo;
          before = run_c + __shfl_sync(all, sc - nc, src);
          break;
        }
        run_n += __shfl_sync(all, sn, 31);
        run_c += __shfl_sync(all, sc, 31);
      }
    }
    if (lane == 0) {
      info[0] = row;
      info[1] = k;
      info[2] = before;
      info[3] = all_chunks;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int draw_ticket(int* sync) {
  const int w = atomicAdd(sync, 1);
  if (w == (int)gridDim.x - 1) atomicExch(sync, 0);   // all drawn: reset
  return w;
}

// ------------------------------------------------------------- launch A
constexpr int kKA = 4;   // chunks a launch-A block chains itself

template <int D>
struct SmemA {
  static constexpr uint32_t kTile = kL * D * 2;
  static constexpr uint32_t kB = 0;                          // [kKA] tiles
  static constexpr uint32_t kX = kB + kKA * align1k(kTile);  // [kKA] tiles
  static constexpr uint32_t kBl = kX + kKA * align1k(kTile); // [kKA] tiles
  static constexpr uint32_t kSf = kBl + kKA * align1k(kTile); // [kKA][64]
  static constexpr uint32_t kBar = kSf + kKA * kL * 4;
  // x^T as an MN-major operand of 64 rows reads 64 x 64 bf16 (8 KB) from
  // a tile's base whatever D is (rows past D are never stored): the last
  // x tile's read must stay inside the block's shared memory
  static constexpr uint32_t kEnd =
      kX + (kKA - 1) * align1k(kTile) + kL * kL * 2;
  static constexpr uint32_t kBytes =
      (kBar + 64 > kEnd ? kBar + 64 : kEnd) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kT, 2)
mamba_bwd_states_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_b,
                        const float* __restrict__ dt,
                        const float* __restrict__ a_log,
                        const int* __restrict__ row_start,
                        const int* __restrict__ row_len, float* states,
                        int* sync, int R, int H) {
  using Sm = SmemA<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int info[5];
  __shared__ float lends[kKA];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) info[4] = draw_ticket(sync);
  __syncthreads();
  const int w = info[4];
  const int h = w % H;
  find_unit<kKA>(row_len, R, w / H, info);
  const int r = info[0];
  if (r < 0) return;
  const int k = info[1];
  const int nch = (row_len[r] + kL - 1) / kL;
  const int nu = (nch - 1 + kKA - 1) / kKA;     // the row's units
  const int c0 = k * kKA, m = min(kKA, nch - 1 - c0);
  const int g = info[2] + c0;
  const int tok0 = row_start[r] + c0 * kL;   // full chunks: never a row's last
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t sb = smem_u32(sm);
  const uint32_t bar = sb + Sm::kBar;
  if (tid == 0) {
    bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect(bar, 2 * m * Sm::kTile);
    for (int i = 0; i < m; ++i) {
      tma_tile<D, kL>(sb + Sm::kB + i * align1k(Sm::kTile), &map_b, bar,
                      tok0 + i * kL, 0);
      tma_tile<D, kL>(sb + Sm::kX + i * align1k(Sm::kTile), &map_x, bar,
                      tok0 + i * kL, h);
    }
  }
  // cf = exp(lc_last - lc) dt of each chunk by a warp scan (warp i: chunk i)
  const float a = -expf(a_log[h]);
  if (warp < m) {
    const int64_t t = tok0 + warp * kL + 2 * lane;
    const float d0 = dt[t * H + h], d1 = dt[(t + 1) * H + h];
    float inc = d0 * a + d1 * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) ex = 0.f;
    const float l0 = ex + d0 * a, l1 = l0 + d1 * a;
    const float lend = __shfl_sync(0xffffffffu, l1, 31);
    float* sf = reinterpret_cast<float*>(sm + Sm::kSf) + warp * kL;
    sf[2 * lane] = expf(fminf(lend - l0, 0.f)) * d0;
    sf[2 * lane + 1] = expf(fminf(lend - l1, 0.f)) * d1;
    if (lane == 0) lends[warp] = lend;
  }
  __syncthreads();
  bar_wait(bar, 0);

  // U of each chunk, x^T (cf B): cf B as hi + lo tiles (hi in place of
  // B), x^T and both as MN-major operands, all the block's products in one
  // batch (rows p of U past D are never stored)
  const int t0r = 16 * warp + lane / 4;
  for (int i = 0; i < m; ++i) {
    uint8_t* bt = sm + Sm::kB + i * align1k(Sm::kTile);
    scaled_pair_tiles<D>(bt,
                         reinterpret_cast<const float*>(sm + Sm::kSf) + i * kL,
                         bt, sm + Sm::kBl + i * align1k(Sm::kTile), tid);
  }
  fence_proxy_async();
  __syncthreads();
  float us[kKA][D / 2];
  wg_fence();
#pragma unroll
  for (int i = 0; i < kKA; ++i) {
    if (i >= m) break;
    const uint32_t xt = sb + Sm::kX + i * align1k(Sm::kTile);
    const uint32_t bh = sb + Sm::kB + i * align1k(Sm::kTile);
    const uint32_t bl = sb + Sm::kBl + i * align1k(Sm::kTile);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = desc_mn<D, kL>(xt, kk, 0);
      wgmma_tt(us[i], dx, desc_mn<D, kL>(bh, kk, 0), kk > 0);
      wgmma_tt(us[i], dx, desc_mn<D, kL>(bl, kk, 0), 1);
    }
  }
  wg_commit();
  wg_wait<0>();
  keep(us);

  // the hand-off: S_in(c0) from the predecessor, then S_in(c0 + 1 ..
  // c0 + m) in turn; the last goes to the successor
  int* flag = sync + kFlagBase + (int64_t)r * H + h;
  if (k > 0) {
    if (tid == 0) wait_flag(flag, k);
    __syncthreads();
  }
  float2 sv[D / 8][2];
  const float* src = states + ((int64_t)g * H + h) * D * D;
#pragma unroll
  for (int q = 0; q < D / 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = t0r + 8 * e;
      sv[q][e] = k > 0 && p < D
                     ? __ldcg(reinterpret_cast<const float2*>(
                           src + p * D + acc_col(4 * q, lane)))
                     : make_float2(0.f, 0.f);
    }
#pragma unroll
  for (int i = 0; i < kKA; ++i) {
    if (i >= m) break;
    const float decay = expf(lends[i]);
    float* dst = states + ((int64_t)(g + i + 1) * H + h) * D * D;
#pragma unroll
    for (int q = 0; q < D / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = t0r + 8 * e;
        const int j = 4 * q + 2 * e;
        sv[q][e] = make_float2(fmaf(sv[q][e].x, decay, us[i][j]),
                               fmaf(sv[q][e].y, decay, us[i][j + 1]));
        if (p < D)
          __stcg(reinterpret_cast<float2*>(dst + p * D +
                                           acc_col(4 * q, lane)),
                 sv[q][e]);
      }
  }
  __syncthreads();
  if (tid == 0) {
    // the release after the block barrier publishes every thread's stores;
    // the row's last unit only resets the flag (launch B reads `states`
    // after this launch)
    if (k + 1 < nu) {
      publish_flag(flag, k + 1);
    } else if (k > 0) {
      *reinterpret_cast<volatile int*>(flag) = 0;
    }
  }
}

// ------------------------------------------------------------- launch B
template <int D>
struct SmemB {
  static constexpr uint32_t kTile = kL * D * 2;   // 64 tokens x D bf16
  static constexpr uint32_t kSq = D * D * 2;      // D x D bf16
  static constexpr int kGs = kL + 4;              // fp32 stride of G
  static constexpr uint32_t kB = 0;
  static constexpr uint32_t kC = kB + align1k(kTile);
  static constexpr uint32_t kX = kC + align1k(kTile);
  static constexpr uint32_t kDyH = kX + align1k(kTile);
  static constexpr uint32_t kDyL = kDyH + align1k(kTile);
  static constexpr uint32_t kSH = kDyL + align1k(kTile);
  static constexpr uint32_t kSL = kSH + align1k(kSq);
  static constexpr uint32_t kDsH = kSL + align1k(kSq);
  static constexpr uint32_t kDsL = kDsH + align1k(kSq);
  static constexpr uint32_t kG = kDsL + align1k(kSq);        // G[t][s]
  // the next head's dy, fp32 as TMA stores it (64 tokens x D)
  static constexpr uint32_t kStage = align1k(kG + kL * kGs * 4);
  // per head: dt, lc log2(e), exp(lc), exp(lc_last - lc); per token:
  // rowq, colv, rr, uu
  static constexpr uint32_t kVec = kStage + kL * D * 4;
  static constexpr uint32_t kBars = kVec + 8 * kL * 4;
  static constexpr uint32_t kBytes = kBars + 64 + 1024;
  // dy^T as an MN-major operand reads 8 KB from each dy tile whatever D
  // is (as x^T in SmemA): inside the block's shared memory
  static_assert(kDyL + kL * kL * 2 <= kBars, "dy^T reads past the end");
};

template <int D>
__device__ void zero_gaps(bf16* dx, float* ddt, bf16* dbm, bf16* dcm,
                          float* da_log, const int* row_start,
                          const int* row_len, int R, int TT, int H, int k,
                          unsigned* cover) {
  const int tid = threadIdx.x, t0 = k * kZeroTile;
  if (tid == 0) *cover = 0u;
  __syncthreads();
  bool any = false;
  for (int r = tid; r < R; r += kT) {
    const int a = max(row_start[r], t0) - t0;
    const int b = min(row_start[r] + row_len[r], t0 + kZeroTile) - t0;
    if (a < b) atomicOr(cover, ((1u << b) - 1u) & ~((1u << a) - 1u));
    any = any || row_len[r] > 0;
  }
  // no token in any row: nothing else writes da_log
  if (!__syncthreads_or(any) && k == 0) {
    for (int h = tid; h < H; h += kT) da_log[h] = 0.f;
  }
  const int n = min(kZeroTile, TT - t0);
  for (int t = 0; t < n; ++t) {
    if ((*cover >> t) & 1u) continue;
    const int64_t tok = t0 + t;
    uint4* xr = reinterpret_cast<uint4*>(dx + tok * H * D);
    for (int e = tid; e < H * D / 8; e += kT) xr[e] = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < H; e += kT) ddt[tok * H + e] = 0.f;
    for (int e = tid; e < D / 2; e += kT) {
      reinterpret_cast<uint32_t*>(dbm + tok * D)[e] = 0u;
      reinterpret_cast<uint32_t*>(dcm + tok * D)[e] = 0u;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kT, 2)
mamba_bwd_chunk_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_c,
                       const __grid_constant__ CUtensorMap map_dy,
                       const __grid_constant__ CUtensorMap map_s,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const int* __restrict__ row_start,
                       const int* __restrict__ row_len,
                       const float* __restrict__ dy,
                       const float* __restrict__ states, float* carry,
                       float* parts, float* da_part, bf16* __restrict__ dx,
                       bf16* __restrict__ dbm, bf16* __restrict__ dcm,
                       float* __restrict__ ddt, float* __restrict__ da_log,
                       int* sync, int TT, int R, int H) {
  using Sm = SmemB<D>;
  constexpr int kGs = Sm::kGs;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int info[7];
  __shared__ float red[4];
  __shared__ unsigned cover;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) info[4] = draw_ticket(sync);
  __syncthreads();
  const int w = info[4];
  const int n_tiles = (TT + kZeroTile - 1) / kZeroTile;
  if (w < n_tiles) {
    zero_gaps<D>(dx, ddt, dbm, dcm, da_log, row_start, row_len, R, TT, H, w,
                 &cover);
    return;
  }
  const int groups = (H + kGroup - 1) / kGroup;
  const int grp = (w - n_tiles) % groups;
  find_unit<0>(row_len, R, (w - n_tiles) / groups, info);
  const int r = info[0];
  if (r < 0) return;
  const int len = row_len[r], nch = (len + kL - 1) / kL;
  const int c = nch - 1 - info[1];   // a row's chunks in reverse
  const int g = info[2] + c, total = info[3];
  const int tok0 = row_start[r] + c * kL;
  const int cl = min(kL, len - c * kL);
  const int h0 = grp * kGroup, h1 = min(H, h0 + kGroup);

  uint8_t* sm = smem_base(smem_raw);
  const uint32_t sb = smem_u32(sm);
  const uint32_t bar_bc = sb + Sm::kBars, bar_x = bar_bc + 8;
  const uint32_t bar_dy = bar_bc + 16, bar_s = bar_bc + 24;
  float* gs = reinterpret_cast<float*>(sm + Sm::kG);
  const float* stage = reinterpret_cast<const float*>(sm + Sm::kStage);
  // a head's S_in, fp32, lands where its dS tiles go once it is converted
  const float* sstage = reinterpret_cast<const float*>(sm + Sm::kDsH);
  float* dtv = reinterpret_cast<float*>(sm + Sm::kVec);
  float* lcv = dtv + kL;
  float* elv = lcv + kL;     // exp(lc)
  float* dcv = elv + kL;     // exp(lc_last - lc)
  float* rowq = dcv + kL;
  float* colv = rowq + kL;
  float* rrv = colv + kL;
  float* uuv = rrv + kL;
  if (tid == 0) {
    bar_init(bar_bc, 1);
    bar_init(bar_x, 1);
    bar_init(bar_dy, 1);
    bar_init(bar_s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect(bar_bc, 2 * Sm::kTile);
    tma_tile<D, kL>(sb + Sm::kB, &map_b, bar_bc, tok0, 0);
    tma_tile<D, kL>(sb + Sm::kC, &map_c, bar_bc, tok0, 0);
    bar_expect(bar_x, Sm::kTile);
    tma_tile<D, kL>(sb + Sm::kX, &map_x, bar_x, tok0, h0);
    bar_expect(bar_dy, kL * D * 4);
    tma_load(sb + Sm::kStage, &map_dy, bar_dy, 0, tok0, h0);
    if (c > 0) {
      bar_expect(bar_s, D * D * 4);
      tma_load(sb + Sm::kDsH, &map_s, bar_s, 0, 0, g * H + h0);
    }
  }
  // warp 0 holds the next head's dt, loaded a head ahead
  float nd0 = 0.f, nd1 = 0.f;
  if (warp == 0) {
    nd0 = 2 * lane < cl ? dt[(int64_t)(tok0 + 2 * lane) * H + h0] : 0.f;
    nd1 = 2 * lane + 1 < cl ? dt[(int64_t)(tok0 + 2 * lane + 1) * H + h0]
                            : 0.f;
  }
  __syncthreads();
  bar_wait(bar_bc, 0);
  if (cl < kL) {
    zero_tail<D>(sm + Sm::kB, cl, tid);
    zero_tail<D>(sm + Sm::kC, cl, tid);
    fence_proxy_async();
    __syncthreads();
  }
  const int t0r = 16 * warp + lane / 4;   // this thread's rows t0r, t0r + 8

  // G = C B^T, exact (bf16 inputs, fp32 sums), shared by the group's
  // heads; the (s, t) loops read it transposed (G[t][s], free of bank
  // conflicts at this stride)
  {
    uint32_t fa[D / 16][4];
    float acc[32];
    load_frags<D, kL>(sm + Sm::kC, 0, fa, warp, lane);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs<0>(acc, fa[kk], desc_k<D, kL>(sb + Sm::kB, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    keep(acc);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(gs + (t0r + 8 * e) * kGs +
                                   acc_col(4 * q, lane)) =
            make_float2(acc[4 * q + 2 * e], acc[4 * q + 2 * e + 1]);
  }

  float dbs[D / 2], dcs[D / 2];   // the group's dB (rows s) and dC (rows t)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dbs[i] = dcs[i] = 0.f;
  uint32_t xphase = 0, dyphase = 0, sphase = 0;

  for (int h = h0; h < h1; ++h) {
    // ---- per-head vectors (warp 0) and dy as bf16 hi + lo tiles
    const float a = -expf(a_log[h]);
    if (warp == 0) {
      const int s0 = 2 * lane;
      const float d0 = nd0, d1 = nd1;
      if (h + 1 < h1) {
        nd0 = s0 < cl ? dt[(int64_t)(tok0 + s0) * H + h + 1] : 0.f;
        nd1 = s0 + 1 < cl ? dt[(int64_t)(tok0 + s0 + 1) * H + h + 1] : 0.f;
      }
      float inc = d0 * a + d1 * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      float ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) ex = 0.f;
      const float l0 = ex + d0 * a, l1 = l0 + d1 * a;
      const float lend = __shfl_sync(0xffffffffu, l1, 31);
      dtv[s0] = d0;
      dtv[s0 + 1] = d1;
      lcv[s0] = l0 * kLog2e;
      lcv[s0 + 1] = l1 * kLog2e;
      elv[s0] = expf(l0);
      elv[s0 + 1] = expf(l1);
      dcv[s0] = expf(fminf(lend - l0, 0.f));
      dcv[s0 + 1] = expf(fminf(lend - l1, 0.f));
    }
    // S_in (TMA'd a head ahead into the dS tiles' space, fp32; chunk 0's
    // is zero) as hi + lo tiles
    if (c > 0) {
      bar_wait(bar_s, sphase);
      sphase ^= 1u;
    }
    for (int e = tid; e < D * D / 4; e += kT) {
      const int p = e / (D / 4), n = 4 * (e % (D / 4));
      const float4 v = c > 0 ? reinterpret_cast<const float4*>(sstage)[e]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t hi, lo;
      split_pair(v.x, v.y, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + Sm::kSH + swz<D, D>(p, n)) = hi;
      *reinterpret_cast<uint32_t*>(sm + Sm::kSL + swz<D, D>(p, n)) = lo;
      split_pair(v.z, v.w, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + Sm::kSH + swz<D, D>(p, n + 2)) = hi;
      *reinterpret_cast<uint32_t*>(sm + Sm::kSL + swz<D, D>(p, n + 2)) = lo;
    }
    bar_wait(bar_dy, dyphase);
    dyphase ^= 1u;
    for (int e = tid; e < kL * D / 4; e += kT) {
      const int t = e / (D / 4), p = 4 * (e % (D / 4));
      const float4 v = t < cl ? reinterpret_cast<const float4*>(stage)[e]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t hi, lo;
      split_pair(v.x, v.y, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + Sm::kDyH + swz<D, kL>(t, p)) = hi;
      *reinterpret_cast<uint32_t*>(sm + Sm::kDyL + swz<D, kL>(t, p)) = lo;
      split_pair(v.z, v.w, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + Sm::kDyH + swz<D, kL>(t, p + 2)) = hi;
      *reinterpret_cast<uint32_t*>(sm + Sm::kDyL + swz<D, kL>(t, p + 2)) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    const float elast = elv[kL - 1];

    int* flag = sync + kFlagBase + (int64_t)r * H + h;
    float* slot = carry + ((int64_t)r * H + h) * D * D;

    // ---- V = dy^T (exp(lc) C) (rows p), the reverse chain's own term:
    // exp(lc) C as hi + lo tiles in the staging space, then the next
    // head's dy lands there, a head ahead
    float vs[D / 2];
    if (c > 0) {
      scaled_pair_tiles<D>(sm + Sm::kC, elv, sm + Sm::kStage,
                           sm + Sm::kStage + align1k(Sm::kTile), tid);
      fence_proxy_async();
      __syncthreads();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t yh = desc_mn<D, kL>(sb + Sm::kDyH, kk, 0);
        const uint64_t ch = desc_mn<D, kL>(sb + Sm::kStage, kk, 0);
        wgmma_tt(vs, yh, ch, kk > 0);
        wgmma_tt(vs, yh, desc_mn<D, kL>(sb + Sm::kStage +
                                            align1k(Sm::kTile), kk, 0), 1);
        wgmma_tt(vs, desc_mn<D, kL>(sb + Sm::kDyL, kk, 0), ch, 1);
      }
      wg_commit();
      wg_wait<0>();
      keep(vs);
      __syncthreads();   // every warp's products have read the staging
    }
    if (tid == 0 && h + 1 < h1) {
      bar_expect(bar_dy, kL * D * 4);
      tma_load(sb + Sm::kStage, &map_dy, bar_dy, 0, tok0, h + 1);
    }

    // ---- the hand-off: dS from the successor, dS(c - 1) out
    if (c + 1 < nch) {
      if (tid == 0) wait_flag(flag, nch - 1 - c);
      __syncthreads();
    }
    float2 dsv[D / 8][2];
#pragma unroll
    for (int q = 0; q < D / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = t0r + 8 * e, n = acc_col(4 * q, lane);
        dsv[q][e] = p < D && c + 1 < nch
                        ? __ldcg(reinterpret_cast<const float2*>(
                              slot + p * D + n))
                        : make_float2(0.f, 0.f);
      }
    if (c > 0) {
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = t0r + 8 * e;
          if (p >= D) continue;
          const int i = 4 * q + 2 * e;
          __stcg(reinterpret_cast<float2*>(slot + p * D +
                                           acc_col(4 * q, lane)),
                 make_float2(fmaf(dsv[q][e].x, elast, vs[i]),
                             fmaf(dsv[q][e].y, elast, vs[i + 1])));
        }
    }
    __syncthreads();
    if (tid == 0 && nch > 1) {
      // the release after the block barrier publishes every thread's
      // stores; chunk 0 is the chain's last reader and resets the flag
      if (c > 0) {
        publish_flag(flag, nch - c);
      } else {
        *reinterpret_cast<volatile int*>(flag) = 0;
      }
    }
    // <dS, S_in> (S_in as its hi + lo pair) and the hi + lo tiles of dS
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < D / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = t0r + 8 * e;
        if (p >= D) continue;
        const uint32_t off = swz<D, D>(p, acc_col(4 * q, lane));
        const __nv_bfloat162 sh =
            *reinterpret_cast<const __nv_bfloat162*>(sm + Sm::kSH + off);
        const __nv_bfloat162 sl =
            *reinterpret_cast<const __nv_bfloat162*>(sm + Sm::kSL + off);
        part = fmaf(dsv[q][e].x, __low2float(sh) + __low2float(sl), part);
        part = fmaf(dsv[q][e].y, __high2float(sh) + __high2float(sl), part);
        uint32_t hi, lo;
        split_pair(dsv[q][e].x, dsv[q][e].y, hi, lo);
        *reinterpret_cast<uint32_t*>(sm + Sm::kDsH + off) = hi;
        *reinterpret_cast<uint32_t*>(sm + Sm::kDsL + off) = lo;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[warp] = part;   // summed after the per-token barrier
    fence_proxy_async();
    __syncthreads();
    bar_wait(bar_x, xphase);
    xphase ^= 1u;
    if (cl < kL) {
      zero_tail<D>(sm + Sm::kX, cl, tid);
      fence_proxy_async();
      __syncthreads();
    }

    // ---- dM^T = x dy^T (rows s) and sx = x dS (rows s)
    float t1[32], t2[D / 2];
    {
      uint32_t xa[D / 16][4];
      load_frags<D, kL>(sm + Sm::kX, 0, xa, warp, lane);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_rs<0>(t1, xa[kk], desc_k<D, kL>(sb + Sm::kDyH, kk), kk > 0);
        wgmma_rs<0>(t1, xa[kk], desc_k<D, kL>(sb + Sm::kDyL, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_rs<1>(t2, xa[kk], desc_mn<D, D>(sb + Sm::kDsH, kk, 0), kk > 0);
        wgmma_rs<1>(t2, xa[kk], desc_mn<D, D>(sb + Sm::kDsL, kk, 0), 1);
      }
      wg_commit();
      wg_wait<0>();
      keep(t1);
      keep(t2);
    }
    // colv_s = sum_t dM_ts G_ts W_ts; dG^T_st = dM_ts W_ts dt_s as hi + lo
    uint32_t gh[4][4], gl[4][4];
    {
      float cs0 = 0.f, cs1 = 0.f;
      const int sr[2] = {t0r, t0r + 8};
      const float ls[2] = {lcv[sr[0]], lcv[sr[1]]};
      const float ds_[2] = {dtv[sr[0]], dtv[sr[1]]};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = sr[e], t = acc_col(4 * q, lane), i = 4 * q + 2 * e;
          const float2 gv =
              make_float2(gs[t * kGs + s], gs[(t + 1) * kGs + s]);
          const float w0 = t >= s ? ex2(fminf(lcv[t] - ls[e], 0.f)) : 0.f;
          const float w1 =
              t + 1 >= s ? ex2(fminf(lcv[t + 1] - ls[e], 0.f)) : 0.f;
          const float m0 = t1[i] * w0, m1 = t1[i + 1] * w1;
          const float v = fmaf(m0, gv.x, m1 * gv.y);
          if (e) cs1 += v; else cs0 += v;
          t1[i] = m0 * ds_[e];
          t1[i + 1] = m1 * ds_[e];
        }
      cs0 = quad_sum(cs0);
      cs1 = quad_sum(cs1);
      if ((lane & 3) == 0) {
        colv[sr[0]] = cs0;
        colv[sr[1]] = cs1;
      }
      split_frags(t1, gh, gl);
    }
    // uu_s = sum_n B_s sx_s; dB += cf_s sx_s + dG^T C
    {
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = t0r + 8 * e, n = acc_col(4 * q, lane);
          const int i = 4 * q + 2 * e;
          const float v = fmaf(t2[i], tile_at<D, kL>(sm + Sm::kB, s, n),
                               t2[i + 1] *
                                   tile_at<D, kL>(sm + Sm::kB, s, n + 1));
          if (e) u1 += v; else u0 += v;
          const float cf = dcv[s] * dtv[s];
          dbs[i] = fmaf(cf, t2[i], dbs[i]);
          dbs[i + 1] = fmaf(cf, t2[i + 1], dbs[i + 1]);
        }
      u0 = quad_sum(u0);
      u1 = quad_sum(u1);
      if ((lane & 3) == 0) {
        uuv[t0r] = u0;
        uuv[t0r + 8] = u1;
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dc = desc_mn<D, kL>(sb + Sm::kC, kk, 0);
        wgmma_rs<1>(dbs, gh[kk], dc, 1);
        wgmma_rs<1>(dbs, gl[kk], dc, 1);
      }
      wg_commit();
      wg_wait<0>();
      keep(dbs);
    }
    // dx_s = cf_s (B dS^T)_s + sum_t score_ts dy_t, in bf16
    {
      uint32_t ba[D / 16][4];
      load_frags<D, kL>(sm + Sm::kB, 0, ba, warp, lane);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_rs<0>(t2, ba[kk], desc_k<D, D>(sb + Sm::kDsH, kk), kk > 0);
        wgmma_rs<0>(t2, ba[kk], desc_k<D, D>(sb + Sm::kDsL, kk), 1);
      }
      wg_commit();
      // score^T (rows s, columns t) as hi + lo, built while B dS^T runs
      const int sr[2] = {t0r, t0r + 8};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = q & 1, s = sr[e];
          const int t = 16 * kk + 8 * (q >> 1) + 2 * (lane & 3);
          const float2 gv =
              make_float2(gs[t * kGs + s], gs[(t + 1) * kGs + s]);
          const float ls = lcv[s], d = dtv[s];
          const float e0 =
              t >= s ? gv.x * ex2(fminf(lcv[t] - ls, 0.f)) * d : 0.f;
          const float e1 =
              t + 1 >= s ? gv.y * ex2(fminf(lcv[t + 1] - ls, 0.f)) * d
                         : 0.f;
          split_pair(e0, e1, gh[kk][q], gl[kk][q]);
        }
      wg_wait<0>();
      keep(t2);
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cf = dcv[sr[e]] * dtv[sr[e]];
          t2[4 * q + 2 * e] *= cf;
          t2[4 * q + 2 * e + 1] *= cf;
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = desc_mn<D, kL>(sb + Sm::kDyH, kk, 0);
        const uint64_t dl = desc_mn<D, kL>(sb + Sm::kDyL, kk, 0);
        wgmma_rs<1>(t2, gh[kk], dh, 1);
        wgmma_rs<1>(t2, gh[kk], dl, 1);
        wgmma_rs<1>(t2, gl[kk], dh, 1);
      }
      wg_commit();
      wg_wait<0>();
      keep(t2);
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = sr[e];
          if (s >= cl) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              dx + ((int64_t)(tok0 + s) * H + h) * D + acc_col(4 * q, lane)) =
              __floats2bfloat162_rn(t2[4 * q + 2 * e], t2[4 * q + 2 * e + 1]);
        }
    }
    // ---- dM = dy x^T (rows t) and sy = dy S_in (rows t)
    {
      uint32_t yh[D / 16][4], yl[D / 16][4];
      load_frags<D, kL>(sm + Sm::kDyH, 0, yh, warp, lane);
      load_frags<D, kL>(sm + Sm::kDyL, 0, yl, warp, lane);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dxd = desc_k<D, kL>(sb + Sm::kX, kk);
        wgmma_rs<0>(t1, yh[kk], dxd, kk > 0);
        wgmma_rs<0>(t1, yl[kk], dxd, 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t sh = desc_mn<D, D>(sb + Sm::kSH, kk, 0);
        wgmma_rs<1>(t2, yh[kk], sh, kk > 0);
        wgmma_rs<1>(t2, yh[kk], desc_mn<D, D>(sb + Sm::kSL, kk, 0), 1);
        wgmma_rs<1>(t2, yl[kk], sh, 1);
      }
      wg_commit();
      wg_wait<0>();
      keep(t1);
      keep(t2);
    }
    __syncthreads();   // every product that reads x or dS is done
    if (tid == 0 && h + 1 < h1) {
      bar_expect(bar_x, Sm::kTile);
      tma_tile<D, kL>(sb + Sm::kX, &map_x, bar_x, tok0, h + 1);
      if (c > 0) {
        bar_expect(bar_s, D * D * 4);
        tma_load(sb + Sm::kDsH, &map_s, bar_s, 0, 0, g * H + h + 1);
      }
    }
    // rowq_t = sum_s dM_ts G_ts W_ts dt_s; dG_ts = dM_ts W_ts dt_s as
    // hi + lo; rr_t = exp(lc_t) sum_n C_t sy_t; dC += exp(lc_t) sy_t
    {
      const int tr[2] = {t0r, t0r + 8};
      const float lt[2] = {lcv[tr[0]], lcv[tr[1]]};
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = tr[e], s = acc_col(4 * q, lane), i = 4 * q + 2 * e;
          const float2 gv = *reinterpret_cast<const float2*>(gs + t * kGs + s);
          const float w0 = s <= t ? ex2(fminf(lt[e] - lcv[s], 0.f)) : 0.f;
          const float w1 =
              s + 1 <= t ? ex2(fminf(lt[e] - lcv[s + 1], 0.f)) : 0.f;
          const float m0 = t1[i] * w0 * dtv[s];
          const float m1 = t1[i + 1] * w1 * dtv[s + 1];
          const float v = fmaf(m0, gv.x, m1 * gv.y);
          if (e) q1 += v; else q0 += v;
          t1[i] = m0;
          t1[i + 1] = m1;
        }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
      split_frags(t1, gh, gl);
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = tr[e], n = acc_col(4 * q, lane), i = 4 * q + 2 * e;
          const float v = fmaf(t2[i], tile_at<D, kL>(sm + Sm::kC, t, n),
                               t2[i + 1] *
                                   tile_at<D, kL>(sm + Sm::kC, t, n + 1));
          if (e) r1 += v; else r0 += v;
          const float el = elv[t];
          dcs[i] = fmaf(el, t2[i], dcs[i]);
          dcs[i + 1] = fmaf(el, t2[i + 1], dcs[i + 1]);
        }
      r0 = quad_sum(r0);
      r1 = quad_sum(r1);
      if ((lane & 3) == 0) {
        rowq[tr[0]] = q0;
        rowq[tr[1]] = q1;
        rrv[tr[0]] = elv[tr[0]] * r0;
        rrv[tr[1]] = elv[tr[1]] * r1;
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mn<D, kL>(sb + Sm::kB, kk, 0);
        wgmma_rs<1>(dcs, gh[kk], db, 1);
        wgmma_rs<1>(dcs, gl[kk], db, 1);
      }
      wg_commit();
    }
    __syncthreads();   // rowq, colv, rr, uu of every token
    // ---- per token (warp 0, two tokens a lane): dlc, its reverse cumsum,
    // ddt and this chunk's part of da_log
    if (warp == 0) {
      const int s0 = 2 * lane;
      float dl[2], cu[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = s0 + j;
        cu[j] = dcv[t] * uuv[t];
        dl[j] = rowq[t] - colv[t] * dtv[t] + rrv[t] - cu[j] * dtv[t];
      }
      float tail = cu[0] * dtv[s0] + cu[1] * dtv[s0 + 1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tail += __shfl_xor_sync(0xffffffffu, tail, o);
      tail = fmaf(elast, (red[0] + red[1]) + (red[2] + red[3]), tail);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (s0 + j == cl - 1) dl[j] += tail;
      // reverse inclusive scan over the 64 tokens
      float inc = dl[0] + dl[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, inc, o);
        if (lane + o < 32) inc += v;
      }
      float after = __shfl_down_sync(0xffffffffu, inc, 1);
      if (lane == 31) after = 0.f;
      const float run1 = after + dl[1], run0 = run1 + dl[0];
      float da = fmaf(run0, dtv[s0], run1 * dtv[s0 + 1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0) da_part[(int64_t)g * H + h] = da;
      const float run[2] = {run0, run1};
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (s0 + j < cl)
          ddt[(int64_t)(tok0 + s0 + j) * H + h] =
              colv[s0 + j] + cu[j] + a * run[j];
    }
    wg_wait<0>();
    keep(dcs);
    __syncthreads();   // the head's tiles and vectors are free
  }

  // ---- the group's dB and dC parts; the chunk's last block sums them
  float* pb = parts + ((int64_t)tok0 * groups + grp) * D;
  float* pc = parts + (((int64_t)TT + tok0) * groups + grp) * D;
#pragma unroll
  for (int q = 0; q < D / 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = t0r + 8 * e, n = acc_col(4 * q, lane), i = 4 * q + 2 * e;
      if (s >= cl) continue;
      __stcg(reinterpret_cast<float2*>(pb + (int64_t)s * groups * D + n),
             make_float2(dbs[i], dbs[i + 1]));
      __stcg(reinterpret_cast<float2*>(pc + (int64_t)s * groups * D + n),
             make_float2(dcs[i], dcs[i + 1]));
    }
  __threadfence();
  __syncthreads();
  int* cnt = sync + kFlagBase + (int64_t)R * H + g;
  if (tid == 0) {
    const int last = atomicAdd(cnt, 1) == groups - 1;
    if (last) *cnt = 0;   // every group has counted: ready for the next call
    info[5] = last;
  }
  __syncthreads();
  if (info[5]) {
    __threadfence();
    const float* qb = parts + (int64_t)tok0 * groups * D;
    const float* qc = parts + ((int64_t)TT + tok0) * groups * D;
    for (int e = tid; e < cl * D / 2; e += kT) {
      const int t = e / (D / 2), n = 2 * (e % (D / 2));
      float2 b = make_float2(0.f, 0.f), cc = make_float2(0.f, 0.f);
      for (int k = 0; k < groups; ++k) {
        const int64_t o = ((int64_t)t * groups + k) * D + n;
        const float2 vb = __ldcg(reinterpret_cast<const float2*>(qb + o));
        const float2 vc = __ldcg(reinterpret_cast<const float2*>(qc + o));
        b.x += vb.x;
        b.y += vb.y;
        cc.x += vc.x;
        cc.y += vc.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(dbm + (int64_t)(tok0 + t) * D + n) =
          __floats2bfloat162_rn(b.x, b.y);
      *reinterpret_cast<__nv_bfloat162*>(dcm + (int64_t)(tok0 + t) * D + n) =
          __floats2bfloat162_rn(cc.x, cc.y);
    }
  }
  // ---- the launch's last block sums da_log's parts over chunks in order
  if (tid == 0) {
    const int done = atomicAdd(sync + 1, 1) == total * groups - 1;
    if (done) sync[1] = 0;
    info[6] = done;
  }
  __syncthreads();
  if (info[6]) {
    __threadfence();
    for (int hh = tid; hh < H; hh += kT) {
      float s = 0.f;
      for (int k = 0; k < total; ++k)
        s += __ldcg(da_part + (int64_t)k * H + hh);
      da_log[hh] = s * -expf(a_log[hh]);
    }
  }
}

// The tensor map of an fp32 array of dims[0] (contiguous) x dims[1] x
// dims[2], the second and third axes `strides` bytes apart, read in boxes
// of dims[0] x box1 x 1, unswizzled; coordinates past an end read as
// zeros. dy (TT, H, D) is read as (D, tokens, heads), `states` (chunks, H,
// D, D) as (D, D, chunks x H).
bool make_map_f32(CUtensorMap* map, const void* ptr,
                  const cuuint64_t (&dims)[3],
                  const cuuint64_t (&strides)[2], int box1) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t box[3] = {(cuuint32_t)dims[0], (cuuint32_t)box1, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
             dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* x, int64_t x_stride, const void* bm, const void* cm,
           int64_t bc_stride, const void* dt, const void* a_log,
           const void* row_start, const void* row_len, const void* dy,
           void* dx, void* dbm, void* dcm, void* ddt, void* da_log,
           void* states, void* carry, void* parts, void* da_part, void* sync,
           int TT, int R, int H, int blocks_a, int blocks_b,
           cudaStream_t stream) {
  // x: (D, tokens, heads), a box of 64 tokens x one head; B, C: (D,
  // tokens, 1), a box of 64 tokens
  const cuuint64_t xd[3] = {(cuuint64_t)D, (cuuint64_t)TT, (cuuint64_t)H};
  const cuuint64_t xs[2] = {(cuuint64_t)x_stride * 2, (cuuint64_t)D * 2};
  const cuuint64_t bd[3] = {(cuuint64_t)D, (cuuint64_t)TT, 1};
  const cuuint64_t bs[2] = {(cuuint64_t)bc_stride * 2,
                            (cuuint64_t)bc_stride * 2 * TT};
  const cuuint64_t yd[3] = {(cuuint64_t)D, (cuuint64_t)TT, (cuuint64_t)H};
  const cuuint64_t ys[2] = {(cuuint64_t)H * D * 4, (cuuint64_t)D * 4};
  const cuuint64_t sd[3] = {(cuuint64_t)D, (cuuint64_t)D,
                            (cuuint64_t)(TT / kL + R) * H};
  const cuuint64_t ss[2] = {(cuuint64_t)D * 4, (cuuint64_t)D * D * 4};
  CUtensorMap mx, mb, mc, mdy, ms;
  if (!make_map<D>(&mx, x, xd, xs, kL, 1) ||
      !make_map<D>(&mb, bm, bd, bs, kL, 1) ||
      !make_map<D>(&mc, cm, bd, bs, kL, 1) ||
      !make_map_f32(&mdy, dy, yd, ys, kL) ||
      !make_map_f32(&ms, states, sd, ss, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_log);
  const int* rs = static_cast<const int*>(row_start);
  const int* rl = static_cast<const int*>(row_len);
  int* sy = static_cast<int*>(sync);
  cudaError_t err;
  if (blocks_a > 0) {
    err = cudaFuncSetAttribute(mamba_bwd_states_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SmemA<D>::kBytes);
    if (err != cudaSuccess) return (int)err;
    mamba_bwd_states_kernel<D>
        <<<blocks_a, kT, SmemA<D>::kBytes, stream>>>(
            mx, mb, dtf, af, rs, rl, static_cast<float*>(states), sy, R, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(mamba_bwd_chunk_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemB<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  mamba_bwd_chunk_kernel<D><<<blocks_b, kT, SmemB<D>::kBytes, stream>>>(
      mx, mb, mc, mdy, ms, dtf, af, rs, rl, static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<float*>(carry),
      static_cast<float*>(parts), static_cast<float*>(da_part),
      static_cast<bf16*>(dx), static_cast<bf16*>(dbm),
      static_cast<bf16*>(dcm), static_cast<float*>(ddt),
      static_cast<float*>(da_log), sy, TT, R, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of y = scan(x, bm, cm, dt, a_log) over the rows, zero initial
// states, for the upstream gradient dy (TT, H, D) fp32 contiguous. Inputs
// as mamba_scan_varlen takes them (x (TT, H, D) and bm, cm (TT, D) bf16
// with token strides x_stride and bc_stride, multiples of 8, 16-byte
// aligned). Outputs, contiguous, every element written (0 on tokens in no
// row): dx (TT, H, D) bf16, dbm and dcm (TT, D) bf16, ddt (TT, H) fp32,
// da_log (H,) fp32. Scratch, uninitialised: states (TT / 64 + R, H, D, D),
// carry (R, H, D, D), parts (2, TT, ceil(H / 4), D) and da_part
// (TT / 64 + R, H), all fp32. sync holds 32 + R * H + TT / 64 + R int32
// that must be zero; the launches leave them zero. blocks_a >= (TT / 256
// + R) * H, blocks_b >= ceil(TT / 16) + (TT / 64 + R) * ceil(H / 4).
// Returns a cudaError_t code (0 on successful launches); nothing
// synchronises. D (P == N) is 16, 32 or 64.
extern "C" int mamba_scan_bwd(const void* x, int64_t x_stride, const void* bm,
                              const void* cm, int64_t bc_stride,
                              const void* dt, const void* a_log,
                              const void* row_start, const void* row_len,
                              const void* dy, void* dx, void* dbm, void* dcm,
                              void* ddt, void* da_log, void* states,
                              void* carry, void* parts, void* da_part,
                              void* sync, int TT, int R, int H, int D,
                              int blocks_a, int blocks_b, void* stream) {
  if (R < 1 || H < 1 || TT < 1 ||
      blocks_a < (TT / kL / kKA + R) * H ||
      blocks_b < (TT + kZeroTile - 1) / kZeroTile +
                     (TT / kL + R) * ((H + kGroup - 1) / kGroup))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define MAMBA_BWD(DD)                                                         \
  if (D == DD)                                                                \
    return launch<DD>(x, x_stride, bm, cm, bc_stride, dt, a_log, row_start,  \
                      row_len, dy, dx, dbm, dcm, ddt, da_log, states, carry, \
                      parts, da_part, sync, TT, R, H, blocks_a, blocks_b,    \
                      cs);
  MAMBA_BWD(16)
  MAMBA_BWD(32)
  MAMBA_BWD(64)
#undef MAMBA_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
