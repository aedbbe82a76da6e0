// Mamba2 SSD chunk scan for Hopper (sm_90a) over ragged token runs ("rows"),
// each with its own carried state: the chunk products on the tensor cores
// (wgmma), the chunks of one row spread over blocks that pass the state
// along in order, and a light path for one-token rows.
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
// [row_start[r], row_start[r] + row_len[r]) of one token stream (not
// overlapping, not necessarily covering it), an fp32 initial state per row
// (s0) and the final state per row out (s1). A row of length 0 copies its
// state through bit for bit; y is zero outside every row.
//   x (TT, H, P) bf16, token stride x_stride (H*P inner elements contiguous);
//   bm, cm (TT, N) bf16, token stride bc_stride; dt (TT, H) fp32 (after
//   softplus); a_log (H,) fp32; row_start, row_len (R,) int32;
//   s0 (R, H, P, N) fp32 with row stride s0_stride; y (TT, H, P) fp32;
//   s1 (R, H, P, N) fp32 with row stride s1_stride (not aliasing s0).
//
// Design.
//  * Work items, found on the device: the host never sees row_len (the
//    serve path runs without a host sync). Row r has max(1, ceil(len / 64))
//    chunk units, at most TT / 64 + R over all rows, and each unit is split
//    into its H heads; the host sizes the grid from that bound, plus one
//    block per 16-token tile of y. A block draws a ticket (atomicAdd on a
//    self-resetting per-stream counter): tickets below the tile count zero
//    the tile's tokens that lie in no row; the rest map, by a block scan
//    over the row lengths, to (row, chunk, head) in row and chunk order,
//    and blocks past the real count exit.
//  * Chunks of one row run in parallel. A chunk block computes everything
//    that does not need the incoming state (the intra-chunk output, the
//    chunk's state contribution dS, its decay), then waits for its
//    predecessor's flag for that head, forms S_c = S_{c-1} exp(lc_last) + dS
//    in s1, publishes it (the row's last chunk resets the flag to 0, so the
//    flags stay zero between launches), and adds exp(lc_t) C_t . S_{c-1} to
//    y. A block waits only on a block with a smaller ticket, which has
//    started: no block can starve its predecessor. Every sum has a fixed
//    order and no atomic touches the data, so two calls give the same bytes.
//  * One head a block. C B^T is a bf16 wgmma, exact into fp32, and the
//    decay mask goes on with selects. (Blocks that shared C B^T over a
//    group of heads won on the H100 only on decode steps, which the host
//    cannot tell apart without a sync: more blocks beat sharing it;
//    PERF.md.) The other three products (score @ x, (sfac x)^T B, C S^T)
//    are bf16 wgmmas too: x, B and C enter as they are, and each fp32
//    operand (the scores, sfac x, the state) enters as a bf16 hi + lo
//    pair, two products each (relative error ~2^-17; the CPU emulation in
//    tests/test_torch_mamba.py found one bf16 rounding of any of them too
//    coarse for the card's 1e-3 tolerance). The state itself stays fp32
//    in registers and in s1.
//  * TMA copies B, C and the head's x tile (64 tokens, strided views of the
//    serve path's xbc row) into swizzled shared memory, x on a barrier of
//    its own that C B^T and the scores do not wait for. P = 128 is two
//    64-wide halves of the head.
//  * One-token rows take a light path: S' = S exp(dt a) + dt x B^T, y =
//    C . S', 16-byte state loads and stores, y reduced across lanes.
//    Zero-length rows copy their state.
//  * The cumulative log-decay is a warp scan.
//
// What bounds it on the H100. Per token and head it reads P bf16 values of x
// and writes P fp32 values of y, and per row and head it reads and writes the
// P x N fp32 state; the FLOPs are a few per byte, far below the ~295
// FLOP/byte balance point, so the bound is the bytes at 3.35 TB/s. A call is
// short (a few to tens of microseconds), so what keeps it from the bound is
// latency: each chunk block's chain of TMA, products and the state hand-off,
// and the serial state pass along a long row's chunks.

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kScanThreads = 128;   // one warpgroup
constexpr int kL = 64;              // chunk length
constexpr int kZeroTile = 16;       // tokens of y a zeroing block checks
constexpr int kFlagBase = 32;       // sync[0] is the ticket; flags follow

constexpr uint32_t align1k(uint32_t v) { return (v + 1023u) / 1024u * 1024u; }

template <int P, int N>
struct ScanSmem {
  static constexpr int kPh = P < 64 ? P : 64;   // rows of a head half
  static constexpr uint32_t kTileBC = kL * N * 2;
  static constexpr uint32_t kTileX = kL * P * 2;
  static constexpr uint32_t kTileS = kPh * N * 2;
  static constexpr uint32_t kB = 0;
  static constexpr uint32_t kC = kB + align1k(kTileBC);
  static constexpr uint32_t kX = kC + align1k(kTileBC);
  static constexpr uint32_t kShi = kX + align1k(kTileX);
  static constexpr uint32_t kSlo = kShi + align1k(kTileS);
  static constexpr uint32_t kDt = kSlo + align1k(kTileS);   // [64] fp32
  static constexpr uint32_t kLc = kDt + kL * 4;             // [4][lc, sfac]
  static constexpr uint32_t kBars = kLc + 4 * 2 * kL * 4;
  static constexpr uint32_t kBytes = kBars + 64 + 1024;
};

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

// Byte offset of (row, col) in a swizzled TMA tile of ROWS rows x D bf16
// (column chunks of Geo<D>::kCw, ROWS rows apart), as load_frags reads it.
template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  using Gm = Geo<D>;
  const uint32_t off = (col / Gm::kCw) * ROWS * Gm::kW + row * Gm::kW +
                       (col % Gm::kCw) * 2;
  return off ^ (((off >> 7) & (Gm::kW / 16 - 1)) << 4);
}

// Zero rows cl .. 63 of a 64-row TMA tile of D columns (tokens past a
// row's end: whatever the stream holds there never enters a product).
template <int D>
__device__ __forceinline__ void zero_tail(uint8_t* tile, int cl, int tid) {
  using Gm = Geo<D>;
  constexpr int kUnits = Gm::kW / 16;
  const int n = Gm::kChunks * (kL - cl) * kUnits;
  for (int e = tid; e < n; e += kScanThreads) {
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

// ------------------------------------------------------------ light paths
// Row of length 0: the head's state copied bit for bit.
template <int P, int N>
__device__ void copy_state(const float* s0, float* s1, int tid) {
  for (int e = tid; e < P * N / 4; e += kScanThreads) {
    reinterpret_cast<float4*>(s1)[e] =
        __ldg(reinterpret_cast<const float4*>(s0) + e);
  }
}

// Row of length 1 (token tok), head h, s0 / s1 at the head's state:
// S' = S exp(dt a) + dt x B^T, y = C . S'.
// Thread tid owns columns n0 .. n0 + 3 (the same in every step, as 512 is a
// multiple of N) of rows p = (4 tid + 512 k) / N; the N / 4 lanes of a row
// are neighbours in one warp and add up y[p] with shuffles.
template <int P, int N>
__device__ void one_token(const bf16* x, int64_t x_stride, const bf16* bm,
                          const bf16* cm, int64_t bc_stride, const float* dt,
                          const float* a_log, const float* s0, float* y,
                          float* s1, int tok, int H, int h, int tid) {
  constexpr int kVecs = P * N / 4;
  constexpr int kIt = (kVecs + kScanThreads - 1) / kScanThreads;
  constexpr int kBatch = kIt < 8 ? kIt : 8;   // float4 loads in flight
  constexpr int kLanes = N / 4;
  const bool live = tid < kVecs;
  const int n0 = (4 * tid) % N;
  float bv[4], cv[4];
  {
    const uint2 b = *reinterpret_cast<const uint2*>(bm + tok * bc_stride + n0);
    const uint2 c = *reinterpret_cast<const uint2*>(cm + tok * bc_stride + n0);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
    bv[0] = __low2float(b2[0]);
    bv[1] = __high2float(b2[0]);
    bv[2] = __low2float(b2[1]);
    bv[3] = __high2float(b2[1]);
    cv[0] = __low2float(c2[0]);
    cv[1] = __high2float(c2[0]);
    cv[2] = __low2float(c2[1]);
    cv[3] = __high2float(c2[1]);
  }
  const float d = dt[(int64_t)tok * H + h];
  const float dec = expf(d * -expf(a_log[h]));
  const float4* src = reinterpret_cast<const float4*>(s0) + tid;
  float4* dst = reinterpret_cast<float4*>(s1) + tid;
  const bf16* xr = x + tok * x_stride + h * P;
#pragma unroll 1
  for (int k0 = 0; k0 < kIt; k0 += kBatch) {
    float4 sv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (live) sv[k] = __ldg(src + 128 * (k0 + k));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int p = (4 * tid + 512 * (k0 + k)) / N;
      float part = 0.f;
      if (live) {
        const float xv = d * __bfloat162float(xr[p]);
        float4 nv;
        nv.x = fmaf(sv[k].x, dec, xv * bv[0]);
        nv.y = fmaf(sv[k].y, dec, xv * bv[1]);
        nv.z = fmaf(sv[k].z, dec, xv * bv[2]);
        nv.w = fmaf(sv[k].w, dec, xv * bv[3]);
        dst[128 * (k0 + k)] = nv;
        part = cv[0] * nv.x + cv[1] * nv.y + cv[2] * nv.z + cv[3] * nv.w;
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (live && (tid % kLanes) == 0) {
        y[((int64_t)tok * H + h) * P + p] = part;
      }
    }
  }
}

// Tokens t0 .. t0 + kZeroTile - 1 of y that lie in no row, zeroed.
__device__ void zero_gaps(float* y, const int* row_start, const int* row_len,
                          int R, int TT, int HP, int t0, unsigned* cover,
                          int tid) {
  if (tid == 0) *cover = 0u;
  __syncthreads();
  for (int r = tid; r < R; r += kScanThreads) {
    const int a = max(row_start[r], t0) - t0;
    const int b = min(row_start[r] + row_len[r], t0 + kZeroTile) - t0;
    if (a < b) atomicOr(cover, ((1u << b) - 1u) & ~((1u << a) - 1u));
  }
  __syncthreads();
  const int n = min(kZeroTile, TT - t0);
  for (int t = 0; t < n; ++t) {
    if ((*cover >> t) & 1u) continue;
    float4* row = reinterpret_cast<float4*>(y + (int64_t)(t0 + t) * HP);
    for (int e = tid; e < HP / 4; e += kScanThreads) {
      row[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ------------------------------------------------------------- the kernel
template <int P, int N>
__global__ void __launch_bounds__(kScanThreads, N < 128 ? 3 : 1)
mamba_scan_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c,
                  const bf16* __restrict__ x, int64_t x_stride,
                  const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                  int64_t bc_stride, const float* __restrict__ dt,
                  const float* __restrict__ a_log,
                  const int* __restrict__ row_start,
                  const int* __restrict__ row_len,
                  const float* __restrict__ s0, int64_t s0_stride,
                  float* __restrict__ y, float* s1, int64_t s1_stride,
                  int* sync, int TT, int R, int H) {
  using Sm = ScanSmem<P, N>;
  using Gn = Geo<N>;
  constexpr int kPh = Sm::kPh;
  constexpr int kHalves = P / kPh;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int info[4];   // ticket; row, chunk, length of the item
  __shared__ int wsum[4];
  __shared__ unsigned cover;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // ---- the ticket, and this block's work item
  const int len0 = tid < R ? row_len[tid] : 0;   // in flight with the ticket
  if (tid == 0) {
    const int w = atomicAdd(sync, 1);
    if (w == (int)gridDim.x - 1) atomicExch(sync, 0);   // all drawn: reset
    info[0] = w;
    info[1] = -1;
  }
  __syncthreads();
  const int n_tiles = (TT + kZeroTile - 1) / kZeroTile;
  const int w = info[0];
  if (w < n_tiles) {
    zero_gaps(y, row_start, row_len, R, TT, H * P, w * kZeroTile, &cover,
              tid);
    return;
  }
  const int u = (w - n_tiles) / H;   // chunk unit
  const int h = (w - n_tiles) % H;
  // the unit's row: a block scan of max(1, ceil(len / 64)) over the rows
  for (int base = 0, run = 0; base < R && run <= u; base += kScanThreads) {
    const int r = base + tid;
    const int len = base == 0 ? len0 : r < R ? row_len[r] : 0;
    const int nc = r < R ? max(1, (len + kL - 1) / kL) : 0;
    int inc = nc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int before = run, total = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      before += k < warp ? wsum[k] : 0;
      total += wsum[k];
    }
    const int excl = before + inc - nc;
    if (r < R && excl <= u && u < excl + nc) {
      info[1] = r;
      info[2] = u - excl;
      info[3] = len;
    }
    run += total;
    __syncthreads();
  }
  const int r = info[1];
  if (r < 0) return;   // past the real count of work items
  const int c = info[2], len = info[3];
  const int start = row_start[r];
  const float* s0h = s0 + (int64_t)r * s0_stride + (int64_t)h * P * N;
  float* s1h = s1 + (int64_t)r * s1_stride + (int64_t)h * P * N;
  if (len == 0) {
    copy_state<P, N>(s0h, s1h, tid);
    return;
  }
  if (len == 1) {
    one_token<P, N>(x, x_stride, bm, cm, bc_stride, dt, a_log, s0h, y, s1h,
                    start, H, h, tid);
    return;
  }

  // ---- a chunk of a row of >= 2 tokens: tokens tok0 .. tok0 + cl - 1
  const int n_chunks = (len + kL - 1) / kL;
  const int tok0 = start + c * kL;
  const int cl = min(kL, len - c * kL);
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t sb = smem_u32(sm);
  const uint32_t bar_bc = sb + Sm::kBars, bar_x = bar_bc + 8;
  float* dts = reinterpret_cast<float*>(sm + Sm::kDt);
  float* lcw = reinterpret_cast<float*>(sm + Sm::kLc) + warp * 2 * kL;
  float* sfw = lcw + kL;

  if (tid == 0) {
    bar_init(bar_bc, 1);
    bar_init(bar_x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect(bar_bc, 2 * Sm::kTileBC);
    tma_tile<N, kL>(sb + Sm::kB, &map_b, bar_bc, tok0, 0);
    tma_tile<N, kL>(sb + Sm::kC, &map_c, bar_bc, tok0, 0);
    bar_expect(bar_x, Sm::kTileX);
    tma_tile<P, kL>(sb + Sm::kX, &map_x, bar_x, tok0, h);
  }
  if (tid < kL) dts[tid] = tid < cl ? dt[(int64_t)(tok0 + tid) * H + h] : 0.f;
  __syncthreads();
  bar_wait(bar_bc, 0);
  if (cl < kL) {
    zero_tail<N>(sm + Sm::kB, cl, tid);
    fence_proxy_async();
    __syncthreads();
  }

  // C B^T: element i of this thread's accumulator is row t = 16 warp +
  // lane / 4 + 8 ((i >> 1) & 1), column s = acc_col(i, lane)
  float cb[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wgmma_ss(cb, desc_k<N, kL>(sb + Sm::kC, kk),
             desc_k<N, kL>(sb + Sm::kB, kk), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  keep(cb);
  const int t0r = 16 * warp + lane / 4;   // this thread's rows t0r, t0r + 8

  const float a = -expf(a_log[h]);
  // cumulative log-decay (a warp scan; each warp keeps its own copy)
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  float inc = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.f;
  const float l0 = ex + v0, l1 = l0 + v1;
  const float lend = __shfl_sync(0xffffffffu, l1, 31);
  lcw[2 * lane] = l0;
  lcw[2 * lane + 1] = l1;
  sfw[2 * lane] = expf(fminf(lend - l0, 0.f)) * dts[2 * lane];
  sfw[2 * lane + 1] = expf(fminf(lend - l1, 0.f)) * dts[2 * lane + 1];
  __syncwarp();
  const float lt[2] = {lcw[t0r], lcw[t0r + 8]};

  // scores, as bf16 hi + lo A fragments of score @ x
  uint32_t sh[4][4], sl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * kk + 2 * q;
      const int t = t0r + 8 * (q & 1);
      const int s = acc_col(i, lane);
      const float e0 = s <= t ? cb[i] * (expf(fminf(lt[q & 1] - lcw[s], 0.f))
                                         * dts[s]) : 0.f;
      const float e1 = s + 1 <= t
                           ? cb[i + 1] *
                                 (expf(fminf(lt[q & 1] - lcw[s + 1], 0.f)) *
                                  dts[s + 1])
                           : 0.f;
      split_pair(e0, e1, sh[kk][q], sl[kk][q]);
    }
  }

  bar_wait(bar_x, 0);
  uint8_t* xt = sm + Sm::kX;
  const uint32_t xs = smem_u32(xt);
  if (cl < kL) {
    zero_tail<P>(xt, cl, tid);
    fence_proxy_async();
    __syncthreads();
  }
  const float e_t[2] = {expf(lt[0]), expf(lt[1])};

  // P = 128's two halves: unrolled they keep N = 64 and 32 free of
  // spills, rolled N = 128 spills less (ptxas, PERF.md)
#pragma unroll (N < 128 ? kHalves : 1)
  for (int hf = 0; hf < kHalves; ++hf) {
    float yacc[kPh / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = desc_mn<P, kL>(xs, kk, hf);
      wgmma_rs<1>(yacc, sh[kk], dx, kk > 0);
      wgmma_rs<1>(yacc, sl[kk], dx, 1);
    }
    wg_commit();
    // (sfac x)^T as hi + lo A fragments: row p = 16 warp + lane / 4 (+ 8),
    // column s; rows past the head's P are zero. Built once score @ x is
    // done: the two batches' fragments never hold registers together.
    wg_wait<0>();
    keep(yacc);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = t0r + 8 * (q & 1);
        const int s = 16 * kk + 8 * (q >> 1) + 2 * (lane & 3);
        float e0 = 0.f, e1 = 0.f;
        if (p < kPh) {
          const int col = hf * 64 + p;
          e0 = sfw[s] * __bfloat162float(*reinterpret_cast<const bf16*>(
                            xt + swz<P, kL>(s, col)));
          e1 = sfw[s + 1] * __bfloat162float(*reinterpret_cast<const bf16*>(
                                xt + swz<P, kL>(s + 1, col)));
        }
        split_pair(e0, e1, ah[kk][q], al[kk][q]);
      }
    }
    float ds[Gn::kChunks][Gn::kCw / 2];
    wg_fence();
#pragma unroll
    for (int cn = 0; cn < Gn::kChunks; ++cn) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mn<N, kL>(sb + Sm::kB, kk, cn);
        wgmma_rs<1>(ds[cn], ah[kk], db, kk > 0);
        wgmma_rs<1>(ds[cn], al[kk], db, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    keep(yacc);
    keep(ds);

    // ---- the state hand-off: S_{c-1} in, S_c out, S_{c-1} to shared
    // memory as the hi + lo B operand of C S^T
    if (hf == 0 && c > 0) {
      if (tid == 0) wait_flag(sync + kFlagBase + (int64_t)r * H + h, c);
      __syncthreads();
    }
    const int64_t so = (int64_t)hf * 64 * N;
    const float* src = (c == 0 ? s0h : s1h) + so;
    float* dst = s1h + so;
    const float decay = expf(lend);
    float2 sv[Gn::kChunks][Gn::kCw / 8][2];
#pragma unroll
    for (int cn = 0; cn < Gn::kChunks; ++cn)
#pragma unroll
      for (int q = 0; q < Gn::kCw / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = t0r + 8 * e;
          const int n = cn * Gn::kCw + acc_col(4 * q, lane);
          sv[cn][q][e] = p < kPh ? __ldcg(reinterpret_cast<const float2*>(
                                       src + (int64_t)p * N + n))
                                 : make_float2(0.f, 0.f);
        }
#pragma unroll
    for (int cn = 0; cn < Gn::kChunks; ++cn)
#pragma unroll
      for (int q = 0; q < Gn::kCw / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = t0r + 8 * e;
          if (p >= kPh) continue;
          const int n = cn * Gn::kCw + acc_col(4 * q, lane);
          const float2 o = sv[cn][q][e];
          __stcg(reinterpret_cast<float2*>(dst + (int64_t)p * N + n),
                 make_float2(fmaf(o.x, decay, ds[cn][4 * q + 2 * e]),
                             fmaf(o.y, decay, ds[cn][4 * q + 2 * e + 1])));
        }
    __syncthreads();
    if (tid == 0 && hf == kHalves - 1 && n_chunks > 1) {
      // the release after the block barrier publishes every thread's
      // state stores; the row's last chunk only resets the flag
      int* flag = sync + kFlagBase + (int64_t)r * H + h;
      if (c + 1 < n_chunks) {
        publish_flag(flag, c + 1);
      } else {
        *reinterpret_cast<volatile int*>(flag) = 0;
      }
    }
#pragma unroll
    for (int cn = 0; cn < Gn::kChunks; ++cn)
#pragma unroll
      for (int q = 0; q < Gn::kCw / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = t0r + 8 * e;
          if (p >= kPh) continue;
          uint32_t hi, lo;
          split_pair(sv[cn][q][e].x, sv[cn][q][e].y, hi, lo);
          const uint32_t off = swz<N, kPh>(p, cn * Gn::kCw + acc_col(4 * q,
                                                                      lane));
          *reinterpret_cast<uint32_t*>(sm + Sm::kShi + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + Sm::kSlo + off) = lo;
        }
    fence_proxy_async();
    __syncthreads();

    // y = score @ x + exp(lc_t) C S_{c-1}^T
    uint32_t cf[N / 16][4];   // C as the A operand
    load_frags<N, kL>(sm + Sm::kC, 0, cf, warp, lane);
    float ys[kPh / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_rs<0>(ys, cf[kk], desc_k<N, kPh>(sb + Sm::kShi, kk), kk > 0);
      wgmma_rs<0>(ys, cf[kk], desc_k<N, kPh>(sb + Sm::kSlo, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    keep(ys);
#pragma unroll
    for (int q = 0; q < kPh / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0r + 8 * e;
        if (t >= cl) continue;
        const int i = 4 * q + 2 * e;
        const int p = hf * 64 + acc_col(4 * q, lane);
        *reinterpret_cast<float2*>(y + ((int64_t)(tok0 + t) * H + h) * P +
                                   p) =
            make_float2(fmaf(e_t[e], ys[i], yacc[i]),
                        fmaf(e_t[e], ys[i + 1], yacc[i + 1]));
      }
    if (hf + 1 < kHalves) __syncthreads();   // the next half rewrites S hi/lo
  }
}

template <int P, int N>
int launch(const void* x, int64_t x_stride, const void* bm, const void* cm,
           int64_t bc_stride, const void* dt, const void* a_log,
           const void* row_start, const void* row_len, const void* s0,
           int64_t s0_stride, void* y, void* s1, int64_t s1_stride,
           void* sync, int TT, int R, int H, int blocks, cudaStream_t stream) {
  using Sm = ScanSmem<P, N>;
  // x: (P, tokens, heads), a box of 64 tokens x one head; B, C: (N,
  // tokens, 1), a box of 64 tokens
  const cuuint64_t xd[3] = {(cuuint64_t)P, (cuuint64_t)TT, (cuuint64_t)H};
  const cuuint64_t xs[2] = {(cuuint64_t)x_stride * 2, (cuuint64_t)P * 2};
  const cuuint64_t bd[3] = {(cuuint64_t)N, (cuuint64_t)TT, 1};
  const cuuint64_t bs[2] = {(cuuint64_t)bc_stride * 2,
                            (cuuint64_t)bc_stride * 2 * TT};
  CUtensorMap mx, mb, mc;
  if (!make_map<P>(&mx, x, xd, xs, kL, 1) ||
      !make_map<N>(&mb, bm, bd, bs, kL, 1) ||
      !make_map<N>(&mc, cm, bd, bs, kL, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Sm::kBytes);
  if (err != cudaSuccess) return (int)err;
  mamba_scan_kernel<P, N><<<blocks, kScanThreads, Sm::kBytes, stream>>>(
      mx, mb, mc, static_cast<const bf16*>(x), x_stride,
      static_cast<const bf16*>(bm), static_cast<const bf16*>(cm), bc_stride,
      static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const int*>(row_start), static_cast<const int*>(row_len),
      static_cast<const float*>(s0), s0_stride, static_cast<float*>(y),
      static_cast<float*>(s1), s1_stride, static_cast<int*>(sync), TT, R, H);
  return (int)cudaGetLastError();
}

template <int P>
int launch_n(int N, const void* x, int64_t x_stride, const void* bm,
             const void* cm, int64_t bc_stride, const void* dt,
             const void* a_log, const void* row_start, const void* row_len,
             const void* s0, int64_t s0_stride, void* y, void* s1,
             int64_t s1_stride, void* sync, int TT, int R, int H, int blocks,
             cudaStream_t stream) {
#define MAMBA_N(NN)                                                          \
  case NN:                                                                   \
    return launch<P, NN>(x, x_stride, bm, cm, bc_stride, dt, a_log,          \
                         row_start, row_len, s0, s0_stride, y, s1, s1_stride, \
                         sync, TT, R, H, blocks, stream);
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
// elements (x_stride and bc_stride multiples of 8, s0_stride and s1_stride
// of 4; x, bm, cm, s0 and s1 16-byte aligned). sync holds 32 + R * H int32
// that must be zero; the launch leaves them zero. `blocks` blocks: at least
// ceil(TT / 16) + (TT / 64 + R) * H. Returns a cudaError_t code (0 on a
// successful launch); the launch does not synchronise. P (head dim) and N
// (state dim) are 16, 32, 64 or 128.
extern "C" int mamba_scan_varlen(const void* x, int64_t x_stride,
                                 const void* bm, const void* cm,
                                 int64_t bc_stride, const void* dt,
                                 const void* a_log, const void* row_start,
                                 const void* row_len, const void* s0,
                                 int64_t s0_stride, void* y, void* s1,
                                 int64_t s1_stride, void* sync, int TT, int R,
                                 int H, int P, int N, int blocks,
                                 void* stream) {
  if (R < 1 || H < 1 || TT < 1 ||
      blocks < (TT + kZeroTile - 1) / kZeroTile + (TT / kL + R) * H) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define MAMBA_P(PP)                                                          \
  case PP:                                                                   \
    return launch_n<PP>(N, x, x_stride, bm, cm, bc_stride, dt, a_log,        \
                        row_start, row_len, s0, s0_stride, y, s1, s1_stride, \
                        sync, TT, R, H, blocks, cs);
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
