// Weight-only quantized GEMV/GEMM for small M (A16W4 / A16W8), sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/quant_matmul.py `quant_matmul` (the
// Pallas `_kernel`), which ops/linear.py runs for every quantized projection
// with M <= 32: q/k/v/o, gate/up/down and a quantized lm_head.
//
// Math (asymmetric, w = q * scale_g + zero_g per group g of input rows):
//     out[m, n] = sum_g scale[g, n] * (bf16(x_g) . q_g)[m, n]
//                       + xsum[m, g] * zero[g, n]
// with the integer payload exact, f32 accumulation, and xsum taken over the
// f32 x (not the bf16-rounded dot operand) -- the same formulation as the
// Pallas kernel, so the plain version in ops/quant_matmul.py is its twin.
//
// What bounds it on the H100: bytes. At M <= 32 a projection does 2*M*K*N
// operations on K*N/2 (u4) or K*N (i8) payload bytes, i.e. at most 128
// operations per byte, far under the ~295 where the tensor cores would be
// the limit. The payload is the only full-size read: one decode step of
// Qwen2-7B streams ~3.98 GB, ~1.19 ms at 3.35 TB/s. Most of a step's 197
// products are small (a k/v_proj is 1 MB, ~0.3 us of bytes), so the fixed
// cost of a product counts as much as its rate.
//
// What this design does about it:
//  * One launch a product, and nothing in its chunk loop but shared-memory
//    reads, the dequant and the mma: a producer warp streams each chunk's
//    payload (up to 64 K-rows x 128 bytes a box, the 128B swizzle), its x
//    columns and, where the chunk ends a quant group, the group's scale and
//    zero rows of the block's columns, all by 2-D TMA / bulk copies on a
//    ring of full / empty mbarriers (~100 KB a block, two blocks an SM). No x
//    records, no preparation kernel, no block-wide barrier a chunk, no
//    global load in the loop. A u4 block takes two adjacent tiles where a
//    product is wide and M <= 8, so that a payload row is 256 contiguous
//    bytes, as an int8 tile's.
//  * The weights are the mma's A operand (m16n8k16: the 16 rows of an A
//    tile are output columns, none of them padding) and the batch rows its
//    n8 side: M <= 8 spends one n8 tile, M <= 16 two and M <= 32 four, so
//    one block feeds all of a product's rows from one dequantized payload.
//    At four the block's sums of finished groups live in shared memory (in
//    registers, beside the current group's, they would not fit the ~112
//    registers a thread that two blocks an SM leave). A small product at
//    M > 16 (q|o, k|v_proj) runs two blocks of 16 rows a tile instead: it
//    is bound by its latency, not by the dequant, and each block's partials
//    are then half as many to sum. A u4 byte holds column c (low nibble)
//    and c + 128 (high) in the TILE-128 layout;
//    `ldmatrix.trans` of a 16-byte unit of eight K-rows gives a lane the
//    bytes of its column pair at K-rows 2 tig, 2 tig + 1, so the low / high
//    nibbles of one byte pair are an A tile's rows gid / gid + 8, a level n
//    fed as bf16(128 + n) = 0x4300 | n in one `lop3` (the 128 * sum(bf16(x))
//    this adds is taken back off in the group affine). int8 levels are
//    exact through f32. x's B fragments come straight from its TMA'd
//    columns, and its row sums (of the f32 x and of the bf16 operand) from
//    the lanes' own B columns, summed across a lane quad where a group
//    ends.
//  * A K split that fills the card at every quant group size: chunks never
//    cross a quant group, a split is a range of chunks that may start or
//    end inside a group, and a group's affine is applied to each split's
//    part of it with that group's scale and zero (the affine is linear, so
//    this is exact up to the order of the f32 sums). The wrapper
//    (ops/quant_matmul.py `split_plan`) picks the split count, trading the
//    blocks that fill the card against the partials to sum; every (tile,
//    K row) is covered exactly once.
//  * The splits of a tile write f32 partials to the wrapper's scratch and
//    sum them without another kernel, in a fixed order: in groups of
//    `fan` splits, the block that takes a group's last ticket (an atomic
//    counter) sums the group's in split order, and the one that takes the
//    tile's last ticket sums the groups' in order and writes the output.
//    Each sets its ticket back to 0, so the result does not change from
//    run to run and CUDA-graph replays start from zero tickets. A thread
//    keeps eight loads of partials in flight whatever the rows.
//
// The wrapper owns the grid: it picks each chunk's K-rows (at most a stage's
// kStageRows), the block columns (N / (256 tb)), the slices of M and the
// split count, and the launch refuses what the kernel cannot run. The
// blocks an SM keeps resident, which the split count aims to fill, come from
// the card (`di_quant_matmul_blocks_per_sm`).

#include "di_common.cuh"

#include <cuda.h>

namespace {

using namespace di;

constexpr int kTileN = 256;      // output columns of a u4 TILE-128 tile
constexpr int kStageRows = 64;   // the most K rows a stage holds (a chunk)
constexpr int kBoxBytes = 128;   // a TMA box's width: a u4 tile row
constexpr int kWarps = 8;        // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);   // + the producer warp

// BITS-bit payload, NT n8 tiles of batch rows (8 NT x rows staged), TB
// 256-column tiles a block (2: u4 at M <= 8, so that a payload row is 256
// contiguous bytes, as an int8 tile's), f32 x (XF32) or bf16.
//   kBoxes: 128-byte TMA boxes of a payload row, 16-byte units 8 kBoxes;
//   UW: units a warp reads, kBoxes (a unit is two u4 A tiles of sixteen
//       columns, or one int8 tile);
// so a warp holds TW A tiles, 4 TW NT partial sums of the current group
// and as many of the block's sums: in registers, or at NT = 4 in shared
// memory after the ring (kSmemSums).
template <int BITS, int NT, int TB, bool XF32>
struct Geo {
  static constexpr int kBoxes = (BITS == 4 ? 1 : 2) * TB;
  static constexpr int UW = kBoxes;
  static constexpr int TW = BITS == 4 ? 2 * UW : UW;
  static constexpr int kCols = kTileN * TB;
  static constexpr int kXRows = 8 * NT;
  static constexpr int kAccStride = kCols + 8;   // f32 of the sums' rows
  static constexpr bool kSmemSums = NT == 4;
  static constexpr int kSumsBytes = kSmemSums ? kXRows * kAccStride * 4 : 0;
  // two blocks an SM
  static constexpr int kRingBytes = 108 * 1024 - kSumsBytes;
  // a stage: payload, x (f32: two boxes of 32 columns), qparams
  static constexpr int kW = kBoxes * kStageRows * kBoxBytes;
  static constexpr int kXOff = kW;
  static constexpr int kXBytes = (XF32 ? 2 : 1) * kXRows * kBoxBytes;
  static constexpr int kQpOff = kXOff + kXBytes;
  static constexpr int kStage = kQpOff + 2 * kCols * 4;
  static constexpr int kStages = kRingBytes / kStage;
  // after the ring (whose first bytes take the block's sums at its end,
  // unless they have their own place): the sums, the mbarriers, a flag
  static constexpr int kSumsOff = kStages * kStage;
  static constexpr int kBarOff = kSumsOff + kSumsBytes;
  static constexpr int kSmem = 1024 + kBarOff + 16 * kStages + 16;
  static_assert(kStages >= 2, "a ring of two stages at least");
};

struct Params {
  const float* scale;
  const float* zero;
  void* out;
  float* partial;        // [block columns][splits][M][256 TB] (splits > 1)
  unsigned* tickets;     // [block columns][groups + 1], zero between
                         // launches
  int* status;           // a ring wait that gave up (kRingTimeout)
  unsigned long long* launches;
  int out_bf16, M, N, G, gs, rows, cpg, splits, fan;
};

// 2-D TMA copy of box (c0, c1) of `map` into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// ldmatrix of two 8x8 b16 matrices, transposed (ldmatrix_x4_trans's half):
// lane (gid, tig) gets element gid of rows 2 tig (low half) and 2 tig + 1
// of each.
__device__ __forceinline__ void ldsm_t2(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// Byte `b` of row `r` of a box stored with the 128B swizzle: 16-byte unit
// u of row r sits at unit u ^ (r % 8).
__device__ __forceinline__ int swz(int r, int b) {
  return r * kBoxBytes + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

// four consecutive outputs from element i (a multiple of 4)
__device__ __forceinline__ void store4(void* out, int bf16, size_t i,
                                       float4 v) {
  if (bf16) {
    uint2 h;
    h.x = pack_bf16(v.x, v.y);
    h.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) = h;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = v;
  }
}

// The chunks of a block, in order: the i-th is K-rows [k0, k0 + rows) of
// quant group g, and the last of its group in the block when `ends`.
struct Cursor {
  int g, kc, i, n;
  __device__ Cursor(const Params& p, int c0, int n_)
      : g(c0 / p.cpg), kc(c0 % p.cpg), i(0), n(n_) {}
  __device__ int k0(const Params& p) const { return g * p.gs + kc * p.rows; }
  __device__ int rows(const Params& p) const {
    return min(p.rows, p.gs - kc * p.rows);
  }
  __device__ bool ends(const Params& p) const {
    return kc == p.cpg - 1 || i == n - 1;
  }
  __device__ void next(const Params& p) {
    ++i;
    if (++kc == p.cpg) {
      kc = 0;
      ++g;
    }
  }
};

// grid = (N / (256 TB), splits, slices); block = 8 consumer warps + 1
// producer warp. Block (bx, split, z) runs chunks [split * C / splits,
// (split + 1) * C / splits) of the C = G * cpg chunks of its TB tiles, for
// x rows [8 NT z, 8 NT (z + 1)).
//
// Consumer warp w reads units uw0 = UW w .. uw0 + UW - 1 of the 8 kBoxes
// units of the payload rows (unit U: box U / 8, bytes 16 (U % 8) ..), at
// every k16 step of a chunk. Its A tile (unit U, t) has rows gid / gid + 8
// = the block's columns
//   u4 (t = 0, 1): 256 (U / 8) + 16 (U % 8) + 2 gid + t, and + 128;
//   int8:          16 U + 2 gid, and + 1.
// Its C fragments (c0, c1 row gid, c2, c3 row gid + 8) are batch rows
// 8 nt + 2 tig, + 1.
template <int BITS, int NT, int TB, bool XF32>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap xmap, const Params p) {
  using Gm = Geo<BITS, NT, TB, XF32>;
  constexpr int kStages = Gm::kStages, TW = Gm::TW, UW = Gm::UW;
  constexpr int kCols = Gm::kCols;
  constexpr float kOffset = BITS == 4 ? 128.f : 0.f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Gm::kBarOff);
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(empty + kStages);

  const int tile = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  if (tile == 0 && split == 0 && blockIdx.z == 0 && tid == 0)
    atomicAdd(p.launches, 1ull);
  // the block's x rows [m0, m0 + mz), and its (columns, rows) slice's
  // index among the partials and tickets
  const int m0 = Gm::kXRows * blockIdx.z;
  const int mz = min(Gm::kXRows, p.M - m0);
  const int slice = tile + gridDim.x * blockIdx.z;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = p.G * p.cpg;
  const int c0 = (int)((long long)split * C / p.splits);
  const int n = (int)((long long)(split + 1) * C / p.splits) - c0;
  const int col_base = tile * kCols;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the block's sums (those in registers: at the end)
  float* acc = reinterpret_cast<float*>(smem + Gm::kSumsOff * Gm::kSmemSums);

  // this lane's columns (block-local) of A tile t, row half h
  const int uw0 = UW * warp;
  auto col_of = [&](int t, int h) {
    const int U = BITS == 4 ? uw0 + t / 2 : uw0 + t;
    return BITS == 4 ? 256 * (U >> 3) + 128 * h + 16 * (U & 7) + 2 * gid +
                           (t & 1)
                     : 16 * U + 2 * gid + h;
  };

  if (warp == kWarps) {   // the producer: one lane issues every copy
    if (lane == 0) {
      const int xbytes = Gm::kXBytes;
      const int wbytes = Gm::kBoxes * p.rows * kBoxBytes;
      // chunk i's payload, x columns and (where it ends a group) qparams on
      // stage i % kStages, once the consumers have freed it
      for (Cursor cu(p, c0, n); cu.i < n; cu.next(p)) {
        const int s = cu.i % kStages;
        if (cu.i >= kStages)
          mbar_wait(empty + s, (cu.i / kStages - 1) & 1, p.status);
        uint8_t* st = smem + s * Gm::kStage;
        const bool ends = cu.ends(p);
        const int k0 = cu.k0(p);
        mbar_arrive_tx(full + s,
                       wbytes + xbytes + (ends ? 2 * kCols * 4 : 0));
#pragma unroll
        for (int bx = 0; bx < Gm::kBoxes; ++bx)
          tma_2d(st + bx * kStageRows * kBoxBytes, &wmap,
                 (tile * Gm::kBoxes + bx) * kBoxBytes, k0, full + s);
        if (ends) {
          const size_t q = (size_t)cu.g * p.N + col_base;
          bulk_g2s(st + Gm::kQpOff, p.scale + q, kCols * 4, full + s);
          bulk_g2s(st + Gm::kQpOff + kCols * 4, p.zero + q, kCols * 4,
                   full + s);
        }
        tma_2d(st + Gm::kXOff, &xmap, k0, m0, full + s);
        if (XF32)
          tma_2d(st + Gm::kXOff + Gm::kXRows * kBoxBytes, &xmap, k0 + 32, m0,
                 full + s);
      }
    }
  } else {
    // xq, xf: this lane's sums of its B columns of x row 8 nt + gid, of
    // the bf16 operand and (f32 x) of x itself; its elements of the block's
    // sums (`sums` or acc[at(..)]): rows 8 nt + 2 tig + (j & 1), columns
    // col_of(t, j / 2)
    float part[TW][NT][4], sums[TW][NT][4], xq[NT], xf[NT];
    auto at = [&](int nt, int t, int j) {
      return (8 * nt + 2 * tig + (j & 1)) * Gm::kAccStride +
             col_of(t, j >> 1);
    };
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      xq[nt] = xf[nt] = 0.f;
#pragma unroll
      for (int t = 0; t < TW; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[t][nt][j] = sums[t][nt][j] = 0.f;
          if (Gm::kSmemSums) acc[at(nt, t, j)] = 0.f;
        }
    }
    // ldmatrix rows: lane l gives row l % 8 of matrix l / 8 (unit
    // uw0 + l / 16 of the warp's units, K-rows 8 ((l / 8) % 2) + l % 8 of
    // the k16 step)
    const int lm_row = 8 * ((lane >> 3) & 1) + (lane & 7);
    const int lm_unit = uw0 + (UW == 2 ? lane >> 4 : 0);
    const int lm_off = (lm_unit >> 3) * kStageRows * kBoxBytes +
                       swz(lm_row, 16 * (lm_unit & 7));

    // k16 step ks of a chunk in stage `st`; `masked`: the chunk holds only
    // `rows` K-rows (a group's last), so x's K-rows past them are zero
    auto dot_step = [&](const uint8_t* st, int ks, int rows, bool masked) {
      uint32_t a[TW][4];
      {
        uint32_t r[4];
        if (UW == 2)
          ldmatrix_x4_trans(r, st + 16 * ks * kBoxBytes + lm_off);
        else
          ldsm_t2(r, st + 16 * ks * kBoxBytes + lm_off);
#pragma unroll
        for (int u = 0; u < UW; ++u) {
          // K-rows 0-7 and 8-15 of the step, bytes (2 gid, 2 gid + 1)
          const uint32_t r0 = r[2 * u], r8 = r[2 * u + 1];
          if (BITS == 4) {
            a[2 * u][0] = u4_lo(r0);
            a[2 * u][1] = u4_hi(r0);
            a[2 * u][2] = u4_lo(r8);
            a[2 * u][3] = u4_hi(r8);
            a[2 * u + 1][0] = u4_lo(r0 >> 8);
            a[2 * u + 1][1] = u4_hi(r0 >> 8);
            a[2 * u + 1][2] = u4_lo(r8 >> 8);
            a[2 * u + 1][3] = u4_hi(r8 >> 8);
          } else {
            const uint32_t l = r0 ^ 0x80808080u, h = r8 ^ 0x80808080u;
            a[u][0] = pack_bf16(i8_level(l, 0), i8_level(l, 2));
            a[u][1] = pack_bf16(i8_level(l, 1), i8_level(l, 3));
            a[u][2] = pack_bf16(i8_level(h, 0), i8_level(h, 2));
            a[u][3] = pack_bf16(i8_level(h, 1), i8_level(h, 3));
          }
        }
      }
      // B: x rows 8 nt + gid, K-rows 16 ks + 2 tig, + 1 (b0) and + 8, + 9
      // (b1)
      const int kb = 16 * ks + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int xr = 8 * nt + gid;
        uint32_t b0, b1;
        if (!XF32) {
          const uint8_t* xs = st + Gm::kXOff;
          b0 = *reinterpret_cast<const uint32_t*>(xs + swz(xr, 2 * kb));
          b1 = *reinterpret_cast<const uint32_t*>(xs + swz(xr, 2 * kb + 16));
          if (masked) {
            if (kb >= rows) b0 = 0u;
            else if (kb + 1 >= rows) b0 &= 0xFFFFu;
            if (kb + 8 >= rows) b1 = 0u;
            else if (kb + 9 >= rows) b1 &= 0xFFFFu;
          }
          xq[nt] += (__uint_as_float(b0 << 16) +
                     __uint_as_float(b0 & 0xFFFF0000u)) +
                    (__uint_as_float(b1 << 16) +
                     __uint_as_float(b1 & 0xFFFF0000u));
        } else {   // f32 x: box kb / 32, bytes 4 (kb % 32) of its row
          const uint8_t* xs =
              st + Gm::kXOff + (kb >> 5) * Gm::kXRows * kBoxBytes;
          float2 v0 = *reinterpret_cast<const float2*>(
              xs + swz(xr, 4 * (kb & 31)));
          float2 v1 = *reinterpret_cast<const float2*>(
              xs + swz(xr, 4 * (kb & 31) + 32));
          if (masked) {
            if (kb >= rows) v0.x = 0.f;
            if (kb + 1 >= rows) v0.y = 0.f;
            if (kb + 8 >= rows) v1.x = 0.f;
            if (kb + 9 >= rows) v1.y = 0.f;
          }
          xf[nt] += (v0.x + v0.y) + (v1.x + v1.y);
          xq[nt] += (bf16_round(v0.x) + bf16_round(v0.y)) +
                    (bf16_round(v1.x) + bf16_round(v1.y));
          b0 = pack_bf16(v0.x, v0.y);
          b1 = pack_bf16(v1.x, v1.y);
        }
#pragma unroll
        for (int t = 0; t < TW; ++t)
          mma_bf16_16816(part[t][nt], a[t], b0, b1);
      }
    };

    for (Cursor cu(p, c0, n); cu.i < n; cu.next(p)) {
      const int s = cu.i % kStages;
      mbar_wait(full + s, (cu.i / kStages) & 1, p.status);
      const uint8_t* st = smem + s * Gm::kStage;
      const int rows = cu.rows(p);
      if (rows == kStageRows) {   // a full chunk: four steps, unrolled
#pragma unroll
        for (int ks = 0; ks < kStageRows / 16; ++ks)
          dot_step(st, ks, rows, false);
      } else {
        for (int ks = 0; ks < (rows + 15) / 16; ++ks)
          dot_step(st, ks, rows, 16 * ks + 16 > rows);
      }

      if (cu.ends(p)) {   // the affine of this warp's part of the group
        const float* sc = reinterpret_cast<const float*>(st + Gm::kQpOff);
        const float* ze = sc + kCols;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // the sums of rows 8 nt + 2 tig + e (the C fragments' rows):
          // row 8 nt + gid's over its lane quad, then from quad 2 tig + e
          float q = xq[nt];
          q += __shfl_xor_sync(0xffffffffu, q, 1);
          q += __shfl_xor_sync(0xffffffffu, q, 2);
          const float xb[2] = {__shfl_sync(0xffffffffu, q, 8 * tig),
                               __shfl_sync(0xffffffffu, q, 8 * tig + 4)};
          float xs[2] = {xb[0], xb[1]};
          if (XF32) {
            float v = xf[nt];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            xs[0] = __shfl_sync(0xffffffffu, v, 8 * tig);
            xs[1] = __shfl_sync(0xffffffffu, v, 8 * tig + 4);
          }
          xq[nt] = xf[nt] = 0.f;
#pragma unroll
          for (int t = 0; t < TW; ++t)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = col_of(t, j >> 1);
              const float v =
                  (part[t][nt][j] - kOffset * xb[j & 1]) * sc[c] +
                  xs[j & 1] * ze[c];
              if (Gm::kSmemSums)
                acc[at(nt, t, j)] += v;
              else
                sums[t][nt][j] += v;
              part[t][nt][j] = 0.f;
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);   // the stage is free
    }
    if (!Gm::kSmemSums) {
      // the sums into the ring's first bytes, every consumer warp done
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int t = 0; t < TW; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[at(nt, t, j)] = sums[t][nt][j];
    }
  }

  // the block's sums: the output, or the split's partial
  __syncthreads();
  constexpr int kRow4 = kCols / 4;   // float4s of a row
  constexpr int kSlot4 = Gm::kXRows * kRow4;   // of a partial slot
  const int n4 = mz * kRow4;         // of the block's output rows
  auto out_at = [&](int e) {
    return (size_t)(m0 + e / kRow4) * p.N + col_base + 4 * (e % kRow4);
  };
  float4* pt = reinterpret_cast<float4*>(p.partial) +
               (size_t)slice * p.splits * kSlot4;
  for (int e = tid; e < n4; e += kThreads) {
    const float4 v = *reinterpret_cast<const float4*>(
        acc + (e / kRow4) * Gm::kAccStride + 4 * (e % kRow4));
    if (p.splits == 1)
      store4(p.out, p.out_bf16, out_at(e), v);
    else
      pt[(size_t)split * kSlot4 + e] = v;
  }
  if (p.splits == 1) return;

  // The splits' partials are summed in split order, in groups of `fan`:
  // the last split of a group to finish sums the group's into its first
  // slot, the last group to finish sums the groups' into the output. Each
  // ticket is set back to 0 by the block that takes its last number.
  const int ngroups = (p.splits + p.fan - 1) / p.fan;
  unsigned* tk = p.tickets + (size_t)slice * (ngroups + 1);
  // sum of slots first, first + stride, .. (count), into `dst` (a slot or,
  // null, the output). A thread takes float4s tid + kThreads r (r < kE) of
  // every slot, kU slots a round: eight loads in flight, summed in order.
  constexpr int kE = (Gm::kXRows * kRow4 + kThreads - 1) / kThreads;
  constexpr int kU = kE >= 8 ? 1 : 8 / kE;
  auto sum_slots = [&](int first, int count, int stride, float4* dst) {
    __threadfence();   // the slots, seen after their tickets
    float4 s[kE];
#pragma unroll
    for (int r = 0; r < kE; ++r) s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < count; k0 += kU) {
      float4 v[kU][kE];
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          const int e = tid + kThreads * r;
          if (k0 + u < count && e < n4)
            v[u][r] =
                __ldcg(pt + (size_t)(first + (k0 + u) * stride) * kSlot4 + e);
        }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < kE; ++r)
          if (k0 + u < count) {
            s[r].x += v[u][r].x;
            s[r].y += v[u][r].y;
            s[r].z += v[u][r].z;
            s[r].w += v[u][r].w;
          }
    }
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int e = tid + kThreads * r;
      if (e >= n4) break;
      if (dst != nullptr)
        dst[e] = s[r];
      else
        store4(p.out, p.out_bf16, out_at(e), s[r]);
    }
  };
  auto last_of = [&](unsigned* ticket, int count) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      *last = atomicAdd(ticket, 1u) == (unsigned)count - 1;
      if (*last) *ticket = 0u;   // for the next launch or replay
    }
    __syncthreads();
    return *last != 0;
  };
  const int g = split / p.fan, g0 = g * p.fan;
  const int members = min(p.fan, p.splits - g0);
  if (!last_of(tk + g, members)) return;
  if (ngroups == 1) {
    sum_slots(0, p.splits, 1, nullptr);
    return;
  }
  sum_slots(g0, members, 1, pt + (size_t)g0 * kSlot4);
  if (!last_of(tk + ngroups, ngroups)) return;
  sum_slots(0, ngroups, p.fan, nullptr);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// A 2-D map of `rows` x `cols` elements of `esize` bytes (row stride
// `cols`), boxes of `bw` x `bh`, the 128B swizzle.
bool make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
              int esize, const void* base, int cols, int rows, int bw,
              int bh) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)bh};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BITS, int NT, int TB, bool XF32>
int launch(const void* x, const void* w, const Params& p, int K,
           int slices, cudaStream_t stream) {
  using Gm = Geo<BITS, NT, TB, XF32>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap wmap, xmap;
  if (!make_map(&wmap, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w,
                BITS == 4 ? p.N / 2 : p.N, K, kBoxBytes, p.rows) ||
      !(XF32 ? make_map(&xmap, encode, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        x, K, p.M, 32, Gm::kXRows)
             : make_map(&xmap, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        x, K, p.M, 64, Gm::kXRows)))
    return -1;
  const cudaError_t attr = cudaFuncSetAttribute(
      qmm_kernel<BITS, NT, TB, XF32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Gm::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  qmm_kernel<BITS, NT, TB, XF32>
      <<<dim3(p.N / Gm::kCols, p.splits, slices), kThreads, Gm::kSmem,
         stream>>>(
          wmap, xmap, p);
  return (int)cudaGetLastError();
}

// The blocks of this instantiation an SM keeps resident, into `*blocks`
// where fewer.
template <int BITS, int NT, int TB, bool XF32>
int resident(int* blocks) {
  using Gm = Geo<BITS, NT, TB, XF32>;
  cudaError_t rc = cudaFuncSetAttribute(
      qmm_kernel<BITS, NT, TB, XF32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
  int n = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, qmm_kernel<BITS, NT, TB, XF32>, kThreads, Gm::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  if (n < *blocks) *blocks = n;
  return 0;
}

// Every instantiation: X(bits, n8 tiles, tiles a block)
#define DI_QMM_VARIANTS(X) \
  X(4, 1, 2) X(4, 1, 1) X(4, 2, 1) X(4, 4, 1) X(8, 1, 1) X(8, 2, 1) X(8, 4, 1)

}  // namespace

// The fewest blocks an SM keeps resident of any instantiation, on the
// current device (the wrapper's split plans fill the card with as many).
extern "C" int di_quant_matmul_blocks_per_sm(int* blocks) {
  *blocks = 1 << 30;
  int rc = 0;
#define DI_QMM(B, T, TB)                                     \
  if (rc == 0) rc = resident<B, T, TB, true>(blocks);        \
  if (rc == 0) rc = resident<B, T, TB, false>(blocks);
  DI_QMM_VARIANTS(DI_QMM)
#undef DI_QMM
  return rc;
}

// x: [M, K] bf16 (x_bf16=1) or f32, 16-byte aligned, K % 8 == 0; w:
// [K, N/2] u4 TILE-128 (bits=4) or [K, N] int8 (bits=8), 16-byte aligned;
// scale/zero: [G, N] f32; out: [M, N] bf16 (out_bf16=1) or f32. The grid
// (ops/quant_matmul.py `split_plan`): `cols` blocks across N of tb tiles
// each (2: u4, M <= 8), `slices` across M (1, or 2 of 16 rows), `splits`
// of K a tile, `rows` K-rows a chunk (at most kStageRows, and no more than
// a quant group), partials summed in groups of `fan`. partial: [slices,
// cols, splits, rows a block, 256 tb] f32 scratch and tickets: [slices,
// cols, ceil(splits / fan) + 1] zeroed counters when splits > 1;
// status: an int the ring's waits mark if they give up; launches: a device
// counter that each launch adds one to (so CUDA graph replays count).
// Requires 1 <= M <= 32, K % G == 0. The caller validates the operands;
// a grid the kernel cannot run is refused here. Returns the launch's CUDA
// error, or -1 when a tensor map cannot be made.
extern "C" int di_quant_matmul(const void* x, int x_bf16, const void* w,
                               int bits, const float* scale,
                               const float* zero, void* out, int out_bf16,
                               float* partial, unsigned* tickets, int* status,
                               int M, int K, int N, int G, int rows,
                               int cols, int slices, int splits, int fan,
                               int tb,
                               unsigned long long* launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 32 || cols * kTileN * tb != N || K % 8 || G < 1 ||
      K % G || (tb != 1 && (tb != 2 || bits != 4 || M > 8)) || rows < 1 ||
      rows > kStageRows || rows > K / G || splits < 1 || fan < 1 ||
      splits > G * ((K / G + rows - 1) / rows) || (bits != 4 && bits != 8) ||
      (slices != 1 && (slices != 2 || M <= 16)))
    return (int)cudaErrorInvalidValue;
  const int gs = K / G;
  const Params p{scale, zero, out, partial, tickets, status, launches,
                 out_bf16, M, N, G, gs, rows,
                 (gs + rows - 1) / rows, splits, fan};
  const int mb = (M + slices - 1) / slices;   // x rows a block, at most
  const int nt = mb <= 8 ? 1 : mb <= 16 ? 2 : 4;   // n8 tiles of them
  const bool f = !x_bf16;
#define DI_QMM(B, T, TB)                                             \
  if (bits == B && nt == T && tb == TB)                              \
    return f ? launch<B, T, TB, true>(x, w, p, K, slices, s)         \
             : launch<B, T, TB, false>(x, w, p, K, slices, s);
  DI_QMM_VARIANTS(DI_QMM)
#undef DI_QMM
  return (int)cudaErrorInvalidValue;
}
