// The layer phases of the prefill megakernel (csrc/prefill_megakernel.cu),
// shared with the tensor-parallel prefill segment kernels
// (csrc/tp_prefill_segments.cu): the argument struct, the x operand layout
// (`xoff`), the weight product of the prompt's rows (`gemm_phase`: wgmma
// with the weight-side dequantized weights as the register A operand and
// x as the 128-byte swizzled shared-memory B operand, fed by bulk copies
// on mbarriers; `product`, its one call site a kernel; the lm_head's
// one-row product `lm_row`: the decode product over K-split items that
// fill the grid, the splits summed by tickets), the residual update and
// RMSNorm of the rows, q|k|v + bias + RoPE with the quantize + write of
// the prompt's K/V
// rows, causal attention over the bf16 q / k / v scratch, SwiGLU, the
// final norm of row n - 1, the block's dynamic shared memory and the
// integer arguments the wrappers pass (ops/prefill_megakernel.py,
// ops/tp_megakernel.py). What bounds the products is the tensor cores'
// rate at S >= 256 and the L2 traffic of their stages (the x tile is
// re-read for every column tile): see the prefill kernel's header. The
// MoE phases stay in csrc/prefill_megakernel.cu.

#pragma once

#include "di_product.cuh"

namespace {

using namespace di;

constexpr int kMTile = 128;     // prompt rows per dense product item and per
                                // attention item
constexpr int kETile = 64;      // routed rows per expert product item
constexpr int kKeyTile = 64;    // keys per attention tile
constexpr int kKVPad = 136;     // bf16 per staged K / V row (128 + 8)
constexpr int kRingBytes = 200 * 1024;   // the products' stages
constexpr int kRingLag = 2;     // a chunk is issued into the stage of the
                                // chunk two before the one being computed
constexpr int kMaxE = kMaxLanes;          // experts a MoE layer

struct PArgs {
  Stream st[kStreams];
  const float* norms;        // [L, 2, hid]
  const float* final_norm;   // [hid]
  const float* qkv_b;        // [L, QKVN] or null
  const float* qk_norm;      // [L, 2, D] q_norm, k_norm (Qwen3) or null
  const float* slopes;       // [H] ALiBi slopes of the plan's heads or null
  const __nv_bfloat16* x0;   // [S, hid]
  const __nv_bfloat16* cos;  // [S, D]
  const __nv_bfloat16* sin;  // [S, D]
  const int* page_row;       // [maxPb] physical base row of each owned page
  const int* n_tokens;       // [1]
  void* k_pool;
  void* v_pool;
  float* k_qp;
  float* v_qp;
  float* logits;             // [V]
  float* resid;              // [S, hid]
  __nv_bfloat16* xn;         // [S, hid], x layout (xoff)
  float* partial;            // [ksplit][rows][N] of the product in flight
  __nv_bfloat16* qb;         // [S, H * D]
  __nv_bfloat16* kb;         // [S, KH * D]
  __nv_bfloat16* vb;         // [S, KH * D]
  __nv_bfloat16* attn;       // [S, H * D], x layout
  __nv_bfloat16* act;        // [S or scap, inter], x layout
  uint8_t* x_last;           // row n - 1 final-normed, as x records
                             // (write_row_records)
  unsigned* tickets;         // [lm tiles] of the lm_head's K splits
  unsigned* barrier;
  int* status;
  float* edn;                // MoE: the experts' down partials
                             // [split][scap][hid], by routed slot
  float* acc;                // MoE: [S, hid] gated sum of the experts
  float* gates;              // MoE: [L][S][EP] gates, 0 where not routed
  float* sgate;              // MoE: [L][S] the shared expert's gate
  __nv_bfloat16* xe;         // MoE: [scap, hid] x_norm of each routed
                             // slot, x layout
  int* eidx;                 // MoE: [S][kMaxTopk] a row's experts, ascending
  int* eslot;                // MoE: [S][kMaxTopk] their routed slots
  int* ecount;               // MoE: [L][E] rows routed to each expert
  unsigned long long* launches;
  unsigned long long* trace;
  int S, L, hid, H, KH, inter, V, ps, maxPb, kv_kind, ql;
  int E, k_top, norm_topk, has_shared, has_sgate, shared_inter, EP, scap;
  float eps, att_scale;
};

// The x operand of a product (x_norm, attn_out, the SwiGLU activation, the
// routed slots' x_norm) is laid out for the product's bulk copies and the
// tensor cores' 128-byte swizzle: element k of row r of an R-row operand
// is at xoff(R, r, k), chunk k / 64 holding all R rows of 128 bytes each,
// the 16-byte unit u = (k % 64) / 8 of row r stored as unit u ^ (r % 8).
// So the x tile of a (chunk, row tile) is one contiguous run of rows x 128
// bytes (one bulk copy), and in a 1024-byte aligned stage it is the
// K-major, 128-byte swizzled B operand of wgmma. R is a multiple of 8.
__device__ __forceinline__ size_t xoff(int R, int r, int k) {
  return ((size_t)(k >> 6) * R + r) * 64 +
         ((((k >> 3) & 7) ^ (r & 7)) << 3) + (k & 7);
}

// wgmma: the fences, commit and wait around the asynchronous products, and
// the shared-memory descriptor of a K-major, 128-byte swizzled B operand:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the start moved
// by 32 bytes a k16 step (the swizzle is applied to the address bits, so a
// 1024-byte aligned tile reads its k16 steps that way).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving the computation of `r` past this point:
// the A registers of a commit group are all written before its wgmma.fence
// and the accumulators are read only after the wait (ptxas serializes the
// products when an instruction that is not a wgmma defines a wgmma's input
// inside the group).
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[N/2] += A (64 x 16, this warp's 16 rows in a[4]) . B (16 x 64,
// K-major, 128-byte swizzled, `desc`); d = A . B where scale_d is 0
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d[N/2] += A (64 x 16, this warp's 16 rows in a[4]) . B (16 x 128,
// K-major, 128-byte swizzled, `desc`); d = A . B where scale_d is 0
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <int NR>
__device__ __forceinline__ void wgmma_step(float (&d)[NR / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (NR == 128)
    wgmma_m64n128(d, a, desc, scale_d);
  else
    wgmma_m64n64(d, a, desc, scale_d);
}

// One stage of a product's ring: the x tile (NR rows x 64 K rows, 1024-byte
// aligned: the B operand), the weight chunk as the pack lays it out, and,
// for a quantized stream, the scale and zero rows of the chunk's quant
// group over the tile's 256 columns (where the chunk starts a group or its
// item). Then the full and empty mbarriers of the stages and the issuing
// cursor.
template <int BITS, int NR>
struct PRing {
  static constexpr int kWOff = NR * 128;
  static constexpr int kQOff = kWOff + Tile<BITS>::kChunkBytes;
  static constexpr int kStage = kQOff + (BITS == 16 ? 0 : 2048);
  static constexpr int kStages =
      kRingBytes / kStage < 8 ? kRingBytes / kStage : 8;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kCurOff = kBarOff + 16 * kStages;
  static_assert(kStage % 1024 == 0, "stages keep the x tile 1024-aligned");
  static constexpr int kCtxOff = kCurOff + 96;
  static_assert(kCtxOff + 96 <= kRingBytes + 1024, "ring overflows");
};
// the routed tables of an expert product (counts, slot bases, tile prefix)
// sit after the largest ring
constexpr int kTabOff = kRingBytes + 1024;

// A product item decoded: its first chunk's payload, its tile's qparam
// rows, its x rows in chunk 0, the chunks of its K split, its rows (a
// dense row tile, or an expert's routed slots) and where its output goes.
struct PItem {
  const uint8_t* w;
  const float* s;
  const float* z;
  const __nv_bfloat16* x;
  int c0, nc, row0, nrows, split, col_out, n_leaf;
};

// The shared-memory cursor of the issuing thread: the item it is in, its
// next chunk, and the chunks issued before.
struct PCursor {
  PItem it;
  int item, c, n;
};

// What a product phase's item decode and chunk issue read: the stream and
// its operand, the item space, and (GROUPED) the routed tables in shared
// memory. It lives in shared memory too (no registers across the chunk
// loop, whose products hold most of them).
struct PCtx {
  const Stream* st;
  const __nv_bfloat16* X;
  const int* cnt;      // [E] rows an expert
  const int* base;     // [E] its first slot
  const int* pre;      // [E + 1] prefix of its row tiles
  int layer, R, mtiles, store_rows, per_rows, chunks_total, cpg, n_items;
};

template <int BITS, int NR, bool GROUPED>
__device__ __forceinline__ PItem decode_item(const PCtx& p, int item) {
  using T = Tile<BITS>;
  const Stream& st = *p.st;
  PItem it;
  int rt, t, e = 0;
  if (GROUPED) {
    const int g = item / p.per_rows;      // a routed row tile of some expert
    while (p.pre[e + 1] <= g) ++e;
    const int rte = p.pre[e + 1] - p.pre[e];
    const int local = item - p.per_rows * p.pre[e];
    rt = local % rte;
    it.split = (local / rte) % st.ksplit;
    t = local / (rte * st.ksplit);
    it.row0 = p.base[e] + rt * NR;
    it.nrows = min(NR, p.cnt[e] - rt * NR);
  } else {
    rt = item % p.mtiles;
    it.split = (item / p.mtiles) % st.ksplit;
    t = item / (p.mtiles * st.ksplit);
    it.row0 = rt * NR;
    it.nrows = min(NR, p.store_rows - it.row0);
  }
  const int leaf = (st.nleaf > 1 && t >= st.tile0[1]) +
                   (st.nleaf > 2 && t >= st.tile0[2]);
  const int lt = t - st.tile0[leaf];
  it.c0 = it.split * st.cps;
  it.nc = min(st.cps, p.chunks_total - it.c0);
  it.w = st.w[leaf] + (size_t)p.layer * st.w_ls[leaf] +
         (size_t)e * st.e_ls[leaf] +
         ((size_t)lt * p.chunks_total + it.c0) * T::kChunkBytes;
  const size_t qoff = (size_t)p.layer * st.q_ls[leaf] +
                      (size_t)e * st.qe_ls[leaf] + (size_t)lt * 256;
  it.s = BITS == 16 ? nullptr : st.s[leaf] + qoff;
  it.z = BITS == 16 ? nullptr : st.z[leaf] + qoff;
  it.x = p.X + (size_t)it.row0 * 64;
  it.col_out = t * 256;
  it.n_leaf = st.n[leaf];
  return it;
}

// By the issuing thread: the next chunk of the block's item sequence into
// its stage, once the chunk kStages before it has left that stage.
template <int BITS, int NR, bool GROUPED>
__device__ __forceinline__ void issue_chunk(const PCtx& p, PCursor& cu,
                                            uint8_t* smem, uint64_t* full,
                                            uint64_t* empty, int* status) {
  using T = Tile<BITS>;
  using RG = PRing<BITS, NR>;
  constexpr int kStages = RG::kStages;
  if (cu.c == cu.it.nc) {
    cu.item += gridDim.x;
    if (cu.item >= p.n_items) return;
    cu.it = decode_item<BITS, NR, GROUPED>(p, cu.item);
    cu.c = 0;
  }
  const int m = cu.n++;
  const int buf = m % kStages;
  if (m >= kStages) mbar_wait(empty + buf, ((m / kStages) - 1) & 1, status);
  uint8_t* dst = smem + (size_t)buf * RG::kStage;
  const int cg = cu.it.c0 + cu.c;
  const bool qp = BITS != 16 && (cu.c == 0 || cg % p.cpg == 0);
  mbar_arrive_tx(full + buf, NR * 128 + T::kChunkBytes + (qp ? 2048 : 0));
  bulk_g2s(dst, cu.it.x + (size_t)cg * p.R * 64, NR * 128, full + buf);
  bulk_g2s(dst + RG::kWOff, cu.it.w + (size_t)cu.c * T::kChunkBytes,
           T::kChunkBytes, full + buf);
  if (qp) {
    const size_t g = (size_t)(cg / p.cpg) * cu.it.n_leaf;
    bulk_g2s(dst + RG::kQOff, cu.it.s + g, 1024, full + buf);
    bulk_g2s(dst + RG::kQOff + 1024, cu.it.z + g, 1024, full + buf);
  }
  ++cu.c;
}

// The A fragments of k16 step s of this warp's 16 columns of each tile
// half, dequantized from the chunk's payload registers (the pack's mma
// fragment order, csrc/di_product.cuh `Tile`): WEIGHT-SIDE, w = bf16(q * s
// + z) with the group's s and z rounded to bf16 (u4: one fused bf16
// multiply-add of the exact operands q + 128 - 128, s and z); a0 = column
// gid, rows 2 tig.., a1 = column gid + 8, a2 / a3 the same eight rows on.
// (The callers unroll their step loops: s is a constant there.)
template <int BITS>
__device__ __forceinline__ void a_frags(const uint8_t* wq, int s,
                                        const __nv_bfloat162 (&s2)[4],
                                        const __nv_bfloat162 (&z2)[4],
                                        const float (&sc)[4],
                                        const float (&ze)[4],
                                        uint32_t (&alo)[4],
                                        uint32_t (&ahi)[4]) {
  uint32_t bl[2][2], bh[2][2];   // [nt][i] of the low / high half
  if (BITS == 4) {
    // (n | 0x4300) is bf16(128 + n); minus 128 and the affine as one fused
    // bf16 multiply-add of exact operands: bf16(n * s + z) without a convert
    const uint4 v = *reinterpret_cast<const uint4*>(wq + (s >> 1) * 512);
    const uint32_t w2[2] = {(s & 1) ? v.z : v.x, (s & 1) ? v.w : v.y};
    const __nv_bfloat162 k128 = __floats2bfloat162_rn(128.f, 128.f);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // byte of row p = 0 | byte of row p = 1 << 16
        const uint32_t pair = __byte_perm(w2[nt], 0u, i == 0 ? 0x4140 : 0x4342);
        const uint32_t lo = and_or(pair, 0x000F000Fu, 0x43004300u);
        const uint32_t hi = and_or(pair >> 4, 0x000F000Fu, 0x43004300u);
        const __nv_bfloat162 wl = __hfma2(
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), k128),
            s2[nt], z2[nt]);
        const __nv_bfloat162 wh = __hfma2(
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi), k128),
            s2[2 + nt], z2[2 + nt]);
        bl[nt][i] = *reinterpret_cast<const uint32_t*>(&wl);
        bh[nt][i] = *reinterpret_cast<const uint32_t*>(&wh);
      }
  } else if (BITS == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(wq + s * 512);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t w = w4[nt * 2 + i];
        bl[nt][i] = pack_bf16(
            fmaf((float)(int8_t)(w & 0xFFu), sc[nt], ze[nt]),
            fmaf((float)(int8_t)((w >> 8) & 0xFFu), sc[nt], ze[nt]));
        bh[nt][i] = pack_bf16(
            fmaf((float)(int8_t)((w >> 16) & 0xFFu), sc[2 + nt], ze[2 + nt]),
            fmaf((float)(int8_t)(w >> 24), sc[2 + nt], ze[2 + nt]));
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint4 v = *reinterpret_cast<const uint4*>(wq + (2 * s + nt) * 512);
      bl[nt][0] = v.x;
      bh[nt][0] = v.y;
      bl[nt][1] = v.z;
      bh[nt][1] = v.w;
    }
  }
  alo[0] = bl[0][0]; alo[1] = bl[1][0]; alo[2] = bl[0][1]; alo[3] = bl[1][1];
  ahi[0] = bh[0][0]; ahi[1] = bh[1][0]; ahi[2] = bh[0][1]; ahi[3] = bh[1][1];
}

// An item's f32 sums from the accumulators: column 128 h + 16 warp + gid
// (+ 8), rows 8 j + 2 tig (+ 1); rows >= nrows and columns >= st.nvalid are
// not stored. A warp's store instruction covers 4 rows x 32 bytes, whole
// sectors. The item's row, column and split pass through an empty asm
// first, so that the compiler computes the NR stores' addresses here and
// does not hoist them out of the chunk loop, where they would hold
// registers beside the accumulators.
template <int NR>
__device__ __forceinline__ void store_tile(const float (&acc)[2][NR / 2],
                                           float* out, size_t split_stride,
                                           const PItem& it, const Stream& st,
                                           int warp, int gid, int tig) {
  int row0 = it.row0, nrows = it.nrows, col0 = it.col_out, split = it.split;
  asm volatile("" : "+r"(row0), "+r"(nrows), "+r"(col0), "+r"(split));
  float* o = out + (size_t)split * split_stride + col0 + 16 * warp + gid;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 8 * j + 2 * tig + (q & 1);
        const int col = 128 * h + 8 * (q >> 1);
        if (r < nrows && col0 + 16 * warp + gid + col < st.nvalid)
          o[(size_t)(row0 + r) * st.ldo + col] = acc[h][4 * j + q];
      }
}

// out[split][row][col] = sum over the split's K chunks of X[row] . W[:, col]
// with weight-side dequant, on wgmma. X is an R-row operand in the x layout
// (xoff). Dense (GROUPED false): the rows of `mtiles` tiles of NR rows;
// rows >= store_rows and columns >= st.nvalid are not stored. GROUPED: an
// expert stream over its routed slots, layer `layer`'s per-expert row
// counts at `ecount` (E experts): expert e's rows are the slots base[e] ..
// base[e] + count - 1 (base: the counts rounded up to 8, summed in expert
// order, as the route phase lays them out), in tiles of NR; an expert with
// no rows has no items and its weights are not read.
//
// Item = (256-column weight tile, K split, row tile), row tiles innermost
// (an expert's items: expert, tile, split, routed-row tile), so the blocks
// running side by side read the same weight chunks and a payload byte
// comes from device memory once. The weights are wgmma's A operand, from
// registers: each warp dequantizes its 16 columns of each tile half once a
// chunk (the payload's fragment order is the A fragment's), and its
// warpgroup's m64nNk16 products reuse them over the tile's NR rows; x is
// the B operand, read by the tensor cores straight from the stage. Each
// k16 step's two products (one a tile half) form a commit group, and a
// warp dequantizes the next step once its group has completed: ptxas
// serializes a wgmma whose register A operand is written while another
// group is in flight, and in a kernel of this size it serializes them
// anyway for want of registers (C7512), so the dequant of one warpgroup
// overlaps the other's products, not its own.
//
// The ring: thread 0 issues the bulk copies of each chunk of the block's
// item sequence (x tile, payload, qparams) on the stage's full mbarrier,
// armed with their bytes, kRingLag chunks behind the one being computed
// (that stage is normally long free); each warp waits on the full barrier
// and arrives on the stage's empty barrier once its products on the stage
// have completed, which thread 0 waits for before it refills the stage. No
// block-wide barrier a chunk. The barriers are initialised at the phase's
// start and invalidated at its end, behind the async-proxy fence, so every
// phase of a launch (and every graph replay) starts them at parity 0. The
// f32 sums of a K split are stored straight from the accumulators: a
// warp's store instruction covers 4 rows x 32 bytes, whole sectors.
template <int BITS, int NR, bool GROUPED>
__device__ __forceinline__ void gemm_phase(
    const Stream& st, int layer, const __nv_bfloat16* X, int R, int mtiles,
    float* out, size_t split_stride, int store_rows, uint8_t* smem_raw,
    int* status, const int* ecount, int E) {
  using T = Tile<BITS>;
  using RG = PRing<BITS, NR>;
  constexpr int kStages = RG::kStages;
  constexpr int kNA = NR / 2;             // accumulators a half
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int chunks_total = st.K / kChunkK;
  const int cpg = st.K / st.G / kChunkK;  // chunks per quant group
  const int tiles = st.tile0[st.nleaf];
  const int per_rows = tiles * st.ksplit; // items of one row tile
  // the stages start 1024-byte aligned
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RG::kBarOff);
  uint64_t* empty = full + kStages;
  PCursor* cur = reinterpret_cast<PCursor*>(smem + RG::kCurOff);
  int* cnt = reinterpret_cast<int*>(smem + kTabOff);   // [E]
  int* base = cnt + kMaxE;                             // [E]
  int* pre = base + kMaxE;                             // [E + 1] row tiles

  if (GROUPED && warp == 0) {
    // counts -> slot bases and the prefix of row tiles, 32 experts a step
    int b0 = 0, p0 = 0;
    if (lane == 0) pre[0] = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < E ? __ldcg(ecount + e) : 0;
      int b = (c + 7) & ~7, p = (c + NR - 1) / NR;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int bo = __shfl_up_sync(0xffffffffu, b, o);
        const int po = __shfl_up_sync(0xffffffffu, p, o);
        if (lane >= o) {
          b += bo;
          p += po;
        }
      }
      if (e < E) {
        cnt[e] = c;
        base[e] = b0 + b - ((c + 7) & ~7);
        pre[e + 1] = p0 + p;
      }
      b0 += __shfl_sync(0xffffffffu, b, 31);
      p0 += __shfl_sync(0xffffffffu, p, 31);
    }
  }
  PCtx& p = *reinterpret_cast<PCtx*>(smem + RG::kCtxOff);
  __syncwarp();                 // warp 0's tables are written
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    fence_mbar_init();
    cur->item = blockIdx.x - gridDim.x;
    cur->c = cur->it.nc = 0;   // the first issue moves to item blockIdx.x
    cur->n = 0;
    p.st = &st;
    p.X = X;
    p.cnt = cnt;
    p.base = base;
    p.pre = pre;
    p.layer = layer;
    p.R = R;
    p.mtiles = mtiles;
    p.store_rows = store_rows;
    p.per_rows = per_rows;
    p.chunks_total = chunks_total;
    p.cpg = cpg;
    p.n_items = per_rows * (GROUPED ? pre[E] : mtiles);
  }
  // every thread's earlier accesses to this memory (another phase's) come
  // before the copies that refill it
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages - kRingLag; ++s)
      issue_chunk<BITS, NR, GROUPED>(p, *cur, smem, full, empty, status);

  float acc[2][kNA];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kNA; ++i) acc[h][i] = 0.f;
  // this lane's four columns [half * 2 + nt]: the group's scale and zero
  // (rounded to bf16: the TPU pack stores the qparams in bf16), in bf16x2
  // for the u4 chain and in f32 for the int8 one
  __nv_bfloat162 s2[4], z2[4];
  float sc[4], ze[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s2[j] = z2[j] = __floats2bfloat162_rn(0.f, 0.f);
    sc[j] = ze[j] = 0.f;
  }
  uint32_t af[2][4];                      // [tile half]

  int n = 0;                              // chunks consumed
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const PItem it = decode_item<BITS, NR, GROUPED>(p, item);
    for (int c = 0; c < it.nc; ++c, ++n) {
      const int buf = n % kStages;
      if (tid == 0)                       // chunk n + kStages - kRingLag
        issue_chunk<BITS, NR, GROUPED>(p, *cur, smem, full, empty, status);
      __syncwarp();
      mbar_wait(full + buf, (n / kStages) & 1, status);
      const uint8_t* base_s = smem + (size_t)buf * RG::kStage;
      const int cg = it.c0 + c;
      if (BITS != 16 && (c == 0 || cg % cpg == 0)) {
        const float* qs = reinterpret_cast<const float*>(base_s + RG::kQOff);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = (j >> 1) * 128 + 16 * warp + 8 * (j & 1) + gid;
          s2[j] = __float2bfloat162_rn(qs[col]);
          z2[j] = __float2bfloat162_rn(qs[256 + col]);
          sc[j] = __low2float(s2[j]);
          ze[j] = __low2float(z2[j]);
        }
      }
      const uint8_t* wq = base_s + RG::kWOff +
                          warp * (T::kQuarters * 512) + lane * 16;
      const uint64_t desc = sw128_desc(base_s);
#pragma unroll
      for (int s = 0; s < kChunkK / 16; ++s) {
        // the step before has completed, so af is free (the fence keeps it
        // alive up to here: the compiler must not give its registers to
        // another value while a product reads them), and at step 0 so is
        // the chunk before's stage
        wgmma_wait_all();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(af[h][i]);
        if (s == 0 && c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + (n - 1) % kStages);
        }
        a_frags<BITS>(wq, s, s2, z2, sc, ze, af[0], af[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(af[h][i]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < kNA; ++i) fence_operand(acc[h][i]);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_step<NR>(acc[h], af[h], desc + 2 * s,
                         (c > 0 || s > 0) ? 1 : 0);
        wgmma_commit();
      }
      if (c == it.nc - 1) {
        wgmma_wait_all();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < kNA; ++i) fence_operand(acc[h][i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(af[h][i]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + buf);
        store_tile<NR>(acc, out, split_stride, it, st, warp, gid, tig);
      }
    }
  }
  // every chunk issued was waited for: no copy is in flight, and no
  // product (on every path out of the loop, for ptxas)
  wgmma_wait_all();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_inval(full + s);
      mbar_inval(empty + s);
    }
  }
  __syncthreads();
}

// One product phase of a layer: stream `sid`, its operand X (S rows, or
// scap routed slots for an expert stream over its routed rows when
// GROUPED), K splits `split_stride` floats apart in `out`. A kernel calls
// this at ONE place, so that each payload kind's product is inlined once:
// ptxas serializes the wgmma of a pipeline that crosses a function call.
template <bool MOE>
__device__ __forceinline__ void product(const PArgs& a, int sid, bool grouped,
                                        int layer, const __nv_bfloat16* X,
                                        float* out, size_t split_stride,
                                        int mtiles, int rows, uint8_t* smem) {
  const Stream& st = a.st[sid];
  if (MOE && grouped) {
    const int* cnt = a.ecount + (size_t)layer * a.E;
    if (st.bits == 4)
      gemm_phase<4, kETile, true>(st, layer, X, a.scap, 0, out,
                                  split_stride, 0, smem, a.status, cnt, a.E);
    else if (st.bits == 8)
      gemm_phase<8, kETile, true>(st, layer, X, a.scap, 0, out,
                                  split_stride, 0, smem, a.status, cnt, a.E);
    else
      gemm_phase<16, kETile, true>(st, layer, X, a.scap, 0, out,
                                   split_stride, 0, smem, a.status, cnt,
                                   a.E);
  } else if (st.bits == 4) {
    gemm_phase<4, kMTile, false>(st, layer, X, a.S, mtiles, out,
                                 split_stride, rows, smem, a.status, nullptr,
                                 0);
  } else if (st.bits == 8) {
    gemm_phase<8, kMTile, false>(st, layer, X, a.S, mtiles, out,
                                 split_stride, rows, smem, a.status, nullptr,
                                 0);
  } else {
    gemm_phase<16, kMTile, false>(st, layer, X, a.S, mtiles, out,
                                  split_stride, rows, smem, a.status,
                                  nullptr, 0);
  }
}

// The lm_head's product of one row (row n - 1, final-normed, as x records
// in x_last) with the vocab shard's stream: logits [st.nvalid] f32.
//
// Bound by bytes: one row against the shard's payload and qparams (Qwen2-7B
// a16w4 at n = 2: 153.6 MB, 0.046 ms at 3.35 TB/s), so every SM has to pull
// ~25 GB/s for the whole launch. What the design does about it:
// - It runs the decode kernels' product (di_product.cuh `product_phase`,
//   one m16 tile of x records whose row 0 is x_last): the weights are the
//   mma's A operand, straight from the payload registers (the u4 levels as
//   bf16(128 + n), the group affine applied to the f32 sums at the end of
//   each group), x_last the B operand's one live n8 tile, and one bulk-copy
//   ring on mbarriers a block, whose stages (payload, x records, the
//   qparam rows at a group's end) are issued two behind the chunk being
//   computed, across items, with no block-wide barrier a chunk. A stage
//   brings the chunk's whole m16 record tile (2112 B, 15 rows of it zero)
//   beside its payload (8 KB of u4), as the decode product does: x_last
//   is not staged once an item. The ring's depth was measured to gain
//   nothing here (the warps' latencies hold the product, not the bytes in
//   flight), so those 25% more copied bytes, from L2, were left.
// - An item is (256-column tile, K split), tile-major, dealt round the
//   grid; the wrapper's split (ops/prefill_megakernel.py
//   `choose_row_split`) weighs the items each SM streams against what
//   each item costs beyond its chunks (Qwen2-7B's vocab in the prefill
//   megakernel: 594 tiles x 2 splits of 28 chunks = 9 items on each of
//   132 SMs; its n = 2 shard in the TP lm segment, two blocks an SM: 297 x
//   2 of 28, at most 5 items an SM), where whole-K items left the last
//   wave a quarter full.
// - Each item writes its split's f32 sums into a.partial ([split][ntot]);
//   once the block's items are done, each of its threads takes the ticket
//   of one of its items' tiles (a.tickets, one load round trip for all),
//   and the block that takes a tile's last ticket adds the tile's splits in
//   ascending order from 0, writes its true columns and sets the ticket
//   back to 0 for the next launch or graph replay.
// So the phase adds no grid barrier, the order of every f32 sum is fixed,
// and a launch repeats bit for bit.
struct RowArgs {             // what product_phase reads of its launch
  const uint8_t* rec;        // x records, [hid / 64][rec_bytes(16)]
  int* status;
  int mpad, B, probe;
};
constexpr int kRowPad = 16;  // record rows: x_last's one row and 15 zero
constexpr int kRowFlagOff =  // the tickets' results, after the ring
    imax(imax(Ring<4, 1>::kBytes, Ring<8, 1>::kBytes), Ring<16, 1>::kBytes);
// Dynamic shared memory of a kernel that runs lm_row and the final norm of
// a row of at most kLmSmem / 4 - kWarps floats (the TP prefill lm segment:
// ~106 KB, two blocks an SM).
constexpr int kLmSmem = kRowFlagOff + kThreads * 4;

// The block's items' tickets and the sums of the tiles whose last ticket it
// takes (product_phase's items of this block, in its order: item = tile x
// ks + split).
__device__ __forceinline__ void row_sums(const PArgs& a, const Stream& st,
                                         float* out, uint8_t* smem) {
  int* last = reinterpret_cast<int*>(smem + kRowFlagOff);
  const int ks = st.ksplit, n_items = st.tile0[st.nleaf] * ks;
  const int tid = threadIdx.x;
  for (int j0 = 0; blockIdx.x + j0 * gridDim.x < n_items; j0 += kThreads) {
    __syncthreads();          // the block's partials (and the flags read)
    const int item = blockIdx.x + (j0 + tid) * gridDim.x;
    if (item < n_items) {
      __threadfence();
      unsigned* tk = a.tickets + item / ks;
      const bool is_last = atomicAdd(tk, 1u) == (unsigned)ks - 1;
      if (is_last) *tk = 0u;
      last[tid] = is_last;
    }
    __syncthreads();
    for (int j = 0; j < kThreads; ++j) {
      const int it = blockIdx.x + (j0 + j) * gridDim.x;
      if (it >= n_items) break;
      if (!last[j]) continue;
      __threadfence();        // the other blocks' partials
      const int col = it / ks * 256 + tid;    // a thread a column
      const float* src = a.partial + col;
      float v = 0.f;
      for (int s = 0; s < ks; s += 8) {
        float p[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          p[q] = s + q < ks ? __ldcg(src + (size_t)(s + q) * st.ldo) : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (s + q < ks) v += p[q];    // ascending, and no + 0.f beyond
      }
      if (col < st.nvalid) out[col] = v;
    }
  }
}

// The lm_head of row n - 1 into `out`, in a function of its own: its
// registers are allocated apart from the kernel's other phases.
__device__ __noinline__ void lm_row(const PArgs& a, float* out,
                                    uint8_t* smem) {
  static_assert(kThreads == 256, "the splits' sum: a thread a column");
  const Stream& st = a.st[kLm];
  const RowArgs ra{a.x_last, a.status, kRowPad, 1, 0};
  if (st.bits == 4)
    product_phase<4, 1, false>(ra, st, 0, a.partial, smem, nullptr, 1, 0);
  else if (st.bits == 8)
    product_phase<8, 1, false>(ra, st, 0, a.partial, smem, nullptr, 1, 0);
  else
    product_phase<16, 1, false>(ra, st, 0, a.partial, smem, nullptr, 1, 0);
  row_sums(a, st, out, smem);
}

// Row n - 1's final-normed values (`val(k)`, bf16-rounded here) as x_last's
// records (di_product.cuh `write_record`, row 0 of one m16 tile; rows 1..15
// stay zero from the scratch's allocation): warp w writes chunks w, w + 8..
template <class F>
__device__ __forceinline__ void write_row_records(const PArgs& a, F val) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < a.hid / kChunkK; c += kWarps) {
    const int k = c * kChunkK + 2 * lane;
    write_record(a.x_last, kRowPad, c, 0, lane, val(k), val(k + 1));
  }
}

// resid[row] = x0[row] (first layer) or resid[row] + the K splits of the
// product before, in a fixed order; xn[row] = bf16(RMSNorm(resid[row]) * w).
// One block a row at a time (a row's splits come from L2: many loads in
// flight matter more than many rows at once).
// The MLP's output to add to resid[row]: the K splits of the down product,
// or a MoE layer's (moe) acc[row] + its shared gate x the K splits of the
// shared expert's down product.
__device__ __forceinline__ float4 mlp_out(const PArgs& a, int row, int i,
                                          int ksplit, size_t split_stride,
                                          bool moe, int moe_layer) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < ksplit; ++s) {
    const float4 p = __ldcg(reinterpret_cast<const float4*>(
        a.partial + (size_t)s * split_stride + (size_t)row * a.hid + i));
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  if (!moe) return v;
  const float4 c =
      __ldcg(reinterpret_cast<const float4*>(a.acc + (size_t)row * a.hid + i));
  const float g =
      a.has_shared ? __ldcg(a.sgate + (size_t)moe_layer * a.S + row) : 0.f;
  // the plain version's operations: acc + (gate x down), rounded apiece
  return make_float4(__fadd_rn(c.x, __fmul_rn(g, v.x)),
                     __fadd_rn(c.y, __fmul_rn(g, v.y)),
                     __fadd_rn(c.z, __fmul_rn(g, v.z)),
                     __fadd_rn(c.w, __fmul_rn(g, v.w)));
}

template <bool MOE>
__device__ __forceinline__ void norm_rows(const PArgs& a, int rows,
                                          int ksplit, size_t split_stride,
                                          bool from_x0, int moe_layer,
                                          const float* w, float* red) {
  const int hid = a.hid, tid = threadIdx.x;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    float* r = a.resid + (size_t)row * hid;
    float ss = 0.f;
    for (int i = tid * 4; i < hid; i += kThreads * 4) {
      float4 v;
      if (from_x0) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(
            a.x0 + (size_t)row * hid + i);
        const float2 lo = __bfloat1622float2(p[0]);
        const float2 hi = __bfloat1622float2(p[1]);
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else if (MOE) {
        v = __ldcg(reinterpret_cast<const float4*>(r + i));
        const float4 p =
            mlp_out(a, row, i, ksplit, split_stride, true, moe_layer);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      } else {
        v = __ldcg(reinterpret_cast<const float4*>(r + i));
        for (int s = 0; s < ksplit; ++s) {
          const float4 p = __ldcg(reinterpret_cast<const float4*>(
              a.partial + (size_t)s * split_stride + (size_t)row * hid + i));
          v.x += p.x;
          v.y += p.y;
          v.z += p.z;
          v.w += p.w;
        }
      }
      *reinterpret_cast<float4*>(r + i) = v;
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    ss = warp_sum(ss);
    __syncthreads();            // `red` of the row before has been read
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) tot += red[k];
    // rsqrtf, as torch.rsqrt computes the plain version's
    const float inv = rsqrtf(tot / (float)hid + a.eps);
    for (int i = tid * 4; i < hid; i += kThreads * 4) {
      const float4 v = *reinterpret_cast<const float4*>(r + i);
      const float4 wv = *reinterpret_cast<const float4*>(w + i);
      *reinterpret_cast<uint2*>(a.xn + xoff(a.S, row, i)) = make_uint2(
          pack_bf16(v.x * inv * wv.x, v.y * inv * wv.y),
          pack_bf16(v.z * inv * wv.z, v.w * inv * wv.w));
    }
  }
}

// One token's K or V head (this lane's dims 4 * lane ..) into its page.
template <int KIND>
__device__ __forceinline__ void write_kv(const PArgs& a, bool is_k, int layer,
                                         int t, int h, int lane,
                                         const float (&v)[4]) {
  void* pool = is_k ? a.k_pool : a.v_pool;
  float* qp = is_k ? a.k_qp : a.v_qp;
  const size_t page = (size_t)a.page_row[t / a.ps] + layer;
  const int off = t % a.ps;
  constexpr int Ds = KIND == kU4 ? kD / 2 : kD;
  const size_t base = ((page * a.ps + off) * a.KH + h) * Ds;
  if (KIND == kF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(pool) + base + lane * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else if (KIND == kBF16) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(pool) + base + lane * 4);
    p[0] = __floats2bfloat162_rn(v[0], v[1]);
    p[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else {
    const float mn = warp_min(fminf(fminf(v[0], v[1]), fminf(v[2], v[3])));
    const float mx = warp_max(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
    const float levels = KIND == kI8 ? 255.f : 15.f;
    const float sc = fmaxf((mx - mn) / levels, 1e-8f);
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float r = rintf((v[i] - mn) / sc);   // half to even
      const int q = KIND == kI8
                        ? (int)fminf(fmaxf(r - 128.f, -128.f), 127.f)
                        : (int)fminf(fmaxf(r, 0.f), 15.f);
      word |= (uint32_t)(q & 0xFF) << (8 * i);
    }
    if (KIND == kI8) {
      *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(pool) + base +
                                   lane * 4) = word;
    } else {
      // byte j = dim j (low nibble) | dim j + D/2 (high): lanes 0..15 hold
      // the low nibbles of bytes 4 * lane .., lanes 16..31 the high ones
      const uint32_t other = __shfl_xor_sync(0xffffffffu, word, 16);
      if (lane < 16)
        *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(pool) + base +
                                     lane * 4) = word | (other << 4);
    }
    if (lane == 0) {
      const size_t qrow = (page * 2 * a.KH + 2 * h) * a.ql + off;
      qp[qrow] = sc;
      qp[qrow + a.ql] = KIND == kI8 ? mn + 128.f * sc : mn;
    }
  }
}

// q|k|v of every row: K splits summed, + bias, a QK-norm model's RMSNorm
// of each q and k head (a.qk_norm), RoPE on q and k (not for an ALiBi
// model, ALIBI, whose cos / sin are not read); q, k, v rounded to
// bf16 for the attention phase; K / V of rows < n into the pool from the
// f32 values. One warp a (row, head), four dims a lane.
template <int KIND, bool ALIBI>
__device__ void rope_kv_phase(const PArgs& a, int layer, int rows, int n) {
  const Stream& st = a.st[kQkv];
  const int H = a.H, KH = a.KH, heads = H + 2 * KH;
  const int QKVN = heads * kD, HD = H * kD, KD = KH * kD;
  // the bias is [q | k | v] of the true widths; in the product's partials
  // each of q, k and v starts at its leaf's first column, its width padded
  // to the pack's 256-column tiles (st.n), a row is st.ldo wide and a split
  // S x st.ntot
  const size_t split_stride = (size_t)a.S * st.ntot;
  const float* bias =
      a.qkv_b == nullptr ? nullptr : a.qkv_b + (size_t)layer * QKVN;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  for (int it = gw; it < rows * heads; it += nw) {
    const int t = it / heads, hs = it % heads;
    const int col = hs * kD + lane * 4;
    const int pcol = col + (hs < H ? 0
                                   : (hs < H + KH ? st.n[0] - HD
                                                  : st.n[0] + st.n[1] - HD -
                                                        KD));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < st.ksplit; ++s) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(
          a.partial + (size_t)s * split_stride + (size_t)t * st.ldo + pcol));
      x.x += p.x;
      x.y += p.y;
      x.z += p.z;
      x.w += p.w;
    }
    if (bias != nullptr) {
      const float4 b = *reinterpret_cast<const float4*>(bias + col);
      x.x += b.x;
      x.y += b.y;
      x.z += b.z;
      x.w += b.w;
    }
    float v[4] = {x.x, x.y, x.z, x.w};
    if (a.qk_norm != nullptr && hs < H + KH) {       // warp-uniform
      // QK-norm (Qwen3): x * rsqrt(mean(x^2) + eps) * w in f32, with the
      // layer's q_norm or k_norm [D]
      float ss = v[0] * v[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) ss = fmaf(v[i], v[i], ss);
      const float inv = rsqrtf(warp_sum(ss) * (1.f / kD) + a.eps);
      const float4 w = *reinterpret_cast<const float4*>(
          a.qk_norm + ((size_t)layer * 2 + (hs < H ? 0 : 1)) * kD +
          lane * 4);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __fmul_rn(__fmul_rn(v[i], inv), wv[i]);
    }
    if (!ALIBI && hs < H + KH) {
      const __nv_bfloat162* cp = reinterpret_cast<const __nv_bfloat162*>(
          a.cos + (size_t)t * kD + lane * 4);
      const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(
          a.sin + (size_t)t * kD + lane * 4);
      const float2 c0 = __bfloat1622float2(cp[0]), c1 = __bfloat1622float2(cp[1]);
      const float2 s0 = __bfloat1622float2(sp[0]), s1 = __bfloat1622float2(sp[1]);
      const float cs[4] = {c0.x, c0.y, c1.x, c1.y};
      const float sn[4] = {s0.x, s0.y, s1.x, s1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rotate_half: dims < 64 take -x[d + 64], the others x[d - 64]
        const float partner = __shfl_xor_sync(0xffffffffu, v[i], 16);
        const float rot = lane < 16 ? -partner : partner;
        // the plain version's x * cos + rot * sin, rounded apiece
        v[i] = __fadd_rn(__fmul_rn(v[i], cs[i]), __fmul_rn(rot, sn[i]));
      }
    }
    __nv_bfloat16* dst;
    if (hs < H)
      dst = a.qb + (size_t)t * HD + hs * kD;
    else if (hs < H + KH)
      dst = a.kb + (size_t)t * KD + (hs - H) * kD;
    else
      dst = a.vb + (size_t)t * KD + (hs - H - KH) * kD;
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + lane * 4);
    d2[0] = __floats2bfloat162_rn(v[0], v[1]);
    d2[1] = __floats2bfloat162_rn(v[2], v[3]);
    if (hs >= H && t < n) {       // warp-uniform
      const bool is_k = hs < H + KH;
      write_kv<KIND>(a, is_k, layer, t, is_k ? hs - H : hs - H - KH, lane, v);
    }
  }
}

template <bool ALIBI>
__device__ void rope_kv(const PArgs& a, int layer, int rows, int n) {
  switch (a.kv_kind) {
    case kF32: rope_kv_phase<kF32, ALIBI>(a, layer, rows, n); break;
    case kBF16: rope_kv_phase<kBF16, ALIBI>(a, layer, rows, n); break;
    case kI8: rope_kv_phase<kI8, ALIBI>(a, layer, rows, n); break;
    default: rope_kv_phase<kU4, ALIBI>(a, layer, rows, n); break;
  }
}

// Causal attention of one layer over the bf16 q / k / v scratch. Item =
// (query head, 64-row half of a 128-row query tile); warps 0-3 and 4-7
// each take the half's 16-row groups (warp w rows 16 (w % 4) ..), the
// first over its even key tiles, the second over its odd ones, so a long
// range is two blocks' halves and two warp groups' shares at once. Pass 1
// finds each row's maximum and sum over the group's tiles; the two
// groups' are combined through shared memory in a fixed order (m = the
// larger, l = l_a e^(m_a - m) + l_b e^(m_b - m)); pass 2 forms p =
// exp(s - m) / l, rounds it to bf16 (the plain version's rounding point)
// and accumulates p @ v over the group's tiles; the odd group's o is added
// to the even group's through shared memory. The items go longest first
// (most key tiles), dealt to the blocks in rounds that turn back at each
// end (round r's item r x grid + b goes to block b, or to block grid - 1 -
// b in odd rounds), so the block with a round's longest item takes the
// next round's shortest. ALIBI (an ALiBi model's kernels, instantiations of
// their own, so that the RoPE model's code is unchanged): the scores gain
// slope * (key - row) after the scale, before the mask, in both passes
// (`scaled`). The key tiles come through two cp.async stages of two tiles
// (one a group): the next step's copies are in flight while the products of
// this one run.
template <bool ALIBI>
__device__ void attention_phase(const PArgs& a, int mtiles, uint8_t* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int grp = warp >> 2, wq = warp & 3;   // key-tile group, row group
  const int H = a.H, KH = a.KH, G = H / KH;
  const int HD = H * kD, KD = KH * kD;
  constexpr int kTile = kKeyTile * kKVPad;   // bf16 of a staged K or V tile
  // K tiles [stage][group], then V tiles [stage][group], then the groups'
  // exchange: (m, l) of every thread, then the odd group's o
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + 4 * kTile;
  float4* xml = reinterpret_cast<float4*>(Vs + 4 * kTile);   // [8][32]
  float4* xo = xml + kThreads;                   // [kD / 8][4][32]
  const int n_items = 2 * H * mtiles;

  for (int round = 0;; ++round) {
    const int item = round * gridDim.x +
                     (round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (item >= n_items) break;   // and in every later round
    // the longest halves (most key tiles) first
    const int hh = item % H, r = item / H;
    const int qt = mtiles - 1 - r / 2, hf = 1 - r % 2;
    const int h = hh / G;
    const int q0 = qt * kMTile + hf * 64 + wq * 16;
    const int r0 = q0 + gid, r1 = r0 + 8;
    const int nkt = 2 * qt + hf + 1;     // key tiles up to the half's end
    const int nst = (nkt + 1) / 2;       // steps: tiles 2 s and 2 s + 1
    const float sl = ALIBI ? a.slopes[hh] : 0.f;   // the head's ALiBi slope

    uint32_t qf[kD / 16][4];
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      const __nv_bfloat16* qp =
          a.qb + (size_t)r0 * HD + hh * kD + 16 * ks + 2 * tig;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(qp);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(qp + (size_t)8 * HD);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(qp + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(qp + (size_t)8 * HD + 8);
    }

    auto load_tile = [&](const __nv_bfloat16* src, __nv_bfloat16* dst,
                         int k0) {
      for (int i = tid; i < kKeyTile * 16; i += kThreads) {
        const int row = i >> 4, seg = i & 15;
        cp_async16(dst + row * kKVPad + seg * 8,
                   src + (size_t)(k0 + row) * KD + h * kD + seg * 8);
      }
    };
    // step st's tiles 2 st + g into stage b (`kv`: V too)
    auto load_step = [&](int st, int b, bool kv) {
      for (int g = 0; g < 2 && 2 * st + g < nkt; ++g) {
        load_tile(a.kb, Ks + (2 * b + g) * kTile, (2 * st + g) * kKeyTile);
        if (kv)
          load_tile(a.vb, Vs + (2 * b + g) * kTile, (2 * st + g) * kKeyTile);
      }
    };
    // a scaled score of key `key` in row `row`, an ALiBi model's plus
    // slope * (key - row), each step rounded (the plain version's order)
    auto scaled = [&](float v, int key, int row) {
      v *= a.att_scale;
      return ALIBI ? __fadd_rn(v, __fmul_rn(sl, (float)(key - row))) : v;
    };
    // s[j][.] = scaled, masked scores of this warp's 16 rows against keys
    // k0 + 8 j + 2 tig (+1)
    auto scores = [&](const __nv_bfloat16* Kt, int k0, float (&s)[8][4]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const __nv_bfloat16* kp = Kt + (8 * j + gid) * kKVPad + 2 * tig;
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks)
          mma_bf16_16816(s[j], qf[ks],
                         *reinterpret_cast<const uint32_t*>(kp + 16 * ks),
                         *reinterpret_cast<const uint32_t*>(kp + 16 * ks + 8));
        const int key = k0 + 8 * j + 2 * tig;
        s[j][0] = key <= r0 ? scaled(s[j][0], key, r0) : -FLT_MAX;
        s[j][1] = key + 1 <= r0 ? scaled(s[j][1], key + 1, r0) : -FLT_MAX;
        s[j][2] = key <= r1 ? scaled(s[j][2], key, r1) : -FLT_MAX;
        s[j][3] = key + 1 <= r1 ? scaled(s[j][3], key + 1, r1) : -FLT_MAX;
      }
    };
    // step st's stage: its copies waited for (the next step's, issued
    // first into the other stage, stay in flight)
    auto next_stage = [&](int st, bool kv) {
      __syncthreads();            // the stage of step st - 1 has been read
      if (st + 1 < nst) load_step(st + 1, (st + 1) & 1, kv);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    };

    // pass 1: the group's running (max, sum) over its tiles; a tile wholly
    // past the warp's rows is skipped (warp-uniform)
    float m0 = -FLT_MAX, m1 = -FLT_MAX, l0 = 0.f, l1 = 0.f;
    __syncthreads();              // the item before is done with the memory
    load_step(0, 0, false);
    cp_async_commit();
    for (int st = 0; st < nst; ++st) {
      next_stage(st, false);
      const int kt = 2 * st + grp, k0 = kt * kKeyTile;
      if (kt >= nkt || k0 > q0 + 15) continue;
      float s[8][4];
      scores(Ks + (2 * (st & 1) + grp) * kTile, k0, s);
      float t0 = -FLT_MAX, t1 = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
        t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
      }
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      float e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
        e1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
      }
      e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
      l0 = l0 * expf(m0 - n0) + e0;
      l1 = l1 * expf(m1 - n1) + e1;
      m0 = n0;
      m1 = n1;
    }
    // the rows' (m, l) from both groups', the even group's first (a group
    // with no key of a row has m = -FLT_MAX, l = 0 there)
    xml[warp * 32 + lane] = make_float4(m0, l0, m1, l1);
    __syncthreads();
    {
      const float4 ea = xml[wq * 32 + lane], eb = xml[(wq + 4) * 32 + lane];
      m0 = fmaxf(ea.x, eb.x);
      m1 = fmaxf(ea.z, eb.z);
      l0 = ea.y * expf(ea.x - m0) + eb.y * expf(eb.x - m0);
      l1 = ea.w * expf(ea.z - m1) + eb.w * expf(eb.z - m1);
    }

    // pass 2: p = exp(s - m) / l, rounded to bf16, times V
    float o[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    __syncthreads();              // pass 1's stages are read
    load_step(0, 0, true);
    cp_async_commit();
    for (int st = 0; st < nst; ++st) {
      next_stage(st, true);
      const int kt = 2 * st + grp, k0 = kt * kKeyTile;
      if (kt >= nkt || k0 > q0 + 15) continue;
      const __nv_bfloat16* Vt = Vs + (2 * (st & 1) + grp) * kTile;
      float s[8][4];
      scores(Ks + (2 * (st & 1) + grp) * kTile, k0, s);
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        // p of keys k0 + 16 kk .. + 15 as the A operand (the score tiles'
        // accumulator layout is the A fragment's)
        uint32_t pf[4];
        pf[0] = pack_bf16(expf(s[2 * kk][0] - m0) / l0,
                          expf(s[2 * kk][1] - m0) / l0);
        pf[1] = pack_bf16(expf(s[2 * kk][2] - m1) / l1,
                          expf(s[2 * kk][3] - m1) / l1);
        pf[2] = pack_bf16(expf(s[2 * kk + 1][0] - m0) / l0,
                          expf(s[2 * kk + 1][1] - m0) / l0);
        pf[3] = pack_bf16(expf(s[2 * kk + 1][2] - m1) / l1,
                          expf(s[2 * kk + 1][3] - m1) / l1);
        const __nv_bfloat16* vrow =
            Vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kKVPad +
            8 * (lane >> 4);
#pragma unroll
        for (int dp = 0; dp < kD / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vrow + 16 * dp);
          mma_bf16_16816(o[2 * dp], pf, vf[0], vf[1]);
          mma_bf16_16816(o[2 * dp + 1], pf, vf[2], vf[3]);
        }
      }
    }
    // the odd group's o into the even group's, then attn_out in the x
    // layout of the o product
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        xo[(j * 4 + wq) * 32 + lane] =
            make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float4 v = xo[(j * 4 + wq) * 32 + lane];
        const int k = hh * kD + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(a.attn + xoff(a.S, r0, k)) =
            pack_bf16(o[j][0] + v.x, o[j][1] + v.y);
        *reinterpret_cast<uint32_t*>(a.attn + xoff(a.S, r1, k)) =
            pack_bf16(o[j][2] + v.z, o[j][3] + v.w);
      }
    }
  }
}

// act[row] = bf16(silu(g) * u) in the x layout of the down product, from
// a gate|up product's K splits (up starts at the gate leaf's padded width):
// the rows < `rows` of a dense product.
__device__ __forceinline__ float4 swiglu4(const Stream& st, const float* in,
                                          size_t split_stride, int row,
                                          int c) {
  float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), u = gv;
  for (int s = 0; s < st.ksplit; ++s) {
    const float* p = in + (size_t)s * split_stride + (size_t)row * st.ntot + c;
    const float4 gs = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 us = __ldcg(reinterpret_cast<const float4*>(p + st.n[0]));
    gv.x += gs.x; gv.y += gs.y; gv.z += gs.z; gv.w += gs.w;
    u.x += us.x; u.y += us.y; u.z += us.z; u.w += us.w;
  }
  // the plain version's order: g * sigmoid(g), sigmoid(g) = 1 / (1 +
  // exp(-g)), then * u
  return make_float4(gv.x * (1.0f / (1.0f + expf(-gv.x))) * u.x,
                     gv.y * (1.0f / (1.0f + expf(-gv.y))) * u.y,
                     gv.z * (1.0f / (1.0f + expf(-gv.z))) * u.z,
                     gv.w * (1.0f / (1.0f + expf(-gv.w))) * u.w);
}
__device__ __forceinline__ void store_act(__nv_bfloat16* act, int R, int row,
                                          int c, float4 v) {
  *reinterpret_cast<uint2*>(act + xoff(R, row, c)) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ void act_phase(const PArgs& a, const Stream& st, int inter,
                          int rows) {
  const int quarter = inter / 4;
  const size_t split_stride = (size_t)a.S * st.ntot;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < rows * quarter;
       i += gridDim.x * kThreads) {
    const int row = i / quarter, c = 4 * (i - row * quarter);
    store_act(a.act, a.S, row, c,
              swiglu4(st, a.partial, split_stride, row, c));
  }
}

__device__ void norm_phase(const PArgs& a, int rows, int ksplit,
                           size_t split_stride, bool from_x0, const float* w,
                           float* red) {
  norm_rows<false>(a, rows, ksplit, split_stride, from_x0, 0, w, red);
}

// Row n - 1: the last down product's splits into the residual, the final
// norm, bf16 -> x_last's records. Block 0 alone (one row).
__device__ void final_norm_phase(const PArgs& a, int n, int ksplit,
                                 bool moe, float* smem) {
  if (blockIdx.x != 0) return;
  const int hid = a.hid, tid = threadIdx.x;
  const size_t split_stride = (size_t)a.S * hid;
  const size_t roff = (size_t)(n - 1) * hid;
  float* vals = smem;            // [hid]
  float* red = smem + hid;       // [kWarps]
  float ss = 0.f;
  if (!moe) {
    for (int i = tid; i < hid; i += kThreads) {
      float v = __ldcg(a.resid + roff + i);
      for (int s = 0; s < ksplit; ++s)
        v += __ldcg(a.partial + (size_t)s * split_stride + roff + i);
      vals[i] = v;
      ss += v * v;
    }
  } else {
    for (int i4 = tid * 4; i4 < hid; i4 += kThreads * 4) {
      const float4 p =
          mlp_out(a, n - 1, i4, ksplit, split_stride, true, a.L - 1);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = __ldcg(a.resid + roff + i4 + k) + pv[k];
        vals[i4 + k] = v;
        ss += v * v;
      }
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  const float inv = rsqrtf(tot / (float)hid + a.eps);
  write_row_records(a, [&](int k) { return vals[k] * inv * a.final_norm[k]; });
}

// What lm_row takes: a K split of at least one chunk a split, partials
// strided by the padded width, the tickets and x_last's records.
inline bool lm_row_args_ok(const PArgs& a) {
  const Stream& st = a.st[kLm];
  return st.K == a.hid && st.ksplit >= 1 && st.cps >= 1 &&
         (st.ksplit - 1) * st.cps < st.K / kChunkK && st.ldo >= st.ntot &&
         a.tickets != nullptr && a.x_last != nullptr;
}

int pmk_smem_bytes() {
  // the products' ring (aligned to 1024 bytes) and the routed tables; the
  // one-row product's ring (di_product.cuh Ring<*, 1>), the attention
  // tiles and the final norm's [hid] floats are far below
  return 1024 + kTabOff + (3 * kMaxE + 1) * 4;
}

// Index of each value in the `ia` array of di_prefill_megakernel
// (ops/prefill_megakernel.py fills it with the same names).
enum IArg {
  I_NORMS, I_FINAL_NORM, I_QKV_B, I_X0, I_COS, I_SIN, I_PAGE_ROW, I_N_TOKENS,
  I_K_POOL, I_V_POOL, I_K_QP, I_V_QP, I_LOGITS, I_RESID, I_XN, I_PARTIAL,
  I_QB, I_KB, I_VB, I_ATTN, I_ACT, I_X_LAST, I_TICKETS, I_BARRIER,
  I_STATUS, I_EDN, I_ACC, I_GATES, I_SGATE, I_XE, I_EIDX, I_ESLOT, I_ECOUNT,
  I_LAUNCHES, I_TRACE, I_S, I_L, I_HID, I_H, I_KH, I_INTER, I_V, I_PS, I_MAXPB,
  I_KV_KIND, I_QL, I_GRID, I_E, I_K_TOP, I_NORM_TOPK, I_HAS_SHARED,
  I_HAS_SGATE, I_SHARED_INTER, I_EP, I_SCAP, I_QK_NORM, I_SLOPES,
  I_STREAMS
};
// then kStreamArgs values per stream (fill_stream)

// PArgs from the `ia` / `fa` arrays of di_prefill_megakernel (the IArg
// order, then kStreamArgs values per stream).
inline void fill_pargs(PArgs& a, const long long* ia, const double* fa) {
  a.norms = ptr<const float>(ia[I_NORMS]);
  a.final_norm = ptr<const float>(ia[I_FINAL_NORM]);
  a.qkv_b = ptr<const float>(ia[I_QKV_B]);
  a.qk_norm = ptr<const float>(ia[I_QK_NORM]);
  a.slopes = ptr<const float>(ia[I_SLOPES]);
  a.x0 = ptr<const __nv_bfloat16>(ia[I_X0]);
  a.cos = ptr<const __nv_bfloat16>(ia[I_COS]);
  a.sin = ptr<const __nv_bfloat16>(ia[I_SIN]);
  a.page_row = ptr<const int>(ia[I_PAGE_ROW]);
  a.n_tokens = ptr<const int>(ia[I_N_TOKENS]);
  a.k_pool = ptr<void>(ia[I_K_POOL]);
  a.v_pool = ptr<void>(ia[I_V_POOL]);
  a.k_qp = ptr<float>(ia[I_K_QP]);
  a.v_qp = ptr<float>(ia[I_V_QP]);
  a.logits = ptr<float>(ia[I_LOGITS]);
  a.resid = ptr<float>(ia[I_RESID]);
  a.xn = ptr<__nv_bfloat16>(ia[I_XN]);
  a.partial = ptr<float>(ia[I_PARTIAL]);
  a.qb = ptr<__nv_bfloat16>(ia[I_QB]);
  a.kb = ptr<__nv_bfloat16>(ia[I_KB]);
  a.vb = ptr<__nv_bfloat16>(ia[I_VB]);
  a.attn = ptr<__nv_bfloat16>(ia[I_ATTN]);
  a.act = ptr<__nv_bfloat16>(ia[I_ACT]);
  a.x_last = ptr<uint8_t>(ia[I_X_LAST]);
  a.tickets = ptr<unsigned>(ia[I_TICKETS]);
  a.barrier = ptr<unsigned>(ia[I_BARRIER]);
  a.status = ptr<int>(ia[I_STATUS]);
  a.edn = ptr<float>(ia[I_EDN]);
  a.acc = ptr<float>(ia[I_ACC]);
  a.gates = ptr<float>(ia[I_GATES]);
  a.sgate = ptr<float>(ia[I_SGATE]);
  a.xe = ptr<__nv_bfloat16>(ia[I_XE]);
  a.eidx = ptr<int>(ia[I_EIDX]);
  a.eslot = ptr<int>(ia[I_ESLOT]);
  a.ecount = ptr<int>(ia[I_ECOUNT]);
  a.E = (int)ia[I_E];
  a.k_top = (int)ia[I_K_TOP];
  a.norm_topk = (int)ia[I_NORM_TOPK];
  a.has_shared = (int)ia[I_HAS_SHARED];
  a.has_sgate = (int)ia[I_HAS_SGATE];
  a.shared_inter = (int)ia[I_SHARED_INTER];
  a.EP = (int)ia[I_EP];
  a.scap = (int)ia[I_SCAP];
  a.launches = ptr<unsigned long long>(ia[I_LAUNCHES]);
  a.trace = ptr<unsigned long long>(ia[I_TRACE]);
  a.S = (int)ia[I_S];
  a.L = (int)ia[I_L];
  a.hid = (int)ia[I_HID];
  a.H = (int)ia[I_H];
  a.KH = (int)ia[I_KH];
  a.inter = (int)ia[I_INTER];
  a.V = (int)ia[I_V];
  a.ps = (int)ia[I_PS];
  a.maxPb = (int)ia[I_MAXPB];
  a.kv_kind = (int)ia[I_KV_KIND];
  a.ql = (int)ia[I_QL];
  a.eps = (float)fa[0];
  a.att_scale = (float)fa[1];
  for (int i = 0; i < kStreams; ++i)
    fill_stream(a.st[i], ia + I_STREAMS + kStreamArgs * i);
}

}  // namespace
