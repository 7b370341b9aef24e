// Expert-grouped fused-dequant GEMM for MoE layers (A16W4 / A16W8), sm_90a:
// a bytes-first design for tiles that hold few rows, the weights as the
// tensor cores' A operand.
//
// Replaces: dashinfer_tpu/ops/pallas/grouped_quant_matmul.py
// `grouped_quant_matmul` (the Pallas `_gkernel`), which ops/moe.py runs
// three times a MoE layer (gate, up, down) on the per-op path: every
// bucket-32 prompt of MoE serving, every prompt of MoE serving on a (1, n)
// mesh, and per-op MoE decode.
//
// What it computes: xs [Mcap, K] bf16 holds the tokens sorted by expert and
// boundary-padded so that every TM-row tile belongs to one expert
// (ops/grouped_quant_matmul.py `build_group_layout`); tile m uses expert
// tile_expert[m]'s weights:
//     out[r, n] = sum_g scale[e, g, n] * (x_g . q_g)[r, n]
//                       + xsum[r, g] * zero[e, g, n]
// per quant group g, the integer payload exact, bf16 operands, f32 sums,
// scale and zero as stored (f32), out bf16; rows past the tile's real rows
// are written 0.
//
// What bounds it on the H100: bytes at the serving shapes. Each tile reads
// its expert's payload once for at most TM rows: a bucket-32 prefill routes
// 128 rows over ~53 of Qwen1.5-MoE's 60 experts, ~2-3 rows a tile, far under
// the ~295 operations a byte where the tensor cores would limit. The first
// design ran x as the mma's A operand (16-row slices of which ~85% were
// padding, every warp dequantizing its B fragments at full width) with one
// 256-thread block an SM and ~16 KB in flight: ~0.58 TB/s.
//
// What this design does about it:
//  * "Swap AB": out^T = W^T xs^T. The weights are the A operand, so the 16
//    rows of an mma tile are output columns and none is padding; the tile's
//    real rows are the n8 side, as many n-tiles as the block's rows need,
//    chosen per block on the card from tile_rows[m] (routing is
//    data-dependent; the call stays free of host syncs and CUDA-graph
//    capturable). A u4 byte holds column j (low) and j + 128 (high) in the
//    TILE-128 layout: one byte of 4 k-rows is one m16 tile's A fragment
//    (rows gid / gid + 8 = the low / high column), made in registers with
//    the magic16 chain (a level n as bf16(128 + n), the 128 * sum(x) taken
//    back off in the group affine); int8 exactly through f32. A lane's 4
//    k-rows of a k16-step are consecutive, so its x B fragment is one
//    8-byte load; the x rows' sums come from one more product with ones.
//  * More bytes in flight: a block (128 threads) covers one "item" of
//    32 LB payload bytes of each k-row and at most RM rows of an M tile, and
//    streams 64-row K chunks through a cp.async ring of ST stages (the
//    payload swizzled against bank conflicts); qparams of a group are
//    loaded a group ahead into registers. A tile of more rows is several
//    blocks side by side in the grid, whose payload reads meet in L2; a
//    tile with no rows writes its zeros and reads nothing.
//  * The block shape (LB, RM, ST) is one of three, picked by the wrapper
//    from static shapes (rows an expert gets on average): 64-byte items and
//    32 rows for a decode batch (twice the blocks: ~25 experts hold rows),
//    128-byte items and 16 rows up to ~12 rows an expert (bucket-32 and
//    -128 prefills), 32 rows beyond. Measured at Qwen1.5-MoE width against
//    the first design (one 256-thread block an SM, x as the A operand):
//    2.3x faster at a bucket-32 prefill's gate, 1.3x at 4,096 rows.
//  What still bounds it: the dequant and product chain of
//  few warps an SM (~1.4 TB/s of u4 at bucket 32, as the stream probe's u4
//  rate); at 4,096 rows the products, at ~10% of the tensor cores' peak
//  (mma.sync, 8 warps an SM): `wgmma` over full tiles is later work.

#include "di_common.cuh"

namespace {

using namespace di;

constexpr int kThreads = 128;               // 4 warps
constexpr int kChunkK = 64;                 // K rows staged per step
constexpr int kXStride = 2 * kChunkK + 32;  // bytes of a staged x row
// The block shapes (LB, RM, ST): payload bytes a lane reads of a k-row (a
// warp 8 lanes x that, the block 4 warps), tile rows a block covers, ring
// stages. The wrapper picks one from static shapes
// (ops/grouped_quant_matmul.py `block_shape`).
constexpr int kShapes[3][3] = {{2, 32, 4}, {4, 16, 4}, {4, 32, 3}};
constexpr uint32_t kOnes = 0x3F803F80u;     // bf16 (1, 1)

template <int LB>
__host__ __device__ constexpr int item_bytes() { return 32 * LB; }
template <int LB, int RM>
__host__ __device__ constexpr int stage_bytes() {
  return kChunkK * item_bytes<LB>() + RM * kXStride;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid = (n_rg * n_items, Mcap / TM): block x = item * n_rg + rg covers tile
// rows [RM rg, RM rg + RM) (of TM) and an item of 32 LB payload bytes of
// each k-row. A lane reads LB bytes (8 LB warp + LB gid of the item) of 4
// consecutive k-rows per k16-step. u4: byte i is m16 tile i (row gid = its
// low column c + i, row gid + 8 = the high column c + 128 + i); int8:
// bytes 2i, 2i + 1 are m16 tile i's rows gid, gid + 8.
template <int BITS, int LB, int RM, int ST>
__global__ void __launch_bounds__(kThreads)
gqm_kernel(const __nv_bfloat16* __restrict__ xs,
           const int* __restrict__ tile_expert,
           const int* __restrict__ tile_rows, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ zero,
           __nv_bfloat16* __restrict__ out, int K, int N, int G, int TM,
           int n_rg, unsigned long long* __restrict__ launches) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kItem = item_bytes<LB>();
  constexpr int kPieces = kItem / 16;          // 16-byte pieces of a k-row
  constexpr int MTW = BITS == 4 ? LB : LB / 2; // m16 tiles a lane feeds
  constexpr int NT = RM / 8;                   // n8 tiles
  constexpr int kStage = stage_bytes<LB, RM>();
  constexpr float kOffset = BITS == 4 ? 128.f : 0.f;
  const int item = blockIdx.x / n_rg, rg = blockIdx.x - item * n_rg;
  const int m = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (blockIdx.x == 0 && m == 0 && tid == 0) atomicAdd(launches, 1ull);

  const int rows_tile = tile_rows == nullptr ? TM : min(tile_rows[m], TM);
  const int row0 = rg * RM;
  const int rows_blk = min(TM - row0, RM);             // rows it writes
  const int rows = max(0, min(rows_tile - row0, rows_blk));   // real rows
  const int nt = (rows + 7) / 8;
  const int lane_byte = item * kItem + 8 * LB * warp + LB * gid;
  // this lane's first column: u4 columns c .. c + LB - 1 and c + 128 ..
  const int colbase = BITS == 4 ? 256 * (lane_byte >> 7) + (lane_byte & 127)
                                : lane_byte;
  __nv_bfloat16* out_blk = out + ((size_t)m * TM + row0) * N + colbase;

  auto zero_rows = [&](int from) {
    for (int r = from + tig; r < rows_blk; r += 4) {
#pragma unroll
      for (int i = 0; i < LB; i += 2) {
        store2(out_blk + (size_t)r * N + i, 0.f, 0.f);
        if (BITS == 4) store2(out_blk + (size_t)r * N + 128 + i, 0.f, 0.f);
      }
    }
  };
  if (nt == 0) {        // block-uniform: no row here, no weight byte read
    zero_rows(0);
    return;
  }

  const int e = tile_expert[m];
  const size_t w_row = BITS == 4 ? (size_t)N / 2 : (size_t)N;
  const uint8_t* w_item = w + (size_t)e * K * w_row + (size_t)item * kItem;
  const float* s_e = scale + (size_t)e * G * N + colbase;
  const float* z_e = zero + (size_t)e * G * N + colbase;
  const __nv_bfloat16* x_blk = xs + ((size_t)m * TM + row0) * K;
  const int n_chunks = K / kChunkK;
  const int cpg = K / G / kChunkK;       // chunks per quant group
  const int xrows = 8 * nt;

  // piece p of k-row r sits at p ^ swz(r): the 4 k-rows a warp reads at
  // once (r = 16s + 4tig + j, tig = 0..3) land on distinct banks
  auto swz = [](int r) { return ((r >> 2) & 3) * (LB / 2); };
  auto stage = [&](int c) {
    uint8_t* w_s = smem + (c % ST) * kStage;
    uint8_t* x_s = w_s + kChunkK * kItem;
    for (int i = tid; i < kChunkK * kPieces; i += kThreads) {
      const int r = i / kPieces, p = i % kPieces;
      cp_async16(w_s + r * kItem + ((p ^ swz(r)) << 4),
                 w_item + (size_t)(c * kChunkK + r) * w_row + p * 16);
    }
    for (int i = tid; i < xrows * 8; i += kThreads) {
      const int r = i >> 3, p = i & 7;
      cp_async16(x_s + r * kXStride + p * 16,
                 x_blk + (size_t)r * K + c * kChunkK + p * 8);
    }
  };

  // a group's scale / zero of this lane's columns, [0]: c .. c + LB - 1,
  // [1]: c + 128 .. (u4); loaded a group ahead
  float qs[2][LB], qz[2][LB], qs_n[2][LB], qz_n[2][LB];
  auto load_qp = [&](int g) {
#pragma unroll
    for (int h = 0; h < (BITS == 4 ? 2 : 1); ++h)
#pragma unroll
      for (int i = 0; i < LB; i += 2) {
        const float2 a = *reinterpret_cast<const float2*>(
            s_e + (size_t)g * N + 128 * h + i);
        const float2 b = *reinterpret_cast<const float2*>(
            z_e + (size_t)g * N + 128 * h + i);
        qs_n[h][i] = a.x;
        qs_n[h][i + 1] = a.y;
        qz_n[h][i] = b.x;
        qz_n[h][i + 1] = b.y;
      }
  };
#pragma unroll
  for (int i = 0; i < LB; ++i)
    qs[1][i] = qz[1][i] = qs_n[1][i] = qz_n[1][i] = 0.f;
  load_qp(0);

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_chunks) stage(i);
    cp_async_commit();
  }

  // part: the group's raw products; xsm: the group's x-row sums, by a
  // product with ones (c0 / c1: rows 8n + 2tig, + 1)
  float acc[MTW][NT][4], part[MTW][NT][4], xsm[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) xsm[n][j] = 0.f;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = part[i][n][j] = 0.f;
  }
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  // this lane's LB bytes of a k-row: its 16-byte piece, swizzled, and the
  // offset in it
  const int lane_off =
      ((LB * 8 * warp + LB * gid) & ~15) ^ (tig * (LB / 2) << 4);
  const int lane_in = (LB * gid) & 15;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // chunk c is in shared memory
    if (c + ST - 1 < n_chunks) stage(c + ST - 1);
    cp_async_commit();
    if (c % cpg == 0) {                  // a group starts: its qparams
      const int g = c / cpg;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          qs[h][i] = qs_n[h][i];
          qz[h][i] = qz_n[h][i];
        }
      if (g + 1 < G) load_qp(g + 1);
    }

    const uint8_t* w_s = smem + (c % ST) * kStage;
    const uint8_t* x_s = w_s + kChunkK * kItem;
#pragma unroll
    for (int s = 0; s < kChunkK / 16; ++s) {
      // k-rows 16s + 4tig + j: (j = 0, 1) -> a0 / a1, (2, 3) -> a2 / a3
      uint32_t wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = w_s + (16 * s + 4 * tig + j) * kItem + lane_off +
                           lane_in;
        wv[j] = LB == 2 ? (uint32_t)*reinterpret_cast<const uint16_t*>(p)
                        : *reinterpret_cast<const uint32_t*>(p);
      }
      uint32_t a[MTW][4];
      if (BITS == 4) {
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const uint32_t sel = i | ((4 + i) << 8);   // byte i of two words
          const uint32_t p01 = __byte_perm(wv[0], wv[1], sel);
          const uint32_t p23 = __byte_perm(wv[2], wv[3], sel);
          a[i][0] = u4_lo(p01);    // row gid: column c + i
          a[i][1] = u4_hi(p01);    // row gid + 8: column c + 128 + i
          a[i][2] = u4_lo(p23);
          a[i][3] = u4_hi(p23);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] ^= 0x80808080u;
#pragma unroll
        for (int i = 0; i < MTW; ++i) {   // rows gid / gid + 8: bytes 2i, 2i+1
          a[i][0] = pack_bf16(i8_level(wv[0], 2 * i), i8_level(wv[1], 2 * i));
          a[i][1] = pack_bf16(i8_level(wv[0], 2 * i + 1),
                              i8_level(wv[1], 2 * i + 1));
          a[i][2] = pack_bf16(i8_level(wv[2], 2 * i), i8_level(wv[3], 2 * i));
          a[i][3] = pack_bf16(i8_level(wv[2], 2 * i + 1),
                              i8_level(wv[3], 2 * i + 1));
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nt) {                    // block-uniform
          const uint2 bx = *reinterpret_cast<const uint2*>(
              x_s + (8 * n + gid) * kXStride + 2 * (16 * s + 4 * tig));
          mma_bf16_16816(xsm[n], ones, bx.x, bx.y);
#pragma unroll
          for (int i = 0; i < MTW; ++i)
            mma_bf16_16816(part[i][n], a[i], bx.x, bx.y);
        }
      }
    }

    if ((c + 1) % cpg == 0) {            // the group's last chunk: affine
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nt) {
          const float xa = xsm[n][0], xb = xsm[n][1];   // rows 2tig, 2tig+1
#pragma unroll
          for (int i = 0; i < MTW; ++i) {
            // scale / zero of the columns of rows gid and gid + 8
            const float s0 = BITS == 4 ? qs[0][i] : qs[0][2 * i];
            const float s1 = BITS == 4 ? qs[1][i] : qs[0][2 * i + 1];
            const float z0 = BITS == 4 ? qz[0][i] : qz[0][2 * i];
            const float z1 = BITS == 4 ? qz[1][i] : qz[0][2 * i + 1];
            float* p = part[i][n];
            float* o = acc[i][n];
            o[0] += (p[0] - kOffset * xa) * s0 + xa * z0;
            o[1] += (p[1] - kOffset * xb) * s0 + xb * z0;
            o[2] += (p[2] - kOffset * xa) * s1 + xa * z1;
            o[3] += (p[3] - kOffset * xb) * s1 + xb * z1;
            p[0] = p[1] = p[2] = p[3] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) xsm[n][j] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows 8n + 2tig (+1) of the block; a row past the real ones holds 0
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
      const int r0 = 8 * n + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = r0 + h < rows;
        __nv_bfloat16* o = out_blk + (size_t)(r0 + h) * N;
#pragma unroll
        for (int i = 0; i < MTW; i += (BITS == 4 ? 2 : 1)) {
          if (BITS == 4) {   // m16 tiles i, i + 1: columns c + i, c + i + 1
            store2(o + i, ok ? acc[i][n][h] : 0.f,
                   ok ? acc[i + 1][n][h] : 0.f);
            store2(o + 128 + i, ok ? acc[i][n][2 + h] : 0.f,
                   ok ? acc[i + 1][n][2 + h] : 0.f);
          } else {           // m16 tile i: columns c + 2i, c + 2i + 1
            store2(o + 2 * i, ok ? acc[i][n][h] : 0.f,
                   ok ? acc[i][n][2 + h] : 0.f);
          }
        }
      }
    }
  }
  zero_rows(8 * nt);
}

template <int BITS, int LB, int RM, int ST>
int launch(const void* xs, const int* te, const int* rows, const void* w,
           const float* scale, const float* zero, void* out, int Mcap, int K,
           int N, int G, int TM, unsigned long long* launches,
           cudaStream_t stream) {
  constexpr int smem = ST * stage_bytes<LB, RM>();
  auto kern = gqm_kernel<BITS, LB, RM, ST>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int n_rg = (TM + RM - 1) / RM;
  const int n_items = (BITS == 4 ? N / 2 : N) / item_bytes<LB>();
  dim3 grid(n_rg * n_items, Mcap / TM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xs), te, rows,
      static_cast<const uint8_t*>(w), scale, zero,
      static_cast<__nv_bfloat16*>(out), K, N, G, TM, n_rg, launches);
  return (int)cudaGetLastError();
}

}  // namespace

// xs: [Mcap, K] bf16; tile_expert: [Mcap / TM] int32; tile_rows: [Mcap / TM]
// int32 real rows per tile, or null (every row); w: [E, K, N/2] u4 TILE-128
// (bits 4) or [E, K, N] int8; scale / zero: [E, G, N] f32; out: [Mcap, N]
// bf16; shape: the row of kShapes to launch. Requires TM in {16, 32, 64},
// N % 256 == 0, K / G % 64 == 0, 16-byte aligned xs and w
// (ops/grouped_quant_matmul.py checks it all). Returns cudaGetLastError().
extern "C" int di_grouped_quant_matmul(const void* xs, const int* tile_expert,
                                       const int* tile_rows, const void* w,
                                       int bits, const float* scale,
                                       const float* zero, void* out, int Mcap,
                                       int K, int N, int G, int E, int TM,
                                       int shape, unsigned long long* launches,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 256 || G < 1 || K % G || (K / G) % kChunkK || E < 1 ||
      (TM != 16 && TM != 32 && TM != 64) || Mcap % TM || shape < 0 ||
      shape > 2 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
#define DI_GQM(B, S)                                                         \
  if (bits == B && shape == S)                                               \
    return launch<B, kShapes[S][0], kShapes[S][1], kShapes[S][2]>(           \
        xs, tile_expert, tile_rows, w, scale, zero, out, Mcap, K, N, G, TM,  \
        launches, s);
  DI_GQM(4, 0) DI_GQM(4, 1) DI_GQM(4, 2)
  DI_GQM(8, 0) DI_GQM(8, 1) DI_GQM(8, 2)
#undef DI_GQM
  return (int)cudaErrorInvalidValue;
}
