// Expert-grouped fused-dequant GEMM for MoE layers (A16W4 / A16W8), sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/grouped_quant_matmul.py
// `grouped_quant_matmul` (the Pallas `_gkernel`), which ops/moe.py runs
// three times a MoE layer (gate, up, down) on the per-op path.
//
// What it computes: xs [Mcap, K] bf16 holds the tokens sorted by expert and
// boundary-padded so that every TM-row tile belongs to one expert
// (ops/grouped_quant_matmul.py `build_group_layout`); tile m uses expert
// tile_expert[m]'s weights:
//     out[r, n] = sum_g scale[e, g, n] * (x_g . q_g)[r, n]
//                       + xsum[r, g] * zero[e, g, n]
// per quant group g, the integer payload exact, bf16 operands, f32 sums,
// scale and zero as stored (f32), out bf16: the Pallas kernel's affine
// after the dot.
//
// What bounds it on the H100: bytes at the serving shapes. Each tile reads
// its expert's payload once (K x 256 u4 bytes a column tile) for at most TM
// rows, so the routed experts' payload is the full-size read (a bucket-32
// prefill routes 128 rows over ~53 of Qwen1.5-MoE's 60 experts: ~2-3 rows a
// tile, far under the ~295 operations a byte where the tensor cores would
// limit).
//
// What this design does about it. It is csrc/quant_matmul.cu's product with
// one extra indirection, the tile's expert base pointer, and an M tile of
// TM rows (16 / 32 / 64): a block owns one (M tile, 256-column tile) pair,
// streams 64-row K chunks of the expert's TILE-128 u4 (or int8) payload and
// of the tile's x rows through a three-stage cp.async ring and runs
// mma.sync m16n8k16 on them (a u4 level n enters as bf16(128 + n); the
// 128 * sum(x) comes back off in the group affine). The static Mcap is
// mostly padding, so a tile reads its real row count (`tile_rows`, from the
// layout) and runs the tensor cores only over the 16-row slices that hold
// rows, and a tile that holds none writes its zeros and exits without
// reading a weight byte. The x rows' sums for the affine come from the A
// fragments the warp already holds (the four lanes of a row add theirs
// at a group's end), so no extra pass over x is needed.

#include "di_common.cuh"

namespace {

using namespace di;

constexpr int kTileN = 256;     // output columns per block
constexpr int kChunkK = 64;     // K rows staged per step
constexpr int kThreads = 256;   // 8 warps
constexpr int kStages = 3;
constexpr int kAPad = kChunkK + 8;   // bf16 per staged x row (no conflicts)

template <int BITS>
__host__ __device__ constexpr int w_row_pad() {
  return (BITS == 4 ? kTileN / 2 : kTileN) + 16;
}

template <int BITS, int MT>
__host__ __device__ constexpr int stage_bytes() {
  return 16 * MT * kAPad * 2 + kChunkK * w_row_pad<BITS>();
}

// bf16 pair -> the sum of its two values
__device__ __forceinline__ float pair_sum(uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xFFFF0000u);
}

// grid = (Mcap / TM, N / 256); MT = TM / 16 m16 slices a tile.
template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads, 1)
gqm_kernel(const __nv_bfloat16* __restrict__ xs,
           const int* __restrict__ tile_expert,
           const int* __restrict__ tile_rows, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ zero,
           __nv_bfloat16* __restrict__ out, int K, int N, int G,
           unsigned long long* __restrict__ launches) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kRowBytes = BITS == 4 ? kTileN / 2 : kTileN;
  constexpr int kRowPad = w_row_pad<BITS>();
  constexpr int kVecPerRow = kRowBytes / 16;
  constexpr int kRows = 16 * MT;
  constexpr int kABytes = kRows * kAPad * 2;
  constexpr int kStage = stage_bytes<BITS, MT>();
  constexpr float kOffset = BITS == 4 ? 128.f : 0.f;

  const int mtile = blockIdx.x, ntile = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (mtile == 0 && ntile == 0 && tid == 0) atomicAdd(launches, 1ull);
  const int rows =
      tile_rows == nullptr ? kRows : min(tile_rows[mtile], kRows);
  const int nsl = (rows + 15) / 16;      // 16-row slices that hold rows
  const int e = tile_expert[mtile];
  const size_t w_row = BITS == 4 ? (size_t)N / 2 : (size_t)N;
  const uint8_t* w_tile =
      w + (size_t)e * K * w_row + (size_t)ntile * kRowBytes;
  const float* s_e = scale + (size_t)e * G * N;
  const float* z_e = zero + (size_t)e * G * N;
  const __nv_bfloat16* x_tile = xs + (size_t)mtile * kRows * K;
  const int n_chunks = rows > 0 ? K / kChunkK : 0;
  const int cpg = K / G / kChunkK;       // chunks per quant group

  float acc[MT][4][4], part[MT][4][4], xs_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xs_r[mt][0] = xs_r[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = part[mt][j][i] = 0.f;
  }

  auto stage = [&](int c, int buf) {
    uint8_t* a_s = smem + (size_t)buf * kStage;
    uint8_t* w_s = a_s + kABytes;
    for (int i = tid; i < nsl * 16 * 8; i += kThreads) {
      const int r = i >> 3, seg = i & 7;
      cp_async16(a_s + r * (kAPad * 2) + seg * 16,
                 x_tile + (size_t)r * K + (size_t)c * kChunkK + seg * 8);
    }
    for (int i = tid; i < kChunkK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, v = i % kVecPerRow;
      cp_async16(w_s + r * kRowPad + v * 16,
                 w_tile + (size_t)(c * kChunkK + r) * w_row + v * 16);
    }
  };

  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) stage(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c % kStages;
    if (c + kStages - 1 < n_chunks)
      stage(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();   // chunk c's x rows and payload are in shared memory

    const __nv_bfloat16* a_s =
        reinterpret_cast<const __nv_bfloat16*>(smem + (size_t)buf * kStage);
    const uint8_t* w_s = smem + (size_t)buf * kStage + kABytes;
#pragma unroll
    for (int s = 0; s < kChunkK / 16; ++s) {
      uint32_t lo[2][2], hi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        b_frags<BITS>(w_s, kRowPad, 16 * s + 2 * tig,
                      16 * warp + 8 * nt + gid, lo[nt], hi[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= nsl) continue;          // block-uniform
        uint32_t af[4];
        ldmatrix_x4(af, a_s + (mt * 16 + (lane & 15)) * kAPad + 16 * s +
                            8 * (lane >> 4));
        // a0 / a2: row gid, a1 / a3: row gid + 8
        xs_r[mt][0] += pair_sum(af[0]) + pair_sum(af[2]);
        xs_r[mt][1] += pair_sum(af[1]) + pair_sum(af[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16_16816(part[mt][nt], af, lo[nt][0], lo[nt][1]);
          mma_bf16_16816(part[mt][2 + nt], af, hi[nt][0], hi[nt][1]);
        }
      }
    }

    if ((c + 1) % cpg == 0) {            // the quant group's last chunk
      const int g = c / cpg;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the four lanes of a row hold its sum in parts
          float v = xs_r[mt][h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          xs_r[mt][h] = v;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = ntile * kTileN + (j >> 1) * 128 + 16 * warp +
                        8 * (j & 1) + 2 * tig;
        const float2 sc =
            *reinterpret_cast<const float2*>(s_e + (size_t)g * N + col);
        const float2 ze =
            *reinterpret_cast<const float2*>(z_e + (size_t)g * N + col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = xs_r[mt][i >> 1];
            acc[mt][j][i] += (part[mt][j][i] - kOffset * x) *
                                 ((i & 1) ? sc.y : sc.x) +
                             x * ((i & 1) ? ze.y : ze.x);
            part[mt][j][i] = 0.f;
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) xs_r[mt][0] = xs_r[mt][1] = 0.f;
    }
    __syncthreads();   // buffer `buf` is free for chunk c + kStages
  }
  cp_async_wait<0>();

  // every row of the tile: a row past `rows` holds 0 (its x row is 0)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = ntile * kTileN + (j >> 1) * 128 + 16 * warp + 8 * (j & 1) +
                    2 * tig;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = (size_t)mtile * kRows + mt * 16 + gid + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(out + row * N + col) =
            __floats2bfloat162_rn(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
  }
}

template <int BITS, int MT>
int launch(const void* xs, const int* te, const int* rows, const void* w,
           const float* scale, const float* zero, void* out, int Mcap, int K,
           int N, int G, unsigned long long* launches, cudaStream_t stream) {
  const int smem = kStages * stage_bytes<BITS, MT>();
  cudaFuncSetAttribute(gqm_kernel<BITS, MT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(Mcap / (16 * MT), N / kTileN);
  gqm_kernel<BITS, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xs), te, rows,
      static_cast<const uint8_t*>(w), scale, zero,
      static_cast<__nv_bfloat16*>(out), K, N, G, launches);
  return (int)cudaGetLastError();
}

}  // namespace

// xs: [Mcap, K] bf16; tile_expert: [Mcap / TM] int32; tile_rows: [Mcap / TM]
// int32 real rows per tile, or null (every row); w: [E, K, N/2] u4 TILE-128
// (bits 4) or [E, K, N] int8; scale / zero: [E, G, N] f32; out: [Mcap, N]
// bf16. Requires TM in {16, 32, 64}, N % 256 == 0, K / G % 64 == 0,
// 16-byte aligned xs and w (ops/grouped_quant_matmul.py checks it all).
// Returns cudaGetLastError().
extern "C" int di_grouped_quant_matmul(const void* xs, const int* tile_expert,
                                       const int* tile_rows, const void* w,
                                       int bits, const float* scale,
                                       const float* zero, void* out, int Mcap,
                                       int K, int N, int G, int E, int TM,
                                       unsigned long long* launches,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % kTileN || (K / G) % kChunkK || Mcap % TM || E < 1)
    return (int)cudaErrorInvalidValue;
#define DI_GQM(B, M)                                                        \
  if (bits == B && TM == 16 * M)                                            \
    return launch<B, M>(xs, tile_expert, tile_rows, w, scale, zero, out,    \
                        Mcap, K, N, G, launches, s);
  DI_GQM(4, 1) DI_GQM(4, 2) DI_GQM(4, 4)
  DI_GQM(8, 1) DI_GQM(8, 2) DI_GQM(8, 4)
#undef DI_GQM
  return (int)cudaErrorInvalidValue;
}
