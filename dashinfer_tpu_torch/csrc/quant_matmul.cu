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
// Qwen2-7B streams ~3.98 GB, ~1.19 ms at 3.35 TB/s.
//
// What this design does about it: the weight is never dequantized to memory,
// and the dot runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), so even at M = 32 the instruction stream stays far below the
// byte stream. Each block owns one 256-column tile (one TILE-128 u4 tile:
// byte j of a row holds columns j and j+128) and a range of whole quant
// groups; it streams 64 K-rows of payload at a time into shared memory with
// 16-byte cp.async copies, four chunks deep (two for int8), so the next
// chunks are in flight while the tensor cores work on this one. Warp w takes
// byte columns 16w..16w+15, i.e. output columns 16w.. (low nibbles) and
// 128+16w.. (high nibbles): each byte it reads feeds two mma tiles. A u4 level n becomes the
// bf16 of 128 + n by one OR (0x4300 | n); the 128 * sum(bf16(x)) this adds is
// taken off in the per-group affine, applied to the f32 accumulators once per
// group. Narrow outputs (k/v_proj: 2 tiles) would leave the card empty, so the
// K range is split across blocks (grid.y) and a second small kernel sums the
// f32 partials.

#include "di_common.cuh"

#include <algorithm>

namespace {

using namespace di;

constexpr int kTileN = 256;     // output columns per block
constexpr int kChunkK = 64;     // K rows staged per step
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kXStride = kChunkK + 8;   // bf16; keeps A-fragment loads
                                        // free of bank conflicts

// Per-call x preparation, one block per K chunk (64 rows of one quant
// group): the chunk's x as the bf16 dot operand, zero past M and past the
// group, and the chunk's sums of the f32 x and of bf16(x) per row. Record
// layout: [kRows][64] bf16, then [2][kRows] f32 (kRows = 16 * MT).
template <int MT>
__host__ __device__ constexpr int record_bytes() {
  return 16 * MT * (kChunkK * 2 + 8);
}

template <typename XT, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_prep(const XT* __restrict__ x, uint8_t* __restrict__ records, int M,
         int K, int G, int chunks_per_group) {
  constexpr int kRows = 16 * MT;
  const int chunk = blockIdx.x;
  const int gs = K / G;
  const int kc = (chunk % chunks_per_group) * kChunkK;
  const int k0 = (chunk / chunks_per_group) * gs + kc;
  const int rows = min(kChunkK, gs - kc);
  uint8_t* rec = records + (size_t)chunk * record_bytes<MT>();
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(rec);
  float* sums = reinterpret_cast<float*>(rec + kRows * kChunkK * 2);
  for (int i = threadIdx.x; i < kRows * kChunkK; i += kThreads) {
    const int m = i / kChunkK, r = i % kChunkK;
    xt[i] = __float2bfloat16(
        (m < M && r < rows) ? to_f32(x[(size_t)m * K + k0 + r]) : 0.f);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < kRows; m += kWarps) {
    float s = 0.f, sb = 0.f;
    if (m < M) {
      for (int r = lane; r < rows; r += 32) {
        const float v = to_f32(x[(size_t)m * K + k0 + r]);
        s += v;
        sb += __bfloat162float(__float2bfloat16(v));
      }
    }
    s = warp_sum(s);
    sb = warp_sum(sb);
    if (lane == 0) {
      sums[m] = s;
      sums[kRows + m] = sb;
    }
  }
}

// grid = (N / 256, ksplit); block = 256 threads; MT = ceil(M / 16) m16
// tiles. Warp w, lane (gid = lane / 4, tig = lane % 4) holds the mma C
// fragments of rows mt*16 + gid (+8) and, for j in 0..3, columns
// col0(j) + 2*tig (+1) with col0 = 16w, 16w+8, 128+16w, 128+16w+8.
// Each chunk's payload rows and its x record arrive by cp.async, so no
// global load sits in the loop's critical path.
template <typename OT, int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const uint8_t* __restrict__ records, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ zero,
           OT* __restrict__ out, float* __restrict__ partial,
           int M, int K, int N, int G, int groups_per_split,
           unsigned long long* __restrict__ launches) {
  constexpr int kRowBytes = BITS == 4 ? kTileN / 2 : kTileN;
  constexpr int kRowPad = kRowBytes + 16;   // 16B-aligned rows, fewer
                                            // bank conflicts
  constexpr int kVecPerRow = kRowBytes / 16;
  constexpr int kRows = 16 * MT;            // padded M
  constexpr int kXVecs = kRows * kChunkK * 2 / 16;   // x tile, 16B pieces
  constexpr int kSumVecs = kRows * 8 / 16;           // the two sum rows
  constexpr int kStages = BITS == 4 ? 3 : 2;  // chunks in flight
  // a u4 level is fed to the tensor cores as 128 + n
  constexpr float kOffset = BITS == 4 ? 128.f : 0.f;
  __shared__ __align__(16) uint8_t w_s[kStages][kChunkK * kRowPad];
  __shared__ __align__(16) __nv_bfloat16 x_s[kStages][kRows * kXStride];
  __shared__ __align__(16) float sum_s[kStages][2 * kRows];

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  if (tile == 0 && split == 0 && tid == 0) atomicAdd(launches, 1ull);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int gs = K / G;
  const int g0 = split * groups_per_split;
  const int g1 = min(G, g0 + groups_per_split);
  const int chunks_per_group = (gs + kChunkK - 1) / kChunkK;
  const int c0 = g0 * chunks_per_group;      // first global chunk
  const int n_chunks = (g1 - g0) * chunks_per_group;
  const size_t w_row = BITS == 4 ? (size_t)N / 2 : (size_t)N;
  const uint8_t* w_tile = w + (size_t)tile * kRowBytes;
  const int col_base = tile * kTileN;

  float acc[MT][4][4], part[MT][4][4];
  float xs[MT][2], xb[MT][2];   // group sums of this thread's rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xs[mt][0] = xs[mt][1] = xb[mt][0] = xb[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = part[mt][j][i] = 0.f;
  }

  auto chunk_rows = [&](int c, int& k0) {
    const int kc = (c % chunks_per_group) * kChunkK;
    k0 = (g0 + c / chunks_per_group) * gs + kc;
    return min(kChunkK, gs - kc);
  };
  auto stage = [&](int c, int buf) {
    int k0;
    const int rows = chunk_rows(c, k0);
    for (int i = tid; i < rows * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, v = i % kVecPerRow;
      cp_async16(&w_s[buf][r * kRowPad + v * 16],
                 w_tile + (size_t)(k0 + r) * w_row + v * 16);
    }
    const uint8_t* rec = records + (size_t)(c0 + c) * record_bytes<MT>();
    for (int i = tid; i < kXVecs + kSumVecs; i += kThreads) {
      if (i < kXVecs) {
        const int m = i / (kChunkK * 2 / 16), v = i % (kChunkK * 2 / 16);
        cp_async16(&x_s[buf][m * kXStride + v * 8], rec + i * 16);
      } else {
        const int v = i - kXVecs;
        cp_async16(&sum_s[buf][v * 4], rec + kXVecs * 16 + v * 16);
      }
    }
    cp_async_commit();
  };

  // one cp.async group per chunk slot (empty past the end), so that
  // waiting for all but the newest kStages - 1 groups lands chunk c
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks)
      stage(c, c);
    else
      cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c % kStages;
    const int ahead = c + kStages - 1;
    if (ahead < n_chunks)
      stage(ahead, ahead % kStages);
    else
      cp_async_commit();
    int k0;
    const int steps = (chunk_rows(c, k0) + 15) / 16;
    cp_async_wait<kStages - 1>();
    __syncthreads();   // chunk c's payload and x record are in shared memory

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xs[mt][h] += sum_s[buf][mt * 16 + gid + 8 * h];
        xb[mt][h] += sum_s[buf][kRows + mt * 16 + gid + 8 * h];
      }
    const uint8_t* ws = w_s[buf];
    const __nv_bfloat16* xsm = x_s[buf];
    for (int s = 0; s < steps; ++s) {
      const int kk = s * 16;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xsm + (mt * 16 + gid) * kXStride + kk +
                                  2 * tig;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xr);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXStride);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t lo[2], hi[2];
        b_frags<BITS>(ws, kRowPad, kk + 2 * tig, 16 * warp + 8 * nt + gid,
                      lo, hi);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(part[mt][nt], a[mt], lo[0], lo[1]);
          mma_bf16_16816(part[mt][2 + nt], a[mt], hi[0], hi[1]);
        }
      }
    }

    if ((c + 1) % chunks_per_group == 0) {   // last chunk of its group
      const int g = g0 + c / chunks_per_group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col_base + (j >> 1) * 128 + 16 * warp + 8 * (j & 1) +
                        2 * tig;
        const float2 sc = *reinterpret_cast<const float2*>(
            scale + (size_t)g * N + col);
        const float2 ze = *reinterpret_cast<const float2*>(
            zero + (size_t)g * N + col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1;
            const float s_ = (i & 1) ? sc.y : sc.x;
            const float z_ = (i & 1) ? ze.y : ze.x;
            acc[mt][j][i] += (part[mt][j][i] - kOffset * xb[mt][h]) * s_ +
                             xs[mt][h] * z_;
            part[mt][j][i] = 0.f;
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        xs[mt][0] = xs[mt][1] = xb[mt][0] = xb[mt][1] = 0.f;
    }
    __syncthreads();   // buffer `buf` is free for chunk c + kStages
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col_base + (j >> 1) * 128 + 16 * warp + 8 * (j & 1) +
                    2 * tig;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mt * 16 + gid + 8 * (i >> 1);
        if (m >= M) continue;
        const int n = col + (i & 1);
        if (partial != nullptr)
          partial[((size_t)split * M + m) * N + n] = acc[mt][j][i];
        else
          store(out + (size_t)m * N + n, acc[mt][j][i]);
      }
  }
}

// out[i] = sum_s partial[s, i] for the split-K launches.
template <typename OT>
__global__ void qmm_reduce(const float* __restrict__ partial,
                           OT* __restrict__ out, int count, int ksplit) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * count + i];
    store(out + i, s);
  }
}

template <typename XT, typename OT, int BITS, int MT>
void launch(const void* x, const uint8_t* w, const float* scale,
            const float* zero, void* out, float* partial, uint8_t* records,
            int M, int K, int N, int G, int ksplit,
            unsigned long long* launches, cudaStream_t stream) {
  const int chunks_per_group = (K / G + kChunkK - 1) / kChunkK;
  qmm_prep<XT, MT><<<G * chunks_per_group, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), records, M, K, G, chunks_per_group);
  const int gps = (G + ksplit - 1) / ksplit;
  dim3 grid(N / kTileN, ksplit);
  qmm_kernel<OT, BITS, MT><<<grid, kThreads, 0, stream>>>(
      records, w, scale, zero, static_cast<OT*>(out),
      ksplit > 1 ? partial : nullptr, M, K, N, G, gps, launches);
  if (ksplit > 1) {
    const int count = M * N;
    const int blocks = std::min((count + 255) / 256, 4096);
    qmm_reduce<OT><<<blocks, 256, 0, stream>>>(partial,
                                                 static_cast<OT*>(out),
                                                 count, ksplit);
  }
}

template <typename XT, typename OT>
void launch_bits(int bits, const void* x, const uint8_t* w,
                 const float* scale, const float* zero, void* out,
                 float* partial, uint8_t* records, int M, int K, int N, int G,
                 int ksplit, unsigned long long* launches,
                 cudaStream_t stream) {
  const bool two = M > 16;
  if (bits == 4 && two)
    launch<XT, OT, 4, 2>(x, w, scale, zero, out, partial, records, M, K, N,
                         G, ksplit, launches, stream);
  else if (bits == 4)
    launch<XT, OT, 4, 1>(x, w, scale, zero, out, partial, records, M, K, N,
                         G, ksplit, launches, stream);
  else if (two)
    launch<XT, OT, 8, 2>(x, w, scale, zero, out, partial, records, M, K, N,
                         G, ksplit, launches, stream);
  else
    launch<XT, OT, 8, 1>(x, w, scale, zero, out, partial, records, M, K, N,
                         G, ksplit, launches, stream);
}

}  // namespace

// x: [M, K] bf16 (x_bf16=1) or f32; w: [K, N/2] u4 TILE-128 (bits=4) or
// [K, N] int8 (bits=8); scale/zero: [G, N] f32; out: [M, N] bf16
// (out_bf16=1) or f32; partial: [ksplit, M, N] f32 scratch when ksplit > 1;
// records: scratch of G * ceil(K / G / 64) * (M > 16 ? 4352 : 2176) bytes,
// 16-byte aligned; launches: a device counter that each launch of
// qmm_kernel adds one to (so CUDA graph replays count). Requires M <= 32,
// N % 256 == 0, K % G == 0, 16-byte aligned w. The caller
// (ops/quant_matmul.py) validates all of it. Returns cudaGetLastError().
extern "C" int di_quant_matmul(const void* x, int x_bf16, const void* w,
                               int bits, const float* scale,
                               const float* zero, void* out, int out_bf16,
                               float* partial, void* records, int M, int K,
                               int N, int G, int ksplit,
                               unsigned long long* launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* wq = static_cast<const uint8_t*>(w);
  uint8_t* rec = static_cast<uint8_t*>(records);
  if (x_bf16 && out_bf16)
    launch_bits<__nv_bfloat16, __nv_bfloat16>(bits, x, wq, scale, zero, out,
                                              partial, rec, M, K, N, G,
                                              ksplit, launches, s);
  else if (x_bf16)
    launch_bits<__nv_bfloat16, float>(bits, x, wq, scale, zero, out, partial,
                                      rec, M, K, N, G, ksplit, launches, s);
  else if (out_bf16)
    launch_bits<float, __nv_bfloat16>(bits, x, wq, scale, zero, out, partial,
                                      rec, M, K, N, G, ksplit, launches, s);
  else
    launch_bits<float, float>(bits, x, wq, scale, zero, out, partial, rec, M,
                              K, N, G, ksplit, launches, s);
  return (int)cudaGetLastError();
}
