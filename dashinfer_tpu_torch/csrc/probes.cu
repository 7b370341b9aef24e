// Two small design probes, sm_90a.
//
// Replaces: tools/probe_magic_dequant.py `build_check` / `build_timed` and
// tools/probe_reshape.py `run` (the TPU probes of the u4 -> bf16 dequant
// chains and of the megakernel's per-layer q re-layout).
//
// Dequant chains. A packed u4 byte holds two levels (low nibble: column j,
// high nibble: column j + HALF). Each chain turns the nibbles of two K rows
// into one bf16x2 register, the tensor cores' B operand:
//   cvt      integer -> f32 convert, two f32 -> one bf16x2 convert;
//   magic16  (n | 0x4300) IS bf16(128 + n): no convert at all, the dot's
//            128 * sum(x) comes back off afterwards;
//   magicf32 (n | 0x4B000000) IS f32(2^23 + n): subtract 2^23, then the
//            bf16x2 convert (no integer -> float convert).
// `di_probe_dequant_levels` writes each chain's levels out (exactness);
// `di_probe_dequant_dot` streams [ROWS, HALF]-byte chunks against x [32,
// ROWS] with mma.sync, acc += x @ lo + x @ hi per chunk as the TPU probe
// does, so the chains' cost per chunk can be compared on this card. What
// bounds it: the instruction issue of the chain and the byte gathers from
// shared memory, not the 128 KB a chunk brings from L2 / device memory.
//
// Re-layout. `di_probe_relayout` copies q [B, H * D] f32 into the padded
// [B, KH, 8, D] layout (head h * G + g -> [h, g], rows g >= G zeroed): one
// warp a head row, or one thread a float4 of the output. Bound: bytes.

#include "di_common.cuh"

namespace {

using namespace di;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 512;     // K rows of a chunk
constexpr int kHalf = 256;     // bytes a row: columns j and j + kHalf
constexpr int kB = 32;         // rows of x
constexpr int kSub = 64;       // K rows staged at a time
constexpr int kXPad = kRows + 8;
constexpr int kWPad = kHalf + 16;   // bytes a staged row (no bank conflicts)

enum Chain { kCvt = 0, kMagic16 = 1, kMagicF32 = 2 };

// pair = byte of row r | byte of row r + 1 << 16 -> bf16x2 of the low
// nibbles' levels and of the high nibbles' (row r in the low half), each
// plus the chain's offset.
template <int CHAIN>
__device__ __forceinline__ void levels(uint32_t pair, uint32_t& lo,
                                       uint32_t& hi) {
  if (CHAIN == kMagic16) {
    lo = (pair & 0x000F000Fu) | 0x43004300u;
    hi = ((pair >> 4) & 0x000F000Fu) | 0x43004300u;
  } else if (CHAIN == kCvt) {
    lo = pack_bf16((float)(pair & 0xFu), (float)((pair >> 16) & 0xFu));
    hi = pack_bf16((float)((pair >> 4) & 0xFu), (float)((pair >> 20) & 0xFu));
  } else {
    const float m = 8388608.f;
    lo = pack_bf16(__uint_as_float((pair & 0xFu) | 0x4B000000u) - m,
                   __uint_as_float(((pair >> 16) & 0xFu) | 0x4B000000u) - m);
    hi = pack_bf16(
        __uint_as_float(((pair >> 4) & 0xFu) | 0x4B000000u) - m,
        __uint_as_float(((pair >> 20) & 0xFu) | 0x4B000000u) - m);
  }
}

template <int CHAIN>
__global__ void levels_kernel(const uint8_t* p, __nv_bfloat16* lo_out,
                              __nv_bfloat16* hi_out, int rows, int half,
                              unsigned long long* launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int total = (rows / 2) * half;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int r = 2 * (i / half), c = i % half;
    const uint32_t pair = (uint32_t)p[(size_t)r * half + c] |
                          ((uint32_t)p[(size_t)(r + 1) * half + c] << 16);
    uint32_t lo, hi;
    levels<CHAIN>(pair, lo, hi);
    uint16_t* l = reinterpret_cast<uint16_t*>(lo_out);
    uint16_t* h = reinterpret_cast<uint16_t*>(hi_out);
    l[(size_t)r * half + c] = (uint16_t)(lo & 0xFFFFu);
    l[(size_t)(r + 1) * half + c] = (uint16_t)(lo >> 16);
    h[(size_t)r * half + c] = (uint16_t)(hi & 0xFFFFu);
    h[(size_t)(r + 1) * half + c] = (uint16_t)(hi >> 16);
  }
}

// out[block] [kB, kHalf] = sum over the block's chunks of x @ lo + x @ hi
// (levels without the chain's offset). Chunk c of `total` is payload chunk
// c % S. A warp owns 32 byte columns; K rows are staged kSub at a time
// through a two-deep cp.async ring.
template <int CHAIN>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const __nv_bfloat16* x, const uint8_t* payload, float* out, int S,
           int total, unsigned long long* launches) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* xsum = reinterpret_cast<float*>(smem + kB * kXPad * 2);
  uint8_t* w_s = smem + kB * kXPad * 2 + kB * 4;      // [2][kSub][kWPad]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (blockIdx.x == 0 && tid == 0) atomicAdd(launches, 1ull);

  for (int i = tid; i < kB * kRows / 8; i += kThreads) {
    const int row = i / (kRows / 8), seg = i % (kRows / 8);
    *reinterpret_cast<uint4*>(x_s + row * kXPad + seg * 8) =
        *reinterpret_cast<const uint4*>(x + (size_t)row * kRows + seg * 8);
  }
  __syncthreads();
  if (tid < kB) {
    float s = 0.f;
    for (int k = 0; k < kRows; ++k) s += __bfloat162float(x_s[tid * kXPad + k]);
    xsum[tid] = s;
  }
  __syncthreads();

  constexpr int kSubs = kRows / kSub;
  const int my_chunks =
      total > (int)blockIdx.x ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_chunks * kSubs;
  auto load = [&](int step, int buf) {
    const int chunk = blockIdx.x + (step / kSubs) * gridDim.x;
    const uint8_t* src = payload + ((size_t)(chunk % S) * kRows +
                                    (size_t)(step % kSubs) * kSub) * kHalf;
    uint8_t* dst = w_s + buf * (kSub * kWPad);
    for (int i = tid; i < kSub * kHalf / 16; i += kThreads)
      cp_async16(dst + (i / (kHalf / 16)) * kWPad + (i % (kHalf / 16)) * 16,
                 src + i * 16);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  if (steps > 0) load(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* w = w_s + (step & 1) * (kSub * kWPad);
    const int k0 = (step % kSubs) * kSub;
#pragma unroll
    for (int s = 0; s < kSub / 16; ++s) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ap =
            x_s + (mt * 16 + gid) * kXPad + k0 + 16 * s + 2 * tig;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kXPad);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kXPad + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* wp = w + (16 * s + 2 * tig) * kWPad + 32 * warp +
                            8 * j + gid;
        const uint32_t p0 = (uint32_t)wp[0] | ((uint32_t)wp[kWPad] << 16);
        const uint32_t p1 =
            (uint32_t)wp[8 * kWPad] | ((uint32_t)wp[9 * kWPad] << 16);
        uint32_t lo0, hi0, lo1, hi1;
        levels<CHAIN>(p0, lo0, hi0);
        levels<CHAIN>(p1, lo1, hi1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][j], af[mt], lo0, lo1);
          mma_bf16_16816(acc[mt][j], af[mt], hi0, hi1);
        }
      }
    }
    __syncthreads();   // the buffer is free for the step after next
  }
  cp_async_wait<0>();

  // the chain's offset: each chunk added it to x @ lo and to x @ hi
  const float off = (CHAIN == kMagic16 ? 128.f : 0.f) * 2.f * (float)my_chunks;
  float* o = out + (size_t)blockIdx.x * kB * kHalf;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + gid + 8 * h;
        const int col = 32 * warp + 8 * j + 2 * tig;
        const float fold = off * xsum[row];
        *reinterpret_cast<float2*>(o + row * kHalf + col) = make_float2(
            acc[mt][j][2 * h] - fold, acc[mt][j][2 * h + 1] - fold);
      }
}

constexpr int kDotSmem = kB * kXPad * 2 + kB * 4 + 2 * kSub * kWPad;

// q [B, H * D] -> out [B, KH, 8, D], D = 128, G = H / KH <= 8.
// variant 0: one warp a (b, kv head, row of 8); variant 1: one thread a
// float4 of the output.
__global__ void relayout_kernel(const float* q, float* out, int B, int H,
                                int KH, int variant,
                                unsigned long long* launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int G = H / KH;
  constexpr int D = 128;
  if (variant == 0) {
    const int lane = threadIdx.x & 31;
    const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int nw = (gridDim.x * blockDim.x) >> 5;
    for (int r = gw; r < B * KH * 8; r += nw) {
      const int g = r % 8, h = (r / 8) % KH, b = r / (8 * KH);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < G)
        v = *reinterpret_cast<const float4*>(
            q + ((size_t)b * H + h * G + g) * D + lane * 4);
      *reinterpret_cast<float4*>(out + (size_t)r * D + lane * 4) = v;
    }
  } else {
    const int total = B * KH * 8 * (D / 4);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
      const int d4 = i % (D / 4), r = i / (D / 4);
      const int g = r % 8, h = (r / 8) % KH, b = r / (8 * KH);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < G)
        v = *reinterpret_cast<const float4*>(
            q + ((size_t)b * H + h * G + g) * D + d4 * 4);
      *reinterpret_cast<float4*>(out + (size_t)i * 4) = v;
    }
  }
}

}  // namespace

// payload [rows, half] u8 -> lo, hi [rows, half] bf16 (levels + the chain's
// offset). rows must be even. Returns cudaGetLastError().
extern "C" int di_probe_dequant_levels(int chain, const void* payload,
                                       void* lo, void* hi, int rows, int half,
                                       void* launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(payload);
  __nv_bfloat16* l = static_cast<__nv_bfloat16*>(lo);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(hi);
  unsigned long long* n = static_cast<unsigned long long*>(launches);
  const int blocks = (rows / 2 * half + kThreads - 1) / kThreads;
  if (chain == kCvt)
    levels_kernel<kCvt><<<blocks, kThreads, 0, s>>>(p, l, h, rows, half, n);
  else if (chain == kMagic16)
    levels_kernel<kMagic16><<<blocks, kThreads, 0, s>>>(p, l, h, rows, half, n);
  else if (chain == kMagicF32)
    levels_kernel<kMagicF32><<<blocks, kThreads, 0, s>>>(p, l, h, rows, half,
                                                         n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x [32, 512] bf16, payload [S, 512, 256] u8 -> out [grid, 32, 256] f32
// partial sums over `total` chunks (chunk c reads payload chunk c % S).
extern "C" int di_probe_dequant_dot(int chain, const void* x,
                                    const void* payload, void* out, int S,
                                    int total, int grid, void* launches,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* p = static_cast<const uint8_t*>(payload);
  float* o = static_cast<float*>(out);
  unsigned long long* n = static_cast<unsigned long long*>(launches);
  if (chain == kCvt) {
    cudaFuncSetAttribute(dot_kernel<kCvt>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDotSmem);
    dot_kernel<kCvt><<<grid, kThreads, kDotSmem, s>>>(xp, p, o, S, total, n);
  } else if (chain == kMagic16) {
    cudaFuncSetAttribute(dot_kernel<kMagic16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDotSmem);
    dot_kernel<kMagic16><<<grid, kThreads, kDotSmem, s>>>(xp, p, o, S, total,
                                                          n);
  } else if (chain == kMagicF32) {
    cudaFuncSetAttribute(dot_kernel<kMagicF32>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDotSmem);
    dot_kernel<kMagicF32><<<grid, kThreads, kDotSmem, s>>>(xp, p, o, S, total,
                                                           n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// q [B, H * 128] f32 -> out [B, KH, 8, 128] f32.
extern "C" int di_probe_relayout(const void* q, void* out, int B, int H,
                                 int KH, int variant, void* launches,
                                 void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > 8 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  // either variant: 32 threads a row of the output
  const int blocks = (B * KH * 8 * 32 + kThreads - 1) / kThreads;
  relayout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<float*>(out), B, H, KH,
      variant, static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}
