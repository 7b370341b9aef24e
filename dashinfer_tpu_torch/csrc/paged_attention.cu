// Paged decode attention (one query token per slot), sm_90a: a page-tiled
// design that streams whole tiles of a KV head's tokens through shared
// memory and scores them with the tensor cores.
//
// Replaces: dashinfer_tpu/ops/pallas/paged_attention.py `paged_attention`
// (the Pallas `_kernel`), which models/transformer.py runs in every layer of
// every per-op decode step (and the per-op TP decode and the CUDA-graph
// per-op forward).
//
// Math: GQA -- query heads h*G .. (h+1)*G-1 read KV head h -- with an online
// softmax over the tokens t < lens[b] of the slot's pages; lens[b] == 0 gives
// an output of 0. Quantized KV (INT8, or UINT4 with halves packing per head:
// byte j holds dim j low and dim j + D/2 high) applies the affine after the
// dot, as the TPU kernel does:
//     q . k_t = (q . q_int_t) * scale_t + (sum_d q_d) * zero_t
// and on the V side  sum_t p_t v_t = sum_t (p_t scale_t) v_int_t + p_t zero_t.
//
// What bounds it on the H100: bytes. Per slot it reads each cached token's K
// and V once (KH * D payload bytes each, plus 16 bytes of qparams per head in
// the quantized modes) and does ~4 * H * D operations per token: about one
// operation per byte. The first design (one token a warp, a shuffle sum and
// two expf per token and head, four scalar qparam loads in the dependent
// chain) kept ~1 KB a block in flight and reached ~7% of the card's 3.35 TB/s.
//
// What this design does about it:
//  * One block per (chunk of tiles, KV head, slot): 8 warps where a head row
//    is at most 128 bytes (int8 / uint4 at D <= 128, the served pools), else
//    4; a tile is 16 tokens a warp. The whole block copies a tile's K rows,
//    V rows and qparams into shared memory with cp.async (16 bytes a thread,
//    the page of each token looked up in the page table; nothing past lens
//    is read, rows past it are zeroed) through a ring of 2-3 tiles, tens of
//    KB in flight per SM. The chunk count comes from static shapes alone
//    (the wrapper: as many chunks as keep the grid within two resident
//    blocks an SM), so the launch is CUDA-graph capturable; chunks past
//    lens exit at once.
//  * With bf16 q and a bf16 / int8 / uint4 pool, every G (1 included: on
//    the card the tensor cores beat a CUDA-core path there too: 0.042 ms
//    against 0.073 a launch on a long-context Qwen1.5-MoE state, B = 8, in
//    one run) scores through
//    mma.sync m16n8k16: q (G rows, zero-padded to 16) as A in bf16, the K
//    levels as B, converted in registers (int8 exactly through f32, a u4
//    level n as bf16(128 + n) with 128 * sum(q) taken back off); the head
//    dims are permuted inside each k-step so that a lane reads 4
//    consecutive payload values of a token row. The affine, the scale and
//    the mask (by select: a float pool holds garbage, possibly NaN, past
//    lens) follow; then ONE online-softmax rescale per 16 tokens, not per
//    token. P.V runs "transposed" (out^T = V^T P^T): the V levels are the A
//    operand, so the 16 rows of the tile are head dims and none is padding,
//    and P^T is the B operand, whose fragments are exactly the scores this
//    lane already holds (token order chosen so). P, folded with the
//    per-token V scale, enters as bf16 hi + lo (two products), ~16 bits of
//    significand; the zero term is a row sum.
//  * f32 q or an f32 pool take a CUDA-core path over the same tiles: a lane
//    owns a token (and a slice of its dims) for the scores, a lane owns
//    head dims for P.V; no shuffle per token.
//  * The warps' states merge in shared memory; a single chunk writes the
//    output, otherwise each chunk writes (max, sum, acc) and `pa_combine`
//    merges them (log2 domain throughout).
//  What still bounds it: the int8 -> bf16 conversions and
//  the dependent chain of each warp's tile with two blocks an SM; ~28% of
//  the byte bound on the long-context state.

#include "di_common.cuh"

namespace {

using namespace di;

constexpr int kMaxG = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry of a (pool kind, head dim): 8 warps a block where a head
// row is at most 128 bytes (int8 / uint4 at the served D = 128), else 4;
// 16 tokens a warp (4 for an f32 pool at D = 256).
template <int KIND, int D>
struct Geo {
  static constexpr int kRowBytes =
      KIND == kU4 ? D / 2 : D * (KIND == kF32 ? 4 : KIND == kBF16 ? 2 : 1);
  static constexpr int kRowStride = kRowBytes + 16;   // bank spread
  static constexpr int kWarps = kRowBytes <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpT = (KIND == kF32 && D == 256) ? 4 : 16;
  static constexpr int kTileT = kWarpT * kWarps;
  static constexpr int kQpOff = 2 * kTileT * kRowStride;
  static constexpr int kStage = kQpOff + 4 * kTileT * 4;
  static constexpr int kStages = kStage <= 20 * 1024 ? 3 : 2;
  static constexpr int kMerge = kWarps * kMaxG * (D + 2) * 4;
  static constexpr int kRing =
      kStages * kStage > kMerge ? kStages * kStage : kMerge;
  static constexpr int kQStride = D + D / 32;         // q_s row, skewed
  // ring (or merge) | p_s [kWarps][kMaxG][kWarpT] | q_s [kMaxG][kQStride]
  // | qsum_s [kMaxG]
  static constexpr int kSmem =
      kRing + 4 * (kWarps * kMaxG * kWarpT + kMaxG * kQStride + kMaxG);
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The 4 head dims a lane's 4 payload values hold, in a K-side k-step s
// (lane tig) or a V-side group q (lane gid): i8 / bf16 read 4 consecutive
// dims; u4 reads 2 bytes, i.e. 2 low-nibble and 2 high-nibble dims.
template <int KIND, int D>
__device__ __forceinline__ int kdim(int s, int tig, int e) {
  if (KIND == kU4) return (e >> 1) * (D / 2) + 8 * s + 2 * tig + (e & 1);
  return 16 * s + 4 * tig + e;
}
template <int KIND, int D>
__device__ __forceinline__ int vdim(int q, int gid, int e) {
  if (KIND == kU4) return (e >> 1) * (D / 2) + 16 * q + 2 * gid + (e & 1);
  return 32 * q + 4 * gid + e;
}

// Copies tokens [t0, t0 + kTileT) of slot `pt_row`'s pages, KV head h, into
// a stage: K rows, V rows, qparams [4][kTileT] (k scale, k zero, v scale,
// v zero). Tokens >= t_end are zero-filled and their page is never looked up.
template <int KIND, int D, bool QUANT>
__device__ __forceinline__ void stage_tile(
    uint8_t* st, const uint8_t* __restrict__ k_pool,
    const uint8_t* __restrict__ v_pool, const float* __restrict__ k_qp,
    const float* __restrict__ v_qp, int ql, const int* __restrict__ pt_row,
    int ps, int t0, int t_end, int h, int KH) {
  using Gm = Geo<KIND, D>;
  constexpr int kVec = Gm::kRowBytes / 16;
  const size_t pool_row = (size_t)KH * Gm::kRowBytes;
  for (int i = threadIdx.x; i < Gm::kTileT * kVec; i += Gm::kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    const int t = t0 + r;
    uint8_t* kd = st + r * Gm::kRowStride + c * 16;
    uint8_t* vd = kd + Gm::kTileT * Gm::kRowStride;
    if (t < t_end) {
      const int page = pt_row[t / ps];
      const size_t src = ((size_t)page * ps + t % ps) * pool_row +
                         (size_t)h * Gm::kRowBytes + c * 16;
      cp_async16(kd, k_pool + src);
      cp_async16(vd, v_pool + src);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (QUANT) {
    float* qp_s = reinterpret_cast<float*>(st + Gm::kQpOff);
    for (int i = threadIdx.x; i < 4 * Gm::kTileT; i += Gm::kThreads) {
      const int which = i / Gm::kTileT, r = i - which * Gm::kTileT;
      const int t = t0 + r;
      if (t < t_end) {
        const int page = pt_row[t / ps];
        const float* base = which < 2 ? k_qp : v_qp;
        cp_async4(qp_s + i, base + ((size_t)page * 2 * KH + 2 * h +
                                    (which & 1)) * ql + t % ps);
      } else {
        qp_s[i] = 0.f;
      }
    }
  }
}

// K-side B fragment of k-step s for the token row `kr` (lane tig): the
// 4 values of dims kdim(s, tig, 0..3), (e0, e1) in b0 and (e2, e3) in b1.
template <int KIND, int D>
__device__ __forceinline__ void k_frag(const uint8_t* kr, int s, int tig,
                                       uint32_t& b0, uint32_t& b1) {
  if (KIND == kBF16) {
    const uint2 w =
        *reinterpret_cast<const uint2*>(kr + 2 * (16 * s + 4 * tig));
    b0 = w.x;
    b1 = w.y;
  } else if (KIND == kI8) {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(kr + 16 * s + 4 * tig) ^
        0x80808080u;
    b0 = pack_bf16(i8_level(w, 0), i8_level(w, 1));
    b1 = pack_bf16(i8_level(w, 2), i8_level(w, 3));
  } else {   // u4: bytes 8s + 2tig, +1: low nibbles (e0, e1), high (e2, e3)
    const uint32_t h =
        *reinterpret_cast<const uint16_t*>(kr + 8 * s + 2 * tig);
    const uint32_t pair = h | (h << 8);   // bytes 0 and 2 hold h's bytes
    b0 = u4_lo(pair);
    b1 = u4_hi(pair);
  }
}

// V-side A fragments of group q for the two m-tiles 2q (rows gid / gid+8:
// dims vdim(q, gid, 0 / 1)) and 2q+1 (dims vdim(q, gid, 2 / 3)), k = the
// warp's 16 tokens in the order (tig, tig+4 | tig+8, tig+12) of k positions
// (2tig, 2tig+1 | 2tig+8, 2tig+9). `vr` is the warp's first token row.
template <int KIND, int D>
__device__ __forceinline__ void v_frags(const uint8_t* vr, int q, int gid,
                                        int tig, uint32_t (&a)[2][4]) {
  constexpr int kS = Geo<KIND, D>::kRowStride;
  const uint8_t* r0 = vr + tig * kS;   // tokens tig, tig+4, tig+8, tig+12
  const uint8_t* r1 = r0 + 4 * kS;
  const uint8_t* r2 = r0 + 8 * kS;
  const uint8_t* r3 = r0 + 12 * kS;
  if (KIND == kBF16) {
    const int off = 2 * (32 * q + 4 * gid);
    const uint2 w0 = *reinterpret_cast<const uint2*>(r0 + off);
    const uint2 w1 = *reinterpret_cast<const uint2*>(r1 + off);
    const uint2 w2 = *reinterpret_cast<const uint2*>(r2 + off);
    const uint2 w3 = *reinterpret_cast<const uint2*>(r3 + off);
    // the low / high bf16 of each word, paired across two tokens
    a[0][0] = __byte_perm(w0.x, w1.x, 0x5410);
    a[0][1] = __byte_perm(w0.x, w1.x, 0x7632);
    a[0][2] = __byte_perm(w2.x, w3.x, 0x5410);
    a[0][3] = __byte_perm(w2.x, w3.x, 0x7632);
    a[1][0] = __byte_perm(w0.y, w1.y, 0x5410);
    a[1][1] = __byte_perm(w0.y, w1.y, 0x7632);
    a[1][2] = __byte_perm(w2.y, w3.y, 0x5410);
    a[1][3] = __byte_perm(w2.y, w3.y, 0x7632);
  } else if (KIND == kI8) {
    const int off = 32 * q + 4 * gid;
    auto flipped = [off](const uint8_t* r) {
      return *reinterpret_cast<const uint32_t*>(r + off) ^ 0x80808080u;
    };
    const uint32_t w0 = flipped(r0), w1 = flipped(r1);
    const uint32_t w2 = flipped(r2), w3 = flipped(r3);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * m + r;
        a[m][r] = pack_bf16(i8_level(w0, e), i8_level(w1, e));
        a[m][2 + r] = pack_bf16(i8_level(w2, e), i8_level(w3, e));
      }
  } else {   // u4: 2 bytes at 16q + 2gid: byte 0 -> e0 (low) / e2 (high),
             // byte 1 -> e1 / e3
    const int off = 16 * q + 2 * gid;
    const uint32_t h0 = *reinterpret_cast<const uint16_t*>(r0 + off);
    const uint32_t h1 = *reinterpret_cast<const uint16_t*>(r1 + off);
    const uint32_t h2 = *reinterpret_cast<const uint16_t*>(r2 + off);
    const uint32_t h3 = *reinterpret_cast<const uint16_t*>(r3 + off);
    const uint32_t p01b0 = __byte_perm(h0, h1, 0x0400);
    const uint32_t p01b1 = __byte_perm(h0, h1, 0x0501);
    const uint32_t p23b0 = __byte_perm(h2, h3, 0x0400);
    const uint32_t p23b1 = __byte_perm(h2, h3, 0x0501);
    a[0][0] = u4_lo(p01b0);
    a[0][1] = u4_lo(p01b1);
    a[0][2] = u4_lo(p23b0);
    a[0][3] = u4_lo(p23b1);
    a[1][0] = u4_hi(p01b0);
    a[1][1] = u4_hi(p01b1);
    a[1][2] = u4_hi(p23b0);
    a[1][3] = u4_hi(p23b1);
  }
}

// Writes the block's merged state of its G heads: the output itself when the
// slot's sequence is one chunk, else the chunk's (max, sum, acc) partial.
// Reads the warps' states m_s / l_s [kWarps][kMaxG] and acc_s
// [kWarps][kMaxG][D] (acc with its zero term added).
template <typename QT, int D, int kWarps>
__device__ __forceinline__ void merge_write(
    const float* m_s, const float* l_s, const float* acc_s, int G, int b,
    int h, int H, int chunk, int n_chunks, QT* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc) {
  for (int idx = threadIdx.x; idx < G * D; idx += 32 * kWarps) {
    const int g = idx / D, d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kMaxG + g]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w * kMaxG + g] - mu);
      lsum += l_s[w * kMaxG + g] * f;
      o += acc_s[(w * kMaxG + g) * D + d] * f;
    }
    const size_t head = (size_t)b * H + h * G + g;
    if (n_chunks == 1) {
      store(out + head * D + d, lsum > 0.f ? o / lsum : 0.f);
    } else {
      const size_t slot = head * n_chunks + chunk;
      part_acc[slot * D + d] = o;
      if (d == 0) {
        part_ml[2 * slot] = mx;
        part_ml[2 * slot + 1] = lsum;
      }
    }
  }
}

// grid = (n_chunks, KH, B); block = kThreads; dynamic shared memory =
// Geo::kSmem. MMA: the tensor-core path (bf16 q on a bf16 / int8 / uint4
// pool, every G), else the CUDA-core path (f32 q or an f32 pool).
template <typename QT, int KIND, int D, bool MMA>
__global__ void __launch_bounds__(Geo<KIND, D>::kThreads)
pa_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ k_pool,
          const uint8_t* __restrict__ v_pool, const float* __restrict__ k_qp,
          const float* __restrict__ v_qp, int ql,
          const int* __restrict__ page_tables, int max_pages,
          const int* __restrict__ lens, QT* __restrict__ out,
          float* __restrict__ part_ml, float* __restrict__ part_acc, int H,
          int ps, int chunk_tokens, float scale_log2,
          unsigned long long* __restrict__ launches) {
  using Gm = Geo<KIND, D>;
  constexpr bool kQuant = KIND == kI8 || KIND == kU4;
  constexpr int kS = Gm::kStages;
  constexpr int kWarps = Gm::kWarps, kThreads = Gm::kThreads;
  extern __shared__ __align__(16) uint8_t smem[];

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, KH = gridDim.y;
  if (chunk == 0 && h == 0 && b == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  const int G = H / KH;
  const int t_begin = chunk * chunk_tokens;
  const int t_end = min(lens[b], t_begin + chunk_tokens);
  if (t_begin >= t_end) {   // block-uniform: nothing to attend here
    if (n_chunks == 1)
      for (int i = threadIdx.x; i < G * D; i += kThreads)
        store(out + ((size_t)b * H + h * G) * D + i, 0.f);
    return;
  }
  const int n_tiles = (t_end - t_begin + Gm::kTileT - 1) / Gm::kTileT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int* pt_row = page_tables + (size_t)b * max_pages;
  const QT* q_bh = q + ((size_t)b * H + h * G) * D;
  float* p_s = reinterpret_cast<float*>(smem + Gm::kRing);  // [w][g][wt]
  float* q_s = p_s + kWarps * kMaxG * Gm::kWarpT;            // [g][kQStride]
  float* qsum_s = q_s + kMaxG * Gm::kQStride;                // [g]

  // ---- the ring: its first tiles in flight before anything else ---------
  auto stage = [&](int i) {
    stage_tile<KIND, D, kQuant>(smem + (i % kS) * Gm::kStage,
                                k_pool, v_pool, k_qp, v_qp, ql, pt_row, ps,
                                t_begin + i * Gm::kTileT, t_end, h, KH);
  };
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }

  // ---- per-block query state -------------------------------------------
  constexpr int kSteps = D / 16;
  constexpr int kDpl = D / 32;             // core path: dims a lane owns
  uint32_t qa[MMA ? kSteps : 1][2];
  float qsum_g = 0.f;                      // MMA: head gid
  if constexpr (MMA) {
    const bool real = gid < G;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d0 = kdim<KIND, D>(s, tig, 2 * hf);   // d0, d0 + 1
        uint32_t v = 0u;
        if (real)
          v = *reinterpret_cast<const uint32_t*>(q_bh + (size_t)gid * D + d0);
        qa[s][hf] = v;
        qsum_g += __uint_as_float(v << 16) + __uint_as_float(v & 0xFFFF0000u);
      }
    }
    qsum_g += __shfl_xor_sync(0xffffffffu, qsum_g, 1);
    qsum_g += __shfl_xor_sync(0xffffffffu, qsum_g, 2);
  } else {
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      q_s[g * Gm::kQStride + d + (d >> 5)] = to_f32(q_bh[i]);
    }
    for (int g = warp; g < G; g += kWarps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += to_f32(q_bh[g * D + d]);
      s = warp_sum(s);
      if (lane == 0) qsum_s[g] = s;
    }
  }

  // online-softmax state (log2 domain)
  float m_run[MMA ? 1 : kMaxG], l_run[MMA ? 1 : kMaxG], z_run[MMA ? 1 : kMaxG];
#pragma unroll
  for (int g = 0; g < (MMA ? 1 : kMaxG); ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = z_run[g] = 0.f;
  }
  float ps_run = 0.f;                      // MMA u4: sum of p * v_scale
  float acc[MMA ? kSteps : kMaxG][MMA ? 4 : kDpl];
#pragma unroll
  for (int i = 0; i < (MMA ? kSteps : kMaxG); ++i)
#pragma unroll
    for (int j = 0; j < (MMA ? 4 : kDpl); ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kS - 2>();
    __syncthreads();   // tile `it` is in shared memory; q_s is written
    if (it + kS - 1 < n_tiles) stage(it + kS - 1);
    cp_async_commit();

    const uint8_t* st = smem + (it % kS) * Gm::kStage;
    const uint8_t* k_s = st;
    const uint8_t* v_s = st + Gm::kTileT * Gm::kRowStride;
    const float* qp_s = reinterpret_cast<const float*>(st + Gm::kQpOff);
    const int t0 = t_begin + it * Gm::kTileT;
    const int w0 = warp * Gm::kWarpT;      // the warp's first token row

    if constexpr (MMA) {
      // scores S[head gid][tokens tig, tig+4 | tig+8, tig+12] of the warp's 16
      float c[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
        // B column gid is token 8j + gid/2 + 4 (gid & 1)
        const uint8_t* kr =
            k_s + (w0 + 8 * j + (gid >> 1) + 4 * (gid & 1)) * Gm::kRowStride;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t b0, b1;
          k_frag<KIND, D>(kr, s, tig, b0, b1);
          const uint32_t a[4] = {qa[s][0], 0u, qa[s][1], 0u};
          mma_bf16_16816(c[j], a, b0, b1);
        }
      }
      float sv[4] = {c[0][0], c[0][1], c[1][0], c[1][1]};
      float pv[4], p[4];
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = w0 + tig + 4 * i;
        float v = sv[i];
        if (KIND == kU4) v -= 128.f * qsum_g;
        if (kQuant) v = v * qp_s[tok] + qsum_g * qp_s[Gm::kTileT + tok];
        v *= scale_log2;
        sv[i] = t0 + tok < t_end ? v : -INFINITY;
        mt = fmaxf(mt, sv[i]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[0], mt);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[0] - mu);
      m_run[0] = m_new;
      float lsum = 0.f, zsum = 0.f, psum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = w0 + tig + 4 * i;
        p[i] = exp2f(sv[i] - mu);
        lsum += p[i];
        pv[i] = kQuant ? p[i] * qp_s[2 * Gm::kTileT + tok] : p[i];
        if (kQuant) zsum += p[i] * qp_s[3 * Gm::kTileT + tok];
        psum += pv[i];
      }
      l_run[0] = l_run[0] * alpha + lsum;
      z_run[0] = z_run[0] * alpha + zsum;
      ps_run = ps_run * alpha + psum;
      // rescale the accumulator: its columns are heads 2tig, 2tig + 1
      const float al0 = __shfl_sync(0xffffffffu, alpha, (2 * tig) << 2);
      const float al1 = __shfl_sync(0xffffffffu, alpha, (2 * tig + 1) << 2);
#pragma unroll
      for (int mt_ = 0; mt_ < kSteps; ++mt_) {
        acc[mt_][0] *= al0;
        acc[mt_][1] *= al1;
        acc[mt_][2] *= al0;
        acc[mt_][3] *= al1;
      }
      // P^T as B: hi and lo bf16 parts of this lane's own 4 values
      const uint32_t bh0 = pack_bf16(pv[0], pv[1]);
      const uint32_t bh1 = pack_bf16(pv[2], pv[3]);
      const uint32_t bl0 = pack_bf16(pv[0] - bf16_round(pv[0]),
                                     pv[1] - bf16_round(pv[1]));
      const uint32_t bl1 = pack_bf16(pv[2] - bf16_round(pv[2]),
                                     pv[3] - bf16_round(pv[3]));
      const uint8_t* vr = v_s + w0 * Gm::kRowStride;
#pragma unroll
      for (int qg = 0; qg < D / 32; ++qg) {
        uint32_t a[2][4];
        v_frags<KIND, D>(vr, qg, gid, tig, a);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16_16816(acc[2 * qg + m], a[m], bh0, bh1);
          mma_bf16_16816(acc[2 * qg + m], a[m], bl0, bl1);
        }
      }
    } else {
      // CUDA cores: lane (tl, part) scores token w0 + tl over its part of
      // the dims; then a lane owns dims kDpl of every token for P.V
      constexpr int kWT = Gm::kWarpT;
      constexpr int kParts = 32 / kWT;
      constexpr int kUnits = (KIND == kU4 ? D / 2 : D) / kParts;  // a part
      const int tl = lane % kWT, part = lane / kWT;
      const int tok = w0 + tl;
      const uint8_t* kr = k_s + tok * Gm::kRowStride;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      for (int u = part * kUnits; u < (part + 1) * kUnits; u += 4) {
        float kv[KIND == kU4 ? 8 : 4];
        int dims[KIND == kU4 ? 8 : 4];
        if (KIND == kF32) {
          const float4 w = *reinterpret_cast<const float4*>(kr + 4 * u);
          kv[0] = w.x; kv[1] = w.y; kv[2] = w.z; kv[3] = w.w;
        } else if (KIND == kBF16) {
          const uint2 w = *reinterpret_cast<const uint2*>(kr + 2 * u);
          kv[0] = __uint_as_float(w.x << 16);
          kv[1] = __uint_as_float(w.x & 0xFFFF0000u);
          kv[2] = __uint_as_float(w.y << 16);
          kv[3] = __uint_as_float(w.y & 0xFFFF0000u);
        } else if (KIND == kI8) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(kr + u) ^ 0x80808080u;
#pragma unroll
          for (int e = 0; e < 4; ++e) kv[e] = i8_level(w, e);
        } else {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kv[e] = (float)((w >> (8 * e)) & 0xFu);
            kv[4 + e] = (float)((w >> (8 * e + 4)) & 0xFu);
          }
        }
#pragma unroll
        for (int e = 0; e < (KIND == kU4 ? 8 : 4); ++e)
          dims[e] = KIND == kU4 ? (e >> 2) * (D / 2) + u + (e & 3) : u + e;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < (KIND == kU4 ? 8 : 4); ++e)
              s[g] = fmaf(q_s[g * Gm::kQStride + dims[e] + (dims[e] >> 5)],
                          kv[e], s[g]);
          }
        }
      }
      const bool valid = t0 + tok < t_end;
      const float ks = kQuant ? qp_s[tok] : 1.f;
      const float kz = kQuant ? qp_s[Gm::kTileT + tok] : 0.f;
      const float vs = kQuant ? qp_s[2 * Gm::kTileT + tok] : 1.f;
      const float vz = kQuant ? qp_s[3 * Gm::kTileT + tok] : 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float v = s[g];
#pragma unroll
          for (int o = kWT; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (kQuant) v = v * ks + qsum_s[g] * kz;
          v = valid ? v * scale_log2 : -INFINITY;
          float mt = v;
#pragma unroll
          for (int o = 1; o < kWT; o <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
          const float m_new = fmaxf(m_run[g], mt);
          const float mu = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m_run[g] - mu);
          const float p = part == 0 ? exp2f(v - mu) : 0.f;
          m_run[g] = m_new;
          l_run[g] = l_run[g] * alpha + p;
          z_run[g] = z_run[g] * alpha + p * vz;
#pragma unroll
          for (int i = 0; i < kDpl; ++i) acc[g][i] *= alpha;
          if (part == 0) p_s[(warp * kMaxG + g) * kWT + tl] = p * vs;
        }
      }
      __syncwarp();
      const uint8_t* vr = v_s + w0 * Gm::kRowStride;
      for (int t = 0; t < kWT; ++t) {
        float vv[kDpl];
        load_row<KIND, kDpl>(vr + t * Gm::kRowStride, 0, lane, vv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pg = p_s[(warp * kMaxG + g) * kWT + t];
#pragma unroll
            for (int i = 0; i < kDpl; ++i)
              acc[g][i] = fmaf(pg, vv[i], acc[g][i]);
          }
        }
      }
      __syncwarp();   // p_s is rewritten by the next tile
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the merge area

  float* m_s = reinterpret_cast<float*>(smem);      // [kWarps][kMaxG]
  float* l_s = m_s + kWarps * kMaxG;                // [kWarps][kMaxG]
  float* acc_s = l_s + kWarps * kMaxG;              // [kWarps][kMaxG][D]
  if constexpr (MMA) {
    float l = l_run[0], z = z_run[0], pz = ps_run;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    pz += __shfl_xor_sync(0xffffffffu, pz, 1);
    pz += __shfl_xor_sync(0xffffffffu, pz, 2);
    // the constant each of this lane's two heads adds to every dim
    const float corr = z - (KIND == kU4 ? 128.f * pz : 0.f);
    const float c0 = __shfl_sync(0xffffffffu, corr, (2 * tig) << 2);
    const float c1 = __shfl_sync(0xffffffffu, corr, (2 * tig + 1) << 2);
    if (tig == 0) {
      m_s[warp * kMaxG + gid] = m_run[0];
      l_s[warp * kMaxG + gid] = l;
    }
    float* a0 = acc_s + (warp * kMaxG + 2 * tig) * D;
    float* a1 = a0 + D;
#pragma unroll
    for (int qg = 0; qg < D / 32; ++qg)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int d_lo = vdim<KIND, D>(qg, gid, 2 * m);       // row gid
        const int d_hi = vdim<KIND, D>(qg, gid, 2 * m + 1);   // row gid + 8
        const float* c = acc[2 * qg + m];
        a0[d_lo] = c[0] + c0;
        a1[d_lo] = c[1] + c1;
        a0[d_hi] = c[2] + c0;
        a1[d_hi] = c[3] + c1;
      }
  } else {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float l = warp_sum(l_run[g]);
        const float z = warp_sum(z_run[g]);
        if (lane == 0) {
          m_s[warp * kMaxG + g] = m_run[g];
          l_s[warp * kMaxG + g] = l;
        }
#pragma unroll
        for (int i = 0; i < kDpl; ++i)
          acc_s[(warp * kMaxG + g) * D + dim_of<KIND, kDpl>(lane, i)] =
              acc[g][i] + z;
      }
    }
  }
  __syncthreads();
  merge_write<QT, D, kWarps>(m_s, l_s, acc_s, G, b, h, H, chunk, n_chunks,
                             out, part_ml, part_acc);
}

// Merges the chunks of each (slot b, query head): grid = B * H, block = D.
// A slot with lens 0 has no chunk and gets 0.
template <typename QT>
__global__ void pa_combine(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc,
                           const int* __restrict__ lens, QT* __restrict__ out,
                           int H, int D, int n_chunks, int chunk_tokens) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const int used = (lens[bh / H] + chunk_tokens - 1) / chunk_tokens;
  const float* ml = part_ml + (size_t)bh * n_chunks * 2;
  const float* acc = part_acc + (size_t)bh * n_chunks * D;
  float mx = -INFINITY;
  for (int c = 0; c < used; ++c) mx = fmaxf(mx, ml[2 * c]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float lsum = 0.f, o = 0.f;
  for (int c = 0; c < used; ++c) {
    const float f = exp2f(ml[2 * c] - mu);
    lsum += ml[2 * c + 1] * f;
    o += acc[(size_t)c * D + d] * f;
  }
  store(out + (size_t)bh * D + d, lsum > 0.f ? o / lsum : 0.f);
}

template <typename QT, int KIND, int D, bool MMA>
int launch_one(const void* q, const void* k_pool, const void* v_pool,
               const float* k_qp, const float* v_qp, int ql,
               const int* page_tables, int max_pages, const int* lens,
               void* out, float* part_ml, float* part_acc, int B, int H,
               int KH, int ps, int chunk_tokens, int n_chunks, float scale,
               unsigned long long* launches, cudaStream_t stream) {
  using Gm = Geo<KIND, D>;
  if (chunk_tokens % Gm::kTileT) return (int)cudaErrorInvalidValue;
  auto kern = pa_kernel<QT, KIND, D, MMA>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Gm::kSmem);
  const dim3 grid(n_chunks, KH, B);
  kern<<<grid, Gm::kThreads, Gm::kSmem, stream>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(k_pool),
      static_cast<const uint8_t*>(v_pool), k_qp, v_qp, ql, page_tables,
      max_pages, lens, static_cast<QT*>(out), part_ml, part_acc, H, ps,
      chunk_tokens, scale * kLog2e, launches);
  if (n_chunks > 1)
    pa_combine<QT><<<B * H, D, 0, stream>>>(part_ml, part_acc, lens,
                                            static_cast<QT*>(out), H, D,
                                            n_chunks, chunk_tokens);
  return (int)cudaGetLastError();
}

template <typename QT, int KIND>
int launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
             const float* k_qp, const float* v_qp, int ql,
             const int* page_tables, int max_pages, const int* lens,
             void* out, float* part_ml, float* part_acc, int B, int H,
             int KH, int ps, int chunk_tokens, int n_chunks, float scale,
             unsigned long long* launches, cudaStream_t stream) {
  // the tensor cores wherever the kinds allow: bf16 q on a bf16 / int8 /
  // uint4 pool, at every G
  constexpr bool kMma =
      sizeof(QT) == 2 && (KIND == kBF16 || KIND == kI8 || KIND == kU4);
#define DI_PA(D_)                                                           \
  return launch_one<QT, KIND, D_, kMma>(                                    \
      q, k_pool, v_pool, k_qp, v_qp, ql, page_tables, max_pages, lens, out, \
      part_ml, part_acc, B, H, KH, ps, chunk_tokens, n_chunks, scale,       \
      launches, stream)
  switch (D) {
    case 64: DI_PA(64);
    case 128: DI_PA(128);
    case 256: DI_PA(256);
  }
#undef DI_PA
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int launch_kind(int kind, int D, const void* q, const void* k_pool,
                const void* v_pool, const float* k_qp, const float* v_qp,
                int ql, const int* page_tables, int max_pages,
                const int* lens, void* out, float* part_ml, float* part_acc,
                int B, int H, int KH, int ps, int chunk_tokens, int n_chunks,
                float scale, unsigned long long* launches,
                cudaStream_t stream) {
#define DI_PA_KIND(K_)                                                      \
  return launch_d<QT, K_>(D, q, k_pool, v_pool, k_qp, v_qp, ql,              \
                          page_tables, max_pages, lens, out, part_ml,       \
                          part_acc, B, H, KH, ps, chunk_tokens, n_chunks,   \
                          scale, launches, stream)
  switch (kind) {
    case kF32: DI_PA_KIND(kF32);
    case kBF16: DI_PA_KIND(kBF16);
    case kI8: DI_PA_KIND(kI8);
    case kU4: DI_PA_KIND(kU4);
  }
#undef DI_PA_KIND
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: [B, H, D] bf16 (q_bf16=1) or f32; k_pool/v_pool: [P, ps, KH*Ds]
// of kv_kind (0 f32, 1 bf16, 2 int8, 3 uint4 halves-packed), 16-byte
// aligned; k_qp/v_qp: [P, 2*KH, ql] f32 (quantized kinds only, else null);
// page_tables: [B, max_pages] int32 physical page ids; lens: [B] int32.
// The sequence is cut into n_chunks chunks of chunk_tokens (a multiple of
// the kernel's tile: 32 for an f32 pool at D = 256, else 64); with
// n_chunks > 1, part_ml / part_acc are f32 scratch of B*H*n_chunks*2 and
// B*H*n_chunks*D floats (else unused). Requires D in {64, 128, 256} and
// H / KH <= 8; launches: a device counter that each launch of pa_kernel
// adds one to (so CUDA graph replays count). The caller
// (ops/paged_attention.py) validates shapes. Returns cudaGetLastError().
extern "C" int di_paged_attention(const void* q, int q_bf16,
                                  const void* k_pool, const void* v_pool,
                                  int kv_kind, const float* k_qp,
                                  const float* v_qp, int ql,
                                  const int* page_tables, int max_pages,
                                  const int* lens, void* out, float* part_ml,
                                  float* part_acc, int B, int H, int KH,
                                  int D, int ps, int chunk_tokens,
                                  int n_chunks, float scale,
                                  unsigned long long* launches,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH < 1 || H % KH || H / KH > kMaxG || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return launch_kind<__nv_bfloat16>(kv_kind, D, q, k_pool, v_pool,
                                      k_qp, v_qp, ql, page_tables, max_pages,
                                      lens, out, part_ml, part_acc, B, H, KH,
                                      ps, chunk_tokens, n_chunks, scale,
                                      launches, s);
  return launch_kind<float>(kv_kind, D, q, k_pool, v_pool, k_qp, v_qp,
                            ql, page_tables, max_pages, lens, out, part_ml,
                            part_acc, B, H, KH, ps, chunk_tokens, n_chunks,
                            scale, launches, s);
}
