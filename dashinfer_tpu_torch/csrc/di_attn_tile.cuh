// Page-tiled decode attention over a paged KV pool, shared by the per-op
// kernel (csrc/paged_attention.cu) and the decode megakernel's attention
// phase (csrc/di_layer.cuh): the tile geometry, the copy of a tile of a KV
// head's tokens into a shared-memory ring, and the loop over the tiles of
// one (chunk, KV head, slot) that leaves each warp's online-softmax state
// in shared memory for its caller to merge.
//
// Math: GQA, query heads h*G .. (h+1)*G-1 read KV head h; an online
// softmax over the tokens [t_begin, t_end); quantized
// KV (INT8, or UINT4 with halves packing per head: byte j holds dim j low
// and dim j + D/2 high) applies the affine after the dot:
//     q . k_t = (q . q_int_t) * scale_t + (sum_d q_d) * zero_t
// and on the V side  sum_t p_t v_t = sum_t (p_t scale_t) v_int_t + p_t zero_t.
//
// A tile is 16 tokens a warp (fewer for f32 pools, below). The block copies
// a tile's K rows, V rows and qparams into shared memory with cp.async (16
// bytes a thread, the page of each token looked up in the page table;
// nothing at or past t_end is read, those rows are zeroed) through a ring
// of 2-3 tiles. With bf16 q on a bf16 / int8 / uint4 pool (MMA) the scores
// run on mma.sync m16n8k16: q (G rows, zero-padded to 16) as A in bf16, the
// K levels as B, converted in registers (int8 exactly through f32, a u4
// level n as bf16(128 + n) with 128 * sum(q) taken back off); the head dims
// are permuted inside each k-step so that a lane reads 4 consecutive
// payload values of a token row. The affine, the scale and the mask (by
// select: a float pool holds garbage, possibly NaN, past lens) follow; then
// ONE online-softmax rescale per 16 tokens. P.V runs "transposed" (out^T =
// V^T P^T): the V levels are the A operand, so the 16 rows of the tile are
// head dims and none is padding, and P^T is the B operand, whose fragments
// are exactly the scores this lane already holds (token order chosen so).
// P, folded with the per-token V scale, enters as bf16 parts (hi + lo:
// ~16 bits of significand; with a third part ~24, an f32's), one product
// each; the zero term is a row sum. f32 q or
// an f32 pool take a CUDA-core path over the same tiles: a lane owns a
// token (and a slice of its dims) for the scores, a lane owns head dims
// for P.V; no shuffle per token.

#pragma once

#include "di_common.cuh"

namespace di {

constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry of a (pool kind, head dim): 8 warps where a head row is at
// most 128 bytes (int8 / uint4 at D = 128), else 4; 16 tokens a warp, but
// 4 for an f32 pool at D = 256 (its tiles would not fit twice in 227 KB)
// and 8 for an f32 pool in the decode megakernel (SMALL: the tiles share
// the block's memory with the product ring at two blocks an SM).
template <int KIND, int D, bool SMALL = false>
struct Geo {
  static constexpr int kRowBytes =
      KIND == kU4 ? D / 2 : D * (KIND == kF32 ? 4 : KIND == kBF16 ? 2 : 1);
  static constexpr int kRowStride = kRowBytes + 16;   // bank spread
  static constexpr int kWarps = kRowBytes <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpT =
      KIND == kF32 ? (D == 256 ? 4 : (SMALL ? 8 : 16)) : 16;
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
  static constexpr int kPOff = kRing;
  static constexpr int kQOff = kPOff + 4 * kWarps * kMaxG * kWarpT;
  static constexpr int kQsumOff = kQOff + 4 * kMaxG * kQStride;
  static constexpr int kSmem = kQsumOff + 4 * kMaxG;
};

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

// Where a slot's tokens live: token t of KV head h is row t % ps of pool
// page pt_row[t / ps] * pmul + padd (the per-op kernel's tables hold
// physical pages: pmul 1, padd 0; the megakernel's logical ones: pmul L,
// padd the layer). qparams [P, 2 KH, ql] (quantized kinds only).
struct KvSrc {
  const uint8_t* k_pool;
  const uint8_t* v_pool;
  const float* k_qp;
  const float* v_qp;
  const int* pt_row;
  int ql, pmul, padd, ps, h, KH;
};

// Copies tokens [t0, t0 + kTileT) of KV head kv.h into a stage: K rows, V
// rows, qparams [4][kTileT] (k scale, k zero, v scale, v zero), with the
// block's NTHR threads. Tokens >= t_end are zero-filled and their page is
// never looked up.
template <int KIND, int D, bool SMALL, int NTHR>
__device__ __forceinline__ void stage_tile(uint8_t* st, const KvSrc& kv,
                                           int t0, int t_end) {
  using Gm = Geo<KIND, D, SMALL>;
  constexpr bool kQuant = KIND == kI8 || KIND == kU4;
  constexpr int kVec = Gm::kRowBytes / 16;
  const size_t pool_row = (size_t)kv.KH * Gm::kRowBytes;
  for (int i = threadIdx.x; i < Gm::kTileT * kVec; i += NTHR) {
    const int r = i / kVec, c = i - r * kVec;
    const int t = t0 + r;
    uint8_t* kd = st + r * Gm::kRowStride + c * 16;
    uint8_t* vd = kd + Gm::kTileT * Gm::kRowStride;
    if (t < t_end) {
      const size_t page = (size_t)kv.pt_row[t / kv.ps] * kv.pmul + kv.padd;
      const size_t src = (page * kv.ps + t % kv.ps) * pool_row +
                         (size_t)kv.h * Gm::kRowBytes + c * 16;
      cp_async16(kd, kv.k_pool + src);
      cp_async16(vd, kv.v_pool + src);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (kQuant) {
    float* qp_s = reinterpret_cast<float*>(st + Gm::kQpOff);
    for (int i = threadIdx.x; i < 4 * Gm::kTileT; i += NTHR) {
      const int which = i / Gm::kTileT, r = i - which * Gm::kTileT;
      const int t = t0 + r;
      if (t < t_end) {
        const size_t page =
            (size_t)kv.pt_row[t / kv.ps] * kv.pmul + kv.padd;
        const float* base = which < 2 ? kv.k_qp : kv.v_qp;
        cp_async4(qp_s + i, base + (page * 2 * kv.KH + 2 * kv.h +
                                    (which & 1)) * kv.ql + t % kv.ps);
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
template <int KIND, int D, bool SMALL>
__device__ __forceinline__ void v_frags(const uint8_t* vr, int q, int gid,
                                        int tig, uint32_t (&a)[2][4]) {
  constexpr int kS = Geo<KIND, D, SMALL>::kRowStride;
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

// The ring's first tiles, in flight before anything else the caller does
// (one commit group a tile).
template <int KIND, int D, bool SMALL, int NTHR>
__device__ __forceinline__ void att_prologue(uint8_t* smem, const KvSrc& kv,
                                             int t_begin, int t_end,
                                             int n_tiles) {
  using Gm = Geo<KIND, D, SMALL>;
#pragma unroll
  for (int i = 0; i < Gm::kStages - 1; ++i) {
    if (i < n_tiles)
      stage_tile<KIND, D, SMALL, NTHR>(smem + i * Gm::kStage, kv,
                                       t_begin + i * Gm::kTileT, t_end);
    cp_async_commit();
  }
}

// The q operands of the MMA path, lane (gid, tig): head gid's dims
// kdim(s, tig, 2 hf), +1 in bf16 pairs (zero for gid >= G), and the sum of
// head gid's bf16 dims (qsum_g, all four tig lanes).
template <int KIND, int D>
struct MmaQ {
  uint32_t qa[D / 16][2];
  float qsum_g;
};

// The tiles of tokens [t_begin, t_end) of one (slot, KV head): n_tiles of
// them, the first att_prologue's. MMA: q in `q` (MmaQ); else q_s / qsum_s
// of the Geo layout hold q in f32 (written before the first tile's
// __syncthreads). The scores are scaled by `scale`; ALIBI: token t's score
// of head g then gains slopes[g] * (t - q_pos) (`slopes`: the G query
// heads' slopes, natural-log domain), each step rounded (the plain
// version's s * scale + bias), in base 2 times log2(e); MMA pad rows (gid
// >= G) get none. Without ALIBI (the per-op kernel, a RoPE model) the
// slopes are not read and the code is the RoPE model's alone. EXACT (the decode
// megakernel, whose attention outputs are rounded to bf16 and, in a MoE
// model, feed router near-ties) keeps the result as close to an f32
// softmax as the tensor cores allow: the natural exponential, P in three
// bf16 parts (an f32's significand), and each tile's P.V (and each half of
// a score) in a fresh accumulator added in f32 (the tensor cores'
// accumulation truncates: short chains); otherwise (the per-op kernel)
// base 2 with log2(e) folded into `scale`, P in two parts, P.V accumulated
// across the tiles: the per-op kernel with EXACT took 0.0240 / 0.0564 ms a
// launch, cold, on a long-context INT8 state of Qwen2-7B's heads (B = 8 /
// 32, 15,513 / 62,052 cached tokens) against 0.0188 / 0.0412 without it
// (NVIDIA H100 80GB HBM3, 700 W; tools/ab_decode.py --kernels), and holds
// its checks either way. Leaves each computing warp's state in the merge area
// at the ring's start: m_s [kWarps][kMaxG] (in the exponential's domain),
// l_s [kWarps][kMaxG], acc_s [kWarps][kMaxG][D] with the zero term added,
// and ends with a __syncthreads. Warps past Geo::kWarps (a block of NTHR
// threads wider than the geometry) only copy.
template <int KIND, int D, bool MMA, bool SMALL, int NTHR, bool EXACT,
          bool ALIBI = false>
__device__ __forceinline__ void attend_tiles(uint8_t* smem, const KvSrc& kv,
                                             int t_begin, int t_end,
                                             int n_tiles, int G,
                                             float scale,
                                             const MmaQ<KIND, D>& q,
                                             const float* slopes = nullptr,
                                             int q_pos = 0) {
  using Gm = Geo<KIND, D, SMALL>;
  constexpr bool kQuant = KIND == kI8 || KIND == kU4;
  constexpr int kS = Gm::kStages;
  constexpr int kWarps = Gm::kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool cw = warp < kWarps;           // a computing warp
  float* p_s = reinterpret_cast<float*>(smem + Gm::kPOff);
  const float* q_s = reinterpret_cast<const float*>(smem + Gm::kQOff);
  const float* qsum_s = reinterpret_cast<const float*>(smem + Gm::kQsumOff);
  constexpr int kSteps = D / 16;
  constexpr int kDpl = D / 32;             // core path: dims a lane owns
  const float qsum_g = q.qsum_g;
  constexpr int PTERMS = EXACT ? 3 : 2;
  constexpr bool FRESH = EXACT;
  // the softmax's exponential: natural (EXACT: the plain version's own
  // arithmetic) or base 2 with log2(e) folded into `scale`
  auto ex = [](float x) { return EXACT ? expf(x) : exp2f(x); };
  // ALiBi: the bias of a score of head g at token t, in the exponential's
  // domain
  auto bias = [&](float sl, int t) {
    return __fmul_rn(EXACT ? sl : sl * kLog2e, (float)(t - q_pos));
  };
  // MMA: this lane's head (row gid), 0 for a pad row
  const float sl_row = (MMA && ALIBI && gid < G) ? slopes[gid] : 0.f;

  // online-softmax state
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
    if (it + kS - 1 < n_tiles)
      stage_tile<KIND, D, SMALL, NTHR>(smem + ((it + kS - 1) % kS) *
                                                  Gm::kStage,
                                       kv, t_begin + (it + kS - 1) *
                                                         Gm::kTileT,
                                       t_end);
    cp_async_commit();
    if (!cw) continue;

    const uint8_t* st = smem + (it % kS) * Gm::kStage;
    const uint8_t* k_s = st;
    const uint8_t* v_s = st + Gm::kTileT * Gm::kRowStride;
    const float* qp_s = reinterpret_cast<const float*>(st + Gm::kQpOff);
    const int t0 = t_begin + it * Gm::kTileT;
    const int w0 = warp * Gm::kWarpT;      // the warp's first token row

    if constexpr (MMA) {
      // scores S[head gid][tokens tig, tig+4 | tig+8, tig+12] of the warp's 16
      // (FRESH: each half of the head dims in an accumulator of its own,
      // added in f32: the tensor cores' accumulation truncates, so its
      // chains are kept short)
      float c[2][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          c[j][hf][0] = c[j][hf][1] = c[j][hf][2] = c[j][hf][3] = 0.f;
        // B column gid is token 8j + gid/2 + 4 (gid & 1)
        const uint8_t* kr =
            k_s + (w0 + 8 * j + (gid >> 1) + 4 * (gid & 1)) * Gm::kRowStride;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t b0, b1;
          k_frag<KIND, D>(kr, s, tig, b0, b1);
          const uint32_t a[4] = {q.qa[s][0], 0u, q.qa[s][1], 0u};
          mma_bf16_16816(c[j][FRESH && s >= kSteps / 2], a, b0, b1);
        }
      }
      float sv[4] = {c[0][0][0] + c[0][1][0], c[0][0][1] + c[0][1][1],
                     c[1][0][0] + c[1][1][0], c[1][0][1] + c[1][1][1]};
      float pv[4], p[4];
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = w0 + tig + 4 * i;
        float v = sv[i];
        if (KIND == kU4) v -= 128.f * qsum_g;
        if (kQuant) v = v * qp_s[tok] + qsum_g * qp_s[Gm::kTileT + tok];
        v *= scale;
        if (ALIBI) v = __fadd_rn(v, bias(sl_row, t0 + tok));
        sv[i] = t0 + tok < t_end ? v : -INFINITY;
        mt = fmaxf(mt, sv[i]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[0], mt);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex(m_run[0] - mu);
      m_run[0] = m_new;
      float lsum = 0.f, zsum = 0.f, psum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = w0 + tig + 4 * i;
        p[i] = ex(sv[i] - mu);
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
      // P^T as B: bf16 parts of this lane's own 4 values, each part the
      // rounding of what the parts before it left
      uint32_t bp[PTERMS][2];
#pragma unroll
      for (int t = 0; t < PTERMS; ++t) {
        bp[t][0] = pack_bf16(pv[0], pv[1]);
        bp[t][1] = pack_bf16(pv[2], pv[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] -= bf16_round(pv[i]);
      }
      const uint8_t* vr = v_s + w0 * Gm::kRowStride;
#pragma unroll
      for (int qg = 0; qg < D / 32; ++qg) {
        uint32_t a[2][4];
        v_frags<KIND, D, SMALL>(vr, qg, gid, tig, a);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (FRESH) {       // this tile's P.V, added to the state in f32
            float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int t = 0; t < PTERMS; ++t)
              mma_bf16_16816(t4, a[m], bp[t][0], bp[t][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[2 * qg + m][i] += t4[i];
          } else {
#pragma unroll
            for (int t = 0; t < PTERMS; ++t)
              mma_bf16_16816(acc[2 * qg + m], a[m], bp[t][0], bp[t][1]);
          }
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
        float kv_[KIND == kU4 ? 8 : 4];
        int dims[KIND == kU4 ? 8 : 4];
        if (KIND == kF32) {
          const float4 w = *reinterpret_cast<const float4*>(kr + 4 * u);
          kv_[0] = w.x; kv_[1] = w.y; kv_[2] = w.z; kv_[3] = w.w;
        } else if (KIND == kBF16) {
          const uint2 w = *reinterpret_cast<const uint2*>(kr + 2 * u);
          kv_[0] = __uint_as_float(w.x << 16);
          kv_[1] = __uint_as_float(w.x & 0xFFFF0000u);
          kv_[2] = __uint_as_float(w.y << 16);
          kv_[3] = __uint_as_float(w.y & 0xFFFF0000u);
        } else if (KIND == kI8) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(kr + u) ^ 0x80808080u;
#pragma unroll
          for (int e = 0; e < 4; ++e) kv_[e] = i8_level(w, e);
        } else {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kv_[e] = (float)((w >> (8 * e)) & 0xFu);
            kv_[4 + e] = (float)((w >> (8 * e + 4)) & 0xFu);
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
                          kv_[e], s[g]);
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
          v = valid ? v * scale : -INFINITY;
          if (ALIBI && valid)
            v = __fadd_rn(v, bias(__ldg(slopes + g), t0 + tok));
          float mt = v;
#pragma unroll
          for (int o = 1; o < kWT; o <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
          const float m_new = fmaxf(m_run[g], mt);
          const float mu = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = ex(m_run[g] - mu);
          const float p = part == 0 ? ex(v - mu) : 0.f;
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
  if (cw) {
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
  }
  __syncthreads();
}

}  // namespace di
