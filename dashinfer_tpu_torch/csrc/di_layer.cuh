// The layer phases of the decode megakernel (csrc/megakernel.cu), shared
// with the tensor-parallel segment kernels (csrc/tp_segments.cu): the
// residual update and RMSNorm, SwiGLU, the attention over the paged pool
// with the new token's quantize + write and the merge of its chunks, the
// grid barrier of a persistent grid, the dynamic shared memory of a block,
// and the integer arguments the wrappers pass.

#pragma once

#include "di_attn_tile.cuh"
#include "di_product.cuh"

namespace {

using namespace di;

constexpr int kSlab = 128;        // columns per item of the norm phases
constexpr int kMaxChunks = 16;    // attention chunks per slot (wrapper)
constexpr int kAttTile = 128;     // chunk tokens are a multiple of this

__device__ __forceinline__ void grid_barrier(const Args& a, int phase) {
  di::grid_barrier(a.barrier, a.status, a.trace, phase);
}

// ---------------------------------------------------------------------------
// LoRA: the decode megakernel's LoRA branch (mk_kernel<MT, false, true>).
// What it computes (the TPU kernel's epilogue, ops/pallas/megakernel.py
// `lora_proj` / `lora_delta`): for a row b on adapter slot n and each
// target t, h = (x_bf16 @ A_t[n]) in f32 over rank space, then the
// target's product gains bf16(h) @ bf16(B_t[n] * scale[n]) (f32 pool: no
// bf16 rounding of A, B or the scale fold); a row without an adapter gains
// nothing (its arithmetic is the dense kernel's). No grid barrier is added:
//   the rank projection runs in the phase of the product that reads the
//     same x records, after its product (`lora_project`): items (target,
//     slot a row uses, kLoraKC-row chunk of K) write f32 partials of h
//     [target][chunk][row][rank] to lora_h; only the slots some active row
//     uses are read (the TPU kernel streams every slot and masks);
//   the delta is added by the phase that already sums that product's
//     K splits, each summing h's chunks in order first: the attention
//     items for q|k|v (their slot's q heads, k and v, before the bias),
//     act_phase for gate and up (so SwiGLU sees them), the next
//     resid_phase for o and down.
// ---------------------------------------------------------------------------
constexpr int kLoraKC = 512;        // K rows of a rank-projection item
constexpr int kMaxLoraRank = 64;    // lora_r (a multiple of 8)
constexpr int kMaxLoraSlots = 64;   // lora_n
enum LoraTarget { kLq, kLk, kLv, kLo, kLg, kLu, kLd };

__device__ __forceinline__ int lora_k(const Args& a, int t) {
  return t == kLo ? a.H * kD : (t == kLd ? a.inter : a.hid);
}

__device__ __forceinline__ int lora_n_out(const Args& a, int t) {
  return t == kLq ? a.H * kD
                  : (t == kLk || t == kLv) ? a.KH * kD
                  : (t == kLo || t == kLd) ? a.hid : a.inter;
}

// Row b's adapter slot, or -1 (no adapter, or an inactive row).
__device__ __forceinline__ int lora_slot(const Args& a, int b) {
  const int n = a.lora_idx[b];
  return a.active[b] && n >= 0 && n < a.lora_n ? n : -1;
}

// Element (row m, column k) of a product's x records (write_record's
// layout), as the bf16 value the product multiplies. Written by another
// block in the phase before: read past L1.
__device__ __forceinline__ float record_x(const uint8_t* rec, int mpad, int m,
                                          int k) {
  const int k0 = k % kChunkK, s = k0 >> 4, kk = k0 & 15;
  const int tig = (kk & 7) >> 1, khalf = kk >> 3;
  const int mt = m >> 4, gid = m & 7, rhalf = (m >> 3) & 1;
  const uint8_t* p = rec + (size_t)(k / kChunkK) * rec_bytes(mpad) +
                     ((mt * 4 + s) * 32 + gid * 4 + tig) * 16 +
                     (rhalf + 2 * khalf) * 4 + (kk & 1) * 2;
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Eight consecutive values of a pool tensor (bf16, or f32 when f32).
__device__ __forceinline__ void load8(const void* base, bool f32, size_t i,
                                      float (&v)[8]) {
  if (f32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    const float4 x = p[0], y = p[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&ws[j]);
      v[2 * j] = __low2float(h);
      v[2 * j + 1] = __high2float(h);
    }
  }
}

// The rank projection of targets [t0, t0 + nt) of `layer`, x from a.rec.
// Items (target, used slot, chunk) go from the last block backwards (the
// product's items go round from block 0, so its last blocks have the
// fewest); in an item a warp takes a row on the slot, its lanes every 32nd
// K row of the chunk, sixteen ranks at a time, and the warp's butterfly
// sums give the chunk's partial h of the row.
__device__ __noinline__ void lora_project(const Args& a, int layer, int t0,
                                          int nt) {
  __shared__ int s_slots[kMaxLoraSlots];
  __shared__ int s_nused;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = a.lora_r;
  if (threadIdx.x == 0) {
    unsigned long long used = 0;
    for (int b = 0; b < a.B; ++b) {
      const int n = lora_slot(a, b);
      if (n >= 0) used |= 1ull << n;
    }
    int k = 0;
    for (int n = 0; n < a.lora_n; ++n)
      if ((used >> n) & 1ull) s_slots[k++] = n;
    s_nused = k;
  }
  __syncthreads();
  const int nused = s_nused;
  int total = 0;
  for (int t = t0; t < t0 + nt; ++t)
    total += nused * ((lora_k(a, t) + kLoraKC - 1) / kLoraKC);
  for (int it = (int)gridDim.x - 1 - (int)blockIdx.x; it < total;
       it += gridDim.x) {
    int t = t0, rem = it;
    for (;;) {
      const int n_t = nused * ((lora_k(a, t) + kLoraKC - 1) / kLoraKC);
      if (rem < n_t) break;
      rem -= n_t;
      ++t;
    }
    const int K = lora_k(a, t), nkc = (K + kLoraKC - 1) / kLoraKC;
    const int n = s_slots[rem / nkc], kc = rem % nkc;
    const int k0 = kc * kLoraKC, k1 = min(K, k0 + kLoraKC);
    const size_t a0 = ((size_t)layer * a.lora_n + n) * K * R;
    float* out = a.lora_h + ((size_t)t * a.lora_kc + kc) * a.B * R;
    int j = 0;
    for (int b = 0; b < a.B; ++b) {
      if (lora_slot(a, b) != n) continue;
      if (j++ % kWarps != warp) continue;
      for (int r0 = 0; r0 < R; r0 += 16) {
        const bool two = r0 + 8 < R;
        float acc[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] = 0.f;
        for (int k = k0 + lane; k < k1; k += 32) {
          const float x = record_x(a.rec, a.mpad, b, k);
          float w[8];
          load8(a.lora_a[t], a.lora_f32, a0 + (size_t)k * R + r0, w);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] = fmaf(x, w[q], acc[q]);
          if (two) {
            load8(a.lora_a[t], a.lora_f32, a0 + (size_t)k * R + r0 + 8, w);
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[8 + q] = fmaf(x, w[q], acc[8 + q]);
          }
        }
        float mine = 0.f;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float s = warp_sum(acc[q]);
          if (lane == q) mine = s;
        }
        if (lane < 16 && r0 + lane < R) out[(size_t)b * R + r0 + lane] = mine;
      }
    }
  }
}

// bf16(h) of row b, target t, rank r: its chunks' partials summed in order.
__device__ __forceinline__ float lora_hval(const Args& a, int t, int b,
                                          int r) {
  const int nkc = (lora_k(a, t) + kLoraKC - 1) / kLoraKC;
  const size_t stride = (size_t)a.B * a.lora_r;
  const float* p = a.lora_h + (size_t)t * a.lora_kc * stride +
                   (size_t)b * a.lora_r + r;
  float h = 0.f;
  for (int kc = 0; kc < nkc; ++kc) h += __ldcg(p + kc * stride);
  return bf16_round(h);
}

// Column `col` of target t's delta for a row on slot n: bf16(h) (`h`, the
// row's lora_r values) . the column of B * scale, rounded to bf16 as the
// TPU kernel's folded view is (an f32 pool: not rounded).
__device__ __noinline__ float lora_delta(const Args& a, int t, int layer,
                                         int n, const float* h, int col) {
  const int R = a.lora_r, N = lora_n_out(a, t);
  const float s = a.lora_scale[n];
  const size_t b0 = ((size_t)layer * a.lora_n + n) * R * N + col;
  float d = 0.f;
  if (a.lora_f32) {
    const float* B = static_cast<const float*>(a.lora_b[t]) + b0;
    for (int r = 0; r < R; ++r) d = fmaf(h[r], B[(size_t)r * N] * s, d);
  } else {
    const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(a.lora_b[t]) +
                             b0;
    for (int r = 0; r < R; ++r)
      d = fmaf(h[r], bf16_round(__bfloat162float(B[(size_t)r * N]) * s), d);
  }
  return d;
}

// The q|k|v deltas of an attention item of `layer` (row b on slot n, KV
// head kvh) -> raw[i] for its first `rows` rows of kD (the q heads, then k
// and v): each thread the i that it sums in attention_phase. The block puts
// the row's bf16(h) of q, k and v in `lh` ([3][lora_r]) first.
__device__ __noinline__ void lora_qkv_delta(const Args& a, int layer, int b,
                                            int n, int kvh, int rows,
                                            float* raw, float* lh) {
  const int R = a.lora_r, G = a.H / a.KH;
  for (int i = threadIdx.x; i < 3 * R; i += kThreads)
    lh[i] = lora_hval(a, kLq + i / R, b, i % R);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int t = r < G ? kLq : (r == G ? kLk : kLv);
    raw[i] = lora_delta(a, t, layer, n, lh + (t - kLq) * R,
                        r < G ? (kvh * G + r) * kD + d : kvh * kD + d);
  }
}

// The residual update and RMSNorm before a product, in two phases with a
// grid barrier between them, so that a row is spread over many blocks (one
// block pulls a row's split-K partials from L2 at a small part of the
// card's rate). Item = (row m, slab of kSlab = 128 columns).
//   resid_phase: resid[m] (+)= sum of the split-K partials of the product
//     before it (or x0 in the first layer); the slab's values, its norm
//     weights (read once a step, so from device memory) and its sum of
//     squares -> shared memory / ssq scratch;
//   norm_phase: the row's sum of squares from all slabs' (a fixed order),
//     then RMSNorm with weight w -> the slab's two chunks of the x records.
// A block meets the same items in both phases and keeps their values in
// shared memory across the barrier: [item k][kSlab] values, then weights.
__device__ __forceinline__ int norm_items_per_block(const Args& a) {
  const int items = a.B * (a.hid / kSlab);
  return (items + gridDim.x - 1) / gridDim.x;
}

// LORA (the decode megakernel's LoRA branch): a row on an adapter slot also
// gains target `lora_t`'s delta of layer `lora_layer` (-1: none), after the
// partials; the half-block's row's bf16(h) goes to shared memory first.
template <bool LORA = false>
__device__ void resid_phase(const Args& a, const float* part, int ksplit,
                            bool from_x0, const float* w, float* smem,
                            int lora_t = -1, int lora_layer = 0) {
  const int hid = a.hid, nslab = hid / kSlab;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_block = norm_items_per_block(a);
  float* vals = smem;                          // [per_block][kSlab]
  float* wts = vals + per_block * kSlab;       // [per_block][kSlab]
  float* red = wts + per_block * kSlab;        // [kWarps]
  float* lh = red + kWarps;                    // LORA: [2][kMaxLoraRank]
  // the block's two halves take one item each at a time
  const int half = tid / kSlab, t = tid % kSlab;
  for (int k0 = 0; k0 < per_block; k0 += kThreads / kSlab) {
    const int k = k0 + half;
    const int it = blockIdx.x + k * gridDim.x;
    const bool valid = k < per_block && it < a.B * nslab;
    int slot = -1;
    if constexpr (LORA) {
      if (valid && lora_t >= 0) slot = lora_slot(a, it / nslab);
      if (slot >= 0 && t < a.lora_r)
        lh[half * kMaxLoraRank + t] = lora_hval(a, lora_t, it / nslab, t);
      __syncthreads();
    }
    if (valid) {
      const int m = it / nslab, i = (it % nslab) * kSlab + t;
      const float wv = w[i];
      float v;
      if (from_x0) {
        v = __bfloat162float(a.x0[(size_t)m * hid + i]);
      } else {
        v = __ldcg(a.resid + (size_t)m * hid + i);
        // four splits' loads are issued before the first is added
        for (int s = 0; s < ksplit; s += 4) {
          float p[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p[q] = s + q < ksplit
                       ? __ldcg(part + ((size_t)(s + q) * a.B + m) * hid + i)
                       : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) v += p[q];
        }
      }
      if (LORA && slot >= 0)
        v += lora_delta(a, lora_t, lora_layer, slot, lh + half * kMaxLoraRank,
                        i);
      a.resid[(size_t)m * hid + i] = v;
      vals[k * kSlab + t] = v;
      wts[k * kSlab + t] = wv;
      const float ss = warp_sum(v * v);
      if (lane == 0) red[warp] = ss;
    }
    __syncthreads();
    if (valid && t == 0) {
      float tot = 0.f;
#pragma unroll
      for (int j = 0; j < kSlab / 32; ++j) tot += red[half * (kSlab / 32) + j];
      a.ssq[it] = tot;
    }
    __syncthreads();
  }
}

__device__ void norm_phase(const Args& a, float* smem) {
  const int hid = a.hid, nslab = hid / kSlab;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = norm_items_per_block(a);
  const float* vals = smem;
  const float* wts = vals + per_block * kSlab;
  // a pair of warps takes an item: one 64-column chunk of the records each
  constexpr int kPer = kSlab / kChunkK;
  for (int k = warp / kPer; k < per_block; k += kWarps / kPer) {
    const int it = blockIdx.x + k * gridDim.x;
    if (it >= a.B * nslab) break;
    const int m = it / nslab, slab = it % nslab, c = warp % kPer;
    float tot = 0.f;
    for (int j = lane; j < nslab; j += 32)
      tot += __ldcg(a.ssq + m * nslab + j);
    tot = warp_sum(tot);
    // rsqrtf, as torch.rsqrt computes the plain version's
    const float inv = rsqrtf(tot / (float)hid + a.eps);
    const int e = k * kSlab + c * kChunkK + 2 * lane;
    write_record(a.rec, a.mpad, slab * kPer + c, m, lane,
                 vals[e] * inv * wts[e], vals[e + 1] * inv * wts[e + 1]);
  }
}

// SwiGLU of one (row m, 64-column chunk c) of a gate|up product's partials
// (`part`: split 0's [B][ntot], `ksplit` splits; up starts at the gate
// leaf's padded width) -> chunk c of the down product's x records. `dl`:
// the LoRA deltas of gate and up at the lane's two columns, added after the
// partials (null: none).
__device__ __forceinline__ void swiglu_chunk(const Args& a, const Stream& st,
                                             int ksplit, const float* part,
                                             int m, int c, uint8_t* rec,
                                             int lane,
                                             const float4* dl = nullptr) {
  const int col = c * kChunkK + 2 * lane;
  float g0 = 0.f, g1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll 4
  for (int s = 0; s < ksplit; ++s) {
    const float* p = part + ((size_t)s * a.B + m) * st.ntot + col;
    const float2 g = __ldcg(reinterpret_cast<const float2*>(p));
    const float2 u = __ldcg(reinterpret_cast<const float2*>(p + st.n[0]));
    g0 += g.x; g1 += g.y; u0 += u.x; u1 += u.y;
  }
  if (dl != nullptr) {
    g0 += dl->x; g1 += dl->y; u0 += dl->z; u1 += dl->w;
  }
  // the plain version's order: g * sigmoid(g), sigmoid(g) = 1 / (1 +
  // exp(-g)), then * u
  write_record(rec, a.mpad, c, m, lane,
               g0 * (1.0f / (1.0f + expf(-g0))) * u0,
               g1 * (1.0f / (1.0f + expf(-g1))) * u1);
}

// The LoRA deltas of gate and up of layer `layer` at columns col, col + 1
// for row m on slot n; the warp puts the row's bf16(h) of both in `lh`
// ([2][kMaxLoraRank], its own shared memory) first.
__device__ __noinline__ float4 lora_gate_up(const Args& a, int layer, int m,
                                            int n, int col, float* lh) {
  const int lane = threadIdx.x & 31;
  for (int r = lane; r < a.lora_r; r += 32) {
    lh[r] = lora_hval(a, kLg, m, r);
    lh[kMaxLoraRank + r] = lora_hval(a, kLu, m, r);
  }
  __syncwarp();
  const float4 d = make_float4(
      lora_delta(a, kLg, layer, n, lh, col),
      lora_delta(a, kLg, layer, n, lh, col + 1),
      lora_delta(a, kLu, layer, n, lh + kMaxLoraRank, col),
      lora_delta(a, kLu, layer, n, lh + kMaxLoraRank, col + 1));
  __syncwarp();
  return d;
}

// SwiGLU of the gate|up partials -> x records of the down product. LORA:
// a row on an adapter slot adds gate's and up's deltas of layer `layer`
// first (each warp's [2][kMaxLoraRank] of `smem` holds its row's h).
template <bool LORA = false>
__device__ void act_phase(const Args& a, int layer = 0,
                          float* smem = nullptr) {
  const int chunks = a.inter / kChunkK;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  for (int it = gw; it < chunks * a.B; it += nw) {
    const int m = it / chunks, c = it % chunks;
    if constexpr (LORA) {
      const int n = lora_slot(a, m);
      if (n >= 0) {
        const float4 dl = lora_gate_up(
            a, layer, m, n, c * kChunkK + 2 * lane,
            smem + (threadIdx.x >> 5) * 2 * kMaxLoraRank);
        swiglu_chunk(a, a.st[kGu], a.st[kGu].ksplit, a.partial, m, c, a.rec,
                     lane, &dl);
        continue;
      }
    }
    swiglu_chunk(a, a.st[kGu], a.st[kGu].ksplit, a.partial, m, c, a.rec,
                 lane);
  }
}

// Merges the `used` attention chunks of slot b's query heads of KV head h
// (G of them) -> attn_out as the x records of the o product: one warp a
// (head, half of D), the chunks in ascending order. Chunk j holds tokens
// iff j * chunk_tokens < len; chunk 0 always holds the new token. The
// chunks' maxima are natural-log scores (attend_tiles' EXACT). A function
// of its own: it runs once a (slot, KV head) and keeps its registers out
// of the attention's.
__device__ __noinline__ void merge_group(const Args& a, int b, int h,
                                         int used) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.H / a.KH, NC = a.nsplit;
  for (int t = warp; t < 2 * G; t += kWarps) {
    const int half = t & 1, head = h * G + (t >> 1);
    const size_t slot = ((size_t)b * a.H + head) * NC;
    const float* ml = a.att_ml + slot * 2;
    const float* acc = a.att_acc + slot * kD + half * 64 + 2 * lane;
    float mx = -INFINITY;
#pragma unroll 4
    for (int c = 0; c < used; ++c) mx = fmaxf(mx, __ldcg(ml + 2 * c));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll 4
    for (int c = 0; c < used; ++c) {
      const float2 m = __ldcg(reinterpret_cast<const float2*>(ml + 2 * c));
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(acc + (size_t)c * kD));
      const float f = expf(m.x - mu);
      lsum += m.y * f;
      o0 += v.x * f;
      o1 += v.y * f;
    }
    if (lsum == 0.f) lsum = 1.f;
    write_record(a.rec, a.mpad, head * 2 + half, b, lane, o0 / lsum,
                 o1 / lsum);
  }
}

// What the attention phase keeps beside the tiles' shared memory: the raw
// q heads, k and v of its KV head [(kMaxG + 2)][kD] f32 (q|k|v + bias),
// rot [(kMaxG + 1)][kD] (q after RoPE rounded to bf16, k
// after RoPE in f32), and the new token's scores [kMaxG] (scaled).
constexpr int kAttExtra = 4 * ((2 * kMaxG + 3) * kD + kMaxG);
constexpr int kAttTiles =
    imax(imax(Geo<kF32, kD, true>::kSmem, Geo<kBF16, kD, true>::kSmem),
         imax(Geo<kI8, kD, true>::kSmem, Geo<kU4, kD, true>::kSmem));

// Attention of one layer, page-tiled on the tensor cores (di_attn_tile.cuh,
// the per-op paged_attention kernel's tiles; an f32 pool on the CUDA
// cores; EXACT: an f32 softmax's precision). Item = (chunk j, slot b, KV
// head h): chunk j is the tokens
// [j * chunk_tokens, (j + 1) * chunk_tokens) of the slot (a.split_len
// tokens, a multiple of kAttTile; a.nsplit chunks cover the page table),
// whole tiles of 16 tokens a warp copied through a ring; chunks past lens
// and inactive slots have no item but chunk 0, which writes the slot's
// zero attn_out records. The item's block first puts its tiles in flight,
// then reads the q heads, k and v (SUMMED: summed with their bias by the
// q|k|v product's epilogue into a.qkv, the TP attn segment's way; else,
// the decode megakernel's, it sums the split-K partials itself, which the
// tiles in flight hide), normalizes each q head and k (a QK-norm model:
// a.qk_norm) and applies RoPE (ALIBI, an ALiBi model's instantiation:
// no rotation, no cos/sin read; attend_tiles adds slope * (t - lens[b]) to
// each cached token's score, the same origin in every chunk of the slot,
// and the new token at lens[b] gets 0); chunk 0 also quantizes and
// writes the new token (warp 0 K, warp 1 V) and folds it in from its
// unquantized f32 K/V when it merges the warps' states. The chunk's (max,
// sum, acc) go to att_ml / att_acc; the last chunk of a (slot, KV head) to
// finish (a ticket a pair, a.att_tickets, set back to 0 by its taker)
// merges the pair's chunks into the o product's x records.
template <int KIND, bool SUMMED, bool LORA = false, bool ALIBI = false>
__device__ void attention_phase(const Args& a, int layer, uint8_t* smem) {
  constexpr bool kMma = KIND != kF32;       // tensor cores but for f32
  using Gm = Geo<KIND, kD, true>;
  constexpr int Ds = KIND == kU4 ? kD / 2 : kD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = a.H, KH = a.KH, G = H / KH, NC = a.nsplit;
  const int CT = a.split_len;
  const int QKVN = (H + 2 * KH) * kD;
  float* raw = reinterpret_cast<float*>(smem + kAttTiles);
  float* rot = raw + (kMaxG + 2) * kD;
  float* s_new = rot + (kMaxG + 1) * kD;
  float* lora_lh = s_new + kMaxG;             // LORA: [3][kMaxLoraRank]
  float* q_s = reinterpret_cast<float*>(smem + Gm::kQOff);
  float* qsum_s = reinterpret_cast<float*>(smem + Gm::kQsumOff);
  __shared__ int s_last;
  const size_t row_elems = (size_t)KH * Ds;
  const int n_items = a.B * KH * NC;

  // chunk-major: the chunks that hold tokens (the first ones of every
  // slot) spread over the blocks instead of falling on every NC-th
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int j = item / (a.B * KH), h = item % KH, b = (item / KH) % a.B;
    if (!a.active[b]) {                         // block-uniform
      if (j == 0)
        for (int t = warp; t < 2 * G; t += kWarps)
          write_record(a.rec, a.mpad, (h * G + (t >> 1)) * 2 + (t & 1), b,
                       lane, 0.f, 0.f);
      continue;
    }
    const int len = a.lens[b];
    const int t_begin = j * CT;
    if (j > 0 && t_begin >= len) continue;
    const int t_end = min(len, t_begin + CT);
    const int n_tiles =
        t_end > t_begin ? (t_end - t_begin + Gm::kTileT - 1) / Gm::kTileT : 0;
    const KvSrc kv{static_cast<const uint8_t*>(a.k_pool),
                   static_cast<const uint8_t*>(a.v_pool), a.k_qp, a.v_qp,
                   a.pt + (size_t)b * a.maxP, a.ql, a.L, layer, a.ps, h, KH};
    att_prologue<KIND, kD, true, kThreads>(smem, kv, t_begin, t_end,
                                           n_tiles);
    // this thread's RoPE dim is tid % kD in every row it rotates below, and
    // chunk 0's new token lands in one page: their loads fly with q|k|v's
    const float cs = ALIBI ? 1.f : __bfloat162float(
                                       a.cos[(size_t)b * kD + (tid & (kD - 1))]);
    const float sn = ALIBI ? 0.f : __bfloat162float(
                                       a.sin[(size_t)b * kD + (tid & (kD - 1))]);
    const int new_col = min(len / a.ps, a.maxP - 1);
    const int new_page = j == 0 ? a.pt[(size_t)b * a.maxP + new_col] : 0;

    // q heads of this KV head, k, v: q|k|v + bias at the true widths
    // (SUMMED: by the q|k|v product's epilogue, into a.qkv; else the item
    // sums the partials here)
    if constexpr (SUMMED) {
      for (int i = tid; i < (G + 2) * kD; i += kThreads) {
        const int r = i / kD, d = i % kD;
        const int col = r < G ? (h * G + r) * kD + d
                              : (r == G ? (H + h) * kD + d
                                        : (H + KH + h) * kD + d);
        raw[i] = __ldcg(a.qkv + (size_t)b * QKVN + col);
      }
    } else {
      // the sum of the split-K partials, + bias. The bias is [q | k | v]
      // of the true widths; in the partials each of q, k and v starts at
      // its leaf's first column, its width padded to the pack's
      // 256-column tiles (st.n), and a row is st.ldo wide. The sums run
      // while the item's first tiles are in flight.
      const Stream& st = a.st[kQkv];
      const float* bias =
          a.qkv_b == nullptr ? nullptr : a.qkv_b + (size_t)layer * QKVN;
      // LORA, a row on an adapter slot: the deltas of its q heads (and in
      // chunk 0, which writes and attends the new token, of k and v) are
      // first put in raw, then added to the partials' sums before the bias
      int lora_rows = 0;
      if constexpr (LORA) {
        const int n = lora_slot(a, b);
        if (n >= 0) {
          lora_rows = j == 0 ? G + 2 : G;
          lora_qkv_delta(a, layer, b, n, h, lora_rows, raw, lora_lh);
        }
      }
      constexpr int kPer = ((kMaxG + 2) * kD + kThreads - 1) / kThreads;
      float v[kPer], bv[kPer];
      int cols[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / kD, d = i % kD;
        const int bc = r < G ? (h * G + r) * kD + d
                             : (r == G ? (H + h) * kD + d
                                       : (H + KH + h) * kD + d);
        cols[u] = bc + (r < G ? 0
                              : (r == G ? st.n[0] - H * kD
                                        : st.n[0] + st.n[1] - (H + KH) * kD));
        // the bias comes from device memory (read once a step): its load
        // is in flight while the partial sums are added
        bv[u] = (bias != nullptr && i < (G + 2) * kD) ? bias[bc] : 0.f;
        v[u] = 0.f;
      }
#pragma unroll 8
      for (int sp = 0; sp < st.ksplit; ++sp) {
        const float* p = a.partial + ((size_t)sp * a.B + b) * st.ldo;
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          if (tid + u * kThreads < (G + 2) * kD) v[u] += __ldcg(p + cols[u]);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = tid + u * kThreads;
        if (LORA && i < lora_rows * kD)
          raw[i] = (v[u] + raw[i]) + bv[u];
        else if (i < (G + 2) * kD)
          raw[i] = v[u] + bv[u];
      }
    }
    __syncthreads();
    if (a.qk_norm != nullptr) {
      // QK-norm (Qwen3): each q head and k RMS-normalized in f32 with the
      // layer's [D] weights, x * rsqrt(mean(x^2) + eps) * w, one warp a
      // row. Every chunk item of a (slot, KV head) sums a row in the same
      // order, so the chunks the merge combines saw the same q and k.
      const float* wn = a.qk_norm + (size_t)layer * 2 * kD;
      for (int r = warp; r < G + 1; r += kWarps) {
        float* row = raw + r * kD;
        const float* w = wn + (r < G ? 0 : kD);
        float v[kD / 32];
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < kD / 32; ++i) {
          v[i] = row[lane + 32 * i];
          ss = fmaf(v[i], v[i], ss);
        }
        const float inv = rsqrtf(warp_sum(ss) * (1.f / kD) + a.eps);
#pragma unroll
        for (int i = 0; i < kD / 32; ++i)
          row[lane + 32 * i] =
              __fmul_rn(__fmul_rn(v[i], inv), w[lane + 32 * i]);
      }
      __syncthreads();
    }
    static_assert(kThreads % kD == 0, "a thread's RoPE dim is fixed");
    for (int i = tid; i < (G + 1) * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      const float x = raw[i];
      float v = x;
      if (!ALIBI) {
        const float xr = d < kD / 2 ? -raw[i + kD / 2] : raw[i - kD / 2];
        v = x * cs + xr * sn;
      }
      rot[i] = r < G ? __bfloat162float(__float2bfloat16(v)) : v;
    }
    __syncthreads();
    const float* k_new = rot + G * kD;
    const float* v_new = raw + (G + 1) * kD;

    if (j == 0 && warp < 2) {
      // the new token goes to its page: warp 0 writes K, warp 1 writes V
      const float* src = warp == 0 ? k_new : v_new;
      void* pool = warp == 0 ? a.k_pool : a.v_pool;
      float* qp = warp == 0 ? a.k_qp : a.v_qp;
      const size_t page = (size_t)new_page * a.L + layer;
      const int off = len % a.ps;
      const size_t base = (page * a.ps + off) * row_elems + (size_t)h * Ds;
      float v[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) v[i] = src[dim_of<KIND, kDPL>(lane, i)];
      if (KIND == kF32) {
        *reinterpret_cast<float4*>(static_cast<float*>(pool) + base +
                                   lane * kDPL) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else if (KIND == kBF16) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(pool) + base + lane * kDPL);
        p[0] = __floats2bfloat162_rn(v[0], v[1]);
        p[1] = __floats2bfloat162_rn(v[2], v[3]);
      } else {
        float mn = fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
        float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
        mn = warp_min(mn);
        mx = warp_max(mx);
        const float levels = KIND == kI8 ? 255.f : 15.f;
        const float sc = fmaxf((mx - mn) / levels, 1e-8f);
        int q[kDPL];
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const float r = rintf((v[i] - mn) / sc);
          q[i] = KIND == kI8 ? (int)fminf(fmaxf(r - 128.f, -128.f), 127.f)
                             : (int)fminf(fmaxf(r, 0.f), 15.f);
        }
        if (KIND == kI8) {
          const uint32_t word = (uint32_t)(q[0] & 0xFF) |
                                ((uint32_t)(q[1] & 0xFF) << 8) |
                                ((uint32_t)(q[2] & 0xFF) << 16) |
                                ((uint32_t)(q[3] & 0xFF) << 24);
          *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(pool) + base +
                                       lane * kDPL) = word;
        } else {
          // registers 0, 1 are the low nibbles of bytes 2*lane, 2*lane + 1
          const uint16_t half = (uint16_t)((q[0] | (q[2] << 4)) |
                                           ((q[1] | (q[3] << 4)) << 8));
          *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(pool) + base +
                                       lane * (kDPL / 2)) = half;
        }
        if (lane == 0) {
          const size_t qrow = (page * 2 * KH + 2 * h) * a.ql + off;
          qp[qrow] = sc;
          qp[qrow + a.ql] = KIND == kI8 ? mn + 128.f * sc : mn;
        }
      }
    }
    if (j == 0) {
      // the new token's scores, from its unquantized f32 K (one warp a
      // head; an ALiBi model's bias is 0 there, the diagonal)
      for (int g = warp; g < G; g += kWarps) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < kD / 32; ++i)
          sc = fmaf(rot[g * kD + lane + 32 * i], k_new[lane + 32 * i], sc);
        sc = warp_sum(sc);
        if (lane == 0) s_new[g] = sc * a.att_scale;
      }
    }

    // q as the tiles take it: bf16 fragments (its values are bf16 already)
    // or f32 rows in the Geo layout
    MmaQ<KIND, kD> qm;
    qm.qsum_g = 0.f;
    if constexpr (kMma) {
#pragma unroll
      for (int s = 0; s < kD / 16; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d0 = kdim<KIND, kD>(s, tig, 2 * hf);
          const float q0 = gid < G ? rot[gid * kD + d0] : 0.f;
          const float q1 = gid < G ? rot[gid * kD + d0 + 1] : 0.f;
          qm.qa[s][hf] = pack_bf16(q0, q1);
          qm.qsum_g += q0 + q1;
        }
      qm.qsum_g += __shfl_xor_sync(0xffffffffu, qm.qsum_g, 1);
      qm.qsum_g += __shfl_xor_sync(0xffffffffu, qm.qsum_g, 2);
    } else {
      for (int i = tid; i < G * kD; i += kThreads) {
        const int g = i / kD, d = i - g * kD;
        q_s[g * Gm::kQStride + d + (d >> 5)] = rot[i];
      }
      for (int g = warp; g < G; g += kWarps) {
        float s = 0.f;
        for (int d = lane; d < kD; d += 32) s += rot[g * kD + d];
        s = warp_sum(s);
        if (lane == 0) qsum_s[g] = s;
      }
    }
    attend_tiles<KIND, kD, kMma, true, kThreads, true, ALIBI>(
        smem, kv, t_begin, t_end, n_tiles, G, a.att_scale, qm,
        ALIBI ? a.slopes + h * G : nullptr, len);

    // merge the warps' states (chunk 0: and the new token), write the
    // chunk's (max, sum, acc)
    const float* m_s = reinterpret_cast<const float*>(smem);
    const float* l_s = m_s + Gm::kWarps * kMaxG;
    const float* acc_s = l_s + Gm::kWarps * kMaxG;
    for (int idx = tid; idx < G * kD; idx += kThreads) {
      const int g = idx / kD, d = idx % kD;
      float mx = j == 0 ? s_new[g] : -INFINITY;
#pragma unroll
      for (int w = 0; w < Gm::kWarps; ++w)
        mx = fmaxf(mx, m_s[w * kMaxG + g]);
      const float mu = mx == -INFINITY ? 0.f : mx;
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < Gm::kWarps; ++w) {
        const float f = expf(m_s[w * kMaxG + g] - mu);
        lsum += l_s[w * kMaxG + g] * f;
        o += acc_s[(w * kMaxG + g) * kD + d] * f;
      }
      if (j == 0) {
        const float f = expf(s_new[g] - mu);
        lsum += f;
        o += f * v_new[d];
      }
      const size_t slot = ((size_t)b * H + h * G + g) * NC + j;
      a.att_acc[slot * kD + d] = o;
      if (d == 0) {
        a.att_ml[2 * slot] = mx;
        a.att_ml[2 * slot + 1] = lsum;
      }
    }
    // the slot's chunks: chunk 0 and each later one that holds a token
    const int used = max(1, min((len + CT - 1) / CT, NC));
    __syncthreads();                    // this chunk's state, then its ticket
    if (tid == 0) {
      __threadfence();
      unsigned* tk = a.att_tickets + (size_t)b * KH + h;
      const bool last = atomicAdd(tk, 1u) == (unsigned)used - 1;
      if (last) *tk = 0u;               // for the next layer, launch or replay
      s_last = last;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();                  // the other chunks' states
      merge_group(a, b, h, used);
    }
    __syncthreads();
  }
}

// ALIBI: an ALiBi model's kernels (a.slopes), instantiations of their own
// (megakernel.cu, tp_segments.cu), so that a RoPE model's code is what it
// was without the branch.
template <bool SUMMED, bool LORA = false, bool ALIBI = false>
__device__ void attention(const Args& a, int layer, uint8_t* smem) {
  switch (a.kv_kind) {
    case kF32:
      attention_phase<kF32, SUMMED, LORA, ALIBI>(a, layer, smem);
      break;
    case kBF16:
      attention_phase<kBF16, SUMMED, LORA, ALIBI>(a, layer, smem);
      break;
    case kI8: attention_phase<kI8, SUMMED, LORA, ALIBI>(a, layer, smem); break;
    default: attention_phase<kU4, SUMMED, LORA, ALIBI>(a, layer, smem); break;
  }
}

int smem_bytes(int mt, int hid, bool lora = false) {
  // resid/norm phases: up to kMaxBatch * hid / kSlab items over >= one
  // block per SM, values and weights each; far below the other two. The
  // LoRA branch's h rows beside the attention's extra (below the product
  // ring's bytes too, so the branch keeps the dense kernel's occupancy)
  return imax(product_smem_bytes(mt),
              kAttTiles + kAttExtra + (lora ? 4 * 3 * kMaxLoraRank : 0));
}

// Index of each value in the `ia` array of di_megakernel (ops/megakernel.py
// fills it with the same names).
enum IArg {
  I_NORMS, I_FINAL_NORM, I_QKV_B, I_X0, I_COS, I_SIN, I_PT, I_LENS, I_ACTIVE,
  I_K_POOL, I_V_POOL, I_K_QP, I_V_QP, I_LOGITS, I_RESID, I_REC, I_PARTIAL,
  I_QKV, I_TICKETS, I_ATT_TICKETS, I_ATT_ML, I_ATT_ACC, I_SSQ, I_BARRIER, I_STATUS, I_LAUNCHES, I_TRACE,
  I_EPART, I_EREC, I_TOPK_E, I_TOPK_W, I_SGATE, I_MSPLIT,
  I_B, I_L, I_HID, I_H, I_KH, I_INTER, I_V, I_PS, I_MAXP, I_KV_KIND, I_QL,
  I_NSPLIT, I_SPLIT_LEN, I_MPAD, I_SKIP_ATTN, I_GRID, I_E, I_K_TOP,
  I_NORM_TOPK, I_HAS_SHARED, I_HAS_SGATE, I_SHARED_INTER, I_QK_NORM,
  I_SLOPES, I_STREAMS
};
// then kStreamArgs values per stream (fill_stream)

// Fills `a` from the `ia` / `fa` arrays of the wrappers (IArg order, then
// kStreamArgs values per stream; fa = {rms eps, attention scale}).
inline void fill_args(Args& a, const long long* ia, const double* fa) {
  a.norms = ptr<const float>(ia[I_NORMS]);
  a.final_norm = ptr<const float>(ia[I_FINAL_NORM]);
  a.qkv_b = ptr<const float>(ia[I_QKV_B]);
  a.qk_norm = ptr<const float>(ia[I_QK_NORM]);
  a.slopes = ptr<const float>(ia[I_SLOPES]);
  a.x0 = ptr<const __nv_bfloat16>(ia[I_X0]);
  a.cos = ptr<const __nv_bfloat16>(ia[I_COS]);
  a.sin = ptr<const __nv_bfloat16>(ia[I_SIN]);
  a.pt = ptr<const int>(ia[I_PT]);
  a.lens = ptr<const int>(ia[I_LENS]);
  a.active = ptr<const uint8_t>(ia[I_ACTIVE]);
  a.k_pool = ptr<void>(ia[I_K_POOL]);
  a.v_pool = ptr<void>(ia[I_V_POOL]);
  a.k_qp = ptr<float>(ia[I_K_QP]);
  a.v_qp = ptr<float>(ia[I_V_QP]);
  a.logits = ptr<float>(ia[I_LOGITS]);
  a.resid = ptr<float>(ia[I_RESID]);
  a.rec = ptr<uint8_t>(ia[I_REC]);
  a.partial = ptr<float>(ia[I_PARTIAL]);
  a.qkv = ptr<float>(ia[I_QKV]);
  a.tickets = ptr<unsigned>(ia[I_TICKETS]);
  a.att_tickets = ptr<unsigned>(ia[I_ATT_TICKETS]);
  a.att_ml = ptr<float>(ia[I_ATT_ML]);
  a.att_acc = ptr<float>(ia[I_ATT_ACC]);
  a.ssq = ptr<float>(ia[I_SSQ]);
  a.barrier = ptr<unsigned>(ia[I_BARRIER]);
  a.status = ptr<int>(ia[I_STATUS]);
  a.launches = ptr<unsigned long long>(ia[I_LAUNCHES]);
  a.trace = ptr<unsigned long long>(ia[I_TRACE]);
  a.epart = ptr<float>(ia[I_EPART]);
  a.erec = ptr<uint8_t>(ia[I_EREC]);
  a.topk_e = ptr<int>(ia[I_TOPK_E]);
  a.topk_w = ptr<float>(ia[I_TOPK_W]);
  a.sgate = ptr<float>(ia[I_SGATE]);
  a.msplit = ptr<const int>(ia[I_MSPLIT]);
  a.E = (int)ia[I_E];
  a.k_top = (int)ia[I_K_TOP];
  a.norm_topk = (int)ia[I_NORM_TOPK];
  a.has_shared = (int)ia[I_HAS_SHARED];
  a.has_sgate = (int)ia[I_HAS_SGATE];
  a.shared_inter = (int)ia[I_SHARED_INTER];
  a.B = (int)ia[I_B];
  a.L = (int)ia[I_L];
  a.hid = (int)ia[I_HID];
  a.H = (int)ia[I_H];
  a.KH = (int)ia[I_KH];
  a.inter = (int)ia[I_INTER];
  a.V = (int)ia[I_V];
  a.ps = (int)ia[I_PS];
  a.maxP = (int)ia[I_MAXP];
  a.kv_kind = (int)ia[I_KV_KIND];
  a.ql = (int)ia[I_QL];
  a.nsplit = (int)ia[I_NSPLIT];
  a.split_len = (int)ia[I_SPLIT_LEN];
  a.mpad = (int)ia[I_MPAD];
  a.skip_attn = (int)ia[I_SKIP_ATTN];
  a.probe = 0;
  a.lora_n = 0;
  a.eps = (float)fa[0];
  a.att_scale = (float)fa[1];
  for (int i = 0; i < kStreams; ++i) {
    fill_stream(a.st[i], ia + I_STREAMS + kStreamArgs * i);
  }
}

// The decode megakernel's LoRA values after its streams, kLoraArgs
// integers (ops/megakernel.py `lora_args`): the addresses of A of the 7
// targets, of B of the 7, of the scales, of the rows' slots and of the h
// scratch; then lora_n, lora_r, lora_f32, lora_kc.
constexpr int kLoraArgs = 21;

inline void fill_lora(Args& a, const long long* p) {
  for (int t = 0; t < 7; ++t) {
    a.lora_a[t] = ptr<const void>(p[t]);
    a.lora_b[t] = ptr<const void>(p[7 + t]);
  }
  a.lora_scale = ptr<const float>(p[14]);
  a.lora_idx = ptr<const int>(p[15]);
  a.lora_h = ptr<float>(p[16]);
  a.lora_n = (int)p[17];
  a.lora_r = (int)p[18];
  a.lora_f32 = (int)p[19];
  a.lora_kc = (int)p[20];
}

}  // namespace
