// The layer phases of the prefill megakernel (csrc/prefill_megakernel.cu),
// shared with the tensor-parallel prefill segment kernels
// (csrc/tp_prefill_segments.cu): the argument struct, the weight product of
// a 128-row tile of the prompt (`gemm_phase`, weight-side dequant with
// mma.sync), the residual update and RMSNorm of the rows, q|k|v + bias +
// RoPE with the quantize + write of the prompt's K/V rows, causal attention
// over the bf16 q / k / v scratch, SwiGLU, the final norm of row n - 1, the
// block's dynamic shared memory and the integer arguments the wrappers pass
// (ops/prefill_megakernel.py, ops/tp_megakernel.py). The MoE phases stay in
// csrc/prefill_megakernel.cu.

#pragma once

#include "di_product.cuh"

namespace {

using namespace di;

constexpr int kMTile = 128;     // prompt rows per product / attention item
constexpr int kAPad = 72;       // bf16 per staged x row (64 + 8: no conflicts)
constexpr int kPStages = 3;     // cp.async ring depth of the products
constexpr int kKeyTile = 64;    // keys per attention tile
constexpr int kKVPad = 136;     // bf16 per staged K / V row (128 + 8)

struct PArgs {
  Stream st[kStreams];
  const float* norms;        // [L, 2, hid]
  const float* final_norm;   // [hid]
  const float* qkv_b;        // [L, QKVN] or null
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
  __nv_bfloat16* xn;         // [S, hid]
  float* partial;            // [ksplit][S][N] of the product in flight
  __nv_bfloat16* qb;         // [S, H * D]
  __nv_bfloat16* kb;         // [S, KH * D]
  __nv_bfloat16* vb;         // [S, KH * D]
  __nv_bfloat16* attn;       // [S, H * D]
  __nv_bfloat16* act;        // [S, inter]
  __nv_bfloat16* x_last;     // [16, hid], rows 1.. stay zero
  unsigned* barrier;
  int* status;
  float* edn;                // MoE: a batch's down partials [eb][split][S][hid]
  float* acc;                // MoE: [S, hid] gated sum of the experts
  float* gates;              // MoE: [L][S][EP] gates, 0 where not routed
  float* sgate;              // MoE: [L][S] the shared expert's gate
  unsigned long long* launches;
  unsigned long long* trace;
  int S, L, hid, H, KH, inter, V, ps, maxPb, kv_kind, ql;
  int E, k_top, norm_topk, has_shared, has_sgate, shared_inter, EP, eb;
  float eps, att_scale;
};

// out[split][row][col] = sum over the split's K chunks of A[row] . W[:, col]
// for the rows of `mtiles` tiles of 16 * MT rows. A is row-major bf16 with
// `lda` elements a row; rows >= store_rows and columns >= st.nvalid are not
// stored. GROUPED: an expert stream, experts e0 .. e0 + ngroups - 1: group
// g's A at A + g * a_gs, its output at out + g * out_gs (the dense
// instantiation folds that away; the experts' run in a function of their
// own, so that they add nothing to the dense products' registers).
template <int BITS, int MT, bool GROUPED>
__device__ __forceinline__ void gemm_phase(
    const Stream& st, int layer, const __nv_bfloat16* A, int lda, int mtiles,
    float* out, size_t split_stride, int ldo, int store_rows, uint8_t* smem,
    int e0, int ngroups, size_t a_gs, size_t out_gs) {
  using T = Tile<BITS>;
  constexpr int kRows = 16 * MT;
  constexpr int kABytes = kRows * kAPad * 2;
  constexpr int kStage = kABytes + T::kChunkBytes;
  constexpr int kAVecs = kRows * 8;
  constexpr int kWVecs = T::kChunkBytes / 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int chunks_total = st.K / kChunkK;
  const int gs = st.K / st.G;              // K rows per quant group
  const int tiles = st.tile0[st.nleaf];
  const int per_group = tiles * st.ksplit * mtiles;
  const int n_items = GROUPED ? per_group * ngroups : per_group;

  for (int item_g = blockIdx.x; item_g < n_items; item_g += gridDim.x) {
    const int grp = GROUPED ? item_g / per_group : 0;
    const int item = GROUPED ? item_g % per_group : item_g;
    const int e = GROUPED ? e0 + grp : 0;
    const int mt_i = item % mtiles;
    const int split = (item / mtiles) % st.ksplit;
    const int t = item / (mtiles * st.ksplit);
    const int leaf = (st.nleaf > 1 && t >= st.tile0[1]) +
                     (st.nleaf > 2 && t >= st.tile0[2]);
    const int lt = t - st.tile0[leaf];
    const int n_leaf = st.n[leaf];
    const uint8_t* w_tile = st.w[leaf] + (size_t)layer * st.w_ls[leaf] +
                            (size_t)e * st.e_ls[leaf] +
                            (size_t)lt * chunks_total * T::kChunkBytes;
    const size_t qoff =
        (size_t)layer * st.q_ls[leaf] + (size_t)e * st.qe_ls[leaf];
    const float* s_leaf = BITS == 16 ? nullptr : st.s[leaf] + qoff;
    const float* z_leaf = BITS == 16 ? nullptr : st.z[leaf] + qoff;
    const __nv_bfloat16* A_g = A + (size_t)grp * a_gs;
    const int col_leaf = lt * 256, col_out = t * 256;
    const int c0 = split * st.cps;
    const int nc = min(st.cps, chunks_total - c0);
    const int m0 = mt_i * kRows;

    auto load = [&](int c, int buf) {
      uint8_t* a_s = smem + (size_t)buf * kStage;
      uint8_t* w_s = a_s + kABytes;
      const __nv_bfloat16* asrc =
          A_g + (size_t)m0 * lda + (size_t)(c0 + c) * kChunkK;
      for (int i = tid; i < kAVecs; i += kThreads) {
        const int row = i >> 3, seg = i & 7;
        cp_async16(a_s + row * (kAPad * 2) + seg * 16,
                   asrc + (size_t)row * lda + seg * 8);
      }
      const uint8_t* wsrc = w_tile + (size_t)(c0 + c) * T::kChunkBytes;
      for (int i = tid; i < kWVecs; i += kThreads)
        cp_async16(w_s + i * 16, wsrc + i * 16);
    };

    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

    for (int s = 0; s < kPStages - 1; ++s) {
      if (s < nc) load(s, s);
      cp_async_commit();
    }

    // this lane's four B columns: [half * 2 + nt]; for the u4 chain each
    // qparam twice in a bf16x2 (a B register holds two rows of one column).
    // A chunk's qparams are fetched while the chunk before is computed.
    float sc[4] = {1.f, 1.f, 1.f, 1.f}, ze[4] = {0.f, 0.f, 0.f, 0.f};
    float s_raw[4], z_raw[4];
    __nv_bfloat162 s2[4], z2[4];
    auto fetch_qparams = [&](int c) {
      const int g = ((c0 + c) * kChunkK) / gs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col =
            col_leaf + (j >> 1) * 128 + 16 * warp + 8 * (j & 1) + gid;
        s_raw[j] = s_leaf[(size_t)g * n_leaf + col];
        z_raw[j] = z_leaf[(size_t)g * n_leaf + col];
      }
    };
    if (BITS != 16) fetch_qparams(0);
    for (int c = 0; c < nc; ++c) {
      if (BITS != 16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // rounded to bf16: the TPU pack stores the qparams in bf16
          s2[j] = __float2bfloat162_rn(s_raw[j]);
          z2[j] = __float2bfloat162_rn(z_raw[j]);
          sc[j] = __low2float(s2[j]);
          ze[j] = __low2float(z2[j]);
        }
        if (c + 1 < nc) fetch_qparams(c + 1);
      }
      cp_async_wait<kPStages - 2>();
      __syncthreads();   // chunk c has landed; buffer (c - 1) % stages is free
      if (c + kPStages - 1 < nc)
        load(c + kPStages - 1, (c + kPStages - 1) % kPStages);
      cp_async_commit();

      const uint8_t* base = smem + (size_t)(c % kPStages) * kStage;
      const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(base);
      const uint8_t* wq =
          base + kABytes + warp * (T::kQuarters * 512) + lane * 16;
#pragma unroll
      for (int s = 0; s < kChunkK / 16; ++s) {
        // B operands [nt][i] of the low (bl) and high (bh) 128 columns
        uint32_t bl[2][2], bh[2][2];
        if (BITS == 4) {
          // (n | 0x4300) is bf16(128 + n); minus 128 and the affine as one
          // fused bf16 multiply-add of exact operands: bf16(n * s + z)
          // without a convert (see the header)
          const uint4 v =
              *reinterpret_cast<const uint4*>(wq + (s >> 1) * 512);
          const uint32_t w2[2] = {(s & 1) ? v.z : v.x, (s & 1) ? v.w : v.y};
          const __nv_bfloat162 k128 = __floats2bfloat162_rn(128.f, 128.f);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              // byte of row p = 0 | byte of row p = 1 << 16
              const uint32_t pair =
                  __byte_perm(w2[nt], 0u, i == 0 ? 0x4140 : 0x4342);
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
                  fmaf((float)(int8_t)((w >> 16) & 0xFFu), sc[2 + nt],
                       ze[2 + nt]),
                  fmaf((float)(int8_t)(w >> 24), sc[2 + nt], ze[2 + nt]));
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(wq + (2 * s + nt) * 512);
            bl[nt][0] = v.x;
            bh[nt][0] = v.y;
            bl[nt][1] = v.z;
            bh[nt][1] = v.w;
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // a0..a3 = rows 0-7 / 8-15 x k 0-7 / 8-15 of the 16 x 16 tile
          uint32_t af[4];
          ldmatrix_x4(af, a_s + (mt * 16 + (lane & 15)) * kAPad + 16 * s +
                              8 * (lane >> 4));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_bf16_16816(acc[mt][nt], af, bl[nt][0], bl[nt][1]);
            mma_bf16_16816(acc[mt][2 + nt], af, bh[nt][0], bh[nt][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next item

    float* o = out + (size_t)grp * out_gs + (size_t)split * split_stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col_out + (j >> 1) * 128 + 16 * warp + 8 * (j & 1) +
                      2 * tig;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + mt * 16 + gid + 8 * h;
          if (row < store_rows && col < st.nvalid)
            *reinterpret_cast<float2*>(o + (size_t)row * ldo + col) =
                make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
    }
  }
}

template <int MT>
__device__ void gemm(const Stream& st, int layer, const __nv_bfloat16* A,
                     int lda, int mtiles, float* out, size_t split_stride,
                     int store_rows, uint8_t* smem) {
  if (st.bits == 4)
    gemm_phase<4, MT, false>(st, layer, A, lda, mtiles, out, split_stride,
                             st.ldo, store_rows, smem, 0, 1, 0, 0);
  else if (st.bits == 8)
    gemm_phase<8, MT, false>(st, layer, A, lda, mtiles, out, split_stride,
                             st.ldo, store_rows, smem, 0, 1, 0, 0);
  else
    gemm_phase<16, MT, false>(st, layer, A, lda, mtiles, out, split_stride,
                              st.ldo, store_rows, smem, 0, 1, 0, 0);
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
  return make_float4(c.x + g * v.x, c.y + g * v.y, c.z + g * v.z,
                     c.w + g * v.w);
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
    const float inv = 1.0f / sqrtf(tot / (float)hid + a.eps);
    __nv_bfloat16* xo = a.xn + (size_t)row * hid;
    for (int i = tid * 4; i < hid; i += kThreads * 4) {
      const float4 v = *reinterpret_cast<const float4*>(r + i);
      const float4 wv = *reinterpret_cast<const float4*>(w + i);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(xo + i);
      o[0] = __floats2bfloat162_rn(v.x * inv * wv.x, v.y * inv * wv.y);
      o[1] = __floats2bfloat162_rn(v.z * inv * wv.z, v.w * inv * wv.w);
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

// q|k|v of every row: K splits summed, + bias, RoPE on q and k; q, k, v
// rounded to bf16 for the attention phase; K / V of rows < n into the pool
// from the f32 values. One warp a (row, head).
template <int KIND>
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
    if (hs < H + KH) {
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
        v[i] = v[i] * cs[i] + rot * sn[i];
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

__device__ void rope_kv(const PArgs& a, int layer, int rows, int n) {
  switch (a.kv_kind) {
    case kF32: rope_kv_phase<kF32>(a, layer, rows, n); break;
    case kBF16: rope_kv_phase<kBF16>(a, layer, rows, n); break;
    case kI8: rope_kv_phase<kI8>(a, layer, rows, n); break;
    default: rope_kv_phase<kU4>(a, layer, rows, n); break;
  }
}

// Causal attention of one layer over the bf16 q / k / v scratch. Item =
// (query head, 128-row query tile); a warp takes 16 rows. Pass 1 finds each
// row's maximum and sum over its key tiles, pass 2 forms p = exp(s - m) / l,
// rounds it to bf16 and accumulates p @ v.
__device__ void attention_phase(const PArgs& a, int mtiles, uint8_t* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = a.H, KH = a.KH, G = H / KH;
  const int HD = H * kD, KD = KH * kD;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kKeyTile * kKVPad;
  const int n_items = H * mtiles;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // the longest tiles (most key tiles) first
    const int hh = item % H, qt = mtiles - 1 - item / H;
    const int h = hh / G;
    const int q0 = qt * kMTile + warp * 16;
    const int r0 = q0 + gid, r1 = r0 + 8;
    const int nkt = (qt * kMTile + kMTile) / kKeyTile;

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
    // s[j][.] = scaled, masked scores of this warp's 16 rows against keys
    // k0 + 8 j + 2 tig (+1)
    auto scores = [&](int k0, float (&s)[8][4]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const __nv_bfloat16* kp = Ks + (8 * j + gid) * kKVPad + 2 * tig;
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks)
          mma_bf16_16816(s[j], qf[ks],
                         *reinterpret_cast<const uint32_t*>(kp + 16 * ks),
                         *reinterpret_cast<const uint32_t*>(kp + 16 * ks + 8));
        const int key = k0 + 8 * j + 2 * tig;
        s[j][0] = key <= r0 ? s[j][0] * a.att_scale : -FLT_MAX;
        s[j][1] = key + 1 <= r0 ? s[j][1] * a.att_scale : -FLT_MAX;
        s[j][2] = key <= r1 ? s[j][2] * a.att_scale : -FLT_MAX;
        s[j][3] = key + 1 <= r1 ? s[j][3] * a.att_scale : -FLT_MAX;
      }
    };

    float m0 = -FLT_MAX, m1 = -FLT_MAX, l0 = 0.f, l1 = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * kKeyTile;
      __syncthreads();            // the tile before has been read
      load_tile(a.kb, Ks, k0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (k0 > q0 + 15) continue;   // warp-uniform: all keys masked
      float s[8][4];
      scores(k0, s);
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

    float o[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * kKeyTile;
      __syncthreads();
      load_tile(a.kb, Ks, k0);
      load_tile(a.vb, Vs, k0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (k0 > q0 + 15) continue;
      float s[8][4];
      scores(k0, s);
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
            Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kKVPad +
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
    __nv_bfloat16* out0 = a.attn + (size_t)r0 * HD + hh * kD + 2 * tig;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(out0 + (size_t)8 * HD + 8 * j) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
    }
  }
}

// act[g][row] = bf16(silu(g) * u) from a gate|up product's K splits for
// `ngroups` groups (group g's split 0 at in + g * in_gs; up starts at the
// gate leaf's padded width; act rows of a group S apart).
template <bool GROUPED>
__device__ void act_phase(const PArgs& a, const Stream& st, const float* in,
                          size_t in_gs, int inter, int ngroups, int rows) {
  const int quarter = inter / 4, up = st.n[0];
  const size_t split_stride = (size_t)a.S * st.ntot;
  const int per_group = rows * quarter;
  const int total = GROUPED ? ngroups * per_group : per_group;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const int g = GROUPED ? i / per_group : 0, r = i - g * per_group;
    const int row = r / quarter, c = 4 * (r - row * quarter);
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), u = gv;
    for (int s = 0; s < st.ksplit; ++s) {
      const float* p = in + (size_t)g * in_gs + (size_t)s * split_stride +
                       (size_t)row * st.ntot + c;
      const float4 gs = __ldcg(reinterpret_cast<const float4*>(p));
      const float4 us = __ldcg(reinterpret_cast<const float4*>(p + up));
      gv.x += gs.x; gv.y += gs.y; gv.z += gs.z; gv.w += gs.w;
      u.x += us.x; u.y += us.y; u.z += us.z; u.w += us.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        a.act + ((size_t)g * a.S + row) * inter + c);
    o[0] = __floats2bfloat162_rn(gv.x / (1.0f + expf(-gv.x)) * u.x,
                                 gv.y / (1.0f + expf(-gv.y)) * u.y);
    o[1] = __floats2bfloat162_rn(gv.z / (1.0f + expf(-gv.z)) * u.z,
                                 gv.w / (1.0f + expf(-gv.w)) * u.w);
  }
}

__device__ void norm_phase(const PArgs& a, int rows, int ksplit,
                           size_t split_stride, bool from_x0, const float* w,
                           float* red) {
  norm_rows<false>(a, rows, ksplit, split_stride, from_x0, 0, w, red);
}

// Row n - 1: the last down product's splits into the residual, the final
// norm, bf16 -> row 0 of x_last. Block 0 alone (one row).
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
  const float inv = 1.0f / sqrtf(tot / (float)hid + a.eps);
  for (int i = tid; i < hid; i += kThreads)
    a.x_last[i] = __float2bfloat16(vals[i] * inv * a.final_norm[i]);
}

int pmk_smem_bytes() {
  const int prod =
      kPStages * (kMTile * kAPad * 2 + Tile<16>::kChunkBytes);
  const int att = 2 * kKeyTile * kKVPad * 2;
  return imax(prod, att);   // the final norm's [hid] floats are far below
}

// Index of each value in the `ia` array of di_prefill_megakernel
// (ops/prefill_megakernel.py fills it with the same names).
enum IArg {
  I_NORMS, I_FINAL_NORM, I_QKV_B, I_X0, I_COS, I_SIN, I_PAGE_ROW, I_N_TOKENS,
  I_K_POOL, I_V_POOL, I_K_QP, I_V_QP, I_LOGITS, I_RESID, I_XN, I_PARTIAL,
  I_QB, I_KB, I_VB, I_ATTN, I_ACT, I_X_LAST, I_BARRIER, I_STATUS, I_EDN,
  I_ACC, I_GATES, I_SGATE, I_LAUNCHES, I_TRACE, I_S, I_L, I_HID, I_H, I_KH,
  I_INTER, I_V, I_PS, I_MAXPB, I_KV_KIND, I_QL, I_GRID, I_E, I_K_TOP,
  I_NORM_TOPK, I_HAS_SHARED, I_HAS_SGATE, I_SHARED_INTER, I_EP, I_EB,
  I_STREAMS
};
// then kStreamArgs values per stream (fill_stream)

// PArgs from the `ia` / `fa` arrays of di_prefill_megakernel (the IArg
// order, then kStreamArgs values per stream).
inline void fill_pargs(PArgs& a, const long long* ia, const double* fa) {
  a.norms = ptr<const float>(ia[I_NORMS]);
  a.final_norm = ptr<const float>(ia[I_FINAL_NORM]);
  a.qkv_b = ptr<const float>(ia[I_QKV_B]);
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
  a.x_last = ptr<__nv_bfloat16>(ia[I_X_LAST]);
  a.barrier = ptr<unsigned>(ia[I_BARRIER]);
  a.status = ptr<int>(ia[I_STATUS]);
  a.edn = ptr<float>(ia[I_EDN]);
  a.acc = ptr<float>(ia[I_ACC]);
  a.gates = ptr<float>(ia[I_GATES]);
  a.sgate = ptr<float>(ia[I_SGATE]);
  a.E = (int)ia[I_E];
  a.k_top = (int)ia[I_K_TOP];
  a.norm_topk = (int)ia[I_NORM_TOPK];
  a.has_shared = (int)ia[I_HAS_SHARED];
  a.has_sgate = (int)ia[I_HAS_SGATE];
  a.shared_inter = (int)ia[I_SHARED_INTER];
  a.EP = (int)ia[I_EP];
  a.eb = (int)ia[I_EB];
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
