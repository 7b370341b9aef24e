// The weight product of the decode megakernel (csrc/megakernel.cu), shared
// with the stream-rate probe (csrc/stream_probe.cu): the argument structs,
// the x records and `product_phase`, a persistent-grid split-K product of
// x [B, K] with a u4 / int8 / bf16 weight stream (of one matrix a layer, or
// of a list of a MoE layer's experts); and `route_row`, the MoE router of
// one token, shared with the prefill megakernel.

#pragma once

#include "di_common.cuh"

namespace di {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkK = 64;               // K rows per pipeline stage
constexpr int kD = 128;                   // head_dim
constexpr int kDPL = 4;                   // head dims per lane
constexpr int kMaxG = 8;                  // query heads per KV head
constexpr int kMaxLanes = 512;            // MoE router lanes (experts + 1)
constexpr int kMaxTopk = 8;               // experts a token

// Streams: a dense model's q|k|v, o, gate|up, down and lm_head; a MoE
// model's gate|up and down are its experts' (kGu, kDn), with its router
// (bf16) and its shared expert's gate|up and down beside them.
enum StreamId {
  kQkv = 0, kO = 1, kGu = 2, kDn = 3, kLm = 4, kRt = 5, kSgu = 6, kSdn = 7,
  kStreams = 8
};

struct Stream {
  const uint8_t* w[3];     // packed payload of each leaf (layer 0)
  const float* s[3];       // scale [G, n] (null for bf16)
  const float* z[3];       // zero  [G, n]
  long long w_ls[3];       // bytes between layers of a leaf
  long long q_ls[3];       // floats between layers of scale / zero
  long long e_ls[3];       // bytes between experts of a leaf
  long long qe_ls[3];      // floats between experts of scale / zero
  int n[3];                // columns of each leaf (padded to 256)
  int tile0[4];            // first 256-column tile of each leaf, then total
  int nleaf, K, G, bits, ksplit, cps, ntot;
  int ldo;                 // row stride of the product's output
  int nvalid;              // columns of it written back: the prefill
                           // kernel's logits (a vocab's width); the decode
                           // product writes every padded column
};

struct Args {
  Stream st[kStreams];
  const float* norms;        // [L, 2, hid]
  const float* final_norm;   // [hid]
  const float* qkv_b;        // [L, QKVN] or null
  const __nv_bfloat16* x0;   // [B, hid]
  const __nv_bfloat16* cos;  // [B, D]
  const __nv_bfloat16* sin;  // [B, D]
  const int* pt;             // [B, maxP] logical pages
  const int* lens;           // [B] tokens already cached
  const uint8_t* active;     // [B] bool
  void* k_pool;
  void* v_pool;
  float* k_qp;
  float* v_qp;
  float* logits;             // [B, V]
  float* resid;              // [B, hid]
  uint8_t* rec;              // x records
  float* partial;            // split-K partials
  float* att_ml;             // [B, H, NS, 2]
  float* att_acc;            // [B, H, NS, D]
  float* ssq;                // [B, hid / 128] sums of squares
  unsigned* barrier;
  int* status;
  unsigned long long* launches;
  unsigned long long* trace;  // null, or [phases + 1] timestamps (ns)
  float* epart;              // MoE: experts' partials [E][split][B][N]
  uint8_t* erec;             // MoE: experts' down x records [E][chunks]
  int* topk_e;               // MoE: [L][B][kMaxTopk] routed experts, ascending
  float* topk_w;             // MoE: [L][B][kMaxTopk] their gates
  float* sgate;              // MoE: [L][B] the shared expert's gate
  int B, L, hid, H, KH, inter, V, ps, maxP, kv_kind, ql, nsplit, split_len,
      mpad, skip_attn;
  int E, k_top, norm_topk, has_shared, has_sgate, shared_inter;
  int probe;                 // stream probe only (tools/bench_stream.py
                             // VARIANTS): 1 no dot, 2 no payload loads,
                             // 3 dot alone, 4 copy pipeline alone
  float eps, att_scale;
};

__device__ __forceinline__ int rec_bytes(int mpad) {
  return mpad * (kChunkK * 2 + 4);
}

// The x records of one 64-row K chunk hold the mma A fragments ready made:
// [16-row m tile][k16 step s][lane][a0 a1 a2 a3] (bf16 pairs, 16 bytes a
// lane, so a product stage reads them with one 16-byte shared-memory load
// per step), then the [mpad] f32 row sums. write_record stores elements
// 2*lane and 2*lane + 1 of row m's chunk; the row sum is over the bf16
// values, which are the dot's operand.
__device__ __forceinline__ void write_record(uint8_t* rec, int mpad, int chunk,
                                             int m, int lane, float v0,
                                             float v1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  uint8_t* r = rec + (size_t)chunk * rec_bytes(mpad);
  const int k0 = 2 * lane, s = k0 >> 4, kk = k0 & 15;
  const int tig = (kk & 7) >> 1, khalf = kk >> 3;
  const int mt = m >> 4, gid = m & 7, rhalf = (m >> 3) & 1;
  *reinterpret_cast<__nv_bfloat162*>(
      r + ((mt * 4 + s) * 32 + gid * 4 + tig) * 16 + (rhalf + 2 * khalf) * 4) =
      p;
  const float sum = warp_sum(__bfloat162float(p.x) + __bfloat162float(p.y));
  if (lane == 0)
    reinterpret_cast<float*>(r + (size_t)mpad * (kChunkK * 2))[m] = sum;
}

// The payload of one (256-column tile, 64-row chunk) as the pack lays it
// out (ops/megakernel.py `pack_payload`): warp w's part is kQuarters runs
// of 512 bytes, run q holding 16 bytes for each lane, which are that lane's
// mma B operands of
//   u4   (q = s / 2):    [s % 2][nt][i][p]         one byte = columns c, c+128
//   int8 (q = s):        [nt][i][half][p]          one byte a column
//   bf16 (q = 2 s + nt): [i][half][p]              two bytes a column
// for k16 step s, n8 tile nt (column 16 w + 8 nt + gid, + 128 for half 1),
// row 16 s + 8 i + 2 tig + p. A stage reads them with 16-byte loads.
template <int BITS>
struct Tile {
  static constexpr int kChunkBytes = kChunkK * (BITS == 4 ? 128 : (BITS == 8 ? 256 : 512));
  static constexpr int kQuarters = kChunkBytes / (kWarps * 512);
  static constexpr int kStages = BITS == 4 ? 6 : (BITS == 8 ? 4 : 3);
};

template <int BITS, int MT>
__host__ __device__ constexpr int stage_bytes() {
  return Tile<BITS>::kChunkBytes + MT * 2048 + MT * 64;
}

// two int8 in the low 16 bits -> two bf16 (exact)
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      (float)(int8_t)(w & 0xFFu), (float)(int8_t)((w >> 8) & 0xFFu));
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (a & b) | c in one instruction (the compiler spends two when b and c are
// both immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// two u4 bytes in the low 16 bits -> bf16(128 + low nibbles),
// bf16(128 + high nibbles): 0x4300 | n is 128 + n
__device__ __forceinline__ void u4x2_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t pair = __byte_perm(w, 0u, 0x4140);   // b0 | b1 << 16
  lo = and_or(pair, 0x000F000Fu, 0x43004300u);
  hi = and_or(pair >> 4, 0x000F000Fu, 0x43004300u);
}

// One weight product: out[s][m][n] = partial sums over K split s of
// x[m] . W[:, n], with the group affine applied. x comes from the records.
// Work item = (pass over 16*MT rows, tile, split); a block's items form one
// flat sequence of 64-row chunks that the cp.async pipeline runs through.
// GROUPED: an expert stream, the product of each expert of `experts`
// (ngroups of them): expert e's weights, its x records at rec + e * rec_gs
// bytes and its output at out + e * out_gs floats. The dense instantiation
// folds all of that away (a MoE model's products run in a separate
// function, so that they add nothing to the dense products' registers).
template <int BITS, int MT, bool GROUPED>
__device__ __forceinline__ void product_phase(
    const Args& a, const Stream& st, int layer, float* out, uint8_t* smem,
    const uint8_t* rec_base, const int* experts, int ngroups, size_t rec_gs,
    size_t out_gs) {
  using T = Tile<BITS>;
  constexpr int kStages = T::kStages;
  constexpr int kRows = 16 * MT;
  constexpr int kWVecs = T::kChunkBytes / 16;
  constexpr int kXVecs = MT * 2048 / 16;
  constexpr int kSumVecs = kRows * 4 / 16;
  constexpr float kOffset = BITS == 4 ? 128.f : 0.f;
  constexpr int kStage = stage_bytes<BITS, MT>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int chunks_total = st.K / kChunkK;
  const int cpg = st.K / st.G / kChunkK;   // chunks per quant group
  const int passes = a.mpad / kRows;
  const int tiles = st.tile0[st.nleaf];
  const int per_group = passes * tiles * st.ksplit;
  const int n_items = GROUPED ? per_group * ngroups : per_group;
  const int rbytes = rec_bytes(a.mpad);

  struct Item {
    const uint8_t* w;     // the tile's first chunk
    const float* s;
    const float* z;
    int n_leaf, col_leaf, col_out, split, c0, nc, m_base, e;
  };
  auto decode = [&](int item) {
    Item it;
    const int e = GROUPED ? experts[item / per_group] : 0;
    if (GROUPED) item %= per_group;
    const int split = item % st.ksplit;
    const int t = (item / st.ksplit) % tiles;
    const int pass = item / (st.ksplit * tiles);
    const int leaf = (st.nleaf > 1 && t >= st.tile0[1]) +
                     (st.nleaf > 2 && t >= st.tile0[2]);
    const int lt = t - st.tile0[leaf];
    it.n_leaf = st.n[leaf];
    it.w = st.w[leaf] + (size_t)layer * st.w_ls[leaf] +
           (size_t)e * st.e_ls[leaf] +
           (size_t)lt * chunks_total * T::kChunkBytes;
    const size_t qoff =
        (size_t)layer * st.q_ls[leaf] + (size_t)e * st.qe_ls[leaf];
    it.s = BITS == 16 ? nullptr : st.s[leaf] + qoff;
    it.z = BITS == 16 ? nullptr : st.z[leaf] + qoff;
    it.e = e;
    it.col_leaf = lt * 256;
    it.col_out = t * 256;
    it.split = split;
    it.c0 = split * st.cps;
    it.nc = min(st.cps, chunks_total - it.c0);
    it.m_base = pass * kRows;
    return it;
  };

  auto stage = [&](const Item& it, int c, int buf) {
    uint8_t* w_s = smem + (size_t)buf * kStage;
    uint8_t* x_s = w_s + T::kChunkBytes;
    uint8_t* sum_s = x_s + MT * 2048;
    if (a.probe != 2 && a.probe != 4) {
      const uint8_t* src = it.w + (size_t)(it.c0 + c) * T::kChunkBytes;
#pragma unroll
      for (int i = 0; i < kWVecs / kThreads; ++i)
        cp_async16(w_s + (tid + i * kThreads) * 16,
                   src + (tid + i * kThreads) * 16);
    }
    const uint8_t* rec = (GROUPED ? rec_base + (size_t)it.e * rec_gs : a.rec) +
                         (size_t)(it.c0 + c) * rbytes;
    const uint8_t* rx = rec + (size_t)it.m_base * (kChunkK * 2);
    const uint8_t* rs = rec + (size_t)a.mpad * (kChunkK * 2) + it.m_base * 4;
    for (int i = tid; i < kXVecs + kSumVecs; i += kThreads) {
      if (i < kXVecs)
        cp_async16(x_s + i * 16, rx + i * 16);
      else
        cp_async16(sum_s + (i - kXVecs) * 16, rs + (i - kXVecs) * 16);
    }
    cp_async_commit();
  };

  float acc[MT][4][4], part[MT][4][4], xs[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xs[mt][0] = xs[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = part[mt][j][i] = 0.f;
  }

  // load cursor (ld_*) runs kStages - 1 chunks ahead of the compute cursor
  int ld_item = blockIdx.x, ld_c = 0;
  Item ld_it = decode(ld_item < n_items ? ld_item : 0);
  auto load_next = [&](int buf) {
    if (ld_item < n_items) {
      stage(ld_it, ld_c, buf);
      if (++ld_c == ld_it.nc) {
        ld_c = 0;
        ld_item += gridDim.x;
        if (ld_item < n_items) ld_it = decode(ld_item);
      }
    } else {
      cp_async_commit();
    }
  };
  for (int s = 0; s < kStages - 1; ++s) load_next(s);

  int buf = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item it = decode(item);
    int g = it.c0 / cpg;                  // quant group of the chunk
    int g_left = cpg - it.c0 % cpg;       // chunks left in it, this one too
    for (int c = 0; c < it.nc; ++c) {
      if (a.probe < 3) {
        load_next((buf + kStages - 1) % kStages);
        cp_async_wait<kStages - 1>();
        __syncthreads();   // this chunk's payload and x record have landed
      }

      const uint8_t* base = smem + (size_t)buf * kStage;
      const uint8_t* wq = base + warp * (T::kQuarters * 512) + lane * 16;
      const uint8_t* xq = base + T::kChunkBytes + lane * 16;
      const float* sums = reinterpret_cast<const float*>(
          base + T::kChunkBytes + MT * 2048);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        xs[mt][0] += sums[mt * 16 + gid];
        xs[mt][1] += sums[mt * 16 + gid + 8];
      }
      if (a.probe != 1 && a.probe != 4) {
#pragma unroll
        for (int s = 0; s < kChunkK / 16; ++s) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                xq + (mt * 4 + s) * 512);
            af[mt][0] = v.x;
            af[mt][1] = v.y;
            af[mt][2] = v.z;
            af[mt][3] = v.w;
          }
          // this step's B operands: [nt][i] for the low and high columns
          uint32_t lo[2][2], hi[2][2];
          if (BITS == 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                wq + (s >> 1) * 512);
            const uint32_t w0 = (s & 1) ? v.z : v.x, w1 = (s & 1) ? v.w : v.y;
            u4x2_to_bf16x2(w0, lo[0][0], hi[0][0]);
            u4x2_to_bf16x2(w0 >> 16, lo[0][1], hi[0][1]);
            u4x2_to_bf16x2(w1, lo[1][0], hi[1][0]);
            u4x2_to_bf16x2(w1 >> 16, lo[1][1], hi[1][1]);
          } else if (BITS == 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(wq + s * 512);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                lo[nt][i] = i8x2_to_bf16x2(w[nt * 2 + i]);
                hi[nt][i] = i8x2_to_bf16x2(w[nt * 2 + i] >> 16);
              }
          } else {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  wq + (2 * s + nt) * 512);
              lo[nt][0] = v.x;
              hi[nt][0] = v.y;
              lo[nt][1] = v.z;
              hi[nt][1] = v.w;
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16_16816(part[mt][nt], af[mt], lo[nt][0], lo[nt][1]);
              mma_bf16_16816(part[mt][2 + nt], af[mt], hi[nt][0], hi[nt][1]);
            }
        }
      }

      // the affine is linear in the partial sums, so it is applied at the
      // end of a quant group or of the item, whichever comes first
      const bool last = c == it.nc - 1;
      const bool group_end = g_left == 1;
      if (last || group_end) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = it.col_leaf + (j >> 1) * 128 + 16 * warp +
                          8 * (j & 1) + 2 * tig;
          float2 sc = make_float2(1.f, 1.f), ze = make_float2(0.f, 0.f);
          if (BITS != 16) {
            // rounded to bf16: the TPU pack stores the qparams in bf16
            sc = bf16_round2(*reinterpret_cast<const float2*>(
                it.s + (size_t)g * it.n_leaf + col));
            ze = bf16_round2(*reinterpret_cast<const float2*>(
                it.z + (size_t)g * it.n_leaf + col));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int h = i >> 1;
              const float s_ = (i & 1) ? sc.y : sc.x;
              const float z_ = (i & 1) ? ze.y : ze.x;
              acc[mt][j][i] += (part[mt][j][i] - kOffset * xs[mt][h]) * s_ +
                               xs[mt][h] * z_;
              part[mt][j][i] = 0.f;
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) xs[mt][0] = xs[mt][1] = 0.f;
      }
      if (last) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = it.col_out + (j >> 1) * 128 + 16 * warp +
                          8 * (j & 1) + 2 * tig;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = it.m_base + mt * 16 + gid + 8 * h;
              if (m < a.B)
                *reinterpret_cast<float2*>(
                    out + (size_t)it.e * out_gs +
                    ((size_t)it.split * a.B + m) * st.ldo + col) =
                    make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
              acc[mt][j][2 * h] = acc[mt][j][2 * h + 1] = 0.f;
            }
        }
      }
      if (group_end) {
        ++g;
        g_left = cpg;
      } else {
        --g_left;
      }
      if (a.probe < 3)
        __syncthreads();   // buffer `buf` is free for the chunk kStages ahead
      buf = (buf + 1) % kStages;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// One matrix a layer, x from a.rec.
template <int MT>
__device__ void product(const Args& a, int sid, int layer, float* out,
                        uint8_t* smem) {
  const Stream& st = a.st[sid];
  if (st.bits == 4)
    product_phase<4, MT, false>(a, st, layer, out, smem, nullptr, nullptr, 1,
                                0, 0);
  else if (st.bits == 8)
    product_phase<8, MT, false>(a, st, layer, out, smem, nullptr, nullptr, 1,
                                0, 0);
  else
    product_phase<16, MT, false>(a, st, layer, out, smem, nullptr, nullptr,
                                 1, 0, 0);
}

// The experts of `experts` (a MoE stream), in a function of its own.
template <int MT>
__device__ __noinline__ void product_experts(const Args& a, int sid,
                                             int layer, float* out,
                                             uint8_t* smem,
                                             const uint8_t* rec,
                                             const int* experts, int ngroups,
                                             size_t rec_gs, size_t out_gs) {
  const Stream& st = a.st[sid];
  if (st.bits == 4)
    product_phase<4, MT, true>(a, st, layer, out, smem, rec, experts,
                               ngroups, rec_gs, out_gs);
  else if (st.bits == 8)
    product_phase<8, MT, true>(a, st, layer, out, smem, rec, experts,
                               ngroups, rec_gs, out_gs);
  else
    product_phase<16, MT, true>(a, st, layer, out, smem, rec, experts,
                                ngroups, rec_gs, out_gs);
}

// The MoE router of one token, run by one warp: the router product's E
// (+ the shared gate's) lanes summed over its K splits (`src`: the token's
// row of split 0), softmax over the E lanes, k rounds of max choosing the
// lowest lane on ties, optional renormalisation (the TPU kernel's router
// phase). Gives the chosen experts in ascending order with their gates, and
// the shared expert's gate: sigmoid of lane E, or 1 without a gate column,
// or 0 without a shared expert.
__device__ __noinline__ void route_row(const float* src, int ksplit,
                                          size_t split_stride, int E, int k,
                                          int norm, int has_shared,
                                          int has_sgate, int (&idx)[kMaxTopk],
                                          float (&w)[kMaxTopk], float& sg) {
  constexpr int kPer = kMaxLanes / 32;
  const int lane = threadIdx.x & 31;
  const int lanes = E + has_sgate;
  float lg[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = lane + 32 * j;
    float v = 0.f;
    if (e < lanes) {
      // eight splits' loads are issued before the first is added
      for (int s = 0; s < ksplit; s += 8) {
        float p[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          p[q] = s + q < ksplit
                     ? __ldcg(src + (size_t)(s + q) * split_stride + e)
                     : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) v += p[q];
      }
    }
    lg[j] = v;
  }
  float mx = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (lane + 32 * j < E) mx = fmaxf(mx, lg[j]);
  mx = warp_max(mx);
  float p[kPer], sum = 0.f, sv = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? expf(lg[j] - mx) : 0.f;
    sum += p[j];
    if (e == E) sv = lg[j];
  }
  sum = warp_sum(sum);
  sv = warp_sum(sv);
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] /= sum;
  unsigned taken = 0;
  float tot = 0.f;
  for (int r = 0; r < kMaxTopk; ++r) {
    idx[r] = 0x7fffffff;
    w[r] = 0.f;
    if (r >= k) continue;
    float best = -1.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (lane + 32 * j < E && !((taken >> j) & 1u) && p[j] > best) {
        best = p[j];
        bi = lane + 32 * j;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    idx[r] = bi;
    w[r] = best;
    tot += best;
    if (bi < E && (bi & 31) == lane) taken |= 1u << (bi >> 5);
  }
  if (norm)
    for (int r = 0; r < k; ++r) w[r] /= tot;
  // ascending expert order: the order of the sums that use them
  for (int r = 1; r < k; ++r)
    for (int q = r; q > 0 && idx[q - 1] > idx[q]; --q) {
      const int ti = idx[q];
      idx[q] = idx[q - 1];
      idx[q - 1] = ti;
      const float tw = w[q];
      w[q] = w[q - 1];
      w[q - 1] = tw;
    }
  sg = !has_shared ? 0.f : (has_sgate ? 1.0f / (1.0f + expf(-sv)) : 1.0f);
}

template <typename T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

// A stream as the wrappers pass it, kStreamArgs integers: w[3], s[3], z[3]
// (addresses), w_ls[3], q_ls[3], n[3], e_ls[3], qe_ls[3], nleaf, K, G,
// bits, ksplit, cps, ldo, nvalid (ops/megakernel.py `stream_args`).
constexpr int kStreamArgs = 32;

inline void fill_stream(Stream& st, const long long* p) {
  for (int j = 0; j < 3; ++j) {
    st.w[j] = ptr<const uint8_t>(p[j]);
    st.s[j] = ptr<const float>(p[3 + j]);
    st.z[j] = ptr<const float>(p[6 + j]);
    st.w_ls[j] = p[9 + j];
    st.q_ls[j] = p[12 + j];
    st.n[j] = (int)p[15 + j];
    st.e_ls[j] = p[18 + j];
    st.qe_ls[j] = p[21 + j];
  }
  st.nleaf = (int)p[24];
  st.K = (int)p[25];
  st.G = (int)p[26];
  st.bits = (int)p[27];
  st.ksplit = (int)p[28];
  st.cps = (int)p[29];
  st.ldo = (int)p[30];
  st.nvalid = (int)p[31];
  int t = 0;
  for (int j = 0; j < 3; ++j) {
    st.tile0[j] = t;
    if (j < st.nleaf) t += st.n[j] / 256;
  }
  st.tile0[3] = t;
  st.ntot = t * 256;
}

constexpr int imax(int x, int y) { return x > y ? x : y; }

// Dynamic shared memory of a block that runs product_phase<*, mt>.
inline int product_smem_bytes(int mt) {
  int b = mt == 1 ? Tile<4>::kStages * stage_bytes<4, 1>()
                  : Tile<4>::kStages * stage_bytes<4, 2>();
  b = imax(b, mt == 1 ? Tile<8>::kStages * stage_bytes<8, 1>()
                      : Tile<8>::kStages * stage_bytes<8, 2>());
  return imax(b, mt == 1 ? Tile<16>::kStages * stage_bytes<16, 1>()
                         : Tile<16>::kStages * stage_bytes<16, 2>());
}

}  // namespace di
