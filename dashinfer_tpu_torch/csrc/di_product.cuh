// The weight product of the decode megakernel (csrc/megakernel.cu), shared
// with the stream-rate probe (csrc/stream_probe.cu): the argument structs,
// the x records and `product_phase`, a persistent-grid split-K product of
// x [B, K] with a u4 / int8 / bf16 weight stream (of one matrix a layer, or
// of a list of a MoE layer's experts); and `route_top` / `route_row`, the
// MoE router of one token, shared with the MoE phases (di_moe_layer.cuh)
// and the prefill megakernel.

#pragma once

#include "di_common.cuh"

namespace di {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkK = 64;               // K rows per pipeline stage
constexpr int kD = 128;                   // head_dim
constexpr int kDPL = 4;                   // head dims per lane
constexpr int kMaxLanes = 512;            // MoE router lanes (experts + 1)
constexpr int kMaxTopk = 8;               // experts a token
// An entry of a MoE split table (Args::msplit), one per routed count: the
// K split (splits, chunks a split) of the experts' gate|up, of the
// experts' down and of the shared expert's down
enum MoeSplit { kGuKs, kGuCps, kDnKs, kDnCps, kSdnKs, kSdnCps,
                kMoeSplitArgs = 8 };

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

// One stream's share of a grouped product phase (product_phase).
struct Part {
  const Stream* st;
  const uint8_t* rec;      // x records of expert 0
  float* out;              // output of expert 0, split 0
  const int* experts;      // the groups' experts, or null: one, expert 0
  size_t rec_gs, out_gs;   // bytes / floats between experts'
  int ngroups, ksplit, cps;
};

struct Args {
  Stream st[kStreams];
  const float* norms;        // [L, 2, hid]
  const float* final_norm;   // [hid]
  const float* qkv_b;        // [L, QKVN] or null
  const float* qk_norm;      // [L, 2, D] q_norm, k_norm (Qwen3) or null
  const float* slopes;       // [H] ALiBi slopes of the plan's heads or null
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
  float* qkv;                // [B, (H + 2 KH) D] q|k|v + bias, true widths
  unsigned* tickets;         // [passes][tiles] of the q|k|v epilogue
  unsigned* att_tickets;     // [B][KH] of the attention chunks' merge
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
  const int* msplit;         // MoE: [routed count 0..E][kMoeSplitArgs], the
                             // K splits of that many routed experts' phases
                             // (ops/tp_megakernel.py `moe_split_table`)
  int B, L, hid, H, KH, inter, V, ps, maxP, kv_kind, ql, nsplit, split_len,
      mpad, skip_attn;
  int E, k_top, norm_topk, has_shared, has_sgate, shared_inter;
  int probe;                 // stream probe only (tools/bench_stream.py
                             // VARIANTS): 1 no dot (the ring and the
                             // affine run), 2 no payload loads (the ring
                             // brings records, sums and qparams), 3 dot
                             // alone (no copy, no wait), 4 copy pipeline
                             // alone (no dequant, dot or affine)
  float eps, att_scale;
  // The decode megakernel's LoRA branch (di_layer.cuh; lora_n 0 without):
  // per target (q, k, v, o, gate, up, down) the adapter pool's A
  // [L][lora_n][K][lora_r] and B [L][lora_n][lora_r][N], bf16 (f32 when
  // lora_f32), as lora/manager.py holds it; last in the struct, so that
  // the other kernels' fields keep their offsets.
  const void* lora_a[7];
  const void* lora_b[7];
  const float* lora_scale;   // [lora_n] alpha / rank of each slot
  const int* lora_idx;       // [B] each row's slot, -1 = none
  float* lora_h;             // [7][lora_kc][B][lora_r] rank-space partials
  int lora_n, lora_r, lora_f32, lora_kc;
};

__device__ __forceinline__ int rec_bytes(int mpad) {
  return mpad * (kChunkK * 2 + 4);
}

// The x records of one 64-row K chunk hold the x operand's mma fragments
// ready made: [16-row m tile][k16 step s][lane][a0 a1 a2 a3] (bf16 pairs,
// 16 bytes a lane, so a product stage reads them with one 16-byte
// shared-memory load per step), then the [mpad] f32 row sums. The 16 bytes
// of lane (gid, tig) are the A fragment of rows gid, gid + 8 of the m tile,
// and so also the B fragments of two n8 tiles of batch rows: (a0, a2) for
// rows gid of the tile's first eight, (a1, a3) for its second eight.
// write_record stores elements 2*lane and 2*lane + 1 of row m's chunk; the
// row sum is over the bf16 values, which are the dot's operand.
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
// mma fragments of
//   u4   (q = s / 2):    [s % 2][nt][i][p]         one byte = columns c, c+128
//   int8 (q = s):        [nt][i][half][p]          one byte a column
//   bf16 (q = 2 s + nt): [i][half][p]              two bytes a column
// for k16 step s, n8 tile nt (column 16 w + 8 nt + gid, + 128 for half 1),
// row 16 s + 8 i + 2 tig + p. A stage reads them with 16-byte loads. Read
// as B operands (weights as the n8 side, x as the m16 side) they pair two
// K rows of one column; read as A operands they are, for each half, the
// m16 x k16 fragment whose 16 rows are the warp's 16 columns of that half:
// a0 = [nt 0][i 0], a1 = [nt 1][i 0], a2 = [nt 0][i 1], a3 = [nt 1][i 1].
template <int BITS>
struct Tile {
  static constexpr int kChunkBytes = kChunkK * (BITS == 4 ? 128 : (BITS == 8 ? 256 : 512));
  static constexpr int kQuarters = kChunkBytes / (kWarps * 512);
  static constexpr int kStages = BITS == 4 ? 6 : (BITS == 8 ? 5 : 3);
  // a chunk is issued into the stage of the chunk kLag before the one
  // being computed: with two, that stage is normally long free, so the
  // issuing warp does not wait for the slowest warp's previous chunk
  static constexpr int kLag = kStages >= 5 ? 2 : 1;
};

// One stage of the product's ring: the chunk's payload, its x record rows
// (MT m16 tiles), their row sums, and, for a quantized stream, the scale
// and zero rows of the chunk's quant group over the tile's 256 columns
// (1 KB each, where the chunk ends a group or an item).
template <int BITS, int MT>
struct Ring {
  static constexpr int kXOff = Tile<BITS>::kChunkBytes;
  static constexpr int kSumOff = kXOff + MT * 2048;
  static constexpr int kQpOff = kSumOff + MT * 64;
  static constexpr int kStage = kQpOff + (BITS == 16 ? 0 : 2048);
  // the stages, a full and an empty mbarrier a stage, the load cursor
  static constexpr int kBarOff = Tile<BITS>::kStages * kStage;
  static constexpr int kCursorOff = kBarOff + 16 * Tile<BITS>::kStages;
  static constexpr int kBytes = kCursorOff + 80;
};

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

// The q|k|v product with its K splits summed in its own epilogue, before
// the phase's grid barrier (the TP attn segment's): for each of its items
// (pass, 256-column tile, K split), once its product loop is done, a block
// takes the (pass, tile)'s ticket (Args::tickets), and the block that
// takes a tile's last sums that tile's split partials for the pass's
// active rows < B, in ascending split order from 0 (as the attention items
// would), adds the layer's bias (`bias`, [(H + 2 KH) D], or null) and
// writes q|k|v at their true widths into `out` ([B][(H + 2 KH) D], without
// the leaves' 256-column padding), and sets the ticket back to 0 for the
// next layer, launch or graph replay.
//
// The sum of one tile: a thread takes four columns (one float4) and two
// rows at a time, eight splits' loads in flight for each, then adds them in
// split order.
template <int MT>
__device__ __forceinline__ void sum_tile(const Args& a, const Stream& st,
                                         float* out, const float* bias,
                                         const float* part, int t,
                                         int m_base) {
  static_assert(kThreads == 256, "64 float4 columns x 4 row groups");
  const int c = 4 * (threadIdx.x & 63), g = threadIdx.x >> 6;
  // the leaves' widths are whole heads: four columns are all of a leaf's
  // true width or all of its padding
  const int leaf = (t >= st.tile0[1]) + (t >= st.tile0[2]);
  const int lc = (t - st.tile0[leaf]) * 256 + c;     // column of the leaf
  if (lc >= (leaf == 0 ? a.H : a.KH) * kD) return;   // the leaf's padding
  const int col = (leaf == 0 ? 0 : (leaf == 1 ? a.H : a.H + a.KH) * kD) + lc;
  const int ld = (a.H + 2 * a.KH) * kD;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) bv = *reinterpret_cast<const float4*>(bias + col);
  const float* src = part + (size_t)t * 256 + c;
  const size_t split_stride = (size_t)a.B * st.ldo;
  const int m_end = min(m_base + 16 * MT, a.B);
  const int ks = st.ksplit;
  for (int m0 = m_base + g; m0 < m_end; m0 += 8) {   // rows m0, m0 + 4
    const bool two = m0 + 4 < m_end;
    const float* r0 = src + (size_t)m0 * st.ldo;
    const float* r1 = src + (size_t)(two ? m0 + 4 : m0) * st.ldo;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    for (int s0 = 0; s0 < ks; s0 += 8) {
      float4 p0[8], p1[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const size_t o = (size_t)(s0 + q < ks ? s0 + q : 0) * split_stride;
        p0[q] = __ldcg(reinterpret_cast<const float4*>(r0 + o));
        p1[q] = __ldcg(reinterpret_cast<const float4*>(r1 + o));
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (s0 + q < ks) {                // ascending, and no + 0.f beyond
          v0.x += p0[q].x; v0.y += p0[q].y; v0.z += p0[q].z; v0.w += p0[q].w;
          v1.x += p1[q].x; v1.y += p1[q].y; v1.z += p1[q].z; v1.w += p1[q].w;
        }
    }
    v0 = make_float4(v0.x + bv.x, v0.y + bv.y, v0.z + bv.z, v0.w + bv.w);
    v1 = make_float4(v1.x + bv.x, v1.y + bv.y, v1.z + bv.z, v1.w + bv.w);
    if (a.active[m0])
      *reinterpret_cast<float4*>(out + (size_t)m0 * ld + col) = v0;
    if (two && a.active[m0 + 4])
      *reinterpret_cast<float4*>(out + (size_t)(m0 + 4) * ld + col) = v1;
  }
}

// The epilogue of the q|k|v product phase (product_phase's items of this
// block, in its order): the tickets, and the sums of the tiles whose last
// ticket this block takes. A function of its own: its loads in flight do
// not shape the registers of the kernel's product loops.
template <int MT>
__device__ __noinline__ void qkv_epilogue(const Args& a, const Stream& st,
                                          float* out, const float* bias,
                                          const float* part) {
  __shared__ int s_last;
  constexpr int kRows = 16 * MT;
  const int tiles = st.tile0[st.nleaf], ks = st.ksplit;
  const int n_items = a.mpad / kRows * tiles * ks;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int t = (item / ks) % tiles, pass = item / (ks * tiles);
    __syncthreads();                      // the block's partials, then
    if (threadIdx.x == 0) {               // its ticket
      __threadfence();
      unsigned* tk = a.tickets + pass * tiles + t;
      const bool last = atomicAdd(tk, 1u) == (unsigned)ks - 1;
      if (last) *tk = 0u;
      s_last = last;
    }
    __syncthreads();
    if (!s_last) continue;
    __threadfence();                      // the other blocks' partials
    sum_tile<MT>(a, st, out, bias, part, t, pass * kRows);
  }
}

// One weight product: out[s][m][n] = partial sums over K split s of
// x[m] . W[:, n], with the group affine applied. x comes from the records.
// Work item = (pass over 16*MT rows, tile, split); a block's items form one
// flat sequence of 64-row chunks that the ring runs through.
//
// The weights are the mma's A operand (m16: the warp's 16 columns of a
// half of the tile, straight from the payload registers) and x its B
// operand (n8: eight batch rows, straight from the records), so the
// product spends one mma a (half, k16 step) on each n8 tile of rows that
// holds a row < B: 2 at B <= 8 (x on the m16 side would take 4, half of
// each tile padding). The output fragment is (column gid / gid + 8,
// batch rows 2 tig, 2 tig + 1): the scale and zero are per column, the row
// sums per batch row.
//
// The ring: one thread issues each chunk's bulk copies (payload, x record
// rows with their row sums, and the qparam rows where the chunk ends a
// group or its item) on the stage's full mbarrier, armed with their bytes;
// each warp waits on it, computes, and arrives on the stage's empty
// mbarrier, which the issuing thread waits on before it refills the stage.
// The issuing is dealt round the warps (lane 0 of warp n % 8 issues at
// chunk n) from a cursor in shared memory that holds the current item
// decoded, so no warp carries it every chunk; a chunk goes into the stage
// of the chunk kLag before the one being computed (two in the deeper
// rings: that stage is normally long free, so the issuing warp does not
// wait for the slowest warp), and a turn counter keeps one issuer at a
// time. No
// block-wide barrier a chunk and no global load in the chunk loop. The
// barriers are initialised at the phase's start and invalidated at its
// end, behind the async-proxy fence, so every phase of a persistent launch
// (and every graph replay) starts them at parity 0.
//
// GROUPED: the products of a MoE layer's `parts` (one or two streams of
// one payload format: its routed experts' and its shared expert's), dealt
// as ONE item space over blocks first .. gridDim.x - 1: part 0's items,
// then part 1's, item i going to block first + i % (gridDim.x - first)
// (blocks below `first` have other work). A part's items are (group, pass,
// tile, split), its groups the experts of `experts` (expert e's weights,
// its x records at rec + e * rec_gs bytes, its output at out + e * out_gs
// floats; no list: one group, expert 0), its K split `ksplit` x `cps`
// chunks (a split count the caller chose for this step's routing, up to
// the stream's own, which sets the strides of its output). So each block
// starts and drains its ring once a phase, whatever the parts. The dense
// instantiation folds all of that away (a MoE model's products run in a
// separate function, so that they add nothing to the dense products'
// registers).
//
// A: the launch's arguments, of which the phase reads the x records and
// their rows (rec, mpad, B), the probe variant and the status word: the
// decode kernels' `Args`, or the prefill kernels' one-row view of their
// lm_head (di_prefill_layer.cuh `RowArgs`).
template <int BITS, int MT, bool GROUPED, class A>
__device__ __forceinline__ void product_phase(
    const A& a, const Stream& st, int layer, float* out, uint8_t* smem,
    const Part* parts, int nparts, int first) {
  using T = Tile<BITS>;
  using R = Ring<BITS, MT>;
  constexpr int kStages = T::kStages;
  constexpr int kRows = 16 * MT;
  constexpr int kNT = 2 * MT;             // n8 tiles of batch rows
  constexpr float kOffset = BITS == 4 ? 128.f : 0.f;
  constexpr int kStage = R::kStage;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int chunks_total = st.K / kChunkK;
  const int cpg = st.K / st.G / kChunkK;   // chunks per quant group
  const int passes = a.mpad / kRows;
  const int tiles = st.tile0[st.nleaf];
  const int per_group = passes * tiles * st.ksplit;
  auto part_items = [&](const Part& p) {
    return passes * p.st->tile0[p.st->nleaf] * p.ksplit * p.ngroups;
  };
  const int n_items0 = GROUPED ? part_items(parts[0]) : per_group;
  const int n_items =
      GROUPED && nparts > 1 ? n_items0 + part_items(parts[1]) : n_items0;
  // the block's first item (none: n_items) and the blocks items go round
  const int nb = GROUPED ? (int)gridDim.x - first : (int)gridDim.x;
  const int b0 = GROUPED && (int)blockIdx.x < first
                     ? n_items
                     : (int)blockIdx.x - (GROUPED ? first : 0);
  const int rbytes = rec_bytes(a.mpad);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBarOff);
  uint64_t* empty = full + kStages;
  // the load cursor (shared memory: no registers across the loop, and any
  // warp can issue): the item it is in, decoded, and where in it
  struct Cursor {
    const uint8_t* w;     // the item's payload, chunk c0
    const float* s;       // scale / zero of the item's tile, group row 0
    const float* z;
    const uint8_t* rec;   // the item's x records, chunk c0
    int item, c, nc, m_base, n, g, gl, n_leaf, cpg;
    int turn;             // issue turns taken (volatile: any warp's)
  };
  Cursor* cur = reinterpret_cast<Cursor*>(smem + R::kCursorOff);
  const bool ring = a.probe != 3;
  const bool pay = a.probe != 2;
  const bool dot = a.probe != 1 && a.probe != 4;
  const bool affine = a.probe != 4;

  struct Item {
    const uint8_t* w;     // the tile's first chunk
    const float* s;       // the tile's first column of the leaf's scale
    const float* z;
    const uint8_t* rec;   // the item's expert's x records (chunk 0)
    float* out;           // GROUPED: the item's expert's output (split 0)
    int col_out, split, c0, nc, m_base, n_leaf, cpg, ldo;
  };
  auto decode = [&](int item) {
    Item it;
    const Part* P = parts;
    if (GROUPED && nparts > 1 && item >= n_items0) {
      P = parts + 1;
      item -= n_items0;
    }
    const Stream& ps = GROUPED ? *P->st : st;
    const int ks = GROUPED ? P->ksplit : st.ksplit;
    const int cps = GROUPED ? P->cps : st.cps;
    const int ct = GROUPED ? ps.K / kChunkK : chunks_total;
    const int tl = GROUPED ? ps.tile0[ps.nleaf] : tiles;
    int e = 0;
    if (GROUPED) {
      const int pg = passes * tl * ks;
      if (P->experts != nullptr) e = P->experts[item / pg];
      item %= pg;
    }
    const int split = item % ks;
    const int t = (item / ks) % tl;
    const int pass = item / (ks * tl);
    const int leaf = (ps.nleaf > 1 && t >= ps.tile0[1]) +
                     (ps.nleaf > 2 && t >= ps.tile0[2]);
    const int lt = t - ps.tile0[leaf];
    it.w = ps.w[leaf] + (size_t)layer * ps.w_ls[leaf] +
           (size_t)e * ps.e_ls[leaf] + (size_t)lt * ct * T::kChunkBytes;
    const size_t qoff = (size_t)layer * ps.q_ls[leaf] +
                        (size_t)e * ps.qe_ls[leaf] + (size_t)lt * 256;
    it.s = BITS == 16 ? nullptr : ps.s[leaf] + qoff;
    it.z = BITS == 16 ? nullptr : ps.z[leaf] + qoff;
    it.col_out = t * 256;
    it.split = split;
    it.c0 = split * cps;
    it.nc = min(cps, ct - it.c0);
    it.m_base = pass * kRows;
    it.rec = GROUPED ? P->rec + (size_t)e * P->rec_gs : a.rec;
    it.out = GROUPED ? P->out + (size_t)e * P->out_gs : out;
    it.n_leaf = ps.n[leaf];
    it.cpg = GROUPED ? ps.K / ps.G / kChunkK : cpg;
    it.ldo = ps.ldo;
    return it;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    fence_mbar_init();
    cur->item = b0 - nb;
    cur->n = 0;
    cur->c = cur->nc = 0;    // the first issue moves to item blockIdx.x
    cur->turn = 0;
  }
  // every thread's earlier accesses to this memory (another phase's) come
  // before the copies that refill it
  fence_proxy_async();
  __syncthreads();

  // takes the issue turn of compute chunk n (turn n + kStages - kLag: the
  // prologue takes the first kStages - kLag): once the turn before it has
  // ended (one issuer at a time; the cursor it wrote is visible) and chunk
  // n - kLag's stage is free (its empty barrier), the next chunk of the
  // block's sequence goes into that stage
  auto issue = [&](int n, int turn) {
    volatile int* vturn = &cur->turn;
    if (*vturn != turn) {
      unsigned spins = 0;
      unsigned long long t0 = 0;
      while (*vturn != turn) {
        if ((++spins & 0xFFu) == 0) {
          if (*reinterpret_cast<volatile int*>(a.status) != 0) break;
          const unsigned long long now = global_ns();
          if (t0 == 0) {
            t0 = now;
          } else if (now - t0 > kBarrierTimeoutNs) {
            atomicCAS(a.status, 0, kRingTimeout);
            break;
          }
        }
      }
    }
    __threadfence_block();
    if (n >= T::kLag)
      mbar_wait(empty + (n - T::kLag) % kStages,
                ((n - T::kLag) / kStages) & 1, a.status);
    Cursor& cu = *cur;
    if (cu.c == cu.nc) {                  // the next item
      cu.item += nb;
      if (cu.item >= n_items) {
        cu.c = cu.nc = 0;
        __threadfence_block();
        *vturn = turn + 1;
        return;
      }
      const Item it = decode(cu.item);
      cu.w = it.w + (size_t)it.c0 * T::kChunkBytes;
      cu.s = it.s;
      cu.z = it.z;
      cu.rec = it.rec + (size_t)it.c0 * rbytes;
      cu.c = 0;
      cu.nc = it.nc;
      cu.m_base = it.m_base;
      cu.g = it.c0 / it.cpg;
      cu.gl = it.cpg - it.c0 % it.cpg;
      cu.cpg = it.cpg;
      cu.n_leaf = it.n_leaf;
    }
    const int ld_n = cu.n;                // chunks issued before
    const int buf = ld_n % kStages;
    uint8_t* dst = smem + (size_t)buf * kStage;
    const bool qp = BITS != 16 && (cu.c == cu.nc - 1 || cu.gl == 1);
    const uint8_t* rec = cu.rec + (size_t)cu.c * rbytes;
    const int m_base = cu.m_base;
    const unsigned bytes = (pay ? T::kChunkBytes : 0) + MT * 2048 + MT * 64 +
                           (qp ? 2048 : 0);
    mbar_arrive_tx(full + buf, bytes);
    if (pay)
      bulk_g2s(dst, cu.w + (size_t)cu.c * T::kChunkBytes, T::kChunkBytes,
               full + buf);
    if (a.mpad == kRows) {                // one pass: rows and sums abut
      bulk_g2s(dst + R::kXOff, rec, MT * 2048 + MT * 64, full + buf);
    } else {
      bulk_g2s(dst + R::kXOff, rec + (size_t)m_base * (kChunkK * 2),
               MT * 2048, full + buf);
      bulk_g2s(dst + R::kSumOff,
               rec + (size_t)a.mpad * (kChunkK * 2) + m_base * 4, MT * 64,
               full + buf);
    }
    if (qp) {
      const size_t g = (size_t)cu.g * cu.n_leaf;
      bulk_g2s(dst + R::kQpOff, cu.s + g, 1024, full + buf);
      bulk_g2s(dst + R::kQpOff + 1024, cu.z + g, 1024, full + buf);
    }
    cu.n = ld_n + 1;
    if (cu.gl == 1) {
      ++cu.g;
      cu.gl = GROUPED ? cu.cpg : cpg;
    } else {
      --cu.gl;
    }
    ++cu.c;
    __threadfence_block();
    *vturn = turn + 1;
  };
  if (tid == 0 && ring)
    for (int s = 0; s < kStages - T::kLag; ++s) issue(0, s);

  float acc[2][kNT][4], part[2][kNT][4], xs[kNT][2];
#pragma unroll
  for (int r = 0; r < kNT; ++r) {
    xs[r][0] = xs[r][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][r][i] = part[h][r][i] = 0.f;
  }

  int n = 0;                              // chunks consumed
  for (int item = b0; item < n_items; item += nb) {
    const Item it = decode(item);
    // n8 tiles of this pass that hold a row < B (warp-uniform)
    const int live = min(kNT, (a.B - it.m_base + 7) >> 3);
    int g_left = it.cpg - it.c0 % it.cpg; // chunks left in the group
    for (int c = 0; c < it.nc; ++c, ++n) {
      const int buf = n % kStages;
      if (ring) {
        // the chunk kStages - kLag ahead, by this chunk's warp
        if (lane == 0 && warp == n % kWarps)
          issue(n, n + kStages - T::kLag);
        __syncwarp();
        mbar_wait(full + buf, (n / kStages) & 1, a.status);
      }
      const uint8_t* base = smem + (size_t)buf * kStage;
      const uint8_t* wq = base + warp * (T::kQuarters * 512) + lane * 16;
      const uint8_t* xq = base + R::kXOff + lane * 16;
      const float* sums = reinterpret_cast<const float*>(base + R::kSumOff);
#pragma unroll
      for (int r = 0; r < kNT; ++r) {
        xs[r][0] += sums[8 * r + 2 * tig];
        xs[r][1] += sums[8 * r + 2 * tig + 1];
      }
      // the weights as A: [nt][i] of the low and high column halves of
      // k16 step s
      auto payload = [&](int s, uint32_t (&lo)[2][2], uint32_t (&hi)[2][2]) {
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
      };
      if (dot) {
#pragma unroll
        for (int s = 0; s < kChunkK / 16; ++s) {
          // x as B: [n8 tile][b0 b1]
          uint32_t bx[kNT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                xq + (mt * 4 + s) * 512);
            bx[2 * mt][0] = v.x;
            bx[2 * mt][1] = v.z;
            bx[2 * mt + 1][0] = v.y;
            bx[2 * mt + 1][1] = v.w;
          }
          uint32_t lo[2][2], hi[2][2];
          payload(s, lo, hi);
          const uint32_t alo[4] = {lo[0][0], lo[1][0], lo[0][1], lo[1][1]};
          const uint32_t ahi[4] = {hi[0][0], hi[1][0], hi[0][1], hi[1][1]};
#pragma unroll
          for (int r = 0; r < kNT; ++r)
            if (r < live) {
              mma_bf16_16816(part[0][r], alo, bx[r][0], bx[r][1]);
              mma_bf16_16816(part[1][r], ahi, bx[r][0], bx[r][1]);
            }
        }
      }

      // the affine is linear in the partial sums, so it is applied at the
      // end of a quant group or of the item, whichever comes first, with
      // the group's scale and zero of the stage (rounded to bf16: the TPU
      // pack stores the qparams in bf16)
      const bool last = c == it.nc - 1;
      const bool group_end = g_left == 1;
      if (affine && (last || group_end)) {
        const float* qs = reinterpret_cast<const float*>(base + R::kQpOff);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sc[2] = {1.f, 1.f}, ze[2] = {0.f, 0.f};
          if (BITS != 16) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = 128 * h + 16 * warp + 8 * j + gid;
              sc[j] = bf16_round(qs[col]);
              ze[j] = bf16_round(qs[256 + col]);
            }
          }
#pragma unroll
          for (int r = 0; r < kNT; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x_ = xs[r][i & 1];
              acc[h][r][i] += (part[h][r][i] - kOffset * x_) * sc[i >> 1] +
                              x_ * ze[i >> 1];
              part[h][r][i] = 0.f;
            }
        }
#pragma unroll
        for (int r = 0; r < kNT; ++r) xs[r][0] = xs[r][1] = 0.f;
      }
      if (ring) {
        __syncwarp();                     // the warp is done with the stage
        if (lane == 0) mbar_arrive(empty + buf);
      }
      if (last && affine) {
        float* o = it.out + (size_t)it.split * a.B * it.ldo + it.col_out +
                   16 * warp + gid;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < kNT; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = it.m_base + 8 * r + 2 * tig + (i & 1);
              if (m < a.B)
                o[(size_t)m * it.ldo + 128 * h + 8 * (i >> 1)] =
                    acc[h][r][i];
              acc[h][r][i] = 0.f;
            }
      }
      if (group_end)
        g_left = it.cpg;
      else
        --g_left;
    }
  }
  // every chunk issued was waited for: no copy is in flight
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

// One matrix a layer, x from a.rec.
template <int MT>
__device__ void product(const Args& a, int sid, int layer, float* out,
                        uint8_t* smem) {
  const Stream& st = a.st[sid];
  if (st.bits == 4)
    product_phase<4, MT, false>(a, st, layer, out, smem, nullptr, 1, 0);
  else if (st.bits == 8)
    product_phase<8, MT, false>(a, st, layer, out, smem, nullptr, 1, 0);
  else
    product_phase<16, MT, false>(a, st, layer, out, smem, nullptr, 1, 0);
}

// `product` in a function of its own, for a kernel with an attention
// phase: its registers are then allocated apart from the attention's,
// which at the 128 registers of a two-block-an-SM kernel otherwise costs
// the products' loops (PERF.md §6).
template <int MT>
__device__ __noinline__ void product_call(const Args& a, int sid, int layer,
                                          float* out, uint8_t* smem) {
  product<MT>(a, sid, layer, out, smem);
}

// A MoE layer's `parts` (one payload format) as one item space over blocks
// `first` on, in a function of its own.
template <int MT>
__device__ __noinline__ void product_parts(const Args& a, int layer,
                                           const Part* parts, int nparts,
                                           int first, uint8_t* smem) {
  const Stream& st = *parts[0].st;
  if (st.bits == 4)
    product_phase<4, MT, true>(a, st, layer, nullptr, smem, parts, nparts,
                               first);
  else if (st.bits == 8)
    product_phase<8, MT, true>(a, st, layer, nullptr, smem, parts, nparts,
                               first);
  else
    product_phase<16, MT, true>(a, st, layer, nullptr, smem, parts, nparts,
                                first);
}

// Lane e of a router product's `ksplit` K-split partials (`src`: the row's
// split 0), summed in split order with eight loads in flight.
__device__ __forceinline__ float split_sum(const float* src, int ksplit,
                                           size_t split_stride, int e) {
  float v = 0.f;
  for (int s = 0; s < ksplit; s += 8) {
    float p[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      p[q] = s + q < ksplit ? __ldcg(src + (size_t)(s + q) * split_stride + e)
                            : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += p[q];
  }
  return v;
}

// The MoE router of one token, run by one warp, from its router product's
// E (+ the shared gate's) lanes in shared memory (`lg`, which it overwrites
// with the softmax; every lane of the warp must see them): softmax over the
// E lanes, k rounds of max choosing the lowest lane on ties, optional
// renormalisation (the TPU kernel's router phase), in loops over the lanes
// (a few hundred instructions on a path each layer runs once). Gives every
// lane the chosen experts in ascending order with their gates, and the
// shared expert's gate: sigmoid of lane E, or 1 without a gate column, or 0
// without a shared expert.
__device__ __forceinline__ void route_top(float* lg, int E, int k, int norm,
                                          int has_shared, int has_sgate,
                                          int (&idx)[kMaxTopk],
                                          float (&w)[kMaxTopk], float& sg) {
  const int lane = threadIdx.x & 31;
  float mx = -FLT_MAX;
  for (int e = lane; e < E; e += 32) mx = fmaxf(mx, lg[e]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int e = lane; e < E; e += 32) sum += expf(lg[e] - mx);
  sum = warp_sum(sum);
  const float sv = warp_sum(lane == (E & 31) && has_sgate ? lg[E] : 0.f);
  for (int e = lane; e < E; e += 32) lg[e] = expf(lg[e] - mx) / sum;
  unsigned taken = 0;
  float tot = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxTopk; ++q) {
    idx[q] = 0x7fffffff;
    w[q] = 0.f;
  }
  for (int q = 0; q < k; ++q) {
    float best = -1.f;
    int bi = 0x7fffffff;
    for (int e = lane, j = 0; e < E; e += 32, ++j)
      if (!((taken >> j) & 1u) && lg[e] > best) {
        best = lg[e];
        bi = e;
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
    idx[q] = bi;
    w[q] = best;
    tot += best;
    if (bi < E && (bi & 31) == lane) taken |= 1u << (bi >> 5);
  }
  if (norm)
    for (int q = 0; q < k; ++q) w[q] /= tot;
  // ascending expert order: the order of the sums that use them
  for (int q = 1; q < k; ++q)
    for (int j = q; j > 0 && idx[j - 1] > idx[j]; --j) {
      const int ti = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = ti;
      const float tw = w[j];
      w[j] = w[j - 1];
      w[j - 1] = tw;
    }
  sg = !has_shared ? 0.f : (has_sgate ? 1.0f / (1.0f + expf(-sv)) : 1.0f);
}

// route_top of one token whose router product is `ksplit` K-split partials
// (`src`: the token's row of split 0), summed a lane by this warp into its
// own kMaxLanes floats of shared memory (`lg`).
__device__ __noinline__ void route_row(const float* src, int ksplit,
                                       size_t split_stride, float* lg, int E,
                                       int k, int norm, int has_shared,
                                       int has_sgate, int (&idx)[kMaxTopk],
                                       float (&w)[kMaxTopk], float& sg) {
  const int lanes = E + has_sgate;
  for (int e = threadIdx.x & 31; e < lanes; e += 32)
    lg[e] = split_sum(src, ksplit, split_stride, e);
  __syncwarp();
  route_top(lg, E, k, norm, has_shared, has_sgate, idx, w, sg);
  __syncwarp();
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
  return mt == 1 ? imax(imax(Ring<4, 1>::kBytes, Ring<8, 1>::kBytes),
                        Ring<16, 1>::kBytes)
                 : imax(imax(Ring<4, 2>::kBytes, Ring<8, 2>::kBytes),
                        Ring<16, 2>::kBytes);
}

}  // namespace di
