// Tensor-parallel decode segments, sm_90a: one layer's attention, one
// layer's MLP (or MoE MLP), and the final norm + lm_head of ONE rank of a
// model axis, each one persistent kernel launch.
//
// Replaces: dashinfer_tpu/ops/pallas/tp_megakernel.py `build_attn_segment`,
// `build_mlp_segment`, `build_moe_mlp_segment` and `build_lm_segment`
// (RoPE or ALiBi (the rank's slice of the global slopes), optional q/k/v
// bias, optional per-head QK RMSNorm, KV pool DEFAULT
// / INT8 / UINT4, weight streams u4 group-wise, int8 group-wise or
// per-channel, bf16; dense or Qwen1.5/2- and Qwen3-MoE layers).
//
// What they compute. The decode megakernel's layer body (csrc/megakernel.cu)
// cut at the two points where the ranks' partial sums must be all-reduced:
//   attn  x += add (the reduced down partials of the layer before, none in
//         layer 0); RMSNorm; q|k|v of the rank's heads (a column share, with
//         bias); a QK-norm model's RMSNorm of each q and k head; RoPE; the new
//         token's K/V quantized and written into the rank's pool (its KV
//         heads); attention over the rank's KV heads with the new token folded
//         in from its unquantized f32 K/V; o over the rank's rows of the o
//         weight => the o partial [B, hid] f32;
//   mlp   x += add (the reduced o partials); RMSNorm; gate|up (a column
//         share); SwiGLU; down over the rank's rows => the down partial;
//   moe   x += add (the reduced o partials); RMSNorm; the router product
//         over the GLOBAL router (every rank computes all E lanes and the
//         shared expert's gate lane, so every rank routes alike); the gates
//         (softmax over all E experts, top-k, renormalisation, the shared
//         gate's sigmoid), recorded; the experts of the rank's group
//         [e0, e0 + E/n) that some active row routes to, renumbered to the
//         rank's stack; their gate|up and the rank's slice of the shared
//         expert; SwiGLU; down => the moe partial [B, hid] f32: per row its
//         experts of the group times their gates (ascending), then the
//         shared slice times its gate. The TPU kernel streams every expert
//         of the group and multiplies the unrouted ones by 0: the same
//         function;
//   lm    x += add; the final RMSNorm; lm_head over the rank's vocab shard
//         => its logits [B, Vp / n] f32 (padded columns included).
// The all-reduces run between the launches (parallel/collectives.py); x,
// the rank's f32 residual, stays on the card and is updated in place. The
// phases are di_layer.cuh's and di_moe_layer.cuh's, the products
// di_product.cuh's, so the rounding points are the megakernel's.
//
// What bounds them on the H100: bytes. A rank's launch reads its share of
// one layer's weights once (Qwen2-7B a16w4 at n = 2: ~7.8 MB attn, ~54 MB
// mlp, ~145 MB lm; Qwen1.5-MoE at n = 2: the global router 0.5 MB, the
// routed experts of the rank's 30, ~4.9 MB each (4.3 MB of u4 payload and
// its qparams), and 9.7 MB of shared slice) and its K/V of the active
// slots; at B <= 64 the dots do at most
// 256 operations a weight byte.
//
// What the design does about it: the products stream the fragment-ordered
// pack through the megakernel's bulk-copy ring (weights as the mma's A
// operand, di_product.cuh), split-K over every block of a grid of all
// co-resident blocks; the phases are separated by the grid barrier (attn:
// resid, norm, q|k|v, attention, o; mlp: resid, norm, gate|up, SwiGLU,
// down; moe: resid, norm, router, gates, gate|up, SwiGLU, down; lm: resid,
// norm), and a last phase sums the down product's K splits into the
// partial (moe: with the gates). The attn segment sums its q|k|v
// product's K splits in its epilogue (the block that finishes a tile's
// last split, by a ticket a tile: q|k|v + bias into the attention's input)
// and merges the attention chunks of a (slot, KV head) in the attention
// phase (the last chunk item to finish, by a ticket a pair): five grid
// barriers. (o's splits summed in its epilogue too, one block a tile, took
// longer than the sum phase over every block with its barrier, PERF.md.) The moe segment reads only the routed
// experts of its group, as the megakernel's MoE branch does, and builds
// their list on the card (no host sync: the forward stays one CUDA graph).
// Its phases: resid, norm, the router product, the gates with the shared
// slice's gate|up beside them (it needs only the norm; the gates take B
// blocks), the routed experts' gate|up with the K split read from the
// plan's split table at the routed count the gates left (so 12 routed
// experts of 30 fill the grid as 30 would), SwiGLU, and the routed
// experts' downs with the shared slice's as one item space, then the sum.
// The attn segment's bytes are few (~2.6 us at the card's rate), so its
// time is set by the launch and its five barriers, not by memory. Its
// attention phase is the megakernel's page-tiled one (di_attn_tile.cuh):
// B x KH/n x chunks items, the chunk count from static shapes (at most 16
// a (slot, KV head), each a whole number of 128-token tiles).

#include "di_moe_layer.cuh"

namespace {

using namespace di;

enum SegKind { kAttnSeg = 0, kMlpSeg = 1, kLmSeg = 2, kMoeSeg = 3 };

struct Seg {
  const float* add;   // [B, hid] added to x first, or null
  float* out;         // attn / mlp / moe: the partial [B, hid]; lm: logits
                      // [B, ldo]
  int layer;
  int e0, ne;         // moe: the rank's experts are global e0 .. e0 + ne - 1
};

// out[m][i] = the sum of a product's K-split partials (a partial row is
// st.ldo wide; the first hid columns are the product's).
__device__ void sum_splits(const Args& a, const Stream& st, float* out) {
  const int n = a.B * a.hid;
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += gridDim.x * kThreads) {
    const int m = idx / a.hid, i = idx - m * a.hid;
    float v = 0.f;
    for (int s = 0; s < st.ksplit; ++s)
      v += __ldcg(a.partial + ((size_t)s * a.B + m) * st.ldo + i);
    out[idx] = v;
  }
}

// The rank's experts that some active row routes to (its group of the
// layer's routing record, renumbered from e0), ascending, into `list`
// (shared memory; every block builds the same list). Returns their count.
__device__ __noinline__ int group_routed_experts(const Args& a, int layer,
                                                 int e0, int ne, int* list,
                                                 unsigned* flags,
                                                 int* count) {
  const int* topk = a.topk_e + (size_t)layer * a.B * kMaxTopk;
  for (int i = threadIdx.x; i < kMaxLanes / 32; i += kThreads) flags[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < a.B * a.k_top; i += kThreads) {
    const int b = i / a.k_top;
    const int e = __ldcg(topk + b * kMaxTopk + i % a.k_top) - e0;
    if (a.active[b] && e >= 0 && e < ne)
      atomicOr(flags + (e >> 5), 1u << (e & 31));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < kMaxLanes / 32; ++w)
      for (unsigned bits = flags[w]; bits != 0; bits &= bits - 1)
        list[n++] = w * 32 + __ffs(bits) - 1;
    *count = n;
  }
  __syncthreads();
  return *count;
}

// The moe partial: out[m][i] = the sum over row m's routed experts of the
// group (ascending global ids, an inactive row's none) of gate x the down
// product's K splits, then the shared slice's K splits (in `a.partial`,
// rows hid wide) times the shared gate, as moe_resid_phase adds them; `sp`:
// the step's split table entry.
__device__ void moe_out_phase(const Args& a, const Seg& g, const int* sp) {
  const size_t route = (size_t)g.layer * a.B;
  const Stream& edn = a.st[kDn];
  const size_t edn_gs = (size_t)edn.ksplit * a.B * a.hid;
  const int eks = sp[kDnKs];
  const int ssplit = a.has_shared ? sp[kSdnKs] : 0;
  const int n = a.B * a.hid;
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < n;
       idx += gridDim.x * kThreads) {
    const int m = idx / a.hid, i = idx - m * a.hid;
    float acc = 0.f;
    if (a.active[m]) {
      for (int j = 0; j < a.k_top; ++j) {
        const int e = __ldcg(a.topk_e + (route + m) * kMaxTopk + j) - g.e0;
        if (e < 0 || e >= g.ne) continue;
        const float gw = __ldcg(a.topk_w + (route + m) * kMaxTopk + j);
        const float* p = a.epart + (size_t)e * edn_gs + (size_t)m * a.hid + i;
        float y = 0.f;
        for (int s = 0; s < eks; ++s)
          y += __ldcg(p + (size_t)s * a.B * a.hid);
        acc += gw * y;
      }
    }
    if (a.has_shared) {
      float y = 0.f;
      for (int s = 0; s < ssplit; ++s)
        y += __ldcg(a.partial + ((size_t)s * a.B + m) * a.hid + i);
      acc += __ldcg(a.sgate + route + m) * y;
    }
    g.out[idx] = acc;
  }
}

// ALIBI: the attn segment of an ALiBi model (a.slopes), an instantiation of
// its own, so that the RoPE model's code is unchanged.
template <int MT, int KIND, bool ALIBI = false>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
seg_kernel(const __grid_constant__ Args a, const __grid_constant__ Seg g) {
  static_assert(!ALIBI || KIND == kAttnSeg, "ALiBi: the attn segment only");
  extern __shared__ __align__(16) uint8_t smem[];
  float* fsmem = reinterpret_cast<float*>(smem);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(a.launches, 1ull);
    if (a.trace != nullptr) a.trace[0] = global_ns();
  }
  const int l = g.layer;
  const float* w = KIND == kLmSeg
                       ? a.final_norm
                       : a.norms + (size_t)(2 * l + (KIND != kAttnSeg)) *
                                       a.hid;
  int phase = 0;
  resid_phase(a, g.add, g.add != nullptr ? 1 : 0, false, w, fsmem);
  grid_barrier(a, phase++);
  norm_phase(a, fsmem);
  grid_barrier(a, phase++);
  if constexpr (KIND == kAttnSeg) {
    product_call<MT>(a, kQkv, l, a.partial, smem);
    qkv_epilogue<MT>(a, a.st[kQkv], a.qkv,
                     a.qkv_b == nullptr
                         ? nullptr
                         : a.qkv_b + (size_t)l * (a.H + 2 * a.KH) * kD,
                     a.partial);
    grid_barrier(a, phase++);
    attention<true, false, ALIBI>(a, l, smem);
    grid_barrier(a, phase++);
    product_call<MT>(a, kO, l, a.partial, smem);
    grid_barrier(a, phase++);
    sum_splits(a, a.st[kO], g.out);
  } else if constexpr (KIND == kMlpSeg) {
    product<MT>(a, kGu, l, a.partial, smem);
    grid_barrier(a, phase++);
    act_phase(a);
    grid_barrier(a, phase++);
    product<MT>(a, kDn, l, a.partial, smem);
    grid_barrier(a, phase++);
    sum_splits(a, a.st[kDn], g.out);
  } else if constexpr (KIND == kMoeSeg) {
    // the rank's routed experts' list, built once in every block
    __shared__ int s_experts[kMaxLanes];
    __shared__ unsigned s_flags[kMaxLanes / 32];
    __shared__ int s_nused;
    product<MT>(a, kRt, l, a.partial, smem);
    grid_barrier(a, phase++);
    moe_gates_phase<MT>(a, l, smem);
    grid_barrier(a, phase++);
    const int nused =
        group_routed_experts(a, l, g.e0, g.ne, s_experts, s_flags, &s_nused);
    const int* sp = moe_splits(a, nused);
    moe_experts_product<MT>(a, kGu, l, s_experts, nused, sp[kGuKs],
                            sp[kGuCps], smem);
    grid_barrier(a, phase++);
    moe_act_phase(a, s_experts, nused, sp[kGuKs], shared_gu_partial(a));
    grid_barrier(a, phase++);
    moe_down_phase<MT>(a, l, s_experts, nused, sp, smem);
    grid_barrier(a, phase++);
    moe_out_phase(a, g, sp);
  } else {
    product<MT>(a, kLm, 0, g.out, smem);
  }
}

// Blocks of seg_kernel<MT, KIND, ALIBI> resident at once on one SM (0 on
// error).
template <int MT, int KIND, bool ALIBI = false>
int per_sm(int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      seg_kernel<MT, KIND, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, seg_kernel<MT, KIND, ALIBI>, kThreads, smem);
  return e == cudaSuccess ? n : 0;
}

// the attn segment's grid: the one both its instantiations (RoPE, ALiBi)
// take
template <int MT>
int per_sm_of(int kind, int smem) {
  switch (kind) {
    case kAttnSeg: {
      const int rope = per_sm<MT, kAttnSeg>(smem);
      const int alibi = per_sm<MT, kAttnSeg, true>(smem);
      return rope < alibi ? rope : alibi;
    }
    case kMlpSeg: return per_sm<MT, kMlpSeg>(smem);
    case kMoeSeg: return per_sm<MT, kMoeSeg>(smem);
    default: return per_sm<MT, kLmSeg>(smem);
  }
}

template <int MT, int KIND, bool ALIBI = false>
void launch(const Args& a, const Seg& g, int grid, int smem, cudaStream_t s) {
  cudaFuncSetAttribute(seg_kernel<MT, KIND, ALIBI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  seg_kernel<MT, KIND, ALIBI><<<grid, kThreads, smem, s>>>(a, g);
}

template <int MT>
void launch_of(int kind, const Args& a, const Seg& g, int grid, int smem,
               cudaStream_t s) {
  switch (kind) {
    case kAttnSeg:
      if (a.slopes != nullptr)
        launch<MT, kAttnSeg, true>(a, g, grid, smem, s);
      else
        launch<MT, kAttnSeg>(a, g, grid, smem, s);
      break;
    case kMlpSeg: launch<MT, kMlpSeg>(a, g, grid, smem, s); break;
    case kMoeSeg: launch<MT, kMoeSeg>(a, g, grid, smem, s); break;
    default: launch<MT, kLmSeg>(a, g, grid, smem, s); break;
  }
}

}  // namespace

// The largest grid of segment `kind` (0 attn, 1 mlp, 2 lm, 3 moe) whose
// blocks are
// all resident at once on `device` for a batch padded to `mpad` rows.
// Returns 0 on error.
extern "C" int di_tp_segment_grid(int device, int mpad, int hid, int kind) {
  const int mt = mpad > 16 ? 2 : 1;
  const int smem = smem_bytes(mt, hid);
  const int n = mt == 1 ? per_sm_of<1>(kind, smem) : per_sm_of<2>(kind, smem);
  int sms = 0;
  if (n == 0 || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (n < 2 ? n : 2);
}

// One segment launch of layer `layer`. `ia` is di_megakernel's (IArg order,
// then the streams) with x at I_RESID, the output at I_LOGITS, and after
// the streams the address of `add` (0: none), then a moe segment's first
// expert and expert count (its E argument is every rank's E, its topk /
// sgate records the rank's); `fa` = {rms eps, attention scale}. Shapes and
// types are validated by the caller (ops/tp_megakernel.py). Returns
// cudaGetLastError().
extern "C" int di_tp_segment(int kind, int layer, const long long* ia,
                             const double* fa, void* stream) {
  Args a;
  fill_args(a, ia, fa);
  Seg g;
  const long long* tail = ia + I_STREAMS + kStreams * kStreamArgs;
  g.add = ptr<const float>(tail[0]);
  g.out = a.logits;
  g.layer = layer;
  g.e0 = (int)tail[1];
  g.ne = (int)tail[2];
  if (kind < kAttnSeg || kind > kMoeSeg || (a.E != 0) != (kind == kMoeSeg) ||
      (a.slopes != nullptr && a.E != 0) ||
      a.skip_attn || a.split_len < kAttTile || a.split_len % kAttTile ||
      a.nsplit < 1 || a.nsplit > kMaxChunks || layer < 0 || layer >= a.L)
    return (int)cudaErrorInvalidValue;
  if (kind == kMoeSeg &&
      (a.E + a.has_sgate > kMaxLanes || a.k_top < 1 || a.k_top > kMaxTopk ||
       a.inter % kChunkK || a.shared_inter % kChunkK || g.e0 < 0 ||
       g.ne < 1 || g.e0 + g.ne > a.E || a.hid % 256 || a.msplit == nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)ia[I_GRID];
  const int mt = a.mpad > 16 ? 2 : 1;
  const int smem = smem_bytes(mt, a.hid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt == 1)
    launch_of<1>(kind, a, g, grid, smem, s);
  else
    launch_of<2>(kind, a, g, grid, smem, s);
  return (int)cudaGetLastError();
}
