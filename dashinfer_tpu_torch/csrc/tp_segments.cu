// Tensor-parallel decode segments, sm_90a: one layer's attention, one
// layer's MLP, and the final norm + lm_head of ONE rank of a model axis,
// each one persistent kernel launch.
//
// Replaces: dashinfer_tpu/ops/pallas/tp_megakernel.py `build_attn_segment`,
// `build_mlp_segment` and `build_lm_segment` (dense models; RoPE, optional
// q/k/v bias, KV pool DEFAULT / INT8 / UINT4, weight streams u4 group-wise,
// int8 group-wise or per-channel, bf16).
//
// What they compute. The decode megakernel's layer body (csrc/megakernel.cu)
// cut at the two points where the ranks' partial sums must be all-reduced:
//   attn  x += add (the reduced down partials of the layer before, none in
//         layer 0); RMSNorm; q|k|v of the rank's heads (a column share, with
//         bias); RoPE; the new token's K/V quantized and written into the
//         rank's pool (its KV heads); attention over the rank's KV heads with
//         the new token folded in from its unquantized f32 K/V; o over the
//         rank's rows of the o weight => the o partial [B, hid] f32;
//   mlp   x += add (the reduced o partials); RMSNorm; gate|up (a column
//         share); SwiGLU; down over the rank's rows => the down partial;
//   lm    x += add; the final RMSNorm; lm_head over the rank's vocab shard
//         => its logits [B, Vp / n] f32 (padded columns included).
// The all-reduces run between the launches (parallel/collectives.py); x,
// the rank's f32 residual, stays on the card and is updated in place. The
// phases are di_layer.cuh's, the products di_product.cuh's, so the rounding
// points are the megakernel's.
//
// What bounds them on the H100: bytes. A rank's launch reads its share of
// one layer's weights once (Qwen2-7B a16w4 at n = 2: ~7.8 MB attn, ~54 MB
// mlp, ~145 MB lm) and its K/V of the active slots; at B <= 64 the dots do
// at most 256 operations a weight byte.
//
// What the design does about it: the products stream the fragment-ordered
// pack with the megakernel's cp.async pipeline, split-K over every block of
// a grid of all co-resident blocks; the phases are separated by the grid
// barrier (attn: resid, norm, q|k|v, attention, merge, o; mlp: resid,
// norm, gate|up, SwiGLU, down; lm: resid, norm), and a last phase sums the
// o / down product's K splits into the partial. The attn segment's bytes
// are few (~2.6 us at the card's rate), so its time is set by the launch
// and its five barriers, not by memory. Its attention phase has B x KH/n x
// stripes items: the stripe count rises to fill the grid (at most 16 a
// (slot, KV head)), so at n = 2 (2 KV heads a rank) the items still cover
// the grid at B = 8, and at n = 4 (1 KV head) half of it; a stripe per
// (slot, KV head) pair is the limit at long contexts, as in the megakernel.

#include "di_layer.cuh"

namespace {

using namespace di;

enum SegKind { kAttnSeg = 0, kMlpSeg = 1, kLmSeg = 2 };

struct Seg {
  const float* add;   // [B, hid] added to x first, or null
  float* out;         // attn / mlp: the partial [B, hid]; lm: logits [B, ldo]
  int layer;
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

template <int MT, int KIND>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
seg_kernel(const __grid_constant__ Args a, const __grid_constant__ Seg g) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* fsmem = reinterpret_cast<float*>(smem);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.launches, 1ull);
  const int l = g.layer;
  const float* w = KIND == kLmSeg
                       ? a.final_norm
                       : a.norms + (size_t)(2 * l + (KIND == kMlpSeg)) * a.hid;
  int phase = 0;
  resid_phase(a, g.add, g.add != nullptr ? 1 : 0, false, w, fsmem);
  grid_barrier(a, phase++);
  norm_phase(a, fsmem);
  grid_barrier(a, phase++);
  if constexpr (KIND == kAttnSeg) {
    product<MT>(a, kQkv, l, a.partial, smem);
    grid_barrier(a, phase++);
    attention(a, l, fsmem);
    grid_barrier(a, phase++);
    merge_phase(a);
    grid_barrier(a, phase++);
    product<MT>(a, kO, l, a.partial, smem);
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
  } else {
    product<MT>(a, kLm, 0, g.out, smem);
  }
}

// Blocks of seg_kernel<MT, KIND> resident at once on one SM (0 on error).
template <int MT, int KIND>
int per_sm(int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      seg_kernel<MT, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, seg_kernel<MT, KIND>, kThreads, smem);
  return e == cudaSuccess ? n : 0;
}

template <int MT>
int per_sm_of(int kind, int smem) {
  return kind == kAttnSeg ? per_sm<MT, kAttnSeg>(smem)
                          : (kind == kMlpSeg ? per_sm<MT, kMlpSeg>(smem)
                                             : per_sm<MT, kLmSeg>(smem));
}

template <int MT, int KIND>
void launch(const Args& a, const Seg& g, int grid, int smem, cudaStream_t s) {
  cudaFuncSetAttribute(seg_kernel<MT, KIND>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  seg_kernel<MT, KIND><<<grid, kThreads, smem, s>>>(a, g);
}

template <int MT>
void launch_of(int kind, const Args& a, const Seg& g, int grid, int smem,
               cudaStream_t s) {
  if (kind == kAttnSeg)
    launch<MT, kAttnSeg>(a, g, grid, smem, s);
  else if (kind == kMlpSeg)
    launch<MT, kMlpSeg>(a, g, grid, smem, s);
  else
    launch<MT, kLmSeg>(a, g, grid, smem, s);
}

}  // namespace

// The largest grid of segment `kind` (0 attn, 1 mlp, 2 lm) whose blocks are
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
// the streams the address of `add` (0: none); `fa` = {rms eps, attention
// scale}. Shapes and types are validated by the caller
// (ops/tp_megakernel.py). Returns cudaGetLastError().
extern "C" int di_tp_segment(int kind, int layer, const long long* ia,
                             const double* fa, void* stream) {
  Args a;
  fill_args(a, ia, fa);
  Seg g;
  g.add = ptr<const float>(ia[I_STREAMS + kStreams * kStreamArgs]);
  g.out = a.logits;
  g.layer = layer;
  if (kind < kAttnSeg || kind > kLmSeg || a.E != 0 || a.skip_attn ||
      a.split_len != kAttUnit || a.nsplit < 1 || a.nsplit > kMaxStripes ||
      layer < 0 || layer >= a.L)
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
