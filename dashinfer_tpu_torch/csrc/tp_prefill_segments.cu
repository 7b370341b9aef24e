// Tensor-parallel prefill segments, sm_90a: one layer's prefill attention,
// one layer's prefill MLP, and the final norm + lm_head of the last prompt
// row, of ONE rank of a model axis, each one persistent kernel launch.
//
// Replaces: dashinfer_tpu/ops/pallas/tp_megakernel.py
// `build_prefill_attn_segment`, `build_prefill_mlp_segment` and
// `build_prefill_lm_segment` (dense models; RoPE or ALiBi (the rank's slice
// of the global slopes), optional q/k/v bias,
// optional per-head QK RMSNorm, KV pool DEFAULT / INT8 / UINT4, weight streams
// u4 group-wise, int8 group-wise or per-channel, bf16).
//
// What they compute. The prefill megakernel's layer body
// (csrc/prefill_megakernel.cu) for the S-row bucket of which n rows are the
// prompt, cut at the two points where the ranks' partial sums must be
// all-reduced:
//   attn  x += add (the reduced down partials of the layer before, none in
//         layer 0); RMSNorm of the rows; q|k|v of the rank's heads (a column
//         share, weight-side dequant, with bias); a QK-norm model's RMSNorm
//         of each q and k head; RoPE; K/V of rows < n
//         quantized and written into the rank's pool pages (`page_row + l`);
//         causal attention over the rank's heads; o over the rank's rows of
//         the o weight => the o partial [S, hid] f32;
//   mlp   x += add (the reduced o partials); RMSNorm; gate|up (a column
//         share); SwiGLU; down over the rank's rows => the down partial;
//   lm    x[n - 1] += add[n - 1]; the final RMSNorm of row n - 1; lm_head
//         over the rank's vocab shard => logits [1, V / n] f32 (the true
//         columns only).
// x, the rank's f32 residual [S, hid], stays on the card and is updated in
// place; the all-reduces run between the launches (parallel/collectives.py).
// Rows past the last 128-row tile that holds a prompt row are not computed:
// their partials are written as zeros, so the all-reduced `add` leaves
// those rows of x as they are. The phases are di_prefill_layer.cuh's, so the
// rounding points are the prefill megakernel's.
//
// What bounds them on the H100: operations for attn and mlp at S >= 256
// (Qwen2-7B a16w4 at n = 2, bucket 1024: ~34 GFLOP attn and ~209 GFLOP mlp
// a rank and layer against ~8 and ~57 MB of weights), bytes for lm (one
// row against 153.6 MB of the vocab shard's u4 payload and qparams: 0.046
// ms at 3.35 TB/s, ~25 GB/s from every SM for the whole launch).
//
// What the design does about it: the products run the prefill megakernel's
// wgmma product over 128-row tiles (the weight dequantized once per chunk
// into the register A operand and reused over the tile, x read by the
// tensor cores from the swizzled shared-memory stage), K split so the grid
// is filled, each payload kind inlined at one call site a kernel; the phases
// of a persistent grid (one block an SM) are separated by the grid barrier
// of di_common.cuh; the last phase of attn and mlp sums the o / down
// product's K splits, in a fixed order, into the partial the wrapper
// allocated for this rank, so the ranks that share a card share the
// scratch but not their partials, and a prefill repeats bit for bit. The
// attention items fall with the rank's heads, so they are (query head,
// 64-row half of a query tile), two warp groups of a block sharing a
// half's key tiles (di_prefill_layer.cuh): at bucket 1024 and n = 2, 224
// halves on 132 SMs, where (query head, query tile) items were 112.
// The lm segment has one row (di_prefill_layer.cuh `lm_row`: the decode
// kernels' product at one row): its items are (256-column tile, K split),
// the split chosen by the wrapper from the SMs' loads (297 tiles x 2
// splits at n = 2, at most 5 items an SM, where whole-K items on 132
// blocks left the last of 3 waves a quarter full), streamed through the
// product's bulk-copy ring, and the block that takes a tile's last ticket
// sums its splits in order, so the segment keeps its one grid barrier
// (after the final norm). It needs only that ring, so it runs two blocks
// an SM (kLmSmem): with one row its warps wait on latencies, and twice the
// warps hide more of them (`tools/ab_decode.py --lm-splits` times it on
// both grids at each split).

#include "di_prefill_layer.cuh"

namespace {

using namespace di;

enum SegKind { kAttnSeg = 0, kMlpSeg = 1, kLmSeg = 2 };

struct PSeg {
  const float* add;   // [S, hid] added to x first, or null
  float* out;         // attn / mlp: the partial [S, hid]; lm: logits [V]
  int layer;
};

// x[row] += add[row] (when given); xn[row] = bf16(RMSNorm(x[row]) * w) in
// the x layout, for rows < `rows`. One block a row at a time, as norm_rows.
__device__ void seg_norm_phase(const PArgs& a, const float* add, int rows,
                               const float* w, float* red) {
  const int hid = a.hid, tid = threadIdx.x;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    float* r = a.resid + (size_t)row * hid;
    float ss = 0.f;
    for (int i = tid * 4; i < hid; i += kThreads * 4) {
      float4 v = __ldcg(reinterpret_cast<const float4*>(r + i));
      if (add != nullptr) {
        const float4 p = __ldcg(
            reinterpret_cast<const float4*>(add + (size_t)row * hid + i));
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
        *reinterpret_cast<float4*>(r + i) = v;
      }
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    ss = warp_sum(ss);
    __syncthreads();            // `red` of the row before has been read
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) tot += red[k];
    const float inv = rsqrtf(tot / (float)hid + a.eps);   // as torch.rsqrt
    for (int i = tid * 4; i < hid; i += kThreads * 4) {
      const float4 v = *reinterpret_cast<const float4*>(r + i);
      const float4 wv = *reinterpret_cast<const float4*>(w + i);
      *reinterpret_cast<uint2*>(a.xn + xoff(a.S, row, i)) = make_uint2(
          pack_bf16(v.x * inv * wv.x, v.y * inv * wv.y),
          pack_bf16(v.z * inv * wv.z, v.w * inv * wv.w));
    }
  }
}

// out[row][i] = the product's K splits summed in order (rows < `rows`), 0
// for the rows after them up to S.
__device__ void sum_splits(const PArgs& a, const Stream& st, int rows,
                           float* out) {
  const int hid = a.hid, q = hid / 4;
  const size_t split_stride = (size_t)a.S * st.ntot;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.S * q;
       i += gridDim.x * kThreads) {
    const int row = i / q, c = 4 * (i - row * q);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      for (int s = 0; s < st.ksplit; ++s) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            a.partial + s * split_stride + (size_t)row * st.ldo + c));
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    *reinterpret_cast<float4*>(out + (size_t)row * hid + c) = v;
  }
}

// Row n - 1: x[n - 1] += add[n - 1] (when given), the final norm, bf16 ->
// x_last's records. Block 0 alone (one row), as final_norm_phase.
__device__ void lm_norm_phase(const PArgs& a, const float* add, int n,
                              float* smem) {
  if (blockIdx.x != 0) return;
  const int hid = a.hid, tid = threadIdx.x;
  const size_t roff = (size_t)(n - 1) * hid;
  float* vals = smem;            // [hid]
  float* red = smem + hid;       // [kWarps]
  float ss = 0.f;
  for (int i = tid; i < hid; i += kThreads) {
    float v = __ldcg(a.resid + roff + i);
    if (add != nullptr) {
      v += __ldcg(add + roff + i);
      a.resid[roff + i] = v;
    }
    vals[i] = v;
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  const float inv = rsqrtf(tot / (float)hid + a.eps);
  write_row_records(a, [&](int k) { return vals[k] * inv * a.final_norm[k]; });
}

// ALIBI: the attn segment of an ALiBi model (a.slopes), an instantiation of
// its own, so that the RoPE model's code is unchanged.
// The lm segment needs only the one-row product's ring: two of its blocks
// fit an SM, twice the warps to hide the product's latencies.
template <int KIND, bool ALIBI = false>
__global__ void __launch_bounds__(kThreads, KIND == kLmSeg ? 2 : 1)
pseg_kernel(const __grid_constant__ PArgs a, const __grid_constant__ PSeg g) {
  static_assert(!ALIBI || KIND == kAttnSeg, "ALiBi: the attn segment only");
  extern __shared__ __align__(16) uint8_t smem[];
  float* fsmem = reinterpret_cast<float*>(smem);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(a.launches, 1ull);
    if (a.trace != nullptr) a.trace[0] = global_ns();
  }
  const int n = min(max(*a.n_tokens, 1), a.S);
  const int mtiles = (n + kMTile - 1) / kMTile;
  const int rows = mtiles * kMTile;
  const int l = g.layer, hid = a.hid, S = a.S;
  int phase = 0;
  auto barrier = [&]() {
    grid_barrier(a.barrier, a.status, a.trace, phase++);
  };
  if constexpr (KIND == kLmSeg) {
    lm_norm_phase(a, g.add, n, fsmem);
    barrier();
    lm_row(a, g.out, smem);
  } else {
    // norm, product, rope + KV, attention, product, the splits' sum (attn)
    // or norm, product, SwiGLU, product, the splits' sum (mlp); the
    // products run at the one call below
    for (int ph = 0; ph < 5; ++ph) {
      const int sid = KIND == kAttnSeg ? (ph == 1 ? kQkv : kO)
                                       : (ph == 1 ? kGu : kDn);
      if (ph == 0) {
        seg_norm_phase(a, g.add, rows,
                       a.norms + (size_t)(2 * l + (KIND == kMlpSeg)) * hid,
                       fsmem);
      } else if (ph == 1 || ph == 3) {
        const __nv_bfloat16* X =
            ph == 1 ? a.xn : (KIND == kAttnSeg ? a.attn : a.act);
        product<false>(a, sid, false, l, X, a.partial,
                       (size_t)S * a.st[sid].ntot, mtiles, rows, smem);
      } else if (ph == 2) {
        if constexpr (KIND == kAttnSeg) {
          rope_kv<ALIBI>(a, l, rows, n);
          barrier();
          attention_phase<ALIBI>(a, mtiles, smem);
        } else {
          act_phase(a, a.st[kGu], a.inter, rows);
        }
      } else {
        sum_splits(a, a.st[sid], rows, g.out);
        // a traced launch stamps the sum's end (PREFILL_MLP_SEG_PHASES)
        if (a.trace != nullptr) barrier();
        break;
      }
      barrier();
    }
  }
}

template <int KIND, bool ALIBI = false>
int per_sm(int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      pseg_kernel<KIND, ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, pseg_kernel<KIND, ALIBI>, kThreads, smem);
  return e == cudaSuccess ? n : 0;
}

template <int KIND, bool ALIBI = false>
void launch(const PArgs& a, const PSeg& g, int grid, int smem,
            cudaStream_t s) {
  cudaFuncSetAttribute(pseg_kernel<KIND, ALIBI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  pseg_kernel<KIND, ALIBI><<<grid, kThreads, smem, s>>>(a, g);
}

}  // namespace

// The largest grid of segment `kind` (0 attn, 1 mlp, 2 lm) whose blocks are
// all resident at once on `device`: SMs x (at most one; the lm segment at
// most two) blocks per SM (the attn segment: of both its instantiations,
// RoPE and ALiBi). Returns 0 on error.
extern "C" int di_tp_prefill_segment_grid(int device, int kind) {
  const int smem = pmk_smem_bytes();
  const int attn = per_sm<kAttnSeg>(smem),
            attn_alibi = per_sm<kAttnSeg, true>(smem);
  const int n = kind == kAttnSeg
                    ? (attn < attn_alibi ? attn : attn_alibi)
                    : (kind == kMlpSeg ? per_sm<kMlpSeg>(smem)
                                       : per_sm<kLmSeg>(kLmSmem));
  const int cap = kind == kLmSeg ? 2 : 1;
  int sms = 0;
  if (n == 0 || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (n < cap ? n : cap);
}

// One segment launch of layer `layer`. `ia` is di_prefill_megakernel's (the
// IArg order, then the streams) with x at I_RESID, then the address of
// `add` (0: none) and of the output; `fa` = {rms eps, attention scale}.
// Shapes and types are validated by the caller (ops/tp_megakernel.py).
// Returns cudaGetLastError().
extern "C" int di_tp_prefill_segment(int kind, int layer, const long long* ia,
                                     const double* fa, void* stream) {
  PArgs a;
  fill_pargs(a, ia, fa);
  PSeg g;
  g.add = ptr<const float>(ia[I_STREAMS + kStreams * kStreamArgs]);
  g.out = ptr<float>(ia[I_STREAMS + kStreams * kStreamArgs + 1]);
  g.layer = layer;
  if (kind < kAttnSeg || kind > kLmSeg || a.E != 0 || a.S % kMTile != 0 ||
      a.S <= 0 || a.hid % 128 != 0 || a.inter % 4 != 0 || layer < 0 ||
      layer >= a.L || g.out == nullptr ||
      (a.hid + kWarps) * 4 > (kind == kLmSeg ? kLmSmem : pmk_smem_bytes()) ||
      !lm_row_args_ok(a))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)ia[I_GRID];
  const int smem = pmk_smem_bytes();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kAttnSeg && a.slopes != nullptr)
    launch<kAttnSeg, true>(a, g, grid, smem, s);
  else if (kind == kAttnSeg)
    launch<kAttnSeg>(a, g, grid, smem, s);
  else if (kind == kMlpSeg)
    launch<kMlpSeg>(a, g, grid, smem, s);
  else
    launch<kLmSeg>(a, g, grid, kLmSmem, s);
  return (int)cudaGetLastError();
}
