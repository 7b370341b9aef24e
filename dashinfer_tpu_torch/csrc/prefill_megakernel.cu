// Whole-model prefill of one prompt bucket as ONE persistent kernel, sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/prefill_megakernel.py
// `build_prefill_megakernel` (RoPE, optional q/k/v bias, KV pool DEFAULT /
// INT8 / UINT4, weight streams u4 group-wise, int8 group-wise or
// per-channel, bf16; a dense MLP or the MoE branch). It reads the DECODE
// pack (ops/megakernel.py
// `pack_params`: fragment-ordered 64-row x 256-column chunks), so prefill
// and decode share one weight set on the card.
//
// What it computes, for the S-row bucket of which n rows are a prompt, per
// layer: RMSNorm -> x_norm bf16; q|k|v = x_norm @ W with WEIGHT-SIDE dequant
// (w = bf16(f32(level) * s + z), s and z rounded to bf16; for u4 as ONE fused
// bf16 multiply-add of the exact bf16 operands level, s, z, which rounds
// once where the f32 form rounds twice: the same value unless the f32 sum
// is inexact AND lands on a bf16 tie) and f32 sums; bias
// in f32; RoPE from bf16 cos/sin tiles in f32 (not on V); K and V of rows
// < n quantized per token and KV head from the f32 values and written to the
// request's pages; causal softmax attention (two passes over the key tiles:
// row maximum and sum first, then p = exp(s - m) / l rounded to bf16 for the
// PV product, as the TPU kernel rounds it) -> attn_out bf16; o product into
// the f32 residual; RMSNorm; gate|up products; SwiGLU rounded to bf16; down
// product into the residual. Then the final norm of row n - 1 and the
// lm_head for that row. The score product's operands are bf16 q and k (the
// tensor cores'), where the TPU kernel's are f32.
//
// What bounds it on the H100: operations at S >= 256 (about 13 GFLOP a
// prompt row for Qwen2-7B against 3.98 GB of weights: 295 operations a byte
// is passed at ~90 rows), bytes below that.
//
// What this design does about it. Nothing of the TPU kernel's VMEM state
// fits on an SM, so the activations between phases (f32 residual, bf16
// x_norm, the products' f32 results, bf16 q / k / v, attn_out, the bf16
// SwiGLU activation) are global scratch that mostly stays in the 50 MB L2,
// and the phases of the persistent grid (one block an SM, from the occupancy
// query) are separated by the grid barrier of di_common.cuh. A product item
// is (256-column weight tile, K split, 128-row tile of the prompt), row
// tiles innermost, so the blocks that run side by side read the same weight
// chunks and a payload byte comes from device memory once. A block streams
// the item's chunks and its x rows through a 3-stage cp.async ring; each warp
// owns 32 of the tile's columns, dequantizes its share of a chunk in
// registers ONCE and reuses it over the tile's 128 rows with mma.sync
// m16n8k16 (128 mma a warp a chunk; the u4 dequant is ~2 instructions an
// element, none of them a convert: tools/probe_magic_dequant.py). K
// splits (chosen by the wrapper from the grid) keep all SMs busy where a
// product has few tiles (o and down at S = 128); their partial sums are
// added in a fixed order by the phase that reads them, so a launch repeats
// bit for bit. Row tiles wholly beyond n are skipped in every phase; rows
// >= n inside the last tile are computed and never read by a valid row.
// An attention item is (query head, 128-row query tile), a warp 16 rows,
// over 64-key tiles of bf16 K / V staged in shared memory; V's mma operand
// comes from ldmatrix.trans.
//
// MoE layers, as the TPU kernel computes them: every expert over every row
// of the bucket, each row's result scaled by its gate for that expert (0
// where the row is not routed to it) and summed in ascending expert order,
// then the shared expert times its gate. After norm2: the router product
// (bf16, a 256-column stream) and a gates phase (one warp a row,
// `route_row`, dense gates [S][EP]); then the experts in batches of `eb`
// (items over (expert, tile, split, row tile), so a batch fills the grid):
// gate|up of the batch -> SwiGLU into `act` [eb][S][Im] -> down into `edn`,
// whose gated sum into `acc` [S][hid] runs beside the next batch's gate|up;
// then the shared expert (gate|up beside the last batch's sum, SwiGLU,
// down). The next norm adds resid + (acc + shared gate x shared down). This
// runs the E / k-fold of the routed work (at bucket 1024 ~28 against ~4.2
// TFLOP for Qwen1.5-MoE): a first version, right before fast.
//
// Phases of one layer (each followed by the barrier): norm1 -> q|k|v ->
// rope + KV write -> attention -> o -> norm2 -> gate|up -> SwiGLU -> down;
// then final norm -> lm_head. With a trace buffer, block 0 writes a
// timestamp where it ends each phase and where it leaves each barrier
// (ops/prefill_megakernel.py `phase_times`).

#include "di_prefill_layer.cuh"

namespace {

using namespace di;

// Experts e0 .. e0 + ngroups - 1 of a MoE stream.
template <int MT>
__device__ __noinline__ void gemm_experts(const Stream& st, int layer,
                                          const __nv_bfloat16* A, int lda,
                                          int mtiles, float* out,
                                          size_t split_stride, int store_rows,
                                          uint8_t* smem, int e0, int ngroups,
                                          size_t a_gs, size_t out_gs) {
  if (st.bits == 4)
    gemm_phase<4, MT, true>(st, layer, A, lda, mtiles, out, split_stride,
                            st.ldo, store_rows, smem, e0, ngroups, a_gs,
                            out_gs);
  else if (st.bits == 8)
    gemm_phase<8, MT, true>(st, layer, A, lda, mtiles, out, split_stride,
                            st.ldo, store_rows, smem, e0, ngroups, a_gs,
                            out_gs);
  else
    gemm_phase<16, MT, true>(st, layer, A, lda, mtiles, out, split_stride,
                             st.ldo, store_rows, smem, e0, ngroups, a_gs,
                             out_gs);
}

// norm_phase of a MoE layer's residual: + acc + the shared expert's output.
__device__ __noinline__ void moe_norm_phase(const PArgs& a, int rows,
                                            int ksplit, size_t split_stride,
                                            int moe_layer, const float* w,
                                            float* red) {
  norm_rows<true>(a, rows, ksplit, split_stride, false, moe_layer, w, red);
}

// MoE router: one warp a row, from the router product's K splits -> dense
// gates [layer][row][EP] (0 where not routed), the shared gate; acc[row] = 0.
// Each layer's gates stay in the scratch until the launch ends.
__device__ __noinline__ void gates_phase(const PArgs& a, int rows,
                                         int layer) {
  float* gates = a.gates + (size_t)layer * a.S * a.EP;
  const Stream& st = a.st[kRt];
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  for (int row = gw; row < rows; row += nw) {
    int idx[kMaxTopk];
    float w[kMaxTopk], sg;
    route_row(a.partial + (size_t)row * st.ldo, st.ksplit,
              (size_t)a.S * st.ldo, a.E, a.k_top, a.norm_topk, a.has_shared,
              a.has_sgate, idx, w, sg);
    for (int e = lane; e < a.EP; e += 32) {
      float v = 0.f;
      for (int j = 0; j < a.k_top; ++j)
        if (idx[j] == e) v = w[j];
      gates[(size_t)row * a.EP + e] = v;
    }
    if (lane == 0) a.sgate[(size_t)layer * a.S + row] = sg;
    for (int i = lane * 4; i < a.hid; i += 128)
      *reinterpret_cast<float4*>(a.acc + (size_t)row * a.hid + i) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[row] += sum over experts e0 .. e0 + nb - 1 (ascending) of
// gates[row][e] x the K splits of e's down product (group e - e0 of edn).
__device__ __noinline__ void expert_sum_phase(const PArgs& a, int layer,
                                              int e0, int nb, int rows) {
  const float* gates = a.gates + (size_t)layer * a.S * a.EP;
  const Stream& st = a.st[kDn];
  const int hid = a.hid, q = hid / 4;
  const size_t split_stride = (size_t)a.S * hid;
  const size_t gs = (size_t)st.ksplit * split_stride;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < rows * q;
       i += gridDim.x * kThreads) {
    const int row = i / q, c = 4 * (i - row * q);
    float* ap = a.acc + (size_t)row * hid + c;
    float4 acc = __ldcg(reinterpret_cast<const float4*>(ap));
    for (int g = 0; g < nb; ++g) {
      const float w = __ldcg(gates + (size_t)row * a.EP + e0 + g);
      if (w == 0.f) continue;       // not routed: it adds 0
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < st.ksplit; ++s) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            a.edn + g * gs + s * split_stride + (size_t)row * hid + c));
        y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
      }
      acc.x += w * y.x; acc.y += w * y.y; acc.z += w * y.z; acc.w += w * y.w;
    }
    *reinterpret_cast<float4*>(ap) = acc;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pmk_kernel(const __grid_constant__ PArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(a.launches, 1ull);
    if (a.trace != nullptr) a.trace[0] = global_ns();
  }
  const int n = min(max(*a.n_tokens, 1), a.S);
  const int mtiles = (n + kMTile - 1) / kMTile;
  const int rows = mtiles * kMTile;
  const int hid = a.hid, S = a.S;
  const int HD = a.H * kD;
  const bool moe = a.E > 0;
  // the down product's splits the next norm adds (a MoE layer: its shared
  // expert's, beside acc)
  const int mlp_ks = moe ? (a.has_shared ? a.st[kSdn].ksplit : 0)
                         : a.st[kDn].ksplit;
  int phase = 0;
  auto barrier = [&]() {
    grid_barrier(a.barrier, a.status, a.trace, phase++);
  };
  for (int l = 0; l < a.L; ++l) {
    if (moe && l > 0)
      moe_norm_phase(a, rows, mlp_ks, (size_t)S * hid, l - 1,
                     a.norms + (size_t)(2 * l) * hid,
                     reinterpret_cast<float*>(smem));
    else
      norm_phase(a, rows, mlp_ks, (size_t)S * hid, l == 0,
                 a.norms + (size_t)(2 * l) * hid,
                 reinterpret_cast<float*>(smem));
    barrier();
    gemm<kMTile / 16>(a.st[kQkv], l, a.xn, hid, mtiles, a.partial,
                      (size_t)S * a.st[kQkv].ntot, rows, smem);
    barrier();
    rope_kv(a, l, rows, n);
    barrier();
    attention_phase(a, mtiles, smem);
    barrier();
    gemm<kMTile / 16>(a.st[kO], l, a.attn, HD, mtiles, a.partial,
                      (size_t)S * hid, rows, smem);
    barrier();
    norm_phase(a, rows, a.st[kO].ksplit, (size_t)S * hid, false,
               a.norms + (size_t)(2 * l + 1) * hid,
               reinterpret_cast<float*>(smem));
    barrier();
    const Stream& gu = a.st[kGu];
    const Stream& dn = a.st[kDn];
    if (!moe) {
      gemm<kMTile / 16>(gu, l, a.xn, hid, mtiles, a.partial,
                        (size_t)S * gu.ntot, rows, smem);
      barrier();
      act_phase<false>(a, gu, a.partial, 0, a.inter, 1, rows);
      barrier();
      gemm<kMTile / 16>(dn, l, a.act, a.inter, mtiles, a.partial,
                        (size_t)S * hid, rows, smem);
      barrier();
      continue;
    }
    gemm<kMTile / 16>(a.st[kRt], l, a.xn, hid, mtiles, a.partial,
                      (size_t)S * a.st[kRt].ntot, rows, smem);
    barrier();
    gates_phase(a, rows, l);
    barrier();
    const size_t gu_gs = (size_t)gu.ksplit * S * gu.ntot;
    int e0 = 0;
    for (; e0 < a.E; e0 += a.eb) {
      const int nb = min(a.eb, a.E - e0);
      if (e0 > 0) expert_sum_phase(a, l, e0 - a.eb, a.eb, rows);
      gemm_experts<kMTile / 16>(gu, l, a.xn, hid, mtiles, a.partial,
                                (size_t)S * gu.ntot, rows, smem, e0, nb, 0,
                                gu_gs);
      barrier();
      act_phase<true>(a, gu, a.partial, gu_gs, a.inter, nb, rows);
      barrier();
      gemm_experts<kMTile / 16>(dn, l, a.act, a.inter, mtiles, a.edn,
                                (size_t)S * hid, rows, smem, e0, nb,
                                (size_t)S * a.inter,
                                (size_t)dn.ksplit * S * hid);
      barrier();
    }
    e0 -= a.eb;
    expert_sum_phase(a, l, e0, a.E - e0, rows);
    if (a.has_shared) {
      const Stream& sgu = a.st[kSgu];
      gemm<kMTile / 16>(sgu, l, a.xn, hid, mtiles, a.partial,
                        (size_t)S * sgu.ntot, rows, smem);
      barrier();
      act_phase<false>(a, sgu, a.partial, 0, a.shared_inter, 1, rows);
      barrier();
      gemm<kMTile / 16>(a.st[kSdn], l, a.act, a.shared_inter, mtiles,
                        a.partial, (size_t)S * hid, rows, smem);
    }
    barrier();
  }
  final_norm_phase(a, n, mlp_ks, moe, reinterpret_cast<float*>(smem));
  barrier();
  gemm<1>(a.st[kLm], 0, a.x_last, hid, 1, a.logits, 0, 1, smem);
  barrier();   // so that a trace shows the lm_head's end
}

}  // namespace

// The largest grid whose blocks are all resident at once on `device`: SMs x
// (at most one) block per SM of the kernel with its dynamic shared memory.
// Returns 0 on error.
extern "C" int di_prefill_megakernel_grid(int device) {
  const int smem = pmk_smem_bytes();
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      pmk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pmk_kernel,
                                                      kThreads, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (per_sm < 1 ? per_sm : 1);
}

// One prefill. `ia` holds pointers and integers by the IArg index, `fa` =
// {rms eps, attention scale}. Shapes and types are validated by the caller
// (ops/prefill_megakernel.py). Returns cudaGetLastError().
extern "C" int di_prefill_megakernel(const long long* ia, const double* fa,
                                     void* stream) {
  PArgs a;
  fill_pargs(a, ia, fa);
  if (a.S % kMTile != 0 || a.S <= 0 || a.hid % 128 != 0 ||
      a.inter % 4 != 0 ||
      (a.hid + kWarps) * 4 > pmk_smem_bytes())
    return (int)cudaErrorInvalidValue;
  if (a.E > 0 && (a.E + a.has_sgate > a.EP || a.EP > kMaxLanes ||
                  a.k_top < 1 || a.k_top > kMaxTopk || a.eb < 1 ||
                  a.shared_inter % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)ia[I_GRID];
  const int smem = pmk_smem_bytes();
  cudaFuncSetAttribute(pmk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  pmk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
