// Whole-model decode step as ONE persistent kernel, sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/megakernel.py `build_decode_megakernel`
// (RoPE or ALiBi, optional q/k/v bias, optional per-head QK RMSNorm (Qwen3),
// KV pool DEFAULT / INT8 / UINT4, weight streams u4 group-wise, int8
// group-wise or per-channel, bf16; a dense MLP or the MoE branch: router,
// routed experts, shared expert).
//
// What it computes, per layer: RMSNorm; q|k|v products + bias; a QK-norm
// model's RMSNorm of each q head and k in f32 (a.qk_norm, a null pointer
// without: a runtime branch, not an instantiation); RoPE with
// bf16 cos/sin tiles (an ALiBi model, a.slopes: none; each cached token's
// score gains slope * (t - lens[b]): `mk_kernel<MT, false, false, true>`,
// launched for a non-null slopes pointer, so that a RoPE model's code is
// unchanged); the new token's K/V quantized and written to its page
// (active slots only); attention over the slot's cached tokens (online
// softmax; a quantized pool's tokens are dequantized in f32 as they are
// read) with the new token folded in from its unquantized f32 K/V; o product into the f32 residual; RMSNorm;
// gate/up products, SwiGLU, down product into the residual. Then the final
// norm and the lm_head. x_norm, q, attn_out and the SwiGLU activation are
// rounded to bf16 where the TPU kernel rounds them; dots run on bf16
// operands with f32 accumulation and the group affine after the dot.
//
// What bounds it on the H100: bytes. One step reads every weight once
// (Qwen2-7B a16w4: ~3.98 GB, ~1.19 ms at 3.35 TB/s) plus the cached K/V of
// the active slots; at B <= 64 the dots do at most 256 operations per
// weight byte.
//
// What this design does about it. The per-op path spends most of its step
// in ~225 kernel boundaries, x prologues, split-K reduce kernels, casts and
// small elementwise kernels. Here every block is alive for the whole step
// (grid = SMs x co-resident blocks, from the occupancy query: two blocks
// of 8 warps an SM at mpad 16, one at mpad 32) and phases are separated by
// a grid-wide barrier in global memory (arrive counter with a flip bit,
// release/acquire fences). Activations between phases live in small global
// scratch buffers that stay in L2:
//   records  the next product's x operand, per 64-row K chunk, as ready-made
//            mma fragments plus f32 row sums (csrc/di_product.cuh), written
//            by the producing phase (no prologue launch);
//   partial  each product's split-K partial sums [ksplit][B][N] f32, summed
//            in a fixed order by the consuming phase (no float atomics:
//            a step repeats bit for bit; the attention items sum the
//            q|k|v product's, with its bias, while their first K/V tiles
//            are in flight: in this kernel that costs less than the TP
//            attn segment's epilogue sum, PERF.md).
// A product phase walks work items (256-column tile, K split) round-robin
// over the blocks; a block's items form ONE flat chunk sequence through a
// ring of shared-memory stages (6 deep for u4) filled by 1-D bulk copies
// (TMA): one lane issues a chunk's payload, its x record rows and row sums,
// and where a quant group ends the tile's scale and zero rows, onto the
// stage's mbarrier; the warps wait on it and free the stage on a second
// one, the issuing dealt round the warps. No thread spends instructions on
// copies, no block-wide barrier a chunk, no global load in the chunk loop.
// The dot is the m16n8k16 mma with the WEIGHTS as the A operand (the pack's
// payload registers of a warp's 16 columns are exactly A fragments; a u4
// level n enters as bf16(128 + n), the 128 * sum(x) comes back off in the
// group affine) and x as B (n8 tiles of batch rows from the records): at B
// <= 8 one n8 tile, half the mmas x on the m16 side would take (half of each
// m16 tile padding). Attention is the per-op kernel's page-tiled design
// (csrc/di_attn_tile.cuh): items are (slot, KV head, chunk of 128-token
// tiles), as many chunks as give about two items a block; a tile's K, V and
// qparams come through a cp.async ring, the scores of the G query heads and
// P.V (transposed, P in three bf16 parts, a natural-exponential softmax,
// short accumulation chains: as close to an f32 softmax as the plain
// version's) run on mma.sync; chunk 0 also quantizes and writes the new
// token and folds it in from its unquantized f32 K/V; pages at or past lens
// are never read; the last chunk item of a (slot, KV head) to finish (a
// ticket a pair) merges the pair's chunks into the o product's x records.
// The MoE gates take one block a row. Each product runs in a function of
// its own (`product_call`): at the 128 registers of the two-block-an-SM
// kernel, its loop otherwise shared the attention's register allocation
// and spills (a step ~10% slower at B = 8, PERF.md §6).
// What still bounds it: the products' dequant-and-mma chain and its
// overlap with the ring (u4 at B = 8 about half the card's copy rate in
// tools/bench_stream.py's probe), the attention items' fixed chain (the
// q|k|v split sums, RoPE, the new token), and the 10 grid barriers a
// layer with the short,
// latency-bound phases between them (residual, norm, SwiGLU: a few us
// each).
//
// Phases of one layer (each followed by the barrier): resid1 -> norm1 ->
// q|k|v -> attention (+ the merge) -> o -> resid2 ->
// norm2 -> gate|up -> SwiGLU -> down; then resid -> final norm -> lm_head.
// Ten barriers a layer.
//
// MoE layers (Qwen1.5/2-MoE): after norm2 the router product (bf16 weights
// as a 256-column stream) and a gates phase (one block a row sums the
// router's K splits; one warp then takes the softmax over the E lanes, the
// top-k and the shared expert's sigmoid gate: `route_top`), then
// gate|up, SwiGLU and down each as ONE phase over all routed experts and
// the shared expert (the experts' K splits static, the shared expert's
// products after the experts' in each block: the TP moe segment's schedule
// measured slower here at B = 8), 12 barriers a layer. The TPU kernel
// streams every expert each step and multiplies the unrouted ones by 0;
// here each block lists the experts that some active row routes to (from
// the gates phase's top-k, in ascending order) and the products' items run
// over those alone, which computes the same function and reads ~25 of 60
// experts at B = 8.
// The next resid phase adds, per row, its experts' down products times their
// gates in ascending expert order, then the shared expert's times its gate.
// LoRA (`mk_kernel<MT, false, true>`, a launch whose rows carry adapters;
// replaces the TPU kernel's LoRA epilogue, `lora_nr > 0`): the adapters'
// rank projections run in the phase of the product that reads the same x
// records, after it (the slots some active row uses, their K chunks dealt
// from the last block backwards), and the deltas are added where the
// product's K splits are summed: q|k|v by the attention items (before the
// bias), gate and up by the SwiGLU phase, o and down by the next residual
// phase; the same ten barriers a layer (di_layer.cuh). What bounds it: the
// dense step's bytes plus the used slots' A and B, read once each by the
// projections but B again by every item that adds a delta.
// With a trace buffer, block
// 0 writes a timestamp where it ends each phase and where it leaves each
// barrier (ops/megakernel.py `phase_times`). The dense layer phases live in
// di_layer.cuh, the MoE ones in di_moe_layer.cuh, which the tensor-parallel
// segments (tp_segments.cu) share.

#include "di_moe_layer.cuh"

namespace {

using namespace di;

// MOE: the MoE model's kernel. The dense kernel is compiled without any of
// the MoE code, so that it adds nothing to the dense products' registers.
// LORA: the dense kernel with the LoRA branch (di_layer.cuh): a launch
// without adapters runs the dense instantiation, the parent's machine code.
// ALIBI: the dense kernel of an ALiBi model (a.slopes; no LoRA branch: its
// LoRA batches decode per-op), so that the RoPE model's code is unchanged.
template <int MT, bool MOE, bool LORA, bool ALIBI = false>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
mk_kernel(const __grid_constant__ Args a) {
  static_assert(!(MOE && LORA), "a MoE model decodes LoRA batches per-op");
  static_assert(!(ALIBI && (MOE || LORA)), "ALiBi: the dense kernel only");
  extern __shared__ __align__(16) uint8_t smem[];
  float* fsmem = reinterpret_cast<float*>(smem);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(a.launches, 1ull);
    if (a.trace != nullptr) a.trace[0] = global_ns();
  }
  const int hid = a.hid;
  // the partial sums the next resid phase adds: the down product's, or a
  // MoE layer's shared expert's (beside its experts')
  const int mlp_ksplit = MOE ? (a.has_shared ? a.st[kSdn].ksplit : 0)
                             : a.st[kDn].ksplit;
  int phase = 0;
  for (int l = 0; l < a.L; ++l) {
    if (MOE && l > 0)
      moe_resid_phase(a, a.partial, mlp_ksplit, a.st[kDn].ksplit, l - 1,
                      a.norms + (size_t)(2 * l) * hid, fsmem);
    else    // LORA: with the down delta of the layer before
      resid_phase<LORA>(a, a.partial, mlp_ksplit, l == 0,
                        a.norms + (size_t)(2 * l) * hid, fsmem,
                        l > 0 ? kLd : -1, l - 1);
    grid_barrier(a, phase++);
    norm_phase(a, fsmem);
    grid_barrier(a, phase++);
    product_call<MT>(a, kQkv, l, a.partial, smem);
    if constexpr (LORA) lora_project(a, l, kLq, 3);
    grid_barrier(a, phase++);
    if (!a.skip_attn) attention<false, LORA, ALIBI>(a, l, smem);
    grid_barrier(a, phase++);
    product_call<MT>(a, kO, l, a.partial, smem);
    if constexpr (LORA) lora_project(a, l, kLo, 1);
    grid_barrier(a, phase++);
    resid_phase<LORA>(a, a.partial, a.st[kO].ksplit, false,
                      a.norms + (size_t)(2 * l + 1) * hid, fsmem, kLo, l);
    grid_barrier(a, phase++);
    norm_phase(a, fsmem);
    grid_barrier(a, phase++);
    if constexpr (!MOE) {
      product_call<MT>(a, kGu, l, a.partial, smem);
      if constexpr (LORA) lora_project(a, l, kLg, 2);
      grid_barrier(a, phase++);
      act_phase<LORA>(a, l, fsmem);
      grid_barrier(a, phase++);
      product_call<MT>(a, kDn, l, a.partial, smem);
      if constexpr (LORA) lora_project(a, l, kLd, 1);
      grid_barrier(a, phase++);
    } else {
      // the routed experts' list, built once a layer in every block
      __shared__ int s_experts[kMaxLanes];
      __shared__ unsigned s_flags[kMaxLanes / 32];
      __shared__ int s_nused;
      product_call<MT>(a, kRt, l, a.partial, smem);
      grid_barrier(a, phase++);
      gates_phase(a, l, fsmem);
      grid_barrier(a, phase++);
      const int nused = routed_experts(a, l, s_experts, s_flags, &s_nused);
      const Stream& eg = a.st[kGu];
      const Stream& ed = a.st[kDn];
      moe_experts_product<MT>(a, kGu, l, s_experts, nused, eg.ksplit, eg.cps,
                              smem);
      if (a.has_shared) product_call<MT>(a, kSgu, l, a.partial, smem);
      grid_barrier(a, phase++);
      moe_act_phase(a, s_experts, nused, eg.ksplit, a.partial);
      grid_barrier(a, phase++);
      moe_experts_product<MT>(a, kDn, l, s_experts, nused, ed.ksplit, ed.cps,
                              smem);
      if (a.has_shared) product_call<MT>(a, kSdn, l, a.partial, smem);
      grid_barrier(a, phase++);
    }
  }
  if (MOE)
    moe_resid_phase(a, a.partial, mlp_ksplit, a.st[kDn].ksplit, a.L - 1,
                    a.final_norm, fsmem);
  else
    resid_phase<LORA>(a, a.partial, mlp_ksplit, false, a.final_norm, fsmem,
                      kLd, a.L - 1);
  grid_barrier(a, phase++);
  norm_phase(a, fsmem);
  grid_barrier(a, phase++);
  product_call<MT>(a, kLm, 0, a.logits, smem);
  grid_barrier(a, phase++);   // so that a trace shows the lm_head's end
}

// Blocks of mk_kernel<MT, MOE, LORA, ALIBI> resident at once on one SM (0
// on error).
template <int MT, bool MOE, bool LORA, bool ALIBI = false>
int per_sm(int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      mk_kernel<MT, MOE, LORA, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mk_kernel<MT, MOE, LORA, ALIBI>, kThreads, smem);
  return e == cudaSuccess ? n : 0;
}

template <int MT, bool MOE, bool LORA, bool ALIBI = false>
void launch(const Args& a, int grid, int smem, cudaStream_t s) {
  cudaFuncSetAttribute(mk_kernel<MT, MOE, LORA, ALIBI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mk_kernel<MT, MOE, LORA, ALIBI><<<grid, kThreads, smem, s>>>(a);
}

// kind 0 dense (a RoPE or an ALiBi model: the grid both instantiations
// take), 1 MoE, 2 LoRA
template <int MT>
int per_sm_of(int kind, int smem) {
  if (kind == 1) return per_sm<MT, true, false>(smem);
  if (kind == 2) return per_sm<MT, false, true>(smem);
  const int rope = per_sm<MT, false, false>(smem);
  const int alibi = per_sm<MT, false, false, true>(smem);
  return rope < alibi ? rope : alibi;
}

template <int MT>
void launch_of(const Args& a, int grid, int smem, cudaStream_t s) {
  if (a.E > 0)
    launch<MT, true, false>(a, grid, smem, s);
  else if (a.lora_n > 0)
    launch<MT, false, true>(a, grid, smem, s);
  else if (a.slopes != nullptr)
    launch<MT, false, false, true>(a, grid, smem, s);
  else
    launch<MT, false, false>(a, grid, smem, s);
}

}  // namespace

// The largest grid whose blocks are all resident at once on `device` for a
// batch padded to `mpad` rows (kind 0: a dense model, 1: a MoE model, 2: a
// dense model with the LoRA branch): SMs x blocks per SM of the kernel with
// its dynamic shared memory. Returns 0 on error.
extern "C" int di_megakernel_grid(int device, int mpad, int hid, int kind) {
  const int mt = mpad > 16 ? 2 : 1;
  const int smem = smem_bytes(mt, hid, kind == 2);
  const int n = mt == 1 ? per_sm_of<1>(kind, smem) : per_sm_of<2>(kind, smem);
  int sms = 0;
  if (n == 0 || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (n < 2 ? n : 2);
}

// One decode forward. `ia` holds pointers and integers by the IArg index,
// then the streams, then the LoRA branch's kLoraArgs values (lora_n 0: no
// adapter; ops/megakernel.py `lora_args`); `fa` = {rms eps, attention
// scale}. Shapes and types are validated by the caller (ops/megakernel.py).
// Returns cudaGetLastError().
extern "C" int di_megakernel(const long long* ia, const double* fa,
                             void* stream) {
  Args a;
  fill_args(a, ia, fa);
  fill_lora(a, ia + I_STREAMS + kStreams * kStreamArgs);
  if (a.slopes != nullptr && (a.E > 0 || a.lora_n > 0))
    return (int)cudaErrorInvalidValue;
  if (a.lora_n > 0 && (a.E > 0 || a.lora_n > kMaxLoraSlots ||
                       a.lora_r < 8 || a.lora_r > kMaxLoraRank ||
                       a.lora_r % 8 || a.lora_kc * kLoraKC < a.inter ||
                       a.lora_kc * kLoraKC < a.hid ||
                       a.lora_kc * kLoraKC < a.H * kD))
    return (int)cudaErrorInvalidValue;
  // the wrapper's attention chunks must be whole tiles, at most kMaxChunks
  if (a.split_len < kAttTile || a.split_len % kAttTile || a.nsplit < 1 ||
      a.nsplit > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (a.E > 0 && (a.E + a.has_sgate > kMaxLanes || a.k_top < 1 ||
                  a.k_top > kMaxTopk || a.inter % kChunkK ||
                  a.shared_inter % kChunkK))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)ia[I_GRID];
  const int mt = a.mpad > 16 ? 2 : 1;
  const int smem = smem_bytes(mt, a.hid, a.lora_n > 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt == 1)
    launch_of<1>(a, grid, smem, s);
  else
    launch_of<2>(a, grid, smem, s);
  return (int)cudaGetLastError();
}
