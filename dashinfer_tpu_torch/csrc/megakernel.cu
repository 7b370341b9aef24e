// Whole-model decode step as ONE persistent kernel, sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/megakernel.py `build_decode_megakernel`
// (RoPE, optional q/k/v bias, KV pool DEFAULT / INT8 / UINT4, weight streams
// u4 group-wise, int8 group-wise or per-channel, bf16; a dense MLP or the
// MoE branch: router, routed experts, shared expert).
//
// What it computes, per layer: RMSNorm; q|k|v products + bias; RoPE with
// bf16 cos/sin tiles; the new token's K/V quantized and written to its page
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
// (grid = SMs x co-resident blocks, from the occupancy query) and phases
// are separated by a grid-wide barrier in global memory (arrive counter
// with a flip bit, release/acquire fences). Activations between phases live
// in small global scratch buffers that stay in L2:
//   records  the next product's x operand, per 64-row K chunk, as ready-made
//            mma A fragments plus f32 row sums (csrc/di_product.cuh), so a
//            product stage brings its x tile and its group sums in with the
//            same cp.async pipeline as the payload (the producing phase
//            writes them: no prologue launch);
//   partial  each product's split-K partial sums [ksplit][B][N] f32, summed
//            in a fixed order by the consuming phase (no float atomics:
//            a step repeats bit for bit).
// A product phase walks work items (256-column tile, K split) round-robin
// over the blocks; a block's items form ONE flat chunk sequence, so the
// cp.async pipeline (6 chunks deep for u4) stays full across item borders.
// The dot is quant_matmul.cu's m16n8k16 mma (a u4 level n enters as
// bf16(128 + n), the 128 * sum(x) comes back off in the group affine), on a
// payload that `pack_params` has re-laid in fragment order: the product is
// bound by instruction issue, not by memory, and the pack lets a lane fetch
// its operands with 16-byte shared-memory loads. Attention items are (slot,
// KV head, stripe of the sequence); stripe 0 also quantizes and writes the
// new token. The loop over pages that the TPU kernel runs as a DMA ring is
// a loop over tokens inside the block, each warp keeping its next tokens in
// flight through a small cp.async ring; pages at or past lens are never
// read.
//
// Phases of one layer (each followed by the barrier): resid1 -> norm1 ->
// q|k|v -> attention -> merge -> o -> resid2 -> norm2 -> gate|up -> SwiGLU
// -> down; then resid -> final norm -> lm_head. Eleven barriers a layer.
//
// MoE layers (Qwen1.5/2-MoE): after norm2 the router product (bf16 weights
// as a 256-column stream) and a gates phase (one warp a row: softmax over
// the E lanes, top-k, the shared expert's sigmoid gate: `route_row`), then
// gate|up, SwiGLU and down each as ONE phase over all routed experts and
// the shared expert: 13 barriers a layer. The TPU kernel streams every
// expert each step and multiplies the unrouted ones by 0; here each block
// lists the experts that some active row routes to (from the gates phase's
// top-k, in ascending order) and the products' items run over those alone,
// which computes the same function and reads ~25 of 60 experts at B = 8.
// The next resid phase adds, per row, its experts' down products times their
// gates in ascending expert order, then the shared expert's times its gate.
// With a trace buffer, block
// 0 writes a timestamp where it ends each phase and where it leaves each
// barrier (ops/megakernel.py `phase_times`). The dense layer phases live in
// di_layer.cuh, which the tensor-parallel segments (tp_segments.cu) share.

#include "di_layer.cuh"

namespace {

using namespace di;

// resid_phase after a MoE layer (`layer`): resid[m] += the row's routed
// experts' down products times their gates (ascending experts; an inactive
// row's experts were not run), then the shared expert's (its `ksplit`
// partials in `part`) times its gate, summed before they are added.
__device__ __noinline__ void moe_resid_phase(const Args& a, const float* part,
                                             int ksplit, int layer,
                                             const float* w, float* smem) {
  const size_t route = (size_t)layer * a.B;
  const Stream& edn = a.st[kDn];
  const size_t edn_gs = (size_t)edn.ksplit * a.B * a.hid;
  const int hid = a.hid, nslab = hid / kSlab;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_block = norm_items_per_block(a);
  float* vals = smem;
  float* wts = vals + per_block * kSlab;
  float* red = wts + per_block * kSlab;
  const int half = tid / kSlab, t = tid % kSlab;
  for (int k0 = 0; k0 < per_block; k0 += kThreads / kSlab) {
    const int k = k0 + half;
    const int it = blockIdx.x + k * gridDim.x;
    const bool valid = k < per_block && it < a.B * nslab;
    if (valid) {
      const int m = it / nslab, i = (it % nslab) * kSlab + t;
      const float wv = w[i];
      float acc = 0.f;
      if (a.active[m]) {
        for (int j = 0; j < a.k_top; ++j) {
          const int e = __ldcg(a.topk_e + (route + m) * kMaxTopk + j);
          const float g = __ldcg(a.topk_w + (route + m) * kMaxTopk + j);
          const float* p = a.epart + (size_t)e * edn_gs + (size_t)m * hid + i;
          float y = 0.f;
          for (int s = 0; s < edn.ksplit; ++s)
            y += __ldcg(p + (size_t)s * a.B * hid);
          acc += g * y;
        }
      }
      if (a.has_shared) {
        float y = 0.f;
        // four splits' loads are issued before the first is added
        for (int s = 0; s < ksplit; s += 4) {
          float p[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p[q] = s + q < ksplit
                       ? __ldcg(part + ((size_t)(s + q) * a.B + m) * hid + i)
                       : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) y += p[q];
        }
        acc += __ldcg(a.sgate + route + m) * y;
      }
      const float v = __ldcg(a.resid + (size_t)m * hid + i) + acc;
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


// MoE: the routed experts' SwiGLU (their gate|up partials in epart -> their
// down x records in erec), then the shared expert's (partial -> rec).
__device__ __noinline__ void moe_act_phase(const Args& a, const int* experts,
                                           int nused) {
  const int ech = a.inter / kChunkK;
  const int sch = a.has_shared ? a.shared_inter / kChunkK : 0;
  const int n_e = nused * ech * a.B;
  const Stream& eg = a.st[kGu];
  const size_t egs = (size_t)eg.ksplit * a.B * eg.ntot;
  const size_t rgs = (size_t)ech * rec_bytes(a.mpad);
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  for (int it = gw; it < n_e + sch * a.B; it += nw) {
    if (it < n_e) {
      const int e = experts[it / (ech * a.B)], r = it % (ech * a.B);
      swiglu_chunk(a, eg, a.epart + (size_t)e * egs, r / ech, r % ech,
                   a.erec + (size_t)e * rgs, lane);
    } else {
      const int r = it - n_e;
      swiglu_chunk(a, a.st[kSgu], a.partial, r / sch, r % sch, a.rec, lane);
    }
  }
}

// MoE router: one warp a row, from the router product's partials; each
// layer's choices stay in the scratch ([L][B][kMaxTopk]) until the step ends.
__device__ __noinline__ void gates_phase(const Args& a, int layer) {
  const Stream& st = a.st[kRt];
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  for (int b = gw; b < a.B; b += nw) {
    int idx[kMaxTopk];
    float w[kMaxTopk], sg;
    route_row(a.partial + (size_t)b * st.ldo, st.ksplit,
              (size_t)a.B * st.ldo, a.E, a.k_top, a.norm_topk, a.has_shared,
              a.has_sgate, idx, w, sg);
    if (lane == 0) {
      const size_t r = (size_t)layer * a.B + b;
      for (int j = 0; j < a.k_top; ++j) {
        a.topk_e[r * kMaxTopk + j] = idx[j];
        a.topk_w[r * kMaxTopk + j] = w[j];
      }
      a.sgate[r] = sg;
    }
  }
}

// The experts that some active row routes to, ascending, into `list`
// (shared memory; every block builds the same list). Returns their count.
__device__ __noinline__ int routed_experts(const Args& a, int layer,
                                           int* list, unsigned* flags,
                                           int* count) {
  const int* topk = a.topk_e + (size_t)layer * a.B * kMaxTopk;
  for (int i = threadIdx.x; i < kMaxLanes / 32; i += kThreads) flags[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < a.B * a.k_top; i += kThreads) {
    const int b = i / a.k_top;
    if (a.active[b]) {
      const int e = __ldcg(topk + b * kMaxTopk + i % a.k_top);
      atomicOr(flags + (e >> 5), 1u << (e & 31));
    }
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

// MOE: the MoE model's kernel. The dense kernel is compiled without any of
// the MoE code, so that it adds nothing to the dense products' registers.
template <int MT, bool MOE>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
mk_kernel(const __grid_constant__ Args a) {
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
      moe_resid_phase(a, a.partial, mlp_ksplit, l - 1,
                      a.norms + (size_t)(2 * l) * hid, fsmem);
    else
      resid_phase(a, a.partial, mlp_ksplit, l == 0,
                  a.norms + (size_t)(2 * l) * hid, fsmem);
    grid_barrier(a, phase++);
    norm_phase(a, fsmem);
    grid_barrier(a, phase++);
    product<MT>(a, kQkv, l, a.partial, smem);
    grid_barrier(a, phase++);
    if (!a.skip_attn) attention(a, l, fsmem);
    grid_barrier(a, phase++);
    merge_phase(a);
    grid_barrier(a, phase++);
    product<MT>(a, kO, l, a.partial, smem);
    grid_barrier(a, phase++);
    resid_phase(a, a.partial, a.st[kO].ksplit, false,
                a.norms + (size_t)(2 * l + 1) * hid, fsmem);
    grid_barrier(a, phase++);
    norm_phase(a, fsmem);
    grid_barrier(a, phase++);
    if constexpr (!MOE) {
      product<MT>(a, kGu, l, a.partial, smem);
      grid_barrier(a, phase++);
      act_phase(a);
      grid_barrier(a, phase++);
      product<MT>(a, kDn, l, a.partial, smem);
      grid_barrier(a, phase++);
    } else {
      // the routed experts' list, built once a layer in every block
      __shared__ int s_experts[kMaxLanes];
      __shared__ unsigned s_flags[kMaxLanes / 32];
      __shared__ int s_nused;
      product<MT>(a, kRt, l, a.partial, smem);
      grid_barrier(a, phase++);
      gates_phase(a, l);
      grid_barrier(a, phase++);
      const int nused = routed_experts(a, l, s_experts, s_flags, &s_nused);
      const Stream& eg = a.st[kGu];
      product_experts<MT>(a, kGu, l, a.epart, smem, a.rec, s_experts, nused,
                          0, (size_t)eg.ksplit * a.B * eg.ntot);
      if (a.has_shared) product<MT>(a, kSgu, l, a.partial, smem);
      grid_barrier(a, phase++);
      moe_act_phase(a, s_experts, nused);
      grid_barrier(a, phase++);
      product_experts<MT>(a, kDn, l, a.epart, smem, a.erec, s_experts, nused,
                          (size_t)(a.inter / kChunkK) * rec_bytes(a.mpad),
                          (size_t)a.st[kDn].ksplit * a.B * a.hid);
      if (a.has_shared) product<MT>(a, kSdn, l, a.partial, smem);
      grid_barrier(a, phase++);
    }
  }
  if (MOE)
    moe_resid_phase(a, a.partial, mlp_ksplit, a.L - 1, a.final_norm, fsmem);
  else
    resid_phase(a, a.partial, mlp_ksplit, false, a.final_norm, fsmem);
  grid_barrier(a, phase++);
  norm_phase(a, fsmem);
  grid_barrier(a, phase++);
  product<MT>(a, kLm, 0, a.logits, smem);
  grid_barrier(a, phase++);   // so that a trace shows the lm_head's end
}

// Blocks of mk_kernel<MT, MOE> resident at once on one SM (0 on error).
template <int MT, bool MOE>
int per_sm(int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      mk_kernel<MT, MOE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mk_kernel<MT, MOE>,
                                                      kThreads, smem);
  return e == cudaSuccess ? n : 0;
}

template <int MT, bool MOE>
void launch(const Args& a, int grid, int smem, cudaStream_t s) {
  cudaFuncSetAttribute(mk_kernel<MT, MOE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mk_kernel<MT, MOE><<<grid, kThreads, smem, s>>>(a);
}

}  // namespace

// The largest grid whose blocks are all resident at once on `device` for a
// batch padded to `mpad` rows (of a MoE model when `moe`): SMs x blocks per
// SM of the kernel with its dynamic shared memory. Returns 0 on error.
extern "C" int di_megakernel_grid(int device, int mpad, int hid, int moe) {
  const int mt = mpad > 16 ? 2 : 1;
  const int smem = smem_bytes(mt, hid);
  const int n = mt == 1 ? (moe ? per_sm<1, true>(smem) : per_sm<1, false>(smem))
                        : (moe ? per_sm<2, true>(smem) : per_sm<2, false>(smem));
  int sms = 0;
  if (n == 0 || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (n < 2 ? n : 2);
}

// One decode forward. `ia` holds pointers and integers by the IArg index,
// `fa` = {rms eps, attention scale}. Shapes and types are validated by the
// caller (ops/megakernel.py). Returns cudaGetLastError().
extern "C" int di_megakernel(const long long* ia, const double* fa,
                             void* stream) {
  Args a;
  fill_args(a, ia, fa);
  // the wrapper's stripe geometry must be the kernel's
  if (a.split_len != kAttUnit || a.nsplit < 1 || a.nsplit > kMaxStripes)
    return (int)cudaErrorInvalidValue;
  if (a.E > 0 && (a.E + a.has_sgate > kMaxLanes || a.k_top < 1 ||
                  a.k_top > kMaxTopk || a.inter % kChunkK ||
                  a.shared_inter % kChunkK))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)ia[I_GRID];
  const int mt = a.mpad > 16 ? 2 : 1;
  const int smem = smem_bytes(mt, a.hid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt == 1)
    a.E > 0 ? launch<1, true>(a, grid, smem, s)
            : launch<1, false>(a, grid, smem, s);
  else
    a.E > 0 ? launch<2, true>(a, grid, smem, s)
            : launch<2, false>(a, grid, smem, s);
  return (int)cudaGetLastError();
}
