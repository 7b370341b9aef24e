// Whole-model prefill of one prompt bucket as ONE persistent kernel, sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/prefill_megakernel.py
// `build_prefill_megakernel` (RoPE or ALiBi (the scores + slope * (key -
// row): `pmk_kernel<true>`, launched for a non-null slopes pointer),
// optional q/k/v bias, optional per-head QK
// RMSNorm (Qwen3), KV pool DEFAULT / INT8 / UINT4, weight streams u4
// group-wise, int8 group-wise or per-channel, bf16; a dense MLP or the MoE
// branch). It reads the DECODE pack (ops/megakernel.py `pack_params`:
// fragment-ordered 64-row x 256-column chunks), so prefill and decode share
// one weight set on the card.
//
// What it computes, for the S-row bucket of which n rows are a prompt, per
// layer: RMSNorm -> x_norm bf16; q|k|v = x_norm @ W with WEIGHT-SIDE dequant
// (w = bf16(f32(level) * s + z), s and z rounded to bf16; for u4 as ONE fused
// bf16 multiply-add of the exact bf16 operands level, s, z, which rounds once
// where the f32 form rounds twice: the same value unless the f32 sum is
// inexact AND lands on a bf16 tie) and f32 sums; bias in f32; a QK-norm
// model's RMSNorm of each q and k head in f32; RoPE from bf16 cos/sin tiles in
// f32 (not on V); K and V of rows < n quantized per token and KV head from the
// f32 values and written to the request's pages; causal softmax attention (two
// passes over the key tiles: row maximum and sum first, then p = exp(s - m) /
// l rounded to bf16 for the PV product, as the TPU kernel rounds it; two warp
// groups' partial sums added in a fixed order) -> attn_out bf16; o product
// into the f32 residual; RMSNorm; gate|up products; SwiGLU rounded to bf16;
// down product into the residual. Then the final norm of row n - 1 and the
// lm_head for that row, with the decode product's rounding (bf16 x by the
// bf16 levels, the group affine on the f32 sums: within PERF.md §2's
// logits rule of the weight-side form). The score product's operands are
// bf16 q and k (the tensor cores'), where the TPU kernel's are f32.
//
// What bounds it on the H100: operations at S >= 256 (about 13 GFLOP a
// prompt row for Qwen2-7B against 3.98 GB of weights: 295 operations a byte
// is passed at ~90 rows), bytes below that. A MoE model's operations are
// its routed work, n rows x k experts (+ the router and the shared expert):
// at bucket 1024 ~4.4 TFLOP for Qwen1.5-MoE, where every expert over every
// row would be ~28.
//
// What this design does about it. Nothing of the TPU kernel's VMEM state
// fits on an SM, so the activations between phases (f32 residual, bf16
// x_norm, the products' f32 results, bf16 q / k / v, attn_out, the bf16
// SwiGLU activation) are global scratch that mostly stays in the 50 MB L2,
// and the phases of the persistent grid (one block an SM, from the occupancy
// query) are separated by the grid barrier of di_common.cuh.
//
// The products (di_prefill_layer.cuh `gemm_phase`) run on wgmma, the
// tensor cores' asynchronous warpgroup product: an item is (256-column
// weight tile, K split, 128-row tile of the prompt), row tiles innermost, so
// the blocks that run side by side read the same weight chunks and a
// payload byte comes from device memory once. The weights are the A
// operand, from registers: each warp dequantizes its 16 columns of each
// tile half once a 64-row chunk, in the pack's fragment order, which is
// wgmma's register-A layout, and its warpgroup's m64n128k16 products reuse
// them over the tile's 128 rows; x is the B operand, which the tensor cores
// read from shared memory, so no warp re-reads the x tile. The phases that
// write x (norms, attention, SwiGLU, the MoE gather) lay it out chunk-major
// in the 128-byte swizzle the tensor cores read (`xoff`), so a stage's x
// tile is one contiguous run and one bulk copy. Thread 0 keeps a ring of
// stages (x tile, weight chunk, qparams) filled with bulk copies on
// mbarriers, two chunks behind the one being computed; the warps wait on a
// stage's full barrier and release it on its empty barrier once their
// products on it are done, with no block-wide barrier a chunk. Each k16
// step's products form a commit group that the warpgroup waits for before
// it dequantizes the next step; with every phase in one persistent
// function (255 registers) ptxas serializes the products (C7512), so one
// warpgroup's dequant overlaps the other's products (~300 TFLOP/s at
// bucket 1024 on an H100 SXM, PERF.md).
// K splits (chosen by the wrapper from the grid) keep all SMs busy where a
// product has few tiles (o and down at S = 128); their partial sums are
// added in a fixed order by the
// phase that reads them, so a launch repeats bit for bit. Row tiles wholly
// beyond n are skipped in every phase; rows >= n inside the last tile are
// computed and never read by a valid row. Each payload kind's product is
// inlined at ONE place in the kernel (`product`): ptxas serializes a wgmma
// pipeline that crosses a function call. An attention item is (query
// head, 64-row half of a 128-row query tile), two warp groups of four
// sharing its key tiles, dealt longest first in rounds that turn back,
// over 64-key tiles of bf16 K / V in two cp.async stages; V's mma operand
// comes from ldmatrix.trans.
// The lm_head's one row (`lm_row`, bound by the vocab's bytes: 307 MB of
// u4 payload and qparams at Qwen2-7B, 0.092 ms) runs the decode kernels'
// mma.sync product (wgmma with N = 1 gains nothing) over (256-column tile,
// K split) items whose split fills whole waves of the grid (594 tiles x 2 =
// 9 waves of 132), the splits summed by the block that takes a tile's last
// ticket; it stays the last phase.
//
// MoE layers: the experts run over their routed rows only. After norm2:
// the router product (bf16, a 256-column stream) and a gates phase (one
// warp a row, `route_row`, dense gates [S][EP], each prompt row's experts
// in ascending order); a route phase lays the n x k (row, expert) pairs
// out as slots, expert by expert, each expert's rows in ascending row
// order (counts and ranks from ballots over the rows in order: no order
// comes from atomics), and copies each routed row's x_norm to its slot;
// the experts' gate|up, SwiGLU and down then run over items (expert,
// column tile, K split, 64-slot tile), enumerated by every block from the
// counts after the barrier: an expert with no rows has no items and its
// weights are not read; the sum phase adds, per row, gate x down at its
// slots in ascending expert order (a gate of 0 skipped), as the TPU
// kernel's every-expert sum does, then the shared expert runs over every
// row (its gate|up beside the sum). The next norm adds resid + (acc +
// shared gate x shared down). The kernel writes each layer's per-expert
// row counts (ecount) for the caller to read.
//
// Phases of one layer (each followed by the barrier): norm1 -> q|k|v ->
// rope + KV write -> attention -> o -> norm2 -> gate|up -> SwiGLU -> down
// (MoE: -> router -> gates -> route -> experts' gate|up -> SwiGLU -> down
// -> sum + shared gate|up -> shared SwiGLU -> shared down); then final
// norm -> lm_head. With a trace buffer, block 0 writes a timestamp where it
// ends each phase and where it leaves each barrier
// (ops/prefill_megakernel.py `phase_times`).

#include "di_prefill_layer.cuh"

namespace {

using namespace di;

// norm_phase of a MoE layer's residual: + acc + the shared expert's output.
__device__ __noinline__ void moe_norm_phase(const PArgs& a, int rows,
                                            int ksplit, size_t split_stride,
                                            int moe_layer, const float* w,
                                            float* red) {
  norm_rows<true>(a, rows, ksplit, split_stride, false, moe_layer, w, red);
}

// MoE router: one warp a row (`route_row`, its router lanes in the warp's
// kMaxLanes floats of shared memory), from the router product's K splits
// -> dense gates [layer][row][EP] (0 where not routed) and the shared gate;
// a prompt row's experts, ascending, into eidx[row]. Each layer's gates
// stay in the scratch until the launch ends.
__device__ __noinline__ void gates_phase(const PArgs& a, int rows, int n,
                                         int layer, float* smem) {
  float* gates = a.gates + (size_t)layer * a.S * a.EP;
  const Stream& st = a.st[kRt];
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  float* lg = smem + (threadIdx.x >> 5) * kMaxLanes;
  for (int row = gw; row < rows; row += nw) {
    int idx[kMaxTopk];
    float w[kMaxTopk], sg;
    route_row(a.partial + (size_t)row * st.ldo, st.ksplit,
              (size_t)a.S * st.ldo, lg, a.E, a.k_top, a.norm_topk,
              a.has_shared, a.has_sgate, idx, w, sg);
    for (int e = lane; e < a.EP; e += 32) {
      float v = 0.f;
      for (int j = 0; j < a.k_top; ++j)
        if (idx[j] == e) v = w[j];
      gates[(size_t)row * a.EP + e] = v;
    }
    if (lane == 0) a.sgate[(size_t)layer * a.S + row] = sg;
    if (lane < a.k_top && row < n) {
      int e = idx[0];
#pragma unroll
      for (int j = 1; j < kMaxTopk; ++j)
        if (j == lane) e = idx[j];
      a.eidx[(size_t)row * kMaxTopk + lane] = e;
    }
  }
}

// The routed slots of the prompt rows' (row, j) pairs: expert e's rows, in
// ascending row order, are the slots base[e] .. base[e] + count[e] - 1,
// base[e] the counts of the experts before e rounded up to 8 and summed
// (the expert products read whole 8-row groups of the x layout). Every
// block reads the n x k experts of the prompt rows into shared memory,
// counts them (a shared-memory histogram: the counts, not their order,
// come from atomics) and ranks each expert's rows with ballots over the
// rows in order, a warp an expert; then it takes its share of the (row, j)
// pairs, a warp a pair: the slot into eslot and the row's x_norm into the
// slot. Block 0 writes the layer's counts (ecount[layer]). Nothing depends
// on the order of atomics, so a launch repeats bit for bit.
__device__ __noinline__ void route_phase(const PArgs& a, int n, int layer,
                                         uint8_t* smem) {
  const int E = a.E, k = a.k_top, nk = n * a.k_top, units = a.hid / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* cnt = reinterpret_cast<int*>(smem);  // [E]
  int* base = cnt + E;                      // [E]
  int* ex = base + E;                       // [n * k] the rows' experts
  int* sl = ex + nk;                        // [n * k] their slots
  for (int e = tid; e < E; e += kThreads) cnt[e] = 0;
  for (int i = tid; i < nk; i += kThreads)
    ex[i] = __ldcg(a.eidx + (size_t)(i / k) * kMaxTopk + i % k);
  __syncthreads();
  for (int i = tid; i < nk; i += kThreads) atomicAdd(cnt + ex[i], 1);
  __syncthreads();
  if (tid == 0) {
    int b = 0;
    for (int e = 0; e < E; ++e) {
      base[e] = b;
      b += (cnt[e] + 7) & ~7;
    }
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int e = tid; e < E; e += kThreads)
      a.ecount[(size_t)layer * E + e] = cnt[e];
  for (int e = warp; e < E; e += kWarps) {
    int pos = base[e];
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int r = r0 + lane;
      int j = -1;
      if (r < n)
        for (int q = 0; q < k; ++q)
          if (ex[r * k + q] == e) j = q;
      const unsigned m = __ballot_sync(0xffffffffu, j >= 0);
      if (j >= 0) sl[r * k + j] = pos + __popc(m & ((1u << lane) - 1u));
      pos += __popc(m);
    }
  }
  __syncthreads();
  for (int i = blockIdx.x * kWarps + warp; i < nk; i += gridDim.x * kWarps) {
    const int row = i / k, slot = sl[i];
    if (lane == 0) a.eslot[(size_t)row * kMaxTopk + i % k] = slot;
    for (int u0 = 0; u0 < units; u0 += 8 * 32) {
      uint4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int u = u0 + 32 * q + lane;
        if (u < units)
          v[q] = __ldcg(reinterpret_cast<const uint4*>(
              a.xn + xoff(a.S, row, 8 * u)));
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int u = u0 + 32 * q + lane;
        if (u < units)
          *reinterpret_cast<uint4*>(a.xe + xoff(a.scap, slot, 8 * u)) = v[q];
      }
    }
  }
}

// SwiGLU of the experts' gate|up over the routed slots -> act (scap rows,
// the x layout of the down product).
__device__ __noinline__ void expert_act_phase(const PArgs& a, int n) {
  const Stream& st = a.st[kGu];
  const int quarter = a.inter / 4, k = a.k_top;
  const size_t split_stride = (size_t)a.scap * st.ntot;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n * k * quarter;
       i += gridDim.x * kThreads) {
    const int rj = i / quarter, c = 4 * (i - rj * quarter);
    const int slot = __ldcg(a.eslot + (size_t)(rj / k) * kMaxTopk + rj % k);
    store_act(a.act, a.scap, slot, c,
              swiglu4(st, a.partial, split_stride, slot, c));
  }
}

// acc[row] = sum over the row's experts, ascending, of its gate x the K
// splits of the expert's down product at the row's slot (a gate of 0 adds
// nothing and is skipped); rows >= n: 0.
__device__ __noinline__ void expert_sum_phase(const PArgs& a, int layer,
                                              int n, int rows) {
  const float* gates = a.gates + (size_t)layer * a.S * a.EP;
  const Stream& st = a.st[kDn];
  const int hid = a.hid, q = hid / 4;
  const size_t split_stride = (size_t)a.scap * hid;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < rows * q;
       i += gridDim.x * kThreads) {
    const int row = i / q, c = 4 * (i - row * q);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < (row < n ? a.k_top : 0); ++j) {
      const size_t rj = (size_t)row * kMaxTopk + j;
      const int e = __ldcg(a.eidx + rj);
      const float w = __ldcg(gates + (size_t)row * a.EP + e);
      if (w == 0.f) continue;       // it adds 0
      const int slot = __ldcg(a.eslot + rj);
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < st.ksplit; ++s) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            a.edn + s * split_stride + (size_t)slot * hid + c));
        y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
      }
      // the plain version's acc + gate x down, rounded apiece
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, y.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, y.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w, y.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w, y.w));
    }
    *reinterpret_cast<float4*>(a.acc + (size_t)row * hid + c) = acc;
  }
}

// ALIBI: an ALiBi model's kernel (a.slopes), an instantiation of its own,
// so that the RoPE model's code is unchanged.
template <bool ALIBI>
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
  const bool moe = a.E > 0;
  // the down product's splits the next norm adds (a MoE layer: its shared
  // expert's, beside acc)
  const int mlp_ks = moe ? (a.has_shared ? a.st[kSdn].ksplit : 0)
                         : a.st[kDn].ksplit;
  int phase = 0;
  auto barrier = [&]() {
    grid_barrier(a.barrier, a.status, a.trace, phase++);
  };
  // a layer's phases, each followed by the grid barrier; a product phase
  // sets its stream and operands and runs at the one product call below
  const int nph = !moe ? 9 : (a.has_shared ? 15 : 13);
  for (int l = 0; l < a.L; ++l) {
    for (int ph = 0; ph < nph; ++ph) {
      int sid = -1;
      bool grouped = false;
      const __nv_bfloat16* X = a.xn;
      float* out = a.partial;
      size_t sst = (size_t)S * hid;
      float* red = reinterpret_cast<float*>(smem);
      switch (ph) {
        case 0:
          if (moe && l > 0)
            moe_norm_phase(a, rows, mlp_ks, (size_t)S * hid, l - 1,
                           a.norms + (size_t)(2 * l) * hid, red);
          else
            norm_phase(a, rows, mlp_ks, (size_t)S * hid, l == 0,
                       a.norms + (size_t)(2 * l) * hid, red);
          break;
        case 1: sid = kQkv; sst = (size_t)S * a.st[kQkv].ntot; break;
        case 2: rope_kv<ALIBI>(a, l, rows, n); break;
        case 3: attention_phase<ALIBI>(a, mtiles, smem); break;
        case 4: sid = kO; X = a.attn; break;
        case 5:
          norm_phase(a, rows, a.st[kO].ksplit, (size_t)S * hid, false,
                     a.norms + (size_t)(2 * l + 1) * hid, red);
          break;
        case 6:                       // gate|up, or the MoE router
          sid = moe ? kRt : kGu;
          sst = (size_t)S * a.st[sid].ntot;
          break;
        case 7:
          if (moe)
            gates_phase(a, rows, n, l, reinterpret_cast<float*>(smem));
          else
            act_phase(a, a.st[kGu], a.inter, rows);
          break;
        case 8:
          if (moe)
            route_phase(a, n, l, smem);
          else {
            sid = kDn;
            X = a.act;
          }
          break;
        case 9:                       // the experts over their routed rows
          sid = kGu;
          grouped = true;
          X = a.xe;
          sst = (size_t)a.scap * a.st[kGu].ntot;
          break;
        case 10: expert_act_phase(a, n); break;
        case 11:
          sid = kDn;
          grouped = true;
          X = a.act;
          out = a.edn;
          sst = (size_t)a.scap * hid;
          break;
        case 12:                      // the sum, beside the shared gate|up
          expert_sum_phase(a, l, n, rows);
          if (a.has_shared) {
            sid = kSgu;
            sst = (size_t)S * a.st[kSgu].ntot;
          }
          break;
        case 13: act_phase(a, a.st[kSgu], a.shared_inter, rows); break;
        default: sid = kSdn; X = a.act; break;
      }
      if (sid >= 0)
        product<true>(a, sid, grouped, l, X, out, sst, mtiles, rows, smem);
      barrier();
    }
  }
  final_norm_phase(a, n, mlp_ks, moe, reinterpret_cast<float*>(smem));
  barrier();
  lm_row(a, a.logits, smem);
  barrier();   // so that a trace shows the lm_head's end
}

// Blocks of pmk_kernel<ALIBI> resident at once on one SM (0 on error).
template <bool ALIBI>
int per_sm(int smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      pmk_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pmk_kernel<ALIBI>,
                                                      kThreads, smem);
  return e == cudaSuccess ? n : 0;
}

}  // namespace

// The largest grid whose blocks are all resident at once on `device`: SMs x
// (at most one) block per SM of the kernel (both its instantiations, RoPE
// and ALiBi) with its dynamic shared memory. Returns 0 on error.
extern "C" int di_prefill_megakernel_grid(int device) {
  const int smem = pmk_smem_bytes();
  const int rope = per_sm<false>(smem), alibi = per_sm<true>(smem);
  const int n = rope < alibi ? rope : alibi;
  int sms = 0;
  if (n == 0 || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (n < 1 ? n : 1);
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
      (a.hid + kWarps) * 4 > pmk_smem_bytes() ||
      (2 * a.EP + 2 * a.S * a.k_top) * 4 > pmk_smem_bytes() ||
      !lm_row_args_ok(a))
    return (int)cudaErrorInvalidValue;
  if (a.E > 0 && (a.E + a.has_sgate > a.EP || a.EP > kMaxLanes ||
                  a.k_top < 1 || a.k_top > kMaxTopk ||
                  a.scap < a.S * a.k_top + 8 * a.E + kETile ||
                  a.scap % 64 != 0 || a.shared_inter % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)ia[I_GRID];
  const int smem = pmk_smem_bytes();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.slopes != nullptr) {
    cudaFuncSetAttribute(pmk_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pmk_kernel<true><<<grid, kThreads, smem, s>>>(a);
  } else {
    cudaFuncSetAttribute(pmk_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pmk_kernel<false><<<grid, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
