// The MoE phases of the decode megakernel (csrc/megakernel.cu), shared
// with the tensor-parallel MoE segment (csrc/tp_segments.cu): the router's
// gates (di_product.cuh's `route_top` a row), the list of the experts some
// active row routes to, the routed experts' products, their and the shared
// expert's SwiGLU, and the residual update after a MoE layer; for the
// segment also the gates beside the shared expert's gate|up and the routed
// experts' downs beside the shared expert's as one item space. The products are
// di_product.cuh's `product_parts`; the segment reads the experts' K
// splits from the split table (`Args::msplit`) at the step's routed count,
// the megakernel keeps its static ones.

#pragma once

#include "di_layer.cuh"

namespace {

using namespace di;

// The split table's entry for `nused` routed experts.
__device__ __forceinline__ const int* moe_splits(const Args& a, int nused) {
  return a.msplit + (size_t)nused * kMoeSplitArgs;
}

// The shared expert's gate|up partials: after the router's in `partial`
// (the gates read those while the shared gate|up runs).
__device__ __forceinline__ float* shared_gu_partial(const Args& a) {
  const Stream& rt = a.st[kRt];
  return a.partial + (size_t)rt.ksplit * a.B * rt.ldo;
}

// resid_phase after a MoE layer (`layer`): resid[m] += the row's routed
// experts' down products (their `eks` K splits) times their gates
// (ascending experts; an inactive row's experts were not run), then the
// shared expert's (its `ksplit` partials in `part`) times its gate, summed
// before they are added.
__device__ __noinline__ void moe_resid_phase(const Args& a, const float* part,
                                             int ksplit, int eks, int layer,
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
          for (int s = 0; s < eks; ++s)
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


// MoE: the routed experts' SwiGLU (their `eks` gate|up partials in epart
// -> their down x records in erec), then the shared expert's (its partials
// at `spart` -> rec).
__device__ __noinline__ void moe_act_phase(const Args& a, const int* experts,
                                           int nused, int eks,
                                           const float* spart) {
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
      swiglu_chunk(a, eg, eks, a.epart + (size_t)e * egs, r / ech, r % ech,
                   a.erec + (size_t)e * rgs, lane);
    } else {
      const int r = it - n_e;
      swiglu_chunk(a, a.st[kSgu], a.st[kSgu].ksplit, spart, r / sch, r % sch,
                   a.rec, lane);
    }
  }
}

// MoE router: one block a row. Its threads take the row's E (+ 1) router
// lanes, one lane a thread, each summing the lane's K-split partials
// (`split_sum`) into shared memory; then warp 0 takes the top-k
// (`route_top`). Each layer's choices stay in the scratch
// ([L][B][kMaxTopk]) until the step ends.
__device__ __noinline__ void gates_phase(const Args& a, int layer,
                                         float* smem) {
  const Stream& st = a.st[kRt];
  const int tid = threadIdx.x;
  const int lanes = a.E + a.has_sgate;
  float* lg_s = smem;                         // [kMaxLanes]
  const size_t stride = (size_t)a.B * st.ldo;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float* src = a.partial + (size_t)b * st.ldo;
    for (int e = tid; e < lanes; e += kThreads)
      lg_s[e] = split_sum(src, st.ksplit, stride, e);
    __syncthreads();
    if (tid < 32) {
      int idx[kMaxTopk];
      float w[kMaxTopk], sg;
      route_top(lg_s, a.E, a.k_top, a.norm_topk, a.has_shared, a.has_sgate,
                idx, w, sg);
      const size_t r = (size_t)layer * a.B + b;
      if (tid == 0) {
        for (int q = 0; q < a.k_top; ++q) {
          a.topk_e[r * kMaxTopk + q] = idx[q];
          a.topk_w[r * kMaxTopk + q] = w[q];
        }
        a.sgate[r] = sg;
      }
    }
    __syncthreads();
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

// The gates (`gates_phase`, blocks 0 .. B - 1) beside the shared expert's
// gate|up, whose items go round the other blocks: it needs only the norm,
// and the gates leave most of the grid idle.
template <int MT>
__device__ void moe_gates_phase(const Args& a, int layer, uint8_t* smem) {
  gates_phase(a, layer, reinterpret_cast<float*>(smem));
  if (!a.has_shared) return;
  const Stream& sg = a.st[kSgu];
  const Part p{&sg, a.rec, shared_gu_partial(a), nullptr, 0, 0, 1, sg.ksplit,
               sg.cps};
  product_parts<MT>(a, layer, &p, 1, a.B < (int)gridDim.x ? a.B : 0, smem);
}

// The gate|up (sid kGu, x from rec) or down (kDn, x from erec) product of
// the routed experts of `experts` (`nused` of them), K split `ks` x `cps`,
// into epart.
template <int MT>
__device__ void moe_experts_product(const Args& a, int sid, int layer,
                                    const int* experts, int nused, int ks,
                                    int cps, uint8_t* smem) {
  const Stream& st = a.st[sid];
  const bool up = sid == kGu;
  const Part p{&st, up ? a.rec : a.erec, a.epart, experts,
               up ? 0 : (size_t)(a.inter / kChunkK) * rec_bytes(a.mpad),
               (size_t)st.ksplit * a.B * st.ntot, nused, ks, cps};
  product_parts<MT>(a, layer, &p, 1, 0, smem);
}

// The routed experts' downs and the shared expert's as one item space.
template <int MT>
__device__ void moe_down_phase(const Args& a, int layer, const int* experts,
                               int nused, const int* sp, uint8_t* smem) {
  const Stream& ed = a.st[kDn];
  const Stream& sd = a.st[kSdn];
  const Part p[2] = {
      {&ed, a.erec, a.epart, experts,
       (size_t)(a.inter / kChunkK) * rec_bytes(a.mpad),
       (size_t)ed.ksplit * a.B * a.hid, nused, sp[kDnKs], sp[kDnCps]},
      {&sd, a.rec, a.partial, nullptr, 0, 0, 1, sp[kSdnKs], sp[kSdnCps]}};
  product_parts<MT>(a, layer, p, a.has_shared ? 2 : 1, 0, smem);
}

}  // namespace
