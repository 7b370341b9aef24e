// The MoE phases of the decode megakernel (csrc/megakernel.cu), shared
// with the tensor-parallel MoE segment (csrc/tp_segments.cu): the residual
// update after a MoE layer, the routed experts' and the shared expert's
// SwiGLU, the router's gates (`route_row` a row) and the list of the
// experts some active row routes to. The expert products themselves are
// di_product.cuh's `product_experts`.

#pragma once

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

// MoE router: one block a row. Its threads take the row's E (+ 1) router
// lanes, one lane a thread, each summing the lane's K-split partials in
// split order, eight loads in flight (route_row's order), into shared
// memory; then warp 0 takes the top-k (`route_top`). Each layer's choices
// stay in the scratch ([L][B][kMaxTopk]) until the step ends.
__device__ __noinline__ void gates_phase(const Args& a, int layer,
                                         float* smem) {
  const Stream& st = a.st[kRt];
  const int tid = threadIdx.x, lane = tid & 31;
  const int lanes = a.E + a.has_sgate;
  float* lg_s = smem;                         // [kMaxLanes]
  const size_t stride = (size_t)a.B * st.ldo;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float* src = a.partial + (size_t)b * st.ldo;
    for (int e = tid; e < lanes; e += kThreads) {
      float v = 0.f;
      for (int s = 0; s < st.ksplit; s += 8) {
        float p[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          p[q] = s + q < st.ksplit ? __ldcg(src + (size_t)(s + q) * stride + e)
                                   : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) v += p[q];
      }
      lg_s[e] = v;
    }
    __syncthreads();
    if (tid < 32) {
      float lg[kRoutePer];
#pragma unroll
      for (int j = 0; j < kRoutePer; ++j) {
        const int e = lane + 32 * j;
        lg[j] = e < lanes ? lg_s[e] : 0.f;
      }
      int idx[kMaxTopk];
      float w[kMaxTopk], sg;
      route_top(lg, a.E, a.k_top, a.norm_topk, a.has_shared, a.has_sgate,
                idx, w, sg);
      if (lane == 0) {
        const size_t r = (size_t)layer * a.B + b;
        for (int j = 0; j < a.k_top; ++j) {
          a.topk_e[r * kMaxTopk + j] = idx[j];
          a.topk_w[r * kMaxTopk + j] = w[j];
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

}  // namespace
