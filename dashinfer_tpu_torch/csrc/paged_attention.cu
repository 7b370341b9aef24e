// Paged decode attention (one query token per slot), sm_90a.
//
// Replaces: dashinfer_tpu/ops/pallas/paged_attention.py `paged_attention`
// (the Pallas `_kernel`), which models/transformer.py runs in every layer of
// every decode step.
//
// Math: GQA -- query heads h*G .. (h+1)*G-1 read KV head h -- with an online
// softmax over the tokens t < lens[b] of the slot's pages; lens[b] == 0 gives
// an output of 0. Quantized KV (INT8, or UINT4 with halves packing per head)
// applies the affine after the dot, as the TPU kernel does:
//     q . k_t = (q . q_int_t) * scale_t + (sum_d q_d) * zero_t
// and on the V side  sum_t p_t v_t = sum_t (p_t scale_t) v_int_t + p_t zero_t.
//
// What bounds it on the H100: bytes. Per slot it reads each cached token's K
// and V once (KH * D payload bytes each, plus 8 bytes of qparams per head in
// the quantized modes) and does ~4 * H * D operations per token: about one
// operation per byte.
//
// What this design does about it: the sequence is split into chunks of
// `split` tokens (flash-decoding), one block per (kv head, slot, chunk), so
// even a batch of 8 long sequences spreads over the SMs; the G query heads
// that share a KV head read it once. Inside a block each warp walks every 4th
// token of the chunk; a lane owns D/32 head dims, so a warp reads a token's
// head row as one contiguous segment, and the score is a warp-shuffle sum.
// Each warp keeps its own online-softmax state; the block merges its warps
// and writes the chunk's (max, sum, acc) to scratch, and a second kernel
// merges the chunks of each (slot, head). The page loop that the TPU runs as
// a sequential grid axis is a loop inside the block; chunks and pages past
// lens[b] are never read.

#include "di_common.cuh"

namespace {

using namespace di;

constexpr int kWarps = 4;
constexpr int kMaxG = 8;

// grid = (KH, B, n_chunks); block = 32 * kWarps threads;
// dynamic shared memory = kWarps * G * (D + 2) floats. Writes the chunk's
// merged state to part_ml [B, H, n_chunks, 2] and part_acc [B, H, n_chunks, D].
template <typename QT, int KIND, int DPL>
__global__ void __launch_bounds__(32 * kWarps)
pa_kernel(const QT* __restrict__ q, const void* __restrict__ k_pool,
          const void* __restrict__ v_pool, const float* __restrict__ k_qp,
          const float* __restrict__ v_qp, int ql,
          const int* __restrict__ page_tables, int max_pages,
          const int* __restrict__ lens, float* __restrict__ part_ml,
          float* __restrict__ part_acc, int H, int KH, int ps, int split,
          float scale, unsigned long long* __restrict__ launches) {
  constexpr int D = 32 * DPL;
  constexpr bool kQuant = KIND == kI8 || KIND == kU4;
  constexpr int Ds = KIND == kU4 ? D / 2 : D;
  extern __shared__ float smem[];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int chunk = blockIdx.z;
  const int n_chunks = gridDim.z;
  if (h == 0 && b == 0 && chunk == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  const int t_begin = chunk * split;
  const int t_end = min(lens[b], t_begin + split);
  if (t_begin >= t_end) return;   // block-uniform: nothing to attend here
  const int G = H / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_elems = (size_t)KH * Ds;

  float qv[kMaxG][DPL], qsum[kMaxG], m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qv[g][i] = g < G ? to_f32(q[((size_t)b * H + h * G + g) * D +
                                  dim_of<KIND, DPL>(lane, i)])
                       : 0.f;
      s += qv[g][i];
      acc[g][i] = 0.f;
    }
    qsum[g] = kQuant ? warp_sum(s) : 0.f;
    m[g] = -FLT_MAX;
    l[g] = 0.f;
  }

  for (int t = t_begin + warp; t < t_end; t += kWarps) {
    const int page = page_tables[(size_t)b * max_pages + t / ps];
    const int off = t % ps;
    const size_t base = ((size_t)page * ps + off) * row_elems + (size_t)h * Ds;
    float kv[DPL], vv[DPL];
    load_row<KIND, DPL>(k_pool, base, lane, kv);
    load_row<KIND, DPL>(v_pool, base, lane, vv);
    float ks = 1.f, kz = 0.f, vs = 1.f, vz = 0.f;
    if (kQuant) {
      const size_t qrow = ((size_t)page * 2 * KH + 2 * h) * ql + off;
      ks = k_qp[qrow];
      kz = k_qp[qrow + ql];
      vs = v_qp[qrow];
      vz = v_qp[qrow + ql];
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s = fmaf(qv[g][i], kv[i], s);
        s = warp_sum(s);
        if (kQuant) s = s * ks + qsum[g] * kz;
        s *= scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
        const float ps_ = p * vs, pz = p * vz;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[g][i] = acc[g][i] * alpha + (ps_ * vv[i] + pz);
      }
    }
  }

  // merge the warps' online-softmax states
  float* m_s = smem;                        // [kWarps][G]
  float* l_s = m_s + kWarps * G;            // [kWarps][G]
  float* acc_s = l_s + kWarps * G;          // [kWarps][G][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc_s[((size_t)warp * G + g) * D + dim_of<KIND, DPL>(lane, i)] =
            acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = -FLT_MAX;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w * G + g] - mx);
      lsum += l_s[w * G + g] * f;
      o += acc_s[((size_t)w * G + g) * D + d] * f;
    }
    const size_t slot = ((size_t)b * H + h * G + g) * n_chunks + chunk;
    part_acc[slot * D + d] = o;
    if (d == 0) {
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = lsum;
    }
  }
}

// Merges the chunks of each (slot b, query head): grid = B * H, block = D.
// A slot with lens 0 has no chunk and gets 0.
template <typename QT>
__global__ void pa_combine(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc,
                           const int* __restrict__ lens, QT* __restrict__ out,
                           int H, int D, int n_chunks, int split) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const int used = (lens[bh / H] + split - 1) / split;
  const float* ml = part_ml + (size_t)bh * n_chunks * 2;
  const float* acc = part_acc + (size_t)bh * n_chunks * D;
  float mx = -FLT_MAX;
  for (int c = 0; c < used; ++c) mx = fmaxf(mx, ml[2 * c]);
  float lsum = 0.f, o = 0.f;
  for (int c = 0; c < used; ++c) {
    const float f = expf(ml[2 * c] - mx);
    lsum += ml[2 * c + 1] * f;
    o += acc[(size_t)c * D + d] * f;
  }
  store(out + (size_t)bh * D + d, lsum > 0.f ? o / lsum : 0.f);
}

template <typename QT, int KIND>
int launch_dpl(int D, const void* q, const void* k_pool, const void* v_pool,
               const float* k_qp, const float* v_qp, int ql,
               const int* page_tables, int max_pages, const int* lens,
               void* out, float* part_ml, float* part_acc, int B, int H,
               int KH, int ps, int split, float scale,
               unsigned long long* launches, cudaStream_t stream) {
  const int n_chunks = (max_pages * ps + split - 1) / split;
  const dim3 grid(KH, B, n_chunks);
  const int threads = 32 * kWarps;
  const size_t smem = sizeof(float) * kWarps * (H / KH) * (D + 2);
#define DI_PA_LAUNCH(DPL_)                                                    \
  pa_kernel<QT, KIND, DPL_><<<grid, threads, smem, stream>>>(                 \
      static_cast<const QT*>(q), k_pool, v_pool, k_qp, v_qp, ql, page_tables, \
      max_pages, lens, part_ml, part_acc, H, KH, ps, split, scale, launches)
  switch (D) {
    case 64: DI_PA_LAUNCH(2); break;
    case 128: DI_PA_LAUNCH(4); break;
    case 256: DI_PA_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DI_PA_LAUNCH
  pa_combine<QT><<<B * H, D, 0, stream>>>(part_ml, part_acc, lens,
                                          static_cast<QT*>(out), H, D,
                                          n_chunks, split);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_kind(int kind, int D, const void* q, const void* k_pool,
                const void* v_pool, const float* k_qp, const float* v_qp,
                int ql, const int* page_tables, int max_pages,
                const int* lens, void* out, float* part_ml, float* part_acc,
                int B, int H, int KH, int ps, int split, float scale,
                unsigned long long* launches, cudaStream_t stream) {
  switch (kind) {
    case kF32:
      return launch_dpl<QT, kF32>(D, q, k_pool, v_pool, k_qp, v_qp, ql,
                                  page_tables, max_pages, lens, out,
                                  part_ml, part_acc, B, H, KH, ps, split,
                                  scale, launches, stream);
    case kBF16:
      return launch_dpl<QT, kBF16>(D, q, k_pool, v_pool, k_qp, v_qp, ql,
                                   page_tables, max_pages, lens, out,
                                   part_ml, part_acc, B, H, KH, ps, split,
                                   scale, launches, stream);
    case kI8:
      return launch_dpl<QT, kI8>(D, q, k_pool, v_pool, k_qp, v_qp, ql,
                                 page_tables, max_pages, lens, out,
                                 part_ml, part_acc, B, H, KH, ps, split,
                                 scale, launches, stream);
    case kU4:
      return launch_dpl<QT, kU4>(D, q, k_pool, v_pool, k_qp, v_qp, ql,
                                 page_tables, max_pages, lens, out,
                                 part_ml, part_acc, B, H, KH, ps, split,
                                 scale, launches, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out: [B, H, D] bf16 (q_bf16=1) or f32; k_pool/v_pool: [P, ps, KH*Ds]
// of kv_kind (0 f32, 1 bf16, 2 int8, 3 uint4 halves-packed); k_qp/v_qp:
// [P, 2*KH, ql] f32 (quantized kinds only, else null); page_tables:
// [B, max_pages] int32 physical page ids; lens: [B] int32; part_ml /
// part_acc: f32 scratch of B*H*n_chunks*2 and B*H*n_chunks*D floats, with
// n_chunks = ceil(max_pages * ps / split). Requires D in {64, 128, 256} and
// H / KH <= 8; launches: a device counter that each launch of pa_kernel
// adds one to (so CUDA graph replays count). The caller
// (ops/paged_attention.py) validates shapes. Returns cudaGetLastError().
extern "C" int di_paged_attention(const void* q, int q_bf16,
                                  const void* k_pool, const void* v_pool,
                                  int kv_kind, const float* k_qp,
                                  const float* v_qp, int ql,
                                  const int* page_tables, int max_pages,
                                  const int* lens, void* out, float* part_ml,
                                  float* part_acc, int B, int H, int KH,
                                  int D, int ps, int split, float scale,
                                  unsigned long long* launches,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch_kind<__nv_bfloat16>(kv_kind, D, q, k_pool, v_pool, k_qp,
                                      v_qp, ql, page_tables, max_pages, lens,
                                      out, part_ml, part_acc, B, H, KH, ps,
                                      split, scale, launches, s);
  return launch_kind<float>(kv_kind, D, q, k_pool, v_pool, k_qp, v_qp, ql,
                            page_tables, max_pages, lens, out, part_ml,
                            part_acc, B, H, KH, ps, split, scale, launches, s);
}
