// Paged decode attention (one query token per slot), sm_90a: a page-tiled
// design that streams whole tiles of a KV head's tokens through shared
// memory and scores them with the tensor cores.
//
// Replaces: dashinfer_tpu/ops/pallas/paged_attention.py `paged_attention`
// (the Pallas `_kernel`), which models/transformer.py runs in every layer of
// every per-op decode step (and the per-op TP decode and the CUDA-graph
// per-op forward).
//
// Math: GQA -- query heads h*G .. (h+1)*G-1 read KV head h -- with an online
// softmax over the tokens t < lens[b] of the slot's pages; lens[b] == 0 gives
// an output of 0. Quantized KV (INT8, or UINT4 with halves packing per head:
// byte j holds dim j low and dim j + D/2 high) applies the affine after the
// dot, as the TPU kernel does:
//     q . k_t = (q . q_int_t) * scale_t + (sum_d q_d) * zero_t
// and on the V side  sum_t p_t v_t = sum_t (p_t scale_t) v_int_t + p_t zero_t.
//
// What bounds it on the H100: bytes. Per slot it reads each cached token's K
// and V once (KH * D payload bytes each, plus 16 bytes of qparams per head in
// the quantized modes) and does ~4 * H * D operations per token: about one
// operation per byte. The first design (one token a warp, a shuffle sum and
// two expf per token and head, four scalar qparam loads in the dependent
// chain) kept ~1 KB a block in flight and reached ~7% of the card's 3.35 TB/s.
//
// What this design does about it:
//  * One block per (chunk of tiles, KV head, slot): 8 warps where a head row
//    is at most 128 bytes (int8 / uint4 at D <= 128, the served pools), else
//    4; a tile is 16 tokens a warp, copied into a ring of 2-3 tiles in shared
//    memory, tens of KB in flight per SM. The chunk count comes from static
//    shapes alone (the wrapper: as many chunks as keep the grid within two
//    resident blocks an SM), so the launch is CUDA-graph capturable; chunks
//    past lens exit at once.
//  * The tiles themselves (di_attn_tile.cuh, shared with the decode
//    megakernel's attention phase): with bf16 q and a bf16 / int8 / uint4
//    pool, every G (1 included: on the card the tensor cores beat a
//    CUDA-core path there too: 0.042 ms against 0.073 a launch on a
//    long-context Qwen1.5-MoE state, B = 8, in one run), scores and P.V on
//    mma.sync with ONE online-softmax rescale per 16 tokens; f32 q or an f32
//    pool on the CUDA cores.
//  * The warps' states merge in shared memory; a single chunk writes the
//    output, otherwise each chunk writes (max, sum, acc) and `pa_combine`
//    merges them (log2 domain throughout).
//  What still bounds it: the int8 -> bf16 conversions and
//  the dependent chain of each warp's tile with two blocks an SM; ~28% of
//  the byte bound on the long-context state.

#include "di_attn_tile.cuh"

namespace {

using namespace di;

// Writes the block's merged state of its G heads: the output itself when the
// slot's sequence is one chunk, else the chunk's (max, sum, acc) partial.
// Reads the warps' states m_s / l_s [kWarps][kMaxG] and acc_s
// [kWarps][kMaxG][D] (acc with its zero term added).
template <typename QT, int D, int kWarps>
__device__ __forceinline__ void merge_write(
    const float* m_s, const float* l_s, const float* acc_s, int G, int b,
    int h, int H, int chunk, int n_chunks, QT* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc) {
  for (int idx = threadIdx.x; idx < G * D; idx += 32 * kWarps) {
    const int g = idx / D, d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kMaxG + g]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w * kMaxG + g] - mu);
      lsum += l_s[w * kMaxG + g] * f;
      o += acc_s[(w * kMaxG + g) * D + d] * f;
    }
    const size_t head = (size_t)b * H + h * G + g;
    if (n_chunks == 1) {
      store(out + head * D + d, lsum > 0.f ? o / lsum : 0.f);
    } else {
      const size_t slot = head * n_chunks + chunk;
      part_acc[slot * D + d] = o;
      if (d == 0) {
        part_ml[2 * slot] = mx;
        part_ml[2 * slot + 1] = lsum;
      }
    }
  }
}

// grid = (n_chunks, KH, B); block = kThreads; dynamic shared memory =
// Geo::kSmem. MMA: the tensor-core path (bf16 q on a bf16 / int8 / uint4
// pool, every G), else the CUDA-core path (f32 q or an f32 pool).
template <typename QT, int KIND, int D, bool MMA>
__global__ void __launch_bounds__(Geo<KIND, D>::kThreads)
pa_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ k_pool,
          const uint8_t* __restrict__ v_pool, const float* __restrict__ k_qp,
          const float* __restrict__ v_qp, int ql,
          const int* __restrict__ page_tables, int max_pages,
          const int* __restrict__ lens, QT* __restrict__ out,
          float* __restrict__ part_ml, float* __restrict__ part_acc, int H,
          int ps, int chunk_tokens, float scale_log2,
          unsigned long long* __restrict__ launches) {
  using Gm = Geo<KIND, D>;
  constexpr int kWarps = Gm::kWarps, kThreads = Gm::kThreads;
  extern __shared__ __align__(16) uint8_t smem[];

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, KH = gridDim.y;
  if (chunk == 0 && h == 0 && b == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  const int G = H / KH;
  const int t_begin = chunk * chunk_tokens;
  const int t_end = min(lens[b], t_begin + chunk_tokens);
  if (t_begin >= t_end) {   // block-uniform: nothing to attend here
    if (n_chunks == 1)
      for (int i = threadIdx.x; i < G * D; i += kThreads)
        store(out + ((size_t)b * H + h * G) * D + i, 0.f);
    return;
  }
  const int n_tiles = (t_end - t_begin + Gm::kTileT - 1) / Gm::kTileT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int* pt_row = page_tables + (size_t)b * max_pages;
  const QT* q_bh = q + ((size_t)b * H + h * G) * D;
  float* q_s = reinterpret_cast<float*>(smem + Gm::kQOff);   // [g][kQStride]
  float* qsum_s = reinterpret_cast<float*>(smem + Gm::kQsumOff);  // [g]

  const KvSrc kv{k_pool, v_pool, k_qp, v_qp, pt_row, ql, 1, 0, ps, h, KH};
  // the ring's first tiles fly before anything else
  att_prologue<KIND, D, false, kThreads>(smem, kv, t_begin, t_end, n_tiles);

  // ---- per-block query state -------------------------------------------
  constexpr int kSteps = D / 16;
  MmaQ<KIND, D> qm;
  qm.qsum_g = 0.f;
  if constexpr (MMA) {
    const bool real = gid < G;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d0 = kdim<KIND, D>(s, tig, 2 * hf);   // d0, d0 + 1
        uint32_t v = 0u;
        if (real)
          v = *reinterpret_cast<const uint32_t*>(q_bh + (size_t)gid * D + d0);
        qm.qa[s][hf] = v;
        qm.qsum_g +=
            __uint_as_float(v << 16) + __uint_as_float(v & 0xFFFF0000u);
      }
    }
    qm.qsum_g += __shfl_xor_sync(0xffffffffu, qm.qsum_g, 1);
    qm.qsum_g += __shfl_xor_sync(0xffffffffu, qm.qsum_g, 2);
  } else {
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      q_s[g * Gm::kQStride + d + (d >> 5)] = to_f32(q_bh[i]);
    }
    for (int g = warp; g < G; g += kWarps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += to_f32(q_bh[g * D + d]);
      s = warp_sum(s);
      if (lane == 0) qsum_s[g] = s;
    }
  }
  attend_tiles<KIND, D, MMA, false, kThreads, false>(smem, kv, t_begin, t_end,
                                                 n_tiles, G, scale_log2, qm);

  const float* m_s = reinterpret_cast<const float*>(smem);
  const float* l_s = m_s + kWarps * kMaxG;
  const float* acc_s = l_s + kWarps * kMaxG;
  merge_write<QT, D, kWarps>(m_s, l_s, acc_s, G, b, h, H, chunk, n_chunks,
                             out, part_ml, part_acc);
}

// Merges the chunks of each (slot b, query head): grid = B * H, block = D.
// A slot with lens 0 has no chunk and gets 0.
template <typename QT>
__global__ void pa_combine(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc,
                           const int* __restrict__ lens, QT* __restrict__ out,
                           int H, int D, int n_chunks, int chunk_tokens) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const int used = (lens[bh / H] + chunk_tokens - 1) / chunk_tokens;
  const float* ml = part_ml + (size_t)bh * n_chunks * 2;
  const float* acc = part_acc + (size_t)bh * n_chunks * D;
  float mx = -INFINITY;
  for (int c = 0; c < used; ++c) mx = fmaxf(mx, ml[2 * c]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float lsum = 0.f, o = 0.f;
  for (int c = 0; c < used; ++c) {
    const float f = exp2f(ml[2 * c] - mu);
    lsum += ml[2 * c + 1] * f;
    o += acc[(size_t)c * D + d] * f;
  }
  store(out + (size_t)bh * D + d, lsum > 0.f ? o / lsum : 0.f);
}

template <typename QT, int KIND, int D, bool MMA>
int launch_one(const void* q, const void* k_pool, const void* v_pool,
               const float* k_qp, const float* v_qp, int ql,
               const int* page_tables, int max_pages, const int* lens,
               void* out, float* part_ml, float* part_acc, int B, int H,
               int KH, int ps, int chunk_tokens, int n_chunks, float scale,
               unsigned long long* launches, cudaStream_t stream) {
  using Gm = Geo<KIND, D>;
  if (chunk_tokens % Gm::kTileT) return (int)cudaErrorInvalidValue;
  auto kern = pa_kernel<QT, KIND, D, MMA>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Gm::kSmem);
  const dim3 grid(n_chunks, KH, B);
  kern<<<grid, Gm::kThreads, Gm::kSmem, stream>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(k_pool),
      static_cast<const uint8_t*>(v_pool), k_qp, v_qp, ql, page_tables,
      max_pages, lens, static_cast<QT*>(out), part_ml, part_acc, H, ps,
      chunk_tokens, scale * kLog2e, launches);
  if (n_chunks > 1)
    pa_combine<QT><<<B * H, D, 0, stream>>>(part_ml, part_acc, lens,
                                            static_cast<QT*>(out), H, D,
                                            n_chunks, chunk_tokens);
  return (int)cudaGetLastError();
}

template <typename QT, int KIND>
int launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
             const float* k_qp, const float* v_qp, int ql,
             const int* page_tables, int max_pages, const int* lens,
             void* out, float* part_ml, float* part_acc, int B, int H,
             int KH, int ps, int chunk_tokens, int n_chunks, float scale,
             unsigned long long* launches, cudaStream_t stream) {
  // the tensor cores wherever the kinds allow: bf16 q on a bf16 / int8 /
  // uint4 pool, at every G
  constexpr bool kMma =
      sizeof(QT) == 2 && (KIND == kBF16 || KIND == kI8 || KIND == kU4);
#define DI_PA(D_)                                                           \
  return launch_one<QT, KIND, D_, kMma>(                                    \
      q, k_pool, v_pool, k_qp, v_qp, ql, page_tables, max_pages, lens, out, \
      part_ml, part_acc, B, H, KH, ps, chunk_tokens, n_chunks, scale,       \
      launches, stream)
  switch (D) {
    case 64: DI_PA(64);
    case 128: DI_PA(128);
    case 256: DI_PA(256);
  }
#undef DI_PA
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int launch_kind(int kind, int D, const void* q, const void* k_pool,
                const void* v_pool, const float* k_qp, const float* v_qp,
                int ql, const int* page_tables, int max_pages,
                const int* lens, void* out, float* part_ml, float* part_acc,
                int B, int H, int KH, int ps, int chunk_tokens, int n_chunks,
                float scale, unsigned long long* launches,
                cudaStream_t stream) {
#define DI_PA_KIND(K_)                                                      \
  return launch_d<QT, K_>(D, q, k_pool, v_pool, k_qp, v_qp, ql,              \
                          page_tables, max_pages, lens, out, part_ml,       \
                          part_acc, B, H, KH, ps, chunk_tokens, n_chunks,   \
                          scale, launches, stream)
  switch (kind) {
    case kF32: DI_PA_KIND(kF32);
    case kBF16: DI_PA_KIND(kBF16);
    case kI8: DI_PA_KIND(kI8);
    case kU4: DI_PA_KIND(kU4);
  }
#undef DI_PA_KIND
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: [B, H, D] bf16 (q_bf16=1) or f32; k_pool/v_pool: [P, ps, KH*Ds]
// of kv_kind (0 f32, 1 bf16, 2 int8, 3 uint4 halves-packed), 16-byte
// aligned; k_qp/v_qp: [P, 2*KH, ql] f32 (quantized kinds only, else null);
// page_tables: [B, max_pages] int32 physical page ids; lens: [B] int32.
// The sequence is cut into n_chunks chunks of chunk_tokens (a multiple of
// the kernel's tile: 32 for an f32 pool at D = 256, else 64); with
// n_chunks > 1, part_ml / part_acc are f32 scratch of B*H*n_chunks*2 and
// B*H*n_chunks*D floats (else unused). Requires D in {64, 128, 256} and
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
                                  int D, int ps, int chunk_tokens,
                                  int n_chunks, float scale,
                                  unsigned long long* launches,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH < 1 || H % KH || H / KH > kMaxG || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return launch_kind<__nv_bfloat16>(kv_kind, D, q, k_pool, v_pool,
                                      k_qp, v_qp, ql, page_tables, max_pages,
                                      lens, out, part_ml, part_acc, B, H, KH,
                                      ps, chunk_tokens, n_chunks, scale,
                                      launches, s);
  return launch_kind<float>(kv_kind, D, q, k_pool, v_pool, k_qp, v_qp,
                            ql, page_tables, max_pages, lens, out, part_ml,
                            part_acc, B, H, KH, ps, chunk_tokens, n_chunks,
                            scale, launches, s);
}
