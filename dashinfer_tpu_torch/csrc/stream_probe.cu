// Weight-stream rate probe, sm_90a.
//
// Replaces: dashinfer_tpu/tools/bench_stream.py `build` / `build_loop` (the
// Pallas probes of the rate at which one launch streams a weight-sized
// buffer per payload format). Their `replica` variant is the decode
// megakernel itself with its attention phases skipped (csrc/megakernel.cu,
// `skip_attn`).
//
// Two kernels, both a persistent grid (SMs x co-resident blocks) that walks
// the whole buffer once:
//   sp_copy     reads the buffer with 16-byte loads and returns per-block
//               wrap-around sums of its 32-bit words: the rate at which the
//               card streams bytes it does nothing with;
//   sp_product  the megakernel's product phase (csrc/di_product.cuh:
//               weights as the mma's A operand, fed by a bulk-copy ring)
//               on one weight leaf: x [B, K] against bf16 / int8
//               per-channel / int8 group-wise / u4 group-wise payload,
//               split-K partial sums out: the ceiling of a megakernel
//               weight phase of that format.
// What bounds them: bytes; the probe exists to measure how close to the
// card's memory rate each format's dequantize-and-dot keeps the stream.
// sp_records lays x out as the product's x records once, outside the timing.

#include "di_product.cuh"

namespace {

using namespace di;

// the product ring's fault word (a wait that gave up: kRingTimeout); it
// stays set for the life of the process
__device__ int sp_status;

__global__ void __launch_bounds__(kThreads)
sp_copy(const uint4* __restrict__ buf, long long n_vec,
        unsigned* __restrict__ block_sums,
        unsigned long long* __restrict__ launches) {
  __shared__ unsigned red[kWarps];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  unsigned acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const uint4 v = __ldcs(buf + i);
    acc += v.x + v.y + v.z + v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int i = 0; i < kWarps; ++i) t += red[i];
    block_sums[blockIdx.x] = t;
  }
}

// x [B, K] bf16 -> x records; one warp per (row, 64-wide chunk).
__global__ void __launch_bounds__(kThreads)
sp_records(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ rec,
           int B, int K, int mpad) {
  const int lane = threadIdx.x & 31;
  const int chunks = K / kChunkK;
  const int nw = gridDim.x * kWarps;
  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); it < B * chunks;
       it += nw) {
    const int m = it / chunks, c = it % chunks;
    const __nv_bfloat16* p = x + (size_t)m * K + c * kChunkK + 2 * lane;
    write_record(rec, mpad, c, m, lane, __bfloat162float(p[0]),
                 __bfloat162float(p[1]));
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
sp_product(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.launches, 1ull);
  product<MT>(a, 0, 0, a.partial, smem);
}

template <typename F>
int resident_grid(F kernel, int device, int smem) {
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaSuccess;
  if (smem > 0)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * per_sm;
}

}  // namespace

// Blocks of the persistent grid of sp_copy (mpad = 0) or of sp_product for a
// batch padded to mpad rows. Returns 0 on error.
extern "C" int di_stream_probe_grid(int device, int mpad) {
  if (mpad == 0) return resident_grid(sp_copy, device, 0);
  return mpad > 16
             ? resident_grid(sp_product<2>, device, product_smem_bytes(2))
             : resident_grid(sp_product<1>, device, product_smem_bytes(1));
}

// buf: n_bytes (a multiple of 16) to read once; block_sums: [grid] u32.
extern "C" int di_stream_probe_copy(const void* buf, long long n_bytes,
                                    unsigned* block_sums, int grid,
                                    unsigned long long* launches,
                                    void* stream) {
  sp_copy<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), n_bytes / 16, block_sums, launches);
  return (int)cudaGetLastError();
}

// x: [B, K] bf16 -> rec (the product's x records, mpad rows per chunk).
extern "C" int di_stream_probe_records(const void* x, void* rec, int B, int K,
                                       int mpad, void* stream) {
  const int items = B * (K / kChunkK);
  const int blocks = (items + kWarps - 1) / kWarps;
  sp_records<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(rec), B, K,
      mpad);
  return (int)cudaGetLastError();
}

// One product over one leaf: `sa` is the stream as fill_stream reads it;
// out: [ksplit, B, N] f32 partial sums. Returns cudaGetLastError().
// variant: 0 = the product; 1-4 leave parts of it out to bisect where a
// format's time goes (Args::probe; their sums mean nothing).
extern "C" int di_stream_probe_product(const long long* sa, const void* rec,
                                       float* out, int B, int mpad, int grid,
                                       int variant,
                                       unsigned long long* launches,
                                       void* stream) {
  Args a;
  fill_stream(a.st[0], sa);
  a.rec = static_cast<uint8_t*>(const_cast<void*>(rec));
  a.partial = out;
  a.launches = launches;
  a.trace = nullptr;
  if (cudaGetSymbolAddress(reinterpret_cast<void**>(&a.status), sp_status) !=
      cudaSuccess)
    return (int)cudaGetLastError();
  a.B = B;
  a.mpad = mpad;
  a.probe = variant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mpad > 16) {
    const int smem = product_smem_bytes(2);
    cudaFuncSetAttribute(sp_product<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sp_product<2><<<grid, kThreads, smem, s>>>(a);
  } else {
    const int smem = product_smem_bytes(1);
    cudaFuncSetAttribute(sp_product<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sp_product<1><<<grid, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
