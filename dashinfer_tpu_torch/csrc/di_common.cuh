// Device code shared by the kernels of this directory (sm_90a): type
// helpers, warp reductions, cp.async, 1-D bulk copies (TMA) completing on
// mbarriers, ldmatrix, the mma.sync m16n8k16 dot, int8 / u4 levels made
// bf16 in registers, quant_matmul's B fragments made from row-major u4 /
// int8 payload, the KV-pool row loads of the attention kernels, and the
// grid-wide barrier of the persistent (megakernel) grids.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace di {

constexpr int kMaxG = 8;                  // query heads per KV head

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr unsigned long long kBarrierTimeoutNs = 4000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mbarriers in shared memory and the 1-D bulk copy (cp.async.bulk, the
// TMA's linear mode) that completes on one: a stage's "full" barrier is
// armed with the bytes its copies bring (arrive.expect_tx) and completes
// when they have landed; its "empty" barrier completes when every consumer
// warp has arrived. A barrier's phase parity flips each time it completes.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// the barriers' initialisation, visible to the copy engine
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's earlier shared-memory accesses, ordered before later bulk
// copies into the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// status value of a ring wait that gave up (a grid barrier's is phase + 1)
constexpr int kRingTimeout = -1;
// Waits for phase `parity` of `bar` to complete. Bounded like the grid
// barrier: after kBarrierTimeoutNs it marks `status` (kRingTimeout) and
// returns, and once `status` holds a fault every wait returns at once, so
// a fault ends the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity,
                                          int* status) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned spins = 0;
  unsigned long long t0 = 0;
  while (!mbar_try_wait(bar, parity)) {
    if ((++spins & 0xFFu) == 0) {
      if (*reinterpret_cast<volatile int*>(status) != 0) return;
      const unsigned long long now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kBarrierTimeoutNs) {
        atomicCAS(status, 0, kRingTimeout);
        return;
      }
    }
  }
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory into mma fragments (lane i gives
// the address of row i % 8 of matrix i / 8); `_trans` transposes each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_ptr) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v)));
}

// Byte i of a word whose bytes were xor'ed with 0x80, as the exact int8
// value in f32 (2^23 + (x + 128), less 2^23 + 128).
__device__ __forceinline__ float i8_level(uint32_t w_flipped, int i) {
  return __int_as_float(__byte_perm(w_flipped, 0x4B000000u, i | 0x7650)) -
         8388736.f;
}

// u4 levels of bytes 0 and 2 of `pair`, each in its bf16 half as
// bf16(128 + n) = 0x4300 | n: the low nibbles (u4_lo) or the high (u4_hi).
__device__ __forceinline__ uint32_t u4_lo(uint32_t pair) {
  return (pair & 0x000F000Fu) | 0x43004300u;
}
__device__ __forceinline__ uint32_t u4_hi(uint32_t pair) {
  return ((pair >> 4) & 0x000F000Fu) | 0x43004300u;
}

// B fragments of one k16 step for the low- and high-column mma tiles of a
// 256-column weight tile staged in shared memory, `row_bytes` per K row:
// rows r, r+1 (b0) and r+8, r+9 (b1), lower k in the low half.
//   BITS 4: byte `col` holds columns col (low nibble) and col + 128 (high);
//           level n -> bf16(128 + n) = 0x4300 | n (the caller takes the
//           128 * sum(x) back off in the group affine);
//   BITS 8: int8 at byte col and col + 128, exact in bf16.
template <int BITS>
__device__ __forceinline__ void b_frags(const uint8_t* w_s, int row_bytes,
                                        int r, int col, uint32_t (&lo)[2],
                                        uint32_t (&hi)[2]) {
  if (BITS == 4) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r + 8 * i;
      const uint32_t pair = static_cast<uint32_t>(w_s[rr * row_bytes + col]) |
                            (static_cast<uint32_t>(
                                 w_s[(rr + 1) * row_bytes + col]) << 16);
      lo[i] = (pair & 0x000F000Fu) | 0x43004300u;
      hi[i] = ((pair >> 4) & 0x000F000Fu) | 0x43004300u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r + 8 * i;
      const int8_t* p0 = reinterpret_cast<const int8_t*>(w_s + rr * row_bytes);
      const int8_t* p1 = p0 + row_bytes;
      lo[i] = bf16_bits((float)p0[col]) | (bf16_bits((float)p1[col]) << 16);
      hi[i] = bf16_bits((float)p0[col + 128]) |
              (bf16_bits((float)p1[col + 128]) << 16);
    }
  }
}

// KV pool payload kinds (the wrappers pass these numbers).
enum KvKind { kF32 = 0, kBF16 = 1, kI8 = 2, kU4 = 3 };

// Loads the DPL head dims this lane owns from one token's head row.
// Lane l owns dims l*DPL .. l*DPL+DPL-1, except under UINT4, where it owns
// the bytes l*DPL/2 .. and so dims (lo) l*DPL/2 + i and (hi) D/2 + l*DPL/2 + i.
template <int KIND, int DPL>
__device__ __forceinline__ void load_row(const void* pool, size_t base,
                                         int lane, float (&v)[DPL]) {
  if (KIND == kF32) {
    const float* p = static_cast<const float*>(pool) + base + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) v[i] = p[i];
  } else if (KIND == kBF16) {
    const __nv_bfloat16* p =
        static_cast<const __nv_bfloat16*>(pool) + base + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) v[i] = __bfloat162float(p[i]);
  } else if (KIND == kI8) {
    const int8_t* p = static_cast<const int8_t*>(pool) + base + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) v[i] = (float)p[i];
  } else {
    const uint8_t* p =
        static_cast<const uint8_t*>(pool) + base + lane * (DPL / 2);
#pragma unroll
    for (int i = 0; i < DPL / 2; ++i) {
      const uint8_t b = p[i];
      v[i] = (float)(b & 0xF);
      v[i + DPL / 2] = (float)(b >> 4);
    }
  }
}

// The head dim of register i of lane `lane` under load_row's ownership.
template <int KIND, int DPL>
__device__ __forceinline__ int dim_of(int lane, int i) {
  if (KIND == kU4)
    return i < DPL / 2 ? lane * (DPL / 2) + i
                       : 16 * DPL + lane * (DPL / 2) + (i - DPL / 2);
  return lane * DPL + i;
}

// Grid-wide barrier of a persistent grid whose blocks are all co-resident:
// every block arrives, block 0's arrival carries the complement so that the
// counter's top bit flips when all have arrived. The fences make what the
// blocks wrote before it visible after it. A wait longer than
// kBarrierTimeoutNs marks `status` with the phase and lets every block run
// to the end, so a grid that is not co-resident ends as an error and not as
// a hang. With a trace buffer, block 0 stamps the end of its part of the
// phase (trace[2 phase + 1]) and the time it leaves the barrier
// (trace[2 phase + 2]): the difference is what the phase's slowest block
// and the barrier itself add.
__device__ __forceinline__ void grid_barrier(unsigned* barrier, int* status_p,
                                             unsigned long long* trace,
                                             int phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (trace != nullptr && blockIdx.x == 0)
      trace[2 * phase + 1] = global_ns();
    volatile unsigned* arrived = barrier;
    volatile int* status = status_p;
    const unsigned nb =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(barrier, nb);
    unsigned spins = 0;
    unsigned long long t0 = 0;
    while (((old ^ *arrived) & 0x80000000u) == 0) {
      if ((++spins & 0x3FFu) == 0) {
        if (*status != 0) break;
        const unsigned long long now = global_ns();
        if (t0 == 0) {
          t0 = now;
        } else if (now - t0 > kBarrierTimeoutNs) {
          atomicCAS(status_p, 0, phase + 1);
          break;
        }
      }
    }
    __threadfence();
    if (trace != nullptr && blockIdx.x == 0)
      trace[2 * phase + 2] = global_ns();
  }
  __syncthreads();
}

}  // namespace di
