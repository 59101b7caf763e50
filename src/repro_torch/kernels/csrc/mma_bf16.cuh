// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the
// kernels of flash_attention.cu and fused_ce.cu: 16-byte cp.async staging,
// ldmatrix, mma.sync.m16n8k16 (bf16 in, fp32 accumulate), and the split of
// fp32 accumulator values into bf16 terms for a second product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with in = false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's most recent groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.  Without .trans lane l receives row l / 4,
// columns 2 (l % 4) + {0, 1} of each; with .trans the transpose's.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), d 16 x 8 fp32.  Lane l
// (g = l / 4, t = l % 4) holds a: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); b: (2t.., g), (2t + 8.., g); d: (g, 2t..), (g + 8, 2t..).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// One A register of (x0, x1) as P bf16 terms, x ~ t[0] + ... + t[P - 1]:
// t[0] = bf16(x), t[1] = bf16(x - t[0]), ...; the remainders are exact in
// fp32, so P terms keep ~8P mantissa bits (all 24 of fp32 at P = 3).  The
// terms land P registers apart by 4 (t[0], t[4], ...): the same register of
// P A fragments.
template <int P>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    t[i * 4] = bits(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// The A operand of k-chunk kc (columns 16 kc .. 16 kc + 15) from fp32
// accumulator tiles c (16 x 8 each, C layout), as P bf16 terms a[i].
template <int P, int N>
__device__ __forceinline__ void a_from_acc(const float (&c)[N][4], int kc, uint32_t (&a)[P][4]) {
  split_pair<P>(c[2 * kc][0], c[2 * kc][1], &a[0][0]);
  split_pair<P>(c[2 * kc][2], c[2 * kc][3], &a[0][1]);
  split_pair<P>(c[2 * kc + 1][0], c[2 * kc + 1][1], &a[0][2]);
  split_pair<P>(c[2 * kc + 1][2], c[2 * kc + 1][3], &a[0][3]);
}

}  // namespace
