// Fused LAMB update for Hopper (sm_90a): two passes over a (layers, P) view.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lamb_update.py:
//   lamb_moments_kernel  <- _moments_kernel (K1, pallas_call at :128)
//   lamb_apply_kernel    <- _apply_kernel   (K2, pallas_call at :161)
//
// Pass A (K1) reads x, g, m, v and writes m' = b1 m + (1-b1) g and
// v' = b2 v + (1-b2) g^2 in place.  It forms u = m' c1 / (sqrt(v' c2) + eps)
// + wd x and writes, per CUDA block, the partial sums of x^2 and u^2 into a
// (layers, nblocks) fp32 buffer.  The wrapper sums those per layer and turns
// them into the trust ratio phi(|x|)/|u| times lr_t with a few torch ops,
// as the JAX package does with plain jnp between its two pallas_calls.
// Pass B (K2) reads x, m', v' and the per-layer ratio, recomputes u, and
// writes x' = x - ratio u in the parameter's dtype, in place; it also writes
// per-block partial sums of (x' - x)^2 so the step's update norm needs no
// copy of the old parameters.
//
// Bound on an H100 SXM: the work has no matrix product and is elementwise
// plus a per-layer reduction, so it is bound by device-memory bytes.  For
// fp32 params and grads each element moves 4 B x (4 reads + 2 writes in A,
// 3 reads + 1 write in B) = 40 B: 13.3 GB for BERT-large's 333.3 M
// parameters, ~4.0 ms at 3.35 TB/s.  This simple design keeps that traffic
// and no more: one pass each, the ragged tail of a layer masked in the
// kernel instead of padded with copies, and no temporary the size of a
// parameter.  16-byte vector loads, a persistent grid and folding the small
// leaves into one launch are left for later.
//
// Determinism: the partial sums use warp shuffles and shared memory in a
// fixed order and no atomics, so every run gives the same bits.
//
// In place: each element of x, m and v is read and then written by the same
// thread and by no other, so updating the parameter and moment storage in
// place is safe.  Nothing is allocated here; c (the bias corrections
// 1/(1-b1^t), 1/(1-b2^t)) and the per-layer ratios come by device pointer,
// so the caller never waits on the host.
//
// The non-finite guard: ok (a device int, or null for "always") says whether
// the step is taken.  With *ok == 0, K1 still forms m', v' and u and writes
// its partial sums, but stores neither m nor v, and K2 stores no x and writes
// zero partials (its loop is skipped), so a skipped step leaves parameters
// and moments bit-identical with no copy of the state and no host sync.  The
// flag costs one 4-byte load, the same word for every thread of a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                   // elements per thread per block
constexpr int kChunk = kThreads * kItems;    // elements of a layer per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
// The value x takes once stored in T (the cast the parameter goes through).
__device__ __forceinline__ float round_to(const float*, float x) { return x; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block; the totals are valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = warp_sum(lane < kWarps ? sa[lane] : 0.f);
    b = warp_sum(lane < kWarps ? sb[lane] : 0.f);
  }
}

// grid (nblocks, layers): block (j, l) owns elements [j*kChunk, (j+1)*kChunk)
// of layer l; threads stride by kThreads so a warp's loads are contiguous.
template <typename TX, typename TG>
__global__ void __launch_bounds__(kThreads) lamb_moments_kernel(
    const TX* x, const TG* g, float* m, float* v, const float* c,
    const int* ok, float* xsq, float* usq, int64_t per_layer, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float eps, float wd) {
  const int64_t base = (int64_t)blockIdx.y * per_layer;
  const int64_t start = (int64_t)blockIdx.x * kChunk + threadIdx.x;
  const float c1 = c[0], c2 = c[1];
  const bool store = ok == nullptr || *ok != 0;
  float sx = 0.f, su = 0.f;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = start + (int64_t)k * kThreads;
    if (j < per_layer) {
      const int64_t i = base + j;
      const float xi = load_f32(x, i);
      const float gi = load_f32(g, i);
      const float mi = b1 * m[i] + one_minus_b1 * gi;
      const float vi = b2 * v[i] + one_minus_b2 * gi * gi;
      if (store) {
        m[i] = mi;
        v[i] = vi;
      }
      const float u = (mi * c1) / (sqrtf(vi * c2) + eps) + wd * xi;
      sx += xi * xi;
      su += u * u;
    }
  }
  block_sum2(sx, su);
  if (threadIdx.x == 0) {
    const int64_t cell = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    xsq[cell] = sx;
    usq[cell] = su;
  }
}

template <typename TX>
__global__ void __launch_bounds__(kThreads) lamb_apply_kernel(
    TX* x, const float* m, const float* v, const float* c, const float* ratio,
    const int* ok, float* dsq, int64_t per_layer, float eps, float wd) {
  if (ok != nullptr && *ok == 0) {   // skipped step: x untouched, no update
    if (threadIdx.x == 0) dsq[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = 0.f;
    return;
  }
  const int64_t base = (int64_t)blockIdx.y * per_layer;
  const int64_t start = (int64_t)blockIdx.x * kChunk + threadIdx.x;
  const float c1 = c[0], c2 = c[1];
  const float r = ratio[blockIdx.y];
  float sd = 0.f, unused = 0.f;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = start + (int64_t)k * kThreads;
    if (j < per_layer) {
      const int64_t i = base + j;
      const float xi = load_f32(x, i);
      const float u = (m[i] * c1) / (sqrtf(v[i] * c2) + eps) + wd * xi;
      const float xn = round_to(x, xi - r * u);
      store_f32(x, i, xn);
      const float d = xn - xi;
      sd += d * d;
    }
  }
  block_sum2(sd, unused);
  if (threadIdx.x == 0) dsq[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = sd;
}

template <typename TX, typename TG>
void launch_moments(const void* x, const void* g, float* m, float* v,
                    const float* c, const int* ok, float* xsq, float* usq, int64_t layers,
                    int64_t per_layer, float b1, float omb1, float b2,
                    float omb2, float eps, float wd, cudaStream_t stream) {
  const dim3 grid((unsigned)((per_layer + kChunk - 1) / kChunk), (unsigned)layers);
  lamb_moments_kernel<TX, TG><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g), m, v, c, ok, xsq, usq,
      per_layer, b1, omb1, b2, omb2, eps, wd);
}

}  // namespace

extern "C" {

// Elements of one layer that one block of either kernel covers; the caller
// sizes the (layers, ceil(P / chunk)) partial-sum buffers with it.
int lamb_chunk_elems() { return kChunk; }

// dtype codes: 0 = float32, 1 = bfloat16.  m, v are always float32.  ok is
// a device int (the step is taken unless it is 0) or null (always taken).
// Returns cudaGetLastError() after the launch (0 = launched).
int lamb_moments(const void* x, int x_dtype, const void* g, int g_dtype,
                 float* m, float* v, const float* c, const int* ok, float* xsq, float* usq,
                 int64_t layers, int64_t per_layer, double b1, double b2,
                 double eps, double wd, void* stream) {
  if (layers < 1 || layers > 65535 || per_layer < 1) return (int)cudaErrorInvalidValue;
  const float fb1 = (float)b1, omb1 = (float)(1.0 - b1);
  const float fb2 = (float)b2, omb2 = (float)(1.0 - b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0)
    launch_moments<float, float>(x, g, m, v, c, ok, xsq, usq, layers, per_layer, fb1, omb1, fb2, omb2, (float)eps, (float)wd, s);
  else if (x_dtype == 1 && g_dtype == 0)
    launch_moments<__nv_bfloat16, float>(x, g, m, v, c, ok, xsq, usq, layers, per_layer, fb1, omb1, fb2, omb2, (float)eps, (float)wd, s);
  else if (x_dtype == 0 && g_dtype == 1)
    launch_moments<float, __nv_bfloat16>(x, g, m, v, c, ok, xsq, usq, layers, per_layer, fb1, omb1, fb2, omb2, (float)eps, (float)wd, s);
  else if (x_dtype == 1 && g_dtype == 1)
    launch_moments<__nv_bfloat16, __nv_bfloat16>(x, g, m, v, c, ok, xsq, usq, layers, per_layer, fb1, omb1, fb2, omb2, (float)eps, (float)wd, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int lamb_apply(void* x, int x_dtype, const float* m, const float* v,
               const float* c, const float* ratio, const int* ok, float* dsq, int64_t layers,
               int64_t per_layer, double eps, double wd, void* stream) {
  if (layers < 1 || layers > 65535 || per_layer < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((per_layer + kChunk - 1) / kChunk), (unsigned)layers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    lamb_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(x), m, v, c, ratio, ok, dsq, per_layer, (float)eps, (float)wd);
  else if (x_dtype == 1)
    lamb_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(x), m, v, c, ratio, ok, dsq, per_layer, (float)eps, (float)wd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
