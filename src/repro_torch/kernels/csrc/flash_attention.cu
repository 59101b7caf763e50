// Differentiable flash attention for Hopper (sm_90a): forward, dq, dk/dv.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_mma_kernel (bf16), flash_fwd_kernel (fp32), and past head dim
//   256 flash_fwd_wide_mma_kernel, flash_fwd_wide_kernel
//                     <- _fwd_kernel (K3, pallas_call at :313)
//   flash_dq_mma_kernel (bf16), flash_dq_kernel (fp32), flash_dq_wide_*
//                     <- _dq_kernel  (K4, pallas_call at :360)
//   flash_dkv_mma_kernel (bf16), flash_dkv_kernel (fp32), flash_dkv_wide_*
//                     <- _dkv_kernel (K5, pallas_call at :386)
//
// What they compute, for q (B, H, S, D) and k, v (B, Hkv, T, D), q head h
// reading kv head h / (H / Hkv) (GQA: k and v are never repeated):
//   K3: s = scale q k^T under the mask, online softmax over kv tiles with a
//       running row max m and sum l; o = (p v) / l and lse = m + log l.
//   K4: p = exp(s - lse) rebuilt under the mask, dp = do v^T,
//       ds = p (dp - di) with di = rowsum(o do) taken by the caller;
//       dq = scale ds k.
//   K5: the same p and ds, transposed: dv = p^T do and dk = scale ds^T q,
//       summed over every q head of the kv head's group and every q tile.
// Masks (the JAX package's _mask_conds): causal keeps col <= row + (T - S),
// a sliding window keeps col > row + (T - S) - window, and use_valid keeps
// col < valid[b] (the caller clips valid to [1, T]).  A masked score is the
// finite -1e30, never -inf, so a row masked entirely sees exp(0) = 1 in the
// rescale and no NaN; its p is forced to 0, so it gives o = 0, lse ~ -1e30
// and zero gradients.  The ragged tails of S and T are masked here: the
// caller pads nothing.
//
// Two designs, chosen by dtype in launch_pass (not a fallback: a call of one
// dtype never reaches the other's kernels):
//   bf16: all three run on the tensor cores (flash_fwd_mma_kernel,
//     flash_dq_mma_kernel, flash_dkv_mma_kernel).
//   fp32: all three on fp32 FMA kernels.  The reference multiplies fp32
//     inputs in fp32; the tensor cores would make that TF32, another
//     function.
//
// Bound on an H100 SXM.  At BERT-large's shape (B 32, H 16, S = T 128,
// D 64, bf16) each pass reads and writes a few (B, H, S, D) tensors of
// 8.4 MB: 34 MB (K3), 42 MB (K4), 51 MB (K5), 10-15 us at 3.35 TB/s
// (K3 0.0101 ms, K5 0.0152 ms), against 2.1-4.3 GFLOP, 2-4 us at the
// 989 TFLOP/s of bf16 tensor cores: bound by bytes.  At S = 512 the work
// grows as S^2: K5's 34 GFLOP take 0.0347 ms, more than its bytes, so it is
// bound by operations; K3 (17 GFLOP, 0.0174 ms) stays just under its bytes
// (0.0202 ms).
//
// The tensor-core design (bf16).  The TPU kernels walk a sequential kv (or
// q) grid axis and carry their accumulators in VMEM from one grid step to
// the next; on Hopper the blocks run in parallel and nothing carries over,
// so that axis is a loop inside one block.  A block has 4 warps; each warp
// owns 16 rows (one m16 tile of mma.sync.m16n8k16, bf16 in, fp32
// accumulate):
//   K3: one block per (b*h, 64-row q tile).  The warp's q fragments stay in
//     registers for the whole kv loop.  s = q k^T on the tensor cores, the
//     online softmax on the fp32 accumulator registers (row max and sum over
//     the quad of lanes that shares a row, by shuffles; masks on fragment
//     coordinates, the same keep and kv_range as the FMA kernels), then
//     o += p v on the tensor cores.  o leaves as bf16 through shared memory
//     in 16-byte stores, lse as fp32.
//   K4: K3's blocks, ring and ownership; the warp's q fragments stay in
//     registers (at D <= 64), do in shared memory.  s = q k^T and dp = do v^T on the
//     tensor cores, p = exp(scale s - lse) and ds = p (dp - di) in
//     registers, then dq += ds k on the tensor cores; the block owns its dq
//     tile (no atomics).
//   K5: one block per (b*hkv, 64-row kv tile), looping over (q head of the
//     group x q tile of 64 rows, 32 at D 128 for registers); it owns its
//     dk/dv tile, so there are no atomics and every run gives the same bits.
//     k and v stay in shared memory; q, do, lse and di stream through a
//     two-stage ring.  s^T = k q^T and dp^T = v do^T on the tensor cores,
//     p^T = exp(scale s^T - lse) and ds^T = p^T (dp^T - di) in registers,
//     then dv += p^T do and dk += ds^T q on the tensor cores; dk and dv
//     stay in fp32 registers to the end.
// p and ds enter the second products as sums of bf16 terms (t0 = bf16(x),
// t1 = bf16(x - t0), ...), one mma per term: the reference keeps them in
// fp32, and ds = p (dp - di) cancels, so one bf16 p or ds (8 bits) would
// miss the fp32-level agreement the tests hold the kernels to.  K4 and K5
// take two terms (~16 bits; the CPU emulation of K4's dq with one term lands
// 43-108 times past the fp32 tolerance, with two within 0.2 of it).  K3
// takes three (all 24): o leaves as bf16, and its
// rounding feeds di = rowsum(o do) and through the cancelling dp - di the dq
// of rows that see few keys; with two terms o's fp32 value sits ~2^-18 off
// the reference's, more of o's elements round to the other neighbouring
// bf16 value, and that moved such dq past one bf16 ulp on the card (D 16,
// causal, MQA).  The operands come straight from the accumulator registers:
// the m16n8 C layout of two neighbouring n-tiles is the m16n8k16 A layout.
// bf16 x bf16 products are exact in fp32, so q k^T and do v^T differ from
// the reference only in the order of the sums.  Tiles are bf16 in shared
// memory, copied by cp.async in 16-byte pieces (ragged rows zero-filled)
// and read by ldmatrix (.trans where the operand is the transposed side);
// rows are padded by 16 bytes so that the 8 rows of an ldmatrix phase fall
// on distinct banks.  So the bf16 kernels need 16-byte aligned base
// pointers and (b, h, s) strides that are multiples of 8 elements; the
// wrapper checks that and raises.  Against the bound: the tiles move as
// bf16 (half of the FMA design's fp32 tiles), each input row is read once
// per block and each output row written once; the blocks are short (two
// tiles each at seq 128), so launch bounds size the kernels for 3 blocks
// per SM, whose loads overlap each other's products, and the work beside
// the products is kept small: a tile with no masked entry (every tile of the
// main path) skips the mask, and p = exp(scale s - m) is one fma into exp2f
// (exp2(s scale log2 e - m log2 e)).  mma.sync rather than wgmma: at seq 128
// the kernels are bound by bytes, where wgmma's rate buys nothing; wgmma,
// TMA loads and warp specialisation are later work.
//
// The FMA design (fp32 inputs): K3 and K4 take one block of 256 threads per
// (b*h, 64-row q tile), K5 one per (b*hkv, 64-row kv tile), with the same
// loops and ownership as above.  The threads form a
// 16 x 16 grid; each owns 4 rows x 4 columns of the 64 x 64 score tile and
// 4 rows x D/16 columns of its accumulators, in registers.  Row max and row
// sum reduce over the 16 threads of a half warp with shuffles.  Tiles are
// held in fp32 in dynamic shared memory (up to 162 KB at D = 128) with rows
// padded by one float so that column reads do not conflict on banks.  p and
// ds stay fp32, as the TPU kernel keeps them.
//
// Head dims 16, 32, 64, 128 and 256 are built, and past 256 the wide
// kernels (below) take any multiple of 128; the wrapper zero-pads any other
// head dim up to the next of them.  At D 256 the tensor-core kernels
// keep 64-row tiles but split the output columns over two blocks (grid z,
// mma_out): each block forms the scores over all of D and accumulates 128
// columns of o, dq, or dk and dv, so that the fp32 accumulators stay within
// the registers of D 128 (K3 also reads q's fragments from shared memory
// there, as K4 does above D 64); the scores are formed twice, so K3 does
// 1.5 times the products of one block over all D, and K4 and K5 too.  The
// FMA kernels take 32-row tiles at D 256 (fma_rows): 64-row fp32 tiles of
// q, k, v and do would outgrow shared memory.
//
// Layouts: every 4-D tensor is read through its (b, h, s) element strides
// with a contiguous last dim, so a (B, S, H, D) model tensor is taken as a
// (B, H, S, D) view without a copy.  lse and di are contiguous fp32
// (B, H, S); valid may be null when use_valid is 0.  Nothing is allocated
// here and nothing synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // q rows of a tensor-core tile
constexpr int kBK = 64;            // kv rows of a tensor-core tile
constexpr float kNegInf = -1e30f;

// Rows of the FMA kernels' square score tile a thread owns in each
// dimension: the 16 x 16 threads cover 16 R x 16 R; R = 2 (32-row tiles) at
// D 256, where 64-row fp32 tiles of q, k, v and do outgrow shared memory.
template <int D>
__host__ __device__ constexpr int fma_rows() { return D <= 128 ? 4 : 2; }

struct Strides {
  int64_t b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  const int* valid;
  void* o;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int B, H, Hkv, S, T, D;
  float scale;
  int causal, window, use_valid;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + R) of a (n, D) slab with row stride ss into smem (row
// stride D + 1) as fp32; rows at or past n read as 0.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* sm, const T* base, int64_t ss, int r0, int n) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D, row = r0 + r;
    sm[r * (D + 1) + c] = row < n ? ld(base + (int64_t)row * ss + c) : 0.f;
  }
}

__device__ __forceinline__ int kv_end_of(const Args& a, int b) {
  return a.use_valid ? min(a.valid[b], a.T) : a.T;
}

// The keep-mask of one (row, col) entry; kv_end folds the T tail and valid.
__device__ __forceinline__ bool keep(const Args& a, int row, int col, int kv_end) {
  const int off = a.T - a.S;
  return col < kv_end && (!a.causal || col <= row + off) &&
         (!a.window || col > row + off - a.window);
}

// kv range [lo, hi) that holds any unmasked entry for q rows [q0, q0 + bq).
__device__ __forceinline__ void kv_range(const Args& a, int q0, int bq, int kv_end, int& lo,
                                         int& hi) {
  const int off = a.T - a.S, q_last = min(q0 + bq, a.S) - 1;
  hi = a.causal ? min(kv_end, q_last + off + 1) : kv_end;
  lo = a.window ? max(0, q0 + off - a.window + 1) : 0;
}

// ---------------------------------------------------------------------------
// K3: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int R = fma_rows<D>(), BT = 16 * R, LDP = BT + 1, LDD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BT * LDD;
  float* sV = sK + BT * LDD;
  float* sP = sV + BT * LDD;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  load_tile<T, D, BT>(sQ, q, a.sq.s, q0, a.S);

  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, BT, kv_end, lo, hi);
  for (int kv0 = (lo / BT) * BT; kv0 < hi; kv0 += BT) {
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    load_tile<T, D, BT>(sK, k, a.sk.s, kv0, a.T);
    load_tile<T, D, BT>(sV, v, a.sv.s, kv0, a.T);
    __syncthreads();
    float s[R][R] = {};
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qa[R], kb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qa[i] = sQ[(ty + 16 * i) * LDD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) kb[j] = sK[(tx + 16 * j) * LDD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[R];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[j] = keep(a, row, kv0 + tx + 16 * j, kv_end);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BT; ++kk) {
      float pa[R], vb[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) pa[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = sV[kk * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

  T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) st(o + row * a.so.s + tx + 16 * j, acc[i][j] / lc);
    if (tx == 0) a.lse_out[(int64_t)bh * a.S + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// K4: dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int R = fma_rows<D>(), BT = 16 * R, LDP = BT + 1, LDD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BT * LDD;   // do
  float* sK = sO + BT * LDD;
  float* sV = sK + BT * LDD;
  float* sS = sV + BT * LDD;   // ds
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  load_tile<T, D, BT>(sQ, q, a.sq.s, q0, a.S);
  load_tile<T, D, BT>(sO, dout, a.sdo.s, q0, a.S);

  float lse[R], di[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < a.S ? a.lse[(int64_t)bh * a.S + row] : 0.f;
    di[i] = row < a.S ? a.di[(int64_t)bh * a.S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, BT, kv_end, lo, hi);
  for (int kv0 = (lo / BT) * BT; kv0 < hi; kv0 += BT) {
    __syncthreads();
    load_tile<T, D, BT>(sK, k, a.sk.s, kv0, a.T);
    load_tile<T, D, BT>(sV, v, a.sv.s, kv0, a.T);
    __syncthreads();
    float s[R][R] = {}, dp[R][R] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[R], oa[R], kb[R], vb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qa[i] = sQ[(ty + 16 * i) * LDD + d];
        oa[i] = sO[(ty + 16 * i) * LDD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kb[j] = sK[(tx + 16 * j) * LDD + d];
        vb[j] = sV[(tx + 16 * j) * LDD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool ok = row < a.S && keep(a, row, kv0 + tx + 16 * j, kv_end);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BT; ++kk) {
      float da[R], kb[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) da[i] = sS[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = sK[kk * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) st(dq + row * a.sdq.s + tx + 16 * j, a.scale * acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K5: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int R = fma_rows<D>(), BT = 16 * R, LDP = BT + 1, LDD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LDD;
  float* sQ = sV + BT * LDD;
  float* sO = sQ + BT * LDD;   // do
  float* sP = sO + BT * LDD;   // p^T: kv rows x q cols
  float* sS = sP + BT * LDP;   // ds^T
  float* sL = sS + BT * LDP;   // lse of the q tile's rows
  float* sD = sL + BT;         // di of the q tile's rows
  const int n = blockIdx.x, b = n / a.Hkv, kvh = n % a.Hkv, group = a.H / a.Hkv;
  const int k0 = blockIdx.y * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b), off = a.T - a.S;
  load_tile<T, D, BT>(sK, k, a.sk.s, k0, a.T);
  load_tile<T, D, BT>(sV, v, a.sv.s, k0, a.T);

  float dk[R][NJ], dv[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q rows [qlo, qhi) that see any unmasked key of this tile
  const int k1 = min(k0 + BT, kv_end);
  const int qlo = a.causal ? max(0, k0 - off) : 0;
  const int qhi = a.window ? min(a.S, k1 - 1 - off + a.window) : a.S;
  for (int hg = 0; k0 < kv_end && hg < group; ++hg) {
    const int h = kvh * group + hg;
    const int64_t bh = (int64_t)b * a.H + h;
    const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    for (int q0 = (qlo / BT) * BT; q0 < qhi; q0 += BT) {
      __syncthreads();  // the last tile's readers are done with sQ, sO, sP, sS
      load_tile<T, D, BT>(sQ, q, a.sq.s, q0, a.S);
      load_tile<T, D, BT>(sO, dout, a.sdo.s, q0, a.S);
      for (int r = threadIdx.x; r < BT; r += kThreads) {
        const int row = q0 + r;
        sL[r] = row < a.S ? a.lse[bh * a.S + row] : 0.f;
        sD[r] = row < a.S ? a.di[bh * a.S + row] : 0.f;
      }
      __syncthreads();
      // transposed scores: this thread's kv rows ty + 16 i, q cols tx + 16 j
      float s[R][R] = {}, dp[R][R] = {};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[R], va[R], qb[R], ob[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          ka[i] = sK[(ty + 16 * i) * LDD + d];
          va[i] = sV[(ty + 16 * i) * LDD + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qb[j] = sQ[(tx + 16 * j) * LDD + d];
          ob[j] = sO[(tx + 16 * j) * LDD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int col = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = tx + 16 * j, row = q0 + r;
          const bool ok = row < a.S && keep(a, row, col, kv_end);
          const float p = ok ? expf(s[i][j] * a.scale - sL[r]) : 0.f;
          sP[(ty + 16 * i) * LDP + r] = p;
          sS[(ty + 16 * i) * LDP + r] = p * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pa[R], da[R], ob[NJ], qb[NJ];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pa[i] = sP[(ty + 16 * i) * LDP + r];
          da[i] = sS[(ty + 16 * i) * LDP + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ob[j] = sO[r * LDD + tx + 16 * j];
          qb[j] = sQ[r * LDD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
            dk[i][j] = fmaf(da[i], qb[j], dk[i][j]);
          }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  T* dvp = static_cast<T*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      st(dkp + row * a.sdk.s + tx + 16 * j, a.scale * dk[i][j]);
      st(dvp + row * a.sdv.s + tx + 16 * j, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: building blocks (and those of mma_bf16.cuh)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
static_assert(16 * kMmaWarps == kBQ && 16 * kMmaWarps == kBK,
              "a warp owns one m16 tile of the 64-row q (K3) or kv (K5) tile");

// bf16 terms of p in K3's p v, of ds in K4's ds k, and of p and ds in K5's
// products (see the note at the top).
constexpr int kFwdTerms = 3;
constexpr int kDqTerms = 2;
constexpr int kDkvTerms = 2;

// q rows of K5's streamed tile: 64, or 32 at D >= 128 to keep dk and dv in
// registers without spilling.
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D <= 64 ? 64 : 32; }

// Output columns (of o, dq, or dk and dv) one tensor-core block owns: all of
// D up to 128; at D 256 two blocks (grid z) own 128 each and each forms the
// scores over all of D again, so that no block holds more than 128 columns
// of fp32 accumulators (K5's dk and dv alone would take 256 registers a
// thread at D 256).
template <int D>
__host__ __device__ constexpr int mma_out() { return D <= 128 ? D : 128; }

// Rows [r0, r0 + R) of a (n, D) bf16 slab with row stride ss into a shared
// tile of row stride D + 8, 16 bytes per cp.async; rows at or past n are
// zero-filled.
template <int D, int R>
__device__ __forceinline__ void stage_rows(bf16* sm, const bf16* base, int64_t ss, int r0, int n) {
  constexpr int CH = D / 8;
  static_assert(R * CH % kMmaThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int i = 0; i < R * CH / kMmaThreads; ++i) {
    const int e = i * kMmaThreads + threadIdx.x, r = e / CH, c = (e % CH) * 8, row = r0 + r;
    const bool in = row < n;
    cp_async16(sm + r * (D + 8) + c, base + (in ? row * ss : 0) + c, in);
  }
}

// A warp's fp32 accumulator tiles c (16 rows x W, C layout) times f as bf16
// into its 16 shared rows sm (row stride LDS >= W), then those rows to rows
// [r0, r0 + 16) of a (n, W) bf16 slab with row stride ss, 16 bytes per
// store; rows at or past n are dropped.
template <int W, int LDS>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t ss, int r0, int n, bf16* sm,
                                          const float (&c)[W / 8][4], const float (&f)[2],
                                          int lane) {
  constexpr int CH = W / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<__nv_bfloat162*>(sm + (g + 8 * hh) * LDS + 8 * j + 2 * t) =
          __floats2bfloat162_rn(c[j][2 * hh] * f[hh], c[j][2 * hh + 1] * f[hh]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int e = i * 32 + lane, r = e / CH, col = (e % CH) * 8;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * ss + col) =
          *reinterpret_cast<const uint4*>(sm + r * LDS + col);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// True if every (row, col) of rows [r0, r0 + nr) x cols [c0, c0 + nc) is
// kept: the tile needs no mask (and, with rows_too, has no row past S).
__device__ __forceinline__ bool tile_full(const Args& a, int r0, int nr, int c0, int nc,
                                          int kv_end, bool rows_too) {
  const int off = a.T - a.S;
  return c0 + nc <= kv_end && (!rows_too || r0 + nr <= a.S) &&
         (!a.causal || c0 + nc - 1 <= r0 + off) && (!a.window || c0 > r0 + nr - 1 + off - a.window);
}

// K3's online-softmax step for one kv tile, on this lane's rows row0 and
// row0 + 8: s holds the raw scores q k^T of columns col0 + 8 j + 2 t + {0, 1}
// and leaves as p; m and l are the running max (of scale s) and this lane's
// share of the sum; alpha is each row's rescale.  MASKED applies keep()
// entry by entry (a tile with no masked entry skips it).  p = exp(scale s -
// m) is taken as exp2(s scale log2(e) - m log2(e)), one fma into exp2.
template <bool MASKED, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Args& a, int row0,
                                             int col0, int kv_end) {
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    uint32_t ok = ~0u;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * hh + e];
        if (MASKED && !keep(a, row, col0 + 8 * j + e, kv_end)) {
          ok &= ~(1u << (2 * j + e));
          x = kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // the reference's masked scores are -1e30, so a row with no key in this
    // tile keeps its m; scale > 0, so max(scale s) = scale max(s)
    const float m_new = MASKED && mx == kNegInf ? m[hh] : fmaxf(m[hh], mx * a.scale);
    alpha[hh] = expf(m[hh] - m_new);
    const float mb = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * hh + e];
        x = !MASKED || (ok >> (2 * j + e) & 1u) ? exp2f(fmaf(x, sl2, -mb)) : 0.f;
        sum += x;
      }
    l[hh] = alpha[hh] * l[hh] + sum;  // this lane's share; the quad sums at the end
    m[hh] = m_new;
  }
}

// K5's p^T = exp(scale s^T - lse) and ds^T = p^T (dp^T - di) in place, on
// this lane's kv rows col0 and col0 + 8 and q rows q0 + 8 j + 2 t + {0, 1}
// (lse and di of the q tile in shared memory).  MASKED applies keep() and
// the S tail entry by entry.
template <bool MASKED, int NQ>
__device__ __forceinline__ void dkv_probs(float (&sc)[NQ][4], float (&dp)[NQ][4], const float* sL,
                                          const float* sDi, const Args& a, int q0, int col0,
                                          int kv_end, int t) {
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float2 lse = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
    const float2 di = *reinterpret_cast<const float2*>(sDi + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + 8 * j + 2 * t + (e & 1);
      float p = exp2f(fmaf(sc[j][e], sl2, -kLog2e * ((e & 1) ? lse.y : lse.x)));
      if (MASKED && !(row < a.S && keep(a, row, col0 + 8 * (e >> 1), kv_end))) p = 0.f;
      sc[j][e] = p;
      dp[j][e] = p * (dp[j][e] - ((e & 1) ? di.y : di.x));
    }
  }
}

// K4's p = exp(scale s - lse) and ds = p (dp - di), left in s in place, on
// this lane's q rows row0 and row0 + 8 (lse and di of each in registers) and
// kv columns col0 + 8 j + {0, 1}.  MASKED applies keep() and the S tail
// entry by entry.
template <bool MASKED, int NS>
__device__ __forceinline__ void dq_probs(float (&s)[NS][4], const float (&dp)[NS][4],
                                         const float (&lse)[2], const float (&di)[2],
                                         const Args& a, int row0, int col0, int kv_end) {
  const float sl2 = a.scale * kLog2e;
  const float lb[2] = {lse[0] * kLog2e, lse[1] * kLog2e};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, row = row0 + 8 * hh;
      float p = exp2f(fmaf(s[j][e], sl2, -lb[hh]));
      if (MASKED && !(row < a.S && keep(a, row, col0 + 8 * j + (e & 1), kv_end))) p = 0.f;
      s[j][e] = p * (dp[j][e] - di[hh]);
    }
}

// ---------------------------------------------------------------------------
// K3 on the tensor cores (bf16)
// ---------------------------------------------------------------------------

// Blocks per SM the register budget is sized for (launch bounds): 3 at
// D <= 64 (<= 168 registers) for K3 and K5, 2 and 1 at D >= 128.  K3 at 4
// blocks (<= 128 registers) spilled and was no faster; K5 at 2 was slower.
// q's fragments stay in registers up to D 128; at D 256 (64 registers of
// them) they are read from shared memory for each kv tile, as K4 reads them.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 3 : 2) flash_fwd_mma_kernel(Args a) {
  constexpr int LD = D + 8, KD = D / 16, NS = kBK / 8, DO = mma_out<D>(), NO = DO / 8;
  constexpr bool kQInRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBQ x LD, then o on its way out
  bf16* sKV = sQ + kBQ * LD;                     // 2 stages x (k, v), kBK x LD each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // the ldmatrix matrix and row this lane addresses
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ, dz = blockIdx.z * DO;  // dz: this block's o columns
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  int lo, hi;
  kv_range(a, q0, kBQ, kv_end, lo, hi);
  const int first = (lo / kBK) * kBK;
  const int ntiles = hi > first ? (hi - first + kBK - 1) / kBK : 0;
  auto stage_kv = [&](int it) {
    bf16* sK = sKV + (it & 1) * 2 * kBK * LD;
    stage_rows<D, kBK>(sK, k, a.sk.s, first + it * kBK, a.T);
    stage_rows<D, kBK>(sK + kBK * LD, v, a.sv.s, first + it * kBK, a.T);
  };

  stage_rows<D, kBQ>(sQ, q, a.sq.s, q0, a.S);
  if (ntiles > 0) stage_kv(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // where this warp's 16 q rows' A fragments start; in registers for the
  // whole loop up to D 128
  const int at_q = (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  uint32_t qf[kQInRegs ? KD : 1][4];
#pragma unroll
  for (int kk = 0; kQInRegs && kk < KD; ++kk) ldsm4(qf[kk], sQ + at_q + 16 * kk);

  float acc[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {  // the next tile streams in while this one is used
      stage_kv(it + 1);
      cp_async_commit();
    }
    const bf16* sK = sKV + (it & 1) * 2 * kBK * LD;
    const bf16* sV = sK + kBK * LD;
    const int kv0 = first + it * kBK;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if (kQInRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[kQInRegs ? kk : 0][r];
      } else {
        ldsm4(qa, sQ + at_q + 16 * kk);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kb[4];
        ldsm4(kb, sK + (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1));
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    // online softmax on the fragments: this lane's rows g and g + 8 of the
    // warp's 16, columns 8 j + 2 t + {0, 1}; a row's 4 lanes form a quad
    float alpha[2];
    const int row0 = q0 + 16 * warp + g;
    if (tile_full(a, q0, kBQ, kv0, kBK, kv_end, false))
      softmax_tile<false>(s, m, l, alpha, a, row0, kv0 + 2 * t, kv_end);
    else
      softmax_tile<true>(s, m, l, alpha, a, row0, kv0 + 2 * t, kv_end);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += p v, p as three bf16 terms straight from the score registers
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[kFwdTerms][4];
      a_from_acc(s, kc, pa);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldsm4_t(vb, sV + (16 * kc + mr + 8 * (mi & 1)) * LD + dz + 8 * n + 8 * (mi >> 1));
#pragma unroll
        for (int i = 0; i < kFwdTerms; ++i) {
          mma_bf16(acc[n], pa[i], vb[0], vb[1]);
          mma_bf16(acc[n + 1], pa[i], vb[2], vb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one's readers are done
  }

  float lc[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = l[hh];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    lc[hh] = fmaxf(x, 1e-30f);
    inv[hh] = 1.f / lc[hh];
  }
  // o through this warp's own rows of sQ, which only this warp reads; the
  // lse once, from the block that owns o's first columns
  store_acc<DO, LD>(static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h + dz, a.so.s,
                    q0 + 16 * warp, a.S, sQ + 16 * warp * LD, acc, inv, lane);
  if (t == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * warp + g + 8 * hh;
      if (row < a.S) a.lse_out[(int64_t)bh * a.S + row] = m[hh] + logf(lc[hh]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 on the tensor cores (bf16)
// ---------------------------------------------------------------------------

// K3's shape: one block per (b*h, 64-row q tile), each warp 16 q rows, k and
// v through the same two-stage ring.  do stays in shared memory and its A
// fragments are read again for each kv tile (KD ldmatrix a tile against 4 KD
// for k and v); q's stay in registers for the whole loop at D <= 64 and are
// read like do's at D 128.  With both in registers ptxas spilled (32 bytes
// at D 64 under the 168 registers of 3 blocks per SM, 44 at D 128 under
// 255), and with q's alone at D 128 still 8.  3 blocks per SM at D <= 64, 2
// at D 128.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 3 : 2) flash_dq_mma_kernel(Args a) {
  constexpr int LD = D + 8, KD = D / 16, NS = kBK / 8, DO = mma_out<D>(), NO = DO / 8;
  constexpr bool kQInRegs = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBQ x LD, then dq on its way out
  bf16* sO = sQ + kBQ * LD;                      // do, kBQ x LD, for the whole loop
  bf16* sKV = sO + kBQ * LD;                     // 2 stages x (k, v), kBK x LD each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ, dz = blockIdx.z * DO;  // dz: this block's dq columns
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  int lo, hi;
  kv_range(a, q0, kBQ, kv_end, lo, hi);
  const int first = (lo / kBK) * kBK;
  const int ntiles = hi > first ? (hi - first + kBK - 1) / kBK : 0;
  auto stage_kv = [&](int it) {
    bf16* sK = sKV + (it & 1) * 2 * kBK * LD;
    stage_rows<D, kBK>(sK, k, a.sk.s, first + it * kBK, a.T);
    stage_rows<D, kBK>(sK + kBK * LD, v, a.sv.s, first + it * kBK, a.T);
  };

  stage_rows<D, kBQ>(sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.s, q0,
                     a.S);
  stage_rows<D, kBQ>(sO, static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
                     a.sdo.s, q0, a.S);
  if (ntiles > 0) stage_kv(0);
  cp_async_commit();
  // this lane's rows row0 and row0 + 8: lse and di once (rows past S: p and
  // ds are masked to 0)
  const int row0 = q0 + 16 * warp + g;
  float lse[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lse[hh] = row < a.S ? a.lse[(int64_t)bh * a.S + row] : 0.f;
    di[hh] = row < a.S ? a.di[(int64_t)bh * a.S + row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  // where this warp's 16 q and do rows' A fragments start; q's in registers
  const int at_w = (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  uint32_t qf[kQInRegs ? KD : 1][4];
#pragma unroll
  for (int kk = 0; kQInRegs && kk < KD; ++kk) ldsm4(qf[kk], sQ + at_w + 16 * kk);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {  // the next tile streams in while this one is used
      stage_kv(it + 1);
      cp_async_commit();
    }
    const bf16* sK = sKV + (it & 1) * 2 * kBK * LD;
    const bf16* sV = sK + kBK * LD;
    const int kv0 = first + it * kBK;
    // s = q k^T and dp = do v^T: this warp's 16 rows x the tile's 64 columns
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], of[4];
      ldsm4(of, sO + at_w + 16 * kk);
      if (kQInRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[kQInRegs ? kk : 0][r];
      } else {
        ldsm4(qa, sQ + at_w + 16 * kk);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kb[4], vb[4];
        const int at = (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1);
        ldsm4(kb, sK + at);
        ldsm4(vb, sV + at);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], of, vb[0], vb[1]);
        mma_bf16(dp[j + 1], of, vb[2], vb[3]);
      }
    }
    // ds in place of s, on fragment coordinates
    if (tile_full(a, q0, kBQ, kv0, kBK, kv_end, true))
      dq_probs<false>(s, dp, lse, di, a, row0, kv0 + 2 * t, kv_end);
    else
      dq_probs<true>(s, dp, lse, di, a, row0, kv0 + 2 * t, kv_end);
    // dq += ds k, ds as kDqTerms bf16 terms straight from the registers
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t da[kDqTerms][4];
      a_from_acc(s, kc, da);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t kb[4];
        ldsm4_t(kb, sK + (16 * kc + mr + 8 * (mi & 1)) * LD + dz + 8 * n + 8 * (mi >> 1));
#pragma unroll
        for (int i = 0; i < kDqTerms; ++i) {
          mma_bf16(acc[n], da[i], kb[0], kb[1]);
          mma_bf16(acc[n + 1], da[i], kb[2], kb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one's readers are done
  }

  // dq = scale acc through this warp's own rows of sQ
  const float scale2[2] = {a.scale, a.scale};
  store_acc<DO, LD>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h + dz, a.sdq.s,
                    q0 + 16 * warp, a.S, sQ + 16 * warp * LD, acc, scale2, lane);
}

// ---------------------------------------------------------------------------
// K5 on the tensor cores (bf16)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 3 : 1) flash_dkv_mma_kernel(Args a) {
  constexpr int LD = D + 8, BQ = dkv_bq<D>(), KD = D / 16, NQ = BQ / 8, DO = mma_out<D>(),
                NO = DO / 8;
  constexpr int TILE = BQ * LD;  // one streamed q or do tile
  static_assert(2 * BQ <= kMmaThreads, "one thread per lse or di entry");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kBK x LD, then dk on its way out
  bf16* sV = sK + kBK * LD;                      // kBK x LD, then dv on its way out
  bf16* sQO = sV + kBK * LD;                     // 2 stages x (q, do), BQ x LD each
  float* sLD = reinterpret_cast<float*>(sQO + 4 * TILE);  // 2 stages x (lse, di), BQ each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int n = blockIdx.x, b = n / a.Hkv, kvh = n % a.Hkv, group = a.H / a.Hkv;
  const int k0 = blockIdx.y * kBK, dz = blockIdx.z * DO;  // dz: this block's dk/dv columns
  const int kv_end = kv_end_of(a, b), off = a.T - a.S;
  // q rows [qlo, qhi) that see any unmasked key of this tile
  const int k1 = min(k0 + kBK, kv_end);
  const int qlo = a.causal ? max(0, k0 - off) : 0;
  const int qhi = a.window ? min(a.S, k1 - 1 - off + a.window) : a.S;
  const int qfirst = (qlo / BQ) * BQ;
  const int nq = (k0 < kv_end && qhi > qfirst) ? (qhi - qfirst + BQ - 1) / BQ : 0;
  const int total = group * nq;  // (q head of the group, q tile), head-major
  auto stage_q = [&](int it) {
    const int hq = kvh * group + it / nq, q0 = qfirst + (it % nq) * BQ;
    bf16* sQ = sQO + (it & 1) * 2 * TILE;
    stage_rows<D, BQ>(sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + hq * a.sq.h, a.sq.s,
                      q0, a.S);
    stage_rows<D, BQ>(sQ + TILE, static_cast<const bf16*>(a.dout) + b * a.sdo.b + hq * a.sdo.h,
                      a.sdo.s, q0, a.S);
    if (threadIdx.x < 2 * BQ) {
      const int row = q0 + threadIdx.x % BQ;
      const float* src = (threadIdx.x < BQ ? a.lse : a.di) + ((int64_t)b * a.H + hq) * a.S;
      cp_async4(sLD + (it & 1) * 2 * BQ + threadIdx.x, src + (row < a.S ? row : 0), row < a.S);
    }
  };

  stage_rows<D, kBK>(sK, static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h, a.sk.s, k0,
                     a.T);
  stage_rows<D, kBK>(sV, static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h, a.sv.s, k0,
                     a.T);
  if (total > 0) stage_q(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const bf16* sKw = sK + (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  const bf16* sVw = sV + (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  const int col0 = k0 + 16 * warp + g;  // this lane's kv rows: col0 and col0 + 8

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {  // the next (q, do, lse, di) stream in while this one is used
      stage_q(it + 1);
      cp_async_commit();
    }
    const int q0 = qfirst + (it % nq) * BQ;
    const bf16* sQ = sQO + (it & 1) * 2 * TILE;
    const bf16* sO = sQ + TILE;
    const float* sL = sLD + (it & 1) * 2 * BQ;
    const float* sDi = sL + BQ;

    // s^T = k q^T and dp^T = v do^T: this warp's 16 kv rows x BQ q columns
    float sc[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm4(ka, sKw + 16 * kk);
      ldsm4(va, sVw + 16 * kk);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t qb[4], ob[4];
        const int at = (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1);
        ldsm4(qb, sQ + at);
        ldsm4(ob, sO + at);
        mma_bf16(sc[j], ka, qb[0], qb[1]);
        mma_bf16(sc[j + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[j], va, ob[0], ob[1]);
        mma_bf16(dp[j + 1], va, ob[2], ob[3]);
      }
    }
    // p^T and ds^T in place, on fragment coordinates: kv row col0 + 8 (e / 2),
    // q row q0 + 8 j + 2 t + e % 2
    if (tile_full(a, q0, BQ, k0, kBK, kv_end, true))
      dkv_probs<false>(sc, dp, sL, sDi, a, q0, col0, kv_end, t);
    else
      dkv_probs<true>(sc, dp, sL, sDi, a, q0, col0, kv_end, t);
    // dv += p^T do and dk += ds^T q, p and ds as bf16 hi + lo
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[kDkvTerms][4], da[kDkvTerms][4];
      a_from_acc(sc, kc, pa);
      a_from_acc(dp, kc, da);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t ob[4], qb[4];
        const int at = (16 * kc + mr + 8 * (mi & 1)) * LD + dz + 8 * j + 8 * (mi >> 1);
        ldsm4_t(ob, sO + at);
        ldsm4_t(qb, sQ + at);
#pragma unroll
        for (int i = 0; i < kDkvTerms; ++i) {
          mma_bf16(dv[j], pa[i], ob[0], ob[1]);
          mma_bf16(dv[j + 1], pa[i], ob[2], ob[3]);
          mma_bf16(dk[j], da[i], qb[0], qb[1]);
          mma_bf16(dk[j + 1], da[i], qb[2], qb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next stage has landed; this one's readers are done
  }

  // dk and dv through this warp's own rows of sK and sV
  const float scale2[2] = {a.scale, a.scale}, one2[2] = {1.f, 1.f};
  store_acc<DO, LD>(static_cast<bf16*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h + dz, a.sdk.s,
                    k0 + 16 * warp, a.T, sK + 16 * warp * LD, dk, scale2, lane);
  store_acc<DO, LD>(static_cast<bf16*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h + dz, a.sdv.s,
                    k0 + 16 * warp, a.T, sV + 16 * warp * LD, dv, one2, lane);
}

// ---------------------------------------------------------------------------
// Head dims past 256: the wide kernels
// ---------------------------------------------------------------------------
//
// Past D 256 full-D tiles no longer fit shared memory (K3's 64-row q tile and
// two stages of k and v would take 332 KB at D 512).  So the wide kernels take
// any D that is a multiple of kWide, at run time (the wrapper zero-pads other
// head dims up to the next multiple): a block owns kWide output columns (grid
// z = D / kWide, as at D 256) and forms the scores over all of D in kWide-wide
// slices of q and k (and of do and v for dp), each slice staged in shared
// memory in its turn; the block's own kWide columns of v (K3), k (K4), or q
// and do (K5) are staged once a tile for the second products.  The shared
// memory a block takes is the same at every D.  The price is in bytes: each
// slice of q (K3, K4) or of k and v (K5) is read again for every tile of the
// other side, and every z block forms the scores over all of D, so the
// scores cost D / kWide times the products of one block.  The bf16 kernels
// keep the tensor-core design above (64-row tiles, 4 warps of 16 rows,
// ldmatrix and mma.sync, p and ds as bf16 terms from the registers) and run
// the slices through a two-stage cp.async ring; the fp32 kernels keep the
// FMA design (64-row tiles) and load each slice in turn.

constexpr int kWide = 128;  // slice width, and output columns of a wide block

// K3, bf16: one block per (b*h, 64-row q tile, kWide o columns).  Unit u of
// the ring is slice u % nsl of kv tile u / nsl: q's and k's slice; the first
// slice of a tile also brings v's columns [dz, dz + kWide), used after the
// last.
__global__ void __launch_bounds__(kMmaThreads, 2) flash_fwd_wide_mma_kernel(Args a) {
  constexpr int W = kWide, LD = W + 8, KD = W / 16, NS = kBK / 8, NO = W / 8, TILE = kBK * LD;
  static_assert(kBQ == kBK, "q and kv slices share one tile size");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sRing = reinterpret_cast<bf16*>(smem_raw);  // 2 stages x (q slice, k slice)
  bf16* sVz = sRing + 4 * TILE;                      // 2 stages x v's columns of this block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ, dz = blockIdx.z * W, nsl = a.D / W;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  int lo, hi;
  kv_range(a, q0, kBQ, kv_end, lo, hi);
  const int first = (lo / kBK) * kBK;
  const int ntiles = hi > first ? (hi - first + kBK - 1) / kBK : 0, units = ntiles * nsl;
  auto stage = [&](int u) {
    const int it = u / nsl, sl = u % nsl, kv0 = first + it * kBK;
    bf16* sQ = sRing + (u & 1) * 2 * TILE;
    stage_rows<W, kBQ>(sQ, q + sl * W, a.sq.s, q0, a.S);
    stage_rows<W, kBK>(sQ + TILE, k + sl * W, a.sk.s, kv0, a.T);
    if (sl == 0) stage_rows<W, kBK>(sVz + (it & 1) * TILE, v + dz, a.sv.s, kv0, a.T);
  };

  if (units > 0) stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int at_q = (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  const int row0 = q0 + 16 * warp + g;
  float acc[NO][4], s[NS][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) {  // the next slice streams in while this one is used
      stage(u + 1);
      cp_async_commit();
    }
    const int it = u / nsl, sl = u % nsl, kv0 = first + it * kBK;
    const bf16* sQ = sRing + (u & 1) * 2 * TILE;
    const bf16* sK = sQ + TILE;
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      ldsm4(qa, sQ + at_q + 16 * kk);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kb[4];
        ldsm4(kb, sK + (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1));
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }
    if (sl == nsl - 1) {  // the scores are whole: softmax, then o += p v
      float alpha[2];
      if (tile_full(a, q0, kBQ, kv0, kBK, kv_end, false))
        softmax_tile<false>(s, m, l, alpha, a, row0, kv0 + 2 * t, kv_end);
      else
        softmax_tile<true>(s, m, l, alpha, a, row0, kv0 + 2 * t, kv_end);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      const bf16* sV = sVz + (it & 1) * TILE;
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        uint32_t pa[kFwdTerms][4];
        a_from_acc(s, kc, pa);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t vb[4];
          ldsm4_t(vb, sV + (16 * kc + mr + 8 * (mi & 1)) * LD + 8 * n + 8 * (mi >> 1));
#pragma unroll
          for (int i = 0; i < kFwdTerms; ++i) {
            mma_bf16(acc[n], pa[i], vb[0], vb[1]);
            mma_bf16(acc[n + 1], pa[i], vb[2], vb[3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next slice has landed; this one's readers are done
  }

  float lc[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = l[hh];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    lc[hh] = fmaxf(x, 1e-30f);
    inv[hh] = 1.f / lc[hh];
  }
  // o through this warp's own rows of the first q slice buffer; the lse once
  store_acc<W, LD>(static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h + dz, a.so.s,
                   q0 + 16 * warp, a.S, sRing + 16 * warp * LD, acc, inv, lane);
  if (t == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row < a.S) a.lse_out[(int64_t)bh * a.S + row] = m[hh] + logf(lc[hh]);
    }
  }
}

// K4, bf16: one block per (b*h, 64-row q tile, kWide dq columns).  Unit u is
// slice u % nsl of q, do, k and v for kv tile u / nsl; the first slice of a
// tile also brings k's columns [dz, dz + kWide) for dq += ds k.
__global__ void __launch_bounds__(kMmaThreads, 1) flash_dq_wide_mma_kernel(Args a) {
  constexpr int W = kWide, LD = W + 8, KD = W / 16, NS = kBK / 8, NO = W / 8, TILE = kBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sRing = reinterpret_cast<bf16*>(smem_raw);  // 2 stages x (q, do, k, v slices)
  bf16* sKz = sRing + 8 * TILE;                      // 2 stages x k's columns of this block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ, dz = blockIdx.z * W, nsl = a.D / W;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  int lo, hi;
  kv_range(a, q0, kBQ, kv_end, lo, hi);
  const int first = (lo / kBK) * kBK;
  const int ntiles = hi > first ? (hi - first + kBK - 1) / kBK : 0, units = ntiles * nsl;
  auto stage = [&](int u) {
    const int it = u / nsl, sl = u % nsl, kv0 = first + it * kBK;
    bf16* st = sRing + (u & 1) * 4 * TILE;
    stage_rows<W, kBQ>(st, q + sl * W, a.sq.s, q0, a.S);
    stage_rows<W, kBQ>(st + TILE, dout + sl * W, a.sdo.s, q0, a.S);
    stage_rows<W, kBK>(st + 2 * TILE, k + sl * W, a.sk.s, kv0, a.T);
    stage_rows<W, kBK>(st + 3 * TILE, v + sl * W, a.sv.s, kv0, a.T);
    if (sl == 0) stage_rows<W, kBK>(sKz + (it & 1) * TILE, k + dz, a.sk.s, kv0, a.T);
  };

  if (units > 0) stage(0);
  cp_async_commit();
  const int row0 = q0 + 16 * warp + g;
  float lse[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lse[hh] = row < a.S ? a.lse[(int64_t)bh * a.S + row] : 0.f;
    di[hh] = row < a.S ? a.di[(int64_t)bh * a.S + row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  const int at_w = (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  float acc[NO][4], s[NS][4], dp[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) {
      stage(u + 1);
      cp_async_commit();
    }
    const int it = u / nsl, sl = u % nsl, kv0 = first + it * kBK;
    const bf16* sQ = sRing + (u & 1) * 4 * TILE;
    const bf16* sO = sQ + TILE;
    const bf16* sK = sQ + 2 * TILE;
    const bf16* sV = sQ + 3 * TILE;
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], of[4];
      ldsm4(qa, sQ + at_w + 16 * kk);
      ldsm4(of, sO + at_w + 16 * kk);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kb[4], vb[4];
        const int at = (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1);
        ldsm4(kb, sK + at);
        ldsm4(vb, sV + at);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], of, vb[0], vb[1]);
        mma_bf16(dp[j + 1], of, vb[2], vb[3]);
      }
    }
    if (sl == nsl - 1) {  // s and dp are whole: ds, then dq += ds k
      if (tile_full(a, q0, kBQ, kv0, kBK, kv_end, true))
        dq_probs<false>(s, dp, lse, di, a, row0, kv0 + 2 * t, kv_end);
      else
        dq_probs<true>(s, dp, lse, di, a, row0, kv0 + 2 * t, kv_end);
      const bf16* sKzi = sKz + (it & 1) * TILE;
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        uint32_t da[kDqTerms][4];
        a_from_acc(s, kc, da);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t kb[4];
          ldsm4_t(kb, sKzi + (16 * kc + mr + 8 * (mi & 1)) * LD + 8 * n + 8 * (mi >> 1));
#pragma unroll
          for (int i = 0; i < kDqTerms; ++i) {
            mma_bf16(acc[n], da[i], kb[0], kb[1]);
            mma_bf16(acc[n + 1], da[i], kb[2], kb[3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const float scale2[2] = {a.scale, a.scale};
  store_acc<W, LD>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h + dz, a.sdq.s,
                   q0 + 16 * warp, a.S, sRing + 16 * warp * LD, acc, scale2, lane);
}

// K5, bf16: one block per (b*hkv, 64-row kv tile, kWide dk/dv columns),
// looping over (q head of the group x 32-row q tile), head-major.  Unit u is
// slice u % nsl of k, v, q and do for q tile u / nsl; the first slice of a q
// tile also brings q's and do's columns [dz, dz + kWide) and the tile's lse
// and di.
__global__ void __launch_bounds__(kMmaThreads, 1) flash_dkv_wide_mma_kernel(Args a) {
  constexpr int W = kWide, LD = W + 8, BQ = 32, KD = W / 16, NQ = BQ / 8, NO = W / 8;
  constexpr int TK = kBK * LD, TQ = BQ * LD, STAGE = 2 * TK + 2 * TQ;
  static_assert(2 * BQ <= kMmaThreads, "one thread per lse or di entry");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sRing = reinterpret_cast<bf16*>(smem_raw);  // 2 stages x (k, v, q, do slices)
  bf16* sQz = sRing + 2 * STAGE;                     // 2 stages x (q, do columns of this block)
  float* sLD = reinterpret_cast<float*>(sQz + 4 * TQ);  // 2 stages x (lse, di)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int n = blockIdx.x, b = n / a.Hkv, kvh = n % a.Hkv, group = a.H / a.Hkv;
  const int k0 = blockIdx.y * kBK, dz = blockIdx.z * W, nsl = a.D / W;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b), off = a.T - a.S;
  // q rows [qlo, qhi) that see any unmasked key of this tile
  const int k1 = min(k0 + kBK, kv_end);
  const int qlo = a.causal ? max(0, k0 - off) : 0;
  const int qhi = a.window ? min(a.S, k1 - 1 - off + a.window) : a.S;
  const int qfirst = (qlo / BQ) * BQ;
  const int nq = (k0 < kv_end && qhi > qfirst) ? (qhi - qfirst + BQ - 1) / BQ : 0;
  const int total = group * nq, units = total * nsl;
  auto stage = [&](int u) {
    const int it = u / nsl, sl = u % nsl;
    const int hq = kvh * group + it / nq, q0 = qfirst + (it % nq) * BQ;
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + hq * a.sq.h;
    const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdo.b + hq * a.sdo.h;
    bf16* st = sRing + (u & 1) * STAGE;
    stage_rows<W, kBK>(st, k + sl * W, a.sk.s, k0, a.T);
    stage_rows<W, kBK>(st + TK, v + sl * W, a.sv.s, k0, a.T);
    stage_rows<W, BQ>(st + 2 * TK, q + sl * W, a.sq.s, q0, a.S);
    stage_rows<W, BQ>(st + 2 * TK + TQ, dout + sl * W, a.sdo.s, q0, a.S);
    if (sl == 0) {
      bf16* sz = sQz + (it & 1) * 2 * TQ;
      stage_rows<W, BQ>(sz, q + dz, a.sq.s, q0, a.S);
      stage_rows<W, BQ>(sz + TQ, dout + dz, a.sdo.s, q0, a.S);
      if (threadIdx.x < 2 * BQ) {
        const int row = q0 + threadIdx.x % BQ;
        const float* src = (threadIdx.x < BQ ? a.lse : a.di) + ((int64_t)b * a.H + hq) * a.S;
        cp_async4(sLD + (it & 1) * 2 * BQ + threadIdx.x, src + (row < a.S ? row : 0),
                  row < a.S);
      }
    }
  };

  if (units > 0) stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk[NO][4], dv[NO][4], sc[NQ][4], dp[NQ][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int at_w = (16 * warp + mr + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
  const int col0 = k0 + 16 * warp + g;  // this lane's kv rows: col0 and col0 + 8

  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) {
      stage(u + 1);
      cp_async_commit();
    }
    const int it = u / nsl, sl = u % nsl, q0 = qfirst + (it % nq) * BQ;
    const bf16* sK = sRing + (u & 1) * STAGE;
    const bf16* sV = sK + TK;
    const bf16* sQ = sK + 2 * TK;
    const bf16* sO = sQ + TQ;
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
    // s^T = k q^T and dp^T = v do^T over this slice
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm4(ka, sK + at_w + 16 * kk);
      ldsm4(va, sV + at_w + 16 * kk);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t qb[4], ob[4];
        const int at = (8 * j + mr + 8 * (mi >> 1)) * LD + 16 * kk + 8 * (mi & 1);
        ldsm4(qb, sQ + at);
        ldsm4(ob, sO + at);
        mma_bf16(sc[j], ka, qb[0], qb[1]);
        mma_bf16(sc[j + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[j], va, ob[0], ob[1]);
        mma_bf16(dp[j + 1], va, ob[2], ob[3]);
      }
    }
    if (sl == nsl - 1) {  // whole: p^T and ds^T, then dv += p^T do and dk += ds^T q
      const float* sL = sLD + (it & 1) * 2 * BQ;
      if (tile_full(a, q0, BQ, k0, kBK, kv_end, true))
        dkv_probs<false>(sc, dp, sL, sL + BQ, a, q0, col0, kv_end, t);
      else
        dkv_probs<true>(sc, dp, sL, sL + BQ, a, q0, col0, kv_end, t);
      const bf16* sQzi = sQz + (it & 1) * 2 * TQ;
      const bf16* sOz = sQzi + TQ;
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t pa[kDkvTerms][4], da[kDkvTerms][4];
        a_from_acc(sc, kc, pa);
        a_from_acc(dp, kc, da);
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t ob[4], qb[4];
          const int at = (16 * kc + mr + 8 * (mi & 1)) * LD + 8 * j + 8 * (mi >> 1);
          ldsm4_t(ob, sOz + at);
          ldsm4_t(qb, sQzi + at);
#pragma unroll
          for (int i = 0; i < kDkvTerms; ++i) {
            mma_bf16(dv[j], pa[i], ob[0], ob[1]);
            mma_bf16(dv[j + 1], pa[i], ob[2], ob[3]);
            mma_bf16(dk[j], da[i], qb[0], qb[1]);
            mma_bf16(dk[j + 1], da[i], qb[2], qb[3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // dk and dv through this warp's own rows of the first stage's k and v slices
  const float scale2[2] = {a.scale, a.scale}, one2[2] = {1.f, 1.f};
  store_acc<W, LD>(static_cast<bf16*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h + dz, a.sdk.s,
                   k0 + 16 * warp, a.T, sRing + 16 * warp * LD, dk, scale2, lane);
  store_acc<W, LD>(static_cast<bf16*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h + dz, a.sdv.s,
                   k0 + 16 * warp, a.T, sRing + TK + 16 * warp * LD, dv, one2, lane);
}

// The FMA design past D 256 (fp32): the kernels above on 64-row fp32 tiles
// (the 16 x 16 threads own 4 x 4 scores and 4 rows x 8 of the block's kWide
// columns each), the slices loaded in turn with no ring.
constexpr int kWideR = 4;

__global__ void __launch_bounds__(kThreads) flash_fwd_wide_kernel(Args a) {
  constexpr int W = kWide, R = kWideR, BT = 16 * R, LDP = BT + 1, LDD = W + 1, NJ = W / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BT * LDD;
  float* sV = sK + BT * LDD;
  float* sP = sV + BT * LDD;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * BT, dz = blockIdx.z * W, nsl = a.D / W;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);

  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, BT, kv_end, lo, hi);
  for (int kv0 = (lo / BT) * BT; kv0 < hi; kv0 += BT) {
    float s[R][R] = {};
    for (int sl = 0; sl < nsl; ++sl) {
      __syncthreads();  // the last readers of sQ, sK (and of sV, sP) are done
      load_tile<float, W, BT>(sQ, q + sl * W, a.sq.s, q0, a.S);
      load_tile<float, W, BT>(sK, k + sl * W, a.sk.s, kv0, a.T);
      if (sl == 0) load_tile<float, W, BT>(sV, v + dz, a.sv.s, kv0, a.T);
      __syncthreads();
#pragma unroll 16
      for (int d = 0; d < W; ++d) {
        float qa[R], kb[R];
#pragma unroll
        for (int i = 0; i < R; ++i) qa[i] = sQ[(ty + 16 * i) * LDD + d];
#pragma unroll
        for (int j = 0; j < R; ++j) kb[j] = sK[(tx + 16 * j) * LDD + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[R];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[j] = keep(a, row, kv0 + tx + 16 * j, kv_end);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BT; ++kk) {
      float pa[R], vb[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) pa[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = sV[kk * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h + dz;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[row * a.so.s + tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0 && blockIdx.z == 0) a.lse_out[(int64_t)bh * a.S + row] = m[i] + logf(lc);
  }
}

__global__ void __launch_bounds__(kThreads) flash_dq_wide_kernel(Args a) {
  constexpr int W = kWide, R = kWideR, BT = 16 * R, LDP = BT + 1, LDD = W + 1, NJ = W / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BT * LDD;   // do
  float* sK = sO + BT * LDD;   // k's slice, then k's columns of this block
  float* sV = sK + BT * LDD;
  float* sS = sV + BT * LDD;   // ds
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * BT, dz = blockIdx.z * W, nsl = a.D / W;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* dout = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);

  float lse[R], di[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < a.S ? a.lse[(int64_t)bh * a.S + row] : 0.f;
    di[i] = row < a.S ? a.di[(int64_t)bh * a.S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, BT, kv_end, lo, hi);
  for (int kv0 = (lo / BT) * BT; kv0 < hi; kv0 += BT) {
    float s[R][R] = {}, dp[R][R] = {};
    for (int sl = 0; sl < nsl; ++sl) {
      __syncthreads();
      load_tile<float, W, BT>(sQ, q + sl * W, a.sq.s, q0, a.S);
      load_tile<float, W, BT>(sO, dout + sl * W, a.sdo.s, q0, a.S);
      load_tile<float, W, BT>(sK, k + sl * W, a.sk.s, kv0, a.T);
      load_tile<float, W, BT>(sV, v + sl * W, a.sv.s, kv0, a.T);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < W; ++d) {
        float qa[R], oa[R], kb[R], vb[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qa[i] = sQ[(ty + 16 * i) * LDD + d];
          oa[i] = sO[(ty + 16 * i) * LDD + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          kb[j] = sK[(tx + 16 * j) * LDD + d];
          vb[j] = sV[(tx + 16 * j) * LDD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool ok = row < a.S && keep(a, row, kv0 + tx + 16 * j, kv_end);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    }
    __syncthreads();  // every reader of k's last slice is done
    load_tile<float, W, BT>(sK, k + dz, a.sk.s, kv0, a.T);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BT; ++kk) {
      float da[R], kb[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) da[i] = sS[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = sK[kk * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

  float* dq = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h + dz;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[row * a.sdq.s + tx + 16 * j] = a.scale * acc[i][j];
  }
}

__global__ void __launch_bounds__(kThreads) flash_dkv_wide_kernel(Args a) {
  constexpr int W = kWide, R = kWideR, BT = 16 * R, LDP = BT + 1, LDD = W + 1, NJ = W / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LDD;
  float* sQ = sV + BT * LDD;   // q's slice, then q's columns of this block
  float* sO = sQ + BT * LDD;   // do's slice, then do's columns of this block
  float* sP = sO + BT * LDD;   // p^T: kv rows x q cols
  float* sS = sP + BT * LDP;   // ds^T
  float* sL = sS + BT * LDP;   // lse of the q tile's rows
  float* sD = sL + BT;         // di of the q tile's rows
  const int n = blockIdx.x, b = n / a.Hkv, kvh = n % a.Hkv, group = a.H / a.Hkv;
  const int k0 = blockIdx.y * BT, dz = blockIdx.z * W, nsl = a.D / W;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b), off = a.T - a.S;

  float dk[R][NJ], dv[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int k1 = min(k0 + BT, kv_end);
  const int qlo = a.causal ? max(0, k0 - off) : 0;
  const int qhi = a.window ? min(a.S, k1 - 1 - off + a.window) : a.S;
  for (int hg = 0; k0 < kv_end && hg < group; ++hg) {
    const int h = kvh * group + hg;
    const int64_t bh = (int64_t)b * a.H + h;
    const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
    const float* dout = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    for (int q0 = (qlo / BT) * BT; q0 < qhi; q0 += BT) {
      float s[R][R] = {}, dp[R][R] = {};
      for (int sl = 0; sl < nsl; ++sl) {
        __syncthreads();  // the last readers of the tiles are done
        load_tile<float, W, BT>(sK, k + sl * W, a.sk.s, k0, a.T);
        load_tile<float, W, BT>(sV, v + sl * W, a.sv.s, k0, a.T);
        load_tile<float, W, BT>(sQ, q + sl * W, a.sq.s, q0, a.S);
        load_tile<float, W, BT>(sO, dout + sl * W, a.sdo.s, q0, a.S);
        if (sl == 0) {
          for (int r = threadIdx.x; r < BT; r += kThreads) {
            const int row = q0 + r;
            sL[r] = row < a.S ? a.lse[bh * a.S + row] : 0.f;
            sD[r] = row < a.S ? a.di[bh * a.S + row] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int d = 0; d < W; ++d) {
          float ka[R], va[R], qb[R], ob[R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            ka[i] = sK[(ty + 16 * i) * LDD + d];
            va[i] = sV[(ty + 16 * i) * LDD + d];
          }
#pragma unroll
          for (int j = 0; j < R; ++j) {
            qb[j] = sQ[(tx + 16 * j) * LDD + d];
            ob[j] = sO[(tx + 16 * j) * LDD + d];
          }
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) {
              s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
              dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int col = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = tx + 16 * j, row = q0 + r;
          const bool ok = row < a.S && keep(a, row, col, kv_end);
          const float p = ok ? expf(s[i][j] * a.scale - sL[r]) : 0.f;
          sP[(ty + 16 * i) * LDP + r] = p;
          sS[(ty + 16 * i) * LDP + r] = p * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();  // every reader of q's and do's last slices is done
      load_tile<float, W, BT>(sQ, q + dz, a.sq.s, q0, a.S);
      load_tile<float, W, BT>(sO, dout + dz, a.sdo.s, q0, a.S);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pa[R], da[R], ob[NJ], qb[NJ];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pa[i] = sP[(ty + 16 * i) * LDP + r];
          da[i] = sS[(ty + 16 * i) * LDP + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ob[j] = sO[r * LDD + tx + 16 * j];
          qb[j] = sQ[r * LDD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
            dk[i][j] = fmaf(da[i], qb[j], dk[i][j]);
          }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h + dz;
  float* dvp = static_cast<float*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h + dz;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[row * a.sdk.s + tx + 16 * j] = a.scale * dk[i][j];
      dvp[row * a.sdv.s + tx + 16 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  constexpr int BT = 16 * fma_rows<D>();
  return sizeof(float) * (3 * BT * (D + 1) + BT * (BT + 1));
}
template <int D>
constexpr size_t dq_smem() {
  constexpr int BT = 16 * fma_rows<D>();
  return sizeof(float) * (4 * BT * (D + 1) + BT * (BT + 1));
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int BT = 16 * fma_rows<D>();
  return sizeof(float) * (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT);
}
template <int D>
constexpr size_t fwd_mma_smem() { return sizeof(bf16) * (kBQ + 4 * kBK) * (D + 8); }
template <int D>
constexpr size_t dq_mma_smem() { return sizeof(bf16) * (2 * kBQ + 4 * kBK) * (D + 8); }
template <int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (2 * kBK + 4 * dkv_bq<D>()) * (D + 8) + sizeof(float) * 4 * dkv_bq<D>();
}
static_assert(fwd_smem<256>() <= 232448 && dq_smem<256>() <= 232448 &&
                  dkv_smem<256>() <= 232448 && fwd_mma_smem<256>() <= 232448 &&
                  dq_mma_smem<256>() <= 232448 && dkv_mma_smem<256>() <= 232448 &&
                  dkv_smem<128>() <= 232448,
              "every kernel fits an SM's shared memory at its largest head dim");
// The wide kernels' shared memory, the same at every D.
constexpr size_t kWideLd = kWide + 8, kWideFmaLd = kWide + 1, kWideFmaRows = 16 * kWideR;
constexpr size_t kFwdWideMmaSmem = sizeof(bf16) * 6 * kBK * kWideLd;
constexpr size_t kDqWideMmaSmem = sizeof(bf16) * 10 * kBK * kWideLd;
constexpr size_t kDkvWideMmaSmem =
    sizeof(bf16) * (4 * kBK + 8 * 32) * kWideLd + sizeof(float) * 4 * 32;
constexpr size_t kFwdWideSmem =
    sizeof(float) * (3 * kWideFmaRows * kWideFmaLd + kWideFmaRows * (kWideFmaRows + 1));
constexpr size_t kDqWideSmem =
    sizeof(float) * (4 * kWideFmaRows * kWideFmaLd + kWideFmaRows * (kWideFmaRows + 1));
constexpr size_t kDkvWideSmem = sizeof(float) * (4 * kWideFmaRows * kWideFmaLd +
                                                 2 * kWideFmaRows * (kWideFmaRows + 1) +
                                                 2 * kWideFmaRows);
static_assert(kFwdWideMmaSmem <= 232448 && kDqWideMmaSmem <= 232448 &&
                  kDkvWideMmaSmem <= 232448 && kFwdWideSmem <= 232448 &&
                  kDqWideSmem <= 232448 && kDkvWideSmem <= 232448,
              "every wide kernel fits an SM's shared memory");

// The dynamic shared memory a kernel may take is set once per kernel and
// device (the attribute call costs host time on every launch otherwise):
// `configured` holds one bit per device for this one kernel.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a,
           cudaStream_t stream, uint64_t& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured |= uint64_t{1} << dev;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

enum Pass { kFwd, kDq, kDkv };

// The dispatch on dtype: bf16 takes the tensor-core kernels, fp32 the FMA
// kernels, every pass.  The grid: (b*h or b*hkv, q or kv tiles of the
// design's rows, D / the output columns a block owns).
template <typename T, int D>
int launch_pass(Pass pass, const Args& a, cudaStream_t s) {
  static uint64_t configured[3] = {0, 0, 0};  // per pass of this (T, D)
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int rows = kMma ? kBQ : 16 * fma_rows<D>(), z = kMma ? D / mma_out<D>() : 1;
  static_assert(kBQ == kBK, "q and kv tiles of one design have the same rows");
  const int64_t tiles = ((pass == kDkv ? a.T : a.S) + rows - 1) / rows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 q_grid((unsigned)(a.B * a.H), (unsigned)tiles, z);
  const dim3 kv_grid((unsigned)(a.B * a.Hkv), (unsigned)tiles, z);
  if constexpr (kMma) {
    if (pass == kFwd)
      return launch(flash_fwd_mma_kernel<D>, q_grid, kMmaThreads, fwd_mma_smem<D>(), a, s,
                    configured[kFwd]);
    if (pass == kDq)
      return launch(flash_dq_mma_kernel<D>, q_grid, kMmaThreads, dq_mma_smem<D>(), a, s,
                    configured[kDq]);
    return launch(flash_dkv_mma_kernel<D>, kv_grid, kMmaThreads, dkv_mma_smem<D>(), a, s,
                  configured[kDkv]);
  } else {
    if (pass == kFwd)
      return launch(flash_fwd_kernel<T, D>, q_grid, kThreads, fwd_smem<D>(), a, s,
                    configured[kFwd]);
    if (pass == kDq)
      return launch(flash_dq_kernel<T, D>, q_grid, kThreads, dq_smem<D>(), a, s,
                    configured[kDq]);
    return launch(flash_dkv_kernel<T, D>, kv_grid, kThreads, dkv_smem<D>(), a, s,
                  configured[kDkv]);
  }
}

// Past D 256: the wide kernels, D / kWide blocks along grid z.
template <typename T>
int launch_wide(Pass pass, const Args& a, cudaStream_t s) {
  static uint64_t configured[3] = {0, 0, 0};  // per pass of this T
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int rows = kMma ? kBQ : (int)kWideFmaRows;
  static_assert(kBQ == kBK, "q and kv tiles of one design have the same rows");
  const int64_t tiles = ((pass == kDkv ? a.T : a.S) + rows - 1) / rows, z = a.D / kWide;
  if (tiles > 65535 || z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 q_grid((unsigned)(a.B * a.H), (unsigned)tiles, (unsigned)z);
  const dim3 kv_grid((unsigned)(a.B * a.Hkv), (unsigned)tiles, (unsigned)z);
  if constexpr (kMma) {
    if (pass == kFwd)
      return launch(flash_fwd_wide_mma_kernel, q_grid, kMmaThreads, kFwdWideMmaSmem, a, s,
                    configured[kFwd]);
    if (pass == kDq)
      return launch(flash_dq_wide_mma_kernel, q_grid, kMmaThreads, kDqWideMmaSmem, a, s,
                    configured[kDq]);
    return launch(flash_dkv_wide_mma_kernel, kv_grid, kMmaThreads, kDkvWideMmaSmem, a, s,
                  configured[kDkv]);
  } else {
    if (pass == kFwd)
      return launch(flash_fwd_wide_kernel, q_grid, kThreads, kFwdWideSmem, a, s,
                    configured[kFwd]);
    if (pass == kDq)
      return launch(flash_dq_wide_kernel, q_grid, kThreads, kDqWideSmem, a, s, configured[kDq]);
    return launch(flash_dkv_wide_kernel, kv_grid, kThreads, kDkvWideSmem, a, s,
                  configured[kDkv]);
  }
}

template <typename T>
int launch_d(Pass pass, const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_pass<T, 16>(pass, a, s);
    case 32: return launch_pass<T, 32>(pass, a, s);
    case 64: return launch_pass<T, 64>(pass, a, s);
    case 128: return launch_pass<T, 128>(pass, a, s);
    case 256: return launch_pass<T, 256>(pass, a, s);
    default:
      if (D > 256 && D % kWide == 0) return launch_wide<T>(pass, a, s);
      return (int)cudaErrorInvalidValue;
  }
}

Strides strides_at(const int64_t* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

Args make_args(int B, int H, int Hkv, int S, int T, double scale, int causal, int window,
               int use_valid) {
  Args a = {};
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.T = T;
  a.scale = (float)scale;
  a.causal = causal;
  a.window = window;
  a.use_valid = use_valid;
  return a;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool rows16(const Strides& s) { return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0; }

// What the tensor-core kernels move in 16-byte pieces: base pointers and
// (b, h, s) strides of bf16 tensors.
bool mma_aligned(Pass pass, const Args& a) {
  const bool in = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && rows16(a.sq) &&
                  rows16(a.sk) && rows16(a.sv);
  if (pass == kFwd) return in && aligned16(a.o) && rows16(a.so);
  const bool grad_in = in && aligned16(a.dout) && rows16(a.sdo);
  if (pass == kDq) return grad_in && aligned16(a.dq) && rows16(a.sdq);
  return grad_in && aligned16(a.dk) && aligned16(a.dv) && rows16(a.sdk) && rows16(a.sdv);
}

int run(Pass pass, Args a, int dtype, int D, void* stream) {
  a.D = D;
  if (a.B < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.S < 1 || a.T < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !mma_aligned(pass, a))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(pass, a, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(pass, a, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, do and the gradients
// share it).  strides: the (b, h, s) element strides of each 4-D tensor
// argument, in argument order.  Each returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorMisalignedAddress (nothing launched)
// for a bf16 pass whose tensors are not 16-byte aligned.

int flash_fwd(const void* q, const void* k, const void* v, const int* valid, void* o,
              float* lse, const int64_t* strides, int dtype, int B, int H, int Hkv, int S,
              int T, int D, double scale, int causal, int window, int use_valid,
              void* stream) {
  Args a = make_args(B, H, Hkv, S, T, scale, causal, window, use_valid);
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = valid;
  a.o = o;
  a.lse_out = lse;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  return run(kFwd, a, dtype, D, stream);
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* di, const int* valid, void* dq, const int64_t* strides, int dtype,
             int B, int H, int Hkv, int S, int T, int D, double scale, int causal,
             int window, int use_valid, void* stream) {
  Args a = make_args(B, H, Hkv, S, T, scale, causal, window, use_valid);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.valid = valid;
  a.dq = dq;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.sdo = strides_at(strides, 3);
  a.sdq = strides_at(strides, 4);
  return run(kDq, a, dtype, D, stream);
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* di, const int* valid, void* dk, void* dv,
              const int64_t* strides, int dtype, int B, int H, int Hkv, int S, int T, int D,
              double scale, int causal, int window, int use_valid, void* stream) {
  Args a = make_args(B, H, Hkv, S, T, scale, causal, window, use_valid);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.valid = valid;
  a.dk = dk;
  a.dv = dv;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.sdo = strides_at(strides, 3);
  a.sdk = strides_at(strides, 4);
  a.sdv = strides_at(strides, 5);
  return run(kDkv, a, dtype, D, stream);
}

}  // extern "C"
