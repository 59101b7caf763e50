// Differentiable flash attention for Hopper (sm_90a): forward, dq, dk/dv.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel (K3, pallas_call at :313)
//   flash_dq_kernel   <- _dq_kernel  (K4, pallas_call at :360)
//   flash_dkv_kernel  <- _dkv_kernel (K5, pallas_call at :386)
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
// Bound on an H100 SXM.  At BERT-large's shape (B 32, H 16, S = T 128,
// D 64, bf16) each pass reads and writes a few (B, H, S, D) tensors of
// 8.4 MB: 34 MB (K3), 42 MB (K4), 51 MB (K5), 10-15 us at 3.35 TB/s,
// against 2.1-4.3 GFLOP, 2-4 us at the 989 TFLOP/s of bf16 tensor cores:
// bound by bytes.  At S = 512 the work grows as S^2 and the same passes are
// bound by operations.  This first version computes in fp32 FMA from
// shared-memory tiles (no tensor cores), so it runs against the card's
// 67 TFLOP/s fp32 rate instead and stays far above either bound.
//
// Design.  The TPU kernels walk a sequential kv (or q) grid axis and carry
// their accumulators in VMEM from one grid step to the next; on Hopper the
// blocks run in parallel and nothing carries over, so that axis is a loop
// inside one block:
//   K3 and K4: one block per (b*h, 64-row q tile), looping over the kv tiles
//     that hold any unmasked entry for the tile (causal, window and valid
//     bounds skip the rest, where the FLOP saving is);
//   K5: one block per (b*hkv, 64-row kv tile), looping over (q head of the
//     group x q tile); it owns its dk/dv tile, so there are no atomics and
//     every run gives the same bits.
// 256 threads form a 16 x 16 grid; each owns 4 rows x 4 columns of the
// 64 x 64 score tile and 4 rows x D/16 columns of its accumulators, in
// registers.  Row max and row sum reduce over the 16 threads of a half warp
// with shuffles.  Tiles are held in fp32 in dynamic shared memory (up to
// 162 KB at D = 128, above the 48 KB of static shared memory) with rows
// padded by one float so that column reads do not conflict on banks.  p and
// ds stay fp32, as the TPU kernel keeps them.  Tensor cores (wgmma), TMA
// loads and a pipeline of tiles are left for later.
//
// Layouts: every 4-D tensor is read through its (b, h, s) element strides
// with a contiguous last dim, so a (B, S, H, D) model tensor is taken as a
// (B, H, S, D) view without a copy.  lse and di are contiguous fp32
// (B, H, S); valid may be null when use_valid is 0.  Nothing is allocated
// here and nothing synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // q rows of a tile
constexpr int kBK = 64;            // kv rows of a tile
constexpr int kLDP = kBK + 1;      // row stride of a 64 x 64 score tile in smem
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "score tiles are square: p and p^T share kLDP");

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
  int B, H, Hkv, S, T;
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

// kv range [lo, hi) that holds any unmasked entry for q rows [q0, q0 + kBQ).
__device__ __forceinline__ void kv_range(const Args& a, int q0, int kv_end, int& lo, int& hi) {
  const int off = a.T - a.S, q_last = min(q0 + kBQ, a.S) - 1;
  hi = a.causal ? min(kv_end, q_last + off + 1) : kv_end;
  lo = a.window ? max(0, q0 + off - a.window + 1) : 0;
}

// ---------------------------------------------------------------------------
// K3: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LDD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LDD;
  float* sV = sK + kBK * LDD;
  float* sP = sV + kBK * LDD;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  load_tile<T, D, kBQ>(sQ, q, a.sq.s, q0, a.S);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, kv_end, lo, hi);
  for (int kv0 = (lo / kBK) * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    load_tile<T, D, kBK>(sK, k, a.sk.s, kv0, a.T);
    load_tile<T, D, kBK>(sV, v, a.sv.s, kv0, a.T);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * LDD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * LDD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = keep(a, row, kv0 + tx + 16 * j, kv_end);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * kLDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty + 16 * i) * kLDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = sV[kk * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

  T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
  constexpr int LDD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kBQ * LDD;   // do
  float* sK = sO + kBQ * LDD;
  float* sV = sK + kBK * LDD;
  float* sS = sV + kBK * LDD;   // ds
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b);
  load_tile<T, D, kBQ>(sQ, q, a.sq.s, q0, a.S);
  load_tile<T, D, kBQ>(sO, dout, a.sdo.s, q0, a.S);

  float lse[4], di[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < a.S ? a.lse[(int64_t)bh * a.S + row] : 0.f;
    di[i] = row < a.S ? a.di[(int64_t)bh * a.S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, kv_end, lo, hi);
  for (int kv0 = (lo / kBK) * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();
    load_tile<T, D, kBK>(sK, k, a.sk.s, kv0, a.T);
    load_tile<T, D, kBK>(sV, v, a.sv.s, kv0, a.T);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sQ[(ty + 16 * i) * LDD + d];
        oa[i] = sO[(ty + 16 * i) * LDD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = sK[(tx + 16 * j) * LDD + d];
        vb[j] = sV[(tx + 16 * j) * LDD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row < a.S && keep(a, row, kv0 + tx + 16 * j, kv_end);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        sS[(ty + 16 * i) * kLDP + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float da[4], kb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sS[(ty + 16 * i) * kLDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = sK[kk * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
  constexpr int LDD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LDD;
  float* sQ = sV + kBK * LDD;
  float* sO = sQ + kBQ * LDD;   // do
  float* sP = sO + kBQ * LDD;   // p^T: kv rows x q cols
  float* sS = sP + kBK * kLDP;  // ds^T
  float* sL = sS + kBK * kLDP;  // lse of the q tile's rows
  float* sD = sL + kBQ;         // di of the q tile's rows
  const int n = blockIdx.x, b = n / a.Hkv, kvh = n % a.Hkv, group = a.H / a.Hkv;
  const int k0 = blockIdx.y * kBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int kv_end = kv_end_of(a, b), off = a.T - a.S;
  load_tile<T, D, kBK>(sK, k, a.sk.s, k0, a.T);
  load_tile<T, D, kBK>(sV, v, a.sv.s, k0, a.T);

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q rows [qlo, qhi) that see any unmasked key of this tile
  const int k1 = min(k0 + kBK, kv_end);
  const int qlo = a.causal ? max(0, k0 - off) : 0;
  const int qhi = a.window ? min(a.S, k1 - 1 - off + a.window) : a.S;
  for (int hg = 0; k0 < kv_end && hg < group; ++hg) {
    const int h = kvh * group + hg;
    const int64_t bh = (int64_t)b * a.H + h;
    const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    for (int q0 = (qlo / kBQ) * kBQ; q0 < qhi; q0 += kBQ) {
      __syncthreads();  // the last tile's readers are done with sQ, sO, sP, sS
      load_tile<T, D, kBQ>(sQ, q, a.sq.s, q0, a.S);
      load_tile<T, D, kBQ>(sO, dout, a.sdo.s, q0, a.S);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const int row = q0 + r;
        sL[r] = row < a.S ? a.lse[bh * a.S + row] : 0.f;
        sD[r] = row < a.S ? a.di[bh * a.S + row] : 0.f;
      }
      __syncthreads();
      // transposed scores: this thread's kv rows ty + 16 i, q cols tx + 16 j
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = sK[(ty + 16 * i) * LDD + d];
          va[i] = sV[(ty + 16 * i) * LDD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = sQ[(tx + 16 * j) * LDD + d];
          ob[j] = sO[(tx + 16 * j) * LDD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j, row = q0 + r;
          const bool ok = row < a.S && keep(a, row, col, kv_end);
          const float p = ok ? expf(s[i][j] * a.scale - sL[r]) : 0.f;
          sP[(ty + 16 * i) * kLDP + r] = p;
          sS[(ty + 16 * i) * kLDP + r] = p * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pa[4], da[4], ob[NJ], qb[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = sP[(ty + 16 * i) * kLDP + r];
          da[i] = sS[(ty + 16 * i) * kLDP + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ob[j] = sO[r * LDD + tx + 16 * j];
          qb[j] = sQ[r * LDD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
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
  for (int i = 0; i < 4; ++i) {
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
// launches
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() { return sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * kLDP); }
template <int D>
constexpr size_t dq_smem() { return sizeof(float) * (2 * (kBQ + kBK) * (D + 1) + kBQ * kLDP); }
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (kBQ + kBK) * (D + 1) + 2 * kBK * kLDP + 2 * kBQ);
}

// The dynamic shared memory a kernel may take is set once per kernel and
// device (the attribute call costs host time on every launch otherwise):
// `configured` holds one bit per device for this one kernel.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t stream,
           uint64_t& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured |= uint64_t{1} << dev;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

enum Pass { kFwd, kDq, kDkv };

template <typename T, int D>
int launch_pass(Pass pass, const Args& a, cudaStream_t s) {
  static uint64_t configured[3] = {0, 0, 0};  // per pass of this (T, D)
  const dim3 q_grid((unsigned)(a.B * a.H), (unsigned)((a.S + kBQ - 1) / kBQ));
  const dim3 kv_grid((unsigned)(a.B * a.Hkv), (unsigned)((a.T + kBK - 1) / kBK));
  switch (pass) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, q_grid, fwd_smem<D>(), a, s, configured[kFwd]);
    case kDq:
      return launch(flash_dq_kernel<T, D>, q_grid, dq_smem<D>(), a, s, configured[kDq]);
    default:
      return launch(flash_dkv_kernel<T, D>, kv_grid, dkv_smem<D>(), a, s, configured[kDkv]);
  }
}

template <typename T>
int launch_d(Pass pass, const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_pass<T, 16>(pass, a, s);
    case 32: return launch_pass<T, 32>(pass, a, s);
    case 64: return launch_pass<T, 64>(pass, a, s);
    case 128: return launch_pass<T, 128>(pass, a, s);
    default: return (int)cudaErrorInvalidValue;
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

int run(Pass pass, const Args& a, int dtype, int D, void* stream) {
  if (a.B < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.S < 1 || a.T < 1 ||
      (int64_t)a.S > 65535LL * kBQ || (int64_t)a.T > 65535LL * kBK)
    return (int)cudaErrorInvalidValue;
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
// launch (0 = launched).

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
