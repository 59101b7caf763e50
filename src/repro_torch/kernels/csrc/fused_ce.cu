// Fused chunked-vocab cross-entropy for Hopper (sm_90a): forward, dh, dw.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_ce.py:
//   fused_ce_fwd_kernel (+ fused_ce_fwd_combine_kernel) <- _fwd_kernel (K6, pallas_call at :218)
//   fused_ce_dh_kernel  (+ fused_ce_dh_combine_kernel)  <- _dh_kernel  (K7, pallas_call at :246)
//   fused_ce_dw_kernel                                  <- _dw_kernel  (K8, pallas_call at :262)
//
// What they compute, for gathered rows h (N, D), the vocab projection w
// (V, D) in the embedding layout and labels in [0, V), with s = h w^T in
// fp32 (the (N, V) logits, which never exist in device memory):
//   K6: per row the log-sum-exp of s (online over vocab tiles: running max m
//       and sum l), the label logit, and the argmax with first-occurrence
//       ties (jnp.argmax); nll = lse - s[label], correct = argmax == label.
//   K7: dh = sum over vocab tiles of ((p - onehot(label)) g) w_tile, with
//       p = exp(s - lse) rebuilt from the forward's lse and g the
//       cotangent of nll.
//   K8: dw_tile = sum over rows of ((p - onehot(label)) g)^T h.
// Columns at or past V are masked here (no padded copy of w): their logit is
// the finite -1e30, never -inf, their p is 0 and they never win the argmax.
// Rows at or past N read as 0 and are never written.  A row whose cotangent
// is 0 contributes exactly 0 to dh and dw.
//
// Bound on an H100 SXM.  At BERT-large's main path (N = 32 x 20 = 640
// supervised rows, D 1024, V 30522, bf16) K6 does 2 N V D = 40 GFLOP and
// K7 and K8 4 N V D = 80 GFLOP each, against 63 MB of w and 1.3 MB of h:
// 0.04 and 0.08 ms at the 989 TFLOP/s of bf16 tensor cores, 0.02 ms at
// 3.35 TB/s, so all three are bound by operations.  This first version
// computes in fp32 FMA from shared-memory tiles (no tensor cores), so it runs
// against the card's 67 TFLOP/s fp32 rate instead.
//
// Design.  The TPU kernels walk a sequential vocab grid axis, carrying m, l,
// the label logit, the argmax and the dh accumulator in VMEM.  On Hopper the
// blocks run in parallel and one block per row tile would give 20 blocks on
// 132 SMs, so the vocab is split across blocks instead:
//   K6: one block per (32-row tile, vocab split) loops over the split's
//     128-column tiles and writes its partial (m, l, label logit, argmax) to a
//     (splits, N) scratch; a second small kernel merges the splits in a fixed
//     order (a strict > keeps the earlier split's column on a tie, as the
//     lowest column wins within a split).
//   K7: one block per (32-row tile, vocab split) owns a 32 x D fp32
//     accumulator in shared memory and writes it to a (splits, N, D) scratch;
//     a second kernel sums the splits in a fixed order and casts to h's type.
//   K8: one block per 32-row vocab tile owns its 32 x D dw accumulator and
//     loops over every 128-row tile of h, as the TPU kernel owns a (bv, D)
//     tile.
// No atomics: every run gives the same bits.  K7 and K8 share one body: an
// "owner" tile of 32 rows (h rows for K7, w rows for K8) against "other"
// tiles of 128 rows (w rows for K7, h rows for K8).  For each other tile the
// 32 x 128 score tile is formed over D in chunks of 32 (both operands staged
// in fp32 shared memory, rows padded by one float), turned into dlogits in
// shared memory, and multiplied into the accumulator over D in chunks of
// 128 (the other tile's 128 x 128 chunk staged in shared memory).  256
// threads: warp ty owns owner rows ty + 8 i and lane tx other columns
// tx + 32 j (i, j < 4), so each row's reductions are one warp's shuffles.
// The accumulator takes 128 KB at D 1024, so K7 and K8 run one block per
// SM; D is at most 1024.  The split count is planned per shape
// (fused_ce_plan) from the kernel's blocks per SM, so that the grid fills
// whole waves.  Tensor cores (wgmma), TMA loads and a pipeline of staged
// chunks are left for later (loads issued into registers a chunk ahead
// pushed K7 and K8 to 255 registers with spills and made K8 slower).
//
// Nothing is allocated here and nothing synchronises: the caller allocates
// outputs and scratch and the kernels run on its stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBO = 32;            // owner rows of a block
constexpr int kBT = 128;           // other rows of a tile (vocab columns in K6/K7)
constexpr int kKC = 32;            // depth of one chunk of the score product
constexpr int kLDK = kKC + 1;      // row stride of a staged score operand
constexpr int kDC = 128;           // width of one D chunk of the gradient product
constexpr int kMaxD = 1024;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads / 32 * 4 == kBO && kBT == 4 * 32,
              "warp ty owns rows ty + 8 i and lane tx columns tx + 32 j, i, j < 4");
static_assert(kBT * kDC >= (kBO + kBT) * kLDK, "score operands alias the gradient chunk");

struct Args {
  const void* h;
  const void* w;
  const int* lbl;
  const float* lse;
  const float* g;
  float* nll;
  float* correct;
  float* lse_out;
  float* part;      // K6: (3, splits, N) m, l, label logit; K7: (splits, N, D)
  int* part_idx;    // K6: (splits, N) argmax column
  void* out;        // K7: dh (N, D); K8: dw (V, D); contiguous
  int64_t sh, sw;   // row strides of h and w, in elements
  int N, V, D, splits, tiles_per_split;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// s[i][j] = A[a0 + ty + 8 i] . B[b0 + tx + 32 j] in fp32 over all D, rows
// past na / nb reading as 0.  sA (kBO x kLDK) and sB (kBT x kLDK) are staging
// buffers; the first __syncthreads waits for their last readers.
template <typename T>
__device__ __forceinline__ void score_tile(const T* A, int64_t sa, int a0, int na, const T* B,
                                           int64_t sb, int b0, int nb, int D, float* sA,
                                           float* sB, float (&s)[4][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kKC) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBO * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC, row = a0 + r, col = k0 + c;
      sA[r * kLDK + c] = row < na && col < D ? ld(A + (int64_t)row * sa + col) : 0.f;
    }
    for (int e = threadIdx.x; e < kBT * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC, row = b0 + r, col = k0 + c;
      sB[r * kLDK + c] = row < nb && col < D ? ld(B + (int64_t)row * sb + col) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kKC; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[(ty + 8 * i) * kLDK + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 32 * j) * kLDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ce_fwd_kernel(Args a) {
  __shared__ float sA[kBO * kLDK];
  __shared__ float sB[kBT * kLDK];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kBO, split = blockIdx.y;
  const int n_tiles = (a.V + kBT - 1) / kBT;
  const int t_lo = split * a.tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + a.tiles_per_split);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);

  int lbl[4], best[4];
  float m[4], l[4], ll[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 8 * i;
    lbl[i] = row < a.N ? a.lbl[row] : -1;
    best[i] = 0;
    m[i] = kNegInf;
    l[i] = 0.f;
    ll[i] = kNegInf;
  }
  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * kBT;
    float s[4][4];
    score_tile<T>(h, a.sh, r0, a.N, w, a.sw, c0, a.V, a.D, sA, sB, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the tile's max and the lowest column reaching it (every tile holds
      // at least one real column, so mx is finite)
      float mx = kNegInf;
      int arg = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 32 * j;
        if (col >= a.V) s[i][j] = kNegInf;
        if (s[i][j] > mx) {
          mx = s[i][j];
          arg = col;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float om = __shfl_xor_sync(kFull, mx, o);
        const int oa = __shfl_xor_sync(kFull, arg, o);
        if (om > mx || (om == mx && oa < arg)) {
          mx = om;
          arg = oa;
        }
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += c0 + tx + 32 * j < a.V ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(sum);
      if (mx > m[i]) best[i] = arg;   // strict: an earlier tile keeps a tie
      m[i] = m_new;
      const int rel = lbl[i] - c0;    // the same for the whole warp
      if (rel >= 0 && rel < kBT) {
        const int jl = rel >> 5;
        float v = s[i][0];
        if (jl == 1) v = s[i][1];
        if (jl == 2) v = s[i][2];
        if (jl == 3) v = s[i][3];
        ll[i] = __shfl_sync(kFull, v, rel & 31);
      }
    }
  }
  if (tx == 0) {
    const int64_t sn = (int64_t)a.splits * a.N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 8 * i;
      if (row >= a.N) continue;
      const int64_t e = (int64_t)split * a.N + row;
      a.part[e] = m[i];
      a.part[sn + e] = l[i];
      a.part[2 * sn + e] = ll[i];
      a.part_idx[e] = best[i];
    }
  }
}

// Merges the splits of each row in split order: lse, nll, correct.
__global__ void __launch_bounds__(kThreads) fused_ce_fwd_combine_kernel(Args a) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const int64_t sn = (int64_t)a.splits * a.N;
  float m = a.part[n];
  int best = a.part_idx[n];
  for (int s = 1; s < a.splits; ++s) {
    const float ms = a.part[(int64_t)s * a.N + n];
    if (ms > m) {   // strict: the earlier split keeps a tie
      m = ms;
      best = a.part_idx[(int64_t)s * a.N + n];
    }
  }
  float l = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const int64_t e = (int64_t)s * a.N + n;
    l += a.part[sn + e] * expf(a.part[e] - m);
  }
  const int lab = a.lbl[n];
  const int ls = min(max(lab / kBT / a.tiles_per_split, 0), a.splits - 1);
  const float ll = a.part[2 * sn + (int64_t)ls * a.N + n];
  const float lse = m + logf(fmaxf(l, 1e-30f));
  a.lse_out[n] = lse;
  a.nll[n] = lse - ll;
  a.correct[n] = best == lab ? 1.f : 0.f;
}

// ---------------------------------------------------------------------------
// K7, K8: dh and dw
// ---------------------------------------------------------------------------

constexpr size_t grad_smem(int D) {
  return sizeof(float) * ((size_t)kBO * D + kBO * kBT + kBT * kDC + 3 * kBT);
}

// kOwnVocab false (K7): the block owns 32 rows of h and loops over the
// vocab tiles of split blockIdx.y.  true (K8): it owns 32 rows of w and
// loops over every 128-row tile of h.
template <typename T, bool kOwnVocab>
__device__ __forceinline__ void grad_body(const Args& a) {
  extern __shared__ float smem[];
  float* sAcc = smem;                     // kBO x D accumulator
  float* sL = sAcc + kBO * a.D;           // kBO x kBT dlogits
  float* sBuf = sL + kBO * kBT;           // kBT x kDC chunk of the other tile
  float* sA = sBuf;                       // score operands, aliasing sBuf
  float* sB = sBuf + kBO * kLDK;
  float* sLse = sBuf + kBT * kDC;         // K8: the other tile's rows' lse, g, label
  float* sG = sLse + kBT;
  int* sLbl = reinterpret_cast<int*>(sG + kBT);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int o0 = blockIdx.x * kBO;
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const T* A = kOwnVocab ? w : h;
  const T* B = kOwnVocab ? h : w;
  const int64_t sa = kOwnVocab ? a.sw : a.sh, sb = kOwnVocab ? a.sh : a.sw;
  const int na = kOwnVocab ? a.V : a.N, nb = kOwnVocab ? a.N : a.V;
  const int n_tiles = (nb + kBT - 1) / kBT;
  const int t_lo = kOwnVocab ? 0 : blockIdx.y * a.tiles_per_split;
  const int t_hi = kOwnVocab ? n_tiles : min(n_tiles, t_lo + a.tiles_per_split);

  float o_lse[4], o_g[4];   // K7: the owner rows' lse, g and label
  int o_lbl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = o0 + ty + 8 * i;
    const bool ok = !kOwnVocab && row < a.N;
    o_lse[i] = ok ? a.lse[row] : 0.f;
    o_g[i] = ok ? a.g[row] : 0.f;
    o_lbl[i] = ok ? a.lbl[row] : -1;
  }
  // each thread reads and writes only its own accumulator entries
  for (int c0 = 0; c0 < a.D; c0 += kDC)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 32 * j;
        if (col < a.D) sAcc[(ty + 8 * i) * a.D + col] = 0.f;
      }

  for (int t = t_lo; t < t_hi; ++t) {
    const int b0 = t * kBT;
    float s[4][4];
    score_tile<T>(A, sa, o0, na, B, sb, b0, nb, a.D, sA, sB, s);
    if (kOwnVocab) {
      // the last readers of sLse/sG/sLbl were before the syncs above
      for (int r = threadIdx.x; r < kBT; r += kThreads) {
        const int n = b0 + r;
        const bool ok = n < a.N;
        sLse[r] = ok ? a.lse[n] : 0.f;
        sG[r] = ok ? a.g[n] : 0.f;
        sLbl[r] = ok ? a.lbl[n] : -1;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int own = o0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 32 * j, oth = b0 + c;
        const int n = kOwnVocab ? oth : own, v = kOwnVocab ? own : oth;
        const float lse = kOwnVocab ? sLse[c] : o_lse[i];
        const float g = kOwnVocab ? sG[c] : o_g[i];
        const int lab = kOwnVocab ? sLbl[c] : o_lbl[i];
        const bool ok = n < a.N && v < a.V;
        const float p = ok ? expf(s[i][j] - lse) : 0.f;
        sL[(ty + 8 * i) * kBT + c] = ok ? (p - (lab == v ? 1.f : 0.f)) * g : 0.f;
      }
    }
    for (int c0 = 0; c0 < a.D; c0 += kDC) {
      __syncthreads();   // sL is written; the last readers of sBuf are done
      for (int e = threadIdx.x; e < kBT * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC, row = b0 + r, col = c0 + c;
        sBuf[e] = row < nb && col < a.D ? ld(B + (int64_t)row * sb + col) : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 32 * j;
          acc[i][j] = col < a.D ? sAcc[(ty + 8 * i) * a.D + col] : 0.f;
        }
#pragma unroll 8
      for (int k = 0; k < kBT; ++k) {
        float dl[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dl[i] = sL[(ty + 8 * i) * kBT + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sBuf[k * kDC + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dl[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 32 * j;
          if (col < a.D) sAcc[(ty + 8 * i) * a.D + col] = acc[i][j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = o0 + ty + 8 * i;
    if (row >= na) continue;
    for (int c0 = 0; c0 < a.D; c0 += kDC)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 32 * j;
        if (col >= a.D) continue;
        const float x = sAcc[(ty + 8 * i) * a.D + col];
        if (kOwnVocab)
          st(static_cast<T*>(a.out) + (int64_t)row * a.D + col, x);
        else
          a.part[((int64_t)blockIdx.y * a.N + row) * a.D + col] = x;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_ce_dh_kernel(Args a) {
  grad_body<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_ce_dw_kernel(Args a) {
  grad_body<T, true>(a);
}

// dh = the sum of the splits' partials in split order, cast to h's type.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ce_dh_combine_kernel(Args a) {
  const int64_t nd = (int64_t)a.N * a.D;
  T* dh = static_cast<T*>(a.out);
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < nd;
       e += (int64_t)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int s = 0; s < a.splits; ++s) acc += a.part[s * nd + e];
    st(dh + e, acc);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The dynamic shared memory a kernel may take is set once per kernel and
// device (the attribute call costs host time on every launch otherwise):
// `configured` holds one bit per device for this one kernel.
template <typename Kernel>
int launch_big(Kernel kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t stream,
               uint64_t& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)grad_smem(kMaxD));
    if (err != cudaSuccess) return (int)err;
    configured |= uint64_t{1} << dev;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

unsigned blocks_of(int64_t n, int per) { return (unsigned)((n + per - 1) / per); }

enum Pass { kFwd, kDh, kDw };

template <typename T>
int launch_pass(Pass pass, const Args& a, cudaStream_t s) {
  static uint64_t configured[2] = {0, 0};   // dh, dw of this T
  const dim3 split_grid(blocks_of(a.N, kBO), (unsigned)a.splits);
  cudaError_t err;
  switch (pass) {
    case kFwd:
      fused_ce_fwd_kernel<T><<<split_grid, kThreads, 0, s>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      fused_ce_fwd_combine_kernel<<<blocks_of(a.N, kThreads), kThreads, 0, s>>>(a);
      return (int)cudaGetLastError();
    case kDh: {
      const int e = launch_big(fused_ce_dh_kernel<T>, split_grid, grad_smem(a.D), a, s,
                               configured[0]);
      if (e != 0) return e;
      const int64_t nd = (int64_t)a.N * a.D;
      const unsigned nb = (unsigned)(blocks_of(nd, kThreads) < 8192 ? blocks_of(nd, kThreads) : 8192);
      fused_ce_dh_combine_kernel<T><<<nb, kThreads, 0, s>>>(a);
      return (int)cudaGetLastError();
    }
    default:
      return launch_big(fused_ce_dw_kernel<T>, dim3(blocks_of(a.V, kBO)), grad_smem(a.D), a, s,
                        configured[1]);
  }
}

// Vocab splits for a (row tile, split) grid of K6 (kFwd) or K7 (kDh): the
// count that minimises waves x the longest block's vocab tiles, with as many
// blocks resident per SM as the kernel's registers and shared memory allow;
// a tie keeps fewer splits (less scratch).
template <typename T>
int plan(Pass pass, int N, int V, int D) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (pass == kFwd) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_ce_fwd_kernel<T>,
                                                        kThreads, 0);
  } else {
    err = cudaFuncSetAttribute(fused_ce_dh_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)grad_smem(kMaxD));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_ce_dh_kernel<T>,
                                                          kThreads, grad_smem(D));
  }
  if (err != cudaSuccess) return -(int)err;
  const int64_t slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t row_tiles = (N + kBO - 1) / kBO;
  const int n_tiles = (V + kBT - 1) / kBT;
  int best = 1;
  int64_t best_cost = INT64_MAX;
  for (int want = 1; want <= n_tiles && want <= 65535; ++want) {
    const int per = (n_tiles + want - 1) / want;
    if ((n_tiles + per - 1) / per != want) continue;   // each split non-empty
    const int64_t cost = (row_tiles * want + slots - 1) / slots * per;
    if (cost < best_cost) {
      best_cost = cost;
      best = want;
    }
  }
  return best;
}

Args make_args(const void* h, const void* w, const int* lbl, int64_t sh, int64_t sw, int N,
               int V, int D, int splits) {
  Args a = {};
  a.h = h;
  a.w = w;
  a.lbl = lbl;
  a.sh = sh;
  a.sw = sw;
  a.N = N;
  a.V = V;
  a.D = D;
  a.splits = splits < 1 ? 1 : splits;
  const int n_tiles = (V + kBT - 1) / kBT;
  a.tiles_per_split = (n_tiles + a.splits - 1) / a.splits;
  return a;
}

int run(Pass pass, const Args& a, int dtype, void* stream) {
  const int n_tiles = (a.V + kBT - 1) / kBT;
  // every split holds at least one vocab tile, so each partial max is finite
  if (a.N < 1 || a.V < 1 || a.D < 1 || a.D > kMaxD || a.splits > n_tiles ||
      (int64_t)(a.splits - 1) * a.tiles_per_split >= n_tiles || a.splits > 65535 ||
      a.sh < a.D || a.sw < a.D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pass<float>(pass, a, s);
  if (dtype == 1) return launch_pass<__nv_bfloat16>(pass, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The vocab splits K6 (pass 0) or K7 (pass 1) takes for these sizes on the
// current device (see plan); a negative CUDA error on failure.
int fused_ce_plan(int pass, int dtype, int N, int V, int D) {
  if (N < 1 || V < 1 || D < 1 || D > kMaxD || (pass != 0 && pass != 1))
    return -(int)cudaErrorInvalidValue;
  const Pass p = pass == 0 ? kFwd : kDh;
  if (dtype == 0) return plan<float>(p, N, V, D);
  if (dtype == 1) return plan<__nv_bfloat16>(p, N, V, D);
  return -(int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16 (h, w, dh and dw share it).  h and
// w have contiguous rows of D elements, sh and sw apart; labels are int32 in
// [0, V); lse, g and every other float tensor are contiguous fp32.  part and
// part_idx are scratch of (3, splits, N) floats and (splits, N) ints (K6) or
// (splits, N, D) floats (K7).  Each returns cudaGetLastError() after its
// launches (0 = launched).

int fused_ce_fwd(const void* h, const void* w, const int* lbl, float* nll, float* correct,
                 float* lse, float* part, int* part_idx, int64_t sh, int64_t sw, int dtype,
                 int N, int V, int D, int splits, void* stream) {
  Args a = make_args(h, w, lbl, sh, sw, N, V, D, splits);
  a.nll = nll;
  a.correct = correct;
  a.lse_out = lse;
  a.part = part;
  a.part_idx = part_idx;
  return run(kFwd, a, dtype, stream);
}

int fused_ce_dh(const void* h, const void* w, const int* lbl, const float* lse, const float* g,
                void* dh, float* part, int64_t sh, int64_t sw, int dtype, int N, int V, int D,
                int splits, void* stream) {
  Args a = make_args(h, w, lbl, sh, sw, N, V, D, splits);
  a.lse = lse;
  a.g = g;
  a.out = dh;
  a.part = part;
  return run(kDh, a, dtype, stream);
}

int fused_ce_dw(const void* h, const void* w, const int* lbl, const float* lse, const float* g,
                void* dw, int64_t sh, int64_t sw, int dtype, int N, int V, int D,
                void* stream) {
  Args a = make_args(h, w, lbl, sh, sw, N, V, D, 1);
  a.lse = lse;
  a.g = g;
  a.out = dw;
  return run(kDw, a, dtype, stream);
}

}  // extern "C"
