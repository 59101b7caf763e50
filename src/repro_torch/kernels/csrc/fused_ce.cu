// Fused chunked-vocab cross-entropy for Hopper (sm_90a): forward, dh, dw.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_ce.py:
//   fused_ce_fwd_mma_kernel (bf16), fused_ce_fwd_kernel (fp32)
//                      (+ fused_ce_fwd_combine_kernel)  <- _fwd_kernel (K6, pallas_call at :218)
//   fused_ce_dh_mma_kernel (bf16), fused_ce_dh_kernel (fp32)
//                       (+ fused_ce_dh_combine_kernel)  <- _dh_kernel  (K7, pallas_call at :246)
//   fused_ce_dw_mma_kernel (bf16), fused_ce_dw_kernel (fp32)
//                                                       <- _dw_kernel  (K8, pallas_call at :262)
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
//
// A vocab slice (tensor parallelism over a model axis): w holds the V rows
// from global row v0.  K6 takes v0 and compares each label against v0 + its
// local column, so a label outside [v0, v0 + V) is no hit: its label logit
// stays -1e30 (the tile and split arithmetic below only ever reads a split
// that holds no such column, or a masked one) and it is never correct.  On
// request K6 also writes each row's label logit, max logit and first argmax
// as a global index (v0 + column), which the caller merges over the slices.
// K7 and K8 take labels already shifted by v0: they compare a label only
// against columns in [0, V), so one outside it is no hit and is never used
// as an address.
// Rows at or past N read as 0 and are never written.  A row whose cotangent
// is 0 contributes exactly 0 to dh and dw.
//
// Bound on an H100 SXM.  At BERT-large's main path (N = 32 x 20 = 640
// supervised rows, D 1024, V 30522, bf16) K6 does 2 N V D = 40 GFLOP and
// K7 and K8 4 N V D = 80 GFLOP each, against 63 MB of w and 1.3 MB of h:
// 0.04 and 0.08 ms at the 989 TFLOP/s of bf16 tensor cores, 0.02 ms at
// 3.35 TB/s, so all three are bound by operations.
//
// Two designs of each, chosen by the caller (fused_ce.py) and checked here
// (not a fallback: a call names its design):
//   mma (bf16 whose h and w can be copied in 16-byte pieces: 16-byte aligned
//     bases, row strides and D multiples of 8 elements): the tensor-core
//     kernels fused_ce_fwd_mma_kernel, fused_ce_dh_mma_kernel and
//     fused_ce_dw_mma_kernel below;
//   fma (fp32, and bf16 that cannot be copied so): fp32 FMA kernels from
//     shared-memory tiles, fused_ce_fwd_kernel, fused_ce_dh_kernel and
//     fused_ce_dw_kernel.  The reference multiplies fp32 inputs in fp32; the
//     tensor cores would make that TF32, another function.
//
// Vocab and ownership.  The TPU kernels walk a sequential vocab grid axis,
// carrying m, l, the label logit, the argmax and the dh accumulator in VMEM.
// On Hopper the blocks run in parallel and one block per row tile would give
// 20 blocks on 132 SMs, so the vocab is split across blocks instead:
//   K6: one block per (row tile, vocab split) loops over the split's
//     128-column tiles and writes its partial (m, l, label logit, argmax) to a
//     (splits, N) scratch; a second small kernel merges the splits in a fixed
//     order (a strict > keeps the earlier split's column on a tie, as the
//     lowest column wins within a split).  The row tile is 32 rows in the
//     FMA design, 64 in the tensor-core design, whose h rows stay in shared
//     memory: each row tile reads its split's w from L2 again (w is 62.5 MB
//     in bf16), so 64 rows halve those reads against 32 (1.25 GB of L2 reads
//     a call at the main path's N 640 with 32-row tiles).
//   K7: one block per (32-row tile, vocab split) owns a 32 x D fp32
//     accumulator and writes it to a (splits, N, D) scratch; a second kernel
//     sums the splits in a fixed order and casts to h's type.  The row tile
//     is fastest in blockIdx, so the row tiles of one split run together and
//     their re-reads of the split's w tiles hit L2 (w is 62.5 MB in bf16,
//     more than the 50 MB L2).
//   K8: one block per 32-row vocab tile owns its 32 x D dw accumulator and
//     loops over every row tile of h, as the TPU kernel owns a (bv, D) tile.
// No atomics: every run gives the same bits.  The split count is planned per
// shape (fused_ce_plan) from the blocks per SM of the kernel that will run,
// so that the grid fills whole waves.  K7 and K8 share one body in each
// design: an "owner" tile of 32 rows (h rows for K7, w rows for K8) against
// "other" tiles (w rows for K7, h rows for K8).  For each other tile the
// score tile s is formed once over all of D, turned into dlogits =
// (exp(s - lse) - onehot) g, and multiplied into the accumulator over D in
// chunks of 128 columns.  The accumulator takes 128 KB at D 1024, so one
// block runs per SM.
//
// Any D: a block holds at most one D window of kDW = 1024 columns.  K7 and
// K8 get a grid axis over the windows (blockIdx.z): each block owns its
// rows' gradient in one window and forms the scores over all of D, window
// by window, so at D > 1024 the scores (and their loads) are repeated once
// per window; the FMA design's accumulator is one window wide.  K6's
// tensor-core kernel keeps its h rows resident over one window and loads
// each window again at its first chunk of every vocab tile; its FMA kernel
// streams D in any case.  Up to D 1024 every kernel runs as before.
//
// The tensor-core design (bf16).  8 warps; both products on mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) from ldmatrix fragments.  bf16 x bf16
// products are exact in fp32, so s differs from the reference's fp32 product
// only in the order of the sums.  dlogits are fp32 (the reference keeps them
// so) and enter the second product as two bf16 terms t0 = bf16(x),
// t1 = bf16(x - t0) (~16 mantissa bits), one mma per term: one bf16 term
// (8 bits) misses the fp32-level agreement the tests hold the kernels to
// (tests/test_torch_fused_ce.py emulates both).  The 32 owner rows stay in
// shared memory for the whole block, and so does the current other tile of
// 64 rows, all of D for both (bf16, rows padded by 16 bytes so that the 8
// rows of an ldmatrix phase fall on distinct banks): 198 KB at D 1024.  So
// the second product reads the other tile the score read, and each tile
// crosses from L2 once.  The accumulator lives in registers, spread over the
// 8 warps: warp w holds owner rows 16 (w % 2) .. + 15 and columns 32 (w / 2)
// .. + 31 of every 128-column D chunk, 128 fp32 registers a thread.  Per
// other tile: warp w forms the score of its owner rows against other rows
// 16 (w / 2) .. + 15; the dlogits go to shared memory as the two bf16
// terms; every warp takes the A fragments of its 16 rows over the tile's 64
// columns into registers and adds, chunk by chunk of D, its share of
// dlogits x other rows.  The other tile is staged by 16-byte cp.async
// (ragged rows and columns zero-filled), two D chunks to a group: once every
// warp is done with a pair of chunks in the second product, the next tile's
// pair streams into its place, and the next score waits pair by pair, so the
// loads overlap the rest of the tile's work.  Tried and not kept (PERF.md):
// the accumulator in fp32 shared memory (a two-slot ring is all that then
// fits: 1.64 ms for K7 at the main path's shape), a four-slot ring that
// streams the other tile twice (1.03 ms), and a score split four ways over
// D between warps (3% faster, but 255 registers with spills).
//
// K6 in the tensor-core design: 8 warps; the block's 64 h rows stay in
// shared memory over all of D (bf16, rows padded by 16 bytes: 129 KB at D
// 1024), and the w rows of each 128-column vocab tile stream through a
// four-slot cp.async ring in chunks of 64 D columns (18 KB a slot), one
// __syncthreads per chunk.  Warp w forms, on mma.sync from ldmatrix
// fragments, the 32 x 32 score block of h rows 32 (w % 2) .. and columns
// 32 (w / 2) ..; bf16 x bf16 products are exact in fp32, so s differs from
// the reference only in the order of the sums, and no split into terms is
// needed.  When a tile's scores are whole the warp updates, in fp32
// registers on fragment coordinates, each of its rows' running max, its
// share of the sum (the quad sums at the end), the argmax as (max, lowest
// column; a strict > across tiles, whose columns rise) and, in the one lane
// that holds the label's column, the label logit.  At the end the 4 warps
// that share rows merge through shared memory by (larger max, then lower
// column) and one thread per row writes the split's partial.
//
// The FMA design (fp32, and bf16 that cannot be staged in 16-byte pieces):
// the same ownership, 256 threads: warp ty owns owner rows ty + 8 i and lane
// tx other columns tx + 32 j (i, j < 4), so each row's reductions are one
// warp's shuffles.  The score tile is formed over D in chunks of 32 (both
// operands staged in fp32 shared memory, rows padded by one float), turned
// into dlogits in shared memory and multiplied into the accumulator over D in
// chunks of 128 (the other tile's 128 x 128 chunk staged in shared memory).
//
// Nothing is allocated here and nothing synchronises: the caller allocates
// outputs and scratch and the kernels run on its stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBO = 32;            // owner rows of a block
constexpr int kBT = 128;           // other rows of a tile (vocab columns in K6/K7)
constexpr int kKC = 32;            // depth of one chunk of the score product
constexpr int kLDK = kKC + 1;      // row stride of a staged score operand
constexpr int kDC = 128;           // width of one D chunk of the gradient product
constexpr int kDW = 1024;          // width of one D window (what a block holds at once)
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
  float* ll_out;    // K6, optional (null: not written): label logit, row max,
  float* max_out;   // first argmax as a global index
  int* idx_out;
  float* part;      // K6: (3, splits, N) m, l, label logit; K7: (splits, N, D)
  int* part_idx;    // K6: (splits, N) argmax column
  void* out;        // K7: dh (N, D); K8: dw (V, D); contiguous
  int64_t sh, sw;   // row strides of h and w, in elements
  int N, V, D, splits, tiles_per_split;
  int v0;           // K6: the global vocab row of w's first row
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
    lbl[i] = row < a.N ? a.lbl[row] - a.v0 : -1;
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
  const int lab = a.lbl[n] - a.v0;   // local; outside [0, V): no hit
  const int ls = min(max(lab / kBT / a.tiles_per_split, 0), a.splits - 1);
  const float ll = a.part[2 * sn + (int64_t)ls * a.N + n];
  const float lse = m + logf(fmaxf(l, 1e-30f));
  a.lse_out[n] = lse;
  a.nll[n] = lse - ll;
  a.correct[n] = best == lab ? 1.f : 0.f;
  if (a.ll_out) a.ll_out[n] = ll;
  if (a.max_out) a.max_out[n] = m;
  if (a.idx_out) a.idx_out[n] = best + a.v0;
}

// ---------------------------------------------------------------------------
// K6 on the tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int kBO6 = 64;           // h rows of a block, resident over all of D
constexpr int kDC6 = 64;           // D columns of one streamed w chunk
constexpr int kStages6 = 4;        // w chunks in flight (the cp.async ring)
constexpr int kLDW6 = kDC6 + 8;    // row stride (bf16) of a staged w chunk
static_assert(kThreads / 32 == 8 && kBO6 == 2 * 32 && kBT == 4 * 32,
              "warp w owns h rows 32 (w % 2) .. + 31 and vocab columns 32 (w / 2) .. + 31 of "
              "each 128-column tile");
static_assert(kBT * kDC6 / 8 % kThreads == 0, "whole rounds of 16-byte copies");

// Row stride (bf16) of the resident h rows: D in whole chunks, plus 8 so that
// the 8 rows of an ldmatrix phase fall on distinct banks.
__host__ __device__ constexpr int fwd_ld(int D) { return (D + kDC6 - 1) / kDC6 * kDC6 + 8; }

constexpr int kWC6 = kDW / kDC6;  // w chunks of one D window
constexpr size_t fwd_mma_smem(int D) {
  return sizeof(bf16) * ((size_t)kBO6 * fwd_ld(D < kDW ? D : kDW) + kStages6 * kBT * kLDW6);
}
static_assert(fwd_mma_smem(kDW) + sizeof(float) * (3 * 4 + 1) * kBO6 <= 232448,
              "the forward's tensor-core kernel (and its static merge arrays) fits an SM's "
              "shared memory");

// One block per (64-row tile of h, vocab split), the split counted in
// 128-column vocab tiles as the combine counts it (see the note at the top).
// The h rows stay resident over one D window (all of D up to kDW); past it
// each window is loaded again at its first chunk of every vocab tile.
__global__ void __launch_bounds__(kThreads, 1) fused_ce_fwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sM[4][kBO6], sL[4][kBO6], sLL[kBO6];
  __shared__ int sB[4][kBO6];
  const int ld = fwd_ld(min(a.D, kDW)), dr = ld - 8;
  const bool windows = a.D > kDW;
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);  // kBO6 x ld: the h rows of a window
  bf16* sW = sH + kBO6 * ld;                      // kStages6 x kBT x kLDW6: the w ring
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int wm = warp & 1, wn = warp >> 1;
  const int r0 = blockIdx.x * kBO6, split = blockIdx.y;
  const bf16* h = static_cast<const bf16*>(a.h);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int n_tiles = (a.V + kBT - 1) / kBT;
  const int t_lo = split * a.tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + a.tiles_per_split);
  const int nC = (a.D + kDC6 - 1) / kDC6, total = (t_hi - t_lo) * nC;

  // w chunk i of the block's sequence (tile t_lo + i / nC, D chunk i % nC)
  // into ring slot i % kStages6 (ragged rows and columns zero-filled), as one
  // group; past the last an empty group
  auto stage_w = [&](int i) {
    if (i < total) {
      const int c0 = (t_lo + i / nC) * kBT, d0 = (i % nC) * kDC6;
      bf16* dst = sW + (i % kStages6) * kBT * kLDW6;
      constexpr int CH = kDC6 / 8;
#pragma unroll
      for (int u = 0; u < kBT * CH / kThreads; ++u) {
        const int e = u * kThreads + threadIdx.x, r = e / CH, col = d0 + (e % CH) * 8;
        const bool in = c0 + r < a.V && col < a.D;
        cp_async16(dst + r * kLDW6 + (e % CH) * 8, w + (in ? (c0 + r) * a.sw + col : 0), in);
      }
    }
    cp_async_commit();
  };

  // the h rows of the first window (zero-filled past N and D), with the first chunk
  {
    const int per_row = dr / 8;
    for (int e = threadIdx.x; e < kBO6 * per_row; e += kThreads) {
      const int r = e / per_row, c = (e % per_row) * 8, row = r0 + r;
      const bool in = row < a.N && c < a.D;
      cp_async16(sH + r * ld + c, h + (in ? row * a.sh + c : 0), in);
    }
  }
  for (int i = 0; i < kStages6 - 1; ++i) stage_w(i);
  if (threadIdx.x < kBO6) sLL[threadIdx.x] = kNegInf;

  // this lane's rows 32 wm + 16 mt + g + 8 hh, k = 2 mt + hh
  int lbl[4], best[4];
  float m[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = r0 + 32 * wm + 16 * (k >> 1) + g + 8 * (k & 1);
    lbl[k] = row < a.N ? a.lbl[row] - a.v0 : -1;
    best[k] = 0x7fffffff;
    m[k] = kNegInf;
    l[k] = 0.f;
  }
  // sc: one w chunk's products (4 mma k-steps); acc: the tile's scores, the
  // chunks summed with round-to-nearest adds.  mma.sync's fp32 accumulation
  // rounds each k-step's sum toward zero, so one chain over all of D would
  // lose ~D/16 ulps of the score (~2e-4 of an lse at D 7168)
  float sc[2][4][4], acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mt][j][e] = acc[mt][j][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages6 - 2>();  // chunk i (and the h rows) have landed
    __syncthreads();                // and every warp is done with chunk i - 1's slot
    const int dc = i % nC;
    if (windows && i > 0 && dc % kWC6 == 0) {
      // the h rows of the window chunk dc starts, by plain 16-byte loads
      // (outside the ring's cp.async groups), once every warp is done with
      // the last window (the __syncthreads above)
      const int w0 = dc * kDC6, per_row = dr / 8;
      for (int e = threadIdx.x; e < kBO6 * per_row; e += kThreads) {
        const int r = e / per_row, c = (e % per_row) * 8, row = r0 + r;
        const bool in = row < a.N && w0 + c < a.D;
        *reinterpret_cast<uint4*>(sH + r * ld + c) =
            in ? *reinterpret_cast<const uint4*>(h + row * a.sh + w0 + c) : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
    }
    stage_w(i + kStages6 - 1);
    const bf16* sWc = sW + (i % kStages6) * kBT * kLDW6;
#pragma unroll
    for (int kk = 0; kk < kDC6 / 16; ++kk) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ldsm4(af[u], sH + (32 * wm + 16 * u + mr + 8 * (mi & 1)) * ld + kDC6 * (dc % kWC6) +
                         16 * kk + 8 * (mi >> 1));
        ldsm4(bfr[u], sWc + (32 * wn + 16 * u + mr + 8 * (mi >> 1)) * kLDW6 + 16 * kk +
                          8 * (mi & 1));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(sc[mt][j], af[mt], bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][j][e] += sc[mt][j][e];
          sc[mt][j][e] = 0.f;
        }
    if (dc != nC - 1) continue;

    // the tile's scores are whole: this lane's columns c0 + 32 wn + 8 j + 2 t
    // + e, masked to -1e30 at or past V
    const int c0 = (t_lo + i / nC) * kBT + 32 * wn + 2 * t;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int mt = k >> 1, hh = k & 1;
      float mx = kNegInf;
      int arg = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + e;
          float& x = acc[mt][j][2 * hh + e];
          if (col >= a.V) x = kNegInf;
          if (col == lbl[k]) sLL[32 * wm + 16 * mt + g + 8 * hh] = x;  // one lane, one tile
          if (x > mx) {  // columns rise with (j, e): the lowest reaching the max
            mx = x;
            arg = col;
          }
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {  // the quad of lanes that shares the row
        const float om = __shfl_xor_sync(kFull, mx, o);
        const int oa = __shfl_xor_sync(kFull, arg, o);
        if (om > mx || (om == mx && oa < arg)) {
          mx = om;
          arg = oa;
        }
      }
      const float m_new = fmaxf(m[k], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += c0 + 8 * j + e < a.V ? expf(acc[mt][j][2 * hh + e] - m_new) : 0.f;
      l[k] = l[k] * expf(m[k] - m_new) + sum;  // this lane's share; the quad sums at the end
      if (mx > m[k]) best[k] = arg;            // strict: an earlier tile keeps a tie
      m[k] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j][2 * hh] = acc[mt][j][2 * hh + 1] = 0.f;
    }
  }
  cp_async_wait_all();  // only empty groups are left

  // merge: the quad's shares of l, then the 4 column warps of each row in
  // shared memory, then one thread per row writes the split's partial
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    l[k] += __shfl_xor_sync(kFull, l[k], 1);
    l[k] += __shfl_xor_sync(kFull, l[k], 2);
    if (t == 0) {
      const int r = 32 * wm + 16 * (k >> 1) + g + 8 * (k & 1);
      sM[wn][r] = m[k];
      sL[wn][r] = l[k];
      sB[wn][r] = best[k];
    }
  }
  __syncthreads();
  const int r = threadIdx.x, row = r0 + r;
  if (r < kBO6 && row < a.N) {
    float mb = sM[0][r];
    int bb = sB[0][r];
    for (int q = 1; q < 4; ++q)
      if (sM[q][r] > mb || (sM[q][r] == mb && sB[q][r] < bb)) {
        mb = sM[q][r];
        bb = sB[q][r];
      }
    float lb = 0.f;
    for (int q = 0; q < 4; ++q) lb += sL[q][r] * expf(sM[q][r] - mb);
    const int64_t sn = (int64_t)a.splits * a.N, e = (int64_t)split * a.N + row;
    a.part[e] = mb;
    a.part[sn + e] = lb;
    a.part[2 * sn + e] = sLL[r];
    a.part_idx[e] = bb;
  }
}

// ---------------------------------------------------------------------------
// K7, K8: dh and dw, fp32 FMA (fp32, and bf16 the tensor cores cannot stage)
// ---------------------------------------------------------------------------

// At width D a block holds the accumulator of one D window: min(D, kDW).
constexpr size_t grad_smem(int D) {
  return sizeof(float) * ((size_t)kBO * (D < kDW ? D : kDW) + kBO * kBT + kBT * kDC + 3 * kBT);
}

// kOwnVocab false (K7): the block owns 32 rows of h and loops over the
// vocab tiles of split blockIdx.y.  true (K8): it owns 32 rows of w and
// loops over every 128-row tile of h.  Either way it owns the D window
// blockIdx.z of its rows' gradient (columns [z0, z0 + kDW)); the scores are
// formed over all of D in every window's block.
template <typename T, bool kOwnVocab>
__device__ __forceinline__ void grad_body(const Args& a) {
  extern __shared__ float smem[];
  const int z0 = blockIdx.z * kDW, z1 = min(a.D, z0 + kDW), Dw = min(a.D, kDW);
  float* sAcc = smem;                     // kBO x Dw accumulator of columns [z0, z1)
  float* sL = sAcc + kBO * Dw;            // kBO x kBT dlogits
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
  for (int c0 = 0; c0 < Dw; c0 += kDC)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 32 * j;
        if (col < Dw) sAcc[(ty + 8 * i) * Dw + col] = 0.f;
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
    for (int c0 = z0; c0 < z1; c0 += kDC) {
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
          acc[i][j] = col < z1 ? sAcc[(ty + 8 * i) * Dw + col - z0] : 0.f;
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
          if (col < z1) sAcc[(ty + 8 * i) * Dw + col - z0] = acc[i][j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = o0 + ty + 8 * i;
    if (row >= na) continue;
    for (int c0 = z0; c0 < z1; c0 += kDC)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 32 * j;
        if (col >= z1) continue;
        const float x = sAcc[(ty + 8 * i) * Dw + col - z0];
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
// K7, K8 on the tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int kBT2 = 64;              // other rows of the resident other tile
constexpr int kLDL = kBT2 + 8;        // row stride (bf16) of dlogits
constexpr int kTerms = 2;             // bf16 terms of dlogits in the second product
constexpr int kChunks = kDW / kDC;    // D chunks of the accumulator (one window)
constexpr int kPairs = kChunks / 2;   // the other tile is refilled two D chunks at a time
static_assert(kThreads / 32 == 8 && kBO == 32 && kBT2 == 64,
              "warp w: owner rows 16 (w % 2) .., score columns 16 (w / 2) .., D columns "
              "32 (w / 2) .. of each chunk");
static_assert(kBT2 * (2 * kDC / 8) % kThreads == 0, "whole rounds of 16-byte copies");

// Row stride (bf16) of the resident owner and other rows: D in whole chunks,
// plus 8 so that the 8 rows of an ldmatrix phase fall on distinct banks.
__host__ __device__ constexpr int res_ld(int D) { return (D + kDC - 1) / kDC * kDC + 8; }

constexpr size_t mma_smem(int D) {
  return sizeof(bf16) * ((size_t)(kBO + kBT2) * res_ld(D < kDW ? D : kDW) + kTerms * kBO * kLDL);
}
static_assert(mma_smem(kDW) <= 232448, "the tensor-core kernels fit an SM's shared memory");

// Wait until at most n (0 .. kPairs - 1) of this thread's newest groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kPairs == 4, "one case per pair");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// kOwnVocab false (K7): the block owns 32 rows of h and loops over the
// vocab tiles of split blockIdx.y.  true (K8): it owns 32 rows of w and
// loops over every 64-row tile of h.  Either way it owns the D window
// blockIdx.z of its rows' gradient.  Up to D kDW (one window) the owner rows
// and the other tile stay resident over all of D and the next tile streams
// in pair by pair behind the product.  Past it, for each other tile, every
// window of the owner rows and the other tile is loaded in turn (the
// block's own window last, so that the product finds it in place) and the
// score summed over them; no load overlaps a product there.
template <bool kOwnVocab>
__device__ __forceinline__ void grad_mma_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = res_ld(min(a.D, kDW)), dr = ld - 8;
  const int nW = (a.D + kDW - 1) / kDW, zw = blockIdx.z, z0 = zw * kDW;
  const int nCz = (min(a.D - z0, kDW) + kDC - 1) / kDC;  // D chunks of the block's window
  bf16* sOwn = reinterpret_cast<bf16*>(smem_raw);  // kBO x ld: the owner rows
  bf16* sOth = sOwn + kBO * ld;                     // kBT2 x ld: the other tile
  bf16* sDl = sOth + kBT2 * ld;                     // kTerms x kBO x kLDL: dlogits
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // the ldmatrix matrix and row this lane addresses
  const int mt = warp & 1, nq = warp >> 1;  // owner rows 16 mt ..
  const int o0 = blockIdx.x * kBO, split = blockIdx.y;
  const bf16* h = static_cast<const bf16*>(a.h);
  const bf16* w = static_cast<const bf16*>(a.w);
  const bf16* A = kOwnVocab ? w : h;
  const bf16* B = kOwnVocab ? h : w;
  const int64_t sa = kOwnVocab ? a.sw : a.sh, sb = kOwnVocab ? a.sh : a.sw;
  const int na = kOwnVocab ? a.V : a.N, nb = kOwnVocab ? a.N : a.V;
  const int n_tiles = (nb + kBT2 - 1) / kBT2;
  // K7's split counts 128-column vocab tiles (as K6 and the combine do)
  const int t_lo = kOwnVocab ? 0 : split * a.tiles_per_split * (kBT / kBT2);
  const int t_hi = kOwnVocab ? n_tiles : min(n_tiles, t_lo + a.tiles_per_split * (kBT / kBT2));
  const int nC = (a.D + kDC - 1) / kDC, nP = (nC + 1) / 2;  // one window: nW == 1

  // D chunks 2p and 2p + 1 of other tile `tile` into sOth (ragged rows and
  // columns zero-filled), as one group; past the last tile an empty group
  auto refill = [&](int tile, int p) {
    if (tile < t_hi) {
      const int b0 = tile * kBT2;
      constexpr int CH = 2 * kDC / 8;  // 16-byte pieces per row of a pair
#pragma unroll
      for (int i = 0; i < kBT2 * CH / kThreads; ++i) {
        const int e = i * kThreads + threadIdx.x, r = e / CH, row = b0 + r;
        const int col = 2 * p * kDC + (e % CH) * 8;
        const bool in = row < nb && col < a.D;
        if (col < dr) cp_async16(sOth + r * ld + col, B + (in ? row * sb + col : 0), in);
      }
    }
    cp_async_commit();
  };

  // D window w of n rows from r0 of X (row stride sx) into sm (ragged rows
  // and columns zero-filled), by cp.async; the caller commits and waits
  auto stage_window = [&](bf16* sm, const bf16* X, int64_t sx, int r0, int nr, int n, int w) {
    const int w0 = w * kDW, per_row = (min(a.D - w0, kDW) + kDC - 1) / kDC * (kDC / 8);
    for (int e = threadIdx.x; e < nr * per_row; e += kThreads) {
      const int r = e / per_row, c = (e % per_row) * 8, row = r0 + r;
      const bool in = row < n && w0 + c < a.D;
      cp_async16(sm + r * ld + c, X + (in ? row * sx + w0 + c : 0), in);
    }
  };
  if (nW == 1) {
    // the owner rows, all of D (zero-filled past D), with the first pair of
    // the first other tile; then its other pairs, a group each
    stage_window(sOwn, A, sa, o0, kBO, na, 0);
    for (int p = 0; p < nP; ++p) refill(t_lo, p);
  }

  float ol[2], og[2];  // K7: the lse, g and label of this lane's owner rows 16 mt + g + 8 hh
  int ob[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = o0 + 16 * mt + g + 8 * hh;
    const bool ok = !kOwnVocab && row < a.N;
    ol[hh] = ok ? a.lse[row] : 0.f;
    og[hh] = ok ? a.g[row] : 0.f;
    ob[hh] = ok ? a.lbl[row] : -1;
  }
  // this warp's share of the accumulator: rows 16 mt + g (+ 8), columns
  // kDC c + 32 nq + 8 j + 2 t (+ 1) of each D chunk c
  float acc[kChunks][4][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int b0 = tile * kBT2;
    float rl[4], rg[4];  // K8: lse, g, label of other rows b0 + 16 nq + 8 j + 2 t + e
    int rb[4];
    if (kOwnVocab) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = b0 + 16 * nq + 8 * (k >> 1) + 2 * t + (k & 1);
        const bool ok = n < a.N;
        rl[k] = ok ? a.lse[n] : 0.f;
        rg[k] = ok ? a.g[n] : 0.f;
        rb[k] = ok ? a.lbl[n] : -1;
      }
    }
    // s = owner rows . other rows: this warp's 16 x 16 share of the 32 x 64
    // tile, pair by pair of D chunks as they land, in two partial sums (even
    // and odd k16 steps) so that four independent mma chains interleave
    float sc[2][4], sp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sp[j][e] = 0.f;
    // chunk c of the resident window into sc and sp
    auto score_chunk = [&](int c) {
#pragma unroll
      for (int kk = 0; kk < kDC / 16; kk += 2) {
        uint32_t af[2][4], bfr[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          ldsm4(af[u], sOwn + (16 * mt + mr + 8 * (mi & 1)) * ld + kDC * c + 16 * (kk + u) +
                           8 * (mi >> 1));
          ldsm4(bfr[u], sOth + (16 * nq + mr + 8 * (mi >> 1)) * ld + kDC * c + 16 * (kk + u) +
                            8 * (mi & 1));
        }
        mma_bf16(sc[0], af[0], bfr[0][0], bfr[0][1]);
        mma_bf16(sc[1], af[0], bfr[0][2], bfr[0][3]);
        mma_bf16(sp[0], af[1], bfr[1][0], bfr[1][1]);
        mma_bf16(sp[1], af[1], bfr[1][2], bfr[1][3]);
      }
    };
    if (nW == 1) {
      for (int c = 0; c < nC; ++c) {
        if ((c & 1) == 0) {
          cp_async_wait_upto(nP - 1 - c / 2);
          __syncthreads();
        }
        score_chunk(c);
      }
    } else {
      for (int i = 1; i <= nW; ++i) {
        const int w = (zw + i) % nW;  // the block's own window last
        __syncthreads();              // every warp is done with the last window's rows
        stage_window(sOwn, A, sa, o0, kBO, na, w);
        stage_window(sOth, B, sb, b0, kBT2, nb, w);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        const int nCw = (min(a.D - w * kDW, kDW) + kDC - 1) / kDC;
        for (int c = 0; c < nCw; ++c) score_chunk(c);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += sp[j][e];
    // dlogits = (exp(s - lse) - onehot(label)) g, 0 past N or V, into sDl as
    // kTerms bf16 terms
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * mt + g + 8 * hh, c = 16 * nq + 8 * j + 2 * t;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = kOwnVocab ? b0 + c + e : o0 + r;
          const int v = kOwnVocab ? o0 + r : b0 + c + e;
          const float lse = kOwnVocab ? rl[2 * j + e] : ol[hh];
          const float gg = kOwnVocab ? rg[2 * j + e] : og[hh];
          const int lab = kOwnVocab ? rb[2 * j + e] : ob[hh];
          const bool ok = n < a.N && v < a.V;
          x[e] = ok ? (expf(sc[j][2 * hh + e] - lse) - (lab == v ? 1.f : 0.f)) * gg : 0.f;
        }
        uint32_t tt[4 * kTerms];
        split_pair<kTerms>(x[0], x[1], tt);
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          *reinterpret_cast<uint32_t*>(sDl + (i * kBO + r) * kLDL + c) = tt[4 * i];
      }
    __syncthreads();  // sDl is written
    uint32_t da[kTerms][kBT2 / 16][4];  // this warp's 16 rows of dlogits as A fragments
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int kc = 0; kc < kBT2 / 16; ++kc)
        ldsm4(da[i][kc],
              sDl + (i * kBO + 16 * mt + mr + 8 * (mi & 1)) * kLDL + 16 * kc + 8 * (mi >> 1));
    // acc += dlogits . other rows, chunk by chunk of D; once every warp is
    // done with a pair, the next tile's pair streams into its place
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= nCz) break;
      if (nW == 1 && c >= 2 && (c & 1) == 0) {
        __syncthreads();
        refill(tile + 1, c / 2 - 1);
      }
#pragma unroll
      for (int kc = 0; kc < kBT2 / 16; ++kc) {
        uint32_t ob4[2][4];  // n-tiles 0, 1 and 2, 3 of this warp's 32 columns
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ldsm4_t(ob4[u], sOth + (16 * kc + mr + 8 * (mi & 1)) * ld + kDC * c + 32 * nq +
                              16 * u + 8 * (mi >> 1));
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[c][j], da[i][kc], ob4[j >> 1][2 * (j & 1)], ob4[j >> 1][2 * (j & 1) + 1]);
      }
    }
    if (nW == 1) {
      __syncthreads();
      refill(tile + 1, nP - 1);
    }
  }
  cp_async_wait_all();  // only empty groups are left

  // the accumulator out: K8 to its dw rows in w's type, K7 to its split's partial
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = o0 + 16 * mt + g + 8 * hh, col = z0 + kDC * c + 32 * nq + 8 * j + 2 * t;
        if (row >= na || col >= a.D) continue;  // D is a multiple of 8: col + 1 < D too
        const float x0 = acc[c][j][2 * hh], x1 = acc[c][j][2 * hh + 1];
        if (kOwnVocab)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + (int64_t)row * a.D +
                                             col) = __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(a.part + ((int64_t)split * a.N + row) * a.D + col) =
              make_float2(x0, x1);
      }
}

__global__ void __launch_bounds__(kThreads, 1) fused_ce_dh_mma_kernel(Args a) {
  grad_mma_body<false>(a);
}

__global__ void __launch_bounds__(kThreads, 1) fused_ce_dw_mma_kernel(Args a) {
  grad_mma_body<true>(a);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Pass { kFwd, kDh, kDw };
enum Design { kFma, kMma };  // the caller's design codes: 0 = FMA, 1 = tensor cores

unsigned blocks_of(int64_t n, int per) { return (unsigned)((n + per - 1) / per); }

// The dynamic shared memory a kernel may take is set once per kernel and
// device (the attribute call costs host time on every launch otherwise):
// `configured` holds one bit per device for this one kernel.
cudaError_t configure(void (*kernel)(Args), size_t max_smem, uint64_t& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << dev;
  }
  return cudaSuccess;
}

// K6's tensor-core kernel, set up for its largest shared memory.
cudaError_t configure_fwd_mma() {
  static uint64_t configured = 0;
  return configure(&fused_ce_fwd_mma_kernel, fwd_mma_smem(kDW), configured);
}

// The K7 (pass kDh) or K8 kernel of a design and dtype, the shared memory it
// takes at width D and at most, and its configured bits: what launch_grad
// launches and what plan sizes K7's split count from.
struct GradKernel {
  void (*fn)(Args);
  size_t smem, max_smem;
  uint64_t* configured;
};

template <typename T>
GradKernel grad_kernel(Pass pass, Design design, int D) {
  static uint64_t configured[4] = {0, 0, 0, 0};  // (dh, dw) x (fma, mma) of this T
  uint64_t* bits = &configured[(pass == kDw ? 2 : 0) + (design == kMma ? 1 : 0)];
  if constexpr (std::is_same<T, bf16>::value) {
    if (design == kMma)
      return {pass == kDh ? &fused_ce_dh_mma_kernel : &fused_ce_dw_mma_kernel, mma_smem(D),
              mma_smem(kDW), bits};
  }
  return {pass == kDh ? &fused_ce_dh_kernel<T> : &fused_ce_dw_kernel<T>, grad_smem(D),
          grad_smem(kDW), bits};
}

// K6 (then its combine kernel) in a design.
template <typename T>
int launch_fwd(Design design, const Args& a, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if constexpr (std::is_same<T, bf16>::value) {
    if (design == kMma) {
      err = configure_fwd_mma();
      if (err != cudaSuccess) return (int)err;
      fused_ce_fwd_mma_kernel<<<dim3(blocks_of(a.N, kBO6), (unsigned)a.splits), kThreads,
                                fwd_mma_smem(a.D), s>>>(a);
    }
  }
  if (design == kFma)
    fused_ce_fwd_kernel<T><<<dim3(blocks_of(a.N, kBO), (unsigned)a.splits), kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_combine_kernel<<<blocks_of(a.N, kThreads), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// K7 (then its combine kernel) or K8 in a design.
template <typename T>
int launch_grad(Pass pass, Design design, const Args& a, cudaStream_t s) {
  const GradKernel k = grad_kernel<T>(pass, design, a.D);
  cudaError_t err = configure(k.fn, k.max_smem, *k.configured);
  if (err != cudaSuccess) return (int)err;
  const unsigned windows = blocks_of(a.D, kDW);  // grid z: the D windows
  const dim3 grid = pass == kDh ? dim3(blocks_of(a.N, kBO), (unsigned)a.splits, windows)
                                : dim3(blocks_of(a.V, kBO), 1, windows);
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(k.fn), grid, dim3(kThreads), params,
                         k.smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it here
    return (int)err;
  }
  if (pass == kDw) return (int)cudaGetLastError();
  const int64_t nd = (int64_t)a.N * a.D;
  const unsigned nb = blocks_of(nd, kThreads) < 8192 ? blocks_of(nd, kThreads) : 8192;
  fused_ce_dh_combine_kernel<T><<<nb, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Vocab splits for a (row tile, split) grid of K6 (kFwd) or K7 (kDh) in a
// design: the count that minimises waves x the longest block's time, with as
// many blocks resident per SM as the registers and shared memory of the
// kernel that will launch allow; a tie keeps fewer splits (less scratch).  A
// block's time is its vocab tiles plus, in the tensor-core design, a fixed
// cost worth kMmaBlockTiles tiles (the owner rows' load and the partial's
// write and combine): without it the plan took 239 splits of one tile at the
// main path's shape, and K7 ran 1.6 times slower than at 13 (PERF.md).
constexpr int kMmaBlockTiles = 2;

template <typename T>
int plan(Pass pass, Design design, int N, int V, int D) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  int rows = kBO;  // owner rows of a block
  if (pass == kFwd && design == kMma) {
    err = configure_fwd_mma();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, &fused_ce_fwd_mma_kernel,
                                                          kThreads, fwd_mma_smem(D));
    rows = kBO6;
  } else if (pass == kFwd) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_ce_fwd_kernel<T>,
                                                        kThreads, 0);
  } else {
    const GradKernel k = grad_kernel<T>(kDh, design, D);
    err = configure(k.fn, k.max_smem, *k.configured);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, kThreads, k.smem);
  }
  if (err != cudaSuccess) return -(int)err;
  const int64_t slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  // K7's blocks: (row tile, D window) pairs of each split
  const int64_t row_tiles = (N + rows - 1) / rows * (pass == kDh ? (D + kDW - 1) / kDW : 1);
  const int n_tiles = (V + kBT - 1) / kBT;
  int best = 1;
  int64_t best_cost = INT64_MAX;
  for (int want = 1; want <= n_tiles && want <= 65535; ++want) {
    const int per = (n_tiles + want - 1) / want;
    if ((n_tiles + per - 1) / per != want) continue;   // each split non-empty
    const int64_t cost =
        (row_tiles * want + slots - 1) / slots * (per + (design == kMma ? kMmaBlockTiles : 0));
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the tensor-core kernels copy in 16-byte pieces: every bf16 row of h
// and w, whole.
bool mma_stageable(const Args& a) {
  return aligned16(a.h) && aligned16(a.w) && a.sh % 8 == 0 && a.sw % 8 == 0 && a.D % 8 == 0;
}

bool design_ok(int design, int dtype) { return design == kFma || (design == kMma && dtype == 1); }

int run(Pass pass, int design, const Args& a, int dtype, void* stream) {
  const int n_tiles = (a.V + kBT - 1) / kBT;
  // every split holds at least one vocab tile, so each partial max is finite
  if (a.N < 1 || a.V < 1 || a.D < 1 || a.splits > n_tiles ||
      (int64_t)(a.splits - 1) * a.tiles_per_split >= n_tiles || a.splits > 65535 ||
      a.sh < a.D || a.sw < a.D || (dtype != 0 && dtype != 1) || !design_ok(design, dtype))
    return (int)cudaErrorInvalidValue;
  if (design == kMma && !mma_stageable(a)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Design d = static_cast<Design>(design);
  if (pass == kFwd) return dtype == 0 ? launch_fwd<float>(d, a, s) : launch_fwd<bf16>(d, a, s);
  return dtype == 0 ? launch_grad<float>(pass, d, a, s) : launch_grad<bf16>(pass, d, a, s);
}

}  // namespace

extern "C" {

// The vocab splits K6 (pass 0) or K7 (pass 1) takes for these sizes on the
// current device in a design (see plan); a negative CUDA error on failure.
int fused_ce_plan(int pass, int design, int dtype, int N, int V, int D) {
  if (N < 1 || V < 1 || D < 1 || (pass != 0 && pass != 1) ||
      (dtype != 0 && dtype != 1) || !design_ok(design, dtype))
    return -(int)cudaErrorInvalidValue;
  const Pass p = pass == 0 ? kFwd : kDh;
  const Design d = static_cast<Design>(design);
  return dtype == 0 ? plan<float>(p, d, N, V, D) : plan<bf16>(p, d, N, V, D);
}

// dtype codes: 0 = float32, 1 = bfloat16 (h, w, dh and dw share it); design
// codes: 0 = FMA, 1 = tensor cores (bf16 only).  h and w have
// contiguous rows of D elements, sh and sw apart; labels are int32 (K6:
// global, against w's rows from v0; K7, K8: local, a label outside [0, V)
// no hit); lse, g and every other float tensor are contiguous fp32.  part
// and part_idx are scratch of (3, splits, N) floats and (splits, N) ints
// (K6) or (splits, N, D) floats (K7).  K6's ll, row_max and row_idx are
// optional (N,) outputs (null: not written).  Each returns
// cudaGetLastError() after its launches (0 = launched), or
// cudaErrorMisalignedAddress (nothing launched) for the tensor-core design
// on rows it cannot copy in 16-byte pieces.

int fused_ce_fwd(const void* h, const void* w, const int* lbl, float* nll, float* correct,
                 float* lse, float* part, int* part_idx, float* ll, float* row_max,
                 int* row_idx, int64_t sh, int64_t sw, int dtype, int design, int N, int V,
                 int D, int splits, int v0, void* stream) {
  Args a = make_args(h, w, lbl, sh, sw, N, V, D, splits);
  a.nll = nll;
  a.correct = correct;
  a.lse_out = lse;
  a.part = part;
  a.part_idx = part_idx;
  a.ll_out = ll;
  a.max_out = row_max;
  a.idx_out = row_idx;
  a.v0 = v0;
  return run(kFwd, design, a, dtype, stream);
}

int fused_ce_dh(const void* h, const void* w, const int* lbl, const float* lse, const float* g,
                void* dh, float* part, int64_t sh, int64_t sw, int dtype, int design, int N,
                int V, int D, int splits, void* stream) {
  Args a = make_args(h, w, lbl, sh, sw, N, V, D, splits);
  a.lse = lse;
  a.g = g;
  a.out = dh;
  a.part = part;
  return run(kDh, design, a, dtype, stream);
}

int fused_ce_dw(const void* h, const void* w, const int* lbl, const float* lse, const float* g,
                void* dw, int64_t sh, int64_t sw, int dtype, int design, int N, int V, int D,
                void* stream) {
  Args a = make_args(h, w, lbl, sh, sw, N, V, D, 1);
  a.lse = lse;
  a.g = g;
  a.out = dw;
  return run(kDw, design, a, dtype, stream);
}

}  // extern "C"
