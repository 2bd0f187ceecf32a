// Fused LM head + softmax cross-entropy for NVIDIA Hopper (sm_90a): a
// forward kernel, a dh kernel and a dW kernel.  Neither the [N, V] logits
// nor the [N, V] dlogits ever reach device memory.
//
// Replaces the TPU kernels kungfu_tpu/ops/pallas/lm_head.py::_fwd_kernel
// (launched by _fwd_call), ::_bwd_dh_kernel and ::_bwd_dw_kernel (both
// launched by _bwd_call).  They compute the same functions:
//
//     x  = h W                       logits tile, f32, on chip only
//     lse = logsumexp_v x,  loss = lse - x[target]
//     dl = (exp(x - lse) - onehot(target)) * g
//     dh = dl W^T,   dW = h^T dl
//
// A target outside [0, V) matches no column: its loss is lse and it adds
// no onehot term, as in the reference kernels.  lse is a residual of the
// forward, not differentiated (the reference's VJP takes g only).
//
// Design for the card, not the TPU's block by block.  bf16 h (every
// main path) takes three wgmma/TMA kernels on W split into two bf16
// terms; f32 h (an edge case no main path has) keeps f32 SIMT kernels.
//
// The split (lm_head_split_w_kernel) writes W^T as hi = bf16(W) and lo =
// bf16(W - hi) (exact in f32, so hi + lo keeps about 17 bits of W),
// transposed to [V, ld] with ld = D rounded up to 8 so each row pitch is
// a multiple of 16 bytes, as TMA needs.  W is never rounded to one bf16
// and TF32 is never used: the logits are h W_hi + h W_lo (two bf16
// products, f32 accumulate; one for a bf16 W), and dl is split the same
// way in registers (dl_hi, dl_lo).  The forward splits W once a step and
// hands the split on to dh and dW.
// * forward (lm_head_fwd_wgmma_kernel): a GEMM with a softmax epilogue.
//   One CTA per (128-row block, vocab split), two consumer warpgroups of
//   64 rows and a producer warp streaming h, W_hi and W_lo chunks through
//   a TMA ring; per 128-column vocab tile the logits stay in registers
//   and update each row's running max, sum of exponentials and target
//   logit in the accumulator layout.  lm_head_fwd_combine_kernel merges
//   the splits.  No cluster: the logits only feed per-row reductions.
// * dh (lm_head_bwd_dh_wgmma_kernel) and dW (lm_head_bwd_dw_wgmma_kernel)
//   recompute the logits tile by tile.  Their f32 accumulators, [64, D]
//   for a block of rows or of vocab columns, do not fit one warpgroup's
//   registers at D = 768 (384 a thread), so D is split over a thread
//   block cluster of ceil(D / 256) CTAs (at most 8): each CTA computes
//   partial logits over its 256 columns, the partials are exchanged
//   through L2 and added in rank order (exchange_partials: every CTA
//   holds the same bits), and each CTA accumulates its own [64, 256]
//   slice (128 registers a thread).  dW keeps its W^T slice resident and
//   streams h; dh keeps its h slice resident and streams W^T.  Two
//   consumer warpgroups take the tiles in turn, so that one's products
//   run while the other waits for its exchange, which is what both still
//   wait on (the notes before each kernel, and "dW on the tensor cores"
//   below).
// * f32 h: the SIMT kernels below.  The TPU carried its accumulators in
//   VMEM across a sequential grid axis; here that axis is a loop inside
//   one CTA, and CTAs run in any order.  forward: one CTA per (128-row
//   block, vocab split) over 128-column vocab tiles, the 16 threads of a
//   row merging their (max, sum, target) in shared memory; dh: one CTA
//   per 32-row block over 256-column vocab tiles, dl W^T into a [32, 768]
//   f32 register accumulator; dW: one CTA per 32-column vocab block over
//   128-row tiles, h^T dl into [768, 32].  A model dimension above 768 is
//   handled in 768-wide chunks, each sweeping (and recomputing) the
//   logits again.  The accumulators live in registers, so one CTA runs
//   per SM; each product walks its K dimension in chunks staged through
//   shared memory, the next chunk's global loads issued into registers
//   before the current chunk's products (Chunk::fetch / store).  Every
//   SIMT product is an f32 fmaf product on the CUDA cores (each operand
//   converted to f32 as it is staged, exact for bf16).
// * No atomics: every result is deterministic.  Rounding points: the
//   logits, the probabilities and dl stay f32 (never stored) apart from
//   dl's two bf16 terms; loss and lse are written in f32; dh is rounded
//   once to h's dtype and dW once to W's dtype, from their f32
//   accumulators, as the reference casts its f32 scratch at the end of
//   each sweep.
// * Ragged N, D and V are masked inside the kernels (no padding copies):
//   rows and columns past the end load as zeros (TMA zero-fills them),
//   masked vocab columns take no part in the max or the sum and get
//   dl = 0 (a template argument, one branch per tile); rows past N have
//   g = 0 and are never written.
//
// What bounds it: at the flagship shape (N 8192, D 768, V 32128) the
// forward needs one 2*N*D*V = 404 GFLOP product and each backward kernel
// two (the recomputed logits and its own product), against ~111 MB of
// operand traffic, so every kernel is bound by operations: 0.41 / 0.82 /
// 0.82 ms at the bf16 tensor-core peak.  The split doubles the logits
// products, so the wgmma kernels execute two (forward), five (dh: the
// logits from W's two terms, then dl_hi W_hi, dl_hi W_lo and dl_lo W_hi;
// dl_lo W_lo, about 2^-18 of a term, is left out) and four (dW) bf16
// products: 0.82 / 2.04 / 1.64 ms.  PERF.md holds the times.
//
// dW on the tensor cores (bf16 h, the flagship's case).  The kernel has
// the shape of the flash dK/dV kernel: a block of 64 vocab columns plays
// the kv block, h's rows play the q rows.  Each CTA computes partial
// logits^T over its own 256 columns of D, and accumulates its own
// [64, 256] slice of dW^T.  Its W^T slice (hi and lo, 64 KB) stays in
// shared memory for the whole row sweep; only h streams, by TMA.  At the
// flagship shape it executes 4 x 2 N D V = 1.6 TFLOP of bf16 work (1.64
// ms at the dense peak) where the function needs 0.82 ms.
//
// Interface: plain C launchers taking device pointers and the caller's
// stream, loaded with ctypes (kungfu_tpu_torch/ops/cuda/lm_head.py).  h is
// a contiguous [N, D] matrix (for the wgmma kernels: any row pitch that
// is a multiple of 8 elements, 16-byte aligned), w a contiguous [D, V]
// matrix (the JAX layout), targets int32 [N]; lse and g are f32 [N];
// each element type is float or bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int BK = 16;     // depth of a chunk along D in the logits products
constexpr int DC = 768;    // model-dim columns one accumulator holds
constexpr float NEG_INF = -1e30f;
constexpr int KF_BAD_ARGS = -1;
constexpr int KF_BAD_REGS = -3;
constexpr float LOG2E = 1.4426950408889634f;

// forward: 128 rows x 128 vocab columns, 8x8 outputs a thread; vocab
// splits until about 512 CTAs, four waves of one CTA per SM on 132 SMs
constexpr int F_BM = 128, F_BN = 128, F_RM = 2, F_RN = 2;
constexpr int F_TX = F_BN / (4 * F_RN);  // 16 threads along the vocab
constexpr int F_TARGET_CTAS = 512;
// dh: 32 rows, 256-column vocab tiles, depth-8 chunks of W^T
constexpr int H_BM = 32, H_BV = 256, H_BK2 = 8;
constexpr int H_TX = H_BV / 8;           // 32 threads along the vocab / D
// dW: 32 vocab columns, 128-row tiles, depth-8 chunks of h
constexpr int W_BM = 128, W_BV = 32, W_BK2 = 8;
constexpr int W_TX = W_BV / 4;           // 8 threads along the vocab

static_assert((F_BM / (4 * F_RM)) * F_TX == NTHREADS, "forward thread grid");
static_assert((H_BM / 4) * H_TX == NTHREADS && DC / 24 == H_TX, "dh thread grid");
static_assert((W_BM / 4) * W_TX == NTHREADS && DC / 24 == W_BM / 4, "dW thread grid");

// Shared memory, byte offsets.  k-major operand tiles are padded by four
// floats a row (stores of a transposed tile spread over the banks; rows
// stay 16-byte aligned for the vector loads).
struct FwdLayout {
  static constexpr int LDA = F_BM + 4;
  static constexpr size_t A = 0;                                  // [BK][LDA]
  static constexpr size_t B = A + sizeof(float) * BK * LDA;       // [BK][F_BN]
  static constexpr size_t RED = B + sizeof(float) * BK * F_BN;    // [3][F_TX][F_BM]
  static constexpr size_t BYTES = RED + sizeof(float) * 3 * F_TX * F_BM;
};

struct DhLayout {
  static constexpr int LDA = H_BM + 4;
  static constexpr int LDD = H_BM + 4;
  static constexpr int LDB2 = DC + 4;
  static constexpr size_t A = 0;                                  // [BK][LDA]
  static constexpr size_t B = A + sizeof(float) * BK * LDA;       // [BK][H_BV]
  static constexpr size_t DL = B + sizeof(float) * BK * H_BV;     // dl^T [H_BV][LDD]
  static constexpr size_t B2 = DL + sizeof(float) * H_BV * LDD;   // W^T [H_BK2][LDB2]
  static constexpr size_t BYTES = B2 + sizeof(float) * H_BK2 * LDB2;
};

struct DwLayout {
  static constexpr int LDA = W_BM + 4;
  static constexpr int LDD = W_BV + 4;
  static constexpr int LDA2 = DC + 4;
  static constexpr size_t A = 0;                                  // [BK][LDA]
  static constexpr size_t B = A + sizeof(float) * BK * LDA;       // [BK][W_BV]
  static constexpr size_t DL = B + sizeof(float) * BK * W_BV;     // dl [W_BM][LDD]
  static constexpr size_t A2 = DL + sizeof(float) * W_BM * LDD;   // h [W_BK2][LDA2]
  static constexpr size_t BYTES = A2 + sizeof(float) * W_BK2 * LDA2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The i-th row (or column) of a thread's output grid in a tile B wide
// split into R groups: four consecutive entries at t*4 in each group.
template <int B, int R>
__device__ __forceinline__ int frag_idx(int i, int t) {
  return (i / 4) * (B / R) + t * 4 + (i % 4);
}

// One chunk of an operand on its way from device memory to shared memory.
// Element (k, m), k < KC, m < M, is src[(r0 + m) * stride + c0 + k] when
// TRANSPOSE (a chunk of KC columns of M rows, stored k-major) and
// src[(r0 + k) * stride + c0 + m] otherwise (KC rows of M columns, stored
// as they are); it is zero outside nrows x ncols, and lands at
// dst[k * ld + m] as f32.  Neighbouring threads read neighbouring columns
// of one row either way.  fetch() issues the loads into registers in the
// source type; store() converts and writes them.  Between the two the
// CTA multiplies the previous chunk, so the loads' latency hides behind
// those products.
template <int KC, int M, typename T, bool TRANSPOSE>
struct Chunk {
  static_assert((KC * M) % NTHREADS == 0, "tile does not split evenly");
  static constexpr int PER = KC * M / NTHREADS;
  T v[PER];

  __device__ __forceinline__ static void coords(int e, int& k, int& m) {
    if (TRANSPOSE) {
      k = e % KC;
      m = e / KC;
    } else {
      m = e % M;
      k = e / M;
    }
  }

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int r0,
                                        int nrows, int c0, int ncols,
                                        int stride, int tid) {
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      int k, m;
      coords(it * NTHREADS + tid, k, m);
      const int r = TRANSPOSE ? r0 + m : r0 + k;
      const int c = TRANSPOSE ? c0 + k : c0 + m;
      v[it] = (r < nrows && c < ncols) ? src[(size_t)r * stride + c]
                                       : from_f32<T>(0.f);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int tid) const {
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      int k, m;
      coords(it * NTHREADS + tid, k, m);
      dst[k * ld + m] = to_f32(v[it]);
    }
  }
};

// acc += A B over KC steps of k, for the thread's (4*RM) x (4*RN) grid of
// a BM x BN tile; A is k-major [KC][lda], B k-major [KC][ldb], both f32
// in shared memory.  Sequential fmaf in k order: f32, never TF32.
template <int BM, int BN, int RM, int RN, int KC>
__device__ __forceinline__ void fma_chunk(float (&acc)[4 * RM][4 * RN],
                                          const float* As, int lda,
                                          const float* Bs, int ldb, int ty,
                                          int tx) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float a[4 * RM], b[4 * RN];
#pragma unroll
    for (int g = 0; g < RM; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + k * lda + g * (BM / RM) + ty * 4);
      a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < RN; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          Bs + k * ldb + g * (BN / RN) + tx * 4);
      b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * RM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

// ------------------------------------------------------------- forward --

// Partial (max, sum of exponentials, target logit) of rows
// [128*blockIdx.x, +128) over split blockIdx.y's vocab tiles, into
// part[(split * N + row) * 3 + {0, 1, 2}].
template <typename TH, typename TW>
__global__ void __launch_bounds__(NTHREADS)
lm_head_fwd_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                   const int* __restrict__ targets, float* __restrict__ part,
                   int N, int D, int V) {
  using L = FwdLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem + L::A);
  float* Bs = reinterpret_cast<float*>(smem + L::B);
  float* red = reinterpret_cast<float*>(smem + L::RED);

  const int tid = threadIdx.x, tx = tid % F_TX, ty = tid / F_TX;
  const int r0 = blockIdx.x * F_BM;
  const int n_vt = (V + F_BN - 1) / F_BN;
  const int vt_begin = (int)((long long)blockIdx.y * n_vt / gridDim.y);
  const int vt_end = (int)((long long)(blockIdx.y + 1) * n_vt / gridDim.y);

  // running max, sum of exp(x - max) and target logit of each owned row
  // over the columns this thread sees
  float m[4 * F_RM], l[4 * F_RM], t[4 * F_RM];
  int tgt[4 * F_RM];
#pragma unroll
  for (int i = 0; i < 4 * F_RM; ++i) {
    const int r = r0 + frag_idx<F_BM, F_RM>(i, ty);
    m[i] = NEG_INF;
    l[i] = 0.f;
    t[i] = 0.f;
    tgt[i] = r < N ? targets[r] : -1;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * F_BN;
    float acc[4 * F_RM][4 * F_RN];
    zero(acc);
    Chunk<BK, F_BM, TH, true> ch;   // h[r0:r0+128, d0:d0+BK]
    Chunk<BK, F_BN, TW, false> cw;  // W[d0:d0+BK, v0:v0+128]
    ch.fetch(h, r0, N, 0, D, D, tid);
    cw.fetch(w, 0, D, v0, V, V, tid);
    for (int d0 = 0; d0 < D; d0 += BK) {
      __syncthreads();  // every warp is done with the previous chunk
      ch.store(As, L::LDA, tid);
      cw.store(Bs, F_BN, tid);
      __syncthreads();
      if (d0 + BK < D) {
        ch.fetch(h, r0, N, d0 + BK, D, D, tid);
        cw.fetch(w, d0 + BK, D, v0, V, V, tid);
      }
      fma_chunk<F_BM, F_BN, F_RM, F_RN, BK>(acc, As, L::LDA, Bs, F_BN, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4 * F_RM; ++i) {
      float tile_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4 * F_RN; ++j)
        if (v0 + frag_idx<F_BN, F_RN>(j, tx) < V)
          tile_max = fmaxf(tile_max, acc[i][j]);
      const float m_new = fmaxf(m[i], tile_max);
      float s = l[i] * expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < 4 * F_RN; ++j) {
        const int col = v0 + frag_idx<F_BN, F_RN>(j, tx);
        if (col < V) {
          s += expf(acc[i][j] - m_new);
          if (col == tgt[i]) t[i] += acc[i][j];
        }
      }
      l[i] = s;
      m[i] = m_new;
    }
  }

  // merge the F_TX column subsets of each row (red is not aliased)
#pragma unroll
  for (int i = 0; i < 4 * F_RM; ++i) {
    const int row = frag_idx<F_BM, F_RM>(i, ty);
    red[(0 * F_TX + tx) * F_BM + row] = m[i];
    red[(1 * F_TX + tx) * F_BM + row] = l[i];
    red[(2 * F_TX + tx) * F_BM + row] = t[i];
  }
  __syncthreads();
  if (tid < F_BM && r0 + tid < N) {
    float mx = NEG_INF;
    for (int x = 0; x < F_TX; ++x) mx = fmaxf(mx, red[x * F_BM + tid]);
    float sum = 0.f, tl = 0.f;
    for (int x = 0; x < F_TX; ++x) {
      sum += red[(F_TX + x) * F_BM + tid] * expf(red[x * F_BM + tid] - mx);
      tl += red[(2 * F_TX + x) * F_BM + tid];
    }
    float* p = part + ((size_t)blockIdx.y * N + r0 + tid) * 3;
    p[0] = mx;
    p[1] = sum;
    p[2] = tl;
  }
}

// loss and lse of each row from the splits' partials; lse clamps the sum
// at 1e-30 as the reference does.
__global__ void lm_head_fwd_combine_kernel(const float* __restrict__ part,
                                           float* __restrict__ loss,
                                           float* __restrict__ lse, int N,
                                           int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[((size_t)s * N + n) * 3]);
  float sum = 0.f, tl = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)s * N + n) * 3;
    sum += p[1] * expf(p[0] - mx);
    tl += p[2];
  }
  const float z = mx + logf(fmaxf(sum, 1e-30f));
  loss[n] = z - tl;
  lse[n] = z;
}

// ------------------------------------------------------------------ dh --

template <typename TH, typename TW>
__global__ void __launch_bounds__(NTHREADS, 1)
lm_head_bwd_dh_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                      const int* __restrict__ targets,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, TH* __restrict__ dh, int N,
                      int D, int V) {
  using L = DhLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem + L::A);
  float* Bs = reinterpret_cast<float*>(smem + L::B);
  float* dlT = reinterpret_cast<float*>(smem + L::DL);
  float* Bs2 = reinterpret_cast<float*>(smem + L::B2);

  const int tid = threadIdx.x, tx = tid % H_TX, ty = tid / H_TX;
  const int r0 = blockIdx.x * H_BM;
  // the thread owns rows ty*4 + i of the block in both products; a row
  // past N gets g = 0, so its dl is 0
  float row_lse[4], row_g[4];
  int tgt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_lse[i] = r < N ? lse[r] : 0.f;
    row_g[i] = r < N ? g[r] : 0.f;
    tgt[i] = r < N ? targets[r] : -1;
  }

  for (int dc0 = 0; dc0 < D; dc0 += DC) {
    float acc[4][24];
    zero(acc);
    for (int v0 = 0; v0 < V; v0 += H_BV) {
      // the logits tile [32, 256] = h_blk W[:, v0:v0+256]
      float s[4][8];
      zero(s);
      Chunk<BK, H_BM, TH, true> ch;   // h[r0:r0+32, d0:d0+BK]
      Chunk<BK, H_BV, TW, false> cw;  // W[d0:d0+BK, v0:v0+256]
      ch.fetch(h, r0, N, 0, D, D, tid);
      cw.fetch(w, 0, D, v0, V, V, tid);
      for (int d0 = 0; d0 < D; d0 += BK) {
        __syncthreads();
        ch.store(As, L::LDA, tid);
        cw.store(Bs, H_BV, tid);
        __syncthreads();
        if (d0 + BK < D) {
          ch.fetch(h, r0, N, d0 + BK, D, D, tid);
          cw.fetch(w, d0 + BK, D, v0, V, V, tid);
        }
        fma_chunk<H_BM, H_BV, 1, 2, BK>(s, As, L::LDA, Bs, H_BV, ty, tx);
      }
      Chunk<H_BK2, DC, TW, true> cwt;  // W[dc0:dc0+768, v0+k0:v0+k0+8]
      // dl, stored transposed (vocab-major) as the A operand of dl W^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = frag_idx<H_BV, 2>(j, tx);
          float d = 0.f;
          if (v0 + col < V) {
            const float p = expf(s[i][j] - row_lse[i]);
            d = (p - (v0 + col == tgt[i] ? 1.f : 0.f)) * row_g[i];
          }
          dlT[col * L::LDD + ty * 4 + i] = d;
        }
      // acc += dl W[dc0:dc0+768, v0:v0+256]^T, eight vocab entries a step
      for (int k0 = 0; k0 < H_BV && v0 + k0 < V; k0 += H_BK2) {
        // not fetched a chunk ahead: the 24 registers that would take
        // spill, and on an H100 the spills cost more than the overlap
        cwt.fetch(w, dc0, D, v0 + k0, V, V, tid);
        __syncthreads();  // dl is complete; the previous W^T chunk is used
        cwt.store(Bs2, L::LDB2, tid);
        __syncthreads();
        fma_chunk<H_BM, DC, 1, 6, H_BK2>(acc, dlT + k0 * L::LDD, L::LDD, Bs2,
                                         L::LDB2, ty, tx);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r >= N) continue;
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int d = dc0 + frag_idx<DC, 6>(j, tx);
        if (d < D) dh[(size_t)r * D + d] = from_f32<TH>(acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------ dW --

template <typename TH, typename TW>
__global__ void __launch_bounds__(NTHREADS, 1)
lm_head_bwd_dw_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                      const int* __restrict__ targets,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, TW* __restrict__ dw, int N,
                      int D, int V) {
  using L = DwLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem + L::A);
  float* Bs = reinterpret_cast<float*>(smem + L::B);
  float* dl = reinterpret_cast<float*>(smem + L::DL);
  float* As2 = reinterpret_cast<float*>(smem + L::A2);

  const int tid = threadIdx.x, tx = tid % W_TX, ty = tid / W_TX;
  const int v0 = blockIdx.x * W_BV;

  for (int dc0 = 0; dc0 < D; dc0 += DC) {
    float acc[24][4];
    zero(acc);
    for (int r0 = 0; r0 < N; r0 += W_BM) {
      // the logits tile [128, 32] = h[r0:r0+128] W[:, v0:v0+32]
      float s[4][4];
      zero(s);
      Chunk<BK, W_BM, TH, true> ch;   // h[r0:r0+128, d0:d0+BK]
      Chunk<BK, W_BV, TW, false> cw;  // W[d0:d0+BK, v0:v0+32]
      ch.fetch(h, r0, N, 0, D, D, tid);
      cw.fetch(w, 0, D, v0, V, V, tid);
      for (int d0 = 0; d0 < D; d0 += BK) {
        __syncthreads();
        ch.store(As, L::LDA, tid);
        cw.store(Bs, W_BV, tid);
        __syncthreads();
        if (d0 + BK < D) {
          ch.fetch(h, r0, N, d0 + BK, D, D, tid);
          cw.fetch(w, d0 + BK, D, v0, V, V, tid);
        }
        fma_chunk<W_BM, W_BV, 1, 1, BK>(s, As, L::LDA, Bs, W_BV, ty, tx);
      }
      // the first h chunk of the product below flies while dl is formed
      Chunk<W_BK2, DC, TH, false> chr;  // h[r0+k0:r0+k0+8, dc0:dc0+768]
      chr.fetch(h, r0, N, dc0, D, D, tid);
      // dl, row-major, as the B operand of h^T dl
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i, r = r0 + row;
        const float rl = r < N ? lse[r] : 0.f;
        const float rg = r < N ? g[r] : 0.f;
        const int tg = r < N ? targets[r] : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx * 4 + j;
          float d = 0.f;
          if (r < N && v0 + col < V) {
            const float p = expf(s[i][j] - rl);
            d = (p - (v0 + col == tg ? 1.f : 0.f)) * rg;
          }
          dl[row * L::LDD + col] = d;
        }
      }
      // acc += h[r0:r0+128, dc0:dc0+768]^T dl, eight rows a step
      for (int k0 = 0; k0 < W_BM && r0 + k0 < N; k0 += W_BK2) {
        __syncthreads();  // dl is complete; the previous h chunk is used
        chr.store(As2, L::LDA2, tid);
        __syncthreads();
        if (k0 + W_BK2 < W_BM && r0 + k0 + W_BK2 < N)
          chr.fetch(h, r0 + k0 + W_BK2, N, dc0, D, D, tid);
        fma_chunk<DC, W_BV, 6, 1, W_BK2>(acc, As2, L::LDA2, dl + k0 * L::LDD,
                                         L::LDD, ty, tx);
      }
    }
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int d = dc0 + frag_idx<DC, 6>(i, ty);
      if (d >= D) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx * 4 + j;
        if (col < V) dw[(size_t)d * V + col] = from_f32<TW>(acc[i][j]);
      }
    }
  }
}

// ----------------------------------------------------- dW on wgmma --

// W split into two bf16 terms, transposed to [V, ld] (ld = D rounded up
// to 8, so a row pitch is a multiple of 16 bytes, as TMA needs; columns
// [D, ld) are zero): hi = bf16(W), lo = bf16(W - hi).  W - hi is exact
// in f32, so hi + lo holds W to about 2^-17 of its value.  A bf16 W
// gives hi = W and no lo (SPLIT false).  32 x 32 tiles through shared
// memory, so the reads of W's rows and the writes of the transposed
// rows are both coalesced.
template <typename TW, bool SPLIT>
__global__ void __launch_bounds__(256)
lm_head_split_w_kernel(const TW* __restrict__ w, __nv_bfloat16* __restrict__ hi,
                       __nv_bfloat16* __restrict__ lo, int D, int V, int ld) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int v0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = d0 + ty + 8 * k, v = v0 + tx;
    tile[ty + 8 * k][tx] = d < D && v < V ? to_f32(w[(size_t)d * V + v]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = v0 + ty + 8 * k, d = d0 + tx;
    if (v < V && d < ld) {
      const float x = tile[tx][ty + 8 * k];
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      hi[(size_t)v * ld + d] = h;
      if (SPLIT) lo[(size_t)v * ld + d] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
  }
}

// The dW kernel for bf16 h, a thread block cluster of CS = ceil(D / 256)
// CTAs per 64-column vocab block (blockIdx.y); CTA `rank` of the cluster
// owns columns [256 rank, 256 rank + 256) of D.  Per 64-row tile of h
// (all N rows, in order):
//   1. partial logits^T [64 v, 64 n] = W^T[v, slice] h[n, slice]^T by
//      wgmma from shared memory, W^T (hi, then lo) K-major as the split
//      kernel stored it, resident for the whole sweep; h's tile, K-major,
//      streams through a TMA ring;
//   2. the CS partials are exchanged and added in rank order, so every
//      CTA of the cluster holds the same logits, bit for bit;
//   3. dl^T = (exp(logits^T - lse) - onehot) g in the accumulator layout,
//      split into bf16 hi and lo register A fragments;
//   4. dW^T[64 v, slice] += dl_hi^T h + dl_lo^T h, h's tile read MN-major
//      through the transpose bit.
// Two consumer warpgroups take the tiles in turn, each with its own dW^T
// accumulator (added in a fixed order at the end), so that one's tensor
// work runs while the other waits for its exchange; there is no producer
// warp (a third warpgroup would cap every thread at 168 registers), so
// each warpgroup refills the two ring stages it owns as it frees them,
// and reads its tiles' lse, g and targets itself.  The exchange goes
// through L2: each warpgroup stores its partial into a slot of a global
// scratch indexed by the SM it runs on (so the slots stay in L2), arrives
// on its peers' mbarriers (release at cluster scope), waits for theirs,
// and loads the CS partials from L2.  Through distributed shared memory
// the same exchange was slower (it moves far fewer bytes per clock than
// L2 here), and its slots do not fit beside two warpgroups' ring stages.
struct DwCfg {
  static constexpr int BV = 64;          // vocab columns per cluster
  static constexpr int BN = 64;          // rows of h per tile
  static constexpr int SLICE = 256;      // model-dim columns per CTA
  static constexpr int MAX_CS = 8;       // the portable cluster size
  static constexpr int STAGES = 4;       // two h tiles per warpgroup
  static constexpr int THREADS = 256;    // two consumer warpgroups
  // the scratch slots: (SM, warpgroup, parity), a partial's f32 each
  static constexpr int MAX_SM = 256;
  static constexpr int PART_FLOATS = 128 * 32;
  static constexpr int W_BYTES = BV * SLICE * 2;      // one term's tile
  static constexpr int H_BYTES = BN * SLICE * 2;      // one h tile
  static constexpr int WLO_OFF = W_BYTES;             // W hi at 0
  static constexpr int H_OFF = 2 * W_BYTES;           // STAGES tiles
  // lse * log2 e, g, target: [warpgroup][parity][3][BN]
  static constexpr int ROW_OFF = H_OFF + STAGES * H_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + 2 * 2 * 3 * BN * 4;
  // w_full, full[STAGES], ready[2 warpgroups][2]
  static constexpr int BYTES = BAR_OFF + (1 + STAGES + 4) * 8 + 1024;
  static_assert(W_BYTES % 1024 == 0 && H_BYTES % 1024 == 0, "alignment");
  static_assert(2 * H_BYTES >= 128 * 128 * 4, "the final sum's buffer");

  static __device__ uint32_t w_tile(uint32_t b, int term) {
    return b + term * WLO_OFF;
  }
  static __device__ uint32_t h_tile(uint32_t b, int s) {
    return b + H_OFF + s * H_BYTES;
  }
  static __device__ uint32_t w_full(uint32_t b) { return b + BAR_OFF; }
  static __device__ uint32_t full(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + s);
  }
  static __device__ uint32_t ready(uint32_t b, int w, int p) {
    return b + BAR_OFF + 8u * (1 + STAGES + 2 * w + p);
  }
};

// One h tile into stage s by TMA (one thread).
__device__ __forceinline__ void dw_load_h(uint32_t base, const CUtensorMap* map,
                                          int s, int d0, int r0) {
  using C = DwCfg;
  hopper::mbar_arrive_expect_tx(C::full(base, s), C::H_BYTES);
  for (int b = 0; b < C::SLICE / 64; ++b) {
    hopper::tma_load_2d(C::h_tile(base, s) + b * C::BN * 128, map,
                        C::full(base, s), d0 + 64 * b, r0);
  }
}

// dl^T in place of the logits^T fragment x (rows v0 + vrow + 8 i, columns
// 8 j + cn + c of the tile), from the tile's lse * log2 e, g and
// targets.  MASK (the cluster's vocab block runs past V) zeroes columns
// v >= V, whose W rows arrived zero-filled; rows of h past N carry g = 0.
template <bool MASK>
__device__ __forceinline__ void dw_dl(float (&x)[32], const float* lse2,
                                      const float* gs, const int* tg, int v,
                                      int V, int cn) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + cn + c;
      const float l2 = lse2[col], gg = gs[col];
      const int t = tg[col];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * j + 2 * i + c;
        const float p = exp2f(fmaf(x[idx], LOG2E, -l2));
        float d = (p - (t == v + 8 * i ? 1.f : 0.f)) * gg;
        if (MASK && v + 8 * i >= V) d = 0.f;
        x[idx] = d;
      }
    }
  }
}

// What a consumer warpgroup needs besides its registers.
struct DwArgs {
  uint32_t base;       // the 1024-aligned shared-memory base
  uint8_t* gbase;      // the same, generic
  const CUtensorMap* h_map;
  const int* targets;
  const float* lse;
  const float* g;
  float* xs;           // the exchange scratch
  const int* sm_of;    // the SM of each CTA of the cluster
  int N, D, V, v0, d0, cs, me, wg;
};

// The cluster's partial logits of one [64, 64] tile, exchanged through
// L2 and added in rank order, so that every CTA holds the same bits (the
// wgmma dW and dh kernels).  x is this warpgroup's partial in the
// accumulator layout on entry and the cluster's sum on return.  The
// partial goes to slot (SM, warpgroup, parity p) of the scratch xs; the
// warpgroup's stores before the call (partial and any shared memory) are
// ordered before thread r's release arrival on CTA r's `ready` barrier
// (local address; parity p, phase j / 2).  Slot p was last read by the
// peers' warpgroups at this warpgroup's tile j - 2; each has since
// arrived for tile j - 1, which it does only after that read.
//
// The loads are latency-bound (a round trip to L2 each round), and the
// registers allow 32 values in flight beside x: rank 0's partial loads
// straight into x, the others' in rounds of half the tile for two ranks,
// so a cluster of three waits two round trips.
__device__ __forceinline__ void exchange_partials(float (&x)[32], float* xs,
                                                  const int* sm_of, int cs,
                                                  int me, int wg, int p, int j,
                                                  uint32_t ready) {
  using namespace hopper;
  constexpr int PART_FLOATS = DwCfg::PART_FLOATS;
  const int t = threadIdx.x % 128;
  auto slot = [&](int r) {
    return reinterpret_cast<float4*>(
               xs + ((size_t)(sm_of[r] * 2 + wg) * 2 + p) * PART_FLOATS) + t;
  };
  float4* mine = slot(me);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    __stcg(mine + q * 128, make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                       x[4 * q + 3]));
  }
  named_sync(1 + wg, 128);
  if (t < cs && t != me) mbar_arrive_cluster(mapa(ready, t));
  mbar_wait_cluster(ready, (j / 2) & 1);
  const float4* src0 = slot(0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 u = __ldcg(src0 + q * 128);
    x[4 * q] = u.x; x[4 * q + 1] = u.y; x[4 * q + 2] = u.z; x[4 * q + 3] = u.w;
  }
  for (int r0 = 1; r0 < cs; r0 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + r < cs) {
          const float4* src = slot(r0 + r);
#pragma unroll
          for (int q = 0; q < 4; ++q) v[r][q] = __ldcg(src + (4 * h + q) * 128);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + r < cs) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float* e = x + 4 * (4 * h + q);
            e[0] += v[r][q].x; e[1] += v[r][q].y; e[2] += v[r][q].z; e[3] += v[r][q].w;
          }
        }
      }
    }
  }
}

// Warpgroup wg's share of the row sweep (tiles wg, wg + 2, ...): its
// dW^T slice in acc.
template <typename TW, bool MASK>
__device__ __forceinline__ void dw_sweep(const DwArgs& a, float (&acc)[128]) {
  using C = DwCfg;
  using namespace hopper;
  constexpr bool SPLIT = sizeof(TW) == 4;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int vrow = 16 * (t / 32) + lane / 4;  // + 8 i
  const int cn = 2 * (lane % 4);
  const int n_it = (a.N + C::BN - 1) / C::BN;
  mbar_wait(C::w_full(a.base), 0);

  for (int it = a.wg, j = 0; it < n_it; it += 2, ++j) {
    const int s = it % C::STAGES, p = j % 2;
    // lse * log2 e, g and the target of the tile's row t (t < 64), read
    // while the logits are computed; rows past N get g = 0 (so dl = 0)
    // and no target
    float* rows = reinterpret_cast<float*>(a.gbase + C::ROW_OFF) +
                  (a.wg * 2 + p) * 3 * C::BN;
    float row_l = 0.f, row_g = 0.f;
    int row_t = -1;
    if (t < C::BN && it * C::BN + t < a.N) {
      const int n = it * C::BN + t;
      row_l = a.lse[n] * LOG2E;
      row_g = a.g[n];
      row_t = a.targets[n];
    }
    mbar_wait(C::full(a.base, s), (it / C::STAGES) & 1);
    // 1. partial logits^T over this CTA's slice of D
    float x[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::SLICE / 16; ++ks) {
      Wgmma<64>::template ss<0>(
          x, desc_kmajor<C::SLICE>(C::w_tile(a.base, 0), C::BV, 0, ks),
          desc_kmajor<C::SLICE>(C::h_tile(a.base, s), C::BN, 0, ks), ks > 0);
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int ks = 0; ks < C::SLICE / 16; ++ks) {
        Wgmma<64>::template ss<0>(
            x, desc_kmajor<C::SLICE>(C::w_tile(a.base, 1), C::BV, 0, ks),
            desc_kmajor<C::SLICE>(C::h_tile(a.base, s), C::BN, 0, ks), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if (t < C::BN) {
      rows[t] = row_l;
      rows[C::BN + t] = row_g;
      reinterpret_cast<int*>(rows + 2 * C::BN)[t] = row_t;
    }

    // 2. the cluster's partials through L2, added in rank order
    if (a.cs > 1) {
      exchange_partials(x, a.xs, a.sm_of, a.cs, a.me, a.wg, p, j,
                        C::ready(a.base, a.wg, p));
    } else {
      named_sync(1 + a.wg, 128);  // the rows are in shared memory
    }

    // 3. dl^T, split into bf16 hi and lo A fragments (k-slice kt: tile
    // columns [16 kt, 16 kt + 16)).  The rows' buffer of parity p is
    // written again two tiles on, after this warpgroup's next barrier,
    // which every thread passes only when done reading it here.
    dw_dl<MASK>(x, rows, rows + C::BN,
                reinterpret_cast<const int*>(rows + 2 * C::BN), a.v0 + vrow,
                a.V, cn);
    uint32_t fhi[C::BN / 16][4], flo[C::BN / 16][4];
#pragma unroll
    for (int kt = 0; kt < C::BN / 16; ++kt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lo = x[8 * kt + 2 * r], hi = x[8 * kt + 2 * r + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
        const float2 hf = __bfloat1622float2(h2);
        fhi[kt][r] = *reinterpret_cast<const uint32_t*>(&h2);
        flo[kt][r] = pack_bf16(lo - hf.x, hi - hf.y);
      }
    }

    // 4. dW^T += dl_hi^T h + dl_lo^T h, waited for at once: left in
    // flight over the next tile's logits, ptxas serialises every wgmma
    // (its C7515 warning)
    fence_frags(fhi);
    fence_frags(flo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::BN / 16; ++ks) {
      Wgmma<256>::template rs<1>(
          acc, fhi[ks], desc_mnmajor<C::SLICE>(C::h_tile(a.base, s), C::BN, ks), 1);
    }
#pragma unroll
    for (int ks = 0; ks < C::BN / 16; ++ks) {
      Wgmma<256>::template rs<1>(
          acc, flo[ks], desc_mnmajor<C::SLICE>(C::h_tile(a.base, s), C::BN, ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // the stage is free once all four warps' products are done (each
    // warp's wait covers its own share of the wgmma): this warpgroup's
    // tile it + STAGES goes there
    named_sync(1 + a.wg, 128);
    if (t == 0 && it + C::STAGES < n_it) {
      dw_load_h(a.base, a.h_map, s, a.d0, (it + C::STAGES) * C::BN);
    }
  }
}

template <typename TW, bool MASK>
__device__ __forceinline__ void dw_consumer(const DwArgs& a,
                                            TW* __restrict__ dw) {
  using C = DwCfg;
  const int t = threadIdx.x % 128, lane = t % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  dw_sweep<TW, MASK>(a, acc);

  // the two warpgroups' sums, added in a fixed order (warpgroup 0's
  // first) in the h stages, which every tile has left by now
  float4* sum = reinterpret_cast<float4*>(a.gbase + C::H_OFF);
  hopper::named_sync(3, 256);  // both sweeps are done with the stages
  if (a.wg == 1) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      sum[q * 128 + t] = make_float4(acc[4 * q], acc[4 * q + 1],
                                     acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  hopper::named_sync(3, 256);
  if (a.wg == 1) return;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float4 o = sum[q * 128 + t];
    acc[4 * q] += o.x; acc[4 * q + 1] += o.y; acc[4 * q + 2] += o.z;
    acc[4 * q + 3] += o.w;
  }

  // epilogue: dW[d, v], rows d0 + 8 j + cn + c, columns v0 + vrow + 8 i
  const int vrow = 16 * (t / 32) + lane / 4;
  const int cn = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = a.v0 + vrow + 8 * i;
    if (v >= a.V) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = a.d0 + 8 * j + cn + c;
        if (d < a.D) dw[(size_t)d * a.V + v] = from_f32<TW>(acc[4 * j + 2 * i + c]);
      }
    }
  }
}

template <typename TW>
__global__ void __launch_bounds__(DwCfg::THREADS, 1)
lm_head_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                            const __grid_constant__ CUtensorMap whi_map,
                            const __grid_constant__ CUtensorMap wlo_map,
                            const int* __restrict__ targets,
                            const float* __restrict__ lse,
                            const float* __restrict__ g, TW* __restrict__ dw,
                            float* __restrict__ xs, int N, int D, int V) {
  using C = DwCfg;
  using namespace hopper;
  constexpr bool SPLIT = sizeof(TW) == 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sm_here, sm_of[C::MAX_CS];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const int me = (int)cluster_rank();
  const int cs = gridDim.x;  // the cluster spans the grid's x
  const int v0 = blockIdx.y * C::BV, d0 = me * C::SLICE;
  const int n_it = (N + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    if (sm >= C::MAX_SM) __trap();  // past the scratch
    sm_here = (int)sm;
    mbar_init(C::w_full(base), 1);
    // full: the TMA issue's arrival; ready: one arrival from each peer's
    // warpgroup
    for (int s = 0; s < C::STAGES; ++s) mbar_init(C::full(base, s), 1);
    for (int w = 0; w < 2; ++w)
      for (int p = 0; p < 2; ++p)
        mbar_init(C::ready(base, w, p), cs > 1 ? cs - 1 : 1);
    mbar_init_fence();
  }
  // the barriers are initialised before any peer arrives on them, and
  // every CTA's SM is known before any partial is exchanged
  cluster_sync();
  if (threadIdx.x < cs) {
    sm_of[threadIdx.x] = (int)ld_cluster_u32(mapa(smem_u32(&sm_here), threadIdx.x));
  }
  if (threadIdx.x == 0) {
    // this CTA's slice of W^T (hi, lo), and the first tiles of h; each
    // warpgroup loads its later tiles itself as it frees their stages
    prefetch_map(&h_map);
    mbar_arrive_expect_tx(C::w_full(base), (SPLIT ? 2 : 1) * C::W_BYTES);
    for (int b = 0; b < C::SLICE / 64; ++b) {
      tma_load_2d(C::w_tile(base, 0) + b * C::BV * 128, &whi_map,
                  C::w_full(base), d0 + 64 * b, v0);
      if (SPLIT) {
        tma_load_2d(C::w_tile(base, 1) + b * C::BV * 128, &wlo_map,
                    C::w_full(base), d0 + 64 * b, v0);
      }
    }
    for (int it = 0; it < C::STAGES && it < n_it; ++it) {
      dw_load_h(base, &h_map, it, d0, it * C::BN);
    }
  }
  __syncthreads();

  const DwArgs a{base, gbase, &h_map, targets, lse, g, xs, sm_of,
                 N, D, V, v0, d0, cs, me, (int)threadIdx.x / 128};
  if (v0 + C::BV > V) {
    dw_consumer<TW, true>(a, dw);
  } else {
    dw_consumer<TW, false>(a, dw);
  }
  // no CTA leaves while a peer may still arrive on its barriers
  cluster_sync();
}

// ------------------------------------------------ forward on wgmma --

// The forward kernel for bf16 h: a GEMM with a softmax epilogue, from
// the split of W (logits h W_hi + h W_lo, one product for a bf16 W).
// One CTA per (128-row block, vocab split); a producer warp streams, per
// 128-column vocab tile and 64-column chunk of D, the chunk of h's rows
// (from L2: every vocab tile reads it again) and of W_hi and W_lo
// through a ring of STAGES stages; two consumer warpgroups of 64 rows
// each take the logits tile [64, 128] into registers by wgmma (both
// operands K-major) and update each row's running max, sum of
// exponentials and target logit in the accumulator layout (quad
// shuffles for the tile's row max; the sums stay per thread until the
// end).  The partials of each split go to `part` as the SIMT forward's
// do, and lm_head_fwd_combine_kernel merges them.
struct FwdWCfg {
  static constexpr int BM = 128;        // rows of h per CTA
  static constexpr int BV = 128;        // vocab columns per tile
  static constexpr int BK = 64;         // columns of D per stage: one box
  static constexpr int STAGES = 4;
  static constexpr int CONSUMERS = 256;  // two warpgroups
  static constexpr int THREADS = CONSUMERS + 32;  // and a producer warp
  static constexpr int H_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BV * BK * 2;  // one term's chunk
  static constexpr int STAGE_BYTES = H_BYTES + 2 * W_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(H_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "alignment");

  static __device__ uint32_t h_tile(uint32_t b, int s) {
    return b + s * STAGE_BYTES;
  }
  static __device__ uint32_t w_tile(uint32_t b, int s, int term) {
    return b + s * STAGE_BYTES + H_BYTES + term * W_BYTES;
  }
  static __device__ uint32_t full(uint32_t b, int s) { return b + BAR_OFF + 8u * s; }
  static __device__ uint32_t empty(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (STAGES + s);
  }
};

// One logits tile into the running (max, sum, target logit) of the
// thread's two rows: x holds rows + 8 i and columns v + 8 j + c (v is
// the tile's first column plus the thread's offset).  m is quad-uniform;
// l and tl are this thread's partial sums.  MASK (the tile runs past V)
// leaves columns >= V out, whose W rows arrived zero-filled.
template <bool MASK>
__device__ __forceinline__ void fwd_tile(const float (&x)[64], float (&m)[2],
                                         float (&l)[2], float (&tl)[2],
                                         const int (&tgt)[2], int v, int V) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!MASK || v + 8 * j + c < V) mx = fmaxf(mx, x[4 * j + 2 * i + c]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float mb = m_new * LOG2E;
    float s = 0.f, tv = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = v + 8 * j + c;
        const float xv = x[4 * j + 2 * i + c];
        if (!MASK || col < V) {
          s += exp2f(fmaf(xv, LOG2E, -mb));
          if (col == tgt[i]) tv = xv;
        }
      }
    }
    l[i] = l[i] * exp2f((m[i] - m_new) * LOG2E) + s;
    tl[i] += tv;
    m[i] = m_new;
  }
}

template <typename TW>
__global__ void __launch_bounds__(FwdWCfg::THREADS, 1)
lm_head_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                         const __grid_constant__ CUtensorMap whi_map,
                         const __grid_constant__ CUtensorMap wlo_map,
                         const int* __restrict__ targets,
                         float* __restrict__ part, int N, int D, int V) {
  using C = FwdWCfg;
  using namespace hopper;
  constexpr bool SPLIT = sizeof(TW) == 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int r0 = blockIdx.x * C::BM;
  const int n_vt = (V + C::BV - 1) / C::BV;
  const int vt_begin = (int)((long long)blockIdx.y * n_vt / gridDim.y);
  const int vt_end = (int)((long long)(blockIdx.y + 1) * n_vt / gridDim.y);
  const int n_kc = (D + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(C::full(base, s), 1);
      mbar_init(C::empty(base, s), C::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // ------------------------------------------------------ producer --
    if (threadIdx.x == C::CONSUMERS) {
      prefetch_map(&h_map);
      prefetch_map(&whi_map);
      if (SPLIT) prefetch_map(&wlo_map);
      const int n_items = (vt_end - vt_begin) * n_kc;
      for (int it = 0; it < n_items; ++it) {
        const int s = it % C::STAGES;
        const int v0 = (vt_begin + it / n_kc) * C::BV, d0 = (it % n_kc) * C::BK;
        mbar_wait(C::empty(base, s), ((it / C::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(C::full(base, s),
                              C::H_BYTES + (SPLIT ? 2 : 1) * C::W_BYTES);
        tma_load_2d(C::h_tile(base, s), &h_map, C::full(base, s), d0, r0);
        tma_load_2d(C::w_tile(base, s, 0), &whi_map, C::full(base, s), d0, v0);
        if (SPLIT) {
          tma_load_2d(C::w_tile(base, s, 1), &wlo_map, C::full(base, s), d0, v0);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers --
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int row = 64 * wg + 16 * (t / 32) + lane / 4;  // + 8 i
  const int cn = 2 * (lane % 4);
  float m[2], l[2], tl[2];
  int tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + row + 8 * i;
    m[i] = NEG_INF;
    l[i] = 0.f;
    tl[i] = 0.f;
    tgt[i] = r < N ? targets[r] : -1;
  }
  int it = 0;
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    float x[64];
    for (int kc = 0; kc < n_kc; ++kc, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(C::full(base, s), (it / C::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::BK / 16; ++ks) {
        Wgmma<128>::template ss<0>(
            x, desc_kmajor<C::BK>(C::h_tile(base, s), C::BM, 64 * wg, ks),
            desc_kmajor<C::BK>(C::w_tile(base, s, 0), C::BV, 0, ks),
            kc > 0 || ks > 0);
      }
      if constexpr (SPLIT) {
#pragma unroll
        for (int ks = 0; ks < C::BK / 16; ++ks) {
          Wgmma<128>::template ss<0>(
              x, desc_kmajor<C::BK>(C::h_tile(base, s), C::BM, 64 * wg, ks),
              desc_kmajor<C::BK>(C::w_tile(base, s, 1), C::BV, 0, ks), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      mbar_arrive(C::empty(base, s));
    }
    const int v = vt * C::BV + cn;
    if (vt * C::BV + C::BV > V) {
      fwd_tile<true>(x, m, l, tl, tgt, v, V);
    } else {
      fwd_tile<false>(x, m, l, tl, tgt, v, V);
    }
  }

  // the quad's partial sums; one thread of the quad writes the row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i], ti = tl[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    ti += __shfl_xor_sync(0xffffffffu, ti, 1);
    ti += __shfl_xor_sync(0xffffffffu, ti, 2);
    const int r = r0 + row + 8 * i;
    if (lane % 4 == 0 && r < N) {
      float* p = part + ((size_t)blockIdx.y * N + r) * 3;
      p[0] = m[i];
      p[1] = li;
      p[2] = ti;
    }
  }
}

// ----------------------------------------------------- dh on wgmma --

// The dh kernel for bf16 h: the dW kernel with the roles of h and W
// swapped.  A thread block cluster of CS = ceil(D / 256) CTAs per 64-row
// tile of h (blockIdx.y); CTA `rank` owns columns [256 rank, 256 rank +
// 256) of D and keeps its [64, 256] slice of h resident in shared
// memory.  Per 64-row vocab tile of W^T (all V rows, in order):
//   1. partial logits [64 n, 64 v] = h[n, slice] W^T[v, slice]^T by
//      wgmma from shared memory, both K-major; W^T's tile (hi, then lo)
//      streams through a TMA ring;
//   2. the CS partials are exchanged through L2 and added in rank order
//      (exchange_partials), so every CTA holds the same logits;
//   3. dl = (exp(logits - lse) - onehot) g in the accumulator layout,
//      split into bf16 hi and lo register A fragments;
//   4. dh[n, slice] += dl_hi W_hi + dl_hi W_lo + dl_lo W_hi, W^T's tile
//      read MN-major through the transpose bit.  dl_lo W_lo (about 2^-18
//      of a term) is left out; a bf16 W has no lo, so there it is dl_hi W
//      + dl_lo W.
// As in dW, two consumer warpgroups take the vocab tiles in turn, each
// with its own dh accumulator (added in a fixed order at the end), and
// there is no producer warp: the warpgroup that frees a stage refills it
// with the tile STAGES on, which is the other warpgroup's (STAGES is
// odd).  A stage holds both terms of a tile (64 KB), so three fit beside
// h.  Each stage has one full barrier per warpgroup, and a tile's load
// completes on its consumer's: each barrier then has one waiter, which
// waits on every one of its phases in order, so no parity wait is ever
// two phases away from the barrier.  A barrier shared by the stage's
// alternating consumers would not do: a parity wait on tile it could
// pass on the still pending phase of tile it - 3.
struct DhCfg {
  static constexpr int BN = 64;          // rows of h per cluster
  static constexpr int BV = 64;          // vocab rows of W^T per tile
  static constexpr int SLICE = 256;      // model-dim columns per CTA
  static constexpr int MAX_CS = DwCfg::MAX_CS;
  static constexpr int STAGES = 3;
  static constexpr int THREADS = 256;    // two consumer warpgroups
  static constexpr int H_BYTES = BN * SLICE * 2;
  static constexpr int W_BYTES = BV * SLICE * 2;     // one term's tile
  static constexpr int STAGE_BYTES = 2 * W_BYTES;
  static constexpr int W_OFF = H_BYTES;              // STAGES stages
  // lse * log2 e, g, target of the tile's rows: [3][BN]
  static constexpr int ROW_OFF = W_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + 3 * BN * 4;
  // h_full, full[STAGES][2 warpgroups], ready[2 warpgroups][2]
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES + 4) * 8 + 1024;
  static_assert(H_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "alignment");
  static_assert(STAGES * STAGE_BYTES >= 128 * 128 * 4, "the final sum's buffer");
  static_assert(BYTES <= 232448 - 64, "shared memory");

  static __device__ uint32_t w_tile(uint32_t b, int s, int term) {
    return b + W_OFF + s * STAGE_BYTES + term * W_BYTES;
  }
  static __device__ uint32_t h_full(uint32_t b) { return b + BAR_OFF; }
  // stage s's full barrier for the tiles warpgroup w consumes
  static __device__ uint32_t full(uint32_t b, int s, int w) {
    return b + BAR_OFF + 8u * (1 + 2 * s + w);
  }
  static __device__ uint32_t ready(uint32_t b, int w, int p) {
    return b + BAR_OFF + 8u * (1 + 2 * STAGES + 2 * w + p);
  }
};
static_assert(DhCfg::STAGES % 2 == 1, "a refill goes to the other warpgroup");

// Vocab tile `it` of W^T (hi, and lo when SPLIT) into stage it % STAGES
// by TMA, completing on the full barrier of its consumer, warpgroup it % 2
// (one thread).
template <bool SPLIT>
__device__ __forceinline__ void dh_load_w(uint32_t base, const CUtensorMap* hi,
                                          const CUtensorMap* lo, int it, int d0) {
  using C = DhCfg;
  const int s = it % C::STAGES, v0 = it * C::BV;
  const uint32_t bar = C::full(base, s, it % 2);
  hopper::mbar_arrive_expect_tx(bar, (SPLIT ? 2 : 1) * C::W_BYTES);
  for (int b = 0; b < C::SLICE / 64; ++b) {
    hopper::tma_load_2d(C::w_tile(base, s, 0) + b * C::BV * 128, hi, bar,
                        d0 + 64 * b, v0);
    if (SPLIT) {
      hopper::tma_load_2d(C::w_tile(base, s, 1) + b * C::BV * 128, lo, bar,
                          d0 + 64 * b, v0);
    }
  }
}

// dl in place of the logits fragment x (rows nrow + 8 i of the tile,
// columns v + 8 j + c, v the tile's first column plus the thread's
// offset), from the rows' lse * log2 e, g and targets in shared memory.
// MASK (the tile runs past V) zeroes columns >= V, whose W rows arrived
// zero-filled; rows of h past N carry g = 0.
template <bool MASK>
__device__ __forceinline__ void dh_dl(float (&x)[32], const float* lse2,
                                      const float* gs, const int* tg, int nrow,
                                      int v, int V) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l2 = lse2[nrow + 8 * i], gg = gs[nrow + 8 * i];
    const int tt = tg[nrow + 8 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int idx = 4 * j + 2 * i + c, col = v + 8 * j + c;
        const float p = exp2f(fmaf(x[idx], LOG2E, -l2));
        float d = (p - (tt == col ? 1.f : 0.f)) * gg;
        if (MASK && col >= V) d = 0.f;
        x[idx] = d;
      }
    }
  }
}

template <typename TW>
__global__ void __launch_bounds__(DhCfg::THREADS, 1)
lm_head_bwd_dh_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                            const __grid_constant__ CUtensorMap whi_map,
                            const __grid_constant__ CUtensorMap wlo_map,
                            const int* __restrict__ targets,
                            const float* __restrict__ lse,
                            const float* __restrict__ g,
                            __nv_bfloat16* __restrict__ dh,
                            float* __restrict__ xs, int N, int D, int V) {
  using C = DhCfg;
  using namespace hopper;
  constexpr bool SPLIT = sizeof(TW) == 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sm_here, sm_of[C::MAX_CS];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const int me = (int)cluster_rank();
  const int cs = gridDim.x;  // the cluster spans the grid's x
  const int r0 = blockIdx.y * C::BN, d0 = me * C::SLICE;
  const int n_it = (V + C::BV - 1) / C::BV;
  float* lse2 = reinterpret_cast<float*>(gbase + C::ROW_OFF);
  float* gs = lse2 + C::BN;
  int* tg = reinterpret_cast<int*>(gs + C::BN);

  if (threadIdx.x == 0) {
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    if (sm >= DwCfg::MAX_SM) __trap();  // past the scratch
    sm_here = (int)sm;
    mbar_init(C::h_full(base), 1);
    for (int s = 0; s < C::STAGES; ++s)
      for (int w = 0; w < 2; ++w) mbar_init(C::full(base, s, w), 1);
    for (int w = 0; w < 2; ++w)
      for (int p = 0; p < 2; ++p)
        mbar_init(C::ready(base, w, p), cs > 1 ? cs - 1 : 1);
    mbar_init_fence();
  }
  // the rows' lse, g and targets; rows past N get g = 0 (so dl = 0) and
  // no target
  if (threadIdx.x < C::BN) {
    const int n = r0 + threadIdx.x;
    lse2[threadIdx.x] = n < N ? lse[n] * LOG2E : 0.f;
    gs[threadIdx.x] = n < N ? g[n] : 0.f;
    tg[threadIdx.x] = n < N ? targets[n] : -1;
  }
  // the barriers are initialised before any peer arrives on them, and
  // every CTA's SM is known before any partial is exchanged
  cluster_sync();
  if (threadIdx.x < cs) {
    sm_of[threadIdx.x] = (int)ld_cluster_u32(mapa(smem_u32(&sm_here), threadIdx.x));
  }
  if (threadIdx.x == 0) {
    // this CTA's slice of h, and the first vocab tiles of W^T
    prefetch_map(&whi_map);
    if (SPLIT) prefetch_map(&wlo_map);
    mbar_arrive_expect_tx(C::h_full(base), C::H_BYTES);
    for (int b = 0; b < C::SLICE / 64; ++b) {
      tma_load_2d(base + b * C::BN * 128, &h_map, C::h_full(base), d0 + 64 * b, r0);
    }
    for (int it = 0; it < C::STAGES && it < n_it; ++it) {
      dh_load_w<SPLIT>(base, &whi_map, &wlo_map, it, d0);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int nrow = 16 * (t / 32) + lane / 4;  // + 8 i
  const int cn = 2 * (lane % 4);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(C::h_full(base), 0);

  for (int it = wg, j = 0; it < n_it; it += 2, ++j) {
    const int s = it % C::STAGES, p = j % 2;
    // this warpgroup's tiles in stage s are it mod 2 STAGES apart
    mbar_wait(C::full(base, s, wg), (it / (2 * C::STAGES)) & 1);
    // 1. partial logits over this CTA's slice of D
    float x[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::SLICE / 16; ++ks) {
      Wgmma<64>::template ss<0>(
          x, desc_kmajor<C::SLICE>(base, C::BN, 0, ks),
          desc_kmajor<C::SLICE>(C::w_tile(base, s, 0), C::BV, 0, ks), ks > 0);
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int ks = 0; ks < C::SLICE / 16; ++ks) {
        Wgmma<64>::template ss<0>(
            x, desc_kmajor<C::SLICE>(base, C::BN, 0, ks),
            desc_kmajor<C::SLICE>(C::w_tile(base, s, 1), C::BV, 0, ks), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // 2. the cluster's partials through L2, added in rank order
    if (cs > 1) {
      exchange_partials(x, xs, sm_of, cs, me, wg, p, j, C::ready(base, wg, p));
    }

    // 3. dl, split into bf16 hi and lo A fragments (k-slice kt: tile
    // columns [16 kt, 16 kt + 16))
    const int v = it * C::BV + cn;
    if (it * C::BV + C::BV > V) {
      dh_dl<true>(x, lse2, gs, tg, nrow, v, V);
    } else {
      dh_dl<false>(x, lse2, gs, tg, nrow, v, V);
    }
    uint32_t fhi[C::BV / 16][4], flo[C::BV / 16][4];
#pragma unroll
    for (int kt = 0; kt < C::BV / 16; ++kt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lo = x[8 * kt + 2 * r], hi = x[8 * kt + 2 * r + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
        const float2 hf = __bfloat1622float2(h2);
        fhi[kt][r] = *reinterpret_cast<const uint32_t*>(&h2);
        flo[kt][r] = pack_bf16(lo - hf.x, hi - hf.y);
      }
    }

    // 4. dh += dl_hi W_hi + dl_hi W_lo + dl_lo W_hi, waited for at once
    // (left in flight over the next tile's logits, ptxas serialises
    // every wgmma)
    fence_frags(fhi);
    fence_frags(flo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::BV / 16; ++ks) {
      Wgmma<256>::template rs<1>(
          acc, fhi[ks], desc_mnmajor<C::SLICE>(C::w_tile(base, s, 0), C::BV, ks), 1);
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int ks = 0; ks < C::BV / 16; ++ks) {
        Wgmma<256>::template rs<1>(
            acc, fhi[ks], desc_mnmajor<C::SLICE>(C::w_tile(base, s, 1), C::BV, ks), 1);
      }
    }
#pragma unroll
    for (int ks = 0; ks < C::BV / 16; ++ks) {
      Wgmma<256>::template rs<1>(
          acc, flo[ks], desc_mnmajor<C::SLICE>(C::w_tile(base, s, 0), C::BV, ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // the stage is free once all four warps' products are done (each
    // warp's wait covers its own share of the wgmma): tile it + STAGES
    // goes there
    named_sync(1 + wg, 128);
    if (t == 0 && it + C::STAGES < n_it) {
      dh_load_w<SPLIT>(base, &whi_map, &wlo_map, it + C::STAGES, d0);
    }
  }

  // the two warpgroups' sums, added in a fixed order (warpgroup 0's
  // first) in the stages, which every tile has left by now
  float4* sum = reinterpret_cast<float4*>(gbase + C::W_OFF);
  named_sync(3, 256);
  if (wg == 1) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      sum[q * 128 + t] = make_float4(acc[4 * q], acc[4 * q + 1],
                                     acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  named_sync(3, 256);
  if (wg == 0) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const float4 o = sum[q * 128 + t];
      acc[4 * q] += o.x; acc[4 * q + 1] += o.y; acc[4 * q + 2] += o.z;
      acc[4 * q + 3] += o.w;
    }
    // epilogue: dh[n, d], rows r0 + nrow + 8 i, columns d0 + 8 j + cn + c
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = r0 + nrow + 8 * i;
      if (n >= N) continue;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = d0 + 8 * jj + cn + c;
          if (d < D) dh[(size_t)n * D + d] = __float2bfloat16(acc[4 * jj + 2 * i + c]);
        }
      }
    }
  }
  // no CTA leaves while a peer may still arrive on its barriers
  cluster_sync();
}

// ------------------------------------------------------------- launch --

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TH, typename TW>
int launch_fwd(const void* h, const void* w, const int* targets, float* part,
               float* loss, float* lse, int N, int D, int V, int splits,
               cudaStream_t stream) {
  auto kernel = lm_head_fwd_kernel<TH, TW>;
  int err;
  if ((err = prepare(kernel, FwdLayout::BYTES)) != 0) return err;
  const dim3 grid((N + F_BM - 1) / F_BM, splits);
  kernel<<<grid, NTHREADS, FwdLayout::BYTES, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), targets, part, N,
      D, V);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  lm_head_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      part, loss, lse, N, splits);
  return (int)cudaGetLastError();
}

template <typename TH, typename TW>
int launch_dh(const void* h, const void* w, const int* targets,
              const float* lse, const float* g, void* dh, int N, int D, int V,
              cudaStream_t stream) {
  auto kernel = lm_head_bwd_dh_kernel<TH, TW>;
  int err;
  if ((err = prepare(kernel, DhLayout::BYTES)) != 0) return err;
  kernel<<<(N + H_BM - 1) / H_BM, NTHREADS, DhLayout::BYTES, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), targets, lse, g,
      static_cast<TH*>(dh), N, D, V);
  return (int)cudaGetLastError();
}

template <typename TH, typename TW>
int launch_dw(const void* h, const void* w, const int* targets,
              const float* lse, const float* g, void* dw, int N, int D, int V,
              cudaStream_t stream) {
  auto kernel = lm_head_bwd_dw_kernel<TH, TW>;
  int err;
  if ((err = prepare(kernel, DwLayout::BYTES)) != 0) return err;
  kernel<<<(V + W_BV - 1) / W_BV, NTHREADS, DwLayout::BYTES, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), targets, lse, g,
      static_cast<TW*>(dw), N, D, V);
  return (int)cudaGetLastError();
}

template <typename TW, bool SPLIT>
int launch_split(const void* w, void* hi, void* lo, int D, int V, int ld,
                 cudaStream_t stream) {
  const dim3 grid((V + 31) / 32, (ld + 31) / 32);
  lm_head_split_w_kernel<TW, SPLIT><<<grid, 256, 0, stream>>>(
      static_cast<const TW*>(w), static_cast<__nv_bfloat16*>(hi),
      static_cast<__nv_bfloat16*>(lo), D, V, ld);
  return (int)cudaGetLastError();
}

// Encodes the maps and launches one cluster of ceil(D / 256) CTAs per
// vocab block.  The first call of each instantiation raises its
// shared-memory limit and checks that ptxas kept everything in registers
// (a spilled accumulator would be read while wgmma still writes it) and
// that the block size fits.
template <typename TW>
int launch_dw_wgmma(const void* h, int h_ld, const void* w_hi,
                    const void* w_lo, int w_ld, const int* targets,
                    const float* lse, const float* g, void* dw, float* xs,
                    int N, int D, int V, cudaStream_t stream) {
  using C = DwCfg;
  auto kernel = lm_head_bwd_dw_wgmma_kernel<TW>;
  static int ready = 0;
  if (ready == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.localSizeBytes != 0 || attr.maxThreadsPerBlock < C::THREADS)
      return KF_BAD_REGS;
    if ((err = (cudaError_t)prepare(kernel, C::BYTES)) != cudaSuccess)
      return (int)err;
    ready = 1;
  }
  const int cs = (D + C::SLICE - 1) / C::SLICE;
  CUtensorMap hm, whm, wlm;
  int err = hopper::encode_matrix_map(&hm, h, D, N, 2LL * h_ld, C::BN);
  if (err == 0)
    err = hopper::encode_matrix_map(&whm, w_hi, D, V, 2LL * w_ld, C::BV);
  if (err == 0)
    err = hopper::encode_matrix_map(&wlm, w_lo != nullptr ? w_lo : w_hi, D, V,
                                    2LL * w_ld, C::BV);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (V + C::BV - 1) / C::BV);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, hm, whm, wlm, targets,
                                           lse, g, static_cast<TW*>(dw), xs,
                                           N, D, V);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The same, for the wgmma forward: one CTA per 128-row block and vocab
// split.  The first call of each instantiation checks the build (no
// spills, the block size fits) and raises the shared-memory limit.
template <typename TW>
int launch_fwd_wgmma(const void* h, int h_ld, const void* w_hi,
                     const void* w_lo, int w_ld, const int* targets,
                     float* part, float* loss, float* lse, int N, int D,
                     int V, int splits, cudaStream_t stream) {
  using C = FwdWCfg;
  auto kernel = lm_head_fwd_wgmma_kernel<TW>;
  static int ready = 0;
  if (ready == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.localSizeBytes != 0 || attr.maxThreadsPerBlock < C::THREADS)
      return KF_BAD_REGS;
    if ((err = (cudaError_t)prepare(kernel, C::BYTES)) != cudaSuccess)
      return (int)err;
    ready = 1;
  }
  CUtensorMap hm, whm, wlm;
  int err = hopper::encode_matrix_map(&hm, h, D, N, 2LL * h_ld, C::BM);
  if (err == 0)
    err = hopper::encode_matrix_map(&whm, w_hi, D, V, 2LL * w_ld, C::BV);
  if (err == 0)
    err = hopper::encode_matrix_map(&wlm, w_lo != nullptr ? w_lo : w_hi, D, V,
                                    2LL * w_ld, C::BV);
  if (err != 0) return err;
  const dim3 grid((N + C::BM - 1) / C::BM, splits);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(hm, whm, wlm, targets, part,
                                                 N, D, V);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  lm_head_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      part, loss, lse, N, splits);
  return (int)cudaGetLastError();
}

// The same, for the wgmma dh kernel: one cluster of ceil(D / 256) CTAs
// per 64-row tile of h.
template <typename TW>
int launch_dh_wgmma(const void* h, int h_ld, const void* w_hi,
                    const void* w_lo, int w_ld, const int* targets,
                    const float* lse, const float* g, void* dh, float* xs,
                    int N, int D, int V, cudaStream_t stream) {
  using C = DhCfg;
  auto kernel = lm_head_bwd_dh_wgmma_kernel<TW>;
  static int ready = 0;
  if (ready == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.localSizeBytes != 0 || attr.maxThreadsPerBlock < C::THREADS)
      return KF_BAD_REGS;
    if ((err = (cudaError_t)prepare(kernel, C::BYTES)) != cudaSuccess)
      return (int)err;
    ready = 1;
  }
  const int cs = (D + C::SLICE - 1) / C::SLICE;
  CUtensorMap hm, whm, wlm;
  int err = hopper::encode_matrix_map(&hm, h, D, N, 2LL * h_ld, C::BN);
  if (err == 0)
    err = hopper::encode_matrix_map(&whm, w_hi, D, V, 2LL * w_ld, C::BV);
  if (err == 0)
    err = hopper::encode_matrix_map(&wlm, w_lo != nullptr ? w_lo : w_hi, D, V,
                                    2LL * w_ld, C::BV);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (N + C::BN - 1) / C::BN);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, hm, whm, wlm, targets, lse, g,
      static_cast<__nv_bfloat16*>(dh), xs, N, D, V);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// FN<TH, TW>(...) for the element types of h and w.
#define KF_DISPATCH(h_bf16, w_bf16, FN, ...)                              \
  ((h_bf16) ? ((w_bf16) ? FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__)   \
                        : FN<__nv_bfloat16, float>(__VA_ARGS__))          \
            : ((w_bf16) ? FN<float, __nv_bfloat16>(__VA_ARGS__)           \
                        : FN<float, float>(__VA_ARGS__)))

bool bad_sizes(int n, int d, int v) { return n <= 0 || d <= 0 || v <= 0; }

// Vocab splits of the forward: enough CTAs to fill the card, at most one
// split per vocab tile.
int fwd_splits(int n, int v) {
  const int row_blocks = (n + F_BM - 1) / F_BM;
  const int tiles = (v + F_BN - 1) / F_BN;
  return std::max(1, std::min(tiles, (F_TARGET_CTAS + row_blocks - 1) / row_blocks));
}

// Vocab splits of the wgmma forward (one CTA per SM): as many as one
// wave of the card's SMs holds, at most one split per vocab tile.
int fwd_wgmma_splits(int n, int v) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int row_blocks = (n + FwdWCfg::BM - 1) / FwdWCfg::BM;
  const int tiles = (v + FwdWCfg::BV - 1) / FwdWCfg::BV;
  return std::max(1, std::min(tiles, sms / row_blocks));
}

}  // namespace

// The vocab splits of the forward for bf16 h (the wgmma kernel) or f32
// h; its scratch `part` holds splits * n * 3 f32 values.
extern "C" int kf_lm_head_fwd_splits(int n, int v, int h_bf16) {
  if (n <= 0 || v <= 0) return KF_BAD_ARGS;
  return h_bf16 ? fwd_wgmma_splits(n, v) : fwd_splits(n, v);
}

// Each launcher returns 0 on success, a cudaError_t code, or -1 for
// arguments the kernels do not take (the Python wrapper checks first).
// The f32-h forward (bf16 h takes kf_lm_head_fwd_wgmma).
extern "C" int kf_lm_head_fwd(const void* h, const void* w,
                              const void* targets, void* part, void* loss,
                              void* lse, int n, int d, int v, int w_bf16,
                              void* stream) {
  if (bad_sizes(n, d, v)) return KF_BAD_ARGS;
  const int* t = static_cast<const int*>(targets);
  float* p = static_cast<float*>(part);
  float* out_loss = static_cast<float*>(loss);
  float* out_lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? launch_fwd<float, __nv_bfloat16>(h, w, t, p, out_loss, out_lse,
                                                   n, d, v, fwd_splits(n, v), st)
                : launch_fwd<float, float>(h, w, t, p, out_loss, out_lse, n, d,
                                           v, fwd_splits(n, v), st);
}

extern "C" int kf_lm_head_bwd_dh(const void* h, const void* w,
                                 const void* targets, const void* lse,
                                 const void* g, void* dh, int n, int d, int v,
                                 int h_bf16, int w_bf16, void* stream) {
  if (bad_sizes(n, d, v)) return KF_BAD_ARGS;
  return KF_DISPATCH(h_bf16, w_bf16, launch_dh, h, w,
                     static_cast<const int*>(targets),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(g), dh, n, d, v,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int kf_lm_head_bwd_dw(const void* h, const void* w,
                                 const void* targets, const void* lse,
                                 const void* g, void* dw, int n, int d, int v,
                                 int h_bf16, int w_bf16, void* stream) {
  if (bad_sizes(n, d, v)) return KF_BAD_ARGS;
  return KF_DISPATCH(h_bf16, w_bf16, launch_dw, h, w,
                     static_cast<const int*>(targets),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(g), dw, n, d, v,
                     static_cast<cudaStream_t>(stream));
}

// W [D, V] (f32 or bf16) to hi, lo bf16 [V, ld] (lo untouched for bf16 W).
extern "C" int kf_lm_head_split_w(const void* w, void* hi, void* lo, int d,
                                  int v, int ld, int w_bf16, void* stream) {
  if (d <= 0 || v <= 0 || ld < d || ld % 8 || (ld + 31) / 32 > 65535)
    return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? launch_split<__nv_bfloat16, false>(w, hi, lo, d, v, ld, st)
                : launch_split<float, true>(w, hi, lo, d, v, ld, st);
}

// Floats of the wgmma dW and dh kernels' exchange scratch (kept in L2).
extern "C" long long kf_lm_head_exchange_scratch() {
  return 4LL * DwCfg::MAX_SM * DwCfg::PART_FLOATS;
}

// Loss and lse (f32 [N]) for bf16 h [N, D] with row pitch h_ld (a
// multiple of 8, 16-byte aligned base), from the split's hi and lo (lo
// ignored for bf16 W); part: splits * n * 3 floats, splits from
// kf_lm_head_fwd_splits(n, v, 1).
extern "C" int kf_lm_head_fwd_wgmma(const void* h, int h_ld, const void* w_hi,
                                    const void* w_lo, int w_ld,
                                    const void* targets, void* part,
                                    void* loss, void* lse, int n, int d,
                                    int v, int splits, int w_bf16,
                                    void* stream) {
  if (bad_sizes(n, d, v) || h_ld < d || h_ld % 8 || w_ld < d || w_ld % 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 || splits < 1 || splits > 65535)
    return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  float* p = static_cast<float*>(part);
  float* out_loss = static_cast<float*>(loss);
  float* out_lse = static_cast<float*>(lse);
  return w_bf16 ? launch_fwd_wgmma<__nv_bfloat16>(h, h_ld, w_hi, nullptr, w_ld,
                                                  t, p, out_loss, out_lse, n, d,
                                                  v, splits, st)
                : launch_fwd_wgmma<float>(h, h_ld, w_hi, w_lo, w_ld, t, p,
                                          out_loss, out_lse, n, d, v, splits,
                                          st);
}

// dh (bf16 [N, D]) for bf16 h, arguments as kf_lm_head_bwd_dw_wgmma's.
extern "C" int kf_lm_head_bwd_dh_wgmma(const void* h, int h_ld,
                                       const void* w_hi, const void* w_lo,
                                       int w_ld, const void* targets,
                                       const void* lse, const void* g,
                                       void* dh, void* xs, int n, int d,
                                       int v, int w_bf16, void* stream) {
  if (bad_sizes(n, d, v) || d > DhCfg::SLICE * DhCfg::MAX_CS || h_ld < d ||
      h_ld % 8 || w_ld < d || w_ld % 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      (n + DhCfg::BN - 1) / DhCfg::BN > 65535)
    return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* x = static_cast<float*>(xs);
  return w_bf16 ? launch_dh_wgmma<__nv_bfloat16>(h, h_ld, w_hi, nullptr, w_ld,
                                                 t, l, gg, dh, x, n, d, v, st)
                : launch_dh_wgmma<float>(h, h_ld, w_hi, w_lo, w_ld, t, l, gg,
                                         dh, x, n, d, v, st);
}

// dW [D, V] in W's dtype for bf16 h [N, D] with row pitch h_ld (a
// multiple of 8, 16-byte aligned base), from the split's hi and lo
// (lo ignored for bf16 W); D at most 256 * 8; xs: kf_lm_head_exchange_scratch()
// floats, any contents.
extern "C" int kf_lm_head_bwd_dw_wgmma(const void* h, int h_ld,
                                       const void* w_hi, const void* w_lo,
                                       int w_ld, const void* targets,
                                       const void* lse, const void* g,
                                       void* dw, void* xs, int n, int d,
                                       int v, int w_bf16, void* stream) {
  if (bad_sizes(n, d, v) || d > DwCfg::SLICE * DwCfg::MAX_CS || h_ld < d ||
      h_ld % 8 || w_ld < d || w_ld % 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      (v + DwCfg::BV - 1) / DwCfg::BV > 65535)
    return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* x = static_cast<float*>(xs);
  return w_bf16 ? launch_dw_wgmma<__nv_bfloat16>(h, h_ld, w_hi, nullptr, w_ld,
                                                 t, l, gg, dw, x, n, d, v, st)
                : launch_dw_wgmma<float>(h, h_ld, w_hi, w_lo, w_ld, t, l, gg,
                                         dw, x, n, d, v, st);
}

extern "C" const char* kf_error_string(int code) {
  if (code == KF_BAD_ARGS) return "unsupported arguments";
  if (code == hopper::KF_TMA_ENCODE_FAILED) return "cuTensorMapEncodeTiled failed";
  if (code == KF_BAD_REGS) {
    return "the wgmma kernel spills registers or cannot run its block size";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
