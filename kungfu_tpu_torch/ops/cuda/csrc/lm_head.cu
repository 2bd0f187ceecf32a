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
// Design for the card, not the TPU's block by block:
// * The TPU carried its accumulators in VMEM across a sequential grid
//   axis; here that axis is a loop inside one CTA, and CTAs run in any
//   order.  No atomics: every result is deterministic.
//   - forward: one CTA per (128-row block, vocab split) walks its share
//     of the vocab in 128-column tiles, keeping a running max, sum of
//     exponentials and target logit per (row, column subset) in each
//     thread's registers; the 16 threads of a row merge them in shared
//     memory, and a small second kernel merges the splits into loss and
//     lse.  The splits exist only to fill the card: 64 row blocks alone
//     would leave most of the SMs idle at the flagship shape.
//   - dh: one CTA per 32-row block walks the vocab in 256-column tiles;
//     per tile it recomputes the logits tile, forms dl in shared memory
//     and adds dl W^T to a [32, 768] f32 accumulator held in registers
//     (96 values a thread).
//   - dW: one CTA per 32-column vocab block walks the rows in 128-row
//     tiles; per tile it recomputes the logits tile, forms dl in shared
//     memory and adds h^T dl to a [768, 32] f32 accumulator in registers.
//   A model dimension above 768 is handled in 768-wide chunks, each
//   chunk sweeping (and recomputing) the logits again.
// * The accumulators live in registers (up to 255 a thread), so one CTA
//   runs per SM and no second CTA hides its loads.  Instead each product
//   walks its K dimension in chunks staged through shared memory, and the
//   next chunk's global loads are issued into registers before the
//   current chunk's products (Chunk::fetch / store), so their latency
//   hides behind them; only dh's second product loads its chunk just in
//   time, because the registers a chunk ahead would need spill.
// * Every product is an f32 SIMT product on the CUDA cores: each
//   operand is converted to f32 as it is staged into shared memory
//   (exact for bf16), multiplied with fmaf and summed in f32.  TF32 is
//   never used and W is never rounded to bf16, so the flagship's f32
//   head weights keep their value (lm_head.py:54-57 and :129-132,
//   :157-160 take f32 products with f32 accumulation).  The all-bf16
//   case takes the same f32 path: its products are exact in f32.
// * Rounding points: the logits, the probabilities and dl stay f32
//   (never stored); loss and lse are written in f32; dh is rounded once
//   to h's dtype and dW once to W's dtype, from their f32 accumulators,
//   as the reference casts its f32 scratch at the end of each sweep.
// * Each block tile is a register-blocked SIMT GEMM: operands staged in
//   shared memory k-major, each thread owning a 4-aligned grid of
//   outputs (8x8 forward, 4x8 and 4x24 in dh, 4x4 and 24x4 in dW) fed by
//   16-byte shared loads, arranged so that a warp's loads are broadcasts
//   or one contiguous 128-byte line.
// * Ragged N, D and V are masked inside the kernels (no padding copies):
//   rows and columns past the end load as zeros, masked vocab columns
//   take no part in the max or the sum (a -inf logit) and get dl = 0;
//   rows past N have g = 0 and are never written.
//
// What bounds it: at the flagship shape (N 8192, D 768, V 32128) the
// forward does one 2*N*D*V = 404 GFLOP product and each backward kernel
// two (the recomputed logits and its own product), against ~111 MB of
// operand traffic, so every kernel is bound by operations: 0.41 / 0.82 /
// 0.82 ms at the bf16 tensor-core peak, 6.0 / 12.1 / 12.1 ms at the
// 67 TFLOP/s FP32 peak its f32 products run at.  This simple kernel (no
// wgmma, TMA or cp.async ring; one CTA per SM, two barriers per chunk)
// is slower than cuBLAS's f32 GEMMs; PERF.md holds the measured times.
// A faster head splits W into two bf16 halves on the tensor cores.
//
// Interface: plain C launchers taking device pointers and the caller's
// stream, loaded with ctypes (kungfu_tpu_torch/ops/cuda/lm_head.py).  h is
// a contiguous [N, D] matrix, w a contiguous [D, V] matrix (the JAX
// layout), targets int32 [N]; lse and g are f32 [N]; each element type
// is float or bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NTHREADS = 256;
constexpr int BK = 16;     // depth of a chunk along D in the logits products
constexpr int DC = 768;    // model-dim columns one accumulator holds
constexpr float NEG_INF = -1e30f;
constexpr int KF_BAD_ARGS = -1;

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

}  // namespace

// The number of f32 values of the forward's scratch `part` is
// kf_lm_head_fwd_splits(n, v) * n * 3.
extern "C" int kf_lm_head_fwd_splits(int n, int v) {
  return n > 0 && v > 0 ? fwd_splits(n, v) : KF_BAD_ARGS;
}

// Each launcher returns 0 on success, a cudaError_t code, or -1 for
// arguments the kernels do not take (the Python wrapper checks first).
extern "C" int kf_lm_head_fwd(const void* h, const void* w,
                              const void* targets, void* part, void* loss,
                              void* lse, int n, int d, int v, int h_bf16,
                              int w_bf16, void* stream) {
  if (bad_sizes(n, d, v)) return KF_BAD_ARGS;
  return KF_DISPATCH(h_bf16, w_bf16, launch_fwd, h, w,
                     static_cast<const int*>(targets),
                     static_cast<float*>(part), static_cast<float*>(loss),
                     static_cast<float*>(lse), n, d, v, fwd_splits(n, v),
                     static_cast<cudaStream_t>(stream));
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

extern "C" const char* kf_error_string(int code) {
  if (code == KF_BAD_ARGS) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
