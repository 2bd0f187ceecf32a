// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kungfu_tpu/ops/pallas/attention.py::_fwd_kernel
// (launched by _fwd_call).  It computes the same function: per (batch*head,
// q block) an online softmax over the kv blocks with a running max m, a
// running sum l and an f32 output accumulator; scores are masked to -1e30
// past the sequence end and above the diagonal (causal); masked
// probabilities are zeroed and l is clamped to 1e-30, so a fully masked row
// yields 0; O is written in the input dtype and lse = m + log(l) in f32.
// A causal q block stops at the last kv block it attends to (the
// reference's _causal_hi), so causal attention does about half the work.
//
// Design for the card, not the TPU's block by block:
// * One CTA of four warps per (bh, 64-row q block); each warp owns 16 q
//   rows.  The TPU carried m/l/acc across a sequential grid axis; here
//   the kv walk is a loop inside the CTA, and CTAs run in any order.
// * 64x64 tiles: the Q tile and one K and one V tile live in shared
//   memory, reused by all 64 q rows; scores and probabilities never leave
//   the SM.  64 rows is the smallest tile that still gives each warp a
//   full 16-row tensor-core fragment, and at the flagship shape (BH 48,
//   S 256) it yields 192 CTAs on 132 SMs where 128-row tiles would leave
//   a third of the card idle.  (The TPU tiles of 256x1024 fit 16 MB of
//   VMEM; a CTA here has 227 KB of shared memory.)
// * bf16: both products on the tensor cores through WMMA (bf16 in, f32
//   accumulate).  P is rounded to bf16 before the PV product, like the
//   reference's p.astype(v.dtype); l sums the unrounded f32 P.
// * f32: plain FMA on the CUDA cores, never TF32, so f32 parity checks
//   hold the algorithm to f32 rounding.  Q is pre-scaled by 1/sqrt(D)
//   as the reference does before its dot.
// * Ragged S is masked with bounds checks (rows past S load as zeros);
//   nothing is padded in device memory.  lse is a plain [BH, S] row
//   vector (the TPU's 128-lane replication was a Mosaic tiling rule).
// * Causal q blocks are scheduled heaviest first (blockIdx.x reversed).
//
// What bounds it: at the flagship shape the causal forward needs about
// 0.4 GFLOP against 6.3 MB of q/k/v/o traffic, so the card's memory, not
// its tensor cores, sets the least time; this simple kernel (no wgmma,
// TMA or warp specialisation yet) is bound in practice by its serial
// load -> sync -> compute steps.  PERF.md holds the measured times.
//
// Interface: a plain C launcher taking device pointers and the caller's
// stream, loaded with ctypes (kungfu_tpu_torch/ops/cuda/attention.py).
// q, k, v, o are contiguous [BH, S, D] with 16-byte aligned bases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // q rows per CTA
constexpr int BK = 64;          // kv rows per tile
constexpr int NTHREADS = 128;   // four warps, 16 q rows each
constexpr float MASK_VALUE = -1e30f;
constexpr int KF_BAD_ARGS = -1;

__host__ __device__ constexpr size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Shared-memory carve-up for the bf16 kernel.  Leading dimensions are
// padded (rows stay 32-byte aligned for WMMA, banks are staggered).
template <int D>
struct Bf16Layout {
  static constexpr int LDT = D + 8;   // bf16 Q/K/V tiles
  static constexpr int LDS = BK + 4;  // f32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 output accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + round_up(size_t(BQ) * LDT * 2, 128);
  static constexpr size_t V = K + round_up(size_t(BK) * LDT * 2, 128);
  static constexpr size_t S = V + round_up(size_t(BK) * LDT * 2, 128);
  static constexpr size_t P = S + round_up(size_t(BQ) * LDS * 4, 128);
  static constexpr size_t O = P + round_up(size_t(BQ) * LDP * 2, 128);
  static constexpr size_t BYTES = O + round_up(size_t(BQ) * LDO * 4, 128);
};

template <int D>
struct F32Layout {
  static constexpr int LDT = D + 4;   // f32 Q/K/V tiles
  static constexpr int LDP = BK + 4;  // f32 probabilities
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + round_up(size_t(BQ) * LDT * 4, 128);
  static constexpr size_t V = K + round_up(size_t(BK) * LDT * 4, 128);
  static constexpr size_t P = V + round_up(size_t(BK) * LDT * 4, 128);
  static constexpr size_t BYTES = P + round_up(size_t(BQ) * LDP * 4, 128);
};

// Rows [r0, r0 + 64) of a contiguous [S, D] matrix into shared memory with
// leading dimension LD, 16 bytes per thread per step; rows past S are zero
// so that masked scores and padded V rows stay finite.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int S, int tid) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = D / EPV;
  for (int i = tid; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * EPV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Online-softmax update for one row half: 32 raw scores (already scaled)
// of columns [c0, c0 + 32), shared by the lane pair (lane, lane ^ 1).
// Returns the correction factor for the accumulator; writes P via `put`.
template <typename Put>
__device__ __forceinline__ float softmax_update(const float* scores, int k0,
                                                int c0, int qpos, int S,
                                                int causal, float& m, float& l,
                                                Put put) {
  float sv[32];
  unsigned live = 0u;
  float mx = MASK_VALUE;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int kpos = k0 + c0 + j;
    const bool ok = kpos < S && (!causal || qpos >= kpos);
    sv[j] = ok ? scores[j] : MASK_VALUE;
    live |= (ok ? 1u : 0u) << j;
    mx = fmaxf(mx, sv[j]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m, mx);
  const float corr = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    // masked entries contribute 0, also when the whole row is masked so far
    const float p = ((live >> j) & 1u) ? expf(sv[j] - m_new) : 0.f;
    sum += p;
    put(j, p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l = l * corr + sum;
  m = m_new;
  return corr;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, float scale, int causal) {
  using L = Bf16Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = warp * 16 + (lane >> 1);  // the row this lane pair owns
  const int half = lane & 1;
  const int qpos = q0 + row;

  load_rows<__nv_bfloat16, D, L::LDT>(Qs, q + base, q0, S, tid);
  for (int i = tid; i < BQ * D; i += NTHREADS) Os[(i / D) * L::LDO + i % D] = 0.f;

  const int n_kb = (S + BK - 1) / BK;
  const int kb_end = causal ? min(n_kb, (q0 + BQ - 1) / BK + 1) : n_kb;
  float m = MASK_VALUE, l = 0.f;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // all warps are done with the previous K/V tiles
    load_rows<__nv_bfloat16, D, L::LDT>(Ks, k + base, k0, S, tid);
    load_rows<__nv_bfloat16, D, L::LDT>(Vs, v + base, k0, S, tid);
    __syncthreads();

    // scores of this warp's 16 rows: Q K^T, bf16 in, f32 accumulate
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, Qs + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        // K stored [kv, D] row-major is K^T column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kt;
        wmma::load_matrix_sync(kt, Ks + n * 16 * L::LDT + kk, L::LDT);
        wmma::mma_sync(sacc[n], qa, kt, sacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + n * 16, sacc[n], L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    float scaled[32];
    const float* srow = Ss + row * L::LDS + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) scaled[j] = srow[j] * scale;
    __nv_bfloat16* prow = Ps + row * L::LDP + half * 32;
    const float corr = softmax_update(
        scaled, k0, half * 32, qpos, S, causal, m, l,
        [&](int j, float p) { prow[j] = __float2bfloat16(p); });
    float* orow = Os + row * L::LDO + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O += P V on this warp's rows
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::load_matrix_sync(pa[kk], Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
    }
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      float* otile = Os + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(oacc, otile, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * L::LDT + n * 16, L::LDT);
        wmma::mma_sync(oacc, pa[kk], vb, oacc);
      }
      wmma::store_matrix_sync(otile, oacc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const float l_safe = fmaxf(l, 1e-30f);
  if (qpos < S) {
    const float* orow = Os + row * L::LDO + half * (D / 2);
    __nv_bfloat16* dst = o + base + (size_t)qpos * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dst[c] = __float2bfloat16(orow[c] / l_safe);
    if (half == 0) lse[(size_t)blockIdx.y * S + qpos] = m + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, float scale, int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ps = reinterpret_cast<float*>(smem + L::P);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q0 + row;

  load_rows<float, D, L::LDT>(Qs, q + base, q0, S, tid);
  __syncthreads();
  for (int i = tid; i < BQ * D; i += NTHREADS) Qs[(i / D) * L::LDT + i % D] *= scale;

  const int n_kb = (S + BK - 1) / BK;
  const int kb_end = causal ? min(n_kb, (q0 + BQ - 1) / BK + 1) : n_kb;
  float m = MASK_VALUE, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_rows<float, D, L::LDT>(Ks, k + base, k0, S, tid);
    load_rows<float, D, L::LDT>(Vs, v + base, k0, S, tid);
    __syncthreads();

    const float* qrow = Qs + row * L::LDT;
    float scores[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float* krow = Ks + (half * 32 + j) * L::LDT;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      scores[j] = s;
    }
    float* prow = Ps + row * L::LDP;
    const float corr = softmax_update(
        scores, k0, half * 32, qpos, S, causal, m, l,
        [&](int j, float p) { prow[half * 32 + j] = p; });
    __syncwarp();
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * L::LDT + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] = fmaf(p, vrow[c], acc[c]);
    }
    __syncwarp();
  }

  const float l_safe = fmaxf(l, 1e-30f);
  if (qpos < S) {
    float* dst = o + base + (size_t)qpos * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dst[c] = acc[c] / l_safe;
    if (half == 0) lse[(size_t)blockIdx.y * S + qpos] = m + logf(l_safe);
  }
}

template <typename T, int D, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* q, const void* k,
           const void* v, void* o, void* lse, int bh, int S, float scale,
           int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int is_bf16, const void* q, const void* k, const void* v, void* o,
             void* lse, int bh, int S, float scale, int causal,
             cudaStream_t stream) {
  if (is_bf16) {
    return launch<__nv_bfloat16, D>(flash_fwd_bf16_kernel<D>,
                                    Bf16Layout<D>::BYTES, q, k, v, o, lse, bh,
                                    S, scale, causal, stream);
  }
  return launch<float, D>(flash_fwd_f32_kernel<D>, F32Layout<D>::BYTES, q, k,
                          v, o, lse, bh, S, scale, causal, stream);
}

}  // namespace

// Returns 0 on success, a cudaError_t code, or -1 for arguments the kernel
// does not take (the Python wrapper checks them first).
extern "C" int kf_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int seq, int head_dim,
                            int causal, int is_bf16, float scale,
                            void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0) return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return dispatch<32>(is_bf16, q, k, v, o, lse, bh, seq, scale, causal, st);
    case 64:
      return dispatch<64>(is_bf16, q, k, v, o, lse, bh, seq, scale, causal, st);
    case 128:
      return dispatch<128>(is_bf16, q, k, v, o, lse, bh, seq, scale, causal, st);
    default:
      return KF_BAD_ARGS;
  }
}

extern "C" const char* kf_error_string(int code) {
  if (code == KF_BAD_ARGS) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
