// Flash-attention backward for NVIDIA Hopper (sm_90a): a dQ kernel and a
// dK/dV kernel.
//
// Replaces the TPU kernels kungfu_tpu/ops/pallas/attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (launched by _bwd_pallas).  Both
// recompute the probabilities from the forward's logsumexp rows instead of
// storing them:
//
//     P  = exp(S - lse)           S = Q K^T * scale, masked entries P = 0
//     dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) - dlse
//     dQ = dS K * scale,  dK = dS^T (Q * scale),  dV = P^T dO
//
// delta is computed by the caller (the reference computes it outside its
// Pallas kernels too).  Like the reference there are two kernels and no
// atomics, so every result is deterministic:
// * dQ: one CTA per (bh, 64-row q block) loops over the kv blocks up to
//   the causal edge, accumulating dQ; q blocks run heaviest first.
// * dK/dV: one CTA per (bh, 64-row kv block) loops over the q blocks from
//   the causal edge on, accumulating dK and dV.
//
// P uses the lse that the port's forward wrote: bf16 takes the product of
// unscaled Q and K (f32 accumulate), then x scale in f32; f32 takes Q
// pre-scaled by scale and a sequential FMA dot, as the forward's f32
// kernel does.  The reference's rounding points are kept:
// dO and V are bf16 into dO V^T, dS is rounded to K's dtype before dS K,
// P to dO's dtype before P^T dO, dS and Q*scale to Q's dtype before
// dS^T (Q*scale); every product accumulates in f32.
//
// dQ (bf16 and f32) and dK/dV f32: four warps per CTA, each owning 16
// rows of the product it accumulates; the accumulators stay in registers
// (WMMA fragments for bf16, arrays for f32) across the whole loop,
// because unlike the forward nothing rescales them.  Scores, dP, P and
// dS live in shared memory one 64x64 tile at a time and never reach
// device memory.  Rows past S load as zeros and are masked (no padding
// copies); lse and delta are plain [BH, S] vectors.  f32 uses FMA on the
// CUDA cores, never TF32.
//
// dK/dV bf16 (flash_bwd_dkv_bf16_wgmma_kernel): warp-specialised wgmma
// and TMA, kv-major from the start, so nothing is transposed through
// shared memory.  A CTA owns 128 kv rows: two consumer warpgroups of 64
// kv rows each, with K and V resident in shared memory (one TMA load).
// The producer warpgroup streams Q and dO tiles (64 rows, 3-D tensor
// maps over [BH, S, D]) and the matching lse and delta rows through a
// two-stage ring of full/empty mbarriers.  Per q block each consumer
// computes S^T = K Q^T and dP^T = V dO^T by wgmma (operands K-major as
// stored), P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in
// registers, then dV += P^T dO and dK += dS^T (Q scale) with bf16 P^T
// and dS^T as register A operands and dO / Q through the transpose bit.
// dK and dV accumulate in registers for the whole loop; the causal loop
// starts at the q block holding the diagonal; no atomics.  Q rows past S
// arrive zero-filled (and lse rows as 0), which would give P = 1, so a
// block that crosses S masks q >= S explicitly.  bf16(Q scale) is exact
// at D = 64 (scale 2^-3): the kernel feeds Q's tile and multiplies dK by
// scale once; at D = 32 and 128 a producer warp pair writes the rounded
// scaled copy of each Q tile and fences it to the async proxy.  At
// D = 128 the grid has a z of 2: one CTA per kv block accumulates dV and
// another dK (S^T is computed by both), since dK, dV, S^T and dP^T
// together do not fit one thread's registers without spilling.
//
// The backward recomputes S the same way as flash_fwd.cu (the bf16
// product of unscaled Q and K, f32 accumulate, times scale in f32), but
// not in the same instruction order: the forward's wgmma and the dQ
// kernel's WMMA may sum a row's products in another order, so P can
// differ from the forward's at the f32 ulp level; chip_smoke.py holds the
// backward to its tolerances with the forward's lse.
//
// What bounds it: at the flagship training shape (BH 48, S 2048, D 64,
// causal) the two kernels do seven 2*D-FLOP products per causal pair,
// ~90 GFLOP, against ~89 MB of operand traffic, so the tensor cores set
// the least time.  The dQ kernel (WMMA, no TMA or pipelining yet) is
// bound in practice by its serial load -> sync -> compute steps and its
// shared-memory round trips; PERF.md holds the measured times.
//
// Interface: plain C launchers taking device pointers and the caller's
// stream, loaded with ctypes (kungfu_tpu_torch/ops/cuda/attention.py).
// q, k, v, dout, dq, dk, dv are contiguous [BH, S, D] with 16-byte aligned
// bases; lse and delta are contiguous f32 [BH, S].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // kv rows per tile
constexpr int NTHREADS = 128;   // four warps, 16 rows each
constexpr int KF_BAD_ARGS = -1;
constexpr int KF_BAD_REGS = -3;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

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

// Rows [r0, r0 + 64) of a contiguous [S, D] matrix into shared memory with
// leading dimension LD, 16 bytes per thread per step, each element
// multiplied by `scale` in f32 and rounded back to T (scale 1 copies);
// rows past S are zero.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int S, int tid,
                                          float scale = 1.f) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = D / EPV;
  for (int i = tid; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * EPV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c));
      if (scale != 1.f) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int j = 0; j < EPV; ++j) e[j] = from_f32<T>(to_f32(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal) {
  return qpos < S && kpos < S && (!causal || qpos >= kpos);
}

// ---------------------------------------------------------------- bf16 --

// Shared memory of the bf16 kernels.  Tiles keep the forward's padded
// leading dimensions (rows stay 32-byte aligned for WMMA, banks are
// staggered).  The f32 staging of the epilogue reuses the two score
// tiles, which are dead by then.
template <int D>
struct Bf16Layout {
  static constexpr int LDT = D + 8;   // bf16 [64, D] operand tiles
  static constexpr int LDS = BK + 4;  // f32 [64, 64] S and dP
  static constexpr int LDP = BK + 8;  // bf16 [64, 64] P and dS
  static constexpr int LDO = D + 4;   // f32 [64, D] staging
  static constexpr size_t TILE = round_up(size_t(64) * LDT * 2, 128);
  static constexpr size_t FTILE = round_up(size_t(64) * LDS * 4, 128);
  static constexpr size_t PTILE = round_up(size_t(64) * LDP * 2, 128);
  static_assert(size_t(64) * LDO * 4 <= 2 * FTILE, "staging overflows");
};

template <int D>
struct DqBf16Layout : Bf16Layout<D> {
  using B = Bf16Layout<D>;
  static constexpr size_t Q = 0;
  static constexpr size_t DO = Q + B::TILE;
  static constexpr size_t K = DO + B::TILE;
  static constexpr size_t V = K + B::TILE;
  static constexpr size_t S = V + B::TILE;
  static constexpr size_t DP = S + B::FTILE;
  static constexpr size_t DS = DP + B::FTILE;
  static constexpr size_t BYTES = DS + B::PTILE;
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using ARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

// S = Q K^T and dP = dO V^T for one warp's 16 q rows against a 64-row kv
// tile, stored to Ss / dPs (f32, leading dimension LDS).
template <int D>
__device__ __forceinline__ void scores_and_dp(const __nv_bfloat16* Qs,
                                              const __nv_bfloat16* dOs,
                                              const __nv_bfloat16* Ks,
                                              const __nv_bfloat16* Vs,
                                              float* Ss, float* dPs,
                                              int warp) {
  using B = Bf16Layout<D>;
  AccFrag sacc[BK / 16], pacc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fill_fragment(sacc[n], 0.f);
    wmma::fill_fragment(pacc[n], 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    ARow qa, da;
    wmma::load_matrix_sync(qa, Qs + warp * 16 * B::LDT + kk, B::LDT);
    wmma::load_matrix_sync(da, dOs + warp * 16 * B::LDT + kk, B::LDT);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      // K and V stored [kv, D] row-major are K^T and V^T column-major
      BCol kt, vt;
      wmma::load_matrix_sync(kt, Ks + n * 16 * B::LDT + kk, B::LDT);
      wmma::mma_sync(sacc[n], qa, kt, sacc[n]);
      wmma::load_matrix_sync(vt, Vs + n * 16 * B::LDT + kk, B::LDT);
      wmma::mma_sync(pacc[n], da, vt, pacc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(Ss + warp * 16 * B::LDS + n * 16, sacc[n], B::LDS,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dPs + warp * 16 * B::LDS + n * 16, pacc[n], B::LDS,
                            wmma::mem_row_major);
  }
}

// The dQ epilogue: one warp's accumulator fragments (16 rows x D) through
// f32 staging to rows [r0 + warp*16, +16) of a bf16 [S, D] output, each
// value times `mult`.
template <int D>
__device__ __forceinline__ void store_rows(const AccFrag* acc, float* stage,
                                           __nv_bfloat16* dst, int r0, int S,
                                           float mult, int warp, int lane) {
  using B = Bf16Layout<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage + warp * 16 * B::LDO + n * 16, acc[n], B::LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  if (r0 + row < S) {
    const float* src = stage + row * B::LDO + half * (D / 2);
    __nv_bfloat16* out = dst + (size_t)(r0 + row) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(src[c] * mult);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, float scale,
                         int causal) {
  using L = DqBf16Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::DO);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + L::DS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = warp * 16 + (lane >> 1);  // the row this lane pair owns
  const int half = lane & 1;
  const int qpos = q0 + row;
  const size_t ridx = (size_t)blockIdx.y * S + qpos;
  const float row_lse = qpos < S ? lse[ridx] : 0.f;
  const float row_delta = qpos < S ? delta[ridx] : 0.f;

  load_rows<__nv_bfloat16, D, L::LDT>(Qs, q + base, q0, S, tid);
  load_rows<__nv_bfloat16, D, L::LDT>(dOs, dout + base, q0, S, tid);

  AccFrag acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int n_kb = (S + BK - 1) / BK;
  const int kb_end = causal ? min(n_kb, (q0 + BQ - 1) / BK + 1) : n_kb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // all warps are done with the previous K/V tiles
    load_rows<__nv_bfloat16, D, L::LDT>(Ks, k + base, k0, S, tid);
    load_rows<__nv_bfloat16, D, L::LDT>(Vs, v + base, k0, S, tid);
    __syncthreads();

    scores_and_dp<D>(Qs, dOs, Ks, Vs, Ss, dPs, warp);
    __syncwarp();
    const float* srow = Ss + row * L::LDS + half * 32;
    const float* dprow = dPs + row * L::LDS + half * 32;
    __nv_bfloat16* dsrow = dSs + row * L::LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool ok = live(qpos, k0 + half * 32 + j, S, causal);
      const float p = ok ? expf(srow[j] * scale - row_lse) : 0.f;
      dsrow[j] = __float2bfloat16(ok ? p * (dprow[j] - row_delta) : 0.f);
    }
    __syncwarp();

    // dQ += dS K on this warp's rows (scale applied once, at the end)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      ARow dsa;
      wmma::load_matrix_sync(dsa, dSs + warp * 16 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        BRow kb_frag;
        wmma::load_matrix_sync(kb_frag, Ks + kk * 16 * L::LDT + n * 16, L::LDT);
        wmma::mma_sync(acc[n], dsa, kb_frag, acc[n]);
      }
    }
  }
  __syncthreads();  // the staging overlays every warp's score tiles
  store_rows<D>(acc, Ss, dq + base, q0, S, scale, warp, lane);
}

template <int D>
struct DkvCfg {
  static constexpr int BQ = 64;                  // q rows per streamed tile
  static constexpr int BKV = 128;                // kv rows per CTA
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 384;            // producer + 2 consumers
  // bf16(Q * scale) == Q * scale exactly when scale is a power of two
  static constexpr bool SCALE_EXACT = D == 64;
  // at D = 128 one CTA accumulates dV and another dK (grid z): both
  // 64-register accumulators and the S^T / dP^T tiles in one thread's
  // registers made ptxas spill inside the loop
  static constexpr bool SPLIT = D == 128;
  static constexpr int ENTRY_REGS = 168;         // 65536 / 384, multiple of 8
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      ENTRY_REGS + (ENTRY_REGS - PRODUCER_REGS) / 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int V_OFF = KV_BYTES;                       // K at 0
  static constexpr int Q_OFF = V_OFF + KV_BYTES;               // STAGES tiles
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;     // STAGES tiles
  static constexpr int QS_OFF = DO_OFF + STAGES * QT_BYTES;    // STAGES, if used
  static constexpr int ROW_OFF =
      QS_OFF + (SCALE_EXACT ? 0 : STAGES * QT_BYTES);          // lse, delta
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * BQ * 4;
  // kv_full, full[STAGES], qs_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(QT_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "alignment");

  // shared-memory addresses from the 1024-aligned base
  static __device__ uint32_t k_tile(uint32_t b) { return b; }
  static __device__ uint32_t v_tile(uint32_t b) { return b + V_OFF; }
  static __device__ uint32_t q_tile(uint32_t b, int s) {
    return b + Q_OFF + s * QT_BYTES;
  }
  static __device__ uint32_t do_tile(uint32_t b, int s) {
    return b + DO_OFF + s * QT_BYTES;
  }
  static __device__ uint32_t qs_tile(uint32_t b, int s) {
    return b + QS_OFF + s * QT_BYTES;
  }
  static __device__ uint32_t kv_full(uint32_t b) { return b + BAR_OFF; }
  static __device__ uint32_t full(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + s);
  }
  static __device__ uint32_t qs_full(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + STAGES + s);
  }
  static __device__ uint32_t empty(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + 2 * STAGES + s);
  }
};

// One consumer warpgroup of the dK/dV kernel: kv rows [kvw0, kvw0 + 64)
// against every streamed q tile; run<DO_DK, DO_DV> accumulates dK, dV or
// both in registers and stores them.
template <int D>
struct DkvConsumer {
  using C = DkvCfg<D>;
  static constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  uint32_t base;
  const float* lse_s;    // [ST][BQ] lse * log2(e)
  const float* delta_s;  // [ST][BQ]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int bh, kvw0, S;
  float scale;
  int causal, qb0, n_it;

  template <bool DO_DK, bool DO_DV>
  __device__ __forceinline__ void run() {
    using namespace hopper;
    const int w = (kvw0 / 64) % 2;  // this warpgroup's half of the K/V tiles
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int kv0 = kvw0 + 16 * (t / 32) + lane / 4;  // + 8 i
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    float dk_acc[DO_DK ? D / 2 : 1], dv_acc[DO_DV ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      if constexpr (DO_DK) dk_acc[i] = 0.f;
      if constexpr (DO_DV) dv_acc[i] = 0.f;
    }
    mbar_wait(C::kv_full(base), 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      const uint32_t ph = (it / ST) & 1;
      const int q0 = (qb0 + it) * BQ;
      mbar_wait(C::full(base, s), ph);
      if (causal && q0 + BQ - 1 < kvw0) {  // every q < kv: P = 0
        mbar_arrive(C::empty(base, s));
        continue;
      }
      // S^T = K Q^T (and dP^T = V dO^T for dK), K-major operands as stored
      float sacc[BQ / 2], dpacc[DO_DK ? BQ / 2 : 1];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        Wgmma<BQ>::template ss<0>(
            sacc, desc_kmajor<D>(C::k_tile(base), BKV, 64 * w, ks),
            desc_kmajor<D>(C::q_tile(base, s), BQ, 0, ks), ks > 0);
      }
      // then dP^T: each accumulator's k-slices back to back
      if constexpr (DO_DK) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          Wgmma<BQ>::template ss<0>(
              dpacc, desc_kmajor<D>(C::v_tile(base), BKV, 64 * w, ks),
              desc_kmajor<D>(C::do_tile(base, s), BQ, 0, ks), ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if constexpr (DO_DK) fence_regs(dpacc);

      // P^T and dS^T: rows kv0 + 8 i, columns q0 + 8 j + cq + c
      const bool need_mask = q0 + BQ > S || (causal && q0 < kvw0 + 63);
      const float* ls = lse_s + s * BQ;
      const float* ds = delta_s + s * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + cq + c;
          const float l2 = ls[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * j + 2 * i + c;
            float p = exp2f(sacc[idx] * scale_log2 - l2);
            if (need_mask) {
              const int q = q0 + col;
              if (q >= S || (causal && q < kv0 + 8 * i)) p = 0.f;
            }
            sacc[idx] = p;
            if constexpr (DO_DK) dpacc[idx] = p * (dpacc[idx] - ds[col]);
          }
        }
      }
      // dV += P^T dO and dK += dS^T (Q scale): bf16 register A operands,
      // dO and Q MN-major through the transpose bit
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kt][r] = pack_bf16(sacc[8 * kt + 2 * r], sacc[8 * kt + 2 * r + 1]);
          if constexpr (DO_DK) {
            dsa[kt][r] =
                pack_bf16(dpacc[8 * kt + 2 * r], dpacc[8 * kt + 2 * r + 1]);
          }
        }
      }
      if constexpr (DO_DK && !C::SCALE_EXACT) mbar_wait(C::qs_full(base, s), ph);
      const uint32_t qb_tile =
          C::SCALE_EXACT ? C::q_tile(base, s) : C::qs_tile(base, s);
      fence_frags(pa);
      if constexpr (DO_DK) fence_frags(dsa);
      if constexpr (DO_DV) fence_regs(dv_acc);
      if constexpr (DO_DK) fence_regs(dk_acc);
      wgmma_fence();
      if constexpr (DO_DV) {
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks) {
          Wgmma<D>::template rs<1>(dv_acc, pa[ks],
                                   desc_mnmajor<D>(C::do_tile(base, s), BQ, ks),
                                   1);
        }
      }
      if constexpr (DO_DK) {
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks) {
          Wgmma<D>::template rs<1>(dk_acc, dsa[ks],
                                   desc_mnmajor<D>(qb_tile, BQ, ks), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (DO_DV) fence_regs(dv_acc);
      if constexpr (DO_DK) fence_regs(dk_acc);
      mbar_arrive(C::empty(base, s));
    }

    // epilogue: dK (times scale when Q went in unscaled) and dV in bf16
    const float mult = C::SCALE_EXACT ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kv = kv0 + 8 * i;
      if (kv < S) {
        const size_t off = ((size_t)bh * S + kv) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if constexpr (DO_DK) {
            *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
                pack_bf16(dk_acc[4 * j + 2 * i] * mult,
                          dk_acc[4 * j + 2 * i + 1] * mult);
          }
          if constexpr (DO_DV) {
            *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
                pack_bf16(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
          }
        }
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int S,
                                float scale, int causal) {
  using C = DkvCfg<D>;
  using G = hopper::TileGeom<D>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* lse_s = reinterpret_cast<float*>(gbase + C::ROW_OFF);  // [ST][BQ]
  float* delta_s = lse_s + ST * BQ;                              // [ST][BQ]
  const uint32_t kv_full = C::kv_full(base);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKV;  // low kv blocks see the most q blocks
  const int n_qb = (S + BQ - 1) / BQ;
  const int qb0 = causal ? k0 / BQ : 0;
  const int n_it = n_qb - qb0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      // full: the TMA thread and the lse/delta warp; qs_full: the
      // scaling warp pair; empty: every consumer thread
      mbar_init(C::full(base, s), 1 + 32);
      mbar_init(C::qs_full(base, s), 64);
      mbar_init(C::empty(base, s), 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer --
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int pw = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      prefetch_map(&q_map);
      prefetch_map(&do_map);
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int b = 0; b < G::N_BOX; ++b) {
        tma_load_3d(C::k_tile(base) + b * BKV * G::ROW_BYTES, &k_map, kv_full,
                    b * G::BOX_COLS, k0, bh);
        tma_load_3d(C::v_tile(base) + b * BKV * G::ROW_BYTES, &v_map, kv_full,
                    b * G::BOX_COLS, k0, bh);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, q0 = (qb0 + it) * BQ;
        mbar_wait(C::empty(base, s), ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(C::full(base, s), 2 * C::QT_BYTES);
        for (int b = 0; b < G::N_BOX; ++b) {
          tma_load_3d(C::q_tile(base, s) + b * BQ * G::ROW_BYTES, &q_map,
                      C::full(base, s), b * G::BOX_COLS, q0, bh);
          tma_load_3d(C::do_tile(base, s) + b * BQ * G::ROW_BYTES, &do_map,
                      C::full(base, s), b * G::BOX_COLS, q0, bh);
        }
      }
    } else if (pw == 1) {
      // lse (times log2 e, for exp2) and delta rows of each q tile
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, q0 = (qb0 + it) * BQ;
        mbar_wait(C::empty(base, s), ((it / ST) & 1) ^ 1);
        for (int r = lane; r < BQ; r += 32) {
          const int q = q0 + r;
          const size_t idx = (size_t)bh * S + q;
          lse_s[s * BQ + r] = q < S ? lse[idx] * LOG2E : 0.f;
          delta_s[s * BQ + r] = q < S ? delta[idx] : 0.f;
        }
        mbar_arrive(C::full(base, s));
      }
    } else if (pw >= 2 && !C::SCALE_EXACT &&
               !(C::SPLIT && blockIdx.z == 0)) {
      // warps 2-3: bf16(Q * scale), element by element in the swizzled
      // layout TMA wrote, then fenced to the async proxy for wgmma.  Only
      // where a consumer waits for it: the dV-only CTAs of a split grid
      // never do, so there these warps would be lapped by the full
      // barrier's phases and wait for one that never comes.
      const int tid = threadIdx.x - 64;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        mbar_wait(C::full(base, s), (it / ST) & 1);
        const uint4* src = reinterpret_cast<const uint4*>(
            gbase + C::Q_OFF + s * C::QT_BYTES);
        uint4* dst =
            reinterpret_cast<uint4*>(gbase + C::QS_OFF + s * C::QT_BYTES);
        for (int c = tid; c < C::QT_BYTES / 16; c += 64) {
          uint4 val = src[c];
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
          }
          dst[c] = val;
        }
        fence_proxy_async();
        mbar_arrive(C::qs_full(base, s));
      }
    }
  } else {
    // ------------------------------------------------------ consumer --
    setmaxnreg_inc<C::CONSUMER_REGS>();
    DkvConsumer<D> c{base, lse_s, delta_s, dk, dv, bh, k0 + 64 * (wg - 1), S,
                     scale, causal, qb0, n_it};
    if constexpr (!C::SPLIT) {
      c.template run<true, true>();
    } else if (blockIdx.z == 0) {
      c.template run<false, true>();
    } else {
      c.template run<true, false>();
    }
  }
}

// ----------------------------------------------------------------- f32 --

template <int D>
struct F32Layout {
  static constexpr int LDT = D + 4;   // f32 [64, D] operand tiles
  static constexpr int LDP = BK + 4;  // f32 [64, 64] P and dS
  static constexpr size_t TILE = round_up(size_t(64) * LDT * 4, 128);
  static constexpr size_t PTILE = round_up(size_t(64) * LDP * 4, 128);
  static constexpr size_t Q = 0;      // Q * scale, as the forward keeps it
  static constexpr size_t DO = Q + TILE;
  static constexpr size_t K = DO + TILE;
  static constexpr size_t V = K + TILE;
  static constexpr size_t P = V + TILE;
  static constexpr size_t DS = P + PTILE;
  static constexpr size_t BYTES = DS + PTILE;
};

__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int n) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// P and dS of one lane pair's q row against a 64-row kv tile: S is the
// forward's sequential FMA dot of the pre-scaled Q row with each K row.
template <int D>
__device__ __forceinline__ void f32_p_ds(const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         float* prow, float* dsrow, int row,
                                         int half, int qpos, int k0, int S,
                                         int causal, float row_lse,
                                         float row_delta) {
  using L = F32Layout<D>;
  const float* qrow = Qs + row * L::LDT;
  const float* drow = dOs + row * L::LDT;
  for (int j = 0; j < 32; ++j) {
    const int col = half * 32 + j;
    float p = 0.f, ds = 0.f;
    if (live(qpos, k0 + col, S, causal)) {
      p = expf(dot_rows(qrow, Ks + col * L::LDT, D) - row_lse);
      ds = p * (dot_rows(drow, Vs + col * L::LDT, D) - row_delta);
    }
    if (prow != nullptr) prow[col] = p;
    dsrow[col] = ds;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, float scale,
                        int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* dOs = reinterpret_cast<float*>(smem + L::DO);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* dSs = reinterpret_cast<float*>(smem + L::DS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q0 + row;
  const size_t ridx = (size_t)blockIdx.y * S + qpos;
  const float row_lse = qpos < S ? lse[ridx] : 0.f;
  const float row_delta = qpos < S ? delta[ridx] : 0.f;

  load_rows<float, D, L::LDT>(Qs, q + base, q0, S, tid, scale);
  load_rows<float, D, L::LDT>(dOs, dout + base, q0, S, tid);

  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  const int n_kb = (S + BK - 1) / BK;
  const int kb_end = causal ? min(n_kb, (q0 + BQ - 1) / BK + 1) : n_kb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_rows<float, D, L::LDT>(Ks, k + base, k0, S, tid);
    load_rows<float, D, L::LDT>(Vs, v + base, k0, S, tid);
    __syncthreads();

    float* dsrow = dSs + row * L::LDP;
    f32_p_ds<D>(Qs, dOs, Ks, Vs, nullptr, dsrow, row, half, qpos, k0, S,
                causal, row_lse, row_delta);
    __syncwarp();  // the lane pair shares the row
    for (int j = 0; j < BK; ++j) {
      const float ds = dsrow[j];
      const float* krow = Ks + j * L::LDT + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] = fmaf(ds, krow[c], acc[c]);
    }
    __syncwarp();
  }

  if (qpos < S) {
    float* dst = dq + base + (size_t)qpos * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dst[c] = acc[c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int S, float scale, int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* dOs = reinterpret_cast<float*>(smem + L::DO);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* dSs = reinterpret_cast<float*>(smem + L::DS);

  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = (tid >> 5) * 16 + (lane >> 1);
  const int half = lane & 1;

  load_rows<float, D, L::LDT>(Ks, k + base, k0, S, tid);
  load_rows<float, D, L::LDT>(Vs, v + base, k0, S, tid);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int n_qb = (S + BQ - 1) / BQ;
  for (int qb = causal ? k0 / BQ : 0; qb < n_qb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_rows<float, D, L::LDT>(Qs, q + base, q0, S, tid, scale);
    load_rows<float, D, L::LDT>(dOs, dout + base, q0, S, tid);
    __syncthreads();

    // P and dS of q row `row`
    const int qpos = q0 + row;
    const float row_lse = qpos < S ? lse[rbase + qpos] : 0.f;
    const float row_delta = qpos < S ? delta[rbase + qpos] : 0.f;
    f32_p_ds<D>(Qs, dOs, Ks, Vs, Ps + row * L::LDP, dSs + row * L::LDP, row,
                half, qpos, k0, S, causal, row_lse, row_delta);
    __syncthreads();

    // dV and dK of kv row `row`: sums over the 64 q rows of the tile
    for (int i = 0; i < BQ; ++i) {
      const float p = Ps[i * L::LDP + row];
      const float ds = dSs[i * L::LDP + row];
      const float* drow = dOs + i * L::LDT + half * (D / 2);
      const float* qrow = Qs + i * L::LDT + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) {
        dv_acc[c] = fmaf(p, drow[c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, qrow[c], dk_acc[c]);
      }
    }
  }

  if (k0 + row < S) {
    const size_t off = base + (size_t)(k0 + row) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      dk[off + c] = dk_acc[c];
      dv[off + c] = dv_acc[c];
    }
  }
}

// ------------------------------------------------------------- launch --

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq(int is_bf16, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, int bh, int S, float scale, int causal,
              cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, bh);
  int err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto kernel = flash_bwd_dq_bf16_kernel<D>;
    constexpr size_t smem = DqBf16Layout<D>::BYTES;
    if ((err = prepare(kernel, smem)) != 0) return err;
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), S, scale, causal);
  } else {
    auto kernel = flash_bwd_dq_f32_kernel<D>;
    constexpr size_t smem = F32Layout<D>::BYTES;
    if ((err = prepare(kernel, smem)) != 0) return err;
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), S, scale, causal);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int bh, int S, float scale, int causal,
                    cudaStream_t stream) {
  using C = DkvCfg<D>;
  auto kernel = flash_bwd_dkv_bf16_wgmma_kernel<D>;
  // first call: the shared-memory limit, and the entry register count
  // setmaxnreg's budget assumes (a mismatch would hang setmaxnreg.inc)
  static int ready = 0;
  if (ready == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != C::ENTRY_REGS) return KF_BAD_REGS;
    if ((err = (cudaError_t)prepare(kernel, C::BYTES)) != cudaSuccess) {
      return (int)err;
    }
    ready = 1;
  }
  CUtensorMap qm, km, vm, dom;
  int err = hopper::encode_rows_map<D>(&qm, q, bh, S, C::BQ);
  if (err == 0) err = hopper::encode_rows_map<D>(&km, k, bh, S, C::BKV);
  if (err == 0) err = hopper::encode_rows_map<D>(&vm, v, bh, S, C::BKV);
  if (err == 0) err = hopper::encode_rows_map<D>(&dom, dout, bh, S, C::BQ);
  if (err != 0) return err;
  const dim3 grid((S + C::BKV - 1) / C::BKV, bh, C::SPLIT ? 2 : 1);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(int is_bf16, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int bh, int S, float scale, int causal,
               cudaStream_t stream) {
  if (is_bf16) {
    return launch_dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, bh, S, scale,
                              causal, stream);
  }
  const dim3 grid((S + BK - 1) / BK, bh);
  auto kernel = flash_bwd_dkv_f32_kernel<D>;
  constexpr size_t smem = F32Layout<D>::BYTES;
  int err;
  if ((err = prepare(kernel, smem)) != 0) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns 0 on success, a cudaError_t code, or -1 for arguments the
// kernels do not take (the Python wrapper checks them first).
extern "C" int kf_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int seq,
                               int head_dim, int causal, int is_bf16,
                               float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0) return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (head_dim) {
    case 32:
      return launch_dq<32>(is_bf16, q, k, v, dout, l, dl, dq, bh, seq, scale, causal, st);
    case 64:
      return launch_dq<64>(is_bf16, q, k, v, dout, l, dl, dq, bh, seq, scale, causal, st);
    case 128:
      return launch_dq<128>(is_bf16, q, k, v, dout, l, dl, dq, bh, seq, scale, causal, st);
    default:
      return KF_BAD_ARGS;
  }
}

extern "C" int kf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int seq, int head_dim, int causal, int is_bf16,
                                float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0) return KF_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (head_dim) {
    case 32:
      return launch_dkv<32>(is_bf16, q, k, v, dout, l, dl, dk, dv, bh, seq, scale, causal, st);
    case 64:
      return launch_dkv<64>(is_bf16, q, k, v, dout, l, dl, dk, dv, bh, seq, scale, causal, st);
    case 128:
      return launch_dkv<128>(is_bf16, q, k, v, dout, l, dl, dk, dv, bh, seq, scale, causal, st);
    default:
      return KF_BAD_ARGS;
  }
}

extern "C" const char* kf_error_string(int code) {
  if (code == KF_BAD_ARGS) return "unsupported arguments";
  if (code == hopper::KF_TMA_ENCODE_FAILED) {
    return "cuTensorMapEncodeTiled failed";
  }
  if (code == KF_BAD_REGS) {
    return "kernel's entry register count differs from its setmaxnreg budget";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
