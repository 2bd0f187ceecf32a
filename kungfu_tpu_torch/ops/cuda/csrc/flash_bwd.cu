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
// * dQ: one CTA per (bh, q block) loops over the kv blocks up to the
//   causal edge, accumulating dQ; q blocks run heaviest first.
// * dK/dV: one CTA per (bh, kv block) loops over the q blocks from the
//   causal edge on, accumulating dK and dV.
//
// P uses the lse that the port's forward wrote: bf16 takes the product of
// unscaled Q and K (f32 accumulate), then x scale in f32; f32 takes Q
// pre-scaled by scale and a sequential FMA dot, as the forward's f32
// kernel does.  The reference's rounding points are kept:
// dO and V are bf16 into dO V^T, dS is rounded to K's dtype before dS K,
// P to dO's dtype before P^T dO, dS and Q*scale to Q's dtype before
// dS^T (Q*scale); every product accumulates in f32.
//
// f32 (dQ and dK/dV): four warps per CTA, 64-row tiles, each warp owning
// 16 rows of the product it accumulates in registers across the whole
// loop; P and dS pass through shared memory one 64x64 tile at a time and
// never reach device memory.  Rows past S load as zeros and are masked
// (no padding copies); lse and delta are plain [BH, S] vectors.  FMA on
// the CUDA cores, never TF32.
//
// dQ bf16 (flash_bwd_dq_bf16_wgmma_kernel): warp-specialised wgmma and
// TMA, q-major.  A CTA owns 128 q rows: two consumer warpgroups of 64
// rows, with Q and dO resident in shared memory (one TMA load) and each
// thread's lse (times log2 e) and delta rows in registers.  The producer
// warpgroup streams K and V tiles of 64 rows through a two-stage ring of
// full/empty mbarriers, K and V on separate full barriers so that
// S = Q K^T starts before V lands.  Per kv tile each consumer issues
// S = Q K^T and dP = dO V^T by wgmma (operands K-major as stored), forms
// P = exp2(S scale log2 e - lse log2 e) in registers while dP is still in
// flight, then dS = P (dP - delta), rounds it to bf16 in the accumulator
// layout and feeds it as the register A operand of dQ += dS K, with K
// (stored [kv, D]) MN-major through the transpose bit.  No score, P or
// dS tile touches shared memory; dQ (16-64 f32 registers) stays in
// registers for the whole loop and is scaled once in the epilogue.  Masks
// run only on a tile that crosses the diagonal or S; there kv >= S (K
// zero-filled) and q >= S (lse read as 0) are masked explicitly.
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
// not in the same instruction order: the forward's and the backward's
// wgmma chains may sum a row's products in another order, so P can
// differ from the forward's at the f32 ulp level; chip_smoke.py holds the
// backward to its tolerances with the forward's lse.
//
// What bounds it: at the flagship training shape (BH 48, S 2048, D 64,
// causal) the two kernels do seven 2*D-FLOP products per causal pair,
// ~90 GFLOP, against ~89 MB of operand traffic, so the tensor cores set
// the least time.  PERF.md holds the measured times.
//
// Interface: plain C launchers taking device pointers and the caller's
// stream, loaded with ctypes (kungfu_tpu_torch/ops/cuda/attention.py).
// q, k, v, dout, dq, dk, dv are contiguous [BH, S, D] with 16-byte aligned
// bases; lse and delta are contiguous f32 [BH, S].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Rows [r0, r0 + 64) of a contiguous f32 [S, D] matrix into shared memory
// with leading dimension LD, 16 bytes per thread per step, each element
// multiplied by `scale` (scale 1 copies); rows past S are zero.
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
        for (int j = 0; j < EPV; ++j) e[j] *= scale;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal) {
  return qpos < S && kpos < S && (!causal || qpos >= kpos);
}

// ---------------------------------------------------------------- bf16 --

template <int D>
struct DqCfg {
  static constexpr int BQ = 128;                 // q rows per CTA
  // kv rows per streamed tile: at D = 128 the S and dP accumulators are
  // halved, since with 64-row tiles they, dQ and the dS fragments made
  // ptxas spill
  static constexpr int BK = D == 128 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 384;            // producer + 2 consumers
  static constexpr int ENTRY_REGS = 168;         // 65536 / 384, multiple of 8
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      ENTRY_REGS + (ENTRY_REGS - PRODUCER_REGS) / 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int DO_OFF = Q_BYTES;                     // Q at 0
  static constexpr int K_OFF = DO_OFF + Q_BYTES;             // STAGES tiles
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;    // STAGES tiles
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(KV_BYTES % 1024 == 0, "alignment");

  // shared-memory addresses from the 1024-aligned base
  static __device__ uint32_t q_tile(uint32_t b) { return b; }
  static __device__ uint32_t do_tile(uint32_t b) { return b + DO_OFF; }
  static __device__ uint32_t k_tile(uint32_t b, int s) {
    return b + K_OFF + s * KV_BYTES;
  }
  static __device__ uint32_t v_tile(uint32_t b, int s) {
    return b + V_OFF + s * KV_BYTES;
  }
  static __device__ uint32_t q_full(uint32_t b) { return b + BAR_OFF; }
  static __device__ uint32_t k_full(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + s);
  }
  static __device__ uint32_t v_full(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + STAGES + s);
  }
  static __device__ uint32_t empty(uint32_t b, int s) {
    return b + BAR_OFF + 8u * (1 + 2 * STAGES + s);
  }
};

// P = exp2(S scale log2 e - lse log2 e) in place of S: rows qpos0 + 8 i,
// columns k0 + 8 j + cq + c.  MASK (a tile that crosses S or the
// diagonal) zeroes kv >= S (K zero-filled), q >= S (lse read as 0) and,
// causal, kv > q; a template argument, as in dkv_probs.
template <bool MASK, int BK>
__device__ __forceinline__ void dq_probs(float (&sacc)[BK / 2],
                                         const float (&lse2)[2], int qpos0,
                                         int k0, int cq, int S, int causal,
                                         float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int idx = 4 * j + 2 * i + c;
        float p = exp2f(sacc[idx] * scale_log2 - lse2[i]);
        if (MASK) {
          const int kv = k0 + 8 * j + cq + c, q = qpos0 + 8 * i;
          if (kv >= S || q >= S || (causal && kv > q)) p = 0.f;
        }
        sacc[idx] = p;
      }
    }
  }
}

// dQ: one CTA per (bh, 128-row q block), heaviest first.  Q and dO stay
// resident; K and V tiles stream through the producer's ring.  Each
// consumer warpgroup owns 64 q rows and keeps their lse (times log2 e)
// and delta in registers.  A tile's dQ product is waited for only after
// the next tile's S and dP are issued, and its stage is released then.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dq, int S,
                               float scale, int causal) {
  using C = DqCfg<D>;
  using G = hopper::TileGeom<D>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BKV = C::BK, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int n_all = (S + BKV - 1) / BKV;
  const int n_kb = causal ? min(n_all, (q0 + BQ - 1) / BKV + 1) : n_all;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(C::q_full(base), 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(C::k_full(base, s), 1);
      mbar_init(C::v_full(base, s), 1);
      mbar_init(C::empty(base, s), 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer --
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      mbar_arrive_expect_tx(C::q_full(base), 2 * C::Q_BYTES);
      for (int b = 0; b < G::N_BOX; ++b) {
        tma_load_3d(C::q_tile(base) + b * BQ * G::ROW_BYTES, &q_map,
                    C::q_full(base), b * G::BOX_COLS, q0, bh);
        tma_load_3d(C::do_tile(base) + b * BQ * G::ROW_BYTES, &do_map,
                    C::q_full(base), b * G::BOX_COLS, q0, bh);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % ST;
        mbar_wait(C::empty(base, s), ((kb / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(C::k_full(base, s), C::KV_BYTES);
        for (int b = 0; b < G::N_BOX; ++b) {
          tma_load_3d(C::k_tile(base, s) + b * BKV * G::ROW_BYTES, &k_map,
                      C::k_full(base, s), b * G::BOX_COLS, kb * BKV, bh);
        }
        mbar_arrive_expect_tx(C::v_full(base, s), C::KV_BYTES);
        for (int b = 0; b < G::N_BOX; ++b) {
          tma_load_3d(C::v_tile(base, s) + b * BKV * G::ROW_BYTES, &v_map,
                      C::v_full(base, s), b * G::BOX_COLS, kb * BKV, bh);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumer --
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int w = wg - 1;  // q rows [64 w, 64 w + 64) of the block
  const int qw0 = q0 + 64 * w;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int qpos0 = qw0 + 16 * (t / 32) + lane / 4;  // + 8 i
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = qpos0 + 8 * i;
    const size_t idx = (size_t)bh * S + q;
    lse2[i] = q < S ? lse[idx] * LOG2E : 0.f;
    dlt[i] = q < S ? delta[idx] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  // this warpgroup's kv tiles end at its own diagonal; the block's tiles
  // past it are only released
  const int n_kb_w = causal ? min(n_all, (qw0 + 63) / BKV + 1) : n_all;
  mbar_wait(C::q_full(base), 0);

  for (int kb = 0; kb < n_kb_w; ++kb) {
    const int s = kb % ST;
    const uint32_t ph = (kb / ST) & 1;
    const int k0 = kb * BKV;
    // S = Q K^T, then dP = dO V^T (V may land later): K-major operands
    float sacc[BKV / 2], dpacc[BKV / 2];
    mbar_wait(C::k_full(base, s), ph);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      Wgmma<BKV>::template ss<0>(
          sacc, desc_kmajor<D>(C::q_tile(base), BQ, 64 * w, ks),
          desc_kmajor<D>(C::k_tile(base, s), BKV, 0, ks), ks > 0);
    }
    wgmma_commit();
    mbar_wait(C::v_full(base, s), ph);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      Wgmma<BKV>::template ss<0>(
          dpacc, desc_kmajor<D>(C::do_tile(base), BQ, 64 * w, ks),
          desc_kmajor<D>(C::v_tile(base, s), BKV, 0, ks), ks > 0);
    }
    wgmma_commit();

    // the groups complete in order: the previous tile's dQ product and
    // this S are done, dP may still be in flight
    wgmma_wait<1>();
    fence_regs(sacc);
    if (kb > 0) mbar_arrive(C::empty(base, (kb - 1) % ST));
    if (k0 + BKV > S || qw0 + 64 > S || (causal && k0 + BKV - 1 > qw0)) {
      dq_probs<true, BKV>(sacc, lse2, qpos0, k0, cq, S, causal, scale_log2);
    } else {
      dq_probs<false, BKV>(sacc, lse2, qpos0, k0, cq, S, causal, scale_log2);
    }
    wgmma_wait<0>();
    fence_regs(dpacc);
    // dS = P (dP - delta), rounded to bf16 as the register A operand of
    // dQ += dS K; K (stored [kv, D]) is MN-major through the transpose bit
    uint32_t dsa[BKV / 16][4];
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = 8 * kt + 2 * r;
        const float d = dlt[r % 2];
        dsa[kt][r] = pack_bf16(sacc[idx] * (dpacc[idx] - d),
                               sacc[idx + 1] * (dpacc[idx + 1] - d));
      }
    }
    fence_frags(dsa);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      Wgmma<D>::template rs<1>(dq_acc, dsa[ks],
                               desc_mnmajor<D>(C::k_tile(base, s), BKV, ks), 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dq_acc);
  if (n_kb_w > 0) mbar_arrive(C::empty(base, (n_kb_w - 1) % ST));
  // a stage may be released only once its tile has landed: an early
  // arrival would count towards the phase of the tile before
  for (int kb = n_kb_w; kb < n_kb; ++kb) {
    const int s = kb % ST;
    const uint32_t ph = (kb / ST) & 1;
    mbar_wait(C::k_full(base, s), ph);
    mbar_wait(C::v_full(base, s), ph);
    mbar_arrive(C::empty(base, s));
  }

  // epilogue: dQ times scale, in bf16, from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = qpos0 + 8 * i;
    if (q < S) {
      __nv_bfloat16* dst = dq + ((size_t)bh * S + q) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(
            dq_acc[4 * j + 2 * i] * scale, dq_acc[4 * j + 2 * i + 1] * scale);
      }
    }
  }
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

// P^T = exp2(S^T scale log2 e - lse log2 e) in place of S^T and, for dK,
// dS^T = P^T (dP^T - delta) in place of dP^T: rows kv0 + 8 i, columns
// q0 + 8 j + cq + c.  MASK (a tile that crosses S or the diagonal) zeroes
// q >= S and, causal, q < kv.  The mask is a template argument, so no
// element carries a branch: tested per element, the compiler wrapped each
// of them in a divergent branch with its own convergence barrier.
template <bool MASK, bool DO_DK, int BQ, int NDP>
__device__ __forceinline__ void dkv_probs(float (&sacc)[BQ / 2],
                                          float (&dpacc)[NDP], const float* ls,
                                          const float* ds, int q0, int kv0,
                                          int cq, int S, int causal,
                                          float scale_log2) {
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
        if (MASK) {
          const int q = q0 + col;
          if (q >= S || (causal && q < kv0 + 8 * i)) p = 0.f;
        }
        sacc[idx] = p;
        if constexpr (DO_DK) dpacc[idx] = p * (dpacc[idx] - ds[col]);
      }
    }
  }
}

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

      const float* ls = lse_s + s * BQ;
      const float* ds = delta_s + s * BQ;
      if (q0 + BQ > S || (causal && q0 < kvw0 + 63)) {
        dkv_probs<true, DO_DK, BQ>(sacc, dpacc, ls, ds, q0, kv0, cq, S, causal,
                                   scale_log2);
      } else {
        dkv_probs<false, DO_DK, BQ>(sacc, dpacc, ls, ds, q0, kv0, cq, S,
                                    causal, scale_log2);
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

// Encodes the maps and launches; the first call of each instantiation
// checks the entry register count setmaxnreg's budget assumes (a mismatch
// would hang setmaxnreg.inc) and raises its shared-memory limit.
template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int S, float scale, int causal,
                   cudaStream_t stream) {
  using C = DqCfg<D>;
  auto kernel = flash_bwd_dq_bf16_wgmma_kernel<D>;
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
  if (err == 0) err = hopper::encode_rows_map<D>(&km, k, bh, S, C::BK);
  if (err == 0) err = hopper::encode_rows_map<D>(&vm, v, bh, S, C::BK);
  if (err == 0) err = hopper::encode_rows_map<D>(&dom, dout, bh, S, C::BQ);
  if (err != 0) return err;
  const dim3 grid((S + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), S, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(int is_bf16, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, int bh, int S, float scale, int causal,
              cudaStream_t stream) {
  if (is_bf16) {
    return launch_dq_bf16<D>(q, k, v, dout, lse, delta, dq, bh, S, scale,
                             causal, stream);
  }
  const dim3 grid((S + BQ - 1) / BQ, bh);
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  constexpr size_t smem = F32Layout<D>::BYTES;
  int err;
  if ((err = prepare(kernel, smem)) != 0) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), S, scale, causal);
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
