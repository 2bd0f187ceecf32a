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
// The TPU carried m/l/acc across a sequential grid axis; here the kv walk
// is a loop inside the CTA, and CTAs run in any order, heaviest first.
//
// bf16: warp-specialised wgmma/TMA kernel (flash_fwd_bf16_wgmma_kernel).
// * One producer warpgroup and two consumer warpgroups of 64 q rows each
//   (128-row q blocks, one CTA per SM).  After setmaxnreg.dec, one
//   producer thread TMA-loads the Q tile once and streams K and V tiles
//   (128 rows; 64 at D = 128) through a
//   two-stage ring in shared memory (full/empty mbarriers per stage, K and
//   V on separate full barriers so Q K^T starts before V lands).  The
//   tensor maps are 3-D over [BH, S, D], so a tile that runs past S is
//   zero-filled by the TMA unit instead of reading the next head.
// * The consumers take the registers the producer gave up.  S = Q K^T is
//   one wgmma chain (both operands K-major in shared memory) into f32
//   registers; the online softmax runs in registers (quad shuffles for
//   the row max, per-thread partial row sums reduced once at the end);
//   O is rescaled in registers; P is packed to bf16 in registers and is
//   the register A operand of the P V wgmma, with V (stored [kv, D],
//   MN-major) through the transpose bit.  Nothing of S, P or O passes
//   through shared memory; O/l and lse are stored from registers.
// * Masks are evaluated only on a block that crosses the diagonal or S.
// Rounding points (the plain version's): S is the f32-accumulated bf16
// product of unscaled Q and K, times scale in f32 (log2(e) folded into
// the scale for exp2; lse is written in natural log); l sums the
// unrounded f32 P; P is rounded to bf16 before P V.
//
// f32: plain FMA on the CUDA cores, never TF32, so f32 parity checks hold
// the algorithm to f32 rounding; 64x64 tiles, one CTA of four warps per
// (bh, 64-row q block), Q pre-scaled by 1/sqrt(D) as the reference does.
//
// What bounds it: at the training shape [48, 2048, 64] causal the forward
// needs 26 us of bf16 tensor-core work (4 D FLOPs per causal pair)
// against 8 us of q/k/v/o traffic, so the tensor cores set the least
// time.  PERF.md holds the measured times.
//
// Interface: a plain C launcher taking device pointers and the caller's
// stream, loaded with ctypes (kungfu_tpu_torch/ops/cuda/attention.py).
// q, k, v, o are contiguous [BH, S, D] with 16-byte aligned bases; the
// launcher encodes the tensor maps on each call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // f32: q rows per CTA
constexpr int BK = 64;          // f32: kv rows per tile
constexpr int NTHREADS = 128;   // f32: four warps, 16 q rows each
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int KF_BAD_ARGS = -1;
constexpr int KF_BAD_REGS = -3;

__host__ __device__ constexpr size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// ---------------------------------------------------------------- bf16 --

constexpr int STAGES = 2;

template <int D>
struct FwdCfg {
  static constexpr int NWG = 2;          // consumer warpgroups
  static constexpr int BQ = 64 * NWG;    // q rows per CTA
  // kv rows per tile: at D = 128 the S accumulator is halved so that S,
  // O and P fit the consumers' registers without spilling
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int THREADS = 128 * (NWG + 1);
  // registers at entry (ptxas allots the launch bounds' maximum to a
  // kernel with setmaxnreg); the producer drops to PRODUCER_REGS and the
  // consumers split what it frees
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      ENTRY_REGS + (ENTRY_REGS - PRODUCER_REGS) / NWG;
  static_assert(CONSUMER_REGS % 8 == 0 && CONSUMER_REGS <= 256, "registers");
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;                    // STAGES tiles
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;  // STAGES tiles
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
};

// One block of the online softmax for the two rows this thread holds:
// s holds the raw scores Q K^T of kv columns [k0, k0 + BK) in the
// accumulator layout and leaves as P (unrounded f32); m, l and O are
// updated (l is this thread's partial row sum); P packed to bf16 lands
// in p as the A fragments of the P V product.
template <bool MASK, int BK, int D>
__device__ __forceinline__ void softmax_block(float (&s)[BK / 2], float (&m)[2],
                                              float (&l)[2], float (&o)[D / 2],
                                              uint32_t (&p)[BK / 16][4],
                                              int qpos0, int k0, int cq, int S,
                                              int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qpos0 + 8 * i;
    float mx = MASK_VALUE;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = s[4 * j + 2 * i + c] * scale_log2;
        if (MASK) {
          const int kpos = k0 + 8 * j + cq + c;
          if (kpos >= S || (causal && kpos > qpos)) v = MASK_VALUE;
        }
        s[4 * j + 2 * i + c] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float corr = exp2f(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v = s[4 * j + 2 * i + c];
        // masked entries contribute 0, also when the row is masked so far
        const float pv = (MASK && v == MASK_VALUE) ? 0.f : exp2f(v - m_new);
        s[4 * j + 2 * i + c] = pv;
        sum += pv;
      }
    }
    l[i] = l[i] * corr + sum;
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * i] *= corr;
      o[4 * j + 2 * i + 1] *= corr;
    }
  }
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S, float scale_log2,
                            int causal) {
  using C = FwdCfg<D>;
  using G = TileGeom<D>;
  constexpr int BKV = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t bars = base + C::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + C::K_OFF + s * C::KV_BYTES; };
  auto v_tile = [&](int s) { return base + C::V_OFF + s * C::KV_BYTES; };
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;  // heaviest first
  const int n_all = (S + BKV - 1) / BKV;
  const int n_kb = causal ? min(n_all, (q0 + C::BQ - 1) / BKV + 1) : n_all;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), C::NWG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer --
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int b = 0; b < G::N_BOX; ++b) {
        tma_load_3d(q_tile + b * C::BQ * G::ROW_BYTES, &q_map, q_full,
                    b * G::BOX_COLS, q0, bh);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty(s), ((kb / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full(s), C::KV_BYTES);
        for (int b = 0; b < G::N_BOX; ++b) {
          tma_load_3d(k_tile(s) + b * BKV * G::ROW_BYTES, &k_map, k_full(s),
                      b * G::BOX_COLS, kb * BKV, bh);
        }
        mbar_arrive_expect_tx(v_full(s), C::KV_BYTES);
        for (int b = 0; b < G::N_BOX; ++b) {
          tma_load_3d(v_tile(s) + b * BKV * G::ROW_BYTES, &v_map, v_full(s),
                      b * G::BOX_COLS, kb * BKV, bh);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumer --
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int w = wg - 1;  // q rows [64 w, 64 w + 64) of the block
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int qpos0 = q0 + 64 * w + 16 * (t / 32) + lane / 4;  // + 8 i
    const int cq = 2 * (lane % 4);
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % STAGES;
      const uint32_t ph = (kb / STAGES) & 1;
      const int k0 = kb * BKV;
      float sacc[BKV / 2];
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        Wgmma<BKV>::template ss<0>(
            sacc, desc_kmajor<D>(q_tile, C::BQ, 64 * w, ks),
            desc_kmajor<D>(k_tile(s), BKV, 0, ks), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      uint32_t p[BKV / 16][4];
      const bool need_mask =
          k0 + BKV > S || (causal && k0 + BKV - 1 > q0 + 64 * w);
      if (need_mask) {
        softmax_block<true, BKV, D>(sacc, m, l, oacc, p, qpos0, k0, cq, S,
                                    causal, scale_log2);
      } else {
        softmax_block<false, BKV, D>(sacc, m, l, oacc, p, qpos0, k0, cq, S,
                                     causal, scale_log2);
      }

      mbar_wait(v_full(s), ph);
      fence_regs(oacc);
      fence_frags(p);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) {
        Wgmma<D>::template rs<1>(oacc, p[ks],
                                 desc_mnmajor<D>(v_tile(s), BKV, ks), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(empty(s));
    }

    // epilogue: O / l in bf16 and lse, from registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[i];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float l_safe = fmaxf(lt, 1e-30f);
      const float inv = __frcp_rn(l_safe);
      const int qpos = qpos0 + 8 * i;
      if (qpos < S) {
        __nv_bfloat16* dst = o + ((size_t)bh * S + qpos) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(
              oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
        }
        if (lane % 4 == 0) lse[(size_t)bh * S + qpos] = m[i] * LN2 + logf(l_safe);
      }
    }
  }
}

// Encodes the maps and launches; the first call of each instantiation
// raises its shared-memory limit and checks the entry register count
// setmaxnreg's budget assumes (a mismatch would hang setmaxnreg.inc).
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int S, float scale, int causal,
                cudaStream_t stream) {
  using C = FwdCfg<D>;
  auto kernel = flash_fwd_bf16_wgmma_kernel<D>;
  static int ready = 0;
  if (ready == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != C::ENTRY_REGS) return KF_BAD_REGS;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = 1;
  }
  CUtensorMap qm, km, vm;
  int err = encode_rows_map<D>(&qm, q, bh, S, C::BQ);
  if (err == 0) err = encode_rows_map<D>(&km, k, bh, S, C::BK);
  if (err == 0) err = encode_rows_map<D>(&vm, v, bh, S, C::BK);
  if (err != 0) return err;
  const dim3 grid((S + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S,
      scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --

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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int S, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D>;
  constexpr size_t smem = F32Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int is_bf16, const void* q, const void* k, const void* v, void* o,
             void* lse, int bh, int S, float scale, int causal,
             cudaStream_t stream) {
  if (is_bf16) {
    return launch_bf16<D>(q, k, v, o, lse, bh, S, scale, causal, stream);
  }
  return launch_f32<D>(q, k, v, o, lse, bh, S, scale, causal, stream);
}

}  // namespace

// Returns 0 on success, a cudaError_t code, or a negative code of
// kf_error_string for arguments the kernel does not take (the Python
// wrapper checks them first).
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
  if (code == KF_TMA_ENCODE_FAILED) return "cuTensorMapEncodeTiled failed";
  if (code == KF_BAD_REGS) {
    return "kernel's entry register count differs from its setmaxnreg budget";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
