// Ring reduce-scatter and ring all-gather for NVIDIA Hopper (sm_90a), over
// k ranks whose buffers are co-resident on one card.
//
// Replaces the TPU kernels kungfu_tpu/ops/pallas/collectives.py::_rs_kernel
// (launched by _rs_pallas) and ::_ag_kernel (launched by _ag_pallas).  They
// compute the same functions, bit for bit:
//
//   reduce-scatter: rank r's flat buffer in[r] is k chunks of `chunk`
//     elements; out[r] (one chunk) is the sum over ranks of their chunk r,
//     folded in ring order ((x[r+s][r] + x[r+2s][r]) + ...) + x[r][r],
//     received operand first, rounded to the element type at every step;
//   all-gather: out[r] (k chunks) is every rank's in[r] in rank order.
//
// s is +1 on the clockwise band, elements [0, cut) of every chunk, and -1
// on the counter-clockwise band [cut, chunk) (cut == chunk: one direction).
// The caller takes cut from the reference's tile geometry, so the bands
// and with them the fold orders are the reference's.
//
// Reduce-scatter (ring_rs_fold_kernel): a direct fold in ring order.  The
// TPU ring exists because ICI links join neighbours only: the partial sum
// travels rank to rank and each hop adds one chunk.  One card has no
// links, and a hop is a load, so the partial that the ring would carry to
// rank r is formed where it is read: each thread owns one 16-byte vector
// of out[r], issues the k loads x[r+s j][r] (j = 1..k, mod k; in groups
// of 8, all of a group in flight together) and folds them in exactly the
// ring's order with the ring's per-step rounding (Fold*).  No slots, no
// flags, no epoch: an ordinary launch, grid-stride over a grid that fills
// the card.  It reads k*k*chunk elements and writes k*chunk, the bytes the
// bound counts.  Any row bases and strides: a (rank, band) segment whose k
// sources and output share their offset mod 16 bytes takes vector loads
// after a scalar head up to the first 16-byte boundary and ends in a
// scalar tail; a segment whose rows do not share it runs scalar.  With
// peer pointers the same kernel serves k cards of an NVSwitch host: each
// rank then reads its k-1 remote contributions over NVLink, (k-1)*chunk
// elements inbound per rank, as the ring does.
//
// All-gather (ring_ag_kernel), the first port's ring:
// * One launch runs every rank's program: the grid is k ranks x ndir
//   directions x nblk blocks.  Block (r, d, b) owns the same span of
//   whole 2048-element tiles in every chunk of its band, for all k-1
//   steps, and its partner downstream is block (r + s, d, b).  The TPU
//   kernel's remote DMAs and semaphores become stores into the
//   downstream block's slot in device memory and flags written with
//   st.release.gpu and read with ld.acquire.gpu.
// * The forwarded tile stays in registers; each block has two receive
//   slots of one tile (double buffering) and two flags, so scratch is
//   bounded by the grid, never by the chunk.  Per tile and step: wait for
//   downstream's ack of the slot about to be reused (from the step before
//   last), store the tile into it, release downstream's ready flag,
//   acquire our own, read our slot, release our ack, store the tile.
// * Every block waits on a neighbour, so all blocks must be resident at
//   once: the launch is cooperative (it fails rather than deadlocks when
//   the grid does not fit) and the grid is sized from the occupancy.
// * Flags never need a reset: their values are `base + q + 1` for the
//   block's q-th exchange, and base grows by each launch's exchange count,
//   so no flag left by an earlier launch satisfies a wait of this one
//   (the TPU kernel instead drains its ack semaphores to zero).
// * A wait that does not end within 20 s traps: a broken protocol ends
//   the process with an error instead of hanging the card.
//
// What bounds both: bytes.  Reduce-scatter reads k*k*chunk elements and
// writes k*chunk; all-gather the reverse.  The all-gather's ring adds
// (k-1) slot writes and reads per element through L2 and one flag round
// trip per tile and step; its loads and stores are plain coalesced
// words, with slot traffic marked .cg (L2 only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KMAX = 64;
constexpr int THREADS = 256;
constexpr int EPT = 8;                 // elements per thread per tile
constexpr int TILE = THREADS * EPT;    // elements per tile
constexpr int KF_BAD_ARGS = 10001;
constexpr int KF_RING_TOO_LARGE = 10002;
constexpr unsigned long long TIMEOUT_NS = 20000000000ull;

struct RingArgs {
  const void* in[KMAX];             // rank r's input
  void* out[KMAX];                  // rank r's output
  void* slot[KMAX];                 // rank r's slots: [ndir*nblk][2][TILE]
  unsigned long long* flag[KMAX];   // rank r's flags: [ndir*nblk][2]
  long long chunk;                  // elements of one chunk
  long long cut;                    // end of the clockwise band
  int k, ndir, nblk;
  unsigned long long base;          // every flag is <= base at launch
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the whole block waits until *p >= v (thread 0 spins)
__device__ __forceinline__ void wait_geq(const unsigned long long* p,
                                         unsigned long long v) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = now_ns();
    while (ld_acquire(p) < v) {
      if (now_ns() - t0 > TIMEOUT_NS) __trap();
    }
  }
  __syncthreads();
}

// after every thread's earlier accesses, publish *p = v
__device__ __forceinline__ void signal(unsigned long long* p,
                                       unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(p, v);
  }
}

__device__ __forceinline__ long long mod(long long x, int k) {
  return ((x % k) + k) % k;
}

// one block's place in the grid and its span of tiles
struct Place {
  int r, d, sign, dn, me;
  long long lo, hi, t0, t1;
};

__device__ __forceinline__ Place place(const RingArgs& a) {
  Place p;
  const int per_rank = a.ndir * a.nblk;
  p.r = blockIdx.x / per_rank;
  const int rem = blockIdx.x % per_rank;
  p.d = rem / a.nblk;
  const int b = rem % a.nblk;
  p.sign = p.d == 0 ? 1 : -1;
  p.dn = static_cast<int>(mod(p.r + p.sign, a.k));
  p.me = rem;
  p.lo = p.d == 0 ? 0 : a.cut;
  p.hi = p.d == 0 ? a.cut : a.chunk;
  const long long tiles = (p.hi - p.lo + TILE - 1) / TILE;
  const long long per = (tiles + a.nblk - 1) / a.nblk;
  p.t0 = b * per;
  p.t1 = p.t0 + per < tiles ? p.t0 + per : tiles;
  return p;
}

struct FoldF32 {
  using T = float;
  static __device__ __forceinline__ T fold(T recv, T local) {
    return __fadd_rn(recv, local);
  }
};

struct FoldBF16 {
  using T = unsigned short;  // bf16 bits
  static __device__ __forceinline__ T fold(T recv, T local) {
    const float s = __fadd_rn(__uint_as_float(static_cast<unsigned>(recv) << 16),
                              __uint_as_float(static_cast<unsigned>(local) << 16));
    return __bfloat16_as_ushort(__float2bfloat16_rn(s));
  }
};

struct FoldI32 {
  using T = int;
  static __device__ __forceinline__ T fold(T recv, T local) {
    return static_cast<int>(static_cast<unsigned>(recv) +
                            static_cast<unsigned>(local));  // wraps
  }
};

// ------------------------------------------------ reduce-scatter fold --

constexpr int FOLD_GROUP = 8;         // loads of one vector in flight
constexpr int FOLD_BLOCKS_PER_SM = 4;

struct FoldArgs {
  const void* in[KMAX];   // rank j's flat buffer: k chunks
  void* out[KMAX];        // rank r's chunk of the sum
  long long chunk, cut;
  int k, nband;
  // per segment blockIdx.y = r * nband + band: the scalar elements before
  // the first 16-byte vector, or -1 when the k sources and the output do
  // not share their offset mod 16 bytes (the segment runs scalar)
  signed char head[2 * KMAX];
};

template <typename T>
union Vec16 {
  uint4 u;
  T e[16 / sizeof(T)];
};

template <typename F>
__global__ void __launch_bounds__(THREADS, FOLD_BLOCKS_PER_SM)
ring_rs_fold_kernel(const FoldArgs a) {
  using T = typename F::T;
  constexpr int VEC = 16 / sizeof(T);
  __shared__ const T* src[KMAX];  // fold order: rank r + s j, j = 1..k
  const int seg = blockIdx.y;
  const int r = seg / a.nband, band = seg % a.nband;
  const int sign = band == 0 ? 1 : -1;
  const long long lo = band == 0 ? 0 : a.cut;
  const long long n = (band == 0 ? a.cut : a.chunk) - lo;
  const int k = a.k;
  if (threadIdx.x < k) {
    const int j = static_cast<int>(threadIdx.x) + 1;
    const int rank = static_cast<int>(mod(r + sign * j, k));
    src[threadIdx.x] = static_cast<const T*>(a.in[rank]) + r * a.chunk + lo;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out[r]) + lo;
  const long long head = a.head[seg] < 0 ? n : min((long long)a.head[seg], n);
  const long long nvec = (n - head) / VEC;
  const long long body_end = head + nvec * VEC;  // the scalar tail's start
  const long long items = head + nvec + (n - body_end);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < items;
       i += (long long)gridDim.x * THREADS) {
    if (i >= head && i < head + nvec) {
      const long long e = head + (i - head) * VEC;
      Vec16<T> acc, v[FOLD_GROUP];
      for (int j0 = 0; j0 < k; j0 += FOLD_GROUP) {
#pragma unroll
        for (int g = 0; g < FOLD_GROUP; ++g) {
          if (j0 + g < k) {
            v[g].u = __ldg(reinterpret_cast<const uint4*>(src[j0 + g] + e));
          }
        }
#pragma unroll
        for (int g = 0; g < FOLD_GROUP; ++g) {
          if (j0 + g == 0) {
            acc = v[0];
          } else if (j0 + g < k) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc.e[c] = F::fold(acc.e[c], v[g].e[c]);
          }
        }
      }
      *reinterpret_cast<uint4*>(out + e) = acc.u;
    } else {
      const long long e = i < head ? i : body_end + (i - head - nvec);
      T acc = src[0][e];
      for (int j = 1; j < k; ++j) acc = F::fold(acc, src[j][e]);
      out[e] = acc;
    }
  }
}

// ------------------------------------------------------- all-gather --

// Exchange one tile with the ring neighbours: send `v` downstream, receive
// upstream's into `v`.  q is the block's exchange count.
template <typename T>
__device__ __forceinline__ void exchange(const RingArgs& a, const Place& p,
                                         unsigned long long q, long long e0,
                                         T (&v)[EPT]) {
  T* dst = static_cast<T*>(a.slot[p.dn]) +
           (static_cast<long long>(p.me) * 2 + (q & 1)) * TILE;
  const T* src = static_cast<const T*>(a.slot[p.r]) +
                 (static_cast<long long>(p.me) * 2 + (q & 1)) * TILE;
  unsigned long long* dn_flag = a.flag[p.dn] + 2 * p.me;  // [0] ready
  unsigned long long* my_flag = a.flag[p.r] + 2 * p.me;   // [1] ack
  // downstream has read what we stored in this slot two exchanges ago
  if (q >= 2) wait_geq(dn_flag + 1, a.base + q - 1);
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int j = i * THREADS + threadIdx.x;
    if (e0 + j < p.hi) __stcg(dst + j, v[i]);
  }
  signal(dn_flag, a.base + q + 1);
  wait_geq(my_flag, a.base + q + 1);
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int j = i * THREADS + threadIdx.x;
    if (e0 + j < p.hi) v[i] = __ldcg(src + j);
  }
  signal(my_flag + 1, a.base + q + 1);
}

template <typename W>
__global__ void __launch_bounds__(THREADS) ring_ag_kernel(const RingArgs a) {
  const Place p = place(a);
  const W* in = static_cast<const W*>(a.in[p.r]);
  W* out = static_cast<W*>(a.out[p.r]);
  unsigned long long q = 0;
  for (long long t = p.t0; t < p.t1; ++t) {
    const long long e0 = p.lo + t * TILE;
    W buf[EPT];
    W* own = out + p.r * a.chunk + e0;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int j = i * THREADS + threadIdx.x;
      if (e0 + j < p.hi) {
        buf[i] = in[e0 + j];
        own[j] = buf[i];
      }
    }
    for (int s = 0; s < a.k - 1; ++s, ++q) {
      exchange(a, p, q, e0, buf);
      W* dst = out + mod(p.r - p.sign * (s + 1), a.k) * a.chunk + e0;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int j = i * THREADS + threadIdx.x;
        if (e0 + j < p.hi) dst[j] = buf[i];
      }
    }
  }
}

using Kernel = void (*)(const RingArgs);
using FoldKernel = void (*)(const FoldArgs);

// reduce-scatter element code: 0 f32, 1 bf16, 2 int32
FoldKernel pick_fold(int code) {
  if (code == 0) return ring_rs_fold_kernel<FoldF32>;
  if (code == 1) return ring_rs_fold_kernel<FoldBF16>;
  if (code == 2) return ring_rs_fold_kernel<FoldI32>;
  return nullptr;
}

// all-gather word bytes: 2 or 4
Kernel pick_ag(int code) {
  if (code == 4) return ring_ag_kernel<unsigned>;
  if (code == 2) return ring_ag_kernel<unsigned short>;
  return nullptr;
}

// blocks of `kernel` the current device holds at once
int capacity(Kernel kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

}  // namespace

// One launch of the reduce-scatter over k co-resident ranks: in/out are k
// device pointers each (rank j's k*chunk elements, rank r's chunk), code
// 0 f32, 1 bf16, 2 int32.  Any element-aligned bases; nothing to keep
// between launches.
extern "C" int kf_ring_rs(int code, const void* const* in, void* const* out,
                          int k, long long chunk, long long cut,
                          void* stream) {
  const FoldKernel kernel = pick_fold(code);
  if (kernel == nullptr || k < 2 || k > KMAX || chunk <= 0 || cut <= 0 ||
      cut > chunk)
    return KF_BAD_ARGS;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long es = code == 1 ? 2 : 4, vec = 16 / es;
  FoldArgs a;
  a.chunk = chunk;
  a.cut = cut;
  a.k = k;
  a.nband = cut < chunk ? 2 : 1;
  for (int r = 0; r < k; ++r) {
    a.in[r] = in[r];
    a.out[r] = out[r];
  }
  long long most = 0;  // work items (vectors and scalars) of a segment
  for (int r = 0; r < k; ++r) {
    for (int b = 0; b < a.nband; ++b) {
      const long long lo = b == 0 ? 0 : cut;
      const long long n = (b == 0 ? cut : chunk) - lo;
      const uintptr_t o = reinterpret_cast<uintptr_t>(out[r]) + lo * es;
      bool shared = o % es == 0;
      for (int j = 0; j < k && shared; ++j) {
        shared = (reinterpret_cast<uintptr_t>(in[j]) + (r * chunk + lo) * es) %
                     16 == o % 16;
      }
      const long long head =
          shared ? static_cast<long long>((16 - o % 16) % 16) / es : -1;
      a.head[r * a.nband + b] = static_cast<signed char>(head);
      const long long h = head < 0 || head > n ? n : head;
      const long long nvec = (n - h) / vec;
      const long long items = n - nvec * (vec - 1);
      most = items > most ? items : most;
    }
  }
  const int segs = k * a.nband;
  long long bx = (most + THREADS - 1) / THREADS;
  const long long fill = sms * FOLD_BLOCKS_PER_SM / segs;
  bx = bx < fill ? bx : (fill > 0 ? fill : 1);
  kernel<<<dim3(static_cast<unsigned>(bx), segs), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Elements of one all-gather tile; the scratch of one block is 2 tiles of
// 4-byte words and 2 flags.
extern "C" int kf_ring_tile() { return TILE; }

// The most blocks the all-gather kernels can keep resident on the current
// device (0 when it cannot launch cooperatively): the scratch is sized
// for it.
extern "C" int kf_ring_capacity(int* blocks) {
  int most = 0;
  for (const int code : {4, 2}) {
    int b = 0;
    const int err = capacity(pick_ag(code), &b);
    if (err) return err;
    most = b > most ? b : most;
  }
  *blocks = most;
  return 0;
}

// One launch of the ring all-gather over k co-resident ranks (code: word
// bytes, 2 or 4).  in/out: k device pointers each.  slot/flag: one
// scratch region of `scratch_blocks` blocks (2 tiles of 4-byte words and 2
// zero-initialised u64 flags each), carved per rank here; *base is the
// epoch, advanced past every flag value this launch writes.
extern "C" int kf_ring_ag_launch(int code, const void* const* in,
                                 void* const* out, int k, long long chunk,
                                 long long cut, void* slot, void* flag,
                                 int scratch_blocks, unsigned long long* base,
                                 void* stream) {
  const Kernel kernel = pick_ag(code);
  if (kernel == nullptr || k < 2 || k > KMAX || chunk <= 0 || cut <= 0 ||
      cut > chunk)
    return KF_BAD_ARGS;
  int resident = 0;
  const int err = capacity(kernel, &resident);
  if (err) return err;
  const int ndir = cut < chunk ? 2 : 1;
  const long long tiles[2] = {(cut + TILE - 1) / TILE,
                              (chunk - cut + TILE - 1) / TILE};
  const long long most = tiles[0] > tiles[1] ? tiles[0] : tiles[1];
  const int fit = (resident < scratch_blocks ? resident : scratch_blocks) /
                  (k * ndir);
  if (fit < 1) return KF_RING_TOO_LARGE;
  const int nblk = most < fit ? static_cast<int>(most) : fit;
  RingArgs a;
  const long long word = 4;  // the scratch is carved in 4-byte words
  for (int r = 0; r < k; ++r) {
    a.in[r] = in[r];
    a.out[r] = out[r];
    a.slot[r] = static_cast<char*>(slot) +
                static_cast<long long>(r) * ndir * nblk * 2 * TILE * word;
    a.flag[r] = static_cast<unsigned long long*>(flag) +
                static_cast<long long>(r) * ndir * nblk * 2;
  }
  a.chunk = chunk;
  a.cut = cut;
  a.k = k;
  a.ndir = ndir;
  a.nblk = nblk;
  a.base = *base;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(k * ndir * nblk),
      dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // each block makes (k-1) exchanges per tile of its span
  long long per = 0;
  for (int d = 0; d < ndir; ++d) {
    const long long p = (tiles[d] + nblk - 1) / nblk;
    per = p > per ? p : per;
  }
  *base += static_cast<unsigned long long>(per) * (k - 1);
  return 0;
}

extern "C" const char* kf_error_string(int code) {
  if (code == KF_BAD_ARGS) return "unsupported arguments";
  if (code == KF_RING_TOO_LARGE)
    return "the ring's blocks cannot all be resident on this device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
