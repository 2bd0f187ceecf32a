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
// All-gather (ring_ag_copy_kernel): a direct copy, for the same reason.
// The ring would pass each shard rank to rank; on one card every rank's
// output is reachable, so each thread loads 16-byte vectors of one
// rank's shard j (two a step, both in flight together) once each and
// stores each into all k outputs at out[r][j*chunk + o], streaming
// (evict-first) stores.  No slots, flags, epoch or cooperative launch:
// an ordinary grid-stride launch of a few blocks per SM, one grid row per
// shard.  Elements of 2, 4 or 8 bytes; a shard whose source and k
// destinations share their offset mod 16 bytes takes vector copies after
// a scalar head and ends in a scalar tail, any other runs scalar.  The
// band cut does not change the values of a gather (both bands land in
// the same places), so the all-gather takes none.
//
// Across processes (one communicator over several worker processes on one
// card): each process holds the buffers of its own ranks only, in a
// symmetric buffer the other processes have mapped through CUDA IPC
// (kf_sym_alloc / kf_sym_open below).  The in[] tables then hold every
// rank's buffer, this process's and its peers' mapped ones, and a launch
// covers only the process's own ranks r0 .. r0+count-1: the reduce-scatter
// folds their chunks, the all-gather writes their outputs.  The fold order
// does not depend on r0 or count, so each chunk is bit for bit the chunk
// of the launch over all k ranks.  Nothing here waits for another process:
// the caller drains its stream and meets the others at a host barrier
// before a launch reads their buffers.
//
// What bounds both: bytes.  Reduce-scatter reads k*k*chunk elements and
// writes k*chunk; all-gather reads k*chunk and writes k*k*chunk.  Each
// kernel moves exactly those bytes once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int KMAX = 64;
constexpr int THREADS = 256;
constexpr int KF_BAD_ARGS = 10001;

__device__ __forceinline__ long long mod(long long x, int k) {
  return ((x % k) + k) % k;
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
  void* out[KMAX];        // rank r0 + i's chunk of the sum
  long long chunk, cut;
  int k, nband, r0;
  // per segment blockIdx.y = i * nband + band (rank r0 + i): the scalar
  // elements before
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
  const int li = seg / a.nband, band = seg % a.nband;
  const int r = a.r0 + li;
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
  T* out = static_cast<T*>(a.out[li]) + lo;
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

constexpr int COPY_BLOCKS_PER_SM = 8;

struct CopyArgs {
  const void* in[KMAX];   // rank j's shard: chunk elements
  void* out[KMAX];        // rank r0 + i's gathered buffer: k chunks
  long long chunk;
  int k, count;
  // per shard blockIdx.y = j: the scalar elements before the first
  // 16-byte vector, or -1 when the source and the k destinations do not
  // share their offset mod 16 bytes (the shard runs scalar)
  signed char head[KMAX];
};

// out[i][j*chunk + e] = in[j][e] for each of the count outputs: one load,
// count stores.
template <typename T>
__global__ void __launch_bounds__(THREADS, COPY_BLOCKS_PER_SM)
ring_ag_copy_kernel(const CopyArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ T* dst[KMAX];  // shard j's place in each output
  const int j = blockIdx.y, count = a.count;
  if (threadIdx.x < count) {
    dst[threadIdx.x] = static_cast<T*>(a.out[threadIdx.x]) + j * a.chunk;
  }
  __syncthreads();
  const T* src = static_cast<const T*>(a.in[j]);
  const long long n = a.chunk;
  const long long head = a.head[j] < 0 ? n : min((long long)a.head[j], n);
  const long long nvec = (n - head) / VEC;
  const long long body_end = head + nvec * VEC;  // the scalar tail's start
  const long long stride = (long long)gridDim.x * THREADS;
  // the vectors, two a thread a step, both loads in flight together; the
  // stores stream (evict first): nothing reads them back soon, and L2
  // keeps the lines it needs for the loads
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nvec;
       i += 2 * stride) {
    const long long e0 = head + i * VEC, e1 = e0 + stride * VEC;
    const bool two = i + stride < nvec;
    const uint4 a0 = __ldg(reinterpret_cast<const uint4*>(src + e0));
    uint4 a1;
    if (two) a1 = __ldg(reinterpret_cast<const uint4*>(src + e1));
    for (int r = 0; r < count; ++r) {
      __stcs(reinterpret_cast<uint4*>(dst[r] + e0), a0);
      if (two) __stcs(reinterpret_cast<uint4*>(dst[r] + e1), a1);
    }
  }
  // the scalar head and tail
  const long long scalars = head + (n - body_end);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < scalars; i += stride) {
    const long long e = i < head ? i : body_end + (i - head);
    const T v = src[e];
    for (int r = 0; r < count; ++r) dst[r][e] = v;
  }
}

using FoldKernel = void (*)(const FoldArgs);
using CopyKernel = void (*)(const CopyArgs);

// reduce-scatter element code: 0 f32, 1 bf16, 2 int32
FoldKernel pick_fold(int code) {
  if (code == 0) return ring_rs_fold_kernel<FoldF32>;
  if (code == 1) return ring_rs_fold_kernel<FoldBF16>;
  if (code == 2) return ring_rs_fold_kernel<FoldI32>;
  return nullptr;
}

// all-gather element bytes: 2, 4 or 8
CopyKernel pick_copy(int bytes) {
  if (bytes == 2) return ring_ag_copy_kernel<unsigned short>;
  if (bytes == 4) return ring_ag_copy_kernel<unsigned>;
  if (bytes == 8) return ring_ag_copy_kernel<unsigned long long>;
  return nullptr;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

}  // namespace

// One launch of the reduce-scatter over k ranks of one card: in holds k
// device pointers (rank j's k*chunk elements), out count of them (the
// chunk of rank r0 + i); code 0 f32, 1 bf16, 2 int32.  r0 = 0, count = k
// is every rank.  Any element-aligned bases; nothing to keep between
// launches.
extern "C" int kf_ring_rs(int code, const void* const* in, void* const* out,
                          int k, int r0, int count, long long chunk,
                          long long cut, void* stream) {
  const FoldKernel kernel = pick_fold(code);
  if (kernel == nullptr || k < 2 || k > KMAX || r0 < 0 || count < 1 ||
      r0 + count > k || chunk <= 0 || cut <= 0 || cut > chunk)
    return KF_BAD_ARGS;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const long long es = code == 1 ? 2 : 4, vec = 16 / es;
  FoldArgs a;
  a.chunk = chunk;
  a.cut = cut;
  a.k = k;
  a.r0 = r0;
  a.nband = cut < chunk ? 2 : 1;
  for (int j = 0; j < k; ++j) a.in[j] = in[j];
  for (int i = 0; i < count; ++i) a.out[i] = out[i];
  long long most = 0;  // work items (vectors and scalars) of a segment
  for (int i = 0; i < count; ++i) {
    const int r = r0 + i;
    for (int b = 0; b < a.nband; ++b) {
      const long long lo = b == 0 ? 0 : cut;
      const long long n = (b == 0 ? cut : chunk) - lo;
      const uintptr_t o = reinterpret_cast<uintptr_t>(out[i]) + lo * es;
      bool shared = o % es == 0;
      for (int j = 0; j < k && shared; ++j) {
        shared = (reinterpret_cast<uintptr_t>(in[j]) + (r * chunk + lo) * es) %
                     16 == o % 16;
      }
      const long long head =
          shared ? static_cast<long long>((16 - o % 16) % 16) / es : -1;
      a.head[i * a.nband + b] = static_cast<signed char>(head);
      const long long h = head < 0 || head > n ? n : head;
      const long long nvec = (n - h) / vec;
      const long long items = n - nvec * (vec - 1);
      most = items > most ? items : most;
    }
  }
  const int segs = count * a.nband;
  long long bx = (most + THREADS - 1) / THREADS;
  const long long fill = sms * FOLD_BLOCKS_PER_SM / segs;
  bx = bx < fill ? bx : (fill > 0 ? fill : 1);
  kernel<<<dim3(static_cast<unsigned>(bx), segs), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the all-gather over k ranks of one card: in holds k device
// pointers (rank j's chunk elements), out count of them (the k*chunk
// output of rank r0 + i), elements of `bytes` bytes (2, 4 or 8).  r0 = 0,
// count = k is every rank; r0 only names the window, since every output
// is the same concatenation.  Any element-aligned bases; nothing to keep
// between launches.
extern "C" int kf_ring_ag(int bytes, const void* const* in, void* const* out,
                          int k, int r0, int count, long long chunk,
                          void* stream) {
  const CopyKernel kernel = pick_copy(bytes);
  if (kernel == nullptr || k < 2 || k > KMAX || r0 < 0 || count < 1 ||
      r0 + count > k || chunk <= 0)
    return KF_BAD_ARGS;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const long long es = bytes, vec = 16 / es;
  CopyArgs a;
  a.chunk = chunk;
  a.k = k;
  a.count = count;
  for (int i = 0; i < count; ++i) a.out[i] = out[i];
  long long most = 0;  // work items (vectors and scalars) of a shard
  for (int j = 0; j < k; ++j) {
    a.in[j] = in[j];
    const uintptr_t o = reinterpret_cast<uintptr_t>(in[j]);
    bool shared = o % es == 0;
    for (int i = 0; i < count && shared; ++i) {
      shared = (reinterpret_cast<uintptr_t>(out[i]) + j * chunk * es) % 16 ==
               o % 16;
    }
    const long long head =
        shared ? static_cast<long long>((16 - o % 16) % 16) / es : -1;
    a.head[j] = static_cast<signed char>(head);
    const long long h = head < 0 || head > chunk ? chunk : head;
    const long long nvec = (chunk - h) / vec;
    const long long items = chunk - nvec * (vec - 1);
    most = items > most ? items : most;
  }
  long long bx = (most + THREADS - 1) / THREADS;
  const long long fill = sms * COPY_BLOCKS_PER_SM / k;
  bx = bx < fill ? bx : (fill > 0 ? fill : 1);
  kernel<<<dim3(static_cast<unsigned>(bx), k), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- symmetric buffers --
//
// A process-spanning communicator's buffers: each process allocates its
// own with cudaMalloc (a whole allocation, so its IPC handle names exactly
// this buffer and no neighbour of torch's caching allocator), publishes
// the 64-byte handle over the host channel, and maps every peer's once a
// communicator epoch.  A process cannot open its own handle.

constexpr int KF_HANDLE_BYTES = sizeof(cudaIpcMemHandle_t);

extern "C" int kf_sym_handle_bytes() { return KF_HANDLE_BYTES; }

// cudaMalloc `bytes` on `device` and write the IPC handle of the buffer.
extern "C" int kf_sym_alloc(int device, long long bytes, void** ptr,
                            void* handle) {
  if (bytes <= 0) return KF_BAD_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(err);
  }
  memcpy(handle, &h, sizeof(h));
  return 0;
}

// Map a peer's buffer from its handle (peer access enabled lazily).
extern "C" int kf_sym_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

// Unmap a peer's buffer.
extern "C" int kf_sym_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Free this process's own buffer.
extern "C" int kf_sym_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

extern "C" const char* kf_error_string(int code) {
  if (code == KF_BAD_ARGS) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
