// Native reduce kernels for the host-side collective engine.
//
// Copy of kungfu_tpu/native/reduce.cpp.
//
// TPU-native equivalent of the reference's C++ reduction layer
// (srcs/go/kungfu/base/op.cpp std_transform_2 + f16.c AVX half kernels):
// the graph-collective engine's hot inner loop — accumulate a received
// chunk into the local buffer — runs here instead of numpy, with bf16
// added as a first-class dtype (it is the TPU wire format for gradients).
//
// SIMD comes from compiler auto-vectorization of the tight typed loops
// (-O3; portable codegen by default — see Makefile ARCHFLAGS for the
// -march=native opt-in); f16/bf16 widen to f32, reduce, and narrow back with
// round-to-nearest-even, matching XLA's conversion semantics.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum Op : int32_t { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_PROD = 3 };

enum Dtype : int32_t {
  DT_U8 = 0,
  DT_I8 = 1,
  DT_I16 = 2,
  DT_I32 = 3,
  DT_I64 = 4,
  DT_U16 = 5,
  DT_U32 = 6,
  DT_U64 = 7,
  DT_F16 = 8,
  DT_F32 = 9,
  DT_F64 = 10,
  DT_BF16 = 11,
};

template <typename T, typename F>
void apply(T* dst, const T* src, size_t n, F f) {
  for (size_t i = 0; i < n; ++i) dst[i] = f(dst[i], src[i]);
}

// min/max propagate NaN like np.minimum/np.maximum (a!=a is false for
// integral T, so the checks fold away there)
template <typename T>
inline T nan_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

template <typename T>
inline T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

template <typename T>
int run_typed(T* dst, const T* src, size_t n, int32_t op) {
  switch (op) {
    case OP_SUM:
      apply(dst, src, n, [](T a, T b) { return static_cast<T>(a + b); });
      return 0;
    case OP_MIN:
      apply(dst, src, n, [](T a, T b) { return nan_min(a, b); });
      return 0;
    case OP_MAX:
      apply(dst, src, n, [](T a, T b) { return nan_max(a, b); });
      return 0;
    case OP_PROD:
      apply(dst, src, n, [](T a, T b) { return static_cast<T>(a * b); });
      return 0;
  }
  return -1;
}

// -- half / bfloat16 conversions -----------------------------------------
inline float f16_to_f32(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while ((man & 0x400u) == 0) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3FFu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (man << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t f32_to_f16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFFu) - 127 + 15;
  uint32_t man = bits & 0x7FFFFFu;
  if (exp >= 0x1F) {  // overflow / inf / nan
    uint32_t m = ((bits >> 23) & 0xFFu) == 0xFFu && man ? 0x200u : 0u;
    return static_cast<uint16_t>(sign | 0x7C00u | m);
  }
  if (exp <= 0) {  // subnormal or zero
    if (exp < -10) return static_cast<uint16_t>(sign);
    man |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t mid = 1u << (shift - 1);
    if (rem > mid || (rem == mid && (half & 1u))) ++half;
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = static_cast<uint32_t>(exp) << 10 | (man >> 13);
  uint32_t rem = man & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) ++half;
  return static_cast<uint16_t>(sign | half);
}

inline float bf16_to_f32(uint16_t h) {
  uint32_t bits = static_cast<uint32_t>(h) << 16;
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  if ((bits & 0x7FFFFFFFu) > 0x7F800000u) {  // nan: keep quiet bit
    return static_cast<uint16_t>((bits >> 16) | 0x40u);
  }
  uint32_t lsb = (bits >> 16) & 1u;  // round to nearest even
  bits += 0x7FFFu + lsb;
  return static_cast<uint16_t>(bits >> 16);
}

// branchless bf16 round-to-nearest-even narrow: vectorizes (mask+blend)
// where the branchy f32_to_bf16 forces scalar code on the hot path
inline uint16_t f32_to_bf16_branchless(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t lsb = (bits >> 16) & 1u;
  uint32_t rounded = (bits + 0x7FFFu + lsb) >> 16;
  uint32_t nan_out = (bits >> 16) | 0x40u;  // quiet the NaN
  bool is_nan = (bits & 0x7FFFFFFFu) > 0x7F800000u;
  return static_cast<uint16_t>(is_nan ? nan_out : rounded);
}

// op hoisted out of the loop so each case is a tight widen/op/narrow
// loop the vectorizer can handle
template <float (*ToF)(uint16_t), uint16_t (*FromF)(float), typename F>
void loop_16(uint16_t* dst, const uint16_t* src, size_t n, F f) {
  for (size_t i = 0; i < n; ++i) {
    dst[i] = FromF(f(ToF(dst[i]), ToF(src[i])));
  }
}

template <float (*ToF)(uint16_t), uint16_t (*FromF)(float)>
int run_16(uint16_t* dst, const uint16_t* src, size_t n, int32_t op) {
  switch (op) {
    case OP_SUM:
      loop_16<ToF, FromF>(dst, src, n, [](float a, float b) { return a + b; });
      return 0;
    case OP_MIN:
      loop_16<ToF, FromF>(dst, src, n, [](float a, float b) { return nan_min(a, b); });
      return 0;
    case OP_MAX:
      loop_16<ToF, FromF>(dst, src, n, [](float a, float b) { return nan_max(a, b); });
      return 0;
    case OP_PROD:
      loop_16<ToF, FromF>(dst, src, n, [](float a, float b) { return a * b; });
      return 0;
  }
  return -1;
}

// Runtime SIMD dispatch for the hot dtypes (the reference's explicit AVX
// f16 kernels, base/f16.c, done the portable way): target_clones emits
// SSE2/AVX2/AVX-512 variants of the whole inlined loop and the dynamic
// linker picks the widest one this CPU supports — no -march opt-in, no
// SIGILL risk on heterogeneous shared-filesystem fleets (the Makefile
// ARCHFLAGS concern).
// ... except under TSan/ASan: target_clones dispatches through IFUNC
// resolvers, which the dynamic linker runs during relocation — BEFORE
// the sanitizer runtime initializes — and that segfaults at startup.
// Sanitizer builds take the portable loop; they exist to find races,
// not to win benchmarks.
#if defined(__x86_64__) && defined(__GNUC__) && !defined(__clang__) && \
    !defined(__SANITIZE_THREAD__) && !defined(__SANITIZE_ADDRESS__)
#define KF_SIMD_CLONES \
  __attribute__((target_clones("default", "avx2", "avx512f")))
#else
#define KF_SIMD_CLONES
#endif

KF_SIMD_CLONES
int run_f32(float* dst, const float* src, size_t n, int32_t op) {
  return run_typed(dst, src, n, op);
}

KF_SIMD_CLONES
int run_f64(double* dst, const double* src, size_t n, int32_t op) {
  return run_typed(dst, src, n, op);
}

KF_SIMD_CLONES
int run_bf16(uint16_t* dst, const uint16_t* src, size_t n, int32_t op) {
  return run_16<bf16_to_f32, f32_to_bf16_branchless>(dst, src, n, op);
}

}  // namespace

extern "C" {

// dst <- dst OP src, elementwise over n elements (reference std_transform_2)
int kf_transform2(void* dst, const void* src, int64_t n, int32_t dtype,
                  int32_t op) {
  size_t m = static_cast<size_t>(n);
  switch (dtype) {
    case DT_U8: return run_typed(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src), m, op);
    case DT_I8: return run_typed(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src), m, op);
    case DT_I16: return run_typed(static_cast<int16_t*>(dst), static_cast<const int16_t*>(src), m, op);
    case DT_I32: return run_typed(static_cast<int32_t*>(dst), static_cast<const int32_t*>(src), m, op);
    case DT_I64: return run_typed(static_cast<int64_t*>(dst), static_cast<const int64_t*>(src), m, op);
    case DT_U16: return run_typed(static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src), m, op);
    case DT_U32: return run_typed(static_cast<uint32_t*>(dst), static_cast<const uint32_t*>(src), m, op);
    case DT_U64: return run_typed(static_cast<uint64_t*>(dst), static_cast<const uint64_t*>(src), m, op);
    case DT_F32: return run_f32(static_cast<float*>(dst), static_cast<const float*>(src), m, op);
    case DT_F64: return run_f64(static_cast<double*>(dst), static_cast<const double*>(src), m, op);
    case DT_F16:
      return run_16<f16_to_f32, f32_to_f16>(
          static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src), m, op);
    case DT_BF16:
      return run_bf16(
          static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src), m, op);
  }
  return -1;
}

int kf_version() { return 1; }

}  // extern "C"
