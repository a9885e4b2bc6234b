// Keyed random draws: threefry-2x32 as JAX computes it (executors/rngex.py).
//
// Not a port of a TPU kernel: the JAX package draws with jax.random under
// jax.jit (thunder_tpu/executors/jaxex.py:89-98 `_uniform_keyed`,
// `_randn_keyed`). This kernel gives the same bits: element i of a draw is
// threefry2x32(fold_in(key, salt), (i >> 32, i & 0xffffffff)), its two words
// xor-ed (jax's partitionable mode), truncated to 8 bits for bf16 (nmant 7 <
// 8), 16 for f16, 32 for f32, turned into a float in [1, 2) and scaled to
// [min, max) with XLA's CPU rounding (f32: one fused multiply-add; f16: in
// f32, then to f16; bf16: after each operation). A normal draw is
// sqrt(2)*erfinv(u) of u in [nextafter(-1, 0), 1). The key is read from device
// memory, so a CUDA-graph replay draws from whatever key was copied in.
//
// Bound: operations. Per element, threefry's 20 rounds are an add, a rotate
// and a xor each (60), the key's first addition to x0 and x1 2, the 5 key
// injections add a word to x0 and one to x1 (10: the word and the round
// constant added to x1 are summed once a thread), the counter's low word and
// the words' xor 2, the float conversion 2: 76 32-bit integer operations,
// against ~2 bytes (bf16) or 4
// (f32) written. At 132 SMs x 128 lanes x 1.98 GHz (the integer ALU and FMA
// pipes together, the most 32-bit integer operations the card issues) that
// is 0.022 ns an element, against 0.0006 (bf16) or 0.0012 ns (f32) of
// writes at 3.35 TB/s: compute-bound by 20 to 40 times. The design keeps
// everything in registers: each thread draws VEC consecutive elements (16
// bytes of output) and stores them with one 16-byte store; the folded key is
// computed once a thread. There is nothing to stage or reuse.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define THUNDER_TF_ROUND(r) \
  x0 += x1;                 \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  THUNDER_TF_ROUND(13) THUNDER_TF_ROUND(15) THUNDER_TF_ROUND(26) THUNDER_TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  THUNDER_TF_ROUND(17) THUNDER_TF_ROUND(29) THUNDER_TF_ROUND(16) THUNDER_TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  THUNDER_TF_ROUND(13) THUNDER_TF_ROUND(15) THUNDER_TF_ROUND(26) THUNDER_TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  THUNDER_TF_ROUND(17) THUNDER_TF_ROUND(29) THUNDER_TF_ROUND(16) THUNDER_TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  THUNDER_TF_ROUND(13) THUNDER_TF_ROUND(15) THUNDER_TF_ROUND(26) THUNDER_TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef THUNDER_TF_ROUND

// The draw's bits to one value of T: the uniform in [lo, lo + span), and for
// a normal draw sqrt(2)*erfinv of it, each rounded as rngex.draw_plain rounds.
template <typename T>
struct Convert;

template <>
struct Convert<float> {
  __device__ static float apply(uint32_t bits, float lo, float span, float sqrt2, bool normal) {
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(lo, __fmaf_rn(f, span, lo));
    return normal ? __fmul_rn(erfinvf(u), sqrt2) : u;
  }
};

template <>
struct Convert<__half> {
  __device__ static __half apply(uint32_t bits, float lo, float span, float sqrt2, bool normal) {
    const uint16_t m = static_cast<uint16_t>(((bits & 0xFFFFu) >> 6) | 0x3C00u);
    const float f = __half2float(__ushort_as_half(m)) - 1.0f;
    float u = __half2float(__float2half_rn(__fadd_rn(__fmul_rn(f, span), lo)));
    u = fmaxf(lo, u);
    if (!normal) return __float2half_rn(u);
    const float e = __half2float(__float2half_rn(erfinvf(u)));
    return __float2half_rn(__fmul_rn(e, sqrt2));
  }
};

template <>
struct Convert<__nv_bfloat16> {
  __device__ static __nv_bfloat16 apply(uint32_t bits, float lo, float span, float sqrt2, bool normal) {
    const uint16_t m = static_cast<uint16_t>(((bits & 0xFFu) >> 1) | 0x3F80u);
    const float f = __bfloat162float(__ushort_as_bfloat16(m)) - 1.0f;
    const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(f, span)));
    float u = __bfloat162float(__float2bfloat16_rn(__fadd_rn(p, lo)));
    u = fmaxf(lo, u);
    if (!normal) return __float2bfloat16_rn(u);
    const float e = __bfloat162float(__float2bfloat16_rn(erfinvf(u)));
    return __float2bfloat16_rn(__fmul_rn(e, sqrt2));
  }
};

template <typename T, int VEC>
__global__ void rng_draw_kernel(const long long* __restrict__ key, int fold, uint32_t salt, T* __restrict__ out,
                                long long n, float lo, float span, float sqrt2, int normal) {
  // fold_in(key, salt) = threefry2x32(key, (0, salt)), once a thread.
  uint32_t k0 = static_cast<uint32_t>(key[0]), k1 = static_cast<uint32_t>(key[1]);
  if (fold) {
    uint32_t x0 = 0u, x1 = salt;
    threefry2x32(k0, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  }
  const long long groups = (n + VEC - 1) / VEC;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long base = g * VEC;
    alignas(16) T vals[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const long long i = base + j;
      uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
      uint32_t x1 = static_cast<uint32_t>(i);
      threefry2x32(k0, k1, x0, x1);
      vals[j] = Convert<T>::apply(x0 ^ x1, lo, span, sqrt2, normal != 0);
    }
    if (base + VEC <= n) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(vals);
    } else {
      for (int j = 0; base + j < n; ++j) out[base + j] = vals[j];
    }
  }
}

template <typename T>
int launch(const long long* key, int fold, uint32_t salt, void* out, long long n, float lo, float span, float sqrt2,
           int normal, int sms, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int THREADS = 256;
  const long long groups = (n + VEC - 1) / VEC;
  const long long want = (groups + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  rng_draw_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(key, fold, salt, static_cast<T*>(out), n, lo, span,
                                                          sqrt2, normal);
  return thunder::launch_status();
}

}  // namespace

// out (16-byte aligned, n elements of `dtype`) <- the draw from
// fold_in(key, salt), or from key itself when `fold` is 0. lo, span and sqrt2
// are values of `dtype` (the wrapper rounds them), passed as floats.
extern "C" int thunder_rng_draw(const void* key, int fold, unsigned int salt, void* out, long long n, int dtype,
                                int normal, float lo, float span, float sqrt2, int sms, void* stream) {
  const long long* k = static_cast<const long long*>(key);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case thunder::kF32:
      return launch<float>(k, fold, salt, out, n, lo, span, sqrt2, normal, sms, s);
    case thunder::kF16:
      return launch<__half>(k, fold, salt, out, n, lo, span, sqrt2, normal, sms, s);
    case thunder::kBF16:
      return launch<__nv_bfloat16>(k, fold, salt, out, n, lo, span, sqrt2, normal, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
