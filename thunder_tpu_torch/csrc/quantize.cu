// The int8 linear's quantization, fused: q = clamp(round_half_even(x / s), -127, 127)
// with s = max(amax, 1e-6) / qmax, amax per row (weights) or over the whole
// tensor (activations).
//
// Replaces the XLA fusions of the JAX package's `_quantize_per_channel` and
// `_quantize_per_tensor` (thunder_tpu/executors/quantex.py:101-119), which
// `_quant_linear_impl` runs on f32 copies of its operands (:130-133).
//
// Bound: bytes. Each input element is read once in its own type (no f32
// copy) and each int8 written once; the arithmetic is a few operations an
// element. The design:
// - `quantize_rows_kernel`: one block a row. The threads read the row as
//   16-byte vectors and keep up to CACHE of them in registers, take amax by
//   a warp reduction and shared memory, then quantize from the registers
//   (a row longer than the cache re-reads only its tail, from L2).
// - `amax_kernel` then `quantize_tensor_kernel`: a grid-stride amax that
//   ends in one `atomicMax` a block on the bit pattern of |x| (non-negative
//   floats order as their bits; a NaN's bits order above +inf, so a NaN
//   propagates as torch.amax and jnp.max propagate it), into a word that the
//   entry point zeroes with a memset on the same stream first, so that a
//   replayed CUDA graph starts from 0 too; then a grid-stride quantization
//   that reads the max.
// - Segments (vmap's batching rule, executors/batching.py): the tensor may
//   be `segs` equal runs of elements, one a vmapped slice, each with its own
//   amax word and scale: blockIdx.y is the segment, and its blocks walk only
//   its run. The max is exact whatever the order, so each segment's scale
//   and bits are those of the unbatched call on that slice; one segment is
//   the per-tensor call as before.
// Bits: the scale and each quotient are one correctly rounded division
// (`__fdiv_rn`, not a product with a reciprocal), `rintf` rounds half to
// even, and the build uses no fast math, so q and s have the bits of the
// plain versions (executors/quantex.py), which are the JAX package's.
// `fault_reciprocal` swaps both divisions for products with the divisor's
// reciprocal: a planted fault for the card's checks, never set by the
// wrapper.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TENSOR_THREADS = 256;
constexpr int CACHE = 8;  // 16-byte vectors of its row a thread keeps in registers
constexpr unsigned F32_INF_BITS = 0x7f800000u;

template <typename T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int i) {
  return thunder::to_float(reinterpret_cast<const T*>(&u)[i]);
}

template <typename T>
__device__ __forceinline__ unsigned vec_amax(const uint4& u) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < kVecElems<T>; ++i) m = max(m, abs_bits(elem<T>(u, i)));
  return m;
}

// max(amax, 1e-6) / qmax; a NaN max stays NaN, as torch.clamp_min keeps it.
template <bool kRecip>
__device__ __forceinline__ float scale_of(unsigned amax_bits, float qmax) {
  const float amax = __uint_as_float(amax_bits);
  const float m = amax_bits > F32_INF_BITS ? amax : fmaxf(amax, 1e-6f);
  return kRecip ? __fmul_rn(m, __frcp_rn(qmax)) : __fdiv_rn(m, qmax);
}

// A NaN quotient gives 0, as the cast of a NaN float to int8 does.
template <bool kRecip>
__device__ __forceinline__ int quant(float x, float s) {
  const float v = rintf(kRecip ? __fmul_rn(x, __frcp_rn(s)) : __fdiv_rn(x, s));
  return v != v ? 0 : static_cast<int>(fminf(fmaxf(v, -127.f), 127.f));
}

// The 16 / sizeof(T) int8 values of one vector, as 8 or 4 bytes.
template <typename T, bool kRecip>
__device__ __forceinline__ void store_vec(int8_t* q, const uint4& u, float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < kVecElems<T>; ++i)
    w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant<kRecip>(elem<T>(u, i), s))) << (8 * (i % 4));
  if constexpr (kVecElems<T> == 8) {
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(q) = w[0];
  }
}

// The block's max of `m` (every thread gets it); `red` holds a word a warp.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* red) {
  m = __reduce_max_sync(0xffffffffu, m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

// One block a row of an (rows, K) matrix with row stride `ld` (elements).
// kVec: K and `ld` hold whole 16-byte vectors and the base is 16-byte aligned.
template <typename T, bool kVec, bool kRecip>
__global__ void quantize_rows_kernel(const T* __restrict__ x, long long ld, int K, float qmax,
                                     int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ unsigned red[32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * ld;
  int8_t* qr = q + static_cast<long long>(blockIdx.x) * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned m = 0;
  if constexpr (kVec) {
    constexpr int V = kVecElems<T>;
    const int nv = K / V;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4 cache[CACHE];
#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
      const int v = tid + i * nt;
      if (v < nv) {
        cache[i] = xv[v];
        m = max(m, vec_amax<T>(cache[i]));
      }
    }
    for (int v = tid + CACHE * nt; v < nv; v += nt) m = max(m, vec_amax<T>(xv[v]));
    const float s = scale_of<kRecip>(block_max(m, red), qmax);
    if (tid == 0) scale[blockIdx.x] = s;
#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
      const int v = tid + i * nt;
      if (v < nv) store_vec<T, kRecip>(qr + v * V, cache[i], s);
    }
    for (int v = tid + CACHE * nt; v < nv; v += nt) store_vec<T, kRecip>(qr + v * V, xv[v], s);
  } else {
    for (int k = tid; k < K; k += nt) m = max(m, abs_bits(thunder::to_float(xr[k])));
    const float s = scale_of<kRecip>(block_max(m, red), qmax);
    if (tid == 0) scale[blockIdx.x] = s;
    for (int k = tid; k < K; k += nt) qr[k] = static_cast<int8_t>(quant<kRecip>(thunder::to_float(xr[k]), s));
  }
}

// Element i of an (rows, cols) matrix with row stride `ld`, as a pointer.
template <typename T>
__device__ __forceinline__ const T* at(const T* x, long long ld, long long cols, long long i) {
  return x + (i / cols) * ld + i % cols;
}

// Segment blockIdx.y holds elements [y * per, (y + 1) * per) of the
// (rows, cols) matrix in row-major order, per = rows * cols / gridDim.y.
template <typename T, bool kVec>
__global__ void __launch_bounds__(TENSOR_THREADS) amax_kernel(const T* __restrict__ x, long long ld, long long rows,
                                                              long long cols, unsigned* __restrict__ amax) {
  __shared__ unsigned red[32];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long per = rows * cols / gridDim.y, first = blockIdx.y * per;
  unsigned m = 0;
  if constexpr (kVec) {
    constexpr int V = kVecElems<T>;
    const long long nv = per / V;
    for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < nv; v += stride)
      m = max(m, vec_amax<T>(*reinterpret_cast<const uint4*>(at(x, ld, cols, first + v * V))));
  } else {
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < per; i += stride)
      m = max(m, abs_bits(thunder::to_float(*at(x, ld, cols, first + i))));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, m);
}

template <typename T, bool kVec, bool kRecip>
__global__ void __launch_bounds__(TENSOR_THREADS)
    quantize_tensor_kernel(const T* __restrict__ x, long long ld, long long rows, long long cols, float qmax,
                           const unsigned* __restrict__ amax, int8_t* __restrict__ q, float* __restrict__ scale) {
  const float s = scale_of<kRecip>(amax[blockIdx.y], qmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[blockIdx.y] = s;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long per = rows * cols / gridDim.y, first = blockIdx.y * per;
  if constexpr (kVec) {
    constexpr int V = kVecElems<T>;
    const long long nv = per / V;
    for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < nv; v += stride) {
      const long long i = first + v * V;
      store_vec<T, kRecip>(q + i, *reinterpret_cast<const uint4*>(at(x, ld, cols, i)), s);
    }
  } else {
    for (long long i = first + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < first + per;
         i += stride)
      q[i] = static_cast<int8_t>(quant<kRecip>(thunder::to_float(*at(x, ld, cols, i)), s));
  }
}

template <typename T, bool kVec, bool kRecip>
int launch_rows(const void* x, long long ld, int rows, int K, float qmax, void* q, void* scale, cudaStream_t st) {
  const int threads = K / kVecElems<T> > 1024 ? 256 : 128;
  quantize_rows_kernel<T, kVec, kRecip><<<rows, threads, 0, st>>>(static_cast<const T*>(x), ld, K, qmax,
                                                                   static_cast<int8_t*>(q), static_cast<float*>(scale));
  return thunder::launch_status();
}

template <typename T, bool kVec, bool kRecip>
int launch_tensor(const void* x, long long ld, long long rows, long long cols, float qmax, void* amax, void* q,
                  void* scale, int blocks, int segs, cudaStream_t st) {
  if (segs < 1 || segs > 65535 || (rows * cols) % segs != 0 || (kVec && (rows * cols / segs) % kVecElems<T> != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * segs, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  unsigned* a = static_cast<unsigned*>(amax);
  const dim3 grid(blocks, segs);
  amax_kernel<T, kVec><<<grid, TENSOR_THREADS, 0, st>>>(xt, ld, rows, cols, a);
  const int status = thunder::launch_status();
  if (status != 0) return status;
  quantize_tensor_kernel<T, kVec, kRecip><<<grid, TENSOR_THREADS, 0, st>>>(
      xt, ld, rows, cols, qmax, a, static_cast<int8_t*>(q), static_cast<float*>(scale));
  return thunder::launch_status();
}

template <typename T, template <typename, bool, bool> class Launch, typename... Args>
int dispatch_flags(int vec, int recip, Args... args) {
  if (vec) return recip ? Launch<T, true, true>::run(args...) : Launch<T, true, false>::run(args...);
  return recip ? Launch<T, false, true>::run(args...) : Launch<T, false, false>::run(args...);
}

template <typename T, bool kVec, bool kRecip>
struct Rows {
  static int run(const void* x, long long ld, int rows, int K, float qmax, void* q, void* scale, cudaStream_t st) {
    return launch_rows<T, kVec, kRecip>(x, ld, rows, K, qmax, q, scale, st);
  }
};

template <typename T, bool kVec, bool kRecip>
struct Tensor {
  static int run(const void* x, long long ld, long long rows, long long cols, float qmax, void* amax, void* q,
                 void* scale, int blocks, int segs, cudaStream_t st) {
    return launch_tensor<T, kVec, kRecip>(x, ld, rows, cols, qmax, amax, q, scale, blocks, segs, st);
  }
};

template <template <typename, bool, bool> class Launch, typename... Args>
int dispatch(int dtype, int vec, int recip, Args... args) {
  switch (dtype) {
    case thunder::kF32:
      return dispatch_flags<float, Launch>(vec, recip, args...);
    case thunder::kF16:
      return dispatch_flags<__half, Launch>(vec, recip, args...);
    case thunder::kBF16:
      return dispatch_flags<__nv_bfloat16, Launch>(vec, recip, args...);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (rows, K) of `dtype` with row stride `ld` elements, K innermost; q (rows,
// K) int8 contiguous; scale (rows,) f32. `vec`: K and `ld` are multiples of
// 16 / sizeof(dtype) and x is 16-byte aligned (the wrapper decides).
extern "C" int thunder_quantize_rows(const void* x, long long ld, int rows, int K, float qmax, int dtype, int vec,
                                     int fault_reciprocal, void* q, void* scale, void* stream) {
  return dispatch<Rows>(dtype, vec, fault_reciprocal, x, ld, rows, K, qmax, q, scale,
                        static_cast<cudaStream_t>(stream));
}

// x (rows, cols) as above, `segs` equal runs of elements in row-major order
// (one for a per-tensor scale; with `vec`, each run a whole number of
// 16-byte vectors); q (rows, cols) int8 contiguous; scale (segs,) f32; amax
// `segs` 32-bit words of scratch; `blocks` the blocks a segment in both
// launches.
extern "C" int thunder_quantize_tensor(const void* x, long long ld, long long rows, long long cols, float qmax,
                                       int dtype, int vec, int fault_reciprocal, void* amax, void* q, void* scale,
                                       int blocks, int segs, void* stream) {
  return dispatch<Tensor>(dtype, vec, fault_reciprocal, x, ld, rows, cols, qmax, amax, q, scale, blocks, segs,
                          static_cast<cudaStream_t>(stream));
}
