// Cross-entropy forward, per-row loss, for sm_90a.
//
// Replaces the TPU kernel thunder_tpu/executors/pallasex.py `_ce_fwd_kernel`
// (launched by `_ce_impl` through `_ce_call`).
//
// What it computes: loss[n] = logsumexp(x[n, :]) - x[n, target[n]] in f32,
//   and 0 where target[n] == ignore_index. A target outside [0, V) that is
//   not ignore_index gives NaN. logits (N, V) are f32 or bf16 with a row
//   stride and contiguous rows; targets are int32 or int64. The Python
//   wrapper takes the sum and divides by max(#valid, 1) for the mean.
//
// Bound on an H100: bytes. One read of the logits: at (4096, 32000) f32 that
//   is ~524 MB, ~0.16 ms at 3.35 TB/s. One exp per element is far below the
//   card's rate.
//
// Design: one block of 256 threads per row. The threads stride over V with
//   an online (max, sum of exp) pair, so the row is read once; loads are 4
//   elements wide where V, the stride and the pointer allow. The pairs are
//   merged across the warp with shuffles, then across warps in shared memory,
//   and thread 0 picks x[target] and writes the loss.

#include "common.cuh"

using thunder::to_float;

namespace {

constexpr int NTHREADS = 256;

struct MaxSum {
  float m;
  float s;
};

__device__ __forceinline__ void update(MaxSum& a, float v) {
  if (v > a.m) {
    a.s = a.s * expf(a.m - v) + 1.f;
    a.m = v;
  } else {
    a.s += v == -INFINITY ? 0.f : expf(v - a.m);
  }
}

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

template <typename T, typename I, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    ce_fwd_kernel(const T* __restrict__ logits, const I* __restrict__ targets,
                  float* __restrict__ loss, int V, long long row_stride, long long ignore_index) {
  const int row = blockIdx.x;
  const T* x = logits + row * row_stride;
  MaxSum acc = {-INFINITY, 0.f};
  if (VEC == 4) {
    for (int j = threadIdx.x * 4; j < V; j += NTHREADS * 4) {
      float v[4];
      load4(x + j, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) update(acc, v[e]);
    }
  } else {
    for (int j = threadIdx.x; j < V; j += NTHREADS) update(acc, to_float(x[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum o = {__shfl_xor_sync(0xffffffffu, acc.m, off), __shfl_xor_sync(0xffffffffu, acc.s, off)};
    acc = merge(acc, o);
  }
  __shared__ MaxSum partial[NTHREADS / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) partial[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    MaxSum tot = partial[0];
    for (int w = 1; w < NTHREADS / 32; ++w) tot = merge(tot, partial[w]);
    const long long t = static_cast<long long>(targets[row]);
    float out;
    if (t == ignore_index) {
      out = 0.f;
    } else if (t < 0 || t >= V) {
      out = NAN;
    } else {
      out = tot.m + logf(tot.s) - to_float(x[t]);
    }
    loss[row] = out;
  }
}

template <typename T, typename I>
int launch(const void* logits, const void* targets, float* loss, int N, int V, long long stride,
           long long ignore_index, int vec4, cudaStream_t stream) {
  if (N == 0) return 0;
  const T* x = static_cast<const T*>(logits);
  const I* t = static_cast<const I*>(targets);
  if (vec4)
    ce_fwd_kernel<T, I, 4><<<N, NTHREADS, 0, stream>>>(x, t, loss, V, stride, ignore_index);
  else
    ce_fwd_kernel<T, I, 1><<<N, NTHREADS, 0, stream>>>(x, t, loss, V, stride, ignore_index);
  return thunder::launch_status();
}

}  // namespace

extern "C" int thunder_ce_fwd(const void* logits, const void* targets, float* loss, int N, int V,
                              long long row_stride, int dtype, int target_is_int64,
                              long long ignore_index, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == thunder::kF32) {
    return target_is_int64
               ? launch<float, long long>(logits, targets, loss, N, V, row_stride, ignore_index, vec4, s)
               : launch<float, int>(logits, targets, loss, N, V, row_stride, ignore_index, vec4, s);
  }
  if (dtype == thunder::kBF16) {
    return target_is_int64
               ? launch<__nv_bfloat16, long long>(logits, targets, loss, N, V, row_stride,
                                                  ignore_index, vec4, s)
               : launch<__nv_bfloat16, int>(logits, targets, loss, N, V, row_stride, ignore_index,
                                            vec4, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
