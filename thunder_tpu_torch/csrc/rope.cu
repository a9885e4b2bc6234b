// Rotary position embedding (rotate-half, full rotary) for sm_90a.
//
// Replaces the TPU kernel thunder_tpu/executors/pallasex.py `_rope_kernel`
// (launched by `_rope_impl`).
//
// What it computes: out = x * cos + [-x2, x1] * sin, where x1 and x2 are the
//   two halves of each head row. x (B, H, T, D) may be a strided view (last
//   dim contiguous), as the q/k slices of the fused qkv projection are;
//   cos/sin (T, D) are contiguous; out (B, H, T, D) is contiguous. All one
//   dtype (bf16, f16 or f32). Each output is computed in f32 and rounded once.
//
// Bound on an H100: bytes. One read of x and one write of out (cos/sin are
//   T*D and stay in L2): at (2, 32, 2048, 100) bf16 that is ~53 MB, ~16 us at
//   3.35 TB/s. There are 3 FLOP per output, far below the card's ratio.
//
// Design: one thread per (row, d) pair with d < D/2: it reads x[d] and
//   x[d + D/2] and writes both outputs, so every element is read and written
//   once. Neighbouring threads take neighbouring d, so loads and stores of
//   a row coalesce; the grid strides over all B*H*T*D/2 pairs.

#include "common.cuh"

using thunder::from_float;
using thunder::to_float;

namespace {

template <typename T>
__global__ void rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t,
                            const T* __restrict__ sin_t, T* __restrict__ out, int H, int T_len,
                            int D, long long sb, long long sh, long long st, long long npairs) {
  const int half = D / 2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < npairs;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / half;
    const int d = static_cast<int>(i - row * half);
    const int t = static_cast<int>(row % T_len);
    const long long bh = row / T_len;
    const int h = static_cast<int>(bh % H);
    const long long b = bh / H;
    const T* xr = x + b * sb + h * sh + t * st;
    const T* cr = cos_t + static_cast<long long>(t) * D;
    const T* sr = sin_t + static_cast<long long>(t) * D;
    const float x1 = to_float(xr[d]);
    const float x2 = to_float(xr[d + half]);
    T* orow = out + row * D;
    orow[d] = from_float<T>(x1 * to_float(cr[d]) - x2 * to_float(sr[d]));
    orow[d + half] = from_float<T>(x2 * to_float(cr[d + half]) + x1 * to_float(sr[d + half]));
  }
}

template <typename T>
int launch(const void* x, const void* c, const void* s, void* out, int B, int H, int T_len, int D,
           long long sb, long long sh, long long st, cudaStream_t stream) {
  const long long npairs = static_cast<long long>(B) * H * T_len * (D / 2);
  if (npairs == 0) return 0;
  const int threads = 256;
  const long long want = (npairs + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  rope_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), static_cast<const T*>(s),
      static_cast<T*>(out), H, T_len, D, sb, sh, st, npairs);
  return thunder::launch_status();
}

}  // namespace

extern "C" int thunder_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int B,
                            int H, int T_len, int D, long long sb, long long sh, long long st,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case thunder::kBF16:
      return launch<__nv_bfloat16>(x, cos_t, sin_t, out, B, H, T_len, D, sb, sh, st, s);
    case thunder::kF16:
      return launch<__half>(x, cos_t, sin_t, out, B, H, T_len, D, sb, sh, st, s);
    case thunder::kF32:
      return launch<float>(x, cos_t, sin_t, out, B, H, T_len, D, sb, sh, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
