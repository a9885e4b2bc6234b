// RMSNorm and LayerNorm over the last dim, forward and backward, for sm_90a.
//
// Replaces the TPU kernels of the opt-in "norm" executor,
// thunder_tpu/executors/pallasex.py `_rms_fwd_kernel` (launched by
// `_rms_impl`), `_rms_bwd_kernel` (`_rms_bwd_impl`), `_ln_fwd_kernel`
// (`_ln_impl`) and `_ln_bwd_kernel` (`_ln_bwd_impl`).
//
// What it computes, on rows x (N, D) with a weight w (D,) and, for LayerNorm,
//   an optional bias b (D,), all of one type (bf16, f16 or f32); everything
//   in f32, each output rounded once:
//   forward  RMS: y = x * rstd * w,              rstd = rsqrt(mean(x^2) + eps)
//            LN:  y = (x - mu) * rstd * w + b,    rstd = rsqrt(mean((x - mu)^2) + eps)
//            (two passes: the mean first, then the centred squares);
//   backward from g (N, D), recomputing mu and rstd from x (nothing is saved):
//            xhat = (x - mu) * rstd, wg = g * w,
//            dx = rstd * (wg - m1 - xhat * m2), m2 = mean(wg * xhat),
//            m1 = mean(wg) for LN and 0 for RMS;
//            each block writes its f32 column sums of g * xhat (dw) and, for
//            LN, of g (db) over its rows into a (n_blocks, D) buffer; the
//            Python wrapper sums the buffer once (as the JAX package sums its
//            per-block partials outside the kernel) and casts to w's type.
//
// Bound on an H100: bytes. The forward reads x and writes y once: at
//   open_llama_3b's (4096, 3200) bf16 that is 52.4 MB, 15.6 us at 3.35 TB/s;
//   pythia-410m's (4096, 1024) 16.8 MB, 5.0 us. The backward reads g and x
//   and writes dx: 78.6 MB (23.5 us) and 25.2 MB (7.5 us). The arithmetic,
//   a few operations per element, is far below the card's rate.
//
// Design: the forward runs one block of 256 threads per row. The backward
//   runs one block per run of consecutive rows (rows_per_block, chosen by the
//   wrapper so that there are about 256 blocks), so that the f32 column
//   partials cost one (n_blocks, D) buffer rather than one row per row. Each
//   thread owns the same columns of every row, so the row cached in shared
//   memory as f32 (x, and g in the backward) and the column accumulators
//   need no synchronisation: only the block sums do (warp shuffles, then the
//   warps' sums read in one order by every thread). Loads and stores are 16
//   bytes wide where D and the pointers allow, one element otherwise. No
//   atomics: the same inputs give the same bits on every run.

#include "common.cuh"

using thunder::from_float;
using thunder::to_float;

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float out[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16-byte vectors only");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_float(v[e]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float in[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(in[0]);
  } else {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = from_float<T>(in[e]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The sum of v over the block, the same bits in every thread: the xor
// butterfly leaves every lane of a warp with the same sum, and every thread
// adds the warps' sums in one order. `red` is NWARPS floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // a previous call may still be reading red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) total += red[w];
  return total;
}

// (mu, rstd) of the row cached in xs (mu = 0 for RMS). `partial` is this
// thread's sum of x (LN) or x^2 (RMS) over its columns.
template <int VEC, bool LN>
__device__ __forceinline__ float2 row_stats(const float* xs, float partial, int D, float eps, float* red) {
  const int nchunk = D / VEC;
  if (!LN) return make_float2(0.f, rsqrtf(block_sum(partial, red) / D + eps));
  const float mu = block_sum(partial, red) / D;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = xs[c * VEC + e] - mu;
      s2 += d * d;
    }
  }
  return make_float2(mu, rsqrtf(block_sum(s2, red) / D + eps));
}

template <typename T, int VEC, bool LN>
__global__ void __launch_bounds__(NTHREADS)
    norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    T* __restrict__ y, int D, float eps) {
  extern __shared__ float xs[];  // D floats: this row of x in f32
  __shared__ float red[NWARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const int nchunk = D / VEC;

  float partial = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
    float v[VEC];
    load_vec<T, VEC>(xr + c * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      xs[c * VEC + e] = v[e];
      partial += LN ? v[e] : v[e] * v[e];
    }
  }
  const float2 st = row_stats<VEC, LN>(xs, partial, D, eps, red);

  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
    float wv[VEC], bv[VEC], out[VEC];
    load_vec<T, VEC>(w + c * VEC, wv);
    if (LN && b != nullptr) load_vec<T, VEC>(b + c * VEC, bv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      out[e] = (xs[c * VEC + e] - st.x) * st.y * wv[e];
      if (LN && b != nullptr) out[e] += bv[e];
    }
    store_vec<T, VEC>(yr + c * VEC, out);
  }
}

template <typename T, int VEC, bool LN>
__global__ void __launch_bounds__(NTHREADS)
    norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ dx, float* __restrict__ dw_part, float* __restrict__ db_part, int N,
                    int D, int rows_per_block, float eps) {
  // xs: the row of x, then of xhat; gs: the row of g; dw_acc, db_acc (LN):
  // this block's column sums. D floats each, in f32.
  extern __shared__ float smem[];
  float* xs = smem;
  float* gs = smem + D;
  float* dw_acc = smem + 2 * D;
  float* db_acc = smem + 3 * D;
  __shared__ float red[NWARPS];
  const int nchunk = D / VEC;

  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      dw_acc[c * VEC + e] = 0.f;
      if (LN) db_acc[c * VEC + e] = 0.f;
    }
  }

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, N);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + static_cast<long long>(row) * D;
    const T* gr = g + static_cast<long long>(row) * D;
    T* dxr = dx + static_cast<long long>(row) * D;

    float partial = 0.f;
    for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
      float xv[VEC], gv[VEC];
      load_vec<T, VEC>(xr + c * VEC, xv);
      load_vec<T, VEC>(gr + c * VEC, gv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xs[c * VEC + e] = xv[e];
        gs[c * VEC + e] = gv[e];
        partial += LN ? xv[e] : xv[e] * xv[e];
      }
    }
    const float2 st = row_stats<VEC, LN>(xs, partial, D, eps, red);

    float a1 = 0.f, a2 = 0.f;
    for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
      float wv[VEC];
      load_vec<T, VEC>(w + c * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = c * VEC + e;
        const float xhat = (xs[i] - st.x) * st.y;
        const float wg = gs[i] * wv[e];
        xs[i] = xhat;
        a1 += wg;
        a2 += wg * xhat;
      }
    }
    const float m2 = block_sum(a2, red) / D;
    const float m1 = LN ? block_sum(a1, red) / D : 0.f;

    for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
      float wv[VEC], out[VEC];
      load_vec<T, VEC>(w + c * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = c * VEC + e;
        const float xhat = xs[i];
        out[e] = st.y * (gs[i] * wv[e] - m1 - xhat * m2);
        dw_acc[i] += gs[i] * xhat;
        if (LN) db_acc[i] += gs[i];
      }
      store_vec<T, VEC>(dxr + c * VEC, out);
    }
  }

  float* dwr = dw_part + static_cast<long long>(blockIdx.x) * D;
  float* dbr = LN && db_part != nullptr ? db_part + static_cast<long long>(blockIdx.x) * D : nullptr;
  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      dwr[c * VEC + e] = dw_acc[c * VEC + e];
      if (dbr != nullptr) dbr[c * VEC + e] = db_acc[c * VEC + e];
    }
  }
}

// Above 48 KB a kernel's dynamic shared memory must be asked for.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, bool LN>
int launch_fwd(const void* x, const void* w, const void* b, void* y, int N, int D, float eps, int vec,
               cudaStream_t stream) {
  if (N == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  auto kernel = vec ? norm_fwd_kernel<T, V, LN> : norm_fwd_kernel<T, 1, LN>;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<N, NTHREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                        static_cast<const T*>(b), static_cast<T*>(y), D, eps);
  return thunder::launch_status();
}

template <typename T, bool LN>
int launch_bwd(const void* g, const void* x, const void* w, void* dx, float* dw_part, float* db_part, int N,
               int D, int rows_per_block, float eps, int vec, cudaStream_t stream) {
  if (N == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  auto kernel = vec ? norm_bwd_kernel<T, V, LN> : norm_bwd_kernel<T, 1, LN>;
  const size_t smem = static_cast<size_t>(LN ? 4 : 3) * D * sizeof(float);
  if (int err = allow_smem(kernel, smem)) return err;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, NTHREADS, smem, stream>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                                             static_cast<const T*>(w), static_cast<T*>(dx), dw_part, db_part,
                                             N, D, rows_per_block, eps);
  return thunder::launch_status();
}

template <bool LN>
int dispatch_fwd(const void* x, const void* w, const void* b, void* y, int N, int D, float eps, int dtype,
                 int vec, cudaStream_t s) {
  switch (dtype) {
    case thunder::kBF16: return launch_fwd<__nv_bfloat16, LN>(x, w, b, y, N, D, eps, vec, s);
    case thunder::kF16: return launch_fwd<__half, LN>(x, w, b, y, N, D, eps, vec, s);
    case thunder::kF32: return launch_fwd<float, LN>(x, w, b, y, N, D, eps, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool LN>
int dispatch_bwd(const void* g, const void* x, const void* w, void* dx, float* dw_part, float* db_part, int N,
                 int D, int rows_per_block, float eps, int dtype, int vec, cudaStream_t s) {
  switch (dtype) {
    case thunder::kBF16:
      return launch_bwd<__nv_bfloat16, LN>(g, x, w, dx, dw_part, db_part, N, D, rows_per_block, eps, vec, s);
    case thunder::kF16:
      return launch_bwd<__half, LN>(g, x, w, dx, dw_part, db_part, N, D, rows_per_block, eps, vec, s);
    case thunder::kF32:
      return launch_bwd<float, LN>(g, x, w, dx, dw_part, db_part, N, D, rows_per_block, eps, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// layer_norm = 0: RMSNorm (b is ignored); 1: LayerNorm (b may be null).
extern "C" int thunder_norm_fwd(const void* x, const void* w, const void* b, void* y, int N, int D, float eps,
                                int layer_norm, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layer_norm ? dispatch_fwd<true>(x, w, b, y, N, D, eps, dtype, vec, s)
                    : dispatch_fwd<false>(x, w, nullptr, y, N, D, eps, dtype, vec, s);
}

// db_part is written for LayerNorm when it is not null.
extern "C" int thunder_norm_bwd(const void* g, const void* x, const void* w, void* dx, float* dw_part,
                                float* db_part, int N, int D, int rows_per_block, float eps, int layer_norm,
                                int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layer_norm ? dispatch_bwd<true>(g, x, w, dx, dw_part, db_part, N, D, rows_per_block, eps, dtype, vec, s)
                    : dispatch_bwd<false>(g, x, w, dx, dw_part, nullptr, N, D, rows_per_block, eps, dtype, vec, s);
}
