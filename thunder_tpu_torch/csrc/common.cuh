// Shared helpers for the port's CUDA kernels (built for sm_90a by
// thunder_tpu_torch/executors/_build.py into one shared library with a plain
// C interface, loaded with ctypes).
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace thunder {

// The dtype codes the Python wrappers pass (executors/_build.py DTYPE_CODES).
enum DType : int { kBF16 = 0, kF16 = 1, kF32 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// Launch status for the Python side: the refusal of a launch (too many
// threads, too much shared memory) shows only here, not at a later sync.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace thunder
