// The int8 linear's product on the `mma.sync` route: out[m, n] =
// cast(float(sum_k qa[m, k] * qw[n, k]) * s[n] (+ bias[n])).
//
// The route for operands TMA cannot describe (K % 16 != 0, or a base not
// 16-byte aligned): `executors/quantex.py` sends every other call to the
// `wgmma`/TMA kernel of int8_gemm.cu, which it replaces on the main path, and
// decides from the shapes and pointers before the launch. Both replace the
// int8 x int8 -> int32 `lax.dot_general` of the JAX package's quantized linear
// (thunder_tpu/executors/quantex.py:134-137, `_quant_linear_impl`) with its
// rescale and bias (:139-142) fused into the store.
//
// Bound: at open_llama_3b's products (M = 4096, K = 3200 or 8640, N = 3200 to
// 32000) 2*M*N*K operations at 1,979 TOP/s int8 dense outweigh the bytes
// (each operand read once, the output written once) at 3.35 TB/s, so the
// tensor cores bound it. This design reaches a fifth of that bound at qkv
// (PERF.md): a 128 x 128 block tile, K in steps of 64 bytes, a ring of
// four stages of shared memory filled by 16-byte `cp.async` copies, eight
// warps of `mma.sync.m16n8k32.s8.s8.s32` with the int32 sums in registers
// (a warp owns 64 x 32 of the tile). Both
// operands have K innermost, the layout `row.col` asks for, so a fragment is
// one `ldmatrix` of shared memory rows padded to 80 bytes (no bank
// conflicts): four 8 x 16-byte matrices give a 16 x 32 fragment of A, or the
// 8 x 32 fragments of B for two n-tiles.
// Problems (vmap's batching rule): gridDim.z runs P products, each block
// offsetting qa, qw, scale, bias and out to its own problem (a step of 0
// for what the problems share); one problem is the plain product.
// A row, a column or a K step past the end is zero-filled by the copy's
// `src-size`; where K is not a multiple of 16 (rows not 16-byte aligned) the
// tile is read byte by byte instead, zeros past K. The int32 sums are exact,
// and the epilogue is one rounding multiply and one rounding add in f32, so
// the result has the bits of the plain version (executors/quantex.py).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int ROW = 80;  // bytes a tile row takes in shared memory: BK plus 16 of padding
constexpr int THREADS = 256;
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = (BM + BN) * ROW;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 81,920: dynamic shared memory, above the static 48 KB

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One 128 x 64-byte tile of a K-innermost int8 matrix (rows `rows`, K `K`)
// into shared memory: 512 chunks of 16 bytes, two a thread.
template <bool kAligned>
__device__ __forceinline__ void load_tile(int8_t* smem, const int8_t* g, int row0, int rows, int k0, int K) {
#pragma unroll
  for (int c = threadIdx.x; c < BM * BK / 16; c += THREADS) {
    const int r = c >> 2, kc = (c & 3) * 16;
    const int row = row0 + r, k = k0 + kc;
    int8_t* dst = smem + r * ROW + kc;
    if (kAligned) {
      const bool ok = row < rows && k < K;  // K % 16 == 0: a chunk is all in or all out
      cp_async16(dst, ok ? g + static_cast<long long>(row) * K + k : g, ok ? 16 : 0);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (row < rows) {
        const int8_t* src = g + static_cast<long long>(row) * K;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (k + j < K) w[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(src[k + j])) << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Four 8 x 8 matrices of 16-bit words (8 rows of 16 bytes each) from shared
// memory; lane l gives the address of row l % 8 of matrix l / 8, and each
// lane gets, of each matrix, 4 bytes of row lane / 4: the int8 fragment
// layout of mma.m16n8k32.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const int8_t* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kAligned, typename T>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(const int8_t* __restrict__ qa, const int8_t* __restrict__ qw,
                                                            const float* __restrict__ scale,
                                                            const float* __restrict__ bias, T* __restrict__ out, int M,
                                                            int N, int K, long long a_step, long long w_step,
                                                            int s_step, int bias_step) {
  extern __shared__ __align__(16) int8_t smem[];
  qa += blockIdx.z * a_step;
  qw += blockIdx.z * w_step;
  scale += blockIdx.z * s_step;
  if (bias != nullptr) bias += blockIdx.z * bias_step;
  out += static_cast<long long>(blockIdx.z) * M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // the warp's 64 x 32 of the tile
  const int g = lane >> 2;
  // ldmatrix: this lane's row (lane % 8) of matrix lane / 8.
  const int lm = lane >> 3, lr = lane & 7;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int steps = (K + BK - 1) / BK;
  // The ring: stage s holds K step s % STAGES; a commit group is made for
  // every step, empty past the end, so that wait_group counts steps.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      load_tile<kAligned>(smem + s * STAGE_BYTES, qa, m0, M, s * BK, K);
      load_tile<kAligned>(smem + s * STAGE_BYTES + BM * ROW, qw, n0, N, s * BK, K);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed, and every warp is done with step s - 1's stage
    const int next = s + STAGES - 1;
    if (next < steps) {
      int8_t* st = smem + (next % STAGES) * STAGE_BYTES;
      load_tile<kAligned>(st, qa, m0, M, next * BK, K);
      load_tile<kAligned>(st + BM * ROW, qw, n0, N, next * BK, K);
    }
    cp_async_commit();
    const int8_t* A = smem + (s % STAGES) * STAGE_BYTES;
    const int8_t* B = A + BM * ROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Matrices: rows 0-7 and 8-15 of the 16-row tile, bytes 0-15, then 16-31.
        ldmatrix_x4(a[i], A + (wm + i * 16 + (lm & 1) * 8 + lr) * ROW + kk + (lm >> 1) * 16);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        // Matrices: n-tile j bytes 0-15 and 16-31, then n-tile j + 1.
        unsigned r[4];
        ldmatrix_x4(r, B + (wn + (j + (lm >> 1)) * 8 + lr) * ROW + kk + (lm & 1) * 16);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // The epilogue: float(sum) * s[n] (+ bias[n]), each rounded in f32 as the
  // plain version rounds it, then to the output's type.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + j * 8 + (lane & 3) * 2 + e;
      if (n >= N) continue;
      const float sn = scale[n];
      const float bn = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + i * 16 + g + h * 8;
          if (m >= M) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), sn);
          if (bias != nullptr) v = __fadd_rn(v, bn);
          out[static_cast<long long>(m) * N + n] = thunder::from_float<T>(v);
        }
      }
    }
  }
}

template <typename T>
int launch(const int8_t* qa, const int8_t* qw, const float* scale, const float* b, void* out, int M, int N, int K,
           int aligned, int P, int a_shared, int w_shared, int s_step, int bias_step, cudaStream_t stream) {
  if (P < 1 || P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, P);
  T* o = static_cast<T*>(out);
  auto kernel = aligned ? int8_gemm_kernel<true, T> : int8_gemm_kernel<false, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(qa, qw, scale, b, o, M, N, K,
                                                a_shared ? 0 : static_cast<long long>(M) * K,
                                                w_shared ? 0 : static_cast<long long>(N) * K, s_step, bias_step);
  return thunder::launch_status();
}

}  // namespace

// P problems as in thunder_int8_gemm: qa (P, M, K) or shared (M, K), qw
// (P, N, K) or shared (N, K), int8, K innermost; scale and bias (or null)
// f32 with problem p's N values at p * s_step and p * bias_step; out (P, M,
// N). `aligned`: K % 16 == 0 and both bases 16-byte aligned (the wrapper
// decides).
extern "C" int thunder_int8_gemm_sync(const void* qa, const void* qw, const void* scale, const void* bias, void* out,
                                 int M, int N, int K, int dtype, int aligned, int P, int a_shared, int w_shared,
                                 int s_step, int bias_step, void* stream) {
  const int8_t* a = static_cast<const int8_t*>(qa);
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case thunder::kF32:
      return launch<float>(a, w, s, b, out, M, N, K, aligned, P, a_shared, w_shared, s_step, bias_step, st);
    case thunder::kF16:
      return launch<__half>(a, w, s, b, out, M, N, K, aligned, P, a_shared, w_shared, s_step, bias_step, st);
    case thunder::kBF16:
      return launch<__nv_bfloat16>(a, w, s, b, out, M, N, K, aligned, P, a_shared, w_shared, s_step, bias_step, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
