// The int8 linear's product: out[m, n] = cast(float(sum_k qa[m, k] * qw[n, k]) * s[n] (+ bias[n])).
//
// Replaces the int8 x int8 -> int32 `lax.dot_general` of the JAX package's
// quantized linear (thunder_tpu/executors/quantex.py:134-137,
// `_quant_linear_impl`) with its rescale and bias (:139-142) fused into the
// store.
//
// Bound: at open_llama_3b's products (M = 4096, K = 3200 or 8640, N = 3200 to
// 32000) 2*M*N*K operations at 1,979 TOP/s int8 dense outweigh the bytes
// (each operand read once, the output written once) at 3.35 TB/s, so the
// tensor cores bound it, and only `wgmma` reaches their full rate. The
// design, for Hopper:
// - A block computes 128 x 256 tiles of out with three warpgroups. The
//   first is the producer: after `setmaxnreg.dec` to 40 registers, one of
//   its threads keeps TMA loads in flight into a ring of four stages of
//   shared memory, each stage 128 rows of qa and 256 rows of qw by 128 bytes
//   of K (48 KB), both K-major with the 128-byte swizzle that `wgmma` reads.
//   Completion is counted on a `full` mbarrier a stage (bytes); the
//   consumers give a stage back on its `empty` mbarrier (two arrivals).
// - The other two warpgroups (`setmaxnreg.inc` to 232) each run four
//   `wgmma.mma_async.m64n256k32.s32.s8.s8` a stage on their 64 rows, both
//   operands from shared memory by descriptor, 128 int32 sums a thread in
//   registers. One group of products stays in flight while the next stage
//   is waited for: a stage is given back once the group after it is issued.
// - The grid is persistent, one block an SM: each block walks the tiles
//   blockIdx.x, + gridDim.x, ..., in groups of 16 tile rows (the order of
//   GROUP_M) so that qw is read from device memory about once a group, and
//   the producer fills the next tile's stages while the consumers store
//   this one's.
// - The epilogue runs from the registers: float(sum) * s[n] (+ bias[n]),
//   `__int2float_rn`, `__fmul_rn`, `__fadd_rn`, as the plain version rounds
//   them, staged through 16 KB of shared memory a consumer (256 bytes of
//   each of its 64 rows a pass) so that out is written in 16-byte runs of
//   whole rows, not in 4-byte pairs scattered over eight rows.
// - Problems (vmap's batching rule, executors/batching.py): one launch may
//   compute P products out[p] = qa[p] . qw[p]^T * s[p], an operand that the
//   slices share given once (a row step of 0). The persistent tile walk runs
//   over the P problems' tiles in turn; a tile's TMA boxes start at row
//   p * a_rows + m0 of qa's map and p * b_rows + n0 of qw's, and its
//   epilogue reads scale and bias row p and writes out[p]. A box that runs
//   past a problem's last row reads the next problem's rows into rows or
//   columns that are never stored. One problem is the plain product.
// The tensor maps are built on the host at each call (`cuTensorMapEncodeTiled`,
// reached through `cudaGetDriverEntryPoint`, so the library needs no -lcuda)
// and passed as `__grid_constant__` parameters, so a CUDA graph captures them
// with the launch. TMA zero-fills what lies past M, N and K (K = 8640 leaves
// half of the last stage empty), and the int32 sums are exact, so the result
// has the bits of the plain version (executors/quantex.py). TMA needs
// 16-byte-aligned bases and rows (K % 16 == 0): the wrapper sends any other
// call to the `mma.sync` kernel of int8_gemm_sync.cu.
#include <cstdint>

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 128;  // BK: bytes of K a stage, one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int GROUP_M = 16;  // tile rows a group of consecutive blocks sweeps N over
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 49,152
constexpr int THREADS = 384;                    // warpgroup 0 loads, 1 and 2 multiply
// A consumer's share of the epilogue's staging buffer: 64 rows of 256
// bytes (128 bf16/f16 columns or 64 f32 columns a pass).
constexpr int EPI_BYTES = 64 * 256;
// The ring (1024-byte aligned, as the 128-byte swizzle asks), the two
// staging buffers, then the barriers; 1 KB of slack to align the dynamic
// shared memory's base. 230,464 bytes of the 232,448 a block may have.
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * EPI_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 2-D tensor map (coordinates: K byte, row) into shared memory,
// completing on `bar`; what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k), "r"(row)
      : "memory");
}

// The shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (the stride byte offset);
// the leading byte offset is unused for this layout. Adding 2 steps the
// start 32 bytes (one k32 slice) along K inside the swizzle row.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (static_cast<uint64_t>(smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// Keep the compiler from moving reads or writes of the sums across the
// asynchronous products.
__device__ __forceinline__ void fence_sums(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256, int32) += a (64 x 32 bytes) . b (256 x 32 bytes)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Two neighbouring outputs, each rounded to nearest even as from_float rounds.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// The byte offset of (row, byte) in a staging buffer of 256-byte rows, its
// 16-byte units swizzled by the row (unit ^ row % 8): the eight rows a warp
// writes at once, and the 16 units a row is read in, fall in distinct banks.
__device__ __forceinline__ int epi_offset(int row, int byte) {
  return row * 256 + ((((byte >> 4) ^ row) & 7) | ((byte >> 4) & 8)) * 16 + (byte & 15);
}

// Tile `tile` of the grouped order: the problem `p` it belongs to, then,
// inside it, consecutive tiles take GROUP_M tile rows by one tile column,
// then the next column, so that the qa rows of a group stay in L2 while qw
// streams through once a group (not once a tile row).
__device__ __forceinline__ void tile_origin(int tile, int M, int N, int& p, int& m0, int& n0) {
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  p = tile / (tiles_m * tiles_n);
  tile -= p * tiles_m * tiles_n;
  const int first_m = tile / (GROUP_M * tiles_n) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M), in_group = tile % (GROUP_M * tiles_n);
  m0 = (first_m + in_group % group_m) * BM;
  n0 = in_group / group_m * BN;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                           const float* __restrict__ scale, const float* __restrict__ bias, T* __restrict__ out,
                           int M, int N, int K, int P, int a_rows, int b_rows, int s_step, int bias_step) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* epi = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * EPI_BYTES);
  uint64_t* empty = full + STAGES;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN) * P;
  const int steps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the same tiles (blockIdx.x, then every gridDim.x-th) and
  // count K steps across them (`it`), which picks the stage and its phase.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int p, m0, n0;
        tile_origin(tile, M, N, p, m0, n0);
        for (int s = 0; s < steps; ++s, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);  // the first round finds every stage free
          uint8_t* a = ring + st * STAGE_BYTES;
          mbar_expect_tx(&full[st], STAGE_BYTES);  // a box counts whole, zero-filled bytes included
          tma_load(a, &map_a, &full[st], s * BK, p * a_rows + m0);
          tma_load(a + A_BYTES, &map_b, &full[st], s * BK, p * b_rows + n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this consumer's 64 rows of the tile
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    constexpr int VEC = 16 / sizeof(T);        // outputs a 16-byte store holds
    constexpr int CW = 256 / sizeof(T);        // columns a staging pass holds
    const bool vec_ok = N % VEC == 0;          // rows start 16-byte aligned
    uint8_t* stage = epi + c * EPI_BYTES;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int p, m0, n0;
      tile_origin(tile, M, N, p, m0, n0);
      const float* sp = scale + static_cast<long long>(p) * s_step;
      const float* bp = bias != nullptr ? bias + static_cast<long long>(p) * bias_step : nullptr;
      T* op = out + static_cast<long long>(p) * M * N;
      int d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0;
      for (int s = 0; s < steps; ++s, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const uint8_t* a = ring + st * STAGE_BYTES;
        const uint64_t da = smem_desc(a + c * 64 * BK), db = smem_desc(a + A_BYTES);
        fence_sums(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8(d, da + 2 * kk, db + 2 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_sums(d);
        // The group before this one has finished reading its stage: give it back.
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_sums(d);
        if (s > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_sums(d);
      // The tile's last stage: the producer fills it for the next tile while
      // this one's epilogue runs.
      if (t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // The epilogue, CW columns a pass through this consumer's staging
      // buffer: each thread writes its outputs there, then the warpgroup
      // stores whole 16-byte runs of rows to out. Sum i of thread t (warp
      // w, lane l of the warpgroup) is row 16 w + l / 4 + 8 ((i / 2) % 2),
      // column 8 (i / 4) + 2 (l % 4) + i % 2 of the consumer's 64 x 256.
#pragma unroll
      for (int pass = 0; pass < 256 / CW; ++pass) {
#pragma unroll
        for (int jj = 0; jj < CW / 8; ++jj) {
          const int j = pass * (CW / 8) + jj;
          const int col = jj * 8 + (l % 4) * 2, n = n0 + j * 8 + (l % 4) * 2;
          const float s0 = n < N ? sp[n] : 0.f, s1 = n + 1 < N ? sp[n + 1] : 0.f;
          const float b0 = bp != nullptr && n < N ? bp[n] : 0.f;
          const float b1 = bp != nullptr && n + 1 < N ? bp[n + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = __fmul_rn(__int2float_rn(d[j * 4 + h * 2]), s0);
            float v1 = __fmul_rn(__int2float_rn(d[j * 4 + h * 2 + 1]), s1);
            if (bias != nullptr) {
              v0 = __fadd_rn(v0, b0);
              v1 = __fadd_rn(v1, b1);
            }
            store2(reinterpret_cast<T*>(stage + epi_offset(w * 16 + l / 4 + h * 8, col * sizeof(T))), v0, v1);
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // this warpgroup's writes are in
        for (int u = t; u < 64 * 16; u += 128) {  // 64 rows of 16 units
          const int row = u / 16, unit = u % 16;
          const int m = m0 + c * 64 + row, n = n0 + pass * CW + unit * VEC;
          if (m >= M || n >= N) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage + epi_offset(row, unit * 16));
          T* dst = op + static_cast<long long>(m) * N + n;
          if (vec_ok && n + VEC <= N) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const T* e = reinterpret_cast<const T*>(&v);
            for (int k = 0; k < VEC && n + k < N; ++k) dst[k] = e[k];
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // read out before the next pass writes
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded; null if absent.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (rows, K) int8 matrix, K innermost, read in boxes of
// BK bytes by `box_rows` rows with the 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};  // bytes between rows
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* qa, const void* qw, const float* scale, const float* bias, void* out, int M, int N, int K,
           int P, int a_shared, int w_shared, int s_step, int bias_step, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (P < 1 || static_cast<long long>(P) * M > INT32_MAX || static_cast<long long>(P) * N > INT32_MAX ||
      !make_map(&map_a, qa, a_shared ? M : P * M, K, BM) || !make_map(&map_b, qw, w_shared ? N : P * N, K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_gemm_wgmma_kernel<T>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // Persistent: one block an SM (its shared memory allows no second).
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN) * P;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, scale, bias, static_cast<T*>(out), M, N, K, P,
                                                a_shared ? 0 : M, w_shared ? 0 : N, s_step, bias_step);
  return thunder::launch_status();
}

}  // namespace

// P problems: qa (P, M, K), or (M, K) shared when a_shared; qw (P, N, K),
// or (N, K) when w_shared; int8, K innermost, K % 16 == 0 and both bases
// 16-byte aligned (the wrapper checks); scale f32 and bias f32 (or null)
// with problem p's N values at p * s_step and p * bias_step (a step of 0
// shares them); out (P, M, N).
extern "C" int thunder_int8_gemm(const void* qa, const void* qw, const void* scale, const void* bias, void* out,
                                 int M, int N, int K, int dtype, int P, int a_shared, int w_shared, int s_step,
                                 int bias_step, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case thunder::kF32:
      return launch<float>(qa, qw, s, b, out, M, N, K, P, a_shared, w_shared, s_step, bias_step, st);
    case thunder::kF16:
      return launch<__half>(qa, qw, s, b, out, M, N, K, P, a_shared, w_shared, s_step, bias_step, st);
    case thunder::kBF16:
      return launch<__nv_bfloat16>(qa, qw, s, b, out, M, N, K, P, a_shared, w_shared, s_step, bias_step, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
