// Building blocks of the flash-attention kernels (flash_attn.cu, flash_bwd.cu,
// flash_bwd_dq.cu) for sm_90a: warp-level tensor-core products
// (mma.sync.m16n8k16, f32 accumulation) fed by ldmatrix from padded shared
// tiles, and asynchronous global-to-shared copies (cp.async).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): with
// g = lane / 4 and t = lane % 4,
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//     a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..);
//   B (16 x 8, k x n): b[0] = (k 2t..2t+1, n g), b[1] = (k 2t + 8.., n g);
//   C (16 x 8, f32): c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1).
// So the accumulators of two neighbouring 16 x 8 tiles (columns 16j..16j+15)
// are, rounded to 16 bits in pairs, the A fragment of k-chunk j: a score
// tile becomes the A operand of the next product without leaving registers.
//
// Shared tiles hold rows of DP (the head size padded to a multiple of 16)
// 16-bit values with a row stride of DP + 8: 16-byte aligned rows whose
// 16-byte chunks fall in 8 different bank groups across any 8 consecutive
// rows, so ldmatrix reads them without bank conflicts.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace thunder {
namespace flash {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// The head sizes the kernels are built for (executors/flashex.py
// `_HEAD_BUCKETS`): a head of D <= DP columns runs in the smallest DP >= D,
// its columns D..DP zero in shared memory.
#define THUNDER_FLASH_HEAD_BUCKETS(X) X(32) X(64) X(112) X(128) X(256)

// Output columns a block accumulates in registers: heads above 128 are split
// over blockIdx.z in chunks of 128, each chunk recomputing the scores.
template <int DP>
struct Head {
  static constexpr int LD = DP + 8;            // shared row stride (elements)
  static constexpr int DC = DP > 128 ? 128 : DP;  // accumulated columns per block
  static constexpr int NZ = DP / DC;           // column chunks (grid z)
  static constexpr int KT = DP / 16;           // k-chunks of a product over the head
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major
// shared tile with row stride ld.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int ld, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// The B fragments of two neighbouring n8 tiles (b[0..1] the first, b[2..3]
// the second) for a product with the transpose of a row-major tile: n runs
// over rows [n0, n0 + 16) and k over columns [k0, k0 + 16) (Q K^T reads K so).
template <typename T>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const T* tile, int ld, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The B fragments of two neighbouring n8 tiles for a product with a row-major
// tile itself: k runs over rows [k0, k0 + 16) and n over columns [n0, n0 + 16)
// (P V reads V so), through ldmatrix's transpose.
template <typename T>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const T* tile, int ld, int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to the 16-bit type (nearest even, as
// `from_float` and torch's casts round), `lo` in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-chunk j from the f32 accumulators of n8 tiles 2j and
// 2j + 1, rounded to the 16-bit type.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// One asynchronous copy of BYTES (4, 8 or 16) into shared memory; when `ok`
// is false nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(BYTES),
                 "r"(ok ? BYTES : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Which VEC-element chunks of a tile's rows a thread copies: rows of
// cpr = D / VEC chunks, the thread's first chunk (r, c) and the step to its
// next, NTHREADS chunks on (dr rows and dc chunks, carried). One division
// per kernel instead of one per copy.
struct Chunks {
  int r, c, dr, dc, cpr;
};

__device__ __forceinline__ Chunks chunks_of(int D, int vec) {
  const int cpr = D / vec;
  return {static_cast<int>(threadIdx.x) / cpr, static_cast<int>(threadIdx.x) % cpr, NTHREADS / cpr,
          NTHREADS % cpr, cpr};
}

// Rows [row0, row0 + NR) of a (nrows, D) matrix with row stride st into a
// shared tile of row stride ld, VEC elements per copy (VEC = 1: plain loads
// and stores); rows at or past nrows are zero-filled. Columns D..DP are not
// written (the kernels zero them once).
template <typename T, int NR, int VEC>
__device__ __forceinline__ void load_rows_v(T* dst, int ld, const T* src, long long st, int row0, int nrows,
                                            const Chunks& ch) {
  int r = ch.r;
  int c = ch.c;
  while (r < NR) {
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const T* s = src + (ok ? gr * st + c * VEC : 0);
    T* d = dst + r * ld + c * VEC;
    if constexpr (VEC == 1) {
      *d = ok ? *s : from_float<T>(0.f);
    } else {
      cp_async<static_cast<int>(VEC * sizeof(T))>(d, s, ok);
    }
    r += ch.dr;
    c += ch.dc;
    if (c >= ch.cpr) {
      c -= ch.cpr;
      ++r;
    }
  }
}

// `load_rows_v` with the widest copy that D, the strides and the base
// pointers allow (`vec`, chosen by the wrapper: 8, 4, 2 or 1 elements; `ch`
// from `chunks_of(D, vec)`).
template <typename T, int NR>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long st, int row0, int nrows,
                                          const Chunks& ch, int vec) {
  if (vec == 8)
    load_rows_v<T, NR, 8>(dst, ld, src, st, row0, nrows, ch);
  else if (vec == 4)
    load_rows_v<T, NR, 4>(dst, ld, src, st, row0, nrows, ch);
  else if (vec == 2)
    load_rows_v<T, NR, 2>(dst, ld, src, st, row0, nrows, ch);
  else
    load_rows_v<T, NR, 1>(dst, ld, src, st, row0, nrows, ch);
}

// Zero columns [D, DP) of `rows` rows of stride ld (the padding that the
// products read and the loads never write).
template <typename T, int DP>
__device__ __forceinline__ void zero_pad_columns(T* base, int rows, int D) {
  constexpr int LD = Head<DP>::LD;
  const int w = DP - D;
  for (int idx = threadIdx.x; idx < rows * w; idx += NTHREADS) {
    const int r = idx / w;
    base[r * LD + D + (idx - r * w)] = from_float<T>(0.f);
  }
}

// How a warp's tile of (row, column) pairs stands under segment ids, given
// every column's segment in cols[0..N) (shared memory) and the segments of
// this lane's two rows: when all columns lie in one segment, a tile that
// every row shares needs no compare, and a tile that no row shares adds
// nothing (P = 0 there) and is skipped, which leaves every sum as it was.
struct SegTile {
  bool skip, compare;
};

template <int N>
__device__ __forceinline__ SegTile seg_tile(const int* cols, int r0, int r1, int lane) {
  const int v = cols[0];
  bool one = true;
#pragma unroll
  for (int c = lane; c < N; c += 32) one = one && cols[c] == v;
  one = __all_sync(0xffffffffu, one);
  const bool share = __all_sync(0xffffffffu, r0 == v && r1 == v);
  const bool none = __all_sync(0xffffffffu, r0 != v && r1 != v);
  return {one && none, !(one && share)};
}

// Write a warp's 16 x DC f32 accumulator (rows r0 + g and r0 + g + 8,
// columns d0 + 8j + 2t, +1), times `mul`, to a contiguous (nrows, D) output
// in the 16-bit type; rows at or past nrows and columns at or past D are
// skipped. Pairs go out as one 4-byte store where D is even.
template <typename T, int NO>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[NO][4], int r0, int nrows, int d0, int D,
                                          float mul0, float mul1, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r >= nrows) continue;
    const float mul = half ? mul1 : mul0;
    T* row = out + static_cast<long long>(r) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = d0 + j * 8 + 2 * t;
      const float v0 = acc[j][2 * half] * mul;
      const float v1 = acc[j][2 * half + 1] * mul;
      if ((D & 1) == 0) {
        if (c < D) *reinterpret_cast<uint32_t*>(row + c) = pack2<T>(v0, v1);
      } else {
        if (c < D) row[c] = from_float<T>(v0);
        if (c + 1 < D) row[c + 1] = from_float<T>(v1);
      }
    }
  }
}

}  // namespace flash
}  // namespace thunder
