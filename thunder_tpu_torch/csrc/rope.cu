// Rotary position embedding (rotate-half, full rotary) for sm_90a.
//
// Replaces the TPU kernel thunder_tpu/executors/pallasex.py `_rope_kernel`
// (launched by `_rope_impl`); the rope backward is the same kernel with -sin.
//
// What it computes: out = x * cos + [-x2, x1] * sin, where x1 and x2 are the
//   two halves of each head row. x (B, H, T, D) may be a strided view (last
//   dim contiguous), as the q/k slices of the fused qkv projection are;
//   cos/sin (T, D) are contiguous, or (B / seg_b, T, D) with a table a
//   segment of seg_b batch rows (per-sample position offsets, a vmapped
//   table: executors/batching.py); out (B, H, T, D) is contiguous. All one
//   dtype (bf16, f16 or f32), any even D, any T. Each output is computed in
//   f32 and rounded once.
//
// Bound on an H100: bytes. One read of x and one write of out (cos/sin are
//   T*D and stay in L2): at (2, 32, 2048, 100) bf16 that is ~53 MB, ~16 us at
//   3.35 TB/s. There are 3 FLOP per output, far below the card's ratio.
//
// Design (fusedex.rope_plan picks every number; its constants mirror these):
//   - A block takes one (b, tile of `tt` rows of t, group of `hg` heads), from
//     a 3-D grid: the index math is done once per block, in 32 bits, and the
//     loops divide by multiplying (FastDiv), never by `/` or `%`.
//   - cos and sin of the tile are copied once into shared memory and serve
//     every head of the group (at the path's shapes all 32 heads: cos/sin
//     are read from L2 once per tile, not once per (b, h) row).
//   - The heads are walked in stages of `hs`, double-buffered in shared
//     memory: cp.async copies stage g + 1 while the block computes stage g. A copy takes the widest unit that the base
//     pointer, strides and row lengths allow (16 bytes; 8 for the path's
//     200-byte q/k rows; 4; or one element with plain loads). Where a head's
//     rows lie back to back (`flat`, as the backward's contiguous dq) its
//     tile is one run, copied in 16-byte units though a row is 200 bytes.
//   - A head's output tile is one contiguous run of tt * D elements, and so is
//     the (tt, D) slice of cos and sin: a thread takes `VO` elements of that
//     flattened run (16 bytes), reads their cos and sin once for the stage's
//     heads, and reads the partner half of each element (d +- D/2) in units
//     of `PU` elements, the widest that never straddles a half or a row; the
//     output is written in 16-byte stores.
//   - Views that break the 16-byte rules take VO = 1 (one element at a time);
//     a row too wide for shared memory (`DIRECT`) reads x, cos and sin from
//     device memory one element at a time. Both are the same kernel template.
// Tried and dropped, slower at the path's shapes: one stage of all the
//   block's heads (a block's loads then never overlap its stores); a stage
//   of one head (a barrier per head, too little work between barriers); a
//   persistent grid walking (b, tile, stage) items through one ring.
// Replaced design: one thread per (row, d) pair with four 64-bit divisions,
//   six 2-byte loads and two 2-byte stores each, and cos/sin re-read from L2
//   for every (b, h) row (34% of the bound).

#include "common.cuh"

#include <cstdint>
#include <type_traits>

using thunder::from_float;
using thunder::to_float;

namespace {

constexpr int NTHREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;  // what a block may ask for on sm_90

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift
// (Granlund-Montgomery); the magic number is made once per block.
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ explicit FastDiv(uint32_t div) : d(div) {
    s = div > 1 ? 32 - __clz(div - 1) : 0;  // ceil(log2(div))
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - div)) / div + 1);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const { return (__umulhi(n, m) + n) >> s; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

// N consecutive elements at p (16-byte aligned when N * sizeof(T) == 16,
// else N * sizeof(T) <= 8 and aligned to it) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_float(v[e]);
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_float(v[e]);
  } else if constexpr (N * sizeof(T) == 4 && N > 1) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_float(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_float(p[e]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_rounded(T* p, const float (&in)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = from_float<T>(in[e]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = from_float<T>(in[e]);
  }
}

// Issue the copies of `heads` tiles of `nruns` runs of `run` elements, run r
// of head i from src + i * sh + r * st to dst + i * tile + r * run, in units
// of BYTES (cp.async, completing with the thread's next commit group; a
// 2-byte unit with a plain load and store). by_nv divides by run / (units
// of BYTES), by_runs by nruns.
template <typename T, int BYTES>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int heads, int nruns, int run, int tile,
                                      long long sh, long long st, const FastDiv& by_nv, const FastDiv& by_runs) {
  constexpr int LX = BYTES / static_cast<int>(sizeof(T));
  const int nv = static_cast<int>(by_nv.d);
  for (int i = threadIdx.x; i < heads * nruns * nv; i += NTHREADS) {
    const int q = static_cast<int>(by_nv(i));  // run index over all heads
    const int c = (i - q * nv) * LX;
    const int hh = static_cast<int>(by_runs(q));
    const int r = q - hh * nruns;
    const T* s = src + hh * sh + r * st + c;
    T* d = dst + hh * tile + r * run + c;
    if constexpr (BYTES == static_cast<int>(sizeof(T)) && BYTES < 4) {
      *d = *s;
    } else {
      cp_async<BYTES>(d, s);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_any(int bytes, T* dst, const T* __restrict__ src, int heads, int nruns, int run,
                                          int tile, long long sh, long long st, const FastDiv& by_nv,
                                          const FastDiv& by_runs) {
  switch (bytes) {
    case 16: stage<T, 16>(dst, src, heads, nruns, run, tile, sh, st, by_nv, by_runs); break;
    case 8: stage<T, 8>(dst, src, heads, nruns, run, tile, sh, st, by_nv, by_runs); break;
    case 4: stage<T, 4>(dst, src, heads, nruns, run, tile, sh, st, by_nv, by_runs); break;
    default:
      if constexpr (sizeof(T) == 2) stage<T, 2>(dst, src, heads, nruns, run, tile, sh, st, by_nv, by_runs);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// VO: elements a thread computes and stores at once (16 bytes, or 1).
// PU: elements of the partner half read at once (PU divides D / 2 and VO).
// DIRECT: x, cos and sin are read from device memory (tt == 1, VO == PU == 1).
template <typename T, int VO, int PU, bool DIRECT>
__global__ void __launch_bounds__(NTHREADS)
    rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                T* __restrict__ out, int H, int T_len, int D, long long sb, long long sh, long long st, int tt,
                int hg, int hs, int vx, int flat, int seg_b) {
  // Shared memory: the tile's cos, then sin, then two buffers of a stage,
  // each `hs` tiles of x; a tile is tt * D elements, rows back to back.
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * tt, h0 = blockIdx.y * hg, b = blockIdx.z;
  const int rows = min(tt, T_len - t0), heads = min(hg, H - h0);
  const int n = rows * D, half = D / 2, tile = tt * D;
  const int nstages = (heads + hs - 1) / hs;
  const T* xb = x + b * sb + h0 * sh + static_cast<long long>(t0) * st;
  // The batch row's table: its segment's (T, D), or the one shared table.
  const long long tab = (seg_b > 0 ? static_cast<long long>(b / seg_b) * T_len : 0) + t0;
  const T* ct = cos_t + tab * D;
  const T* stt = sin_t + tab * D;
  T* cs = reinterpret_cast<T*>(smem);
  T* ss = cs + tile;
  T* ring = ss + tile;
  // A flat tile is one run of n elements; else `rows` runs of D.
  const int nruns = flat ? 1 : rows, run = flat ? n : D;
  const FastDiv by_nv(run * static_cast<int>(sizeof(T)) / (vx > 0 ? vx : 1)), by_runs(nruns), by_d(D);
  auto fetch = [&](int g) {  // stage g (heads g * hs ...) into buffer g % 2
    stage_any<T>(vx, ring + (g % 2) * hs * tile, xb + g * hs * sh, min(hs, heads - g * hs), nruns, run, tile, sh,
                 st, by_nv, by_runs);
  };

  if constexpr (!DIRECT) {
    // cos and sin: one contiguous run each, in 16-byte units where the
    // stores are (the tail of a ragged tile in 4-byte units), else by element.
    const int tb = VO == 1 ? static_cast<int>(sizeof(T)) : (n * sizeof(T)) % 16 == 0 ? 16 : 4;
    const FastDiv by_tb(n * static_cast<int>(sizeof(T)) / tb), one(1);
    stage_any<T>(tb, cs, ct, 1, 1, n, 0, 0, 0, by_tb, one);
    stage_any<T>(tb, ss, stt, 1, 1, n, 0, 0, 0, by_tb, one);
    fetch(0);
    cp_async_commit();
  }

  T* ob = out + (static_cast<long long>(b) * H + h0) * T_len * D + static_cast<long long>(t0) * D;
  const long long ohead = static_cast<long long>(T_len) * D;
  const T* ch = DIRECT ? ct : cs;
  const T* sn = DIRECT ? stt : ss;

  for (int g = 0; g < nstages; ++g) {
    const T* xg = xb + g * hs * sh;
    long long xstride = sh;
    if constexpr (!DIRECT) {
      // Stage g has landed, and every thread is done with stage g - 1, whose
      // buffer takes stage g + 1 while the block computes stage g.
      cp_async_wait_all();
      __syncthreads();
      if (g + 1 < nstages) fetch(g + 1);
      cp_async_commit();
      xg = ring + (g % 2) * hs * tile;
      xstride = tile;
    }
    const int gheads = min(hs, heads - g * hs);
    T* og = ob + g * hs * ohead;

    // out[j .. j + CNT) of each head of the stage, CNT == VO or 1 (the tail).
    auto rotate = [&](int j, auto cnt_tag) {
      constexpr int CNT = decltype(cnt_tag)::value;
      constexpr int P = CNT == VO ? PU : 1;
      float c[CNT], s[CNT];
      load_f32<T, CNT>(ch + j, c);
      load_f32<T, CNT>(sn + j, s);
      // Each unit of P elements lies in one half of one row: its partner is
      // P elements at +half (first half, negated) or -half.
      int off[CNT / P];
      const int d0 = j - static_cast<int>(by_d(j)) * D;
#pragma unroll
      for (int u = 0, dd = d0; u < CNT / P; ++u) {
        off[u] = dd < half ? half : -half;
        dd += P;
        if (dd >= D) dd -= D;
      }
      for (int hh = 0; hh < gheads; ++hh) {
        const T* xh = xg + hh * xstride;
        float own[CNT], res[CNT];
        load_f32<T, CNT>(xh + j, own);
#pragma unroll
        for (int u = 0; u < CNT / P; ++u) {
          float oth[P];
          load_f32<T, P>(xh + j + u * P + off[u], oth);
#pragma unroll
          for (int e = 0; e < P; ++e) {
            const int k = u * P + e;
            res[k] = own[k] * c[k] + (off[u] > 0 ? -oth[e] : oth[e]) * s[k];
          }
        }
        store_rounded<T, CNT>(og + hh * ohead + j, res);
      }
    };

    const int nvo = n / VO;
    for (int v = threadIdx.x; v < nvo; v += NTHREADS) rotate(v * VO, std::integral_constant<int, VO>{});
    if constexpr (VO > 1) {
      for (int j = nvo * VO + threadIdx.x; j < n; j += NTHREADS) rotate(j, std::integral_constant<int, 1>{});
    }
  }
}

template <typename T, int VO, int PU, bool DIRECT>
int launch_kernel(const void* x, const void* c, const void* s, void* out, int B, int H, int T_len, int D,
                  long long sb, long long sh, long long st, int tt, int hg, int hs, int vx, int flat, int seg_b,
                  cudaStream_t stream) {
  auto kernel = rope_kernel<T, VO, PU, DIRECT>;
  const size_t smem = DIRECT ? 0 : static_cast<size_t>(2 + 2 * hs) * tt * D * sizeof(T);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > DEFAULT_SMEM) {
    if (int err = static_cast<int>(
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))))
      return err;
  }
  const dim3 grid((T_len + tt - 1) / tt, (H + hg - 1) / hg, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(c),
                                           static_cast<const T*>(s), static_cast<T*>(out), H, T_len, D, sb, sh, st,
                                           tt, hg, hs, vx, flat, seg_b);
  return thunder::launch_status();
}

template <typename T>
int launch(const void* x, const void* c, const void* s, void* out, int B, int H, int T_len, int D, long long sb,
           long long sh, long long st, int tt, int hg, int hs, int vx, int vo, int pu, int flat,
           int direct, int seg_b, cudaStream_t stream) {
  if (static_cast<long long>(B) * H * T_len * D == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool vx_ok = vx == 16 || vx == 8 || vx == 4 || vx == static_cast<int>(sizeof(T));
  if (D % 2 || tt < 1 || hg < 1 || hs < 1 || hs > hg || !vx_ok || B > 65535 ||
      (H + hg - 1) / hg > 65535 || (direct && (tt != 1 || vo != 1)) || (vo != 1 && vo != V) || pu < 1 || vo % pu ||
      (D / 2) % pu || seg_b < 0 || (seg_b > 0 && B % seg_b))
    return static_cast<int>(cudaErrorInvalidValue);
#define THUNDER_ROPE(VO_, PU_, DIRECT_) \
  launch_kernel<T, VO_, PU_, DIRECT_>(x, c, s, out, B, H, T_len, D, sb, sh, st, tt, hg, hs, vx, flat, seg_b, stream)
  if (direct) return THUNDER_ROPE(1, 1, true);
  if (vo == 1) return THUNDER_ROPE(1, 1, false);
  switch (pu) {
    case 1: return THUNDER_ROPE(V, 1, false);
    case 2: return THUNDER_ROPE(V, 2, false);
    case 4: return THUNDER_ROPE(V, 4, false);
    default:
      if constexpr (V == 8) return THUNDER_ROPE(V, 8, false);
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef THUNDER_ROPE
}

}  // namespace

// Strides sb, sh, st are x's, in elements; out is contiguous. tt rows of t
// and hg heads a block, walked in double-buffered stages of hs heads; vx the
// bytes of a copy of x into shared memory; vo the elements a thread stores at
// once (16 bytes or 1); pu the elements of a partner read; flat: a head's
// rows lie back to back (st == D); direct: x is read from device memory
// (tt == 1, vo == 1); seg_b: 0 for one shared (T, D) table, else the batch
// rows of each (T, D) table of cos and sin (B / seg_b tables, back to back).
extern "C" int thunder_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int B, int H,
                            int T_len, int D, long long sb, long long sh, long long st, int tt, int hg,
                            int hs, int vx, int vo, int pu, int flat, int direct, int seg_b, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case thunder::kBF16:
      return launch<__nv_bfloat16>(x, cos_t, sin_t, out, B, H, T_len, D, sb, sh, st, tt, hg, hs, vx, vo, pu,
                                   flat, direct, seg_b, s);
    case thunder::kF16:
      return launch<__half>(x, cos_t, sin_t, out, B, H, T_len, D, sb, sh, st, tt, hg, hs, vx, vo, pu, flat,
                            direct, seg_b, s);
    case thunder::kF32:
      return launch<float>(x, cos_t, sin_t, out, B, H, T_len, D, sb, sh, st, tt, hg, hs, vx, vo, pu, flat,
                           direct, seg_b, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
