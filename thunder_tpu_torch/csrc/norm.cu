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
//            dw = sum of g * xhat and, for LN, db = sum of g over the rows,
//            in f32 (the Python wrapper casts them to w's type).
//
// Bound on an H100: bytes. The forward reads x and writes y once: at
//   open_llama_3b's (4096, 3200) bf16 that is 52.4 MB, 15.6 us at 3.35 TB/s;
//   pythia-410m's (4096, 1024) 16.8 MB, 5.0 us. The backward reads g and x
//   and writes dx: 78.6 MB (23.5 us) and 25.2 MB (7.5 us). The arithmetic,
//   a few operations per element, is far below the card's rate.
//
// Forward: the bound is bytes, so the design keeps rows in flight with little
//   work a byte (normex.fwd_plan picks the route, its constants mirror these).
//   - A row in registers. A group of `wpr` warps takes a row (one warp at
//     pythia-410m's D = 1024 bf16: 32 lanes x four 16-byte units; four warps
//     at open_llama_3b's 3200); a lane holds at most 32 columns. Row sums are
//     warp shuffles, and a group of several warps adds its warps' sums after
//     a named barrier of the group only. No shared-memory copy of the row,
//     no whole-block barrier.
//   - A persistent grid of `ctas` blocks of 8 warps, one wave: as many
//     blocks as the SMs hold at once (thunder_norm_fwd_blocks_per_sm says how
//     many the kernel's registers allow: one at LayerNorm's 159 a thread, two
//     at RMSNorm's 119). Group j of all blocks walks rows j, j + groups, ...
//     Each group loads its weight (and bias) once into registers, and loads
//     its next row while it reduces the current one, so two rows a group are
//     in flight. The passes are branch-free: units past the row's end hold
//     zeros.
//   - Rows too wide for 8 warps' registers take a block a row, the row cached
//     in shared memory as f32 (`norm_fwd_kernel_block`), or, too wide for
//     shared memory, read from device memory again (its STREAM route).
//   Replaced design (kept for those widths): a block of 256 threads a row
//   (half of them idle at D = 1024 bf16), the row written to shared memory
//   and read back, two whole-block barriers a row sum.
//
// Backward: the bound is bytes, so the design keeps rows in flight and the
//   per-row work short.
//   - Rows in flight. A persistent grid of one block of 8 warps per SM
//     (the wrapper passes the SM count). The warps form row groups of `wpr`
//     warps (1 at pythia-410m's D = 1024, 4 at open_llama_3b's 3200); group
//     j of all blocks walks rows j, j + groups, ... Each group has a ring of
//     up to 3 row slots in shared memory holding x and g in their own type.
//     One lane asks the Tensor Memory Accelerator for a whole row of each
//     with a bulk copy (cp.async.bulk) that completes on the slot's
//     mbarrier: ~100 KB in flight on every SM at the path shapes. A group
//     copies its slot into registers and hands it back at once, so the
//     refill overlaps the whole row's work.
//   - No whole-block barrier per row. Row sums are warp shuffles; a group of
//     several warps adds its warps' sums in a fixed order after a named
//     barrier of that group only (bar.sync id, 32 * wpr).
//   - Registers. A lane owns the same columns (at most 32) of every row and
//     keeps x (then xhat), g, w and its f32 sums of g * xhat (and g) in
//     registers. The passes have no branches (columns past the row's end
//     hold zeros) and each row sum runs as two chains, so the columns' work
//     interleaves. Rows too wide for that add their column sums into the
//     block's partial row in device memory instead, one owner per column.
//   - The column sums. Each group writes its sums to its own rows of shared
//     memory, and each block adds them in group order into one (D,) partial
//     row. A second small kernel sums the blocks' rows in a fixed order into
//     dw (and db); it is launched as a programmatic dependent of the first,
//     so it is scheduled while the row kernel drains.
//   - Segments (vmap's batching rule, executors/batching.py). The N rows may
//     be `segs` equal runs of N / segs rows, one a vmapped slice, each with
//     its own dw (and db): the blocks split into `segs` equal sets, set s
//     walks only segment s's rows, and the column-sum kernel sums each set's
//     partial rows into row s of dw (segs, D). One segment is the plain
//     backward, with the same bits.
//   - Per-segment weights (a vmapped weight, executors/batching.py): the
//     weight (and LayerNorm's bias) may be (segs, D), row r of the forward
//     reading row r / seg_rows of it and the backward's segment s reading row
//     s; a shared (D,) weight is passed with no segment step, and its rows
//     take the same instructions and give the same bits as before.
//   - Rows that break the bulk copy's 16-byte rules, or too wide for one
//     slot, take the same passes reading device memory directly (4-byte
//     loads where rows allow, else one element).
//   No atomics: the same inputs give the same bits on every run.
// Replaced design: one block per run of 16 rows, the row cached in shared
//   memory as f32, two whole-block barriers per row sum, no row loading while
//   a row was reduced, and two torch reductions of the (blocks, D) partials.

#include "common.cuh"

#include <cstdint>
#include <type_traits>

using thunder::from_float;
using thunder::to_float;

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;  // what a block may ask for on sm_90

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

// =============================================================================
// Forward, a block a row (wide rows)
// =============================================================================

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

// (mu, rstd) of the row (mu = 0 for RMS); row(c, v) gives chunk c's values.
// `partial` is this thread's sum of x (LN) or x^2 (RMS) over its columns.
template <int VEC, bool LN, typename Row>
__device__ __forceinline__ float2 row_stats(const Row& row, float partial, int D, float eps, float* red) {
  const int nchunk = D / VEC;
  if (!LN) return make_float2(0.f, rsqrtf(block_sum(partial, red) / D + eps));
  const float mu = block_sum(partial, red) / D;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
    float v[VEC];
    row(c, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = v[e] - mu;
      s2 += d * d;
    }
  }
  return make_float2(mu, rsqrtf(block_sum(s2, red) / D + eps));
}

// A block a row, for rows too wide for norm_fwd_kernel's registers. STREAM:
// the row is read from device memory on each pass instead of being cached in
// shared memory (rows wider than a block's shared memory).
template <typename T, int VEC, bool LN, bool STREAM>
__global__ void __launch_bounds__(NTHREADS)
    norm_fwd_kernel_block(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    T* __restrict__ y, int D, int seg_rows, float eps) {
  extern __shared__ float xs[];  // D floats: this row of x in f32 (not STREAM)
  __shared__ float red[NWARPS];
  const long long row = blockIdx.x;
  if (seg_rows > 0) {  // this row's segment's weight and bias
    const long long off = row / seg_rows * D;
    w += off;
    if (b != nullptr) b += off;
  }
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const int nchunk = D / VEC;
  auto cached = [&](int c, float v[VEC]) {
    if constexpr (STREAM) {
      load_vec<T, VEC>(xr + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = xs[c * VEC + e];
    }
  };

  float partial = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
    float v[VEC];
    load_vec<T, VEC>(xr + c * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if constexpr (!STREAM) xs[c * VEC + e] = v[e];
      partial += LN ? v[e] : v[e] * v[e];
    }
  }
  const float2 st = row_stats<VEC, LN>(cached, partial, D, eps, red);

  for (int c = threadIdx.x; c < nchunk; c += NTHREADS) {
    float xv[VEC], wv[VEC], bv[VEC], out[VEC];
    cached(c, xv);
    load_vec<T, VEC>(w + c * VEC, wv);
    if (LN && b != nullptr) load_vec<T, VEC>(b + c * VEC, bv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      out[e] = (xv[e] - st.x) * st.y * wv[e];
      if (LN && b != nullptr) out[e] += bv[e];
    }
    store_vec<T, VEC>(yr + c * VEC, out);
  }
}

// =============================================================================
// Backward
// =============================================================================

// How the backward reads its rows (normex.bwd_plan picks it).
enum BwdMode : int { kRing = 0, kDirect = 1, kScalar = 2 };
constexpr int MAX_DEPTH = 3;    // ring slots a row group
constexpr int LANE_COLS = 32;   // columns a lane keeps its dw/db sums of in registers

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

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// U consecutive elements (4 bytes, or one element when U == 1).
template <typename T, int U>
__device__ __forceinline__ void store_unit(T* p, const float in[U]) {
  if constexpr (U == 1) {
    *p = from_float<T>(in[0]);
  } else {
    uint32_t raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < U; ++e) v[e] = from_float<T>(in[e]);
    *reinterpret_cast<uint32_t*>(p) = raw;
  }
}

// The U elements of a unit as they lie in memory, in 32 bits (one element
// of 2 bytes is zero-extended), and their f32 values.
template <typename T, int U>
__device__ __forceinline__ uint32_t load_raw(const T* p) {
  if constexpr (U * sizeof(T) == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(U == 1 && sizeof(T) == 2, "units of 4 bytes or one 2-byte element");
    return *reinterpret_cast<const uint16_t*>(p);
  }
}

template <typename T, int U>
__device__ __forceinline__ void unpack(uint32_t raw, float out[U]) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < U; ++e) out[e] = to_float(v[e]);
}

template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* p, float out[U]) {
  unpack<T, U>(load_raw<T, U>(p), out);
}

// The sums of a row group of `wpr` warps: xor butterflies in each warp, then
// (wpr > 1) the warps' sums, written to one of two buffers and added in warp
// order by every thread after the group's named barrier. Two buffers in turn
// need one barrier a sum: a warp writes a buffer again only after the next
// sum's barrier, which every warp reaches after reading it.
struct GroupSum {
  float2* buf;  // 2 * wpr
  int wpr, warp, lane, bar_id, phase;

  __device__ __forceinline__ float2 operator()(float2 v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
    if (wpr == 1) return v;
    float2* b = buf + phase * wpr;
    if (lane == 0) b[warp] = v;
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(32 * wpr) : "memory");
    float2 t = make_float2(0.f, 0.f);
    for (int i = 0; i < wpr; ++i) {
      t.x += b[i].x;
      t.y += b[i].y;
    }
    phase ^= 1;
    return t;
  }

  __device__ __forceinline__ void sync() const {
    if (wpr == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(32 * wpr) : "memory");
    }
  }
};

// =============================================================================
// Forward, rows in registers
// =============================================================================

enum FwdMode : int { kRows = 0, kBlock = 1, kStream = 2 };

// A unit of U elements as it lies in memory: 16 bytes, or (load_raw) 4 bytes
// or one 2-byte element in 32 bits.
template <typename T, int U>
using Raw = std::conditional_t<U * sizeof(T) == 16, uint4, uint32_t>;

template <typename T, int U>
__device__ __forceinline__ Raw<T, U> load_any(const T* p) {
  if constexpr (U * sizeof(T) == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    return load_raw<T, U>(p);
  }
}

template <typename T, int U>
__device__ __forceinline__ void unpack_any(const Raw<T, U>& raw, float* out) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < U; ++e) out[e] = to_float(v[e]);
}

template <typename T, int U>
__device__ __forceinline__ void store_any(T* p, const float* in) {
  if constexpr (U * sizeof(T) == 16) {
    store_vec<T, U>(p, in);
  } else {
    store_unit<T, U>(p, in);
  }
}

// Row groups of `wpr` warps on a persistent grid; a lane owns units gt,
// gt + 32 * wpr, ... (K at most) of every row it visits, holds the weight's
// and bias's in registers, and loads its group's next row while it reduces
// the current one.
template <typename T, int U, bool LN>
__global__ void __launch_bounds__(NTHREADS)
    norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    T* __restrict__ y, int N, int D, int seg_rows, int wpr, float eps) {
  constexpr int K = LANE_COLS / U;
  using R = Raw<T, U>;
  __shared__ float2 red[2 * NWARPS];
  const int tg = 32 * wpr, groups = NWARPS / wpr;
  const int grp = threadIdx.x / tg, gt = threadIdx.x % tg;
  const int nunits = D / U;
  GroupSum gsum{red + grp * 2 * (wpr > 1 ? wpr : 0), wpr, gt / 32, gt % 32, 1 + grp, 0};
  const int first = blockIdx.x * groups + grp, stride = gridDim.x * groups;

  R xq[K], nq[K], wq[K], bq[K];
  auto load_row = [&](int row, R(&q)[K]) {
    const T* xr = x + static_cast<long long>(row) * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = gt + k * tg;
      q[k] = u < nunits ? load_any<T, U>(xr + u * U) : R{};
    }
  };
  // The weight and bias of segment `seg` (seg_rows > 0: rows seg * seg_rows
  // on read that segment's row of w and b; else one shared row).
  auto load_params = [&](int seg) {
    const long long off = static_cast<long long>(seg) * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = gt + k * tg;
      wq[k] = u < nunits ? load_any<T, U>(w + off + u * U) : R{};
      bq[k] = LN && b != nullptr && u < nunits ? load_any<T, U>(b + off + u * U) : R{};
    }
  };
  if (first < N) load_row(first, xq);
  int seg = seg_rows > 0 && first < N ? first / seg_rows : 0;
  load_params(seg);

  for (int row = first; row < N; row += stride) {
    if (row + stride < N) load_row(row + stride, nq);
    if (seg_rows > 0 && row / seg_rows != seg) {
      seg = row / seg_rows;
      load_params(seg);
    }
    float xf[K * U], s1[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unpack_any<T, U>(xq[k], &xf[k * U]);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const float v = xf[k * U + e];
        s1[(k * U + e) & 1] += LN ? v : v * v;
      }
    }
    float mu = 0.f, rstd;
    if constexpr (LN) {
      mu = gsum(make_float2(s1[0] + s1[1], 0.f)).x / D;
      float s2[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool in = gt + k * tg < nunits;
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const float d = in ? xf[k * U + e] - mu : 0.f;
          s2[(k * U + e) & 1] += d * d;
        }
      }
      rstd = rsqrtf(gsum(make_float2(s2[0] + s2[1], 0.f)).x / D + eps);
    } else {
      rstd = rsqrtf(gsum(make_float2(s1[0] + s1[1], 0.f)).x / D + eps);
    }
    T* yr = y + static_cast<long long>(row) * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = gt + k * tg;
      float wv[U], bv[U], out[U];
      unpack_any<T, U>(wq[k], wv);
      unpack_any<T, U>(bq[k], bv);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        out[e] = (xf[k * U + e] - mu) * rstd * wv[e];
        if (LN) out[e] += bv[e];
      }
      if (u < nunits) store_any<T, U>(yr + u * U, out);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) xq[k] = nq[k];
  }
}

// The four passes over one row held at xr, gr (shared or device memory),
// for rows too wide for registers: the statistics, then m1 and m2, then dx
// and this thread's column sums, added into the block's partial rows pw, pb
// in device memory (w is read there too).
template <typename T, int U, bool LN>
__device__ __forceinline__ void bwd_row(const T* xr, const T* gr, T* __restrict__ dxr, const T* __restrict__ w,
                                        int D, int nunits, int gt, int tg, float eps, float* __restrict__ pw,
                                        float* __restrict__ pb, GroupSum& gsum) {
  float s1 = 0.f;
  for (int u = gt; u < nunits; u += tg) {
    float xv[U];
    load_unit<T, U>(xr + u * U, xv);
#pragma unroll
    for (int e = 0; e < U; ++e) s1 += LN ? xv[e] : xv[e] * xv[e];
  }
  float mu = 0.f, rstd;
  if constexpr (LN) {
    mu = gsum(make_float2(s1, 0.f)).x / D;
    float s2 = 0.f;
    for (int u = gt; u < nunits; u += tg) {
      float xv[U];
      load_unit<T, U>(xr + u * U, xv);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const float d = xv[e] - mu;
        s2 += d * d;
      }
    }
    rstd = rsqrtf(gsum(make_float2(s2, 0.f)).x / D + eps);
  } else {
    rstd = rsqrtf(gsum(make_float2(s1, 0.f)).x / D + eps);
  }

  float a1 = 0.f, a2 = 0.f;
  for (int u = gt; u < nunits; u += tg) {
    float xv[U], gv[U], wk[U];
    load_unit<T, U>(xr + u * U, xv);
    load_unit<T, U>(gr + u * U, gv);
    load_unit<T, U>(w + u * U, wk);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float xhat = (xv[e] - mu) * rstd;
      const float wg = gv[e] * wk[e];
      a1 += wg;
      a2 += wg * xhat;
    }
  }
  const float2 m = gsum(make_float2(a1, a2));
  const float m2 = m.y / D;
  const float m1 = LN ? m.x / D : 0.f;

  for (int u = gt; u < nunits; u += tg) {
    float xv[U], gv[U], wk[U], out[U];
    load_unit<T, U>(xr + u * U, xv);
    load_unit<T, U>(gr + u * U, gv);
    load_unit<T, U>(w + u * U, wk);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float xhat = (xv[e] - mu) * rstd;
      out[e] = rstd * (gv[e] * wk[e] - m1 - xhat * m2);
      pw[u * U + e] += gv[e] * xhat;
      if (LN && pb != nullptr) pb[u * U + e] += gv[e];
    }
    store_unit<T, U>(dxr + u * U, out);
  }
}

// The register version of bwd_row for rows whose lane slices fit in
// registers: load_row reads this thread's units of x and g (KMAX
// independent loads each, so one latency for the row), and bwd_row_regs runs
// the same four passes on them, with the same order of every sum.
template <typename T, int U, int KMAX>
__device__ __forceinline__ void load_row(const T* xr, const T* gr, int nunits, int gt, int tg, uint32_t (&xq)[KMAX],
                                         uint32_t (&gq)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int u = gt + k * tg;
    xq[k] = u < nunits ? load_raw<T, U>(xr + u * U) : 0u;
    gq[k] = u < nunits ? load_raw<T, U>(gr + u * U) : 0u;
  }
}

template <typename T, int U, bool LN, int KMAX>
__device__ __forceinline__ void bwd_row_regs(const uint32_t (&xq)[KMAX], const uint32_t (&gq)[KMAX],
                                             T* __restrict__ dxr, int D, int nunits, int gt, int tg, float eps,
                                             const float (&wv)[KMAX * U], float (&aw)[KMAX * U],
                                             float (&ab)[KMAX * U], GroupSum& gsum) {
  // Units past the row's end hold x = g = w = 0, which add nothing to any
  // sum but the centred squares; so only those and the store look at the
  // bound, and the units' chains interleave without branches.
  // Each sum runs as two chains (even and odd columns of the lane), added at
  // the end: half the dependent latency, the same order on every run. x is
  // unpacked once, and overwritten with xhat in the third pass. Means are
  // taken as sums times 1/D.
  const float inv_d = 1.f / D;
  float xf[KMAX * U], s1[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    unpack<T, U>(xq[k], &xf[k * U]);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float v = xf[k * U + e];
      s1[(k * U + e) & 1] += LN ? v : v * v;
    }
  }
  float mu = 0.f, rstd;
  if constexpr (LN) {
    mu = gsum(make_float2(s1[0] + s1[1], 0.f)).x * inv_d;
    float s2[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const bool in = gt + k * tg < nunits;
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const float d = in ? xf[k * U + e] - mu : 0.f;
        s2[(k * U + e) & 1] += d * d;
      }
    }
    rstd = rsqrtf(gsum(make_float2(s2[0] + s2[1], 0.f)).x * inv_d + eps);
  } else {
    rstd = rsqrtf(gsum(make_float2(s1[0] + s1[1], 0.f)).x * inv_d + eps);
  }

  float a1[2] = {0.f, 0.f}, a2[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    float gv[U];
    unpack<T, U>(gq[k], gv);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float xhat = (xf[k * U + e] - mu) * rstd;
      const float wg = gv[e] * wv[k * U + e];
      xf[k * U + e] = xhat;
      a1[(k * U + e) & 1] += wg;
      a2[(k * U + e) & 1] += wg * xhat;
    }
  }
  const float2 m = gsum(make_float2(a1[0] + a1[1], a2[0] + a2[1]));
  const float m2 = m.y * inv_d;
  const float m1 = LN ? m.x * inv_d : 0.f;

#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int u = gt + k * tg;
    float gv[U], out[U];
    unpack<T, U>(gq[k], gv);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float xhat = xf[k * U + e];
      out[e] = rstd * (gv[e] * wv[k * U + e] - m1 - xhat * m2);
      aw[k * U + e] += gv[e] * xhat;
      if constexpr (LN) ab[k * U + e] += gv[e];
    }
    if (u < nunits) store_unit<T, U>(dxr + u * U, out);
  }
}

// Shared memory of the backward (normex.bwd_plan mirrors it): the fold
// buffers (REG only: each group's D floats for dw and, LN, db), rounded up
// to 16 bytes, then each group's ring of `depth` slots of (x row, g row).
__host__ __device__ inline size_t fold_bytes(int D, int groups, bool ln, bool reg) {
  return reg ? ((static_cast<size_t>(groups) * D * 4 * (ln ? 2 : 1) + 15) / 16) * 16 : 0;
}

template <typename T, int MODE, bool LN>
__global__ void __launch_bounds__(NTHREADS, 1)
    norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ dx, float* __restrict__ dw_part, float* __restrict__ db_part, int seg_rows,
                    int seg_blocks, int w_per_seg, int D, int wpr, int depth, float eps) {
  constexpr int U = MODE == kScalar ? 1 : static_cast<int>(4 / sizeof(T));
  constexpr int KMAX = LANE_COLS / U;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[NWARPS * MAX_DEPTH];
  __shared__ float2 red[2 * NWARPS];

  const int tg = 32 * wpr;                      // threads a group
  const int groups = NWARPS / wpr;              // groups a block
  const int grp = threadIdx.x / tg, gt = threadIdx.x % tg;
  const int nunits = D / U;
  const bool reg = (nunits + tg - 1) / tg <= KMAX;
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
  unsigned char* ring = smem + fold_bytes(D, groups, LN, reg) + static_cast<size_t>(grp) * depth * 2 * row_bytes;
  uint64_t* gbars = bars + grp * MAX_DEPTH;
  GroupSum gsum{red + grp * 2 * (wpr > 1 ? wpr : 0), wpr, gt / 32, gt % 32, 1 + grp, 0};

  float* pw = dw_part + static_cast<long long>(blockIdx.x) * D;
  float* pb = LN && db_part != nullptr ? db_part + static_cast<long long>(blockIdx.x) * D : nullptr;

  if constexpr (MODE == kRing) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NWARPS * MAX_DEPTH; ++i) mbar_init(&bars[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (!reg) {  // one group a block (wpr == 8): the partial rows are the sums
    for (int c = threadIdx.x; c < D; c += NTHREADS) {
      pw[c] = 0.f;
      if (pb != nullptr) pb[c] = 0.f;
    }
  }
  __syncthreads();
  // Let the column-sum kernel be scheduled early; it waits for this grid's end.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // This block's segment: its rows are seg_rows from `base`, walked by the
  // seg_blocks blocks of the segment.
  const long long base = static_cast<long long>(blockIdx.x / seg_blocks) * seg_rows;
  if (w_per_seg) w += static_cast<long long>(blockIdx.x / seg_blocks) * D;  // the segment's own weight
  const int first = (blockIdx.x % seg_blocks) * groups + grp, stride = seg_blocks * groups;
  const int nrows = first < seg_rows ? (seg_rows - 1 - first) / stride + 1 : 0;

  auto run = [&](auto reg_tag) {
    constexpr bool REG = decltype(reg_tag)::value;
    float wv[KMAX * U], aw[KMAX * U], ab[KMAX * U];
#pragma unroll
    for (int i = 0; i < KMAX * U; ++i) {
      wv[i] = 0.f;
      aw[i] = 0.f;
      ab[i] = 0.f;
    }
    auto load_weight = [&] {  // after the ring's first copies are in flight
      if constexpr (REG) {
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (gt + k * tg < nunits) load_unit<T, U>(w + (gt + k * tg) * U, &wv[k * U]);
        }
      }
    };

    if constexpr (MODE == kRing) {
      auto fetch = [&](int i, int s) {  // row i of this group into slot s = i % depth
        const long long row = base + first + static_cast<long long>(i) * stride;
        unsigned char* slot = ring + static_cast<size_t>(s) * 2 * row_bytes;
        mbar_expect_tx(&gbars[s], static_cast<uint32_t>(2 * row_bytes));
        bulk_load(slot, x + row * D, static_cast<uint32_t>(row_bytes), &gbars[s]);
        bulk_load(slot + row_bytes, g + row * D, static_cast<uint32_t>(row_bytes), &gbars[s]);
      };
      if (gt == 0) {
        for (int i = 0; i < depth && i < nrows; ++i) fetch(i, i);
      }
      load_weight();
      uint32_t phase = 0;  // of slot s's barrier: flips each time the ring wraps
      for (int i = 0, s = 0; i < nrows; ++i, s = s + 1 == depth ? 0 : s + 1) {
        const long long row = base + first + static_cast<long long>(i) * stride;
        const T* slot = reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * 2 * row_bytes);
        mbar_wait(&gbars[s], phase);
        if (s + 1 == depth) phase ^= 1;
        if constexpr (REG) {
          uint32_t xq[KMAX], gq[KMAX];
          load_row<T, U, KMAX>(slot, slot + D, nunits, gt, tg, xq, gq);
          gsum.sync();  // every thread of the group has read the slot: refill it
          if (gt == 0 && i + depth < nrows) fetch(i + depth, s);
          bwd_row_regs<T, U, LN, KMAX>(xq, gq, dx + row * D, D, nunits, gt, tg, eps, wv, aw, ab, gsum);
        } else {
          bwd_row<T, U, LN>(slot, slot + D, dx + row * D, w, D, nunits, gt, tg, eps, pw, pb, gsum);
          gsum.sync();  // every thread of the group is done with the slot
          if (gt == 0 && i + depth < nrows) fetch(i + depth, s);
        }
      }
    } else {
      load_weight();
      for (int i = 0; i < nrows; ++i) {
        const long long row = base + first + static_cast<long long>(i) * stride;
        if constexpr (REG) {
          uint32_t xq[KMAX], gq[KMAX];
          load_row<T, U, KMAX>(x + row * D, g + row * D, nunits, gt, tg, xq, gq);
          bwd_row_regs<T, U, LN, KMAX>(xq, gq, dx + row * D, D, nunits, gt, tg, eps, wv, aw, ab, gsum);
        } else {
          bwd_row<T, U, LN>(x + row * D, g + row * D, dx + row * D, w, D, nunits, gt, tg, eps, pw, pb, gsum);
        }
      }
    }

    if constexpr (REG) {
      // Each group writes its sums to its own rows; then each column's
      // groups are added in group order into the block's partial row.
      float* fw = reinterpret_cast<float*>(smem);  // (groups, D), then (groups, D) for db
      float* fb = fw + static_cast<size_t>(groups) * D;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (gt + k * tg < nunits) {
#pragma unroll
          for (int e = 0; e < U; ++e) {
            const int c = (gt + k * tg) * U + e;
            fw[grp * D + c] = aw[k * U + e];
            if constexpr (LN) fb[grp * D + c] = ab[k * U + e];
          }
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < D; c += NTHREADS) {
        float sw = 0.f, sb = 0.f;
        for (int q = 0; q < groups; ++q) {
          sw += fw[q * D + c];
          if constexpr (LN) sb += fb[q * D + c];
        }
        pw[c] = sw;
        if (pb != nullptr) pb[c] = sb;
      }
    }
  };
  if (reg) {
    run(std::true_type{});
  } else {
    run(std::false_type{});
  }
}

// out[c] = sum over r of part[r, c], r in a fixed order: 32 slices of rows
// (r = s, s + 32, ..., loaded 8 at a time, so a slice is one or two round
// trips) for 32 columns a block, then the slices in order. blockIdx.y picks
// dw (0) or db (1); blockIdx.z the segment, whose `rows` partial rows it
// sums into its own output row.
__global__ void __launch_bounds__(1024)
    norm_colsum_kernel(const float* __restrict__ pw, float* __restrict__ ow, const float* __restrict__ pb,
                       float* __restrict__ ob, int rows, int D) {
  __shared__ float red[32][33];
  // Launched as a programmatic dependent of the row kernel: wait until that
  // grid has finished and its partial rows are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* p = (blockIdx.y ? pb : pw) + static_cast<long long>(blockIdx.z) * rows * D;
  float* o = (blockIdx.y ? ob : ow) + static_cast<long long>(blockIdx.z) * D;
  const int c = threadIdx.x % 32, s = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + c;
  float acc = 0.f;
  if (col < D) {
    for (int r0 = s; r0 < rows; r0 += 32 * 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = r0 + 32 * j;
        v[j] = r < rows ? p[static_cast<long long>(r) * D + col] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += v[j];
    }
  }
  red[s][c] = acc;
  __syncthreads();
  if (s == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 32; ++q) t += red[q][c];
    o[col] = t;
  }
}

// Above 48 KB a kernel's dynamic shared memory must be asked for.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The register route's kernel for a unit of `unit` elements (V: 16 bytes,
// W: 4 bytes, or 1), or null.
template <typename T, bool LN>
auto fwd_rows_kernel(int unit) -> decltype(&norm_fwd_kernel<T, 1, LN>) {
  constexpr int V = 16 / sizeof(T);
  constexpr int W = sizeof(T) < 4 ? static_cast<int>(4 / sizeof(T)) : 1;
  return unit == V ? norm_fwd_kernel<T, V, LN> : unit == W ? norm_fwd_kernel<T, W, LN>
                                               : unit == 1 ? norm_fwd_kernel<T, 1, LN> : nullptr;
}

template <typename T, bool LN>
int launch_fwd(const void* x, const void* w, const void* b, void* y, int N, int D, int seg_rows, float eps, int mode,
               int unit, int wpr, int ctas, cudaStream_t stream) {
  if (N == 0) return 0;
  if (seg_rows < 0 || (seg_rows > 0 && N % seg_rows != 0)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const T *xt = static_cast<const T*>(x), *wt = static_cast<const T*>(w), *bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (mode == kRows) {
    auto kernel = fwd_rows_kernel<T, LN>(unit);
    if (kernel == nullptr || ctas < 1 || wpr < 1 || wpr > NWARPS || NWARPS % wpr != 0 || D % unit != 0 ||
        (D / unit + 32 * wpr - 1) / (32 * wpr) > LANE_COLS / unit)
      return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<ctas, NTHREADS, 0, stream>>>(xt, wt, bt, yt, N, D, seg_rows, wpr, eps);
    return thunder::launch_status();
  }
  if ((mode != kBlock && mode != kStream) || (unit != V && unit != 1) || D % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stream_rows = mode == kStream;
  auto kernel = stream_rows
                    ? (unit == V ? norm_fwd_kernel_block<T, V, LN, true> : norm_fwd_kernel_block<T, 1, LN, true>)
                    : (unit == V ? norm_fwd_kernel_block<T, V, LN, false> : norm_fwd_kernel_block<T, 1, LN, false>);
  const size_t smem = stream_rows ? 0 : static_cast<size_t>(D) * sizeof(float);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<N, NTHREADS, smem, stream>>>(xt, wt, bt, yt, D, seg_rows, eps);
  return thunder::launch_status();
}

template <typename T, bool LN>
int launch_bwd(const void* g, const void* x, const void* w, void* dx, float* dw, float* db, float* dw_part,
               float* db_part, int N, int D, int segs, int w_per_seg, int ctas, int wpr, int depth, int mode,
               float eps, cudaStream_t stream) {
  if (ctas < 1 || wpr < 1 || wpr > NWARPS || NWARPS % wpr != 0 || depth < 0 || depth > MAX_DEPTH ||
      (mode == kRing) != (depth > 0) || segs < 1 || segs > 65535 || N % segs != 0 || ctas % segs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mode == kRing     ? norm_bwd_kernel<T, kRing, LN>
                : mode == kDirect ? norm_bwd_kernel<T, kDirect, LN>
                                  : norm_bwd_kernel<T, kScalar, LN>;
  const int U = mode == kScalar ? 1 : static_cast<int>(4 / sizeof(T));
  const int tg = 32 * wpr, nunits = D / U;
  const bool reg = (nunits + tg - 1) / tg <= LANE_COLS / U;
  const size_t smem =
      fold_bytes(D, NWARPS / wpr, LN, reg) + static_cast<size_t>(NWARPS / wpr) * depth * 2 * static_cast<size_t>(D) * sizeof(T);
  if (smem > MAX_SMEM || (!reg && wpr != NWARPS)) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<ctas, NTHREADS, smem, stream>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                                           static_cast<const T*>(w), static_cast<T*>(dx), dw_part, db_part, N / segs,
                                           ctas / segs, w_per_seg, D, wpr, depth, eps);
  if (int err = thunder::launch_status()) return err;
  // The column sums may be scheduled while the row kernel's blocks drain
  // (programmatic dependent launch); they wait for its end themselves.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + 31) / 32, LN && db_part != nullptr ? 2 : 1, segs);
  cfg.blockDim = dim3(1024);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (int err = static_cast<int>(cudaLaunchKernelEx(&cfg, norm_colsum_kernel, static_cast<const float*>(dw_part), dw,
                                                    static_cast<const float*>(db_part), db, ctas / segs, D)))
    return err;
  return thunder::launch_status();
}

template <bool LN>
int dispatch_fwd(const void* x, const void* w, const void* b, void* y, int N, int D, int seg_rows, float eps,
                 int dtype, int mode, int unit, int wpr, int ctas, cudaStream_t s) {
  switch (dtype) {
    case thunder::kBF16:
      return launch_fwd<__nv_bfloat16, LN>(x, w, b, y, N, D, seg_rows, eps, mode, unit, wpr, ctas, s);
    case thunder::kF16: return launch_fwd<__half, LN>(x, w, b, y, N, D, seg_rows, eps, mode, unit, wpr, ctas, s);
    case thunder::kF32: return launch_fwd<float, LN>(x, w, b, y, N, D, seg_rows, eps, mode, unit, wpr, ctas, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool LN>
int dispatch_bwd(const void* g, const void* x, const void* w, void* dx, float* dw, float* db, float* dw_part,
                 float* db_part, int N, int D, int segs, int w_per_seg, int ctas, int wpr, int depth, int mode,
                 float eps, int dtype, cudaStream_t s) {
  switch (dtype) {
    case thunder::kBF16:
      return launch_bwd<__nv_bfloat16, LN>(g, x, w, dx, dw, db, dw_part, db_part, N, D, segs, w_per_seg, ctas, wpr,
                                           depth, mode, eps, s);
    case thunder::kF16:
      return launch_bwd<__half, LN>(g, x, w, dx, dw, db, dw_part, db_part, N, D, segs, w_per_seg, ctas, wpr, depth,
                                    mode, eps, s);
    case thunder::kF32:
      return launch_bwd<float, LN>(g, x, w, dx, dw, db, dw_part, db_part, N, D, segs, w_per_seg, ctas, wpr, depth,
                                   mode, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// layer_norm = 0: RMSNorm (b is ignored); 1: LayerNorm (b may be null).
// mode 0: row groups of `wpr` warps on `ctas` blocks, loading `unit`
// elements at once (16 bytes, 4 bytes or 1); mode 1: a block a row, the row
// cached in shared memory; mode 2: a block a row, read twice (unit 16 bytes
// or 1 in modes 1 and 2; wpr and ctas unused). seg_rows 0: w and b are (D,);
// else (N / seg_rows, D), row r reading row r / seg_rows.
extern "C" int thunder_norm_fwd(const void* x, const void* w, const void* b, void* y, int N, int D, int seg_rows,
                                float eps, int layer_norm, int dtype, int mode, int unit, int wpr, int ctas,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layer_norm ? dispatch_fwd<true>(x, w, b, y, N, D, seg_rows, eps, dtype, mode, unit, wpr, ctas, s)
                    : dispatch_fwd<false>(x, w, nullptr, y, N, D, seg_rows, eps, dtype, mode, unit, wpr, ctas, s);
}

// How many blocks of the register route's kernel (layer_norm, dtype, unit as
// in thunder_norm_fwd) an SM holds at once, or a negative CUDA error.
extern "C" int thunder_norm_fwd_blocks_per_sm(int layer_norm, int dtype, int unit) {
  auto occupancy = [](auto kernel) {
    int n = 0;
    if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NTHREADS, 0);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  };
  switch (dtype) {
    case thunder::kBF16:
      return layer_norm ? occupancy(fwd_rows_kernel<__nv_bfloat16, true>(unit))
                        : occupancy(fwd_rows_kernel<__nv_bfloat16, false>(unit));
    case thunder::kF16:
      return layer_norm ? occupancy(fwd_rows_kernel<__half, true>(unit))
                        : occupancy(fwd_rows_kernel<__half, false>(unit));
    case thunder::kF32:
      return layer_norm ? occupancy(fwd_rows_kernel<float, true>(unit))
                        : occupancy(fwd_rows_kernel<float, false>(unit));
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Two launches: the row kernel on `ctas` blocks of 8 warps in row groups of
// `wpr` warps with rings of `depth` slots (mode 0; 0 for modes 1 and 2),
// writing dx and the blocks' partial rows dw_part (and, for LayerNorm when
// it is not null, db_part), each (ctas, D) f32; then their column sums into
// dw (and db), (segs, D) f32: the rows are `segs` equal segments (N and
// ctas multiples of segs), each summed on its own ctas / segs blocks.
// w_per_seg: w is (segs, D), segment s reading row s; else w is (D,).
extern "C" int thunder_norm_bwd(const void* g, const void* x, const void* w, void* dx, float* dw, float* db,
                                float* dw_part, float* db_part, int N, int D, int segs, int w_per_seg, int ctas,
                                int wpr, int depth, int mode, float eps, int layer_norm, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layer_norm ? dispatch_bwd<true>(g, x, w, dx, dw, db, dw_part, db_part, N, D, segs, w_per_seg, ctas, wpr,
                                         depth, mode, eps, dtype, s)
                    : dispatch_bwd<false>(g, x, w, dx, dw, nullptr, dw_part, nullptr, N, D, segs, w_per_seg, ctas,
                                          wpr, depth, mode, eps, dtype, s);
}
