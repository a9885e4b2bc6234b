// Flash-attention forward (causal or full, no mask) for sm_90a.
//
// Replaces the TPU splash-attention kernel reached from
// thunder_tpu/executors/flashex.py `_sdpa_impl` -> `_sdpa_runtime` ->
// `_splash_sdpa` (kernel built by `_splash_kernel`), and, when given an lse
// pointer, the residual-saving forward `_splash_fwd_res` /
// `_sdpa_fwd_res_impl`, which also returns the per-row logsumexp that the
// backward (flash_bwd.cu) consumes.
//
// What it computes: O = softmax(scale * Q K^T + causal mask) V with an online
// softmax, never materialising the (Tq, Tkv) scores in device memory.
//   q (B, H, Tq, D), k/v (B, G, Tkv, D), o (B, H, Tq, D) contiguous; bf16 or
//   f16; D <= 256. q/k/v may be strided views (last dim contiguous): the
//   kernel reads them through their b/h/t strides, so the slices of the fused
//   qkv projection are never copied. GQA reads kv head h / (H / G).
//   Causal: query i sees key j iff j <= i + (Tkv - Tq) (bottom-right aligned,
//   as the JAX package's decomposition and splash kernel do). A query that
//   sees no key gets a zero row.
// Numerics: scores are accumulated in f32 and scaled in f32 (the JAX package
//   rounds q*scale to bf16 before its kernel instead; the two agree within
//   the stated tolerance). The running max and sum are f32; P is rounded to
//   the input type for P.V, which accumulates in f32; O is written once in
//   the input type. lse (B, H, Tq) f32, written only when the pointer is not
//   null: m + log(l) in natural log of the scaled scores, -inf for a query
//   that sees no key.
//
// Bound on an H100: 4*B*H*Tq*Tkv*D/2 FLOP for causal attention over 989
//   TFLOP/s bf16 (compute-bound at the model's shapes: at B=2, H=32, T=2048,
//   D=100 that is ~5.4e10 FLOP, ~54 us, against ~105 MB of q/k/v/o, ~31 us).
//
// Design: one block of 4 warps per (64-query tile, b*h). Each warp owns 16
//   query rows. The block walks 64-key tiles up to the causal diagonal; K and
//   V tiles are staged in shared memory with D padded to a multiple of 16
//   with zeros. Products use tensor-core WMMA (16x16x16, f32 accumulation).
//   The O accumulator lives in shared memory in f32, so each row's rescale by
//   exp(m_old - m_new) is a plain loop (WMMA's register layout is opaque).
//   Rows of 200 bytes (D = 100) are only 8-byte aligned, so loads are 8-byte
//   (4 elements) where D and the strides allow, else one element at a time.
//   This is the simple version: no TMA, no wgmma, no pipelining.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using thunder::from_float;

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BN + 4;  // f32 score row stride
constexpr int LDP = BN + 8;  // P row stride (16-bit)

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // null: not wanted
  int B, H, G, Tq, Tkv, D, DP;
  long long sq[3], sk[3], sv[3];  // b, h, t strides in elements
  float scale_log2;               // scale * log2(e)
  int causal;
};

// Rows [row0, row0 + 64) of a (T, D) matrix with row stride st into a
// shared tile of row stride ld; rows at or past nrows are zero. Columns
// D..DP stay as zeroed at the start of the kernel.
template <typename T, int VEC>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long st, int row0,
                                          int nrows, int D) {
  const int cpr = D / VEC;
  for (int idx = threadIdx.x; idx < BM * cpr; idx += NTHREADS) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * VEC;
    const int gr = row0 + r;
    T* d = dst + r * ld + c;
    if (VEC == 4) {
      uint2 val = make_uint2(0u, 0u);
      if (gr < nrows) val = *reinterpret_cast<const uint2*>(src + gr * st + c);
      *reinterpret_cast<uint2*>(d) = val;
    } else {
      *d = gr < nrows ? src[gr * st + c] : from_float<T>(0.f);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int DP = p.DP;
  const int LDK = DP + 8;
  const int LDO = DP + 4;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BM * LDK;
  T* Vs = Ks + BN * LDK;
  float* Ss = reinterpret_cast<float*>(Vs + BN * LDK);
  T* Ps = reinterpret_cast<T*>(Ss + BM * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BM * LDP);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + g * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + g * p.sv[1];

  for (int i = threadIdx.x; i < (BM + 2 * BN) * LDK; i += NTHREADS) Qs[i] = from_float<T>(0.f);
  for (int i = threadIdx.x; i < BM * LDO; i += NTHREADS) Os[i] = 0.f;
  __syncthreads();
  load_tile<T, VEC>(Qs, LDK, qb, p.sq[2], m0, p.Tq, p.D);

  // Softmax state: lanes 2r and 2r+1 both hold row r of this warp's 16.
  const int r_local = lane >> 1;
  const int half = lane & 1;
  const int row = warp * 16 + r_local;
  const int qi = m0 + row;
  const int offset = p.Tkv - p.Tq;
  float m_i = -INFINITY;
  float l_i = 0.f;

  int n_end = p.Tkv;
  if (p.causal) n_end = min(p.Tkv, m0 + BM + offset);

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, VEC>(Ks, LDK, kb, p.sk[2], n0, p.Tkv, p.D);
    load_tile<T, VEC>(Vs, LDK, vb, p.sv[2], n0, p.Tkv, p.D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BN / 16];
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
    for (int kk = 0; kk < DP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * LDK + kk * 16, LDK);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, Ks + n * 16 * LDK + kk * 16, LDK);
        wmma::mma_sync(sacc[n], a, bt, sacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BN / 16; ++n)
      wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, sacc[n], LDS, wmma::mem_row_major);
    __syncwarp();

    // Online softmax over this tile; each lane takes 32 of the row's 64 keys.
    float* srow = Ss + row * LDS;
    T* prow = Ps + row * LDP;
    float mx = -INFINITY;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int j = n0 + c;
      const bool ok = j < p.Tkv && (!p.causal || j <= qi + offset);
      const float s = ok ? srow[c] * p.scale_log2 : -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = m_new == -INFINITY ? 1.f : exp2f(m_i - m_new);
    float sum = 0.f;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float pv = m_new == -INFINITY ? 0.f : exp2f(srow[c] - m_new);
      prow[c] = from_float<T>(pv);
      sum += pv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;

    // Rescale this warp's O rows, a row at a time across the warp.
    for (int r = 0; r < 16; ++r) {
      const float a_r = __shfl_sync(0xffffffffu, alpha, 2 * r);
      float* orow = Os + (warp * 16 + r) * LDO;
      for (int c = lane; c < DP; c += 32) orow[c] *= a_r;
    }
    __syncwarp();

    // O += P V for this warp's rows.
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + warp * 16 * LDO + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LDK + n * 16, LDK);
        wmma::mma_sync(oacc, a, bv, oacc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * LDO + n * 16, oacc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // O / l, a row at a time across the warp; a row that saw no key is zero.
  for (int r = 0; r < 16; ++r) {
    const float l = __shfl_sync(0xffffffffu, l_i, 2 * r);
    const float m = __shfl_sync(0xffffffffu, m_i, 2 * r);
    const int q = m0 + warp * 16 + r;
    if (q >= p.Tq) continue;
    if (p.lse != nullptr && lane == 0)
      p.lse[static_cast<long long>(bh) * p.Tq + q] = l > 0.f ? m * 0.6931471805599453f + logf(l) : -INFINITY;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* og = static_cast<T*>(p.o) + (static_cast<long long>(bh) * p.Tq + q) * p.D;
    const float* orow = Os + (warp * 16 + r) * LDO;
    for (int c = lane; c < p.D; c += 32) og[c] = from_float<T>(orow[c] * inv);
  }
}

template <typename T, int VEC>
int launch(const FlashParams& p, cudaStream_t stream) {
  const int LDK = p.DP + 8;
  const int LDO = p.DP + 4;
  const size_t smem = static_cast<size_t>(BM + 2 * BN) * LDK * sizeof(T) + BM * LDS * sizeof(float) +
                      BM * LDP * sizeof(T) + static_cast<size_t>(BM) * LDO * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Tq + BM - 1) / BM, p.B * p.H);
  flash_fwd_kernel<T, VEC><<<grid, NTHREADS, smem, stream>>>(p);
  return thunder::launch_status();
}

}  // namespace

extern "C" int thunder_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                                 int G, int Tq, int Tkv, int D, long long sqb, long long sqh,
                                 long long sqt, long long skb, long long skh, long long skt,
                                 long long svb, long long svh, long long svt, float scale,
                                 int causal, int dtype, int vec4, void* stream) {
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.G = G;
  p.Tq = Tq;
  p.Tkv = Tkv;
  p.D = D;
  p.DP = (D + 15) / 16 * 16;
  p.sq[0] = sqb; p.sq[1] = sqh; p.sq[2] = sqt;
  p.sk[0] = skb; p.sk[1] = skh; p.sk[2] = skt;
  p.sv[0] = svb; p.sv[1] = svh; p.sv[2] = svt;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == thunder::kBF16)
    return vec4 ? launch<__nv_bfloat16, 4>(p, s) : launch<__nv_bfloat16, 1>(p, s);
  if (dtype == thunder::kF16) return vec4 ? launch<__half, 4>(p, s) : launch<__half, 1>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
