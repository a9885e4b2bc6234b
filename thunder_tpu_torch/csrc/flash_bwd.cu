// Flash-attention backward from the saved output and logsumexp, for sm_90a.
//
// Replaces the TPU kernel reached from thunder_tpu/executors/flashex.py
// `_sdpa_bwd_res_impl` (splash attention's `_splash_attention_bwd`, run from
// the saved (out, lse) that `_splash_fwd_res` returns).
//
// What it computes, for causal or full attention with no mask:
//   Di = rowsum(dout * out)                       (f32)
//   P  = exp(scale * q k^T - lse)                 (f32; 0 where masked)
//   dV = P^T dout,  dP = dout v^T,  dS = P * (dP - Di)
//   dQ = scale * dS k,  dK = scale * dS^T q
//   q, out, dout (B, H, Tq, D), k/v (B, G, Tkv, D), lse (B, H, Tq) f32; bf16
//   or f16, D <= 256. q/k/v/out/dout may be strided views (last dim
//   contiguous). dq (B, H, Tq, D) and dk/dv (B, G, Tkv, D) are contiguous and
//   in the input type; dk/dv are summed over the H/G query heads of each kv
//   group. Causal: query i sees key j iff j <= i + (Tkv - Tq), as in the
//   forward. P and dS are rounded to the input type before the tensor-core
//   products that take them (P^T dout, dS k, dS^T q); every product
//   accumulates in f32. The plain version (executors/flashex.py
//   `flash_attention_bwd_plain`) rounds at the same places.
//
// Bound on an H100: operations. A causal pass costs 10 * B * H * D FLOP per
//   visible (query, key) pair (q k^T recomputed, dout v^T, and the three
//   products into dV, dQ, dK): at B=2, H=32, T=2048, D=100 that is ~1.3e11
//   FLOP, ~0.14 ms at 989 TFLOP/s, against ~106 MB of inputs and outputs
//   (~32 us at 3.35 TB/s).
//
// Design: the FlashAttention-2 split, without atomics, so the gradients are
//   the same from run to run:
//   - a pre-pass, one warp per query row, writes Di (B, H, Tq) f32;
//   - the dK/dV kernel, one block per (32-key tile, b * kv head), walks the
//     heads of its group and the 64-query tiles that can see its keys,
//     recomputing P and dS per tile and summing dK, dV in shared memory;
//   - the dQ kernel, one block per (64-query tile, b * h), walks the key
//     tiles up to the causal diagonal and sums dQ in shared memory.
//   Products are tensor-core WMMA (16x16x16, f32 accumulation) between
//   shared-memory tiles, spread over the block's 4 warps; D is padded to a
//   multiple of 16 with zeros, and rows of 200 bytes (D = 100) are loaded 8
//   bytes at a time where D and the strides allow, as in the forward. At
//   D = 112 a block takes ~100 KB of shared memory (two blocks per SM); at
//   D = 256, ~190 KB. This is the simple version: accumulators round-trip
//   through shared memory, no TMA, no wgmma, no pipelining.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;
using thunder::from_float;
using thunder::to_float;

namespace {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 32;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BN + 4;  // f32 (BM, BN) row stride
constexpr int LDP = BN + 8;  // 16-bit (BM, BN) row stride
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  float* di;
  int B, H, G, Tq, Tkv, D, DP;
  long long sq[3], sk[3], sv[3], so[3], sdo[3];  // b, h, t strides in elements
  float scale;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// Rows [row0, row0 + NR) of a (T, D) matrix with row stride st into a shared
// tile of row stride ld; rows at or past nrows are zero. Columns D..DP keep
// the zeros written at the start of the kernel.
template <typename T, int VEC, int NR>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long st, int row0, int nrows,
                                          int D) {
  const int cpr = D / VEC;
  for (int idx = threadIdx.x; idx < NR * cpr; idx += NTHREADS) {
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

// C (M x N, f32, row stride ldc) = A (M x K) * B (K x N), or += when acc.
// A is row-major unless TRANS_A, where it is stored as its transpose (K x M
// row-major); B is row-major unless TRANS_B, where it is stored as its
// transpose (N x K row-major). The 16x16 tiles of C are spread over the
// block's warps. M, N and K are multiples of 16.
template <typename T, bool TRANS_A, bool TRANS_B>
__device__ __forceinline__ void mma_tiles(float* C, int ldc, const T* A, int lda, const T* Bm, int ldb, int M,
                                          int N, int K, bool acc) {
  using LA = typename std::conditional<TRANS_A, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int nt = N / 16;
  for (int f = warp; f < (M / 16) * nt; f += NWARPS) {
    const int mi = f / nt;
    const int ni = f - mi * nt;
    float* cp = C + mi * 16 * ldc + ni * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
      wmma::load_matrix_sync(a, TRANS_A ? A + kk * 16 * lda + mi * 16 : A + mi * 16 * lda + kk * 16, lda);
      wmma::load_matrix_sync(b, TRANS_B ? Bm + ni * 16 * ldb + kk * 16 : Bm + kk * 16 * ldb + ni * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// Di[b, h, i] = sum_d dout * out, one warp per row.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_di_kernel(BwdParams p) {
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + threadIdx.x / 32;
  if (row >= static_cast<long long>(p.B) * p.H * p.Tq) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % p.Tq);
  const long long bh = row / p.Tq;
  const int h = static_cast<int>(bh % p.H);
  const long long b = bh / p.H;
  const T* o = static_cast<const T*>(p.o) + b * p.so[0] + h * p.so[1] + i * p.so[2];
  const T* d = static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1] + i * p.sdo[2];
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc += to_float(o[c]) * to_float(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[row] = acc;
}

// lse (in log2 units) and Di of query rows [m0, m0 + BM) into rowv[0..BM) and
// rowv[BM..2 BM); a row past Tq gets lse -inf (P = 0) and Di 0.
__device__ __forceinline__ void load_row_stats(float* rowv, const BwdParams& p, long long bh, int m0) {
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    const int i = m0 + r;
    rowv[r] = i < p.Tq ? p.lse[bh * p.Tq + i] * LOG2E : -INFINITY;
    rowv[BM + r] = i < p.Tq ? p.di[bh * p.Tq + i] : 0.f;
  }
}

// P = exp2(scale_log2 * S - lse2) where query m0 + r sees key n0 + c, else 0;
// written over S in f32 and, when Pt is not null, into Pt in the input type.
template <typename T>
__device__ __forceinline__ void probabilities(float* Ss, T* Pt, const float* rowv, const BwdParams& p, int m0,
                                              int n0) {
  const int offset = p.Tkv - p.Tq;
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    const int i = m0 + r;
    const int j = n0 + c;
    const float l2 = rowv[r];
    const bool ok = i < p.Tq && j < p.Tkv && (!p.causal || j <= i + offset) && l2 != -INFINITY;
    const float pv = ok ? exp2f(Ss[r * LDS + c] * p.scale_log2 - l2) : 0.f;
    Ss[r * LDS + c] = pv;
    if (Pt != nullptr) Pt[r * LDP + c] = from_float<T>(pv);
  }
}

// dS = P * (dP - Di), rounded to the input type.
template <typename T>
__device__ __forceinline__ void score_grads(T* dSt, const float* Ps, const float* dPs, const float* rowv) {
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    dSt[r * LDP + c] = from_float<T>(Ps[r * LDS + c] * (dPs[r * LDS + c] - rowv[BM + r]));
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDK = p.DP + 8;
  const int LDA = p.DP + 4;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BN * LDK;
  T* Qs = Vs + BN * LDK;
  T* dOs = Qs + BM * LDK;
  float* dKa = reinterpret_cast<float*>(dOs + BM * LDK);
  float* dVa = dKa + BN * LDA;
  float* Ss = dVa + BN * LDA;
  float* dPs = Ss + BM * LDS;
  T* Pt = reinterpret_cast<T*>(dPs + BM * LDS);
  float* rowv = reinterpret_cast<float*>(Pt + BM * LDP);

  const int n0 = blockIdx.x * BN;
  const int bg = blockIdx.y;
  const int b = bg / p.G;
  const int g = bg - b * p.G;
  const int rep = p.H / p.G;
  for (int i = threadIdx.x; i < (2 * BN + 2 * BM) * LDK; i += NTHREADS) Ks[i] = from_float<T>(0.f);
  for (int i = threadIdx.x; i < 2 * BN * LDA; i += NTHREADS) dKa[i] = 0.f;
  __syncthreads();
  load_rows<T, VEC, BN>(Ks, LDK, static_cast<const T*>(p.k) + b * p.sk[0] + g * p.sk[1], p.sk[2], n0, p.Tkv,
                        p.D);
  load_rows<T, VEC, BN>(Vs, LDK, static_cast<const T*>(p.v) + b * p.sv[0] + g * p.sv[1], p.sv[2], n0, p.Tkv,
                        p.D);

  // The first query tile with a query that sees a key of this tile.
  const int m_begin = p.causal ? max(0, n0 - (p.Tkv - p.Tq)) / BM * BM : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
    const T* dob = static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1];
    for (int m0 = m_begin; m0 < p.Tq; m0 += BM) {
      __syncthreads();  // every warp is done with the previous tile
      load_rows<T, VEC, BM>(Qs, LDK, qb, p.sq[2], m0, p.Tq, p.D);
      load_rows<T, VEC, BM>(dOs, LDK, dob, p.sdo[2], m0, p.Tq, p.D);
      load_row_stats(rowv, p, bh, m0);
      __syncthreads();
      mma_tiles<T, false, true>(Ss, LDS, Qs, LDK, Ks, LDK, BM, BN, p.DP, false);    // S = Q K^T
      mma_tiles<T, false, true>(dPs, LDS, dOs, LDK, Vs, LDK, BM, BN, p.DP, false);  // dP = dO V^T
      __syncthreads();
      probabilities<T>(Ss, Pt, rowv, p, m0, n0);
      __syncthreads();
      mma_tiles<T, true, false>(dVa, LDA, Pt, LDP, dOs, LDK, BN, p.DP, BM, true);  // dV += P^T dO
      __syncthreads();
      score_grads<T>(Pt, Ss, dPs, rowv);
      __syncthreads();
      mma_tiles<T, true, false>(dKa, LDA, Pt, LDP, Qs, LDK, BN, p.DP, BM, true);  // dK += dS^T Q
    }
  }
  __syncthreads();
  T* dkg = static_cast<T*>(p.dk) + static_cast<long long>(bg) * p.Tkv * p.D;
  T* dvg = static_cast<T*>(p.dv) + static_cast<long long>(bg) * p.Tkv * p.D;
  for (int idx = threadIdx.x; idx < BN * p.D; idx += NTHREADS) {
    const int r = idx / p.D;
    const int c = idx - r * p.D;
    const int j = n0 + r;
    if (j >= p.Tkv) continue;
    dkg[static_cast<long long>(j) * p.D + c] = from_float<T>(dKa[r * LDA + c] * p.scale);
    dvg[static_cast<long long>(j) * p.D + c] = from_float<T>(dVa[r * LDA + c]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDK = p.DP + 8;
  const int LDA = p.DP + 4;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BM * LDK;
  T* Ks = dOs + BM * LDK;
  T* Vs = Ks + BN * LDK;
  float* dQa = reinterpret_cast<float*>(Vs + BN * LDK);
  float* Ss = dQa + BM * LDA;
  float* dPs = Ss + BM * LDS;
  T* dSt = reinterpret_cast<T*>(dPs + BM * LDS);
  float* rowv = reinterpret_cast<float*>(dSt + BM * LDP);

  const int m0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + g * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + g * p.sv[1];
  for (int i = threadIdx.x; i < (2 * BM + 2 * BN) * LDK; i += NTHREADS) Qs[i] = from_float<T>(0.f);
  for (int i = threadIdx.x; i < BM * LDA; i += NTHREADS) dQa[i] = 0.f;
  __syncthreads();
  load_rows<T, VEC, BM>(Qs, LDK, static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1], p.sq[2], m0, p.Tq,
                        p.D);
  load_rows<T, VEC, BM>(dOs, LDK, static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1], p.sdo[2], m0,
                        p.Tq, p.D);
  load_row_stats(rowv, p, bh, m0);

  int n_end = p.Tkv;
  if (p.causal) n_end = min(p.Tkv, m0 + BM + (p.Tkv - p.Tq));
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, VEC, BN>(Ks, LDK, kb, p.sk[2], n0, p.Tkv, p.D);
    load_rows<T, VEC, BN>(Vs, LDK, vb, p.sv[2], n0, p.Tkv, p.D);
    __syncthreads();
    mma_tiles<T, false, true>(Ss, LDS, Qs, LDK, Ks, LDK, BM, BN, p.DP, false);    // S = Q K^T
    mma_tiles<T, false, true>(dPs, LDS, dOs, LDK, Vs, LDK, BM, BN, p.DP, false);  // dP = dO V^T
    __syncthreads();
    probabilities<T>(Ss, nullptr, rowv, p, m0, n0);
    __syncthreads();
    score_grads<T>(dSt, Ss, dPs, rowv);
    __syncthreads();
    mma_tiles<T, false, false>(dQa, LDA, dSt, LDP, Ks, LDK, BM, p.DP, BN, true);  // dQ += dS K
  }
  __syncthreads();
  T* dqg = static_cast<T*>(p.dq) + static_cast<long long>(bh) * p.Tq * p.D;
  for (int idx = threadIdx.x; idx < BM * p.D; idx += NTHREADS) {
    const int r = idx / p.D;
    const int c = idx - r * p.D;
    const int i = m0 + r;
    if (i < p.Tq) dqg[static_cast<long long>(i) * p.D + c] = from_float<T>(dQa[r * LDA + c] * p.scale);
  }
}

template <typename T, int VEC>
int launch(const BwdParams& p, cudaStream_t stream) {
  const int LDK = p.DP + 8;
  const int LDA = p.DP + 4;
  const size_t common = static_cast<size_t>(2 * BM + 2 * BN) * LDK * sizeof(T) + 2 * BM * LDS * sizeof(float) +
                        BM * LDP * sizeof(T) + 2 * BM * sizeof(float);
  const size_t smem_dkdv = common + static_cast<size_t>(2 * BN) * LDA * sizeof(float);
  const size_t smem_dq = common + static_cast<size_t>(BM) * LDA * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows = static_cast<long long>(p.B) * p.H * p.Tq;
  if (rows == 0) return 0;
  flash_bwd_di_kernel<T><<<static_cast<unsigned>((rows + NWARPS - 1) / NWARPS), NTHREADS, 0, stream>>>(p);
  int status = thunder::launch_status();
  if (status != 0) return status;
  flash_bwd_dkdv_kernel<T, VEC><<<dim3((p.Tkv + BN - 1) / BN, p.B * p.G), NTHREADS, smem_dkdv, stream>>>(p);
  status = thunder::launch_status();
  if (status != 0) return status;
  flash_bwd_dq_kernel<T, VEC><<<dim3((p.Tq + BM - 1) / BM, p.B * p.H), NTHREADS, smem_dq, stream>>>(p);
  return thunder::launch_status();
}

}  // namespace

extern "C" int thunder_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const float* lse, void* dq, void* dk, void* dv, float* di, int B, int H, int G,
                                 int Tq, int Tkv, int D, long long sqb, long long sqh, long long sqt,
                                 long long skb, long long skh, long long skt, long long svb, long long svh,
                                 long long svt, long long sob, long long soh, long long sot, long long sdob,
                                 long long sdoh, long long sdot, float scale, int causal, int dtype, int vec4,
                                 void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.di = di;
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
  p.so[0] = sob; p.so[1] = soh; p.so[2] = sot;
  p.sdo[0] = sdob; p.sdo[1] = sdoh; p.sdo[2] = sdot;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == thunder::kBF16)
    return vec4 ? launch<__nv_bfloat16, 4>(p, s) : launch<__nv_bfloat16, 1>(p, s);
  if (dtype == thunder::kF16) return vec4 ? launch<__half, 4>(p, s) : launch<__half, 1>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
