// The dQ kernel of the flash-attention backward (see flash_bwd.cu for what
// the backward computes and what it replaces), for sm_90a. A file of its own
// so that nvcc builds it beside the dK/dV kernel.
//
// One block of 4 warps per (b * h, 64-query tile, column chunk); each warp
// owns 16 queries, whose rows of dQ stay in f32 registers and whose lse and
// Di are read once into registers. The block walks the key tiles up to the
// causal diagonal (64 keys, 32 for heads above 128) through a double-buffered
// cp.async ring of K/V tiles, recomputing S = Q K^T and dP = dout V^T in
// mma.sync's accumulator layout; dS = P * (dP - Di), rounded to the input
// type in registers, is the A operand of dQ += dS K, whose B fragments come
// through ldmatrix.trans. Under segment ids a warp skips a key tile that
// none of its queries may see. Query tiles launch in reverse, so the
// heaviest causal blocks start first.

#include "flash_bwd.cuh"

using namespace thunder::flash;

namespace {

constexpr int BMD = 64;  // queries per block, 16 per warp

template <int DP>
__host__ __device__ constexpr int bnk() {
  return DP > 128 ? 32 : 64;  // keys per tile
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int LD = Head<DP>::LD;
  constexpr int DC = Head<DP>::DC;
  constexpr int KT = Head<DP>::KT;
  constexpr int BN = bnk<DP>();
  constexpr int NS = BN / 8;  // n8 tiles of S (key columns)
  constexpr int NO = DC / 8;  // n8 tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BMD * LD;
  T* ring = dOs + BMD * LD;  // slot s: K at ring + 2s BN LD, V after it
  int* kseg_s = reinterpret_cast<int*>(ring + 4 * BN * LD);  // [2][BN]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BMD;
  const int d0 = blockIdx.z * DC;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.G);
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const int offset = p.Tkv - p.Tq;
  const int n_end = p.causal ? min(p.Tkv, m0 + BMD + offset) : p.Tkv;
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;

  const Chunks ch = chunks_of(p.D, p.vec);
  zero_pad_columns<T, DP>(Qs, 2 * BMD + 4 * BN, p.D);
  __syncthreads();
  load_rows<T, BMD>(Qs, LD, static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1], p.sq[2], m0, p.Tq, ch,
                    p.vec);
  load_rows<T, BMD>(dOs, LD, static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1], p.sdo[2], m0, p.Tq,
                    ch, p.vec);
  cp_async_commit();

  auto issue_kv = [&](int n) {
    T* kd = ring + (n & 1) * 2 * BN * LD;
    load_rows<T, BN>(kd, LD, kb, p.sk[2], n * BN, p.Tkv, ch, p.vec);
    load_rows<T, BN>(kd + BN * LD, LD, vb, p.sv[2], n * BN, p.Tkv, ch, p.vec);
    if constexpr (SEG) {
      for (int c = threadIdx.x; c < BN; c += NTHREADS) {  // keys past Tkv: 0
        const int j = n * BN + c;
        const bool ok = j < p.Tkv;
        cp_async<4>(kseg_s + (n & 1) * BN + c, p.kvseg + (ok ? static_cast<long long>(b) * p.Tkv + j : 0), ok);
      }
    }
  };
  if (n_tiles > 0) issue_kv(0);
  cp_async_commit();

  // This lane's rows: r0 (accumulator entries 0, 1) and r0 + 8 (2, 3).
  const int wrow = m0 + warp * 16;
  const int r0 = wrow + g;
  float lse2[2], di[2];
  int qs[2] = {0, 0};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + hf * 8;
    lse2[hf] = lse2_of(r < p.Tq ? p.lse[static_cast<long long>(bh) * p.Tq + r] : 0.f, r < p.Tq);
    di[hf] = r < p.Tq ? p.di[static_cast<long long>(bh) * p.Tq + r] : 0.f;
    if constexpr (SEG) qs[hf] = r < p.Tq ? p.qseg[static_cast<long long>(b) * p.Tq + r] : 0;
  }
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles) issue_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q, dout and tile n have landed for every thread
    const T* Kt = ring + (n & 1) * 2 * BN * LD;
    const T* Vt = Kt + BN * LD;
    const int* kss = kseg_s + (n & 1) * BN;
    const SegTile seg = SEG ? seg_tile<BN>(kss, qs[0], qs[1], lane) : SegTile{false, false};
    if (!seg.skip) {
      // S = Q K^T and dP = dout V^T for this warp's 16 queries.
      float s[NS][4], ds[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = ds[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        load_a(a, Qs, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_rows(bb, Kt, LD, np * 16, kk * 16, lane);
          mma<T>(s[2 * np], a, bb[0], bb[1]);
          mma<T>(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        load_a(a, dOs, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_rows(bb, Vt, LD, np * 16, kk * 16, lane);
          mma<T>(ds[2 * np], a, bb[0], bb[1]);
          mma<T>(ds[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // P and dS = P * (dP - Di); the causal compare only on a tile that
      // crosses this warp's diagonal, the range compare only on the ragged
      // last tile.
      const int n0 = n * BN;
      const bool edge = n0 + BN > p.Tkv || (p.causal && n0 + BN - 1 > wrow + offset);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          float pv = exp2f(s[j][e] * p.scale_log2 - lse2[hf]);
          if (seg.compare || edge) {
            const int c = j * 8 + 2 * t + (e & 1);
            const int col = n0 + c;
            bool ok = col < p.Tkv && (!p.causal || col <= r0 + hf * 8 + offset);
            if constexpr (SEG) ok = ok && kss[c] == qs[hf];
            if (!ok) pv = 0.f;
          }
          ds[j][e] = pv * (ds[j][e] - di[hf]);
        }

      // dQ += dS K: dS from registers, rounded to the input type.
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        uint32_t a[4];
        acc_to_a<T>(a, ds[2 * kc], ds[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          uint32_t bb[4];
          load_b_cols(bb, Kt, LD, kc * 16, d0 + dp * 16, lane);
          mma<T>(dq[2 * dp], a, bb[0], bb[1]);
          mma<T>(dq[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }
  cp_async_wait<0>();

  store_acc<T, NO>(static_cast<T*>(p.dq) + static_cast<long long>(bh) * p.Tq * p.D, dq, wrow, p.Tq, d0, p.D,
                   p.scale, p.scale, lane);
}

template <typename T, int DP, bool SEG>
int launch(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * BMD + 4 * bnk<DP>()) * Head<DP>::LD * sizeof(T) +
                      2 * bnk<DP>() * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP, SEG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.B * p.H, (p.Tq + BMD - 1) / BMD, Head<DP>::NZ);
  flash_bwd_dq_kernel<T, DP, SEG><<<grid, NTHREADS, smem, stream>>>(p);
  return thunder::launch_status();
}

template <typename T, bool SEG>
int dispatch(const BwdParams& p, int dp, cudaStream_t stream) {
  switch (dp) {
#define THUNDER_CASE(DPV) \
  case DPV:               \
    return launch<T, DPV, SEG>(p, stream);
    THUNDER_FLASH_HEAD_BUCKETS(THUNDER_CASE)
#undef THUNDER_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

namespace thunder {
namespace flash {

int launch_bwd_dq(const BwdParams& p, int dtype, int dp, cudaStream_t stream) {
  const bool seg = p.qseg != nullptr;
  if (dtype == kBF16)
    return seg ? dispatch<__nv_bfloat16, true>(p, dp, stream) : dispatch<__nv_bfloat16, false>(p, dp, stream);
  if (dtype == kF16) return seg ? dispatch<__half, true>(p, dp, stream) : dispatch<__half, false>(p, dp, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
}  // namespace thunder
