// Flash-attention backward from the saved output and logsumexp, for sm_90a.
//
// Replaces the TPU kernels reached from thunder_tpu/executors/flashex.py
// `_sdpa_bwd_res_impl` (splash attention's `_splash_attention_bwd`, run from
// the saved (out, lse) that `_splash_fwd_res` returns) and, after a forward
// with lse under the same segment ids (flash_attn.cu), `_sdpa_bwd_impl`: the
// recompute-path backward of masked, padded or Tq != Tkv attention, which the
// JAX package runs as the VJP of `_sdpa_runtime`.
//
// What it computes, for causal or full attention, optionally under segment
// ids:
//   Di = rowsum(dout * out)                       (f32)
//   P  = exp(scale * q k^T - lse)                 (f32; 0 where masked)
//   dV = P^T dout,  dP = dout v^T,  dS = P * (dP - Di)
//   dQ = scale * dS k,  dK = scale * dS^T q
//   q, out, dout (B, H, Tq, D), k/v (B, G, Tkv, D), lse (B, H, Tq) f32; bf16
//   or f16, D <= 256. q/k/v/out/dout may be strided views (last dim
//   contiguous). dq (B, H, Tq, D) and dk/dv (B, G, Tkv, D) are contiguous and
//   in the input type; dk/dv are summed over the H/G query heads of each kv
//   group. Causal: query i sees key j iff j <= i + (Tkv - Tq), as in the
//   forward. Segment ids q_seg (B, Tq), kv_seg (B, Tkv) int32 (both or
//   neither): query i sees key j only if q_seg[b, i] == kv_seg[b, j], so P
//   is 0 wherever the segments differ, as well as where causality masks and
//   where a row's lse is -inf (a query that saw no key). P and dS are rounded
//   to the input type before the tensor-core products that take them
//   (P^T dout, dS k, dS^T q); every product accumulates in f32. The plain
//   version (executors/flashex.py `flash_attention_bwd_plain`) rounds at the
//   same places.
//
// Bound on an H100: operations. A causal pass costs 10 * B * H * D FLOP per
//   visible (query, key) pair (q k^T recomputed, dout v^T, and the three
//   products into dV, dQ, dK): at B=2, H=32, T=2048, D=100 that is ~1.3e11
//   FLOP, ~0.14 ms at 989 TFLOP/s, against ~106 MB of inputs and outputs
//   (~32 us at 3.35 TB/s). This design does 14 per pair: the dQ kernel
//   recomputes q k^T and dout v^T rather than add into dQ with atomics.
//
// Design: the FlashAttention-2 split, without atomics, so the gradients are
//   the same from run to run (every reduction runs in a fixed order):
//   - a pre-pass, one warp per query row, writes Di (B, H, Tq) f32;
//   - the dK/dV kernel (here), one block of 4 warps per (b * kv head, 64-key
//     tile, column chunk); each warp owns 16 keys, and their rows of dK and
//     dV stay in f32 registers for the whole walk over the heads of the
//     group (in order) and the 64-query tiles that can see the keys (32 for
//     heads above 128). It computes S^T = K Q^T and dP^T = V dout^T, so P^T
//     and dS^T come out in mma.sync's accumulator layout; rounded to the
//     input type in registers they are the A operands of dV += P^T dout and
//     dK += dS^T Q, whose B fragments come through ldmatrix.trans. K and V
//     are loaded once; Q and dout tiles, with their rows' lse and Di, come
//     through a double-buffered cp.async ring, so the next tile's copy
//     overlaps this tile's products. Key tiles launch in ascending order, so
//     the heaviest causal blocks start first;
//   - the dQ kernel (flash_bwd_dq.cu), one block per (b * h, 64-query tile,
//     column chunk), dQ in registers, lse and Di read once per row into
//     registers, K/V tiles through the same kind of ring, query tiles in
//     reverse.
//   The causal compare runs only on tiles that cross the diagonal. Segment
//   ids are a template flag, and a warp skips a tile whose columns lie in
//   one segment that none of its rows has, as the forward does (the skipped
//   products would add zeros). Copies are as wide as D and the strides
//   allow (8 bytes for the 200-byte rows of D = 100), and heads are padded
//   and split over grid z as in the forward (flash_attn.cu). At D = 112
//   each kernel takes ~92 KB of shared memory: two blocks per SM.

#include "flash_bwd.cuh"

using thunder::to_float;
using namespace thunder::flash;

namespace {

constexpr int BNK = 64;  // keys per dK/dV block, 16 per warp

template <int DP>
__host__ __device__ constexpr int bmq() {
  return DP > 128 ? 32 : 64;  // queries per step of the dK/dV walk
}

// Di[b, h, i] = sum_d dout * out, one warp per row (4 elements a load where
// the copies may be 8 bytes wide).
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
  if (p.vec >= 4) {
    for (int c = lane * 4; c < p.D; c += 128) {
      const uint2 ov = *reinterpret_cast<const uint2*>(o + c);
      const uint2 dv = *reinterpret_cast<const uint2*>(d + c);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += to_float(oe[e]) * to_float(de[e]);
    }
  } else {
    for (int c = lane; c < p.D; c += 32) acc += to_float(o[c]) * to_float(d[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[row] = acc;
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(BwdParams p) {
  constexpr int LD = Head<DP>::LD;
  constexpr int DC = Head<DP>::DC;
  constexpr int KT = Head<DP>::KT;
  constexpr int BMQ = bmq<DP>();
  constexpr int NS = BMQ / 8;  // n8 tiles of S^T (query columns)
  constexpr int NO = DC / 8;   // n8 tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BNK * LD;
  T* ring = Vs + BNK * LD;  // stage s: Q at ring + 2s BMQ LD, dout after it
  float* rowst = reinterpret_cast<float*>(ring + 4 * BMQ * LD);  // stage s: lse at rowst + 2s BMQ, Di after it
  int* qseg_s = reinterpret_cast<int*>(rowst + 4 * BMQ);        // [2][BMQ]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bg = blockIdx.x;
  const int n0 = blockIdx.y * BNK;
  const int d0 = blockIdx.z * DC;
  const int b = bg / p.G;
  const int kvh = bg - b * p.G;
  const int rep = p.H / p.G;
  const int offset = p.Tkv - p.Tq;
  // The first query tile with a query that sees a key of this block.
  const int m_begin = p.causal ? max(0, n0 - offset) / BMQ * BMQ : 0;
  const int nmt = m_begin < p.Tq ? (p.Tq - m_begin + BMQ - 1) / BMQ : 0;
  const int n_steps = rep * nmt;

  const Chunks ch = chunks_of(p.D, p.vec);
  zero_pad_columns<T, DP>(Ks, 2 * BNK + 4 * BMQ, p.D);
  __syncthreads();
  load_rows<T, BNK>(Ks, LD, static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[1], p.sk[2], n0, p.Tkv, ch,
                    p.vec);
  load_rows<T, BNK>(Vs, LD, static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[1], p.sv[2], n0, p.Tkv, ch,
                    p.vec);
  cp_async_commit();

  // Step `it` of the walk: head it / nmt of the group, query tile it % nmt.
  auto issue_step = [&](int it) {
    const int hh = it / nmt;
    const int m0 = m_begin + (it - hh * nmt) * BMQ;
    const int h = kvh * rep + hh;
    const long long bh = static_cast<long long>(b) * p.H + h;
    T* qd = ring + (it & 1) * 2 * BMQ * LD;
    load_rows<T, BMQ>(qd, LD, static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1], p.sq[2], m0, p.Tq, ch,
                      p.vec);
    load_rows<T, BMQ>(qd + BMQ * LD, LD, static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1], p.sdo[2],
                      m0, p.Tq, ch, p.vec);
    float* rs = rowst + (it & 1) * 2 * BMQ;
    for (int r = threadIdx.x; r < BMQ; r += NTHREADS) {  // rows past Tq: zeros
      const int i = m0 + r;
      const bool ok = i < p.Tq;
      cp_async<4>(rs + r, p.lse + (ok ? bh * p.Tq + i : 0), ok);
      cp_async<4>(rs + BMQ + r, p.di + (ok ? bh * p.Tq + i : 0), ok);
      if constexpr (SEG)
        cp_async<4>(qseg_s + (it & 1) * BMQ + r, p.qseg + (ok ? static_cast<long long>(b) * p.Tq + i : 0), ok);
    }
  };
  if (n_steps > 0) issue_step(0);
  cp_async_commit();

  // This lane's keys: kw + g (accumulator entries 0, 1) and kw + g + 8 (2, 3).
  const int kw = n0 + warp * 16;
  int ks[2] = {0, 0};
  if constexpr (SEG) {
    for (int hf = 0; hf < 2; ++hf) {
      const int j = kw + g + hf * 8;
      ks[hf] = j < p.Tkv ? p.kvseg[static_cast<long long>(b) * p.Tkv + j] : 0;
    }
  }
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    if (it + 1 < n_steps) issue_step(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step it (and K, V) have landed for every thread
    const int m0 = m_begin + (it % nmt) * BMQ;
    const T* Qs = ring + (it & 1) * 2 * BMQ * LD;
    const T* dOs = Qs + BMQ * LD;
    const float* lse = rowst + (it & 1) * 2 * BMQ;
    const float* di = lse + BMQ;
    const int* qss = qseg_s + (it & 1) * BMQ;
    const SegTile seg = SEG ? seg_tile<BMQ>(qss, ks[0], ks[1], lane) : SegTile{false, false};
    if (!seg.skip) {
      // S^T = K Q^T for this warp's 16 keys.
      float sT[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) sT[j][0] = sT[j][1] = sT[j][2] = sT[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        load_a(a, Ks, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_rows(bb, Qs, LD, np * 16, kk * 16, lane);
          mma<T>(sT[2 * np], a, bb[0], bb[1]);
          mma<T>(sT[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // P^T = exp2(scale_log2 * S^T - lse2[query]); the causal compare only on
      // a tile that crosses the diagonal.
      const bool edge = p.causal && kw + 15 > m0 + offset;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = j * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(lse + c);
        const float l2[2] = {lse2_of(l.x, m0 + c < p.Tq), lse2_of(l.y, m0 + c + 1 < p.Tq)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = exp2f(sT[j][e] * p.scale_log2 - l2[e & 1]);
          if (seg.compare || edge) {
            const int key = kw + g + (e >> 1) * 8;
            bool ok = !p.causal || key <= m0 + c + (e & 1) + offset;
            if constexpr (SEG) ok = ok && ks[e >> 1] == qss[c + (e & 1)];
            if (!ok) pv = 0.f;
          }
          sT[j][e] = pv;
        }
      }

      // dV += P^T dout: P^T from registers, rounded to the input type.
#pragma unroll
      for (int kc = 0; kc < BMQ / 16; ++kc) {
        uint32_t a[4];
        acc_to_a<T>(a, sT[2 * kc], sT[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          uint32_t bb[4];
          load_b_cols(bb, dOs, LD, kc * 16, d0 + dp * 16, lane);
          mma<T>(dv[2 * dp], a, bb[0], bb[1]);
          mma<T>(dv[2 * dp + 1], a, bb[2], bb[3]);
        }
      }

      // dP^T = V dout^T, then dS^T = P^T * (dP^T - Di[query]) in place.
      float dsT[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) dsT[j][0] = dsT[j][1] = dsT[j][2] = dsT[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        load_a(a, Vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_rows(bb, dOs, LD, np * 16, kk * 16, lane);
          mma<T>(dsT[2 * np], a, bb[0], bb[1]);
          mma<T>(dsT[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(di + j * 8 + 2 * t);
        dsT[j][0] = sT[j][0] * (dsT[j][0] - d2.x);
        dsT[j][1] = sT[j][1] * (dsT[j][1] - d2.y);
        dsT[j][2] = sT[j][2] * (dsT[j][2] - d2.x);
        dsT[j][3] = sT[j][3] * (dsT[j][3] - d2.y);
      }

      // dK += dS^T Q: dS^T from registers, rounded to the input type.
#pragma unroll
      for (int kc = 0; kc < BMQ / 16; ++kc) {
        uint32_t a[4];
        acc_to_a<T>(a, dsT[2 * kc], dsT[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          uint32_t bb[4];
          load_b_cols(bb, Qs, LD, kc * 16, d0 + dp * 16, lane);
          mma<T>(dk[2 * dp], a, bb[0], bb[1]);
          mma<T>(dk[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  const long long out0 = static_cast<long long>(bg) * p.Tkv * p.D;
  store_acc<T, NO>(static_cast<T*>(p.dk) + out0, dk, kw, p.Tkv, d0, p.D, p.scale, p.scale, lane);
  store_acc<T, NO>(static_cast<T*>(p.dv) + out0, dv, kw, p.Tkv, d0, p.D, 1.f, 1.f, lane);
}

template <typename T, int DP, bool SEG>
int launch_dkdv(const BwdParams& p, cudaStream_t stream) {
  constexpr int BMQ = bmq<DP>();
  const size_t smem = static_cast<size_t>(2 * BNK + 4 * BMQ) * Head<DP>::LD * sizeof(T) +
                      4 * BMQ * sizeof(float) + 2 * BMQ * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP, SEG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.B * p.G, (p.Tkv + BNK - 1) / BNK, Head<DP>::NZ);
  flash_bwd_dkdv_kernel<T, DP, SEG><<<grid, NTHREADS, smem, stream>>>(p);
  return thunder::launch_status();
}

template <typename T, bool SEG>
int dispatch_dkdv(const BwdParams& p, int dp, cudaStream_t stream) {
  switch (dp) {
#define THUNDER_CASE(DPV) \
  case DPV:               \
    return launch_dkdv<T, DPV, SEG>(p, stream);
    THUNDER_FLASH_HEAD_BUCKETS(THUNDER_CASE)
#undef THUNDER_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const BwdParams& p, int dtype, int dp, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Tq;
  if (rows > 0) {
    flash_bwd_di_kernel<T><<<static_cast<unsigned>((rows + NWARPS - 1) / NWARPS), NTHREADS, 0, stream>>>(p);
    const int status = thunder::launch_status();
    if (status != 0) return status;
  }
  if (static_cast<long long>(p.B) * p.G * p.Tkv > 0) {
    const int status =
        p.qseg != nullptr ? dispatch_dkdv<T, true>(p, dp, stream) : dispatch_dkdv<T, false>(p, dp, stream);
    if (status != 0) return status;
  }
  return rows > 0 ? launch_bwd_dq(p, dtype, dp, stream) : 0;
}

}  // namespace

extern "C" int thunder_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const float* lse, void* dq, void* dk, void* dv, float* di, const int* qseg,
                                 const int* kvseg, int B, int H, int G,
                                 int Tq, int Tkv, int D, long long sqb, long long sqh, long long sqt,
                                 long long skb, long long skh, long long skt, long long svb, long long svh,
                                 long long svt, long long sob, long long soh, long long sot, long long sdob,
                                 long long sdoh, long long sdot, float scale, int causal, int dtype, int vec,
                                 int dp, void* stream) {
  if (D < 1 || D > dp || !(vec == 1 || vec == 2 || vec == 4 || vec == 8) || D % vec != 0 ||
      (qseg == nullptr) != (kvseg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.vec = vec;
  p.sq[0] = sqb; p.sq[1] = sqh; p.sq[2] = sqt;
  p.sk[0] = skb; p.sk[1] = skh; p.sk[2] = skt;
  p.sv[0] = svb; p.sv[1] = svh; p.sv[2] = svt;
  p.so[0] = sob; p.so[1] = soh; p.so[2] = sot;
  p.sdo[0] = sdob; p.sdo[1] = sdoh; p.sdo[2] = sdot;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  p.qseg = qseg;
  p.kvseg = kvseg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == thunder::kBF16) return launch<__nv_bfloat16>(p, dtype, dp, s);
  if (dtype == thunder::kF16) return launch<__half>(p, dtype, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
