// Flash-attention forward (causal or full, optionally under segment ids)
// for sm_90a.
//
// Replaces the TPU splash-attention kernel reached from
// thunder_tpu/executors/flashex.py `_sdpa_impl` -> `_sdpa_runtime` ->
// `_splash_sdpa` (kernel built by `_splash_kernel`): with no mask, and, given
// segment ids, the masked and padded cases of `_sdpa_runtime` (key-padding
// and HF 4-D masks, verified on the host) that `_splash_sdpa` lowers to
// splash `SegmentIds`. When given an lse pointer it is also the
// residual-saving forward `_splash_fwd_res` / `_sdpa_fwd_res_impl`, and the
// recompute inside `_sdpa_bwd_impl`: the per-row logsumexp that the backward
// (flash_bwd.cu) consumes.
//
// What it computes: O = softmax(scale * Q K^T + causal mask) V with an online
// softmax, never materialising the (Tq, Tkv) scores in device memory.
//   q (B, H, Tq, D), k/v (B, G, Tkv, D), o (B, H, Tq, D) contiguous; bf16 or
//   f16; D <= 256. q/k/v may be strided views (last dim contiguous): the
//   kernel reads them through their b/h/t strides, so the slices of the fused
//   qkv projection are never copied. GQA reads kv head h / (H / G).
//   Causal: query i sees key j iff j <= i + (Tkv - Tq) (bottom-right aligned,
//   as the JAX package's decomposition and splash kernel do). Segment ids:
//   q_seg (B, Tq) and kv_seg (B, Tkv) int32, contiguous, both or neither;
//   query i also needs q_seg[b, i] == kv_seg[b, j] to see key j (splash's
//   SegmentIds semantics). A query that sees no key gets a zero row.
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
// Design (FlashAttention-2's forward on warp-level tensor-core products, the
//   building blocks of flash_common.cuh): one block of 4 warps per (b*h,
//   64-query tile, column chunk); each warp owns 16 query rows. The query
//   tiles are launched in reverse, so the heaviest causal blocks start first.
//   - Q's fragments are loaded once into registers (heads up to 128; larger
//     heads read them from shared memory at each tile).
//   - The block walks 64-key tiles up to the causal diagonal. K and V tiles
//     sit in a double-buffered ring in shared memory filled by cp.async, so
//     the next tile's copy overlaps this tile's products. Rows of 200 bytes
//     (D = 100) start 8-byte aligned, so copies are 8 bytes wide there; 16
//     where D and the strides allow, 4 or plain 2-byte loads where they do
//     not (the wrapper picks the width; each thread's share of a tile is
//     planned once per kernel). TMA would need 16-byte strides.
//   - S = Q K^T comes out in mma.sync's accumulator layout; the online
//     softmax runs there: row max and sum across the 4 lanes of a row by
//     shuffles, exp2f of the log2-scaled scores. The causal compare runs only
//     on tiles that cross the diagonal (and the key-range compare only on the
//     ragged last tile). Segment ids are a template flag: a warp skips a
//     tile whose keys lie in one segment that none of its rows has (left
//     padding), and compares only where its rows and keys are mixed.
//   - P is rounded to the input type in registers and is the A operand of
//     O += P V, whose V fragments come through ldmatrix.trans. O is an f32
//     register accumulator, rescaled in registers.
//   - A tile whose keys a row cannot see leaves that row's running max at
//     -inf; the rescale and the probabilities are guarded for it.
//   - Heads are padded to 32, 64, 112, 128 or 256 columns (zeros in shared
//     memory); above 128, the output columns are split over grid z in chunks
//     of 128 so the accumulator fits the registers, each chunk recomputing
//     the scores.
//   At D = 112 a block takes 61 KB of shared memory (Q's copy shares a K/V
//   slot): three blocks per SM.

#include "flash_common.cuh"

using namespace thunder::flash;

namespace {

constexpr int BM = 64;  // query rows per block, 16 per warp
constexpr int BN = 64;  // keys per tile

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // null: not wanted
  const int* qseg;   // (B, Tq) segment ids, or null with kvseg: no segments
  const int* kvseg;  // (B, Tkv)
  int B, H, G, Tq, Tkv, D;
  int vec;                        // elements per global-to-shared copy
  long long sq[3], sk[3], sv[3];  // b, h, t strides in elements
  float scale_log2;               // scale * log2(e)
  int causal;
};

template <int DP>
__host__ __device__ constexpr int smem_rows() {
  return 4 * BN + (DP <= 128 ? 0 : BM);  // K/V ring, and Q when it is not held in registers
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(FlashParams p) {
  constexpr int LD = Head<DP>::LD;
  constexpr int DC = Head<DP>::DC;
  constexpr int KT = Head<DP>::KT;
  constexpr bool Q_REGS = DP <= 128;
  constexpr int NS = BN / 8;  // n8 tiles of S
  constexpr int NO = DC / 8;  // n8 tiles of O
  static_assert(BM == BN, "Q's copy takes a K slot of the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);          // ring slot s: K at base + 2s BN LD, V after it
  T* Qs = Q_REGS ? base + 2 * BN * LD : base + 4 * BN * LD;
  int* kseg_s = reinterpret_cast<int*>(base + smem_rows<DP>() * LD);  // [2][BN]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int d0 = blockIdx.z * DC;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.G);
  const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const int offset = p.Tkv - p.Tq;
  const int n_end = p.causal ? min(p.Tkv, m0 + BM + offset) : p.Tkv;
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;

  const Chunks ch = chunks_of(p.D, p.vec);
  zero_pad_columns<T, DP>(base, smem_rows<DP>(), p.D);
  __syncthreads();

  auto issue_kv = [&](int n) {
    T* kd = base + (n & 1) * 2 * BN * LD;
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

  load_rows<T, BM>(Qs, LD, qb, p.sq[2], m0, p.Tq, ch, p.vec);
  cp_async_commit();
  if (n_tiles > 0) issue_kv(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[Q_REGS ? KT : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);
    __syncthreads();  // Q's slot takes tile 1
  }

  // This lane's rows: r0 (accumulator entries 0, 1) and r0 + 8 (entries 2, 3).
  const int wrow = m0 + warp * 16;
  const int r0 = wrow + g;
  int qs[2] = {0, 0};
  if constexpr (SEG) {
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + hf * 8;
      qs[hf] = r < p.Tq ? p.qseg[static_cast<long long>(b) * p.Tq + r] : 0;
    }
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sum
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles) issue_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile n has landed for every thread
    const T* Kt = base + (n & 1) * 2 * BN * LD;
    const T* Vt = Kt + BN * LD;
    const int* ks = kseg_s + (n & 1) * BN;
    const SegTile seg = SEG ? seg_tile<BN>(ks, qs[0], qs[1], lane) : SegTile{false, false};
    if (!seg.skip) {
      // S = Q K^T for this warp's 16 rows.
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        if constexpr (Q_REGS) {
          a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
        } else {
          load_a(a, Qs, LD, warp * 16, kk * 16, lane);
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_rows(bb, Kt, LD, np * 16, kk * 16, lane);
          mma<T>(s[2 * np], a, bb[0], bb[1]);
          mma<T>(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // Log2-scaled scores; masked ones -inf. The causal compare runs only on a
      // tile that crosses this warp's diagonal, the range compare only on the
      // ragged last tile.
      const int n0 = n * BN;
      const bool edge = n0 + BN > p.Tkv || (p.causal && n0 + BN - 1 > wrow + offset);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale_log2;
      if (seg.compare || edge) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + (e & 1);
            const int col = n0 + c;
            bool ok = col < p.Tkv && (!p.causal || col <= r0 + (e >> 1) * 8 + offset);
            if constexpr (SEG) ok = ok && ks[c] == qs[e >> 1];
            if (!ok) s[j][e] = -INFINITY;
          }
      }

      // Online softmax in the accumulator layout: a row's 64 scores lie in the
      // 4 lanes of its quad.
      float alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hf], mx);
        alpha[hf] = m_new == -INFINITY ? 1.f : exp2f(m_run[hf] - m_new);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no visible key yet: P = 0
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j][2 * hf] = exp2f(s[j][2 * hf] - m_use);
          s[j][2 * hf + 1] = exp2f(s[j][2 * hf + 1] - m_use);
          sum += s[j][2 * hf] + s[j][2 * hf + 1];
        }
        l_run[hf] = l_run[hf] * alpha[hf] + sum;
        m_run[hf] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P V: P from registers, rounded to the input type.
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        uint32_t a[4];
        acc_to_a<T>(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          uint32_t bb[4];
          load_b_cols(bb, Vt, LD, kc * 16, d0 + dp * 16, lane);
          mma<T>(o[2 * dp], a, bb[0], bb[1]);
          mma<T>(o[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }

  // O / l; a row that saw no key is zero.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 1);
    l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 2);
  }
  T* og = static_cast<T*>(p.o) + static_cast<long long>(bh) * p.Tq * p.D;
  store_acc<T, NO>(og, o, wrow, p.Tq, d0, p.D, l_run[0] > 0.f ? 1.f / l_run[0] : 0.f,
                   l_run[1] > 0.f ? 1.f / l_run[1] : 0.f, lane);
  if (p.lse != nullptr && blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + hf * 8;
      if (r < p.Tq)
        p.lse[static_cast<long long>(bh) * p.Tq + r] =
            l_run[hf] > 0.f ? m_run[hf] * 0.6931471805599453f + logf(l_run[hf]) : -INFINITY;
    }
  }
}

template <typename T, int DP, bool SEG>
int launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_rows<DP>()) * Head<DP>::LD * sizeof(T) + 2 * BN * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.B * p.H == 0 || p.Tq == 0) return 0;
  dim3 grid(p.B * p.H, (p.Tq + BM - 1) / BM, Head<DP>::NZ);
  flash_fwd_kernel<T, DP, SEG><<<grid, NTHREADS, smem, stream>>>(p);
  return thunder::launch_status();
}

template <typename T, bool SEG>
int dispatch(const FlashParams& p, int dp, cudaStream_t stream) {
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

extern "C" int thunder_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                 const int* qseg, const int* kvseg, int B, int H,
                                 int G, int Tq, int Tkv, int D, long long sqb, long long sqh,
                                 long long sqt, long long skb, long long skh, long long skt,
                                 long long svb, long long svh, long long svt, float scale,
                                 int causal, int dtype, int vec, int dp, void* stream) {
  if (D < 1 || D > dp || !(vec == 1 || vec == 2 || vec == 4 || vec == 8) || D % vec != 0 ||
      (qseg == nullptr) != (kvseg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.qseg = qseg;
  p.kvseg = kvseg;
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
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg = qseg != nullptr;
  if (dtype == thunder::kBF16)
    return seg ? dispatch<__nv_bfloat16, true>(p, dp, s) : dispatch<__nv_bfloat16, false>(p, dp, s);
  if (dtype == thunder::kF16) return seg ? dispatch<__half, true>(p, dp, s) : dispatch<__half, false>(p, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
