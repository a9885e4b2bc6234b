// What the flash-attention backward's two files (flash_bwd.cu: the Di
// pre-pass, the dK/dV kernel and the entry point; flash_bwd_dq.cu: the dQ
// kernel) share. See flash_bwd.cu for what they compute.
#pragma once

#include "flash_common.cuh"

namespace thunder {
namespace flash {

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
  int B, H, G, Tq, Tkv, D;
  int vec;  // elements per global-to-shared copy of q, k, v, dout
  long long sq[3], sk[3], sv[3], so[3], sdo[3];  // b, h, t strides in elements
  float scale;
  float scale_log2;  // scale * log2(e)
  int causal;
  const int* qseg;   // (B, Tq), or null with kvseg: no segments
  const int* kvseg;  // (B, Tkv)
};

// A row's logsumexp in log2 units for P = exp2(scale_log2 * s - lse2): a row
// past Tq (`in_range` false) or that saw no key (lse -inf) gets +inf, so its
// P is 0.
__device__ __forceinline__ float lse2_of(float lse, bool in_range) {
  return in_range && lse != -INFINITY ? lse * LOG2E : INFINITY;
}

// Launch the dQ kernel for head bucket dp (flash_bwd_dq.cu).
int launch_bwd_dq(const BwdParams& p, int dtype, int dp, cudaStream_t stream);

}  // namespace flash
}  // namespace thunder
