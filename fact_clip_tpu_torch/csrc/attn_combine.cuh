// The fixed-order combine of per-key-tile softmax partials, shared by the
// flash forwards of flash_attn.cu (K2's flash form, K8c) and K3's per-head
// forward (mha_attn.cu, which K8d's attention runs too): one block per
// (head, query row, video) merges the tiles' (m, l, acc) into the
// attention output, in tile order
// within each thread and then in warp order (no atomics: the same bits on
// every run).  For the single-head form it also writes probs = exp(logit -
// m_max) / l_total; for K3's backward the row's softmax stats (m_max,
// l_total).  Partials: part_ml (B, n_t, H*M, 2), part_acc (B, n_t, H*M, hd).
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  v = is_max ? fk::warp_max(v) : fk::warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < fk::kWarps; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

__global__ void __launch_bounds__(fk::kThreads)
proj_attn_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                         int n_t, int M, int H, int hd, float* __restrict__ out,
                         const float* __restrict__ logits, float* __restrict__ probs, int X,
                         float* __restrict__ stats) {
  extern __shared__ float4 smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [kThreads]
  float* w = red + fk::kThreads;                    // [n_t]
  const int tid = threadIdx.x;
  const int hm = blockIdx.x;
  const int b = blockIdx.y;
  const int HM = H * M;
  const int h = hm / M;
  const int m = hm - h * M;
  const float* ml = part_ml + ((size_t)b * n_t * HM + hm) * 2;

  float mx = -INFINITY;
  for (int t = tid; t < n_t; t += fk::kThreads) mx = fmaxf(mx, ml[(size_t)t * HM * 2]);
  mx = block_reduce(mx, red, true);
  float l = 0.f;
  for (int t = tid; t < n_t; t += fk::kThreads) {
    const float wt = expf(ml[(size_t)t * HM * 2] - mx);
    w[t] = wt;
    l += wt * ml[(size_t)t * HM * 2 + 1];
  }
  l = block_reduce(l, red, false);  // its barriers also publish w[]
  const float inv = 1.f / fmaxf(l, 1e-30f);
  if (stats != nullptr && tid == 0) {
    stats[((size_t)b * HM + hm) * 2] = mx;
    stats[((size_t)b * HM + hm) * 2 + 1] = l;
  }

  const float* pa = part_acc + ((size_t)b * n_t * HM + hm) * hd;
  const size_t tstride = (size_t)HM * hd;
  float* o = out + ((size_t)b * M + m) * (H * hd) + h * hd;
  const int DD = hd < fk::kThreads ? hd : fk::kThreads;  // threads per row slice
  const int TG = fk::kThreads / DD;                       // tile groups
  const int g = tid / DD;
  const int dd0 = tid - g * DD;
  if (TG == 1) {
    for (int dd = dd0; dd < hd; dd += DD) {
      float a = 0.f;
      for (int t = 0; t < n_t; ++t) a = fmaf(w[t], pa[t * tstride + dd], a);
      o[dd] = a * inv;
    }
  } else {
    // hd < 256: several tile groups per output column, summed through smem
    __syncthreads();
    float a = 0.f;
    if (g < TG)
      for (int t = g; t < n_t; t += TG) a = fmaf(w[t], pa[t * tstride + dd0], a);
    red[tid] = a;
    __syncthreads();
    if (g == 0) {
      for (int i = 1; i < TG; ++i) a += red[i * DD + dd0];
      o[dd0] = a * inv;
    }
  }

  if (probs != nullptr) {
    const float* lr = logits + ((size_t)b * M + m) * X;
    float* pr = probs + ((size_t)b * M + m) * X;
    for (int xk = tid; xk < X; xk += fk::kThreads) pr[xk] = expf(lr[xk] - mx) * inv;
  }
}

cudaError_t launch_combine(const float* part_acc, const float* part_ml, int B, int n_t, int M,
                           int H, int hd, float* out, const float* logits, float* probs, int X,
                           float* stats, cudaStream_t stream) {
  const size_t smem_c = ((size_t)fk::kThreads + n_t) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)proj_attn_combine_kernel, smem_c);
  if (err != cudaSuccess) return err;
  proj_attn_combine_kernel<<<dim3(H * M, B), fk::kThreads, smem_c, stream>>>(
      part_acc, part_ml, n_t, M, H, hd, out, logits, probs, X, stats);
  return cudaGetLastError();
}

}  // namespace
