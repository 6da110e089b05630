// K8: the int8 evaluation's helpers outside the towers' wgmma passes: the
// 8-row group maxima of a tower's input (the first layer's window scales of
// K8a and K8e, csrc/quant2.cu) and the row quantizer of K8b's and K8c's
// int8 projections (their attention stages live beside their f32 twins in
// x2y_attn.cu and flash_attn.cu, their integer products on quant.cuh's
// mma.sync core).
#include <math.h>

#include "quant.cuh"

namespace {

__global__ void __launch_bounds__(fk::kThreads)
q8_group_max_kernel(const float* __restrict__ x, const int* __restrict__ len, float* gmax, int T,
                    int G, int C) {
  const int lane = threadIdx.x & 31;
  const int gi = blockIdx.x * fk::kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (gi >= G) return;
  const int lim = min(len[b], T);
  float m = 0.f;
  for (int r = gi * 8; r < gi * 8 + 8 && r < lim; ++r)
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(__ldg(x + ((size_t)b * T + r) * C + c)));
  m = fk::warp_max(m);
  if (lane == 0) gmax[(size_t)b * G + gi] = m;
}

// q[row] = round((x + pos)[row] * 127 / s[row]), s[row] = max(absmax, 1e-12),
// one warp per row of x (B x N rows of C); pos (on the leading P channels,
// batch stride pos_bstride) may be null.
__global__ void __launch_bounds__(fk::kThreads)
q8_rows_kernel(const float* __restrict__ x, const float* __restrict__ pos, long long pos_bstride,
               int P, int N, int C, int rows, int8_t* q, float* s) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * fk::kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int b = row / N;
  const float* xr = x + (size_t)row * C;
  const float* pr = pos ? pos + (size_t)b * pos_bstride + (size_t)(row - b * N) * P : nullptr;
  auto val = [&](int c) {
    const float v = __ldg(xr + c);
    return pr != nullptr && c < P ? __fadd_rn(v, __ldg(pr + c)) : v;
  };
  float m = 0.f;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(val(c)));
  const float sc = fmaxf(fk::warp_max(m), 1e-12f);
  const float inv = __fdiv_rn(127.f, sc);
  for (int c = lane; c < C; c += 32) q[(size_t)row * C + c] = (int8_t)fk::quant_s8(val(c), inv);
  if (lane == 0) s[row] = sc;
}

}  // namespace

extern "C" int fk_q8_group_max(const float* x, const int* len, float* gmax, int B, int T, int T_pad,
                               int C, void* stream) {
  const int G = T_pad / 8;
  q8_group_max_kernel<<<dim3((G + fk::kWarps - 1) / fk::kWarps, B), fk::kThreads, 0,
                        (cudaStream_t)stream>>>(x, len, gmax, T, G, C);
  return (int)cudaGetLastError();
}

extern "C" int fk_q8_rows(const float* x, const float* pos, long long pos_bstride, int P, int B,
                          int N, int C, int8_t* q, float* s, void* stream) {
  const int rows = B * N;
  q8_rows_kernel<<<(rows + fk::kWarps - 1) / fk::kWarps, fk::kThreads, 0,
                   (cudaStream_t)stream>>>(x, pos, pos_bstride, P, N, C, rows, q, s);
  return (int)cudaGetLastError();
}
