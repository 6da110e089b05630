// K8: the int8 evaluation's helper outside the towers' wgmma passes: the
// 8-row group maxima of a tower's input (the first layer's window scales of
// K8a and K8e, csrc/quant2.cu).
#include <math.h>

#include "common.cuh"

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

}  // namespace

extern "C" int fk_q8_group_max(const float* x, const int* len, float* gmax, int B, int T, int T_pad,
                               int C, void* stream) {
  const int G = T_pad / 8;
  q8_group_max_kernel<<<dim3((G + fk::kWarps - 1) / fk::kWarps, B), fk::kThreads, 0,
                        (cudaStream_t)stream>>>(x, len, gmax, T, G, C);
  return (int)cudaGetLastError();
}
