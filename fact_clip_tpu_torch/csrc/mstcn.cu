// K1: one layer of the fused MSTCN tower (forward, dropout off).
//
// Replaces fact_clip_tpu/ops/pallas/dilated_conv.py::_stack_layer
// (_stack_kernel): for a tile of 64 frames of one video
//   h = relu(sum_k x[t + (k-1)d] @ Wd[k] + bd)      (dilated conv3, SAME zeros)
//   z = x[t] + h @ W1 + b1, then LayerNorm (eps) if use_ln
//   y[t] = z for t < len[b], 0 for t >= len[b]      (the tower's write mask)
// and, on the tower's last layer, logits[t] = y[t] @ Wo + bo (padded frames
// carry the bias row).  Frames at or past len[b] read as zeros, so the
// layer needs no pre-masked input.
//
// Bound on the H100: f32 FMA on the CUDA cores.  A layer is
// 2 * B*T * 4*C*C FLOPs (12.9 GFLOP at B=8, T=3072, C=256) against
// 2 * B*T*C*4 bytes of stream traffic, ~260 FLOP per byte, far above the
// card's f32 ridge (~20).  The design keeps the relu activations of the tile in
// shared memory between the two GEMMs and reads the dilated taps straight
// from global memory per tile: a dilation of up to 512 frames reaches far
// beyond any tile, and the taps' rows come from L2.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // frames per block

__global__ void __launch_bounds__(fk::kThreads)
mstcn_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const int* __restrict__ lengths,
                   const float* __restrict__ wd, const float* __restrict__ bd,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ ow, const float* __restrict__ ob,
                   float* __restrict__ logits, int T, int C, int O, int dil,
                   int use_ln, float eps) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* h = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);
  const int ldh = C + 4;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const int L = min(lengths[b], T);
  const float* xb = x + (size_t)b * T * C;
  float* yb = y + (size_t)b * T * C;
  float acc[RM][8];

  // stage 1: dilated conv as one GEMM over K = 3C (tap-major rows of Wd)
  auto taps = [&](int r, int k) {
    const int tap = k / C;
    const int t = t0 + r + (tap - 1) * dil;
    return (t >= 0 && t < L) ? __ldg(xb + (size_t)t * C + (k - tap * C)) : 0.f;
  };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, taps, wd, C, 3 * C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < C) h[fk::pass_row<BM>(i) * ldh + c] = fmaxf(acc[i][j] + __ldg(bd + c), 0.f);
      }
  }
  __syncthreads();

  // stage 2: 1x1 conv + bias + residual into the output stream
  auto relu_h = [&](int r, int k) { return h[r * ldh + k]; };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, relu_h, w1, C, C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + fk::pass_row<BM>(i);
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        float v = 0.f;
        if (t < L) v = acc[i][j] + __ldg(b1 + c) + __ldg(xb + (size_t)t * C + c);
        yb[(size_t)t * C + c] = v;
      }
    }
  }

  const int rows = min(BM, T - t0);
  if (use_ln) {
    __syncthreads();
    const int valid = max(0, min(rows, L - t0));
    fk::layer_norm_rows(yb + (size_t)t0 * C, rows, valid, C, gamma, beta, eps);
  }
  if (ow == nullptr) return;

  // stage 3 (last layer): out projection of the finished stream tile.  The
  // tile was written by this block, so it is read with coherent loads.
  __syncthreads();
  auto stream = [&](int r, int k) { return r < rows ? yb[(size_t)(t0 + r) * C + k] : 0.f; };
  float* lb = logits + (size_t)b * T * O;
  for (int n0 = 0; n0 < O; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, stream, ow, O, C, n0, O, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + fk::pass_col(j);
        if (o < O) lb[(size_t)(t0 + r) * O + o] = acc[i][j] + __ldg(ob + o);
      }
    }
  }
}

}  // namespace

extern "C" int fk_mstcn_layer(const float* x, float* y, const int* lengths, const float* wd,
                              const float* bd, const float* w1, const float* b1,
                              const float* gamma, const float* beta, const float* ow,
                              const float* ob, float* logits, int B, int T, int C, int O,
                              int dil, int use_ln, float eps, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) + (size_t)BM * (C + 4) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)mstcn_layer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  mstcn_layer_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, y, lengths, wd, bd, w1, b1, gamma, beta, ow, ob, logits, T, C, O, dil, use_ln, eps);
  return (int)cudaGetLastError();
}
