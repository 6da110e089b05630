// K2, small-X form: single-head cross-attention of many query rows (frames or
// segments) over a few projected keys (action tokens or segments).
//
// Replaces fact_clip_tpu/ops/pallas/x2y_attn.py::_x2y_small_x_fwd_impl
// (_small_x_kernel).  One block per (tile of 64 query rows, video), three
// products on the GEMM core:
//   yq = (y + y_pos) @ Wq + bq                       (kept in shared memory)
//   logits = yq @ xk^T * scale, keys at or past x_len set to -1e9
//   probs = softmax(logits), attn = probs @ xv
// xk and xv are projected outside, as the TPU kernel's caller does (xk
// arrives transposed, (d, X), so that it is the second operand of a row-major
// product); the key axis is at most 1024 long.  The logits and probabilities
// are outputs, so the block writes them to global memory and reads them back
// (its own rows, from L1/L2) for the softmax and the attend.
//
// Bound on the H100: the q projection, 2 * B*Y*Cy*d FLOPs of f32 FMA
// (12.9 GFLOP for the u-block's a2f at B=8, Y=3072, Cy=d=512); the logits
// and the attend add 4 * B*Y*X*d (2 GFLOP at X=40).  Every product reads its
// second operand once per block of 64 rows, so each weight or key value
// fetched from L2 serves 64 rows.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;  // query rows per block

__global__ void __launch_bounds__(fk::kThreads)
x2y_small_x_kernel(const float* __restrict__ y, const float* __restrict__ ypos,
                   long long pos_bstride, int Py, const float* __restrict__ xkt,
                   const float* __restrict__ xv, const float* __restrict__ wq,
                   const float* __restrict__ bq, const int* __restrict__ xlen,
                   float* __restrict__ attn, float* __restrict__ probs,
                   float* __restrict__ logits, int Y, int X, int Cy, int d, float scale) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* yq = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * BM;
  const int rows = min(BM, Y - y0);
  const int xl = min(xlen[b], X);
  const float* yb = y + (size_t)b * Y * Cy;
  const float* pb = ypos ? ypos + (size_t)b * pos_bstride : nullptr;
  const float* xkb = xkt + (size_t)b * d * X;
  const float* xvb = xv + (size_t)b * X * d;
  float* lb = logits + ((size_t)b * Y + y0) * X;  // this block's rows
  float* prb = probs + ((size_t)b * Y + y0) * X;
  float* ab = attn + ((size_t)b * Y + y0) * d;
  float acc[RM][8];

  auto yq_in = [&](int r, int k) {  // y + pos: the query projection's input
    if (r >= rows) return 0.f;
    float v = __ldg(yb + (size_t)(y0 + r) * Cy + k);
    if (pb != nullptr && k < Py) v += __ldg(pb + (size_t)(y0 + r) * Py + k);
    return v;
  };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, yq_in, wq, d, Cy, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) yq[fk::pass_row<BM>(i) * d + c] = acc[i][j] + __ldg(bq + c);
      }
  }
  __syncthreads();

  // logits = yq @ xk^T * scale, masked keys -1e9, straight to global memory
  auto yq_elem = [&](int r, int k) { return yq[r * d + k]; };
  for (int n0 = 0; n0 < X; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, yq_elem, xkb, X, d, n0, X, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = n0 + fk::pass_col(j);
        if (key < X) lb[(size_t)r * X + key] = key < xl ? acc[i][j] * scale : fk::kMaskedLogit;
      }
    }
  }
  __syncthreads();  // the block's logits are visible to the whole block

  // softmax, one warp per row; plain loads: the rows were written above
  for (int r = ty; r < rows; r += fk::kWarps) {
    const float* lrow = lb + (size_t)r * X;
    float* prow = prb + (size_t)r * X;
    float mx = -INFINITY;
    for (int k = tx; k < X; k += 32) mx = fmaxf(mx, lrow[k]);
    mx = fk::warp_max(mx);
    float sum = 0.f;
    for (int k = tx; k < X; k += 32) sum += expf(lrow[k] - mx);
    const float inv = 1.f / fk::warp_sum(sum);
    for (int k = tx; k < X; k += 32) prow[k] = expf(lrow[k] - mx) * inv;
  }
  __syncthreads();

  // attn = probs @ xv
  auto p_elem = [&](int r, int k) { return r < rows ? prb[(size_t)r * X + k] : 0.f; };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, p_elem, xvb, d, X, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) ab[(size_t)r * d + c] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int fk_x2y_small_x(const float* y, const float* ypos, long long pos_bstride, int Py,
                              const float* xkt, const float* xv, const float* wq, const float* bq,
                              const int* xlen, float* attn, float* probs, float* logits, int B,
                              int Y, int X, int Cy, int d, float scale, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) + (size_t)BM * d * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_small_x_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Y + BM - 1) / BM, B);
  x2y_small_x_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      y, ypos, pos_bstride, Py, xkt, xv, wq, bq, xlen, attn, probs, logits, Y, X, Cy, d, scale);
  return (int)cudaGetLastError();
}
