// K2 backward: single-head X2Y cross-attention, both forms.
//
// Small-X form: replaces fact_clip_tpu/ops/pallas/x2y_attn.py::
// _x2y_small_x_bwd_impl (_small_x_bwd_kernel).  One block per (tile of 64
// query rows, video), from the saved probabilities and the cotangents of
// (attn, probs, logits):
//   dprobs = g_probs + g_attn @ xv^T
//   dlogits = (probs * (dprobs - rowsum(probs * dprobs)) + g_logits) * scale,
//             exactly zero at keys at or past x_len (the -1e9 logits)
//   yq = (y + y_pos) @ Wq + bq        (recomputed, for dxk)
//   dyq = dlogits @ xk,  dy = dyq @ Wq^T
// The block writes dlogits, yq, dyq, dy and its column sums of dyq (dbq).
// The sums over query rows, dxk = dlogits^T yq and dxv = probs^T g_attn per
// video and dWq = (y + y_pos)^T dyq, are grad.cu's fk_atb + fk_reduce, and so
// is the batch sum of d_ypos; the X-side projections' grads stay plain
// matmuls outside, as in the JAX caller.
//
// Flash form: replaces _x2y_flash_bwd_impl (_flash_bwd_kernel).  The TPU
// kernel walks the key tiles in order and carries dyq and the weight grads in
// VMEM; here one block per (tile of 64 keys, video) works alone:
//   xk = (x + x_pos) @ Wk + bk (written, for dyq), xv = x @ Wv + bv (shared memory)
//   dlogits^T = (probs * (g_probs + xv g_attn^T - D) + g_logits) * scale,
//               zero at keys at or past x_len; D = rowsum(probs * g_probs) +
//               rowsum(g_attn * attn) comes from the caller
//   dxv = probs^T g_attn,  dxk = dlogits^T yq,  dx = dxk Wk^T + dxv Wv^T
// It writes xk, dlogits^T, dxk, dxv, dx and its column sums of dxk, dxv (dbk,
// dbv).  dyq = dlogits @ xk per video, dWk = (x + x_pos)^T dxk, dWv = x^T dxv
// and the batch sum of d_xpos are fk_atb + fk_reduce: fixed order, no
// atomics.  The q projection's grads stay outside, as in the JAX caller.
//
// Bound on the H100: f32 FMA.  The flash form recomputes both projections
// and runs the dx product, 6 * B*X*Cx*d FLOPs (38.7 GFLOP for the u-block's
// f2a at B=8, X=3072, Cx=d=512), with the weight products as much again in
// fk_atb; the small-X form the q projection, dy and dWq (3 * 12.9 GFLOP for
// the a2f).  The (B, Y, X) and (B, X, M) intermediates are small next to
// that (X or M is 40).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;     // query rows (small-X) or keys (flash) per block
constexpr int kMaxM = 64;  // flash: query rows per video, held in shared memory

__global__ void __launch_bounds__(fk::kThreads)
x2y_sx_bwd_kernel(const float* __restrict__ y, const float* __restrict__ ypos,
                  long long pos_bstride, int Py, const float* __restrict__ probs,
                  const float* __restrict__ gprobs, const float* __restrict__ glogits,
                  const float* __restrict__ gattn, const float* __restrict__ xk,
                  const float* __restrict__ xvt, const float* __restrict__ wq,
                  const float* __restrict__ wqt, const float* __restrict__ bq,
                  const int* __restrict__ xlen, float* __restrict__ dlog,
                  float* __restrict__ yq, float* __restrict__ dyq, float* __restrict__ dy,
                  float* __restrict__ part_bq, int Y, int X, int Cy, int d, float scale) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* Sq = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * BM;
  const int rows = min(BM, Y - y0);
  const int xl = min(xlen[b], X);
  const int blk = b * gridDim.x + blockIdx.x;
  const size_t rx = ((size_t)b * Y + y0) * X;  // this block's rows of (B, Y, X)
  const size_t rd = ((size_t)b * Y + y0) * d;  // of (B, Y, d)
  float* lb = dlog + rx;
  const float* prb = probs + rx;
  const float* pb = ypos ? ypos + (size_t)b * pos_bstride : nullptr;
  float acc[RM][8];

  // 1. dprobs = g_attn @ xv^T (+ g_probs), into the dlogits buffer
  auto ga = [&](int r, int k) { return r < rows ? __ldg(gattn + rd + (size_t)r * d + k) : 0.f; };
  for (int n0 = 0; n0 < X; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, ga, xvt + (size_t)b * d * X, X, d, n0, X, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = n0 + fk::pass_col(j);
        if (key >= X) continue;
        float v = acc[i][j];
        if (gprobs != nullptr) v += __ldg(gprobs + rx + (size_t)r * X + key);
        lb[(size_t)r * X + key] = v;
      }
    }
  }
  __syncthreads();

  // 2. softmax backward, one warp per row; plain loads: written above
  for (int r = threadIdx.x >> 5; r < rows; r += fk::kWarps) {
    float* lrow = lb + (size_t)r * X;
    const float* prow = prb + (size_t)r * X;
    float D = 0.f;
    for (int k = lane; k < X; k += 32) D += prow[k] * lrow[k];
    D = fk::warp_sum(D);
    for (int k = lane; k < X; k += 32) {
      float v = prow[k] * (lrow[k] - D);
      if (glogits != nullptr) v += __ldg(glogits + rx + (size_t)r * X + k);
      lrow[k] = k < xl ? v * scale : 0.f;
    }
  }
  __syncthreads();

  // 3. yq = (y + y_pos) @ Wq + bq
  auto yq_in = [&](int r, int k) {
    if (r >= rows) return 0.f;
    float v = __ldg(y + ((size_t)b * Y + y0 + r) * Cy + k);
    if (pb != nullptr && k < Py) v += __ldg(pb + (size_t)(y0 + r) * Py + k);
    return v;
  };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, yq_in, wq, d, Cy, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) yq[rd + (size_t)r * d + c] = acc[i][j] + __ldg(bq + c);
      }
    }
  }

  // 4. dyq = dlogits @ xk, kept in shared memory
  auto dl = [&](int r, int k) { return r < rows ? lb[(size_t)r * X + k] : 0.f; };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, dl, xk + (size_t)b * X * d, d, X, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= d) continue;
        Sq[r * d + c] = acc[i][j];
        if (r < rows) dyq[rd + (size_t)r * d + c] = acc[i][j];
      }
    }
  }
  __syncthreads();
  fk::block_colsum(Sq, d, rows, d, part_bq + (size_t)blk * d);

  // 5. dy = dyq @ Wq^T
  auto sq = [&](int r, int k) { return Sq[r * d + k]; };
  for (int n0 = 0; n0 < Cy; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, sq, wqt, Cy, d, n0, Cy, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < Cy) dy[((size_t)b * Y + y0 + r) * Cy + c] = acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(fk::kThreads)
x2y_flash_bwd_kernel(const float* __restrict__ x, const float* __restrict__ xpos,
                     long long pos_bstride, int Px, const float* __restrict__ probs,
                     const float* __restrict__ gprobs, const float* __restrict__ glogits,
                     const float* __restrict__ gattn, const float* __restrict__ gattnt,
                     const float* __restrict__ yq, const float* __restrict__ Dr,
                     const float* __restrict__ wk, const float* __restrict__ bk,
                     const float* __restrict__ wv, const float* __restrict__ bv,
                     const float* __restrict__ wkvt, const int* __restrict__ xlen,
                     float* __restrict__ xk, float* __restrict__ dlogt, float* __restrict__ dxk,
                     float* __restrict__ dxv, float* __restrict__ dx, float* __restrict__ part_b,
                     int X, int Cx, int M, int d, float scale) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* Sv = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);
  float* Sl = Sv + BM * d;  // (BM, M) dlogits^T of the tile

  const int b = blockIdx.y;
  const int x0 = blockIdx.x * BM;
  const int rows = min(BM, X - x0);
  const int xl = min(xlen[b], X);
  const int blk = b * gridDim.x + blockIdx.x;
  const float* xb = x + ((size_t)b * X + x0) * Cx;
  const float* pb = xpos ? xpos + (size_t)b * pos_bstride : nullptr;
  const size_t rd = ((size_t)b * X + x0) * d;
  float acc[RM][8];

  // 1. xk = (x + x_pos) @ Wk + bk, written for dyq
  auto xk_in = [&](int r, int k) {
    if (r >= rows) return 0.f;
    float v = __ldg(xb + (size_t)r * Cx + k);
    if (pb != nullptr && k < Px) v += __ldg(pb + (size_t)(x0 + r) * Px + k);
    return v;
  };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, xk_in, wk, d, Cx, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) xk[rd + (size_t)r * d + c] = acc[i][j] + __ldg(bk + c);
      }
    }
  }

  // 2. xv = x @ Wv + bv into shared memory
  auto x_in = [&](int r, int k) { return r < rows ? __ldg(xb + (size_t)r * Cx + k) : 0.f; };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, x_in, wv, d, Cx, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) Sv[r * d + c] = r < rows ? acc[i][j] + __ldg(bv + c) : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. dlogits^T of the tile: (xv @ g_attn^T)^T is dprobs' share of g_attn
  auto sv = [&](int r, int k) { return Sv[r * d + k]; };
  fk::gemm_pass<BM>(acc, sv, gattnt + (size_t)b * d * M, M, d, 0, M, s);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = fk::pass_row<BM>(i);
    const int t = x0 + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = fk::pass_col(j);
      if (m >= M) continue;
      float v = 0.f;
      if (r < rows && t < xl) {
        const size_t e = ((size_t)b * M + m) * X + t;
        float dp = acc[i][j];
        if (gprobs != nullptr) dp += __ldg(gprobs + e);
        v = __ldg(probs + e) * (dp - __ldg(Dr + (size_t)b * M + m));
        if (glogits != nullptr) v += __ldg(glogits + e);
        v *= scale;
      }
      Sl[r * M + m] = v;
      if (r < rows) dlogt[((size_t)b * X + t) * M + m] = v;
    }
  }
  __syncthreads();

  // 4. dxv = probs^T @ g_attn
  auto pt = [&](int r, int m) {
    return r < rows ? __ldg(probs + ((size_t)b * M + m) * X + x0 + r) : 0.f;
  };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, pt, gattn + (size_t)b * M * d, d, M, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) dxv[rd + (size_t)r * d + c] = acc[i][j];
      }
    }
  }

  // 5. dxk = dlogits^T @ yq
  auto sl = [&](int r, int m) { return Sl[r * M + m]; };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, sl, yq + (size_t)b * M * d, d, M, n0, d, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < d) dxk[rd + (size_t)r * d + c] = acc[i][j];
      }
    }
  }
  __syncthreads();  // this block's dxk and dxv rows are visible to the whole block

  // 6. column sums for dbk, dbv
  fk::block_colsum(dxk + rd, d, rows, d, part_b + (size_t)blk * 2 * d);
  fk::block_colsum(dxv + rd, d, rows, d, part_b + (size_t)blk * 2 * d + d);

  // 7. dx = [dxk | dxv] @ [Wk^T ; Wv^T]; plain loads: written above
  auto cat = [&](int r, int k) {
    if (r >= rows) return 0.f;
    return k < d ? dxk[rd + (size_t)r * d + k] : dxv[rd + (size_t)r * d + (k - d)];
  };
  for (int n0 = 0; n0 < Cx; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, cat, wkvt, Cx, 2 * d, n0, Cx, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < Cx) dx[((size_t)b * X + x0 + r) * Cx + c] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int fk_x2y_sx_bwd(const float* y, const float* ypos, long long pos_bstride, int Py,
                             const float* probs, const float* gprobs, const float* glogits,
                             const float* gattn, const float* xk, const float* xvt,
                             const float* wq, const float* wqt, const float* bq, const int* xlen,
                             float* dlog, float* yq, float* dyq, float* dy, float* part_bq,
                             int B, int Y, int X, int Cy, int d, float scale, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) + (size_t)BM * d * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_sx_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Y + BM - 1) / BM, B);
  x2y_sx_bwd_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      y, ypos, pos_bstride, Py, probs, gprobs, glogits, gattn, xk, xvt, wq, wqt, bq, xlen, dlog,
      yq, dyq, dy, part_bq, Y, X, Cy, d, scale);
  return (int)cudaGetLastError();
}

extern "C" int fk_x2y_flash_bwd(const float* x, const float* xpos, long long pos_bstride, int Px,
                                const float* probs, const float* gprobs, const float* glogits,
                                const float* gattn, const float* gattnt, const float* yq,
                                const float* Dr, const float* wk, const float* bk,
                                const float* wv, const float* bv, const float* wkvt,
                                const int* xlen, float* xk, float* dlogt, float* dxk,
                                float* dxv, float* dx, float* part_b, int B, int X, int Cx,
                                int M, int d, float scale, void* stream) {
  if (M > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(fk::GemmSmem<BM>) + (size_t)BM * (d + M) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_flash_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((X + BM - 1) / BM, B);
  x2y_flash_bwd_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, xpos, pos_bstride, Px, probs, gprobs, glogits, gattn, gattnt, yq, Dr, wk, bk, wv, bv,
      wkvt, xlen, xk, dlogt, dxk, dxv, dx, part_b, X, Cx, M, d, scale);
  return (int)cudaGetLastError();
}
