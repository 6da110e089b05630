// K2, small-X form: single-head cross-attention of many query rows (frames or
// segments) over a few projected keys (action tokens or segments).
//
// Replaces fact_clip_tpu/ops/pallas/x2y_attn.py::_x2y_small_x_fwd_impl
// (_small_x_kernel).  On the H100 the work splits by what bounds it, one
// host call (fk_x2y_sx_fwd; ops/x2y_attn.py::_x2y_small_x_fwd_card):
//   yq = (y + y_pos) @ Wq + bq: one 3xTF32 GEMM of tc_tower.cuh (epilogue
//     kProj), every query row, on y + y_pos from sx_attn.cuh's prep;
//   kv = [xk | xv], the projection of the keys (outside the TPU kernel, in
//     its caller), one more launch of the same GEMM, zero at keys at or past
//     x_len (all X keys of a video with x_len = 0);
//   the attention (this file, x2y_sx_attn_kernel): one block per (tile of
//     BQ = 8-32 query rows, video), f32 FMA on sx_attn.cuh's panels:
//       logits = yq xk^T * scale, -1e9 at keys at or past x_len,
//       probs = softmax(logits), attn = probs xv,
//     the logits and probs kept in shared memory (X <= 1024) and written
//     once.
// Bound on the H100: the q projection, 2 * B*Y*Cy*d FLOPs (12.9 GFLOP for
// the u-block's a2f at B=8, Y=3072, Cy=d=512: 0.078 ms as three TF32 passes
// at 495 TFLOP/s); the logits and the attend add 4 * B*Y*X*d (2 GFLOP at
// X=40, 0.030 ms of f32 FMA).  Short query tiles fill the card at epic's
// B=2, Y=256-300 (64-76 blocks where 64-row tiles gave 8-10); one host
// call keeps the host's share of a call at epic's shapes small (the same
// sequence driven from Python took 0.32 ms of host time a call, H100 80GB
// HBM3, 700 W).
//
// K8b, the int8 twin (x2y_small_x_q8_kernel), replaces
// fact_clip_tpu/ops/pallas/quant_conv.py::_x2y_small_x_q8_impl
// (_x2y_small_x_kernel_q8): the frame rows y + y_pos arrive quantized per row
// (quant.cu's q8_rows_kernel: int8 values and each row's absmax s_y), the q
// projection is an int8 GEMM on quant.cuh's mma.sync core, dequantized in
// JAX's order fma(idot * s_y, swq, bq) (ops/quant_conv.py), and the logits,
// softmax and attend are small_x_attend's on common.cuh's f32 GEMM core, one
// block per (64 query rows, video); xk arrives transposed, (d, X), and xv
// (X, d), projected outside.
#include <math.h>

#include "common.cuh"
#include "quant.cuh"
#include "sx_attn.cuh"

namespace {

constexpr int BM = 64;  // query rows per block of K8b
// floats at the front of K8b's block memory: the f32 GEMM staging and the
// int8 staging in the same place
constexpr int kStageFloats =
    (sizeof(fk::GemmSmem<BM>) > sizeof(fk::QSmem<BM>) ? sizeof(fk::GemmSmem<BM>)
                                                      : sizeof(fk::QSmem<BM>)) / sizeof(float);

// logits = yq @ xk^T * scale (masked keys -1e9), probs = softmax(logits),
// attn = probs @ xv for the block's rows, from yq (BM x d) in shared memory
__device__ __forceinline__ void small_x_attend(const float* yq, fk::GemmSmem<BM>& s,
                                               const float* __restrict__ xkb,
                                               const float* __restrict__ xvb, int rows, int xl,
                                               int X, int d, float scale, float* lb, float* prb,
                                               float* ab) {
  constexpr int RM = BM / 8;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float acc[RM][8];
  // logits straight to global memory
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

// The attention of x2y_small_x_fwd: logits, probs and attn of the block's
// BQ = 4R query rows from the projected queries yq (B, Y, d) and kv = [xk |
// xv] (B, X, 2d).  Key tiles wholly past x_len compute nothing (their logits
// are -1e9, their probabilities exactly 0), and neither do a video's keys at
// x_len = 0 (every logit -1e9: it attends uniformly to all X values).
template <int R>
__global__ void __launch_bounds__(fk::kThreads, 2)
x2y_sx_attn_kernel(const float* __restrict__ yq, const float* __restrict__ kv,
                   const int* __restrict__ xlen, int Y, int X, int d, float scale,
                   float* __restrict__ logits, float* __restrict__ probs,
                   float* __restrict__ attn) {
  constexpr int BQ = 4 * R;
  extern __shared__ float4 smem_raw[];
  const int ls = fk::sx_pad(X);
  float* Q = reinterpret_cast<float*>(smem_raw);  // (BQ, d + 4): the tile's yq rows
  float* S = Q + BQ * (d + 4);                     // (BQ, ls): logits, then probs
  float* panel = S + BQ * ls;
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6, lane = tid & 31;
  const int b = blockIdx.y, y0 = blockIdx.x * BQ;
  const int rows = min(BQ, Y - y0);
  const int xl = min(xlen[b], X);
  const float* kvb = kv + (size_t)b * X * 2 * d;
  const size_t rx = ((size_t)b * Y + y0) * X;  // this block's rows of (B, Y, X)
  fk::sx_stage_rows(Q, yq + ((size_t)b * Y + y0) * d, BQ, rows, d);

  // 1. logits = yq xk^T * scale; -1e9 at keys at or past x_len
  for (int j0 = 0; j0 < X; j0 += fk::kSxKeys) {
    float acc[R] = {};
    if (j0 < xl) fk::sx_dots<R>(acc, Q, d, kvb, X, 0, j0, panel);  // block-uniform
    const int j = j0 + tx;
    if (j >= ls) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = R * ty + i;
      const float v = j < xl ? acc[i] * scale : fk::kMaskedLogit;
      S[m * ls + j] = j < X ? v : 0.f;  // the row's padding to 16 bytes: 0 (sx_attend)
      if (m < rows && j < X) logits[rx + (size_t)m * X + j] = v;
    }
  }
  __syncthreads();

  // 2. softmax, one warp per row
  for (int m = tid >> 5; m < rows; m += fk::kWarps) {
    float* srow = S + m * ls;
    float mx = -INFINITY;
    for (int k = lane; k < X; k += 32) mx = fmaxf(mx, srow[k]);
    mx = fk::warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < X; k += 32) sum += expf(srow[k] - mx);
    const float inv = 1.f / fk::warp_sum(sum);
    float* prow = probs + rx + (size_t)m * X;
    for (int k = lane; k < X; k += 32) {
      const float p = expf(srow[k] - mx) * inv;
      srow[k] = p;
      prow[k] = p;
    }
  }

  // 3. attn = probs xv over the keys whose probability can be non-zero
  const int nk = xl > 0 ? xl : X;
  for (int n0 = 0; n0 < d; n0 += fk::kSxNC) {
    float acc[R][4];
    fk::sx_attend<R>(acc, S, ls, kvb, d, d, n0, nk, panel);  // its first sync covers step 2
    const int c = n0 + 4 * tx;
    if (c >= d) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = R * ty + i;
      if (m < rows)
        fk::sx_st4(attn + ((size_t)b * Y + y0 + m) * d + c,
                   make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

__global__ void __launch_bounds__(fk::kThreads)
x2y_small_x_q8_kernel(const int8_t* __restrict__ qy, const float* __restrict__ sy,
                      const float* __restrict__ xkt, const float* __restrict__ xv,
                      const int8_t* __restrict__ qwqt, const float* __restrict__ swq,
                      const float* __restrict__ bq, const int* __restrict__ xlen,
                      float* __restrict__ attn, float* __restrict__ probs,
                      float* __restrict__ logits, int Y, int X, int Cy, int d, float scale) {
  extern __shared__ float4 smem_raw[];
  // the int8 staging and the f32 GEMM staging share the front of the block's memory
  fk::QSmem<BM>& qs = *reinterpret_cast<fk::QSmem<BM>*>(smem_raw);
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* yq = reinterpret_cast<float*>(smem_raw) + kStageFloats;

  const int b = blockIdx.y;
  const int y0 = blockIdx.x * BM;
  const int rows = min(BM, Y - y0);
  const int xl = min(xlen[b], X);
  const int8_t* qyb = qy + ((size_t)b * Y + y0) * Cy;
  const float* syb = sy + (size_t)b * Y + y0;
  int acc[BM / 16][4][4];
  auto stage = [&](int8_t (*as)[fk::kQLD], int k0) { fk::q_stage_a_rows<BM>(as, qyb, Cy, rows, k0); };
  for (int n0 = 0; n0 < d; n0 += fk::kBN) {
    fk::q_gemm_pass<BM>(acc, stage, qwqt, Cy, n0, d, qs);
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = fk::q_row(mt, i);
          const int c = n0 + fk::q_col(nt, i);
          if (c >= d) continue;
          const float sr = r < rows ? syb[r] : 0.f;
          yq[r * d + c] = __fmaf_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), sr),
                                    __ldg(swq + c), __ldg(bq + c));
        }
  }
  __syncthreads();
  small_x_attend(yq, s, xkt + (size_t)b * d * X, xv + (size_t)b * X * d, rows, xl, X, d, scale,
                 logits + ((size_t)b * Y + y0) * X, probs + ((size_t)b * Y + y0) * X,
                 attn + ((size_t)b * Y + y0) * d);
}

template <int R>
cudaError_t launch_sx_attn(size_t smem, dim3 grid, cudaStream_t stream, const float* yq,
                           const float* kv, const int* xlen, int Y, int X, int d, float scale,
                           float* logits, float* probs, float* attn) {
  cudaError_t err = fk::set_smem((const void*)x2y_sx_attn_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  x2y_sx_attn_kernel<R><<<grid, fk::kThreads, smem, stream>>>(yq, kv, xlen, Y, X, d, scale,
                                                              logits, probs, attn);
  return cudaGetLastError();
}

}  // namespace

// K2's small-X forward, one host call: the prep, packs and projections of
// sx_attn.cuh (yq and kv in the caller's workspace, fk::SxProj; y_pos as yin
// = y + y_pos), then the attention -> logits and probs (B, Y, X), attn (B, Y,
// d); `tile` query rows per block (8, 16 or 32).
extern "C" int fk_x2y_sx_fwd(const float* y, const float* ypos, long long ystride, int Py,
                             const float* x, const float* xpos, long long xstride, int Px,
                             const float* wq, const float* bq, const float* wk, const float* bk,
                             const float* wv, const float* bv, const int* xlen, int B, int Y,
                             int X, int Cy, int Cx, int d, float scale, int* lens, float* yin,
                             float* xin, float* wqp, float* wkvp, float* yq, float* kv,
                             float* logits, float* probs, float* attn, int tile, void* stream) {
  if (d % 4 || Cy % 4 || Cx % 4 || Py % 4 || Px % 4 || X < 1 || X > fk::kSxMaxKeys ||
      (tile != 8 && tile != 16 && tile != 32) || (ypos != nullptr) != (yin != nullptr) ||
      (xpos != nullptr) != (xin != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const fk::SxProj p{y,  ypos, ystride, Py, x,  xpos, xstride, Px,  wq,  bq,   wk, bk,
                     wv, bv,   xlen,    B,  Y,  X,    Cy,      Cx,  d,   lens, yin, xin,
                     wqp, wkvp, yq,     kv, nullptr, nullptr};
  int err = sx_project(p, s);
  if (err) return err;
  const size_t smem = fk::sx_smem_floats(tile, X, d) * sizeof(float);
  const dim3 grid((Y + tile - 1) / tile, B);
  return (int)(tile == 32   ? launch_sx_attn<8>(smem, grid, s, yq, kv, xlen, Y, X, d, scale,
                                                  logits, probs, attn)
               : tile == 16 ? launch_sx_attn<4>(smem, grid, s, yq, kv, xlen, Y, X, d, scale,
                                                  logits, probs, attn)
                            : launch_sx_attn<2>(smem, grid, s, yq, kv, xlen, Y, X, d, scale,
                                                  logits, probs, attn));
}

// K8b: qy (B, Y, Cy) int8 and sy (B, Y) from quant.cu's fk_q8_rows of y + y_pos;
// qwqt (d, Cy) int8, swq (d,) the folded weight scale
extern "C" int fk_x2y_small_x_q8(const int8_t* qy, const float* sy, const float* xkt,
                                 const float* xv, const int8_t* qwqt, const float* swq,
                                 const float* bq, const int* xlen, float* attn, float* probs,
                                 float* logits, int B, int Y, int X, int Cy, int d, float scale,
                                 void* stream) {
  if (Cy % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (kStageFloats + (size_t)BM * d) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_small_x_q8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Y + BM - 1) / BM, B);
  x2y_small_x_q8_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      qy, sy, xkt, xv, qwqt, swq, bq, xlen, attn, probs, logits, Y, X, Cy, d, scale);
  return (int)cudaGetLastError();
}
