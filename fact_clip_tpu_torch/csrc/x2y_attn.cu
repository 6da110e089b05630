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
// K8b, the int8 twin, replaces
// fact_clip_tpu/ops/pallas/quant_conv.py::_x2y_small_x_q8_impl
// (_x2y_small_x_kernel_q8) on the same split, one host call
// (fk_x2y_sx_q8_fwd; ops/quant_conv.py::_x2y_sx_q8_card):
//   the key side as K2's (sx_attn.cuh's prep and sx_key_side: kv = [xk |
//     xv] in f32 on the 3xTF32 GEMM, as JAX computes it outside its kernel,
//     zero at keys at or past x_len), on the side stream;
//   the query side on q8_proj.cu's int8 wgmma core (fk::q8_rows_proj): the
//     rows q(y + y_pos) and their absmax scales s_y (JAX's per-row
//     quantizer), then yq = fma(idot(q(y + y_pos), qWq) * s_y, swq, bq),
//     JAX's dequantization order (ops/quant_conv.py::_proj_q8), every row,
//     one persistent launch; the int32 sums are exact, so yq equals the
//     plain version's bit for bit;
//   the attention above (x2y_sx_attn_kernel) on yq and kv.
// Bound on the H100: the int8 product, 2 * B*Y*Cy*d operations (12.9 G at
// the flagship's a2f: 0.007 ms at 1,979 TOPS), the key side's f32-accurate
// products and the attention's f32 terms as above; the bytes of y (50 MB
// at the flagship) and of the (B, Y, X) logits and probs.  One block per 64
// query rows and video, with the int8 product on mma.sync inside it, gives
// 48 blocks a video at Y = 3072 and 8-10 at epic's B = 2, Y = 256-300: 0.44
// ms against 0.25 for this split at the flagship's shape (H100 80GB HBM3,
// 700 W).
#include <math.h>

#include "common.cuh"
#include "sx_attn.cuh"

namespace {

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

// the attention of `tile` query rows a block (8, 16 or 32)
int sx_attn(int tile, cudaStream_t s, const float* yq, const float* kv, const int* xlen, int B,
            int Y, int X, int d, float scale, float* logits, float* probs, float* attn) {
  const size_t smem = fk::sx_smem_floats(tile, X, d) * sizeof(float);
  const dim3 grid((Y + tile - 1) / tile, B);
  return (int)(tile == 32   ? launch_sx_attn<8>(smem, grid, s, yq, kv, xlen, Y, X, d, scale,
                                                logits, probs, attn)
               : tile == 16 ? launch_sx_attn<4>(smem, grid, s, yq, kv, xlen, Y, X, d, scale,
                                                logits, probs, attn)
                            : launch_sx_attn<2>(smem, grid, s, yq, kv, xlen, Y, X, d, scale,
                                                logits, probs, attn));
}

}  // namespace

namespace fk {
// q8_proj.cu: K8b's query side, the rows quantized and projected on the int8 core
int q8_rows_proj(const float* y, const float* pos, long long pos_bstride, int P,
                 const int8_t* wpack, int Kw, const float* sw, const float* bias, int B, int N,
                 int C, int Cw, int E, int8_t* qy, float* sy, float* out, cudaStream_t st);
}  // namespace fk

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
  return sx_attn(tile, s, yq, kv, xlen, B, Y, X, d, scale, logits, probs, attn);
}

// K2's small-X attention alone, on projections made elsewhere (the
// mixed-precision form, ops/x2y_attn.py::x2y_small_x16_fwd, makes yq (B, Y,
// d) and kv = [xk | xv] (B, X, 2d) f32 on the bf16 GEMM, tc_bf16.cu: JAX's
// small-X kernel takes f32 keys and values under mixed precision, so its
// attention is this f32 one) -> logits and probs (B, Y, X), attn (B, Y, d);
// `tile` query rows per block (8, 16 or 32).
extern "C" int fk_x2y_sx_attn(const float* yq, const float* kv, const int* xlen, int B, int Y,
                              int X, int d, float scale, float* logits, float* probs, float* attn,
                              int tile, void* stream) {
  if (d % 4 || X < 1 || X > fk::kSxMaxKeys || (tile != 8 && tile != 16 && tile != 32))
    return (int)cudaErrorInvalidValue;
  return sx_attn(tile, (cudaStream_t)stream, yq, kv, xlen, B, Y, X, d, scale, logits, probs,
                 attn);
}

// K8b, one host call: the key side of sx_attn.cuh (lens, xin = [x + x_pos |
// x] with x_pos, the packs wkvp and kv in the caller's workspace, fk::SxProj)
// on the side stream; the query side, qy (B, Y, Cw) int8, sy (B, Y) and yq
// (B, Y, d), on q8_proj.cu's int8 core (wqpack (d, Kw) int8, zeros past Cy;
// swq (d,) the folded weight scale); then the attention -> logits and probs
// (B, Y, X), attn (B, Y, d); `tile` query rows per block (8, 16 or 32).
extern "C" int fk_x2y_sx_q8_fwd(const float* y, const float* ypos, long long ystride, int Py,
                                const float* x, const float* xpos, long long xstride, int Px,
                                const int8_t* wqpack, int Kw, const float* swq, const float* bq,
                                const float* wk, const float* bk, const float* wv,
                                const float* bv, const int* xlen, int B, int Y, int X, int Cy,
                                int Cx, int Cw, int d, float scale, int* lens, float* xin,
                                float* wkvp, float* kv, int8_t* qy, float* sy, float* yq,
                                float* logits, float* probs, float* attn, int tile,
                                void* stream) {
  if (d % 4 || Cx % 4 || Px % 4 || X < 1 || X > fk::kSxMaxKeys ||
      (tile != 8 && tile != 16 && tile != 32) || (xpos != nullptr) != (xin != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the key side's inputs and buffers (the query side is the int8 one)
  const fk::SxProj p{y,  nullptr, 0,    0,  x,  xpos,    xstride, Px,      nullptr, nullptr,
                     wk, bk,      wv,   bv, xlen, B,     Y,       X,       Cy,      Cx,
                     d,  lens,    nullptr, xin, nullptr, wkvp,   nullptr, kv,      nullptr,
                     nullptr};
  SxSide side;
  int err;
  if ((err = sx_prep(p, s)) || (err = sx_key_side(p, s, side)) ||
      (err = fk::q8_rows_proj(y, ypos, ystride, Py, wqpack, Kw, swq, bq, B, Y, Cy, Cw, d, qy, sy,
                              yq, s)) ||
      (err = (int)cudaStreamWaitEvent(s, side.join, 0)))  // kv is ready
    return err;
  return sx_attn(tile, s, yq, kv, xlen, B, Y, X, d, scale, logits, probs, attn);
}
