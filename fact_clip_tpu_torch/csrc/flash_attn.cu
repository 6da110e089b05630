// Cross-attention of a few query rows over a long projected key/value stream:
// the forward of K2's flash form (single head) and its int8 twin K8c.
//
// K2's flash forward replaces fact_clip_tpu/ops/pallas/x2y_attn.py::
// _x2y_flash_fwd_impl (_flash_kernel).  The TPU kernel walks the key axis
// sequentially per video, projects each key tile inside the loop and carries
// an online softmax in VMEM scratch.  Blocks on the H100 run in no order, and
// the projection is nearly all of the work, so it splits as K2's flash
// backward (x2y_bwd.cu) and K3 (mha_attn.cu) do, one host call
// (fk_x2y_flash_fwd; ops/x2y_attn.py::_x2y_flash_fwd_card):
//   lens      the attended lengths (sx_attn.cuh's prep: x_len, or all X
//             frames of a video with x_len = 0, as ops/mha_attn.py::
//             attended_lengths);
//   packs     Wk^T and Wv^T, hi / lo (fk_k6_pack);
//   table     pos @ Wk (1 or B, X, d), where x_pos is given: one kMasked GEMM
//             of tc_tower.cuh on Wk^T's pack;
//   kv        [xk | xv] = x @ [Wk | Wv] + [bk | bv] + [pos @ Wk | 0] (B, X, 2d):
//             one 3xTF32 GEMM of two problems, epilogue kProj (promoted every
//             8 deep, as K3's; the table on problem 0 only), zero at rows
//             past the attended length;
//   partial   x2y_flash_attn_kernel, one block per (group of <= 32 query rows,
//             64-key tile, video), f32 FMA: logits = yq xk^T * scale, -1e9
//             at keys at or past x_len, written out (the losses and the
//             decode read them); the tile max m, exp(logit - m) and its sum
//             l; acc = sum exp(logit - m) xv.  The K panels, the query rows
//             and the V panels stream through shared memory (sx_attn.cuh's
//             sx_attend for the last), a thread holds R = rows / 4 query rows
//             of one key or of four output columns;
//   combine   attn_combine.cuh's fixed-order combine, which writes attn and
//             probs = exp(logit - m_max) / l_total.
// The q projection yq = (y + y_pos) Wq + bq stays outside, as in JAX.
// Bound on the H100: the projection, 2 * 2 * B*X*Cx*d FLOPs over the valid
// frames (25.1 GFLOP at the flagship's B=8, X=3072, Cx=d=512, its valid
// lengths: 0.152 ms as three TF32 passes at 495 TFLOP/s, 0.374 ms of f32
// FMA); the attention 4 * B*M*X*d (2 GFLOP at M=40: 0.03 ms of f32 FMA) and
// its kv read (100 MB).  Projecting K and V inside each (key tile, video)
// block instead runs them on f32 FMA and re-reads both weights in every
// block: 1.35 ms at the flagship's shape against 0.64-0.67 for this split
// (H100 80GB HBM3, 700 W).
//
// K8c, the int8 twin, replaces fact_clip_tpu/ops/pallas/quant_conv.py::
// _x2y_flash_q8_impl (_x2y_flash_kernel_q8) on the same split, one host call
// (fk_x2y_flash_q8_fwd; ops/quant_conv.py::_x2y_flash_q8_card):
//   rows      q(x + pos) and q(x) (2, B, X, Cw) int8, zeros past Cx, with
//             their absmax scales (JAX's per-row quantizer);
//   kv        [xk | xv] = fma(idot(q(.), qW) * s_row, sw, b) (B, X, 2d) as one
//             persistent int8 wgmma launch of two problems, zeros past the
//             attended length: K8d's pair at one head (q8_proj.cu's
//             fk::q8_rows_kv_proj); the int32 sums are exact, so the rows,
//             their scales and kv equal the plain version's bit for bit;
//   partial   and combine as K2's flash forward's above.
// The q projection yq = (y + y_pos) Wq + bq stays in f32 outside, as in JAX.
// Bound on the H100: the int8 products, 4 * Xv * Cx * d operations over the
// valid keys Xv (25 G at the flagship's B=8, X=3072, Cx=d=512: 0.013 ms at
// 1,979 TOPS), the attention's f32 terms as K2's and the bytes of x, the
// weights, the logits and probs.  One block per (key tile, video) that
// projected its own tile on mma.sync re-read both int8 weights in every
// block and attended on f32 FMA with the whole (BK, d + 1) K/V tile in
// shared memory: 0.72 ms at the flagship's shape (H100 80GB HBM3, 700 W).
#include <math.h>

#include "attn_combine.cuh"
#include "common.cuh"
#include "sx_attn.cuh"

namespace {

constexpr int kFlashKeys = fk::kSxKeys;  // keys per block of K2's flash attention
constexpr int kFlashDC = 64;             // columns of d per panel of its logits
constexpr int kFlashKS = kFlashDC + 4;   // the panels' row stride: conflict-free float4 reads

// floats of the staging panel of a block of 4R query rows: the query and key
// panels of the logits, or sx_attend's value panel
template <int R>
constexpr int flash_panel_floats() {
  return (4 * R + kFlashKeys) * kFlashKS > fk::SxPanels<R>::FLOATS
             ? (4 * R + kFlashKeys) * kFlashKS
             : fk::SxPanels<R>::FLOATS;
}

// acc[i] = sum_c q[R ty + i][c] kb[tx][c]: the block's query rows (row stride
// d; rows at or past `rows` zero) against its keys (row stride 2d: xk's
// columns of kv; keys at or past `keys` zero), through 64-column panels of
// both; the next panel's loads are in registers while this one is
// multiplied.  Synchronises the block (call it block-uniformly).
template <int R>
__device__ __forceinline__ void flash_dots(float (&acc)[R], const float* __restrict__ q,
                                           int rows, const float* __restrict__ kb, int keys,
                                           int d, float* panel) {
  constexpr int BQ = 4 * R, C4 = kFlashDC / 4;
  constexpr int kPerK = kFlashKeys * C4 / fk::kThreads;          // float4 of keys a thread
  constexpr int kPerQ = (BQ * C4 + fk::kThreads - 1) / fk::kThreads;  // and of query rows
  float* qp = panel;                   // (BQ, KS)
  float* kp = panel + BQ * kFlashKS;   // (64, KS)
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const size_t ld = 2 * (size_t)d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nk[kPerK], nq[kPerQ];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kPerK; ++u) {
      const int i = tid + u * fk::kThreads, r = i / C4, c = (i - r * C4) * 4;
      nk[u] = r < keys && c0 + c < d ? fk::sx_ldg4(kb + r * ld + c0 + c) : zero;
    }
#pragma unroll
    for (int u = 0; u < kPerQ; ++u) {
      const int i = tid + u * fk::kThreads, r = i / C4, c = (i - r * C4) * 4;
      nq[u] = r < rows && c0 + c < d ? fk::sx_ldg4(q + (size_t)r * d + c0 + c) : zero;
    }
  };
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  fetch(0);
  for (int c0 = 0; c0 < d; c0 += kFlashDC) {
    __syncthreads();  // the panels' last readers are done
#pragma unroll
    for (int u = 0; u < kPerK; ++u) {
      const int i = tid + u * fk::kThreads, r = i / C4, c = (i - r * C4) * 4;
      fk::sx_st4(kp + r * kFlashKS + c, nk[u]);
    }
#pragma unroll
    for (int u = 0; u < kPerQ; ++u) {
      const int i = tid + u * fk::kThreads, r = i / C4, c = (i - r * C4) * 4;
      if (i < BQ * C4) fk::sx_st4(qp + r * kFlashKS + c, nq[u]);
    }
    __syncthreads();
    if (c0 + kFlashDC < d) fetch(c0 + kFlashDC);
    const int cn = min(kFlashDC, d - c0);
    const float* kr = kp + tx * kFlashKS;
    const float* ar = qp + R * ty * kFlashKS;
#pragma unroll 4
    for (int c = 0; c < cn; c += 4) {
      const float4 k = fk::sx_ld4(kr + c);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = fk::sx_ld4(ar + i * kFlashKS + c);
        acc[i] = fmaf(a.x, k.x, acc[i]);
        acc[i] = fmaf(a.y, k.y, acc[i]);
        acc[i] = fmaf(a.z, k.z, acc[i]);
        acc[i] = fmaf(a.w, k.w, acc[i]);
      }
    }
  }
}

// K2's flash partials: block (query group g, key tile t, video b), 256
// threads, thread row ty (0..3) owning query rows g BQ + R ty + i, thread
// column tx (0..63) key t 64 + tx in the logits and four columns of d in the
// attend.  yq (B, M, d); kv (B, X, 2d) zero past the attended length.  A tile
// wholly past x_len writes the partials the full computation gives (m =
// -1e9, l = the tile's keys, acc = 0: its xv rows are zero) without reading
// anything; a video with x_len = 0 runs every tile, every logit -1e9.
template <int R>
__global__ void __launch_bounds__(fk::kThreads)
x2y_flash_attn_kernel(const float* __restrict__ yq, const float* __restrict__ kv,
                      const int* __restrict__ xlen, int X, int M, int d, float scale,
                      float* __restrict__ logits, float* __restrict__ part_acc,
                      float* __restrict__ part_ml) {
  constexpr int BQ = 4 * R, BK = kFlashKeys;
  extern __shared__ float4 smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);  // (BQ, BK): logits, then exp(logit - m)
  float* panel = S + BQ * BK;
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6, lane = tid & 31;
  const int m0 = blockIdx.x * BQ, tile = blockIdx.y, b = blockIdx.z;
  const int rows = min(BQ, M - m0);
  const int x0 = tile * BK;
  const int keys = min(BK, X - x0);
  const int xl = min(xlen[b], X);
  const size_t prow = ((size_t)b * gridDim.y + tile) * M + m0;  // the partials' first row
  float* lg = logits + ((size_t)b * M + m0) * X + x0;          // row m at + m X
  if (xl > 0 && x0 >= xl) {
    for (int i = tid; i < rows * BK; i += fk::kThreads)
      if (i % BK < keys) lg[(size_t)(i / BK) * X + i % BK] = fk::kMaskedLogit;
    for (int i = tid; i < rows * d; i += fk::kThreads) part_acc[prow * d + i] = 0.f;
    for (int m = tid; m < rows; m += fk::kThreads) {
      part_ml[(prow + m) * 2] = fk::kMaskedLogit;
      part_ml[(prow + m) * 2 + 1] = (float)keys;
    }
    return;
  }
  const float* kvb = kv + ((size_t)b * X + x0) * 2 * d;

  // 1. logits = yq xk^T * scale; -1e9 at keys at or past x_len, -inf past X
  float acc[R];
  if (x0 < xl) {  // block-uniform; else every logit is masked
    flash_dots<R>(acc, yq + ((size_t)b * M + m0) * d, rows, kvb, keys, d, panel);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = R * ty + i;
    const float v = tx < keys ? (x0 + tx < xl ? acc[i] * scale : fk::kMaskedLogit) : -INFINITY;
    S[m * BK + tx] = v;
    if (m < rows && tx < keys) lg[(size_t)m * X + tx] = v;
  }
  __syncthreads();

  // 2. the tile's max m and weights exp(logit - m) and their sum l, a warp a row
  for (int m = tid >> 5; m < BQ; m += fk::kWarps) {
    float* sr = S + m * BK;
    if (m >= rows) {  // padding rows: zero weights, finite for the attend
      sr[lane] = sr[lane + 32] = 0.f;
      continue;
    }
    const float a = sr[lane], c = sr[lane + 32];
    const float mt = fk::warp_max(fmaxf(a, c));
    const float pa = lane < keys ? expf(a - mt) : 0.f;
    const float pc = lane + 32 < keys ? expf(c - mt) : 0.f;
    sr[lane] = pa;
    sr[lane + 32] = pc;
    const float lt = fk::warp_sum(pa + pc);
    if (lane == 0) {
      part_ml[(prow + m) * 2] = mt;
      part_ml[(prow + m) * 2 + 1] = lt;
    }
  }

  // 3. acc = sum exp(logit - m) xv over the tile's keys that can weigh
  const int nk = xl > 0 ? min(keys, xl - x0) : keys;
  for (int n0 = 0; n0 < d; n0 += fk::kSxNC) {
    float a4[R][4];
    fk::sx_attend<R>(a4, S, BK, kvb, d, d, n0, nk, panel);  // its first sync covers step 2
    const int c = n0 + 4 * tx;
    if (c >= d) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = R * ty + i;
      if (m < rows)
        fk::sx_st4(part_acc + (prow + m) * d + c, make_float4(a4[i][0], a4[i][1], a4[i][2],
                                                              a4[i][3]));
    }
  }
}

template <int R>
cudaError_t launch_flash(dim3 grid, cudaStream_t st, const float* yq, const float* kv,
                         const int* xlen, int X, int M, int d, float scale, float* logits,
                         float* part_acc, float* part_ml) {
  const size_t smem = (4 * R * kFlashKeys + flash_panel_floats<R>()) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_flash_attn_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  x2y_flash_attn_kernel<R><<<grid, fk::kThreads, smem, st>>>(yq, kv, xlen, X, M, d, scale,
                                                             logits, part_acc, part_ml);
  return cudaGetLastError();
}

// the partials of every (group of `rows` query rows, 64-key tile, video) and
// the combine: logits and probs (B, M, X), attn (B, M, d) from yq (B, M, d)
// and kv = [xk | xv] (B, X, 2d)
int flash_attend(const float* yq, const float* kv, const int* xlen, int B, int X, int M, int d,
                 float scale, float* part_acc, float* part_ml, float* logits, float* probs,
                 float* attn, int rows, cudaStream_t s) {
  const int n_t = (X + kFlashKeys - 1) / kFlashKeys;
  const dim3 grid((M + rows - 1) / rows, n_t, B);
  decltype(&launch_flash<1>) const launch[8] = {
      launch_flash<1>, launch_flash<2>, launch_flash<3>, launch_flash<4>,
      launch_flash<5>, launch_flash<6>, launch_flash<7>, launch_flash<8>};
  const cudaError_t e = launch[rows / 4 - 1](grid, s, yq, kv, xlen, X, M, d, scale, logits,
                                             part_acc, part_ml);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_combine(part_acc, part_ml, B, n_t, M, 1, d, attn, logits, probs, X, nullptr,
                             s);
}

}  // namespace

namespace fk {
// q8_proj.cu: K8d's rows and int8 [K | V] projection, here at one head
int q8_rows_kv_proj(const float* x, const float* pos, long long pos_bstride, int P,
                    const int8_t* wpack, int Kw, const float* swk, const float* bk,
                    const float* swv, const float* bv, const int* xlen, int B, int X, int Cx,
                    int Cw, int E, int8_t* qx, float* sx, float* kv, cudaStream_t st);
}  // namespace fk

// K2's flash forward, one host call (see the top of this file): x (B, X, Cx)
// with x_pos (1 or B, X, Px; null for none) on its leading Px channels, the
// projected queries yq (B, M, d) -> logits and probs (B, M, X), attn (B, M,
// d).  Workspace: lens (2B + 1 ints), wkvp (2 problems x hi / lo x d x Cx),
// tab ((1 or B) x X x d, with x_pos), kv (B, X, 2d), part_acc (B, n_t, M, d)
// and part_ml (B, n_t, M, 2) over 64-key tiles; `rows` query rows a block
// (a multiple of 4 up to 32).
extern "C" int fk_x2y_flash_fwd(const float* x, const float* xpos, long long xstride, int Px,
                                const float* yq, const float* wk, const float* bk,
                                const float* wv, const float* bv, const int* xlen, int B, int X,
                                int Cx, int M, int d, float scale, int* lens, float* wkvp,
                                float* tab, float* kv, float* part_acc, float* part_ml,
                                float* logits, float* probs, float* attn, int rows,
                                void* stream) {
  if (d % 4 || Cx % 4 || Px % 4 || rows % 4 || rows < 4 || rows > 32 || X < 1 || M < 1 ||
      (xpos != nullptr) != (tab != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the prep writes only the lengths: lens[B + b] the attended length, lens[2B] = X
  const fk::SxProj p{nullptr, nullptr, 0,  0,  x,    nullptr, 0,       0,       nullptr, nullptr,
                     wk,      bk,      wv, bv, xlen, B,       M,       X,       0,       Cx,
                     d,       lens,    nullptr, nullptr, nullptr, wkvp, nullptr, kv,  nullptr,
                     nullptr};
  const size_t kvz = (size_t)2 * d * Cx;  // one problem's packed hi / lo parts
  int err;
  if ((err = sx_prep(p, s)) || (err = fk_k6_pack(wk, wkvp, Cx, d, 1, Cx, Cx, stream)) ||
      (err = fk_k6_pack(wv, wkvp + kvz, Cx, d, 1, Cx, Cx, stream)))
    return err;
  const int one[2] = {0, 0}, two[4] = {0, 0, 0, 0};
  if (xpos != nullptr &&  // pos @ Wk on problem 0's pack, over every row of a shared table
      (err = fk_k6_gemm(fk::kGemmMasked, xpos, Px, 1, 1, one, Cx, wkvp, d, Cx, xstride ? B : 1,
                        X, xstride ? lens + B : lens + 2 * B, tab, d, 0, nullptr, nullptr,
                        nullptr, 0, 0, nullptr, nullptr, nullptr, 0, 0u, 1.f, stream)))
    return err;
  if ((err = fk_k6_gemm(fk::kGemmProj, x, Cx, 2, 1, two, Cx, wkvp, d, Cx, B, X, lens + B, kv,
                        2 * d, d, bk, bv, tab, d, xstride ? (long long)X * d : 0, nullptr,
                        nullptr, nullptr, 0, 0u, 1.f, stream)))
    return err;
  return flash_attend(yq, kv, xlen, B, X, M, d, scale, part_acc, part_ml, logits, probs, attn,
                      rows, s);
}

// K2's flash attention alone, on projections made elsewhere (the
// mixed-precision form, ops/x2y_attn.py::x2y_flash16_fwd, makes kv = [xk |
// xv] (B, X, 2d) f32 on the bf16 GEMM, tc_bf16.cu, and yq outside: JAX's
// flash kernel keeps xk and xv f32 under mixed precision, so its attention
// is this f32 one): the partials and the combine -> logits and probs (B, M,
// X), attn (B, M, d); `rows` query rows a block (a multiple of 4 up to 32).
extern "C" int fk_x2y_flash_attend(const float* yq, const float* kv, const int* xlen, int B,
                                   int X, int M, int d, float scale, float* part_acc,
                                   float* part_ml, float* logits, float* probs, float* attn,
                                   int rows, void* stream) {
  if (d % 4 || rows % 4 || rows < 4 || rows > 32 || X < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  return flash_attend(yq, kv, xlen, B, X, M, d, scale, part_acc, part_ml, logits, probs, attn,
                      rows, (cudaStream_t)stream);
}

// K8c, one host call (see the top of this file): x (B, X, Cx) with x_pos (1
// or B, X, Px; null for none) on its leading Px channels, the projected
// queries yq (B, M, d) -> logits and probs (B, M, X), attn (B, M, d).
// wpack (2d, Kw) int8 [qWk^T ; qWv^T] (zeros past Cx) with the folded
// scales swk, swv and the biases bk, bv.  Buffers: qx (2, B, X, Cw) int8,
// sx (2, B, X), kv (B, X, 2d), part_acc (B, n_t, M, d) and part_ml (B, n_t,
// M, 2) over 64-key tiles; `rows` query rows a block (a multiple of 4 up to
// 32).
extern "C" int fk_x2y_flash_q8_fwd(const float* x, const float* xpos, long long xstride, int Px,
                                   const int8_t* wpack, int Kw, const float* swk,
                                   const float* bk, const float* swv, const float* bv,
                                   const float* yq, const int* xlen, int B, int X, int Cx, int Cw,
                                   int M, int d, float scale, int8_t* qx, float* sx, float* kv,
                                   float* part_acc, float* part_ml, float* logits, float* probs,
                                   float* attn, int rows, void* stream) {
  if (d % 4 || rows % 4 || rows < 4 || rows > 32 || X < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = fk::q8_rows_kv_proj(x, xpos, xstride, Px, wpack, Kw, swk, bk, swv, bv, xlen, B,
                                      X, Cx, Cw, d, qx, sx, kv, s);
  if (err) return err;
  return flash_attend(yq, kv, xlen, B, X, M, d, scale, part_acc, part_ml, logits, probs, attn,
                      rows, s);
}
