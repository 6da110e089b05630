// K2 backward: single-head X2Y cross-attention, both forms.
//
// Small-X form: replaces fact_clip_tpu/ops/pallas/x2y_attn.py::
// _x2y_small_x_bwd_impl (_small_x_bwd_kernel).  The TPU kernel walks the
// query tiles in order, recomputes yq in VMEM and carries dxk, dxv, dWq and
// dbq there.  On the H100 the work splits by what bounds it, as the flash
// form's does, in one host call (fk_x2y_sx_bwd;
// ops/x2y_attn.py::_x2y_small_x_bwd_card):
//   yq = (y + y_pos) @ Wq + bq and kv = [xk | xv], recomputed as JAX's does,
//     on tc_tower.cuh's 3xTF32 GEMM (epilogue kProj; sx_attn.cuh's sx_project);
//   the attention terms (this file, x2y_sx_attn_bwd_kernel): one block per
//     (tile of BQ = 8-32 query rows, video), f32 FMA on sx_attn.cuh's
//     panels, from the saved probabilities and the cotangents of (attn,
//     probs, logits):
//       dprobs = g_probs + g_attn xv^T,
//       dlogits = (probs * (dprobs - rowsum(probs * dprobs)) + g_logits) * scale,
//                 exactly zero at keys at or past x_len (the -1e9 logits),
//       dyq = dlogits xk,
//     writing dlogits (rows padded to 16 bytes), dyq and the tile's column
//     sums of dyq (dbq's shares, summed in two fixed-order stages);
//   dy = dyq Wq^T: one GEMM of the tensor cores (K = d);
//   dWq = (y + y_pos)^T dyq, dxk = dlogits^T yq and dxv = probs^T g_attn
//     (per video): mstcn2.cu's k6_wgrad and grad.cu's fixed-order sums.  No
//     float atomics.  (dxk and dxv as the query tiles' shares, written by the
//     attention kernel and summed in two stages, made the whole backward
//     1.32 ms against 1.05 at the flagship and 0.42-0.43 against 0.35-0.39
//     at epic's and the TDU's shapes: the shares are B x tiles x X x 2d
//     floats; H100 80GB HBM3, 700 W.)
// The X side's projections and their cotangents stay plain matmuls outside,
// as in the JAX caller.  Bound on the H100: the products yq, dy and dWq,
// 3 * 2 * B*Y*Cy*d (38.7 GFLOP for the flagship's a2f at B=8, Y=3072,
// Cy=d=512: 0.234 ms as three TF32 passes); the attention terms, 8 * B*Y*X*d
// with dxk and dxv (4 GFLOP at X=40), are small beside them.
//
// Flash form: replaces _x2y_flash_bwd_impl (_flash_bwd_kernel).  The TPU
// kernel walks the key tiles in order, recomputes each tile's projections in
// VMEM and carries dyq and the weight grads there.  On the H100 the work
// splits by what bounds it, as K3's backward (mha_attn.cu) does at H = 1:
//   the projection  [xk | xv] = x @ [Wk | Wv] + [bk | bv] + [x_pos @ Wk | 0],
//     recomputed as JAX's does, one 3xTF32 GEMM of tc_tower.cuh (epilogue
//     kProj; ops/mha_attn.py::_project);
//   the attention terms  (this file, x2y_flash_attn_bwd_kernel): one block
//     per (64-key tile, video), f32 FMA:
//       dlogits^T = (probs^T * (g_probs^T + xv g_attn^T - D) + g_logits^T) * scale,
//                   zero at keys at or past x_len (D = rowsum(probs * g_probs)
//                   + rowsum(g_attn * attn) from the caller),
//       dxv = probs^T g_attn,  dxk = dlogits^T yq  -> dkv = [dxk | dxv] (B, X, 2d),
//       the tile's shares of dyq = dlogits xk and of the bias sums;
//   dx = dkv @ [Wk | Wv]^T: one GEMM of the tensor cores, K = 2d;
//   [dWk | dWv] = x^T dkv (+ x_pos^T of the batch's dxk): mstcn2.cu's
//     k6_wgrad; dyq's tile shares and the bias sums in two fixed-order stages
//     (ops/_grad.py::sum_groups).  No float atomics.
// The attention terms are 8 * B*M*X*d FLOPs (4.0 GFLOP at the flagship's B=8,
// X=3072, M=40, d=512: 0.06 ms at 67 TFLOP/s) and read kv once (100 MB); the
// three big products are 3 * 4 * B*X*Cx*d (77 GFLOP) on the tensor cores.  A
// video with no valid key (x_len = 0) attends to every frame, as JAX's and
// the plain version do: its tiles run (uniform probs, dlogits 0), and the
// caller projects and multiplies all its frames.
#include <math.h>

#include "common.cuh"
#include "sx_attn.cuh"

namespace {

constexpr int kMaxM = 64;  // flash: query rows per video (the attention's 64-wide panels)

// The small-X form's attention terms for the block's BQ = 4R query rows, from
// kv = [xk | xv] (B, X, 2d).  A video with no valid key (x_len = 0) has no
// dlogit that is not 0 (its -1e9 logits are constants), so its blocks write
// zeros; otherwise only the keys below x_len take part (probs 0 past them).
template <int R>
__global__ void __launch_bounds__(fk::kThreads, 2)
x2y_sx_attn_bwd_kernel(const float* __restrict__ kv, const float* __restrict__ probs,
                       const float* __restrict__ gprobs, const float* __restrict__ glogits,
                       const float* __restrict__ gattn, const int* __restrict__ xlen, int Y,
                       int X, int d, float scale, float* __restrict__ dlog,
                       float* __restrict__ dyq, float* __restrict__ part_bq) {
  constexpr int BQ = 4 * R;
  extern __shared__ float4 smem_raw[];
  const int ls = fk::sx_pad(X);  // S's row stride and dlog's
  float* G = reinterpret_cast<float*>(smem_raw);  // (BQ, d + 4): the tile's g_attn rows
  float* S = G + BQ * (d + 4);                     // (BQ, ls): dprobs, then dlogits
  float* panel = S + BQ * ls;
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6, lane = tid & 31;
  const int b = blockIdx.y, y0 = blockIdx.x * BQ;
  const int rows = min(BQ, Y - y0);
  const int xl = min(xlen[b], X);
  const float* kvb = kv + (size_t)b * X * 2 * d;
  const size_t rx = ((size_t)b * Y + y0) * X;  // this block's rows of (B, Y, X)
  float* dlb = dlog + ((size_t)b * Y + y0) * ls;
  float* dqb = dyq + ((size_t)b * Y + y0) * d;
  float* pb = part_bq + (size_t)(b * gridDim.x + blockIdx.x) * d;
  if (xl <= 0) {
    for (int i = tid; i < rows * ls; i += fk::kThreads) dlb[i] = 0.f;
    for (int i = tid; i < rows * d; i += fk::kThreads) dqb[i] = 0.f;
    for (int i = tid; i < d; i += fk::kThreads) pb[i] = 0.f;
    return;
  }
  fk::sx_stage_rows(G, gattn + ((size_t)b * Y + y0) * d, BQ, rows, d);

  // 1. dprobs = g_attn xv^T + g_probs on the keys below x_len
  for (int j0 = 0; j0 < xl; j0 += fk::kSxKeys) {
    float acc[R];
    fk::sx_dots<R>(acc, G, d, kvb, X, d, j0, panel);
    const int j = j0 + tx;
    if (j >= xl) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = R * ty + i;
      float v = acc[i];
      if (gprobs != nullptr && m < rows) v += __ldg(gprobs + rx + (size_t)m * X + j);
      S[m * ls + j] = v;
    }
  }
  __syncthreads();

  // 2. softmax backward, one warp per row: dlogits into S and dlog (zero at
  // keys at or past x_len, and on the tile's rows past Y)
  for (int m = tid >> 5; m < BQ; m += fk::kWarps) {
    float* srow = S + m * ls;
    if (m >= rows) {
      for (int k = lane; k < ls; k += 32) srow[k] = 0.f;
      continue;
    }
    const float* prow = probs + rx + (size_t)m * X;
    float D = 0.f;
    for (int k = lane; k < xl; k += 32) D += __ldg(prow + k) * srow[k];
    D = fk::warp_sum(D);
    float* drow = dlb + (size_t)m * ls;
    for (int k = lane; k < ls; k += 32) {
      float v = 0.f;
      if (k < xl) {
        v = __ldg(prow + k) * (srow[k] - D);
        if (glogits != nullptr) v += __ldg(glogits + rx + (size_t)m * X + k);
        v *= scale;
      }
      srow[k] = v;
      drow[k] = v;
    }
  }

  // 3. dyq = dlogits xk over the keys below x_len, and the tile's column sums
  for (int n0 = 0; n0 < d; n0 += fk::kSxNC) {
    float acc[R][4];
    fk::sx_attend<R>(acc, S, ls, kvb, d, 0, n0, xl, panel);  // its first sync covers step 2
    const int c = n0 + 4 * tx;
    float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // this thread's rows, in order
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = R * ty + i;
      if (m >= rows || c >= d) continue;
      fk::sx_st4(dqb + (size_t)m * d + c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      cs = make_float4(cs.x + acc[i][0], cs.y + acc[i][1], cs.z + acc[i][2], cs.w + acc[i][3]);
    }
    __syncthreads();  // the panel's readers are done: it takes the four thread rows' sums
    fk::sx_st4(panel + ty * fk::kSxNC + 4 * tx, cs);
    __syncthreads();
    if (n0 + tid < d) {
      float s = 0.f;
      for (int t = 0; t < 4; ++t) s += panel[t * fk::kSxNC + tid];
      pb[n0 + tid] = s;
    }
  }
}

// The flash form's attention backward over one tile of kFT keys of one video,
// from the recomputed projection kv = [xk | xv] (B, X, 2d):
//   1. dp^T = xv g_attn^T (kFT x M, over d in chunks of kFC1), then
//      dlogits^T = (probs^T * (g_probs^T + dp^T - D) + g_logits^T) * scale,
//      zero at keys at or past x_len, held twice in shared memory (both
//      orientations) with probs^T;
//   2. per chunk of kFC columns: dxk = dlogits^T yq and dxv = probs^T g_attn
//      (kFT x kFC, over the M rows) written to dkv = [dxk | dxv] with the
//      chunk's column sums (the tile's shares of dbk, dbv), and the tile's
//      share of dyq = dlogits xk (M x kFC, over the tile's keys).
// Each thread holds a 4 x 4 block of every product, its operands read as
// float4 from panels with 68-float rows (16-byte aligned, k-major).
constexpr int kFT = 64;   // keys per block
constexpr int kFS = 68;   // row stride (floats) of the block's 64-wide panels
constexpr int kFC = 64;   // columns of d per chunk of stage 2
constexpr int kFC1 = 32;  // columns of d per chunk of stage 1

__host__ __device__ constexpr size_t flash_attn_bwd_floats() {
  // probs^T, dlogits^T, dlogits; yq, g_attn and xk chunks (stage 1's xv^T
  // and g_attn^T chunks in their place); the column sums of 16 thread rows
  return (size_t)6 * kFT * kFS + (size_t)2 * 16 * kFC;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ai = at(a, i);
    acc[i][0] = fmaf(ai, b.x, acc[i][0]);
    acc[i][1] = fmaf(ai, b.y, acc[i][1]);
    acc[i][2] = fmaf(ai, b.z, acc[i][2]);
    acc[i][3] = fmaf(ai, b.w, acc[i][3]);
  }
}

__global__ void __launch_bounds__(fk::kThreads)
x2y_flash_attn_bwd_kernel(const float* __restrict__ kv, const float* __restrict__ probs,
                          const float* __restrict__ gprobs, const float* __restrict__ glogits,
                          const float* __restrict__ gattn, const float* __restrict__ yq,
                          const float* __restrict__ Dr, const int* __restrict__ xlen, int X,
                          int M, int d, float scale, float* __restrict__ dkv,
                          float* __restrict__ part_dyq, float* __restrict__ part_b,
                          int n_slots) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int x0 = tile * kFT;
  const int rows = min(kFT, X - x0);
  const int xl = min(xlen[b], X);
  const int tid = threadIdx.x;
  const size_t ld = 2 * (size_t)d;  // kv and dkv row stride
  const float* kvb = kv + ((size_t)b * X + x0) * ld;
  float* dkvb = dkv + ((size_t)b * X + x0) * ld;
  float* pq = part_dyq + ((size_t)b * n_slots + tile) * M * d;
  float* pb = part_b + ((size_t)b * n_slots + tile) * ld;
  const float* gab = gattn + (size_t)b * M * d;
  const float* yqb = yq + (size_t)b * M * d;
  if (xl > 0 && x0 >= xl) {  // every key masked: probs 0 and dlogits 0, so all of it is 0
    for (size_t i = tid; i < (size_t)rows * ld; i += fk::kThreads) dkvb[i] = 0.f;
    for (int i = tid; i < M * d; i += fk::kThreads) pq[i] = 0.f;
    for (int i = tid; i < 2 * d; i += fk::kThreads) pb[i] = 0.f;
    return;
  }
  extern __shared__ float4 smem_raw[];
  float* Pt = reinterpret_cast<float*>(smem_raw);  // [m][j]: probs of the tile's keys
  float* DLt = Pt + kFT * kFS;                      // [m][j]: dlogits
  float* DL = DLt + kFT * kFS;                      // [j][m]: dlogits
  float* Ys = DL + kFT * kFS;                       // [m][c]: a chunk of yq
  float* Gs = Ys + kFT * kFS;                       // [m][c]: of g_attn
  float* XK = Gs + kFT * kFS;                       // [j][c]: of xk
  float* XVt = Ys;                                  // stage 1: [c][j] a chunk of xv
  float* Gt = Ys + kFC1 * kFS;                      //          [c][m] of g_attn
  float* Ssum = XK + kFT * kFS;                     // [2][16][kFC]: column sums per thread row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < kFT * kFT; i += fk::kThreads) {  // keys past X and rows past M: 0
    const int m = i / kFT, j = i - m * kFT;
    Pt[m * kFS + j] = m < M && j < rows ? __ldg(probs + ((size_t)b * M + m) * X + x0 + j) : 0.f;
  }

  // 1. dp^T: keys 4 tj .. 4 tj + 3, rows 4 tm .. 4 tm + 3
  const int tj = tid & 15, tm = tid >> 4;
  float dp[4][4] = {};
  for (int c0 = 0; c0 < d; c0 += kFC1) {
    for (int i = tid; i < kFT * kFC1 / 4; i += fk::kThreads) {
      const int r = i / (kFC1 / 4), c4 = (i - r * (kFC1 / 4)) * 4;
      const bool cok = c0 + c4 < d;  // d % 4 == 0: the whole float4
      const float4 v = cok && r < rows ? ld4(kvb + r * ld + d + c0 + c4) : zero;
      const float4 g = cok && r < M ? ld4(gab + (size_t)r * d + c0 + c4) : zero;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        XVt[(c4 + q) * kFS + r] = at(v, q);
        Gt[(c4 + q) * kFS + r] = at(g, q);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kFC1; ++c) outer4(dp, ld4(XVt + c * kFS + 4 * tj), ld4(Gt + c * kFS + 4 * tm));
    __syncthreads();
  }
  {
    const float* Db = Dr + (size_t)b * M;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * tj + q;
      const int key = x0 + j;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 4 * tm + r;
        float v = 0.f;
        if (m < M && j < rows && key < xl) {
          const size_t e = ((size_t)b * M + m) * X + key;
          float dpv = dp[q][r];
          if (gprobs != nullptr) dpv += __ldg(gprobs + e);
          v = Pt[m * kFS + j] * (dpv - __ldg(Db + m));
          if (glogits != nullptr) v += __ldg(glogits + e);
          v *= scale;
        }
        DLt[m * kFS + j] = v;
        DL[j * kFS + m] = v;
      }
    }
  }
  __syncthreads();

  // 2. per chunk: dxk, dxv (keys 4 ty .., columns 4 tx ..), dyq (rows 4 ty .., columns 4 tx ..)
  const int tx = tid & 15, ty = tid >> 4;
  for (int c0 = 0; c0 < d; c0 += kFC) {
    for (int i = tid; i < kFT * kFC / 4; i += fk::kThreads) {
      const int r = i / (kFC / 4), c4 = (i - r * (kFC / 4)) * 4;
      const bool cok = c0 + c4 < d;
      st4(Ys + r * kFS + c4, cok && r < M ? ld4(yqb + (size_t)r * d + c0 + c4) : zero);
      st4(Gs + r * kFS + c4, cok && r < M ? ld4(gab + (size_t)r * d + c0 + c4) : zero);
      st4(XK + r * kFS + c4, cok && r < rows ? ld4(kvb + r * ld + c0 + c4) : zero);
    }
    __syncthreads();
    float ak[4][4] = {}, av[4][4] = {};
    for (int m = 0; m < M; ++m) {
      const float4 y = ld4(Ys + m * kFS + 4 * tx), g = ld4(Gs + m * kFS + 4 * tx);
      outer4(ak, ld4(DLt + m * kFS + 4 * ty), y);
      outer4(av, ld4(Pt + m * kFS + 4 * ty), g);
    }
    const int c = c0 + 4 * tx;
    float4 sk = zero, sv = zero;  // this thread's four keys, in order
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * ty + q;
      const float4 k4 = make_float4(ak[q][0], ak[q][1], ak[q][2], ak[q][3]);
      const float4 v4 = make_float4(av[q][0], av[q][1], av[q][2], av[q][3]);
      if (j < rows && c < d) {
        st4(dkvb + j * ld + c, k4);
        st4(dkvb + j * ld + d + c, v4);
      }
      sk = make_float4(sk.x + k4.x, sk.y + k4.y, sk.z + k4.z, sk.w + k4.w);
      sv = make_float4(sv.x + v4.x, sv.y + v4.y, sv.z + v4.z, sv.w + v4.w);
    }
    st4(Ssum + ty * kFC + 4 * tx, sk);
    st4(Ssum + (16 + ty) * kFC + 4 * tx, sv);
    float aq[4][4] = {};
    if (4 * ty < M)
      for (int j = 0; j < rows; ++j) outer4(aq, ld4(DL + j * kFS + 4 * ty), ld4(XK + j * kFS + 4 * tx));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 4 * ty + r;
      if (m < M && c < d) st4(pq + (size_t)m * d + c, make_float4(aq[r][0], aq[r][1], aq[r][2], aq[r][3]));
    }
    __syncthreads();  // the chunk's operands are read and its column sums written
    if (tid < 2 * kFC) {  // the tile's column sums of dxk, dxv over the 16 thread rows, in order
      const int w = tid / kFC, cc = tid - w * kFC;
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += Ssum[(w * 16 + t) * kFC + cc];
      if (c0 + cc < d) pb[w * d + c0 + cc] = s;
    }
  }
}

template <int R>
cudaError_t launch_sx_attn_bwd(size_t smem, dim3 grid, cudaStream_t stream, const float* kv,
                               const float* probs, const float* gprobs, const float* glogits,
                               const float* gattn, const int* xlen, int Y, int X, int d,
                               float scale, float* dlog, float* dyq, float* part_bq) {
  cudaError_t err = fk::set_smem((const void*)x2y_sx_attn_bwd_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  x2y_sx_attn_bwd_kernel<R><<<grid, fk::kThreads, smem, stream>>>(
      kv, probs, gprobs, glogits, gattn, xlen, Y, X, d, scale, dlog, dyq, part_bq);
  return cudaGetLastError();
}

}  // namespace

// K2's small-X backward, one host call: the prep, packs and projections of
// sx_attn.cuh (recomputed, as JAX's kernel does), the attention terms, then
//   dy = dyq Wq^T                         (fk_k6_gemm, kMasked, K = d)
//   dWq = (y + y_pos)^T dyq               (fk_k6_wgrad over kc_y-frame chunks, fk_reduce)
//   d_ypos = sum_b dy[..., :Py]           (where wanted; y_pos shared by the batch)
//   dbq = the tiles' column sums          (fk_reduce in two stages: runs of `group`)
//   dkv = [dxk | dxv] (B, X, 2d), dxk = dlogits^T yq and dxv = probs^T g_attn per
//         video (fk_k6_wgrad, fk_reduce_to)
// and the X side that JAX's caller computes with plain products:
//   dx = dkv [Wk | Wv]^T                  (kMasked, K = 2d, over the key lengths)
//   dWk = (x + x_pos)^T dxk, dWv = x^T dxv (fk_k6_wgrad over kc_x-key chunks, fk_reduce)
//   [dbk | dbv] = the column sums of dkv           (two fixed-order stages, as dbq's)
//   d_xpos = (dxk, summed over the batch where x_pos is shared) Wk^T (where wanted;
//            (1 or B, X, Cx), the caller takes the leading Px channels)
// into the caller's workspace and outputs (ops/x2y_attn.py::_sx_bwd lays them
// out): part_bq holds n_slots >= B * ceil(Y / tile) rows (a multiple of
// group), stage n_slots / group rows, part the weight products' partials,
// dkv B * X rows rounded up to a multiple of group, dk the batch's dxk for
// d_xpos.  One host call: at epic's shapes the same
// work driven from Python took 0.3-0.4 ms of host time a call (H100 80GB
// HBM3, 700 W).
extern "C" int fk_x2y_sx_bwd(const float* y, const float* ypos, long long ystride, int Py,
                             const float* x, const float* xpos, long long xstride, int Px,
                             const float* wq, const float* bq, const float* wk, const float* bk,
                             const float* wv, const float* bv, const int* xlen,
                             const float* probs, const float* gprobs, const float* glogits,
                             const float* gattn, int B, int Y, int X, int Cy, int Cx, int d,
                             float scale, int* lens, float* yin, float* xin, float* probs_p,
                             float* wqp, float* wqn, float* wkvp, float* wkvn, float* yq,
                             float* kv, float* dlog, float* dyq, float* part_bq, int n_slots,
                             float* stage, float* part, float* dkv, float* dk, float* dy,
                             float* dypos, float* dwq, float* dbq, float* dx, float* dxpos,
                             float* dwk, float* dwv, float* dbk, float* dbv, int tile, int group,
                             int kc_y,
                             int kc_x, void* stream) {
  const int n_blk = B * ((Y + tile - 1) / tile);
  const int Bx = xstride ? B : 1;  // d_xpos's batch
  if (d % 4 || Cy % 4 || Cx % 4 || Py % 4 || Px % 4 || X < 1 || X > fk::kSxMaxKeys ||
      (tile != 8 && tile != 16 && tile != 32) || (ypos != nullptr) != (yin != nullptr) ||
      (xpos != nullptr) != (xin != nullptr) ||
      (X % 4 != 0) != (probs_p != nullptr) || group < 1 || n_slots % group ||
      n_slots < n_blk || kc_y % 32 || kc_x % 32 || kc_y < 32 || kc_x < 32 ||
      (dypos != nullptr && (ypos == nullptr || ystride != 0)) ||
      (dxpos != nullptr && (xpos == nullptr || dk == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const fk::SxProj p{y,  ypos, ystride, Py, x,  xpos, xstride, Px,  wq,  bq,    wk, bk,
                     wv, bv,   xlen,    B,  Y,  X,    Cy,      Cx,  d,   lens,  yin, xin,
                     wqp, wkvp, yq,     kv, probs, probs_p};
  int err = sx_project(p, s);
  if (err) return err;
  const size_t smem = fk::sx_smem_floats(tile, X, d) * sizeof(float);
  const dim3 grid((Y + tile - 1) / tile, B);
  err = (int)(tile == 32   ? launch_sx_attn_bwd<8>(smem, grid, s, kv, probs, gprobs, glogits,
                                                     gattn, xlen, Y, X, d, scale, dlog, dyq,
                                                     part_bq)
              : tile == 16 ? launch_sx_attn_bwd<4>(smem, grid, s, kv, probs, gprobs, glogits,
                                                     gattn, xlen, Y, X, d, scale, dlog, dyq,
                                                     part_bq)
                           : launch_sx_attn_bwd<2>(smem, grid, s, kv, probs, gprobs, glogits,
                                                     gattn, xlen, Y, X, d, scale, dlog, dyq,
                                                     part_bq));
  if (err) return err;
  if (n_slots > n_blk &&
      (err = (int)cudaMemsetAsync(part_bq + (size_t)n_blk * d, 0,
                                  (size_t)(n_slots - n_blk) * d * sizeof(float), s)))
    return err;
  const int one[2] = {0, 0};
  const int per_y = (Y + kc_y - 1) / kc_y, per_x = (X + kc_x - 1) / kc_x;  // chunks a video
  const int xp = fk::sx_pad(X);
  const long long cd = (long long)Cy * d, xd = (long long)X * d, kd = (long long)Cx * d;
  const int* lx = lens + B;  // the keys' lengths
  const float* xa = xin ? xin : x;  // [x + x_pos | x], or x for both
  const int xa_ch = xin ? 2 * Cx : Cx;
  const int runs_kv = (B * X + group - 1) / group;  // dkv holds runs_kv * group rows
  if ((err = fk_k6_pack(wq, wqn, Cy, d, 0, d, d, s)) ||
      (err = fk_k6_gemm(fk::kGemmMasked, dyq, d, 1, 1, one, d, wqn, Cy, d, B, Y, lens, dy, Cy,
                        0, nullptr, nullptr, nullptr, 0, 0, nullptr, nullptr, nullptr, 0, 0u,
                        1.f, s)) ||
      (err = fk_k6_wgrad(yin ? yin : y, Cy, 0, Cy, dyq, d, 0, d, lens, 0, 0, 1, part, B, Y, kc_y,
                         s)) ||
      (err = fk_reduce(part, 1, B * per_y, cd, 0, 1, 0, (int)cd, dwq, s)) ||
      (dypos != nullptr &&
       (err = fk_reduce(dy, 1, B, (long long)Y * Cy, 0, Y, Cy, Py, dypos, s))) ||
      (err = fk_reduce(part_bq, n_slots / group, group, d, (long long)group * d, 1, 0, d, stage,
                       s)) ||
      (err = fk_reduce(stage, 1, n_slots / group, d, 0, 1, 0, d, dbq, s)) ||
      (err = fk_k6_wgrad(dlog, xp, 0, X, yq, d, 0, d, lens, 0, 0, 1, part, B, Y, kc_y, s)) ||
      (err = fk_reduce_to(part, B, per_y, xd, per_y * xd, X, d, d, dkv, 2 * xd, 2 * d, s)) ||
      (err = fk_k6_wgrad(probs_p ? probs_p : probs, xp, 0, X, gattn, d, 0, d, lens, 0, 0, 1,
                         part, B, Y, kc_y, s)) ||
      (err = fk_reduce_to(part, B, per_y, xd, per_y * xd, X, d, d, dkv + d, 2 * xd, 2 * d, s)))
    return err;
  // the X side
  const long long nkv = (long long)Cx * 2 * d;
  sx_pack_kv_kernel<<<(int)((nkv + 255) / 256 < 1056 ? (nkv + 255) / 256 : 1056), 256, 0, s>>>(
      wk, wv, Cx, d, wkvn);
  if ((err = (int)cudaGetLastError()) ||
      (err = fk_k6_gemm(fk::kGemmMasked, dkv, 2 * d, 1, 1, one, 2 * d, wkvn, Cx, 2 * d, B, X, lx,
                        dx, Cx, 0, nullptr, nullptr, nullptr, 0, 0, nullptr, nullptr, nullptr, 0,
                        0u, 1.f, s)) ||
      (err = fk_k6_wgrad(xa, xa_ch, 0, Cx, dkv, 2 * d, 0, d, lx, 0, 0, 1, part, B, X, kc_x, s)) ||
      (err = fk_reduce(part, 1, B * per_x, kd, 0, 1, 0, (int)kd, dwk, s)) ||
      (err = fk_k6_wgrad(xa, xa_ch, xin ? Cx : 0, Cx, dkv, 2 * d, d, d, lx, 0, 0, 1, part, B, X,
                         kc_x, s)) ||
      (err = fk_reduce(part, 1, B * per_x, kd, 0, 1, 0, (int)kd, dwv, s)) ||
      // [dbk | dbv]: runs of `group` rows of dkv (zero rows pad it to whole runs), then the runs
      (err = (int)cudaMemsetAsync(dkv + 2 * (long long)B * xd, 0,
                                  (size_t)(runs_kv * group - B * X) * 2 * d * sizeof(float),
                                  s)) ||
      (err = fk_reduce(dkv, runs_kv, group, 2 * d, (long long)group * 2 * d, 1, 0, 2 * d, part,
                       s)) ||
      (err = fk_reduce(part, 1, runs_kv, 2 * d, 0, 1, 0, d, dbk, s)) ||
      (err = fk_reduce(part + d, 1, runs_kv, 2 * d, 0, 1, 0, d, dbv, s)))
    return err;
  if (dxpos == nullptr) return 0;
  // dxk of the batch (summed where x_pos is shared), (Bx, X, d), times Wk^T: the
  // first d of each packed row of [Wk | Wv] (a step past them reads dk's zeros)
  if ((err = fk_reduce_to(dkv, Bx, Bx == 1 ? B : 1, 2 * xd, 2 * xd, X, 2 * d, d, dk, xd, d, s)))
    return err;
  return fk_k6_gemm(fk::kGemmMasked, dk, d, 1, 1, one, d, wkvn, Cx, 2 * d, Bx, X,
                    Bx == 1 ? lens + 2 * B : lx, dxpos, Cx, 0, nullptr, nullptr, nullptr, 0, 0,
                    nullptr, nullptr, nullptr, 0, 0u, 1.f, s);
}

// The small-X form's attention terms alone, on a projection the caller made
// (the bf16 form, ops/x2y_attn.py::x2y_small_x16_bwd: yq (B, Y, d) and kv =
// [xk | xv] (B, X, 2d) f32 from the bf16 GEMM, as JAX's kernel takes them
// under mixed precision): dlog (B, Y, sx_pad(X)), dyq (B, Y, d) and the
// tiles' dbq shares part_bq (n_slots >= B * ceil(Y / tile) rows, the rest
// zeroed), as fk_x2y_sx_bwd computes them.
extern "C" int fk_x2y_sx_attn_bwd(const float* kv, const float* probs, const float* gprobs,
                                  const float* glogits, const float* gattn, const int* xlen,
                                  int B, int Y, int X, int d, float scale, float* dlog,
                                  float* dyq, float* part_bq, int n_slots, int tile,
                                  void* stream) {
  const int n_blk = B * ((Y + tile - 1) / tile);
  if (d % 4 || X < 1 || X > fk::kSxMaxKeys || (tile != 8 && tile != 16 && tile != 32) ||
      n_slots < n_blk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = fk::sx_smem_floats(tile, X, d) * sizeof(float);
  const dim3 grid((Y + tile - 1) / tile, B);
  int err = (int)(tile == 32   ? launch_sx_attn_bwd<8>(smem, grid, s, kv, probs, gprobs, glogits,
                                                         gattn, xlen, Y, X, d, scale, dlog, dyq,
                                                         part_bq)
                  : tile == 16 ? launch_sx_attn_bwd<4>(smem, grid, s, kv, probs, gprobs, glogits,
                                                         gattn, xlen, Y, X, d, scale, dlog, dyq,
                                                         part_bq)
                               : launch_sx_attn_bwd<2>(smem, grid, s, kv, probs, gprobs, glogits,
                                                         gattn, xlen, Y, X, d, scale, dlog, dyq,
                                                         part_bq));
  if (err) return err;
  if (n_slots > n_blk)
    return (int)cudaMemsetAsync(part_bq + (size_t)n_blk * d, 0,
                                (size_t)(n_slots - n_blk) * d * sizeof(float), s);
  return 0;
}

// The flash form's attention backward on the recomputed projection kv (B, X,
// 2d): dkv (B, X, 2d), part_dyq (B, n_slots, M, d) and part_b (B, n_slots,
// 2d), the 64-key tiles' shares in slots t < ceil(X / 64) <= n_slots of each
// video (the caller zeroes the others).
extern "C" int fk_x2y_flash_attn_bwd(const float* kv, const float* probs, const float* gprobs,
                                     const float* glogits, const float* gattn, const float* yq,
                                     const float* Dr, const int* xlen, int B, int X, int M, int d,
                                     float scale, float* dkv, float* part_dyq, float* part_b,
                                     int n_slots, void* stream) {
  if (M > kMaxM || d % 4 != 0 || n_slots < (X + kFT - 1) / kFT) return (int)cudaErrorInvalidValue;
  const size_t smem = flash_attn_bwd_floats() * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_flash_attn_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  x2y_flash_attn_bwd_kernel<<<dim3((X + kFT - 1) / kFT, B), fk::kThreads, smem,
                              (cudaStream_t)stream>>>(kv, probs, gprobs, glogits, gattn, yq, Dr,
                                                      xlen, X, M, d, scale, dkv, part_dyq,
                                                      part_b, n_slots);
  return (int)cudaGetLastError();
}
