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
// matmuls outside, as in the JAX caller.  Bound on the H100: f32 FMA, the q
// projection, dy and dWq (3 * 12.9 GFLOP for the flagship's a2f at B=8,
// Y=3072, Cy=d=512); the (B, Y, X) intermediates are small next to it.
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

namespace {

constexpr int BM = 64;     // query rows per block of the small-X form
constexpr int kMaxM = 64;  // flash: query rows per video (the attention's 64-wide panels)

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
