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
// K8b, the int8 twin (x2y_small_x_q8_kernel), replaces
// fact_clip_tpu/ops/pallas/quant_conv.py::_x2y_small_x_q8_impl
// (_x2y_small_x_kernel_q8): the frame rows y + y_pos arrive quantized per row
// (quant.cu's q8_rows_kernel: int8 values and each row's absmax s_y), the q
// projection is an int8 GEMM on quant.cuh's mma.sync core, dequantized in
// JAX's order fma(idot * s_y, swq, bq) (ops/quant_conv.py), and the logits, softmax and attend
// are this kernel's (small_x_attend).
//
// Bound on the H100: the q projection, 2 * B*Y*Cy*d FLOPs of f32 FMA
// (12.9 GFLOP for the u-block's a2f at B=8, Y=3072, Cy=d=512); the logits
// and the attend add 4 * B*Y*X*d (2 GFLOP at X=40).  Every product reads its
// second operand once per block of 64 rows, so each weight or key value
// fetched from L2 serves 64 rows.
#include <math.h>

#include "common.cuh"
#include "quant.cuh"

namespace {

constexpr int BM = 64;  // query rows per block
// floats at the front of the block's memory: the GEMM staging (f32, and the
// int8 staging of the q8 twin in the same place)
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
  float* yq = reinterpret_cast<float*>(smem_raw) + kStageFloats;

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

  small_x_attend(yq, s, xkb, xvb, rows, xl, X, d, scale, lb, prb, ab);
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

}  // namespace

extern "C" int fk_x2y_small_x(const float* y, const float* ypos, long long pos_bstride, int Py,
                              const float* xkt, const float* xv, const float* wq, const float* bq,
                              const int* xlen, float* attn, float* probs, float* logits, int B,
                              int Y, int X, int Cy, int d, float scale, void* stream) {
  const size_t smem = (kStageFloats + (size_t)BM * d) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)x2y_small_x_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Y + BM - 1) / BM, B);
  x2y_small_x_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      y, ypos, pos_bstride, Py, xkt, xv, wq, bq, xlen, attn, probs, logits, Y, X, Cy, d, scale);
  return (int)cudaGetLastError();
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
