// K4: the post-norm sublayers of the action-token decoders, one block per
// video (forward, dropout off).
//
// Replaces fact_clip_tpu/ops/pallas/sa_layer.py::_sa_fwd_impl (_sa_fwd_kernel)
// and ::_ffn_fwd_impl (_ffn_fwd_kernel):
//   SA:  y = LN(x + MHA(x + pos, x + pos, x) @ Wo + bo)
//   FFN: y = LN(x + relu(x @ W1 + b1) @ W2 + b2)            (LN eps 1e-6)
// Every projection, the softmax, the residual and the LayerNorm run in the
// kernel.  The per-video intermediates (q, k, v and the attention context,
// or the FFN hidden rows) go to a scratch buffer that the wrapper allocates;
// at M=40 tokens they are 160 KB per video and stay in L2; the attention
// stages one head's q, k and v at a time in shared memory.
//
// Bound on the H100: latency.  A sublayer is 2*M*E*(4E) FLOPs per video
// (21 MFLOP at M=40, E=256) spread over one SM per video, and at B=8 only 8
// of the 132 SMs have work.  The design keeps each sublayer in one launch,
// in place of the ~15 small launches of the plain PyTorch version.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;  // token rows per GEMM pass

// rows [r0, r0 + BM) of out = A @ W + bias (+ residual), optional relu
template <class LoadA>
__device__ __forceinline__ void rows_gemm(LoadA load_a, const float* __restrict__ W,
                                          const float* __restrict__ bias, int K, int N,
                                          int r0, int M, const float* residual, bool relu,
                                          float* out, fk::GemmSmem<BM>& s) {
  constexpr int RM = BM / 8;
  float acc[RM][8];
  for (int n0 = 0; n0 < N; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, load_a, W, N, K, n0, N, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + fk::pass_row<BM>(i);
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= N) continue;
        float v = acc[i][j] + __ldg(bias + c);
        if (relu) v = fmaxf(v, 0.f);
        if (residual != nullptr) v += __ldg(residual + (size_t)r * N + c);
        out[(size_t)r * N + c] = v;
      }
    }
  }
}

// A element (r, k) of the row tile at r0: src[r0 + r][k] (+ pos), zero past
// M rows.  `src` may have been written earlier in this kernel: plain loads.
struct Rows {
  const float* src;
  const float* pos;
  int Pp, r0, M, K;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const int row = r0 + r;
    if (row >= M) return 0.f;
    float v = src[(size_t)row * K + k];
    if (pos != nullptr && k < Pp) v += __ldg(pos + (size_t)row * Pp + k);
    return v;
  }
};

__global__ void __launch_bounds__(fk::kThreads)
sa_sublayer_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                   long long pos_bstride, int Pp, const float* __restrict__ wq,
                   const float* __restrict__ bq, const float* __restrict__ wk,
                   const float* __restrict__ bk, const float* __restrict__ wv,
                   const float* __restrict__ bv, const float* __restrict__ wo,
                   const float* __restrict__ bo, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ scratch,
                   float* __restrict__ y, int M, int E, int H, float eps) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* p_s = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);

  const int b = blockIdx.x;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int hd = E / H;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t ME = (size_t)M * E;
  const float* xb = x + b * ME;
  const float* pb = pos ? pos + (size_t)b * pos_bstride : nullptr;
  float* qb = scratch + b * 4 * ME;  // q, k, v, context
  float* kb = qb + ME;
  float* vb = kb + ME;
  float* cb = vb + ME;
  float* yb = y + b * ME;

  for (int r0 = 0; r0 < M; r0 += BM) {
    const Rows with_pos{xb, pb, Pp, r0, M, E};
    const Rows plain{xb, nullptr, 0, r0, M, E};
    rows_gemm(with_pos, wq, bq, E, E, r0, M, nullptr, false, qb, s);
    rows_gemm(with_pos, wk, bk, E, E, r0, M, nullptr, false, kb, s);
    rows_gemm(plain, wv, bv, E, E, r0, M, nullptr, false, vb, s);
  }
  __syncthreads();

  // one head at a time: its q, k, v columns staged in shared memory (odd
  // row stride: lane j reading key row j is conflict-free), one warp per
  // query row
  float* pw = p_s + (size_t)ty * M;
  const int ldh = hd + 1;
  float* qs = p_s + (size_t)fk::kWarps * M;
  float* ks = qs + (size_t)M * ldh;
  float* vs = ks + (size_t)M * ldh;
  for (int h = 0; h < H; ++h) {
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
      const int m = i / hd;
      const int dd = i - m * hd;
      const size_t g = (size_t)m * E + h * hd + dd;
      qs[m * ldh + dd] = qb[g];
      ks[m * ldh + dd] = kb[g];
      vs[m * ldh + dd] = vb[g];
    }
    __syncthreads();
    for (int m = ty; m < M; m += fk::kWarps) {
      const float* qr = qs + m * ldh;
      for (int j = tx; j < M; j += 32) {
        const float* kr = ks + j * ldh;
        float dot = 0.f;
        for (int dd = 0; dd < hd; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        pw[j] = dot * scale;
      }
      __syncwarp();
      float mx = -INFINITY;
      for (int j = tx; j < M; j += 32) mx = fmaxf(mx, pw[j]);
      mx = fk::warp_max(mx);
      float sum = 0.f;
      for (int j = tx; j < M; j += 32) sum += expf(pw[j] - mx);
      const float inv = 1.f / fk::warp_sum(sum);
      __syncwarp();
      for (int j = tx; j < M; j += 32) pw[j] = expf(pw[j] - mx) * inv;
      __syncwarp();
      for (int dd = tx; dd < hd; dd += 32) {
        float o = 0.f;
        for (int j = 0; j < M; ++j) o = fmaf(pw[j], vs[j * ldh + dd], o);
        cb[(size_t)m * E + h * hd + dd] = o;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int r0 = 0; r0 < M; r0 += BM) {
    rows_gemm(Rows{cb, nullptr, 0, r0, M, E}, wo, bo, E, E, r0, M, xb, false, yb, s);
  }
  __syncthreads();
  fk::layer_norm_rows(yb, M, M, E, gamma, beta, eps);
}

__global__ void __launch_bounds__(fk::kThreads)
ffn_sublayer_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ scratch,
                    float* __restrict__ y, int M, int E, int F, float eps) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * M * E;
  float* hb = scratch + (size_t)b * M * F;
  float* yb = y + (size_t)b * M * E;

  for (int r0 = 0; r0 < M; r0 += BM) {
    rows_gemm(Rows{xb, nullptr, 0, r0, M, E}, w1, b1, E, F, r0, M, nullptr, true, hb, s);
  }
  __syncthreads();
  for (int r0 = 0; r0 < M; r0 += BM) {
    rows_gemm(Rows{hb, nullptr, 0, r0, M, F}, w2, b2, F, E, r0, M, xb, false, yb, s);
  }
  __syncthreads();
  fk::layer_norm_rows(yb, M, M, E, gamma, beta, eps);
}

}  // namespace

extern "C" int fk_sa_sublayer(const float* x, const float* pos, long long pos_bstride, int Pp,
                              const float* wq, const float* bq, const float* wk,
                              const float* bk, const float* wv, const float* bv,
                              const float* wo, const float* bo, const float* gamma,
                              const float* beta, float* scratch, float* y, int B, int M, int E,
                              int H, float eps, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) +
                      ((size_t)fk::kWarps * M + (size_t)3 * M * (E / H + 1)) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)sa_sublayer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sa_sublayer_kernel<<<B, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, pos, pos_bstride, Pp, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, scratch, y, M, E, H,
      eps);
  return (int)cudaGetLastError();
}

extern "C" int fk_ffn_sublayer(const float* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, const float* gamma,
                               const float* beta, float* scratch, float* y, int B, int M, int E,
                               int F, float eps, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>);
  cudaError_t err = fk::set_smem((const void*)ffn_sublayer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_sublayer_kernel<<<B, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, gamma, beta, scratch, y, M, E, F, eps);
  return (int)cudaGetLastError();
}
