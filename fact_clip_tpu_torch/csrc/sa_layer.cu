// K4: the post-norm sublayers of the action-token decoders, forward with
// dropout and backward, one block per video.
//
// Forward: replaces fact_clip_tpu/ops/pallas/sa_layer.py::_sa_fwd_impl
// (_sa_fwd_kernel) and ::_ffn_fwd_impl (_ffn_fwd_kernel):
//   SA:  y = LN(x + drop_o(MHA(x + pos, x + pos, x; drop_a on the probs) @ Wo + bo))
//   FFN: y = LN(x + drop_2(drop_1(relu(x @ W1 + b1)) @ W2 + b2))   (LN eps 1e-6)
// Every projection, the softmax, the dropout, the residual and the LayerNorm
// run in the kernel.  The per-video intermediates (q, k, v and the attention
// context, or the FFN hidden rows) go to a scratch buffer that the wrapper
// allocates; at M=40 tokens they are 160 KB per video and stay in L2; the
// attention stages one head's q, k and v at a time in shared memory.
//
// Dropout: the TPU kernels draw from the on-core PRNG seeded per video
// (sa_layer.py:138, :240).  Here a keep value is common.cuh's counter hash of
// (seed, stream, index) over the mask's logical shape (ops/dropout.py): SA
// stream 0 over (B, H*M, M) for the probabilities (rows h*M + m) and stream
// 1 over (B, M, E) for the output; FFN, with its own seed, stream 0 over
// (B, M, F) for the hidden rows and stream 1 over (B, M, E) for the output.
//
// Backward: replaces ::_sa_bwd (_sa_bwd_kernel) and ::_ffn_bwd
// (_ffn_bwd_kernel).  Each recomputes its forward from x (and pos) with the
// masks that dropout.cu regenerated for the call, takes the LayerNorm
// backward (eps 1e-6) and writes dx:
//   SA:  dout = dres * keep_o; dc = dout Wo^T; per head dPd = dc_h v_h^T,
//        dv_h = Pd^T dc_h, dS = P * (dPd * keep_a - rowsum(P * dPd * keep_a)) * scale,
//        dq_h = dS k_h, dk_h = dS^T q_h; dxa = dq Wq^T + dk Wk^T;
//        dx = dres + dxa + dv Wv^T.  It writes the panels c (the context),
//        dout, [dq | dk], dv and dxa, and per-video column sums (dbq, dbk,
//        dbv, dbo, dgamma, dbeta).  JAX sums the weight and positional
//        gradients across its sequential grid; here blocks run in no order,
//        so the wrapper takes dWq|dWk = (x + pos)^T [dq | dk], dWv = x^T dv,
//        dWo = c^T dout with grad.cu's fk_atb (one partial per video) and
//        sums those partials, the column sums and d(pos) = sum_b dxa[b] with
//        fk_reduce, in a fixed order.
//   FFN: dt2 = dres * keep_2; dh = (dt2 W2^T) * keep_1; dz1 = dh * (z1 > 0);
//        dx = dres + dz1 W1^T.  It writes dx, the panels dz1, h * keep_1 and
//        dt2, and the LN column sums; dW1 = x^T dz1 and dW2 = (h * keep_1)^T
//        dt2 stay matrix products outside, as in the JAX wrapper.
//
// Bound on the H100: latency.  A forward is 2*M*E*(4E) FLOPs per video (21
// MFLOP at M=40, E=256; the backward about three times that) spread over one
// SM per video, and at B=8 only 8 of the 132 SMs have work.  The design keeps
// each pass in one launch, in place of the ~15 (forward) or ~40 (autograd
// backward) small launches of the plain PyTorch version.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;  // token rows per GEMM pass

// rows [r0, r0 + BM) of A @ W (W: K x N, row-major); epi(r, c, acc) takes
// each finished value of a row r < M
template <class LoadA, class Epi>
__device__ __forceinline__ void rows_gemm(LoadA load_a, const float* __restrict__ W, int K, int N,
                                          int r0, int M, Epi epi, fk::GemmSmem<BM>& s) {
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
        if (c < N) epi(r, c, acc[i][j]);
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

// out = rows (M x N) @ W + bias, for all row tiles; a plain store
__device__ __forceinline__ void project(const float* src, const float* pos, int Pp, int M, int K,
                                        const float* __restrict__ W,
                                        const float* __restrict__ bias, int N, float* out,
                                        fk::GemmSmem<BM>& s) {
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{src, pos, Pp, r0, M, K}, W, K, N, r0, M,
              [&](int r, int c, float v) { out[(size_t)r * N + c] = v + __ldg(bias + c); }, s);
}

// Per-row LayerNorm statistics (two-pass mean and 1/sqrt(var + eps)) of M
// rows of width E, one warp per row, into mean[M], rstd[M].
__device__ __forceinline__ void ln_stats(const float* base, int M, int E, float eps, float* mean,
                                         float* rstd) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < M; r += fk::kWarps) {
    const float* row = base + (size_t)r * E;
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += row[c];
    const float mu = fk::warp_sum(s) / E;
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float inv = rsqrtf(fk::warp_sum(v) / E + eps);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = inv;
    }
  }
}

// The LayerNorm backward of M rows: `res` holds the LN input and is
// overwritten with dres = rstd * (gg - mean(gg) - xhat * mean(gg * xhat)),
// gg = g * gamma; dgamma = sum_r g * xhat and dbeta = sum_r g go to
// part[0:E], part[E:2E] (row order).  keep_out != nullptr also writes
// dout = dres * keep_out.  The caller synchronises first.
__device__ __forceinline__ void ln_backward(float* res, const float* __restrict__ g,
                                            const float* __restrict__ gamma, const float* mean,
                                            const float* rstd, int M, int E,
                                            float* __restrict__ part,
                                            const float* __restrict__ keep_out,
                                            float* __restrict__ dout) {
  for (int c = threadIdx.x; c < E; c += fk::kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < M; ++r) {
      const float gv = __ldg(g + (size_t)r * E + c);
      sg = fmaf(gv, (res[(size_t)r * E + c] - mean[r]) * rstd[r], sg);
      sb += gv;
    }
    part[c] = sg;
    part[E + c] = sb;
  }
  __syncthreads();  // every column sum has read res before it is overwritten
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < M; r += fk::kWarps) {
    float* row = res + (size_t)r * E;
    const float* gr = g + (size_t)r * E;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float gg = __ldg(gr + c) * __ldg(gamma + c);
      s1 += gg;
      s2 += gg * (row[c] - mean[r]) * rstd[r];
    }
    s1 = fk::warp_sum(s1) / E;
    s2 = fk::warp_sum(s2) / E;
    for (int c = lane; c < E; c += 32) {
      const float xhat = (row[c] - mean[r]) * rstd[r];
      const float d = rstd[r] * (__ldg(gr + c) * __ldg(gamma + c) - s1 - xhat * s2);
      row[c] = d;
      if (dout != nullptr)
        dout[(size_t)r * E + c] = keep_out != nullptr ? d * __ldg(keep_out + (size_t)r * E + c) : d;
    }
  }
}

// Shared memory of the attention stages: one head's q, k, v (and dc), two
// M x M row panels and the LN row statistics.
__host__ __device__ inline size_t sa_smem_floats(int M, int hd) {
  return (size_t)4 * M * (hd + 1) + (size_t)2 * M * M + (size_t)2 * M;
}

__global__ void __launch_bounds__(fk::kThreads)
sa_sublayer_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                   long long pos_bstride, int Pp, const float* __restrict__ wq,
                   const float* __restrict__ bq, const float* __restrict__ wk,
                   const float* __restrict__ bk, const float* __restrict__ wv,
                   const float* __restrict__ bv, const float* __restrict__ wo,
                   const float* __restrict__ bo, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ scratch,
                   float* __restrict__ y, int M, int E, int H, float eps, fk::Dropout drop_a,
                   fk::Dropout drop_o) {
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
  const uint32_t seed_a = drop_a.load_seed();
  const uint32_t seed_o = drop_o.load_seed();

  project(xb, pb, Pp, M, E, wq, bq, E, qb, s);
  project(xb, pb, Pp, M, E, wk, bk, E, kb, s);
  project(xb, nullptr, 0, M, E, wv, bv, E, vb, s);
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
      const uint32_t row = ((uint32_t)b * (uint32_t)H + (uint32_t)h) * (uint32_t)M + (uint32_t)m;
      for (int j = tx; j < M; j += 32) {
        float p = expf(pw[j] - mx) * inv;
        if (drop_a.seed != nullptr) p *= drop_a.keep(row * (uint32_t)M + (uint32_t)j, seed_a);
        pw[j] = p;
      }
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

  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{cb, nullptr, 0, r0, M, E}, wo, E, E, r0, M,
              [&](int r, int c, float v) {
                v += __ldg(bo + c);
                if (drop_o.seed != nullptr)
                  v *= drop_o.keep(((uint32_t)b * (uint32_t)M + (uint32_t)r) * (uint32_t)E +
                                       (uint32_t)c, seed_o);
                yb[(size_t)r * E + c] = v + __ldg(xb + (size_t)r * E + c);
              }, s);
  __syncthreads();
  fk::layer_norm_rows(yb, M, M, E, gamma, beta, eps);
}

__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_kernel(const float* __restrict__ x, const float* __restrict__ pos, int Pp,
              const float* __restrict__ wq, const float* __restrict__ bq,
              const float* __restrict__ wk, const float* __restrict__ bk,
              const float* __restrict__ wv, const float* __restrict__ bv,
              const float* __restrict__ wo, const float* __restrict__ bo,
              const float* __restrict__ gamma, const float* __restrict__ wot,
              const float* __restrict__ wqkt, const float* __restrict__ wvt,
              const float* __restrict__ keep_a, const float* __restrict__ keep_o,
              const float* __restrict__ g, float* __restrict__ scratch, float* __restrict__ c_out,
              float* __restrict__ dout, float* __restrict__ dqk, float* __restrict__ dv,
              float* __restrict__ dxa, float* __restrict__ dx, float* __restrict__ part, int M,
              int E, int H, float eps) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* sm = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);

  const int b = blockIdx.x;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int hd = E / H;
  const int ldh = hd + 1;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t ME = (size_t)M * E;
  const float* xb = x + b * ME;
  const float* gb = g + b * ME;
  float* qb = scratch + b * 5 * ME;  // q, k, v, res -> dres, dc
  float* kb = qb + ME;
  float* vb = kb + ME;
  float* rb = vb + ME;
  float* dcb = rb + ME;
  float* cb = c_out + b * ME;
  float* doutb = dout + b * ME;
  float* dqkb = dqk + b * 2 * ME;
  float* dvb = dv + b * ME;
  float* dxab = dxa + b * ME;
  float* partb = part + (size_t)b * 6 * E;
  const float* ka = keep_a ? keep_a + (size_t)b * H * M * M : nullptr;
  const float* ko = keep_o ? keep_o + b * ME : nullptr;
  float* qs = sm;  // [M][ldh] each: q_h, k_h, v_h, dc_h
  float* ks = qs + (size_t)M * ldh;
  float* vs = ks + (size_t)M * ldh;
  float* dcs = vs + (size_t)M * ldh;
  float* S = dcs + (size_t)M * ldh;  // [M][M]: scores, then P, then dS
  float* PD = S + (size_t)M * M;     // [M][M]: dPd, then P * keep_a
  float* mean = PD + (size_t)M * M;
  float* rstd = mean + M;

  // 1. the forward again: q, k, v; per head P and the context c = (P * keep_a) v
  project(xb, pos, Pp, M, E, wq, bq, E, qb, s);
  project(xb, pos, Pp, M, E, wk, bk, E, kb, s);
  project(xb, nullptr, 0, M, E, wv, bv, E, vb, s);
  __syncthreads();
  auto stage = [&](int h, bool with_dc) {
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
      const int m = i / hd;
      const int dd = i - m * hd;
      const size_t e = (size_t)m * E + h * hd + dd;
      qs[m * ldh + dd] = qb[e];
      ks[m * ldh + dd] = kb[e];
      vs[m * ldh + dd] = vb[e];
      if (with_dc) dcs[m * ldh + dd] = dcb[e];
    }
    __syncthreads();
  };
  // row m of the staged head, by one warp: S[m] <- softmax(q_h[m] . k_h^T * scale)
  auto softmax_row = [&](int m) {
    float* sr = S + (size_t)m * M;
    for (int j = tx; j < M; j += 32) {
      float dot = 0.f;
      for (int dd = 0; dd < hd; ++dd) dot = fmaf(qs[m * ldh + dd], ks[j * ldh + dd], dot);
      sr[j] = dot * scale;
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = tx; j < M; j += 32) mx = fmaxf(mx, sr[j]);
    mx = fk::warp_max(mx);
    float sum = 0.f;
    for (int j = tx; j < M; j += 32) sum += expf(sr[j] - mx);
    const float inv = 1.f / fk::warp_sum(sum);
    __syncwarp();
    for (int j = tx; j < M; j += 32) sr[j] = expf(sr[j] - mx) * inv;
    __syncwarp();
  };
  for (int h = 0; h < H; ++h) {
    stage(h, false);
    for (int m = ty; m < M; m += fk::kWarps) {
      softmax_row(m);
      float* sr = S + (size_t)m * M;
      if (ka != nullptr)
        for (int j = tx; j < M; j += 32) sr[j] *= __ldg(ka + ((size_t)h * M + m) * M + j);
      __syncwarp();
      for (int dd = tx; dd < hd; dd += 32) {
        float o = 0.f;
        for (int j = 0; j < M; ++j) o = fmaf(sr[j], vs[j * ldh + dd], o);
        cb[(size_t)m * E + h * hd + dd] = o;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // 2. res = x + drop_o(c Wo + bo), its LN statistics, the LN backward
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{cb, nullptr, 0, r0, M, E}, wo, E, E, r0, M,
              [&](int r, int c, float v) {
                v += __ldg(bo + c);
                if (ko != nullptr) v *= __ldg(ko + (size_t)r * E + c);
                rb[(size_t)r * E + c] = v + __ldg(xb + (size_t)r * E + c);
              }, s);
  __syncthreads();
  ln_stats(rb, M, E, eps, mean, rstd);
  __syncthreads();
  ln_backward(rb, gb, gamma, mean, rstd, M, E, partb + 4 * E, ko, doutb);
  __syncthreads();

  // 3. dbo; dc = dout Wo^T
  fk::block_colsum(doutb, E, M, E, partb + 3 * E);
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{doutb, nullptr, 0, r0, M, E}, wot, E, E, r0, M,
              [&](int r, int c, float v) { dcb[(size_t)r * E + c] = v; }, s);
  __syncthreads();

  // 4. per head: dS, then dq_h = dS k_h, dk_h = dS^T q_h, dv_h = (P * keep_a)^T dc_h
  for (int h = 0; h < H; ++h) {
    stage(h, true);
    for (int m = ty; m < M; m += fk::kWarps) {
      softmax_row(m);
      float* sr = S + (size_t)m * M;
      float* pr = PD + (size_t)m * M;
      const float* kr = ka ? ka + ((size_t)h * M + m) * M : nullptr;
      float rs = 0.f;
      for (int j = tx; j < M; j += 32) {
        float dot = 0.f;
        for (int dd = 0; dd < hd; ++dd) dot = fmaf(dcs[m * ldh + dd], vs[j * ldh + dd], dot);
        const float dp = kr ? dot * __ldg(kr + j) : dot;
        pr[j] = dp;
        rs = fmaf(sr[j], dp, rs);
      }
      rs = fk::warp_sum(rs);
      for (int j = tx; j < M; j += 32) {  // each lane rewrites only its own j
        const float p = sr[j];
        sr[j] = p * (pr[j] - rs) * scale;
        pr[j] = kr ? p * __ldg(kr + j) : p;
      }
      __syncwarp();
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
      const int r = i / hd;  // a query row for dq, a key row for dk and dv
      const int dd = i - r * hd;
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int j = 0; j < M; ++j) {
        aq = fmaf(S[(size_t)r * M + j], ks[j * ldh + dd], aq);
        ak = fmaf(S[(size_t)j * M + r], qs[j * ldh + dd], ak);
        av = fmaf(PD[(size_t)j * M + r], dcs[j * ldh + dd], av);
      }
      dqkb[(size_t)r * 2 * E + h * hd + dd] = aq;
      dqkb[(size_t)r * 2 * E + E + h * hd + dd] = ak;
      dvb[(size_t)r * E + h * hd + dd] = av;
    }
    __syncthreads();
  }

  // 5. dbq, dbk, dbv; dxa = [dq | dk] @ [Wq^T ; Wk^T]
  fk::block_colsum(dqkb, 2 * E, M, 2 * E, partb);
  fk::block_colsum(dvb, E, M, E, partb + 2 * E);
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{dqkb, nullptr, 0, r0, M, 2 * E}, wqkt, 2 * E, E, r0, M,
              [&](int r, int c, float v) { dxab[(size_t)r * E + c] = v; }, s);
  __syncthreads();

  // 6. dx = dres + dxa + dv Wv^T; plain loads: written above
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{dvb, nullptr, 0, r0, M, E}, wvt, E, E, r0, M,
              [&](int r, int c, float v) {
                const size_t e = (size_t)r * E + c;
                dx[b * ME + e] = v + rb[e] + dxab[e];
              }, s);
}

__global__ void __launch_bounds__(fk::kThreads)
ffn_sublayer_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ scratch,
                    float* __restrict__ y, int M, int E, int F, float eps, fk::Dropout drop_1,
                    fk::Dropout drop_2) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * M * E;
  float* hb = scratch + (size_t)b * M * F;
  float* yb = y + (size_t)b * M * E;
  const uint32_t seed_1 = drop_1.load_seed();
  const uint32_t seed_2 = drop_2.load_seed();

  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{xb, nullptr, 0, r0, M, E}, w1, E, F, r0, M,
              [&](int r, int c, float v) {
                v = fmaxf(v + __ldg(b1 + c), 0.f);
                if (drop_1.seed != nullptr)
                  v *= drop_1.keep(((uint32_t)b * (uint32_t)M + (uint32_t)r) * (uint32_t)F +
                                       (uint32_t)c, seed_1);
                hb[(size_t)r * F + c] = v;
              }, s);
  __syncthreads();
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{hb, nullptr, 0, r0, M, F}, w2, F, E, r0, M,
              [&](int r, int c, float v) {
                v += __ldg(b2 + c);
                if (drop_2.seed != nullptr)
                  v *= drop_2.keep(((uint32_t)b * (uint32_t)M + (uint32_t)r) * (uint32_t)E +
                                       (uint32_t)c, seed_2);
                yb[(size_t)r * E + c] = v + __ldg(xb + (size_t)r * E + c);
              }, s);
  __syncthreads();
  fk::layer_norm_rows(yb, M, M, E, gamma, beta, eps);
}

__global__ void __launch_bounds__(fk::kThreads)
ffn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ w1t, const float* __restrict__ w2t,
               const float* __restrict__ keep_1, const float* __restrict__ keep_2,
               const float* __restrict__ g, float* __restrict__ scratch, float* __restrict__ dz1,
               float* __restrict__ hk, float* __restrict__ dt2, float* __restrict__ dx,
               float* __restrict__ part, int M, int E, int F, float eps) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* mean = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);
  float* rstd = mean + M;
  const int b = blockIdx.x;
  const size_t ME = (size_t)M * E;
  const size_t MF = (size_t)M * F;
  const float* xb = x + b * ME;
  float* rb = scratch + b * ME;  // res, then dres
  float* zb = dz1 + b * MF;      // z1, then dz1
  float* hkb = hk + b * MF;
  float* dt2b = dt2 + b * ME;
  const float* k1 = keep_1 ? keep_1 + b * MF : nullptr;
  const float* k2 = keep_2 ? keep_2 + b * ME : nullptr;

  // 1. the forward again: z1, h * keep_1, res = x + drop_2(t2)
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{xb, nullptr, 0, r0, M, E}, w1, E, F, r0, M,
              [&](int r, int c, float v) {
                const size_t e = (size_t)r * F + c;
                v += __ldg(b1 + c);
                zb[e] = v;
                const float h = fmaxf(v, 0.f);
                hkb[e] = k1 != nullptr ? h * __ldg(k1 + e) : h;
              }, s);
  __syncthreads();
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{hkb, nullptr, 0, r0, M, F}, w2, F, E, r0, M,
              [&](int r, int c, float v) {
                const size_t e = (size_t)r * E + c;
                v += __ldg(b2 + c);
                if (k2 != nullptr) v *= __ldg(k2 + e);
                rb[e] = v + __ldg(xb + e);
              }, s);
  __syncthreads();

  // 2. the LN backward; dt2 = dres * keep_2
  ln_stats(rb, M, E, eps, mean, rstd);
  __syncthreads();
  ln_backward(rb, g + b * ME, gamma, mean, rstd, M, E, part + (size_t)b * 2 * E, k2, dt2b);
  __syncthreads();

  // 3. dz1 = (dt2 W2^T) * keep_1 * (z1 > 0), over z1 in place (one thread per element)
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{dt2b, nullptr, 0, r0, M, E}, w2t, E, F, r0, M,
              [&](int r, int c, float v) {
                const size_t e = (size_t)r * F + c;
                if (k1 != nullptr) v *= __ldg(k1 + e);
                zb[e] = zb[e] > 0.f ? v : 0.f;
              }, s);
  __syncthreads();

  // 4. dx = dres + dz1 W1^T
  for (int r0 = 0; r0 < M; r0 += BM)
    rows_gemm(Rows{zb, nullptr, 0, r0, M, F}, w1t, F, E, r0, M,
              [&](int r, int c, float v) {
                const size_t e = (size_t)r * E + c;
                dx[b * ME + e] = v + rb[e];
              }, s);
}

}  // namespace

extern "C" int fk_sa_sublayer(const float* x, const float* pos, long long pos_bstride, int Pp,
                              const float* wq, const float* bq, const float* wk,
                              const float* bk, const float* wv, const float* bv,
                              const float* wo, const float* bo, const float* gamma,
                              const float* beta, float* scratch, float* y, int B, int M, int E,
                              int H, float eps, const int* seed_a, int stream_a,
                              unsigned thresh_a, float scale_a, const int* seed_o, int stream_o,
                              unsigned thresh_o, float scale_o, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) +
                      ((size_t)fk::kWarps * M + (size_t)3 * M * (E / H + 1)) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)sa_sublayer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sa_sublayer_kernel<<<B, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, pos, pos_bstride, Pp, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, scratch, y, M, E, H,
      eps, fk::Dropout{seed_a, stream_a, thresh_a, scale_a},
      fk::Dropout{seed_o, stream_o, thresh_o, scale_o});
  return (int)cudaGetLastError();
}

extern "C" int fk_ffn_sublayer(const float* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, const float* gamma,
                               const float* beta, float* scratch, float* y, int B, int M, int E,
                               int F, float eps, const int* seed_1, int stream_1,
                               unsigned thresh_1, float scale_1, const int* seed_2, int stream_2,
                               unsigned thresh_2, float scale_2, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>);
  cudaError_t err = fk::set_smem((const void*)ffn_sublayer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_sublayer_kernel<<<B, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, gamma, beta, scratch, y, M, E, F, eps,
      fk::Dropout{seed_1, stream_1, thresh_1, scale_1},
      fk::Dropout{seed_2, stream_2, thresh_2, scale_2});
  return (int)cudaGetLastError();
}

extern "C" int fk_sa_bwd(const float* x, const float* pos, int Pp, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, const float* wo, const float* bo, const float* gamma,
                         const float* wot, const float* wqkt, const float* wvt,
                         const float* keep_a, const float* keep_o, const float* g,
                         float* scratch, float* c_out, float* dout, float* dqk, float* dv,
                         float* dxa, float* dx, float* part, int B, int M, int E, int H,
                         float eps, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) + sa_smem_floats(M, E / H) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)sa_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sa_bwd_kernel<<<B, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, pos, Pp, wq, bq, wk, bk, wv, bv, wo, bo, gamma, wot, wqkt, wvt, keep_a, keep_o, g,
      scratch, c_out, dout, dqk, dv, dxa, dx, part, M, E, H, eps);
  return (int)cudaGetLastError();
}

extern "C" int fk_ffn_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* gamma, const float* w1t,
                          const float* w2t, const float* keep_1, const float* keep_2,
                          const float* g, float* scratch, float* dz1, float* hk, float* dt2,
                          float* dx, float* part, int B, int M, int E, int F, float eps,
                          void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) + (size_t)2 * M * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)ffn_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_kernel<<<B, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, gamma, w1t, w2t, keep_1, keep_2, g, scratch, dz1, hk, dt2, dx, part, M,
      E, F, eps);
  return (int)cudaGetLastError();
}
