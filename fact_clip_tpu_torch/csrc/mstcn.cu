// K1: the fused MSTCN tower, forward and backward, on the towers' GEMM on
// the TF32 tensor cores at f32 accuracy (3xTF32 `wgmma` fed by TMA,
// tc_tower.cuh).  K1's GEMMs launch through the towers' one GEMM entry,
// mstcn2.cu's fk_k6_gemm; this file holds K1's row passes.
//
// Forward: replaces fact_clip_tpu/ops/pallas/dilated_conv.py::_stack_layer
// (_stack_kernel).  Per layer, for the frames of one video,
//   h = relu(sum_k x[t + (k-1)d] @ Wd[k] + bd)      (dilated conv3, SAME zeros)
//   z = x[t] + drop(h @ W1 + b1), then LayerNorm (eps) if use_ln
//   y[t] = z for t < len[b], 0 for t >= len[b]      (the tower's write mask)
// and, on the tower's last layer, logits[t] = y[t] @ Wo + bo (padded frames
// carry the bias row).  Taps before frame 0 or at or past len[b] read as
// zeros, so the layer needs no pre-masked input.  A ReLU sits between the
// two products, so a layer is two GEMM launches: (a) the conv over K = 3C
// as three segments (shifts -d, 0, +d) with the kRelu epilogue, writing h
// (the backward's save in training, a scratch buffer when serving: 25 MB at
// the flagship's 8 x 3072 x 256, small enough for the 50 MB L2 to keep
// between the launches), (b) the 1x1 over K = C on h with the kResid
// epilogue: + b1, the dropout hash (fk::dropout_bits, stream = layer, index
// (b*T + t)*C + c: the mask of ops/dropout.py bit for bit), + x, zero past
// the video.  A
// 128-column tile holds only part of a row, so LayerNorm is a row pass of
// its own (k1_ln: a warp per row, two-pass mean and variance as the JAX
// package's _ln_two_pass); the out projection is the kLogits GEMM.
//
// Backward: replaces _stack_bwd_layer (_stack_bwd_dc_kernel,
// _stack_bwd_dx_kernel), from the saved input stream x and ReLU output h
// and the cotangent g of the layer's output (on the last layer: of the
// logits):
//   last layer only: g = g_logits @ Wo^T (kMasked GEMM, K = O, zero past
//     len[b]); on the last layer and with LayerNorm, z = (h W1 + b1) * keep
//     + x recomputed (kResid GEMM);
//   k1_dz: the LayerNorm backward (statistics recomputed from z as the
//     forward computed them), dz, dh = dz * keep (the keep mask re-hashed in
//     place, never stored), the last layer's LN output y for dWo, and
//     per-block column sums for db1, dgamma, dbeta and dbo;
//   dc = (dh @ W1^T) * (h > 0): kGate GEMM with per-block column sums (dbd);
//   dx[s] = sum_k dc[s + (1-k)d] Wd[k]^T + dz[s], zero at s >= len[b] (the
//     kDx GEMM, K = 3C);
//   dWd (x^T dc over three shifted taps), dW1 = h^T dh and dWo = y^T
//     g_logits: K6's weight-gradient products over time, whose chunk
//     partials grad.cu's fk_reduce sums in a fixed order, as it sums the
//     column sums (no float atomics: the same bits on every run).
//
// Bound on the H100: the products, 3 TF32 passes at 495 TFLOP/s.  At the
// flagship's 8 x 3072 x 256 (22,022 valid frames), 10 layers, O = 512: a
// forward 8 C^2 FLOP a frame and layer + the out projection, 121 GFLOP ->
// 0.735 ms; the backward 16 C^2 a frame and layer (dc, dx, dWd, dW1), 2 C^2
// more on each layer that recomputes z (the last; every layer with LN) and
// the out projection's two products, 245 GFLOP -> 1.487 ms; bytes (B*T*C*4
// = 25 MB per stream pass) are below.  The limits are the GEMM's: C a
// multiple of 32, O a multiple of 4.
#include "common.cuh"

namespace {

constexpr int kDzRows = 16;  // the most frames of one k1_dz block

// y[b, t] = LayerNorm(y[b, t]) in place for t < len[b]; rows at or past
// len[b] are written as zeros.  R frames of one video a block, a warp a row.
__global__ void __launch_bounds__(fk::kThreads)
    k1_ln_kernel(float* __restrict__ y, const int* __restrict__ lengths,
                 const float* __restrict__ gamma, const float* __restrict__ beta, int T, int C,
                 int R, float eps) {
  const int b = blockIdx.y, t0 = blockIdx.x * R;
  const int L = min(lengths[b], T);
  const int rows = min(R, T - t0);
  fk::layer_norm_rows(y + ((size_t)b * T + t0) * C, rows, max(0, min(rows, L - t0)), C, gamma,
                      beta, eps);
}

// The layer's elementwise backward, R frames of one video a block, on valid
// frames (zeros elsewhere).  With LayerNorm: per row (a warp) mean and rstd
// of z by two passes as the forward's k1_ln, xhat = (z - mean) rstd,
//   dz = (g gamma - mean(g gamma) - xhat mean(g gamma xhat)) rstd,
// y_out = xhat gamma + beta (the last layer's output, for dWo); then per
// column (a thread) part[blk] = (sum dh, sum g xhat, sum g).  Without: dz =
// g (the caller hands g itself to the dx GEMM), part[blk] = sum dh.  Both:
// dh = dz * keep; part_o[blk] = sum of g_logits over every frame (dbo: the
// padded frames' logits are the bias row).
__global__ void __launch_bounds__(fk::kThreads)
    k1_dz_kernel(const float* __restrict__ g, const float* __restrict__ z,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ glg, const int* __restrict__ lengths, fk::Dropout drop,
                 float* dz, float* dh, float* y_out, float* __restrict__ part,
                 float* __restrict__ part_o, int T, int C, int O, int R, int use_ln, float eps) {
  __shared__ float stat[2 * kDzRows];  // per row: mean, rstd
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * R;
  const int L = min(lengths[b], T);
  const int rows = min(R, T - t0);
  const int vrows = max(0, min(rows, L - t0));
  const int blk = b * gridDim.x + blockIdx.x;
  const uint32_t seed = drop.load_seed();
  auto keep = [&](int t, int c) {
    return drop.seed != nullptr
               ? drop.keep(((uint32_t)b * (uint32_t)T + (uint32_t)t) * (uint32_t)C + (uint32_t)c,
                           seed)
               : 1.f;
  };
  if (!use_ln) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        const size_t e = ((size_t)b * T + t) * C + c;
        const float v = t < L ? __ldg(g + e) * keep(t, c) : 0.f;
        dh[e] = v;
        s += v;
      }
      part[(size_t)blk * C + c] = s;
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
      const int t = t0 + r;
      const size_t base = ((size_t)b * T + t) * C;
      if (r >= vrows) {
        for (int c = lane; c < C; c += 32) {
          dz[base + c] = 0.f;
          dh[base + c] = 0.f;
          if (y_out != nullptr) y_out[base + c] = 0.f;
        }
        continue;
      }
      const float* zr = z + base;
      const float* gr = g + base;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += __ldg(zr + c);
      const float mean = fk::warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = __ldg(zr + c) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(fk::warp_sum(v) / C + eps);
      float m1 = 0.f, m2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float gg = __ldg(gr + c) * __ldg(gamma + c);
        m1 += gg;
        m2 += gg * ((__ldg(zr + c) - mean) * rstd);
      }
      m1 = fk::warp_sum(m1) / C;
      m2 = fk::warp_sum(m2) / C;
      for (int c = lane; c < C; c += 32) {
        const float xh = (__ldg(zr + c) - mean) * rstd;
        const float dzv = (__ldg(gr + c) * __ldg(gamma + c) - m1 - xh * m2) * rstd;
        dz[base + c] = dzv;
        dh[base + c] = dzv * keep(t, c);
        if (y_out != nullptr) y_out[base + c] = xh * __ldg(gamma + c) + __ldg(beta + c);
      }
      if (lane == 0) {
        stat[2 * r] = mean;
        stat[2 * r + 1] = rstd;
      }
    }
    __syncthreads();  // dh and the statistics of every row of the block
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float sh = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < vrows; ++r) {
        const size_t e = ((size_t)b * T + t0 + r) * C + c;
        const float gv = __ldg(g + e);
        sh += dh[e];
        sg += gv * ((__ldg(z + e) - stat[2 * r]) * stat[2 * r + 1]);
        sb += gv;
      }
      float* pc = part + (size_t)blk * 3 * C;
      pc[c] = sh;
      pc[C + c] = sg;
      pc[2 * C + c] = sb;
    }
  }
  if (part_o == nullptr) return;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += __ldg(glg + ((size_t)b * T + t0 + r) * O + o);
    part_o[(size_t)blk * O + o] = s;
  }
}

}  // namespace

extern "C" int fk_k1_ln(float* y, const int* lengths, const float* gamma, const float* beta,
                        int B, int T, int C, int R, float eps, void* stream) {
  dim3 grid((T + R - 1) / R, B);
  k1_ln_kernel<<<grid, fk::kThreads, 0, (cudaStream_t)stream>>>(y, lengths, gamma, beta, T, C, R,
                                                                 eps);
  return (int)cudaGetLastError();
}

// part (B * ceil(T / R), 3 or 1, C) and part_o (B * ceil(T / R), O): see k1_dz_kernel
extern "C" int fk_k1_dz(const float* g, const float* z, const float* gamma, const float* beta,
                        const float* glg, const int* lengths, const int* seed, int layer,
                        unsigned thresh, float scale, float* dz, float* dh, float* y_out,
                        float* part, float* part_o, int B, int T, int C, int O, int R,
                        int use_ln, float eps, void* stream) {
  if (R < 1 || R > kDzRows) return (int)cudaErrorInvalidValue;
  dim3 grid((T + R - 1) / R, B);
  k1_dz_kernel<<<grid, fk::kThreads, 0, (cudaStream_t)stream>>>(
      g, z, gamma, beta, glg, lengths, fk::Dropout{seed, layer, thresh, scale}, dz, dh, y_out,
      part, part_o, T, C, O, R, use_ln, eps);
  return (int)cudaGetLastError();
}
