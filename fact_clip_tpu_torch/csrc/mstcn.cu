// K1: one layer of the fused MSTCN tower, forward and backward.
//
// Forward: replaces fact_clip_tpu/ops/pallas/dilated_conv.py::_stack_layer
// (_stack_kernel): for a tile of 64 frames of one video
//   h = relu(sum_k x[t + (k-1)d] @ Wd[k] + bd)      (dilated conv3, SAME zeros)
//   z = x[t] + drop(h @ W1 + b1), then LayerNorm (eps) if use_ln
//   y[t] = z for t < len[b], 0 for t >= len[b]      (the tower's write mask)
// and, on the tower's last layer, logits[t] = y[t] @ Wo + bo (padded frames
// carry the bias row).  Frames at or past len[b] read as zeros, so the
// layer needs no pre-masked input.  In training the layer also writes h (the
// ReLU activations) for the backward.
//
// Dropout: the TPU kernel draws bits from the on-core PRNG seeded per grid
// cell (_keep_mask, _seed_cell); this card has no such PRNG, so the keep
// mask is fk::dropout_bits(seed, layer, (b*T + t)*C + c) < thresh, scaled by
// 1/(1-rate).  The forward, the backward and the mask kernel (the
// counterpart of dilated_conv.py::dropout_mask) compute it; it is never
// kept past the layer's backward.
//
// Backward: replaces _stack_bwd_layer (_stack_bwd_dc_kernel,
// _stack_bwd_dx_kernel), from the saved input stream x and activation h and
// the cotangent g of the layer's output (on the last layer: of the logits):
//   bwd_dc: per 64-frame tile, z and y recomputed from h, x and the mask
//           (regenerated for the layer by the mask kernel, as the JAX
//           package's layer backward regenerates it with dropout_mask);
//           the out projection's backward (dy = g_logits @ Wo^T) on the last
//           layer; the LayerNorm backward; dz; dh = dz * keep; dc = (dh @
//           W1^T) * (h > 0).  It writes dc, dz, dh (and y on the last layer)
//           and per-block column sums for db1, dbd, dgamma, dbeta, dob.
//   bwd_dx: dx[s] = dc[s+d] Wd[0]^T + dc[s] Wd[1]^T + dc[s-d] Wd[2]^T + dz[s],
//           zero at s >= len[b]; the taps read dc straight from global
//           memory, as the forward reads x, since d reaches 512 frames.
// The weight gradients dWd, dW1, dWo are sums over B*T rows: grad.cu's
// fk_atb writes per-block partial products and fk_reduce sums them (and the
// column sums) in a fixed order, so the result does not vary from run to
// run.
//
// Bound on the H100: f32 FMA on the CUDA cores.  A layer forward is
// 2 * B*T * 4*C*C FLOPs (12.9 GFLOP at B=8, T=3072, C=256) against
// 2 * B*T*C*4 bytes of stream traffic, ~260 FLOP per byte, far above the
// card's f32 ridge (~20); the backward is about twice that (da, dx, dWd, dW1).
// The design keeps the relu activations of the tile in shared memory between
// the forward's two GEMMs and reads the dilated taps straight from global
// memory per tile: a dilation of up to 512 frames reaches far beyond any
// tile, and the taps' rows come from L2.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // frames per block

struct Dropout {
  const int* seed;  // this layer's seed (device), nullptr: no dropout
  int layer;
  unsigned thresh;
  float scale;
  __device__ __forceinline__ float keep(int b, int T, int C, int t, int c, uint32_t s) const {
    const uint32_t idx = ((uint32_t)b * (uint32_t)T + (uint32_t)t) * (uint32_t)C + (uint32_t)c;
    return fk::dropout_bits(s, (uint32_t)layer, idx) < thresh ? scale : 0.f;
  }
};

__global__ void __launch_bounds__(fk::kThreads)
mstcn_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const int* __restrict__ lengths,
                   const float* __restrict__ wd, const float* __restrict__ bd,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ ow, const float* __restrict__ ob,
                   float* __restrict__ logits, float* __restrict__ a_out, Dropout drop,
                   int T, int C, int O, int dil, int use_ln, float eps) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* h = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);
  const int ldh = C + 4;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const int L = min(lengths[b], T);
  const float* xb = x + (size_t)b * T * C;
  float* yb = y + (size_t)b * T * C;
  const uint32_t seed = drop.seed ? (uint32_t)drop.seed[0] : 0u;
  float acc[RM][8];

  // stage 1: dilated conv as one GEMM over K = 3C (tap-major rows of Wd)
  auto taps = [&](int r, int k) {
    const int tap = k / C;
    const int t = t0 + r + (tap - 1) * dil;
    return (t >= 0 && t < L) ? __ldg(xb + (size_t)t * C + (k - tap * C)) : 0.f;
  };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, taps, wd, C, 3 * C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        const float v = fmaxf(acc[i][j] + __ldg(bd + c), 0.f);
        h[r * ldh + c] = v;
        if (a_out != nullptr && t0 + r < T) a_out[((size_t)b * T + t0 + r) * C + c] = v;
      }
    }
  }
  __syncthreads();

  // stage 2: 1x1 conv + bias (+ dropout) + residual into the output stream
  auto relu_h = [&](int r, int k) { return h[r * ldh + k]; };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, relu_h, w1, C, C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + fk::pass_row<BM>(i);
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        float v = 0.f;
        if (t < L) {
          float o = acc[i][j] + __ldg(b1 + c);
          if (drop.seed != nullptr) o *= drop.keep(b, T, C, t, c, seed);
          v = o + __ldg(xb + (size_t)t * C + c);
        }
        yb[(size_t)t * C + c] = v;
      }
    }
  }

  const int rows = min(BM, T - t0);
  if (use_ln) {
    __syncthreads();
    const int valid = max(0, min(rows, L - t0));
    fk::layer_norm_rows(yb + (size_t)t0 * C, rows, valid, C, gamma, beta, eps);
  }
  if (ow == nullptr) return;

  // stage 3 (last layer): out projection of the finished stream tile.  The
  // tile was written by this block, so it is read with coherent loads.
  __syncthreads();
  auto stream = [&](int r, int k) { return r < rows ? yb[(size_t)(t0 + r) * C + k] : 0.f; };
  float* lb = logits + (size_t)b * T * O;
  for (int n0 = 0; n0 < O; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, stream, ow, O, C, n0, O, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + fk::pass_col(j);
        if (o < O) lb[(size_t)(t0 + r) * O + o] = acc[i][j] + __ldg(ob + o);
      }
    }
  }
}

// The scaled keep mask of one layer, (B, T, C): replayed for the layer's backward.
__global__ void dropout_mask_kernel(Dropout drop, float* __restrict__ out, int B, int T, int C) {
  const uint32_t seed = (uint32_t)drop.seed[0];
  const long long n = (long long)B * T * C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % C);
    const long long bt = e / C;
    const int t = (int)(bt % T);
    const int b = (int)(bt / T);
    out[e] = drop.keep(b, T, C, t, c, seed);
  }
}

// Per-block column sums, written by bwd_dc: part_c[blk][4][C] = (db1, dbd,
// dgamma, dbeta) and part_o[blk][O] = dob.
__global__ void __launch_bounds__(fk::kThreads)
mstcn_bwd_dc_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ g, const float* __restrict__ glg,
                    const int* __restrict__ lengths, const float* __restrict__ w1,
                    const float* __restrict__ w1t, const float* __restrict__ b1,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ owt, const float* __restrict__ keepm,
                    float* __restrict__ dc,
                    float* __restrict__ dz_out, float* __restrict__ dh_out,
                    float* __restrict__ y_out, float* __restrict__ part_c,
                    float* __restrict__ part_o, int T, int C, int O, int use_ln, float eps) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  const int ld = C + 4;
  float* S1 = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);
  float* S2 = S1 + BM * ld;
  float* rstd = S2 + BM * ld;  // (BM,)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const int L = min(lengths[b], T);
  const int rows = min(BM, T - t0);
  const int blk = b * gridDim.x + blockIdx.x;
  const size_t base = ((size_t)b * T + t0) * C;
  const bool last = glg != nullptr;
  const int lane = threadIdx.x & 31;
  float acc[RM][8];

  auto keep = [&](int r, int c) {
    return keepm != nullptr && r < rows ? __ldg(keepm + base + (size_t)r * C + c) : 1.f;
  };

  // 1. z = x + drop(h @ W1 + b1) (valid rows), then xhat in place if use_ln
  if (use_ln || last) {
    auto h_elem = [&](int r, int k) { return r < rows ? __ldg(a + base + (size_t)r * C + k) : 0.f; };
    for (int n0 = 0; n0 < C; n0 += fk::kBN) {
      fk::gemm_pass<BM>(acc, h_elem, w1, C, C, n0, C, s);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = fk::pass_row<BM>(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + fk::pass_col(j);
          if (c >= C) continue;
          float v = 0.f;
          if (t0 + r < L)
            v = (acc[i][j] + __ldg(b1 + c)) * keep(r, c) + __ldg(x + base + (size_t)r * C + c);
          S1[r * ld + c] = v;
        }
      }
    }
    __syncthreads();
    if (use_ln) {
      for (int r = threadIdx.x >> 5; r < BM; r += fk::kWarps) {
        float* row = S1 + r * ld;
        float sm = 0.f;
        for (int c = lane; c < C; c += 32) sm += row[c];
        const float mean = fk::warp_sum(sm) / C;
        float v = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float dd = row[c] - mean;
          v += dd * dd;
        }
        const float inv = rsqrtf(fk::warp_sum(v) / C + eps);
        for (int c = lane; c < C; c += 32) row[c] = (row[c] - mean) * inv;
        if (lane == 0) rstd[r] = inv;
      }
      __syncthreads();
    }
  }

  // 2. the cotangent g of the (write-masked) layer output into S2
  if (last) {
    // y as the forward's out projection read it, for dWo; g = (g_lg @ Wo^T) * valid
    for (int e = threadIdx.x; e < rows * C; e += fk::kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      float v = 0.f;
      if (t0 + r < L) v = use_ln ? S1[r * ld + c] * __ldg(gamma + c) + __ldg(beta + c) : S1[r * ld + c];
      y_out[base + e] = v;
    }
    const float* glb = glg + ((size_t)b * T + t0) * O;
    auto glg_elem = [&](int r, int k) { return r < rows ? __ldg(glb + (size_t)r * O + k) : 0.f; };
    for (int n0 = 0; n0 < C; n0 += fk::kBN) {
      fk::gemm_pass<BM>(acc, glg_elem, owt, C, O, n0, C, s);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = fk::pass_row<BM>(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + fk::pass_col(j);
          if (c < C) S2[r * ld + c] = t0 + r < L ? acc[i][j] : 0.f;
        }
      }
    }
    fk::block_colsum(glb, O, rows, O, part_o + (size_t)blk * O);
  } else {
    for (int e = threadIdx.x; e < BM * C; e += fk::kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      S2[r * ld + c] = t0 + r < L ? g[base + e] : 0.f;
    }
  }
  __syncthreads();

  // 3. LayerNorm backward: dgamma, dbeta column sums, then dz in place
  float* pc = part_c + (size_t)blk * 4 * C;
  if (use_ln) {
    for (int c = threadIdx.x; c < C; c += fk::kThreads) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < BM; ++r) {
        sg += S2[r * ld + c] * S1[r * ld + c];
        sb += S2[r * ld + c];
      }
      pc[2 * C + c] = sg;
      pc[3 * C + c] = sb;
    }
    __syncthreads();
    for (int r = threadIdx.x >> 5; r < BM; r += fk::kWarps) {
      float* gr = S2 + r * ld;
      const float* xr = S1 + r * ld;
      float m1 = 0.f, m2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float gg = gr[c] * __ldg(gamma + c);
        m1 += gg;
        m2 += gg * xr[c];
      }
      m1 = fk::warp_sum(m1) / C;
      m2 = fk::warp_sum(m2) / C;
      const float inv = rstd[r];
      for (int c = lane; c < C; c += 32)
        gr[c] = (gr[c] * __ldg(gamma + c) - m1 - xr[c] * m2) * inv;
    }
    __syncthreads();
  } else {
    for (int c = threadIdx.x; c < C; c += fk::kThreads) pc[2 * C + c] = pc[3 * C + c] = 0.f;
  }

  // 4. dz out (the residual's cotangent), dh = dz * keep in place, db1
  for (int e = threadIdx.x; e < BM * C; e += fk::kThreads) {
    const int r = e / C;
    const int c = e - r * C;
    const float dzv = S2[r * ld + c];
    if (r < rows && dz_out != nullptr) dz_out[base + e] = dzv;
    const float dhv = dzv * keep(r, c);
    S2[r * ld + c] = dhv;
    if (r < rows) dh_out[base + e] = dhv;
  }
  __syncthreads();
  fk::block_colsum(S2, ld, rows, C, pc);

  // 5. dc = (dh @ W1^T) * (h > 0), dbd
  auto dh_elem = [&](int r, int k) { return S2[r * ld + k]; };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, dh_elem, w1t, C, C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BM>(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        float v = 0.f;
        if (r < rows && __ldg(a + base + (size_t)r * C + c) > 0.f) v = acc[i][j];
        S1[r * ld + c] = v;
        if (r < rows) dc[base + (size_t)r * C + c] = v;
      }
    }
  }
  __syncthreads();
  fk::block_colsum(S1, ld, rows, C, pc + C);
}

__global__ void __launch_bounds__(fk::kThreads)
mstcn_bwd_dx_kernel(const float* __restrict__ dc, const float* __restrict__ gsrc,
                    const int* __restrict__ lengths, const float* __restrict__ wdt,
                    float* __restrict__ dx, int T, int C, int dil) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const int L = min(lengths[b], T);
  const float* dcb = dc + (size_t)b * T * C;
  float acc[RM][8];

  // tap k of the forward read x[t + (k-1)d]: its transpose reads dc[s - (k-1)d]
  auto taps = [&](int r, int k) {
    const int tap = k / C;
    const int t = t0 + r + (1 - tap) * dil;
    return (t >= 0 && t < L) ? __ldg(dcb + (size_t)t * C + (k - tap * C)) : 0.f;
  };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BM>(acc, taps, wdt, C, 3 * C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + fk::pass_row<BM>(i);
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        const size_t e = ((size_t)b * T + t) * C + c;
        dx[e] = t < L ? acc[i][j] + __ldg(gsrc + e) : 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int fk_mstcn_layer(const float* x, float* y, const int* lengths, const float* wd,
                              const float* bd, const float* w1, const float* b1,
                              const float* gamma, const float* beta, const float* ow,
                              const float* ob, float* logits, float* a_out, const int* seed,
                              int layer, unsigned thresh, float scale, int B, int T, int C,
                              int O, int dil, int use_ln, float eps, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>) + (size_t)BM * (C + 4) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)mstcn_layer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  Dropout drop{seed, layer, thresh, scale};
  mstcn_layer_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, y, lengths, wd, bd, w1, b1, gamma, beta, ow, ob, logits, a_out, drop, T, C, O, dil,
      use_ln, eps);
  return (int)cudaGetLastError();
}

extern "C" int fk_mstcn_dropout_mask(const int* seed, int layer, unsigned thresh, float scale,
                                     float* out, int B, int T, int C, void* stream) {
  const long long n = (long long)B * T * C;
  const int blocks = (int)min((n + 255) / 256, 8192LL);
  Dropout drop{seed, layer, thresh, scale};
  dropout_mask_kernel<<<blocks > 0 ? blocks : 1, 256, 0, (cudaStream_t)stream>>>(drop, out, B,
                                                                                 T, C);
  return (int)cudaGetLastError();
}

static size_t bwd_dc_smem(int C) {
  return sizeof(fk::GemmSmem<BM>) + (size_t)(2 * BM * (C + 4) + BM) * sizeof(float);
}

extern "C" int fk_mstcn_bwd_dc(const float* x, const float* a, const float* g, const float* glg,
                               const int* lengths, const float* w1, const float* w1t,
                               const float* b1, const float* gamma, const float* beta,
                               const float* owt, const float* keep, float* dc, float* dz,
                               float* dh, float* y_out,
                               float* part_c, float* part_o, int B, int T, int C, int O,
                               int use_ln, float eps, void* stream) {
  const size_t smem = bwd_dc_smem(C);
  cudaError_t err = fk::set_smem((const void*)mstcn_bwd_dc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  mstcn_bwd_dc_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, a, g, glg, lengths, w1, w1t, b1, gamma, beta, owt, keep, dc, dz, dh, y_out, part_c,
      part_o, T, C, O, use_ln, eps);
  return (int)cudaGetLastError();
}

extern "C" int fk_mstcn_bwd_dx(const float* dc, const float* gsrc, const int* lengths,
                               const float* wdt, float* dx, int B, int T, int C, int dil,
                               void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>);
  cudaError_t err = fk::set_smem((const void*)mstcn_bwd_dx_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  mstcn_bwd_dx_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(dc, gsrc, lengths, wdt,
                                                                          dx, T, C, dil);
  return (int)cudaGetLastError();
}
