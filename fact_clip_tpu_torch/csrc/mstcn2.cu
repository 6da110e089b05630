// K6: one layer of the fused MS-TCN++ tower (two dilations per layer),
// forward (a training form and a serving form) and backward.
//
// Forward: replaces fact_clip_tpu/ops/pallas/dilated_conv.py::_stack2_layer
// (_stack2_kernel).  The training form, for a tile of 32 frames of one video
//   c1 = sum_k x[t + (k-1)d1] @ K1[k] + b1,  c2 = sum_k x[t + (k-1)d2] @ K2[k] + b2
//   h  = relu(c1 @ Wt + c2 @ Wb + bf)           (Wf = [Wt; Wb], (2C, C): one GEMM
//                                                over K = 2C of the tile [c1 | c2])
//   y[t] = (drop(h) + x[t]) for t < len[b], 0 for t >= len[b]
// and, on the tower's last layer, logits[t] = y[t] @ Wo + bo (padded frames
// carry the bias row).  Taps at or past len[b], or before frame 0, read as
// zeros (the TPU kernel's `where` on its halo), so the layer needs no
// pre-masked input.  It also writes [c1 | c2] (B, T, 2C) and h = relu(.)
// before dropout (B, T, C) for the backward.  The serving form, which saves
// nothing, folds the fuse into the taps: with W6 = [K1[k] Wt; K2[k] Wb]
// (6C, C, ops/dilated_conv.py::mstcn2_fold, cached by the module) and
// bias = b1 Wt + b2 Wb + bf, h = relu(taps(x) @ W6 + bias) is one GEMM over
// K = 6C on 64-frame tiles: 12 C^2 FMAs a frame instead of 16 C^2, in
// another summation order; it has no dropout (a forward with dropout runs
// the training form, its saves left out).  A block whose tile lies wholly
// past len[b] runs no GEMM: it writes zeros (its saves too, which the
// backward multiplies by a zero cotangent) and the bias row of the logits;
// the backward's blocks past the video write zeros.
//
// Dropout: fk::dropout_bits(seed, layer, (b*T + t)*C + c) < thresh, scaled by
// 1/(1-rate), on h (every layer but the tower's last, which its caller runs at
// rate 0, as layers.py:480-482 does).  The backward has the mask kernel
// (dropout.cu) regenerate it; it is never stored past the layer's backward.
//
// Backward: replaces _stack2_bwd_layer (_stack2_bwd_dc_kernel,
// _stack2_bwd_dx_kernel), from the saved input stream x, [c1 | c2], h and the
// cotangent g of the layer's output (on the last layer: of the logits):
//   bwd_dc: per 64-frame tile, on the last layer y = (h*keep + x)*valid (for
//           dWo) and g = (g_logits @ Wo^T)*valid; ds = g * keep * (h > 0);
//           [dc1 | dc2] = ds @ Wf^T.  It writes ds, dc1, dc2 (and dz = g and
//           y on the last layer) and per-block column sums for dbf, db1, db2
//           (and dob).
//   bwd_dx: dx[s] = sum_k dc1[s + (1-k)d1] K1[k]^T + dc2[s + (1-k)d2] K2[k]^T
//           + g[s], zero at s >= len[b]: one GEMM over K = 6C whose taps read
//           dc1 and dc2 straight from global memory, since d reaches 512.
// The weight gradients dK1, dK2 (x^T dc, three shifts each), dWf = [c1|c2]^T ds
// and dWo = y^T g_logits are sums over B*T rows: grad.cu's fk_atb writes
// per-block partial products and fk_reduce sums them (and the column sums) in
// a fixed order: no float atomics, the same result on every run.
//
// Bound on the H100: f32 FMA on the CUDA cores.  A training layer forward is
// 2 * B*T * 8*C*C FLOPs (two conv3 at 6C^2 a frame, the fuse at 4C^2):
// 68.7 GFLOP at B=4, T=4096, C=512, ~1.0 ms at 67 TFLOP/s, against 2*B*T*C*4
// bytes of stream traffic (~500 FLOP per byte); the serving form does 3/4 of
// that, the backward about twice.  Design: K1's layout (csrc/mstcn.cu)
// cannot be copied, because the fuse GEMM needs both convolutions' outputs
// of a tile at once: at C=512 two (64, C+4) tiles are 264 KB, above the
// 227 KB a block may hold.  The training forward therefore takes 32 frames
// a block: [c1 | c2] as one (32, 2C+4) tile (132 KB) beside the GEMM staging
// (37 KB), 169 KB in all, one block per SM.  The serving form needs no such
// tile.  The backward needs one (64, C+4) tile (ds) and runs 64 frames a
// block (174 KB); c1 and c2 come from the training forward's saves.
#include "common.cuh"

namespace {

constexpr int BMF = 32;  // frames per forward block
constexpr int BMB = 64;  // frames per backward block

// One block per SM (its shared memory leaves no room for a second): said
// here, it frees ptxas from a 128-register budget under which this kernel
// spills.
__global__ void __launch_bounds__(fk::kThreads, 1)
mstcn2_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const int* __restrict__ lengths,
                    const float* __restrict__ k1, const float* __restrict__ b1,
                    const float* __restrict__ k2, const float* __restrict__ b2,
                    const float* __restrict__ wf, const float* __restrict__ bf,
                    const float* __restrict__ ow, const float* __restrict__ ob,
                    float* __restrict__ logits, float* __restrict__ c_out,
                    float* __restrict__ h_out, fk::Dropout drop, int T, int C, int O, int d1,
                    int d2) {
  constexpr int RM = BMF / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BMF>& s = *reinterpret_cast<fk::GemmSmem<BMF>*>(smem_raw);
  float* cs = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BMF>) / sizeof(float);
  const int ldc = 2 * C + 4;  // [c1 | c2] of the tile; +4 keeps rows 16-byte aligned

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BMF;
  const int L = min(lengths[b], T);
  const float* xb = x + (size_t)b * T * C;
  float* yb = y + (size_t)b * T * C;
  if (t0 >= L) {  // a tile past the video: zeros, and the bias row on the last layer
    const int rows = min(BMF, T - t0);
    const size_t row0 = (size_t)b * T + t0;
    for (int e = threadIdx.x; e < rows * C; e += fk::kThreads) {
      y[row0 * C + e] = 0.f;
      if (h_out != nullptr) h_out[row0 * C + e] = 0.f;
    }
    if (c_out != nullptr)
      for (int e = threadIdx.x; e < rows * 2 * C; e += fk::kThreads) c_out[row0 * 2 * C + e] = 0.f;
    if (ow != nullptr)
      for (int e = threadIdx.x; e < rows * O; e += fk::kThreads)
        logits[row0 * O + e] = __ldg(ob + e % O);
    return;
  }
  const uint32_t seed = drop.load_seed();
  float acc[RM][8];

  // stage 1: the two dilated convs, each one GEMM over K = 3C (tap-major rows)
  for (int half = 0; half < 2; ++half) {
    const int dil = half ? d2 : d1;
    const float* wk = half ? k2 : k1;
    const float* bk = half ? b2 : b1;
    auto taps = [&](int r, int k) {
      const int tap = k / C;
      const int t = t0 + r + (tap - 1) * dil;
      return (t >= 0 && t < L) ? __ldg(xb + (size_t)t * C + (k - tap * C)) : 0.f;
    };
    for (int n0 = 0; n0 < C; n0 += fk::kBN) {
      fk::gemm_pass<BMF>(acc, taps, wk, C, 3 * C, n0, C, s);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = fk::pass_row<BMF>(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + fk::pass_col(j);
          if (c >= C) continue;
          const float v = acc[i][j] + __ldg(bk + c);
          cs[r * ldc + half * C + c] = v;
          if (c_out != nullptr && t0 + r < T)
            c_out[((size_t)b * T + t0 + r) * 2 * C + half * C + c] = v;
        }
      }
    }
  }
  __syncthreads();

  // stage 2: the fuse over [c1 | c2], ReLU (+ dropout), residual, write mask
  auto c_elem = [&](int r, int k) { return cs[r * ldc + k]; };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BMF>(acc, c_elem, wf, C, 2 * C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + fk::pass_row<BMF>(i);
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        const float hv = fmaxf(acc[i][j] + __ldg(bf + c), 0.f);
        if (h_out != nullptr) h_out[((size_t)b * T + t) * C + c] = hv;
        float v = 0.f;
        if (t < L) {
          float o = hv;
          if (drop.seed != nullptr)
            o *= drop.keep(((uint32_t)b * (uint32_t)T + (uint32_t)t) * (uint32_t)C + (uint32_t)c,
                           seed);
          v = o + __ldg(xb + (size_t)t * C + c);
        }
        yb[(size_t)t * C + c] = v;
      }
    }
  }
  if (ow == nullptr) return;

  // stage 3 (last layer): out projection of the finished stream tile.  The
  // tile was written by this block, so it is read with coherent loads.
  __syncthreads();
  const int rows = min(BMF, T - t0);
  auto stream = [&](int r, int k) { return r < rows ? yb[(size_t)(t0 + r) * C + k] : 0.f; };
  float* lb = logits + (size_t)b * T * O;
  for (int n0 = 0; n0 < O; n0 += fk::kBN) {
    fk::gemm_pass<BMF>(acc, stream, ow, O, C, n0, O, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BMF>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + fk::pass_col(j);
        if (o < O) lb[(size_t)(t0 + r) * O + o] = acc[i][j] + __ldg(ob + o);
      }
    }
  }
}

// The serving form of the layer (no saves): the fuse folded into the taps,
// W6 = [K1[0] Wt; K1[1] Wt; K1[2] Wt; K2[0] Wb; K2[1] Wb; K2[2] Wb] (6C, C)
// and bias = b1 Wt + b2 Wb + bf, so that h = relu(taps(x) @ W6 + bias) is one
// GEMM over K = 6C: 12 C^2 FMAs a frame instead of 16 C^2, and no [c1 | c2]
// tile, so 64 frames a block.  No dropout; the epilogue is otherwise the
// training form's, and so is the out projection.
__global__ void __launch_bounds__(fk::kThreads, 1)
mstcn2_folded_kernel(const float* __restrict__ x, float* __restrict__ y,
                     const int* __restrict__ lengths, const float* __restrict__ w6,
                     const float* __restrict__ bias, const float* __restrict__ ow,
                     const float* __restrict__ ob, float* __restrict__ logits, int T, int C,
                     int O, int d1, int d2) {
  constexpr int RM = BMB / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BMB>& s = *reinterpret_cast<fk::GemmSmem<BMB>*>(smem_raw);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BMB;
  const int L = min(lengths[b], T);
  const int rows = min(BMB, T - t0);
  const float* xb = x + (size_t)b * T * C;
  float* yb = y + (size_t)b * T * C;
  float* lb = logits + (size_t)b * T * O;
  if (t0 >= L) {  // a tile past the video: zeros, and the bias row on the last layer
    for (int e = threadIdx.x; e < rows * C; e += fk::kThreads) yb[(size_t)t0 * C + e] = 0.f;
    if (ow != nullptr)
      for (int e = threadIdx.x; e < rows * O; e += fk::kThreads)
        lb[(size_t)t0 * O + e] = __ldg(ob + e % O);
    return;
  }
  float acc[RM][8];

  // taps 0-2 of dilation d1, 3-5 of d2: tap k reads x[t + (k-1)d]
  auto taps = [&](int r, int k) {
    const int tap = k / C;
    const bool second = tap >= 3;
    const int t = t0 + r + ((second ? tap - 3 : tap) - 1) * (second ? d2 : d1);
    return (t >= 0 && t < L) ? __ldg(xb + (size_t)t * C + (k - tap * C)) : 0.f;
  };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BMB>(acc, taps, w6, C, 6 * C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + fk::pass_row<BMB>(i);
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= C) continue;
        yb[(size_t)t * C + c] =
            t < L ? fmaxf(acc[i][j] + __ldg(bias + c), 0.f) + __ldg(xb + (size_t)t * C + c) : 0.f;
      }
    }
  }
  if (ow == nullptr) return;

  // the last layer: out projection of the finished stream tile, written by
  // this block and read back with coherent loads
  __syncthreads();
  auto stream = [&](int r, int k) { return r < rows ? yb[(size_t)(t0 + r) * C + k] : 0.f; };
  for (int n0 = 0; n0 < O; n0 += fk::kBN) {
    fk::gemm_pass<BMB>(acc, stream, ow, O, C, n0, O, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BMB>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + fk::pass_col(j);
        if (o < O) lb[(size_t)(t0 + r) * O + o] = acc[i][j] + __ldg(ob + o);
      }
    }
  }
}

// Per-block column sums, written by bwd_dc: part[blk][3][C] = (dbf, db1, db2)
// and part_o[blk][O] = dob.
__global__ void __launch_bounds__(fk::kThreads)
mstcn2_bwd_dc_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ g, const float* __restrict__ glg,
                     const int* __restrict__ lengths, const float* __restrict__ wft,
                     const float* __restrict__ owt, const float* __restrict__ keepm,
                     float* __restrict__ ds_out, float* __restrict__ dc1,
                     float* __restrict__ dc2, float* __restrict__ dz_out,
                     float* __restrict__ y_out, float* __restrict__ part,
                     float* __restrict__ part_o, int T, int C, int O) {
  constexpr int RM = BMB / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BMB>& s = *reinterpret_cast<fk::GemmSmem<BMB>*>(smem_raw);
  const int ld = C + 4;
  float* G = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BMB>) / sizeof(float);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BMB;
  const int L = min(lengths[b], T);
  const int rows = min(BMB, T - t0);
  const int blk = b * gridDim.x + blockIdx.x;
  const size_t base = ((size_t)b * T + t0) * C;
  const bool last = glg != nullptr;
  float acc[RM][8];

  if (t0 >= L) {  // past the video every cotangent is zero; dob still sums g_logits
    for (int e = threadIdx.x; e < rows * C; e += fk::kThreads) {
      ds_out[base + e] = 0.f;
      dc1[base + e] = 0.f;
      dc2[base + e] = 0.f;
      if (last) dz_out[base + e] = y_out[base + e] = 0.f;
    }
    for (int c = threadIdx.x; c < 3 * C; c += fk::kThreads) part[(size_t)blk * 3 * C + c] = 0.f;
    if (last)
      fk::block_colsum(glg + ((size_t)b * T + t0) * O, O, rows, O, part_o + (size_t)blk * O);
    return;
  }
  auto keep = [&](int r, int c) {
    return keepm != nullptr && r < rows ? __ldg(keepm + base + (size_t)r * C + c) : 1.f;
  };

  // 1. g, the cotangent of the layer's write-masked output, into G
  if (last) {
    // y as the forward's out projection read it, for dWo
    for (int e = threadIdx.x; e < rows * C; e += fk::kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      float v = 0.f;
      if (t0 + r < L) v = __ldg(h + base + e) * keep(r, c) + __ldg(x + base + e);
      y_out[base + e] = v;
    }
    const float* glb = glg + ((size_t)b * T + t0) * O;
    auto glg_elem = [&](int r, int k) { return r < rows ? __ldg(glb + (size_t)r * O + k) : 0.f; };
    for (int n0 = 0; n0 < C; n0 += fk::kBN) {
      fk::gemm_pass<BMB>(acc, glg_elem, owt, C, O, n0, C, s);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = fk::pass_row<BMB>(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + fk::pass_col(j);
          if (c < C) G[r * ld + c] = t0 + r < L ? acc[i][j] : 0.f;
        }
      }
    }
    fk::block_colsum(glb, O, rows, O, part_o + (size_t)blk * O);
  } else {
    for (int e = threadIdx.x; e < BMB * C; e += fk::kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      G[r * ld + c] = t0 + r < L ? __ldg(g + base + e) : 0.f;
    }
  }
  __syncthreads();

  // 2. dz out (the residual's cotangent, last layer), ds = g * keep * (h > 0)
  //    in place, dbf
  for (int e = threadIdx.x; e < BMB * C; e += fk::kThreads) {
    const int r = e / C;
    const int c = e - r * C;
    const float gv = G[r * ld + c];
    if (r < rows && dz_out != nullptr) dz_out[base + e] = gv;
    float dsv = 0.f;
    if (r < rows && __ldg(h + base + e) > 0.f) dsv = gv * keep(r, c);
    G[r * ld + c] = dsv;
    if (r < rows) ds_out[base + e] = dsv;
  }
  __syncthreads();
  float* pc = part + (size_t)blk * 3 * C;
  fk::block_colsum(G, ld, rows, C, pc);

  // 3. [dc1 | dc2] = ds @ Wf^T, N = 2C
  auto ds_elem = [&](int r, int k) { return G[r * ld + k]; };
  for (int n0 = 0; n0 < 2 * C; n0 += fk::kBN) {
    fk::gemm_pass<BMB>(acc, ds_elem, wft, 2 * C, C, n0, 2 * C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BMB>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c >= 2 * C) continue;
        if (c < C)
          dc1[base + (size_t)r * C + c] = acc[i][j];
        else
          dc2[base + (size_t)r * C + (c - C)] = acc[i][j];
      }
    }
  }
  __syncthreads();  // dc1, dc2 rows were written by this block: plain loads below
  fk::block_colsum(dc1 + base, C, rows, C, pc + C);
  fk::block_colsum(dc2 + base, C, rows, C, pc + 2 * C);
}

__global__ void __launch_bounds__(fk::kThreads)
mstcn2_bwd_dx_kernel(const float* __restrict__ dc1, const float* __restrict__ dc2,
                     const float* __restrict__ gsrc, const int* __restrict__ lengths,
                     const float* __restrict__ wdt, float* __restrict__ dx, int T, int C,
                     int d1, int d2) {
  constexpr int RM = BMB / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BMB>& s = *reinterpret_cast<fk::GemmSmem<BMB>*>(smem_raw);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BMB;
  const int L = min(lengths[b], T);
  const float* dc1b = dc1 + (size_t)b * T * C;
  const float* dc2b = dc2 + (size_t)b * T * C;
  if (t0 >= L) {  // a tile past the video
    const int rows = min(BMB, T - t0);
    float* dxt = dx + ((size_t)b * T + t0) * C;
    for (int e = threadIdx.x; e < rows * C; e += fk::kThreads) dxt[e] = 0.f;
    return;
  }
  float acc[RM][8];

  // taps 0-2 transpose conv 1's, taps 3-5 conv 2's: tap k of the forward read
  // x[t + (k-1)d], so its transpose reads dc[s - (k-1)d]
  auto taps = [&](int r, int k) {
    const int tap = k / C;
    const bool second = tap >= 3;
    const int kk = second ? tap - 3 : tap;
    const int t = t0 + r + (1 - kk) * (second ? d2 : d1);
    const float* src = second ? dc2b : dc1b;
    return (t >= 0 && t < L) ? __ldg(src + (size_t)t * C + (k - tap * C)) : 0.f;
  };
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::gemm_pass<BMB>(acc, taps, wdt, C, 6 * C, n0, C, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + fk::pass_row<BMB>(i);
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

extern "C" int fk_mstcn2_layer(const float* x, float* y, const int* lengths, const float* k1,
                               const float* b1, const float* k2, const float* b2,
                               const float* wf, const float* bf, const float* ow,
                               const float* ob, float* logits, float* c_out, float* h_out,
                               const int* seed, int layer, unsigned thresh, float scale, int B,
                               int T, int C, int O, int d1, int d2, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BMF>) + (size_t)BMF * (2 * C + 4) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)mstcn2_layer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BMF - 1) / BMF, B);
  fk::Dropout drop{seed, layer, thresh, scale};
  mstcn2_layer_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, y, lengths, k1, b1, k2, b2, wf, bf, ow, ob, logits, c_out, h_out, drop, T, C, O, d1,
      d2);
  return (int)cudaGetLastError();
}

extern "C" int fk_mstcn2_folded(const float* x, float* y, const int* lengths, const float* w6,
                                const float* bias, const float* ow, const float* ob,
                                float* logits, int B, int T, int C, int O, int d1, int d2,
                                void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BMB>);
  cudaError_t err = fk::set_smem((const void*)mstcn2_folded_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BMB - 1) / BMB, B);
  mstcn2_folded_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, y, lengths, w6, bias, ow, ob, logits, T, C, O, d1, d2);
  return (int)cudaGetLastError();
}

extern "C" int fk_mstcn2_bwd_dc(const float* x, const float* h, const float* g, const float* glg,
                                const int* lengths, const float* wft, const float* owt,
                                const float* keep, float* ds, float* dc1, float* dc2, float* dz,
                                float* y_out, float* part, float* part_o, int B, int T, int C,
                                int O, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BMB>) + (size_t)BMB * (C + 4) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)mstcn2_bwd_dc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BMB - 1) / BMB, B);
  mstcn2_bwd_dc_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, h, g, glg, lengths, wft, owt, keep, ds, dc1, dc2, dz, y_out, part, part_o, T, C, O);
  return (int)cudaGetLastError();
}

extern "C" int fk_mstcn2_bwd_dx(const float* dc1, const float* dc2, const float* gsrc,
                                const int* lengths, const float* wdt, float* dx, int B, int T,
                                int C, int d1, int d2, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BMB>);
  cudaError_t err = fk::set_smem((const void*)mstcn2_bwd_dx_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BMB - 1) / BMB, B);
  mstcn2_bwd_dx_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      dc1, dc2, gsrc, lengths, wdt, dx, T, C, d1, d2);
  return (int)cudaGetLastError();
}
