// K8: int8 evaluation.  The int8 MSTCN tower (K8a) and the row quantizer of
// the int8 attention projections (K8b-K8d, whose attention stages live beside
// their f32 twins in x2y_attn.cu and flash_attn.cu).  The integer products
// run on quant.cuh's mma.sync core.
//
// K8a replaces fact_clip_tpu/ops/pallas/quant_conv.py::_stack_layer_q8
// (_stack_kernel_q8, act_scale="tile"), one layer of
//   a   = relu((sum_k q(x[t + (k-1) d]) . qwd[k]) * (s_x * swd) + bd)
//   out = (q(a) . qw1) * (s_a * sw1) + b1 + x[t]   (-> LayerNorm) * mask
// with int8 joint-tap conv weights and one int8 1x1 weight (per output
// channel scales), and two activation scales per video and JAX tile of 512
// frames (``tile`` of ops/quant_conv.py::_stack_layout, not any block of
// this kernel): s_x is the absmax of the layer input over the tile's read
// window [t*tile - halo, t*tile + tile + halo) within [0, T_pad), halo =
// ceil8(d); s_a the max of the ReLU output over the tile's rows, padded
// frames included.  A tile of ReLU output (512 x 256 f32, 512 KB) does not
// fit in a block, so a layer runs in two passes:
//   A: per (64 frames, video): the tile scale s_x from the 8-row group
//      maxima of the layer input (a max over ~200 floats), the three taps
//      quantized while staged and summed in ONE int32 accumulator (the joint
//      weight scale makes them share one dequantization), dequantize, + bd,
//      ReLU, write a (f32), and fold a's max into one word per (video, tile)
//      with atomicMax on the int bits (a >= 0: int order is float order; a
//      max is exact and does not depend on the order).
//   B: per (64 frames, video): quantize a with its tile's s_a while staged,
//      the 1x1 int8 GEMM, dequantize, + b1 + the residual, LayerNorm (two
//      passes, a warp a row, 1 / sqrt correctly rounded: the plain version
//      sums in this order, so both round alike), the write mask, and each
//      8-row group's absmax of the
//      output: the next layer's window maxima (halo and tile are multiples
//      of 8, so a window is a union of groups).
// Layer 0's group maxima come from q8_group_max_kernel over the masked input.
// Every dequantization is written out in JAX's order with explicit roundings
// (nvcc contracts nothing): fma(acc, s_x * swd, bd) and fma(acc, s_a * sw1,
// b1) + x, the product-plus-bias one fused multiply-add as XLA computes it
// (ops/quant_conv.py).
//
// Bound on the H100 (chip_smoke.py::k8a_case), counting the work the function
// needs: the 3-tap product on the rows whose ReLU output feeds a tile's s_a
// (the valid rows and, past a video's end, those within d of it in its last
// tile; further on a = relu(bd)), the 1x1 product and the f32 epilogue on the
// valid rows.  At the flagship's lengths (22,022 valid frames of 8 x 3072,
// C=256) the ten layers' int8 products are 117.2 G operations (0.059 ms at
// 1,979 TOPS) and the epilogue 0.68 GFLOP (0.010 ms at 67 TFLOP/s).  This
// kernel's own traffic is larger: a layer reads its input 4 times (three taps
// and the residual), writes and reads a once and writes its output once, 8 *
// 4 * B*T*C bytes (0.1 GB, 0.03 ms at 3.35 TB/s).  The kernel is neither: a
// simple single-buffered mma.sync pipeline, see PERF.md for its time.
#include <math.h>

#include "quant.cuh"

namespace {

constexpr int TBM = 64;           // frames per block
constexpr int kMaxBlockTiles = 9;  // JAX tiles (multiples of 8 frames) 64 frames can touch

__global__ void __launch_bounds__(fk::kThreads)
q8_group_max_kernel(const float* __restrict__ x, const int* __restrict__ len, float* gmax, int T,
                    int G, int C) {
  const int lane = threadIdx.x & 31;
  const int gi = blockIdx.x * fk::kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (gi >= G) return;
  const int lim = min(len[b], T);
  float m = 0.f;
  for (int r = gi * 8; r < gi * 8 + 8 && r < lim; ++r)
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(__ldg(x + ((size_t)b * T + r) * C + c)));
  m = fk::warp_max(m);
  if (lane == 0) gmax[(size_t)b * G + gi] = m;
}

// Pass A: a = relu(conv3_q8(x) + bd) on rows [r0, r0 + 64) of video b, and
// the per-(video, tile) max of a into smax.
__global__ void __launch_bounds__(fk::kThreads)
q8_tower_a_kernel(const float* __restrict__ x, const int* __restrict__ len,
                  const float* __restrict__ gmax, const int8_t* __restrict__ qwdt,
                  const float* __restrict__ swd, const float* __restrict__ bd, float* a_out,
                  int* smax, int T, int C, int d, int halo, int tile, int n_tiles, int T_pad) {
  extern __shared__ float4 smem_raw[];
  fk::QSmem<TBM>& s = *reinterpret_cast<fk::QSmem<TBM>*>(smem_raw);
  __shared__ float t_scale[kMaxBlockTiles];
  __shared__ int t_max[kMaxBlockTiles];
  __shared__ float row_s[TBM];
  __shared__ float row_inv[TBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TBM;
  const int G = T_pad / 8;
  const int lim = min(len[b], T);
  const int t_first = r0 / tile;
  const int nt = min(r0 + TBM - 1, T_pad - 1) / tile - t_first + 1;

  for (int i = tid >> 5; i < nt; i += fk::kWarps) {  // s_x of each tile the block touches
    const int t = t_first + i;
    const int lo = max(0, t * tile - halo) / 8;
    const int hi = min(T_pad, t * tile + tile + halo) / 8;
    float m = 0.f;
    for (int g = lo + lane; g < hi; g += 32) m = fmaxf(m, gmax[(size_t)b * G + g]);
    m = fk::warp_max(m);
    if (lane == 0) {
      t_scale[i] = fmaxf(m, 1e-12f);
      t_max[i] = 0;
    }
  }
  __syncthreads();
  for (int r = tid; r < TBM; r += fk::kThreads) {
    const float sc = t_scale[min(r0 + r, T_pad - 1) / tile - t_first];
    row_s[r] = sc;
    row_inv[r] = __fdiv_rn(127.f, sc);
  }
  // (q_gemm_pass synchronises before its first staging)

  // A[r][tap * C + c] = q(x[r0 + r + (tap - 1) d][c]); rows outside [0, len) read 0
  auto stage = [&](int8_t (*as)[fk::kQLD], int k0) {
    const int r = tid >> 2;
    const int kk = (tid & 3) * 16;
    const int k = k0 + kk;
    int4 v = make_int4(0, 0, 0, 0);
    if (k < 3 * C) {
      const int tap = k / C;
      const int c = k - tap * C;
      const int src = r0 + r + (tap - 1) * d;
      if (src >= 0 && src < lim) v = fk::quant16(x + ((size_t)b * T + src) * C + c, row_inv[r]);
    }
    *reinterpret_cast<int4*>(&as[r][kk]) = v;
  };

  int acc[TBM / 16][4][4];
  float rmax[TBM / 16][2];
#pragma unroll
  for (int mt = 0; mt < TBM / 16; ++mt) rmax[mt][0] = rmax[mt][1] = 0.f;
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::q_gemm_pass<TBM>(acc, stage, qwdt, 3 * C, n0, C, s);
#pragma unroll
    for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
      for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = fk::q_row(mt, i);
          const int c = n0 + fk::q_col(nt2, i);
          const int row = r0 + r;
          if (c >= C || row >= T_pad) continue;
          const float v = __fmaf_rn(__int2float_rn(acc[mt][nt2][i]),
                                    __fmul_rn(row_s[r], __ldg(swd + c)), __ldg(bd + c));
          const float a = v > 0.f ? v : 0.f;  // relu
          a_out[((size_t)b * T_pad + row) * C + c] = a;
          rmax[mt][i >> 1] = fmaxf(rmax[mt][i >> 1], a);
        }
  }
#pragma unroll
  for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + fk::q_row(mt, 2 * h);
      if (row < T_pad) atomicMax(&t_max[row / tile - t_first], __float_as_int(rmax[mt][h]));
    }
  __syncthreads();
  if (tid < nt && t_max[tid] > 0) atomicMax(smax + (size_t)b * n_tiles + t_first + tid, t_max[tid]);
}

// Pass B: out = (q(a) . qw1) * (s_a * sw1) + b1 + x (-> LN) * mask on rows
// [r0, r0 + 64) of video b, and the output's 8-row group maxima.
__global__ void __launch_bounds__(fk::kThreads)
q8_tower_b_kernel(const float* __restrict__ x, const int* __restrict__ len,
                  const float* __restrict__ a_in, const int* __restrict__ smax,
                  const int8_t* __restrict__ qw1t, const float* __restrict__ sw1,
                  const float* __restrict__ b1, const float* __restrict__ gamma,
                  const float* __restrict__ beta, int use_ln, float eps, float* y,
                  float* gmax_out, int T, int C, int tile, int n_tiles, int T_pad) {
  extern __shared__ float4 smem_raw[];
  fk::QSmem<TBM>& s = *reinterpret_cast<fk::QSmem<TBM>*>(smem_raw);
  float* o_s = reinterpret_cast<float*>(smem_raw) + sizeof(fk::QSmem<TBM>) / sizeof(float);
  const int ldo = C + 1;
  __shared__ float row_s[TBM];
  __shared__ float row_inv[TBM];
  __shared__ int g_max[TBM / 8];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TBM;
  const int G = T_pad / 8;
  const int lim = min(len[b], T);
  for (int r = tid; r < TBM; r += fk::kThreads) {
    const int t = min(r0 + r, T_pad - 1) / tile;
    const float sc = fmaxf(__int_as_float(smax[(size_t)b * n_tiles + t]), 1e-12f);
    row_s[r] = sc;
    row_inv[r] = __fdiv_rn(127.f, sc);
  }
  if (tid < TBM / 8) g_max[tid] = 0;

  auto stage = [&](int8_t (*as)[fk::kQLD], int k0) {
    const int r = tid >> 2;
    const int kk = (tid & 3) * 16;
    const int row = r0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (row < T_pad && k0 + kk < C)
      v = fk::quant16(a_in + ((size_t)b * T_pad + row) * C + k0 + kk, row_inv[r]);
    *reinterpret_cast<int4*>(&as[r][kk]) = v;
  };

  int acc[TBM / 16][4][4];
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    fk::q_gemm_pass<TBM>(acc, stage, qw1t, C, n0, C, s);
#pragma unroll
    for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
      for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = fk::q_row(mt, i);
          const int c = n0 + fk::q_col(nt2, i);
          const int row = r0 + r;
          if (c >= C) continue;
          const float res = row < lim ? __ldg(x + ((size_t)b * T + row) * C + c) : 0.f;
          o_s[r * ldo + c] = __fadd_rn(
              __fmaf_rn(__int2float_rn(acc[mt][nt2][i]), __fmul_rn(row_s[r], __ldg(sw1 + c)),
                        __ldg(b1 + c)),
              res);
        }
  }
  __syncthreads();

  for (int r = tid >> 5; r < TBM; r += fk::kWarps) {  // one warp per row
    const int row = r0 + r;
    if (row >= T_pad) break;
    float* o = o_s + r * ldo;
    float m = 0.f;
    if (row < lim) {
      if (use_ln) {
        float sum = 0.f;
        for (int c = lane; c < C; c += 32) sum += o[c];
        const float mean = __fdiv_rn(fk::warp_sum(sum), (float)C);
        float var = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float dv = __fsub_rn(o[c], mean);
          var = __fadd_rn(var, __fmul_rn(dv, dv));
        }
        const float inv =
            __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(fk::warp_sum(var), (float)C), eps)));
        for (int c = lane; c < C; c += 32)
          o[c] = __fmaf_rn(__fmul_rn(__fsub_rn(o[c], mean), inv), __ldg(gamma + c),
                           __ldg(beta + c));
      }
      for (int c = lane; c < C; c += 32) {
        y[((size_t)b * T + row) * C + c] = o[c];
        m = fmaxf(m, fabsf(o[c]));
      }
    } else if (row < T) {
      for (int c = lane; c < C; c += 32) y[((size_t)b * T + row) * C + c] = 0.f;
    }
    m = fk::warp_max(m);
    if (lane == 0) atomicMax(&g_max[r >> 3], __float_as_int(m));
  }
  __syncthreads();
  if (tid < TBM / 8 && r0 / 8 + tid < G) gmax_out[(size_t)b * G + r0 / 8 + tid] = __int_as_float(g_max[tid]);
}

// q[row] = round((x + pos)[row] * 127 / s[row]), s[row] = max(absmax, 1e-12),
// one warp per row of x (B x N rows of C); pos (on the leading P channels,
// batch stride pos_bstride) may be null.
__global__ void __launch_bounds__(fk::kThreads)
q8_rows_kernel(const float* __restrict__ x, const float* __restrict__ pos, long long pos_bstride,
               int P, int N, int C, int rows, int8_t* q, float* s) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * fk::kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int b = row / N;
  const float* xr = x + (size_t)row * C;
  const float* pr = pos ? pos + (size_t)b * pos_bstride + (size_t)(row - b * N) * P : nullptr;
  auto val = [&](int c) {
    const float v = __ldg(xr + c);
    return pr != nullptr && c < P ? __fadd_rn(v, __ldg(pr + c)) : v;
  };
  float m = 0.f;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(val(c)));
  const float sc = fmaxf(fk::warp_max(m), 1e-12f);
  const float inv = __fdiv_rn(127.f, sc);
  for (int c = lane; c < C; c += 32) q[(size_t)row * C + c] = (int8_t)fk::quant_s8(val(c), inv);
  if (lane == 0) s[row] = sc;
}

}  // namespace

extern "C" int fk_q8_group_max(const float* x, const int* len, float* gmax, int B, int T, int T_pad,
                               int C, void* stream) {
  const int G = T_pad / 8;
  q8_group_max_kernel<<<dim3((G + fk::kWarps - 1) / fk::kWarps, B), fk::kThreads, 0,
                        (cudaStream_t)stream>>>(x, len, gmax, T, G, C);
  return (int)cudaGetLastError();
}

// One int8 tower layer: pass A then pass B.  smax (B, n_tiles) int32 zeros.
extern "C" int fk_q8_tower_layer(const float* x, const int* len, const float* gmax_in,
                                 const int8_t* qwdt, const float* swd, const float* bd, float* a,
                                 int* smax, const int8_t* qw1t, const float* sw1, const float* b1,
                                 const float* gamma, const float* beta, float* y, float* gmax_out,
                                 int B, int T, int C, int d, int halo, int tile, int n_tiles,
                                 int T_pad, int use_ln, float eps, void* stream) {
  if (C % 32 != 0 || tile % 8 != 0 || T_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T_pad + TBM - 1) / TBM, B);
  const size_t smem_a = sizeof(fk::QSmem<TBM>);
  cudaError_t err = fk::set_smem((const void*)q8_tower_a_kernel, smem_a);
  if (err != cudaSuccess) return (int)err;
  q8_tower_a_kernel<<<grid, fk::kThreads, smem_a, (cudaStream_t)stream>>>(
      x, len, gmax_in, qwdt, swd, bd, a, smax, T, C, d, halo, tile, n_tiles, T_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_b = sizeof(fk::QSmem<TBM>) + (size_t)TBM * (C + 1) * sizeof(float);
  err = fk::set_smem((const void*)q8_tower_b_kernel, smem_b);
  if (err != cudaSuccess) return (int)err;
  q8_tower_b_kernel<<<grid, fk::kThreads, smem_b, (cudaStream_t)stream>>>(
      x, len, a, smax, qw1t, sw1, b1, gamma, beta, use_ln, eps, y, gmax_out, T, C, tile, n_tiles,
      T_pad);
  return (int)cudaGetLastError();
}

extern "C" int fk_q8_rows(const float* x, const float* pos, long long pos_bstride, int P, int B,
                          int N, int C, int8_t* q, float* s, void* stream) {
  const int rows = B * N;
  q8_rows_kernel<<<(rows + fk::kWarps - 1) / fk::kWarps, fk::kThreads, 0,
                   (cudaStream_t)stream>>>(x, pos, pos_bstride, P, N, C, rows, q, s);
  return (int)cudaGetLastError();
}
