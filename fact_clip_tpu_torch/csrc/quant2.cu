// K8e: the int8 MS-TCN++ tower (int8 evaluation of the f: m2 models,
// Breakfast and Epic-Kitchens), on quant.cuh's int8 mma.sync core.
//
// Replaces fact_clip_tpu/ops/pallas/quant_conv.py::_stack2_layer_q8
// (_stack2_kernel_q8, act_scale="tile"), one layer of
//   c_k = (sum_tap q(x[t + (tap-1) d_k]) . qk_k[tap]) * (s_x * sk_k) + b_k   k = 1, 2
//   h   = (q(c1) . Wt) * (s1 * swt) + (q(c2) . Wb) * (s2 * swb)
//   out = (relu(h + bf) + x[t]) * mask
// with d1 = 2^(L-1-i) and d2 = 2^i, int8 joint-tap conv weights and int8
// fuse halves (per output channel scales), and three activation scales per
// video and JAX tile of ``tile`` frames (ops/quant_conv.py::_tiling, not
// any block of this kernel): s_x the absmax of the layer input over the
// tile's window [t*tile - halo, t*tile + tile + halo) within [0, T_pad),
// halo = ceil8(max(d1, d2)) for both convs; s1 and s2 the max of |c1| and
// |c2| over EVERY row of the tile, padded rows included (past a video's end
// c_k is b_k plus the taps of valid frames within d_k).  A tile of c (512 x
// 512 f32, 1 MB at Breakfast's width) does not fit in a block, so a layer
// runs in two passes, as K8a's (quant.cu):
//   A: per (64 frames, video): s_x from the 8-row group maxima of the layer
//      input; for each conv the three taps quantized while staged with one
//      window scale and summed in ONE int32 accumulator (joint weight
//      scale), dequantize + b_k, write c_k (f32), and fold |c_k|'s max into
//      one word per (conv, video, tile) with atomicMax on the int bits
//      (|c| >= 0: int order is float order; a max does not depend on the
//      order).  Blocks whose every tap reads past the video (r0 >= len +
//      d_k) skip the GEMM: their c_k is exactly b_k, as in the plain
//      version.
//   B: per (64 frames, video): quantize c1 and c2 with their tile's s1, s2
//      while staged, the two fuse GEMMs (K = C each, one accumulator pass
//      after the other, the first kept as f32 in registers), the f32
//      epilogue, the residual, the write mask and each 8-row group's absmax
//      of the output: the next layer's window maxima.  Blocks wholly past
//      the video write zeros and skip their GEMMs.
// Every dequantization follows JAX's kernel as XLA's CPU backend computes it
// (the CPU tests hold the plain version bit-equal to the interpret mode):
// c_k = fma(acc, s_x * sk, b_k); h = fma(h1, s1 * swt, h2 * (s2 * swb));
// relu(h + bf) + x, each other step rounded on its own.
//
// Bound on the H100 (chip_smoke.py::k8e_case), counting the work the
// function needs: the six tap products on the rows whose c feeds a tile's
// scale (valid rows, and past a video's end those within d_k of it inside
// its last tile), the two fuse products and the f32 epilogue on the valid
// rows.  At Breakfast's 4 x 4096 x 512 with every frame valid the ten
// layers' int8 products are 8 C^2 operations a frame and layer, 0.69 T
// operations (0.35 ms at 1,979 TOPS).  Its own traffic is larger: a layer
// reads its input three times (taps and residual), writes and reads c1 and
// c2 once and writes its output once, ~7 * 4 * B*T*C bytes (0.23 GB, 0.07
// ms at 3.35 TB/s).  The six int8 tap weights of a layer (1.5 MB at C=512)
// stream from L2.  The kernel is neither: the simple single-buffered
// mma.sync pipeline of K8a, see PERF.md for its time.
#include <math.h>

#include "quant.cuh"

namespace {

constexpr int TBM = 64;            // frames per block
constexpr int kMaxBlockTiles = 9;  // JAX tiles (multiples of 8 frames) 64 frames can touch

// Pass A: c_k on rows [r0, r0 + 64) of video b, k = 1, 2, and the per-(conv,
// video, tile) max of |c_k| into smax (2, B, n_tiles).
__global__ void __launch_bounds__(fk::kThreads)
q8_tower2_a_kernel(const float* __restrict__ x, const int* __restrict__ len,
                   const float* __restrict__ gmax, const int8_t* __restrict__ qk1t,
                   const float* __restrict__ sk1, const float* __restrict__ b1,
                   const int8_t* __restrict__ qk2t, const float* __restrict__ sk2,
                   const float* __restrict__ b2, float* c_out, int* smax, int B, int T, int C,
                   int d1, int d2, int halo, int tile, int n_tiles, int T_pad) {
  extern __shared__ float4 smem_raw[];
  fk::QSmem<TBM>& s = *reinterpret_cast<fk::QSmem<TBM>*>(smem_raw);
  __shared__ float t_scale[kMaxBlockTiles];
  __shared__ int t_max[2][kMaxBlockTiles];
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
      t_max[0][i] = t_max[1][i] = 0;
    }
  }
  __syncthreads();
  for (int r = tid; r < TBM; r += fk::kThreads) {
    const float sc = t_scale[min(r0 + r, T_pad - 1) / tile - t_first];
    row_s[r] = sc;
    row_inv[r] = __fdiv_rn(127.f, sc);
  }
  // (q_gemm_pass synchronises before its first staging)

  int acc[TBM / 16][4][4];
  for (int k = 0; k < 2; ++k) {
    const int d = k == 0 ? d1 : d2;
    const int8_t* qkt = k == 0 ? qk1t : qk2t;
    const float* sk = k == 0 ? sk1 : sk2;
    const float* bk = k == 0 ? b1 : b2;
    float* ck = c_out + (size_t)k * B * T_pad * C;
    const bool skip = r0 >= lim + d;  // every tap of every row reads past the video
    // A[r][tap * C + c] = q(x[r0 + r + (tap - 1) d][c]); rows outside [0, len) read 0
    auto stage = [&](int8_t (*as)[fk::kQLD], int k0) {
      const int r = tid >> 2;
      const int kk = (tid & 3) * 16;
      const int kx = k0 + kk;
      int4 v = make_int4(0, 0, 0, 0);
      if (kx < 3 * C) {
        const int tap = kx / C;
        const int cc = kx - tap * C;
        const int src = r0 + r + (tap - 1) * d;
        if (src >= 0 && src < lim) v = fk::quant16(x + ((size_t)b * T + src) * C + cc, row_inv[r]);
      }
      *reinterpret_cast<int4*>(&as[r][kk]) = v;
    };
    float rmax[TBM / 16][2];
#pragma unroll
    for (int mt = 0; mt < TBM / 16; ++mt) rmax[mt][0] = rmax[mt][1] = 0.f;
    for (int n0 = 0; n0 < C; n0 += fk::kBN) {
      if (skip) {
#pragma unroll
        for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
          for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt2][i] = 0;
      } else {
        fk::q_gemm_pass<TBM>(acc, stage, qkt, 3 * C, n0, C, s);
      }
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
                                      __fmul_rn(row_s[r], __ldg(sk + c)), __ldg(bk + c));
            ck[((size_t)b * T_pad + row) * C + c] = v;
            rmax[mt][i >> 1] = fmaxf(rmax[mt][i >> 1], fabsf(v));
          }
    }
#pragma unroll
    for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + fk::q_row(mt, 2 * h);
        if (row < T_pad) atomicMax(&t_max[k][row / tile - t_first], __float_as_int(rmax[mt][h]));
      }
  }
  __syncthreads();
  if (tid < 2 * nt) {
    const int k = tid / nt;
    const int i = tid - k * nt;
    if (t_max[k][i] > 0) atomicMax(smax + ((size_t)k * B + b) * n_tiles + t_first + i, t_max[k][i]);
  }
}

// Pass B: out = (relu(fuse(q(c1), q(c2)) + bf) + x) * mask on rows [r0, r0 +
// 64) of video b, and the output's 8-row group maxima.
__global__ void __launch_bounds__(fk::kThreads)
q8_tower2_b_kernel(const float* __restrict__ x, const int* __restrict__ len,
                   const float* __restrict__ c_in, const int* __restrict__ smax,
                   const int8_t* __restrict__ qwtt, const float* __restrict__ swt,
                   const int8_t* __restrict__ qwbt, const float* __restrict__ swb,
                   const float* __restrict__ bf, float* y, float* gmax_out, int B, int T, int C,
                   int tile, int n_tiles, int T_pad) {
  extern __shared__ float4 smem_raw[];
  fk::QSmem<TBM>& s = *reinterpret_cast<fk::QSmem<TBM>*>(smem_raw);
  __shared__ float row_s[2][TBM];
  __shared__ float row_inv[2][TBM];
  __shared__ int g_max[TBM / 8];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TBM;
  const int G = T_pad / 8;
  const int lim = min(len[b], T);
  for (int e = tid; e < 2 * TBM; e += fk::kThreads) {
    const int k = e / TBM;
    const int r = e - k * TBM;
    const int t = min(r0 + r, T_pad - 1) / tile;
    const float sc = fmaxf(__int_as_float(smax[((size_t)k * B + b) * n_tiles + t]), 1e-12f);
    row_s[k][r] = sc;
    row_inv[k][r] = __fdiv_rn(127.f, sc);
  }
  if (tid < TBM / 8) g_max[tid] = 0;
  const bool skip = r0 >= lim;  // every row is masked: zeros

  int kc = 0;  // the conv whose output is staged: c1 (0) or c2 (1)
  auto stage = [&](int8_t (*as)[fk::kQLD], int k0) {
    const int r = tid >> 2;
    const int kk = (tid & 3) * 16;
    const int row = r0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (row < T_pad && k0 + kk < C)
      v = fk::quant16(c_in + (((size_t)kc * B + b) * T_pad + row) * C + k0 + kk, row_inv[kc][r]);
    *reinterpret_cast<int4*>(&as[r][kk]) = v;
  };

  int acc[TBM / 16][4][4];
  float h1[TBM / 16][4][4];
  float rmax[TBM / 16][2];
#pragma unroll
  for (int mt = 0; mt < TBM / 16; ++mt) rmax[mt][0] = rmax[mt][1] = 0.f;
  for (int n0 = 0; n0 < C; n0 += fk::kBN) {
    if (!skip) {
      kc = 0;
      fk::q_gemm_pass<TBM>(acc, stage, qwtt, C, n0, C, s);
#pragma unroll
      for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
        for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
          for (int i = 0; i < 4; ++i) h1[mt][nt2][i] = __int2float_rn(acc[mt][nt2][i]);
      kc = 1;
      fk::q_gemm_pass<TBM>(acc, stage, qwbt, C, n0, C, s);
    }
#pragma unroll
    for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
      for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = fk::q_row(mt, i);
          const int c = n0 + fk::q_col(nt2, i);
          const int row = r0 + r;
          if (c >= C || row >= T) continue;
          float o = 0.f;
          if (!skip && row < lim) {
            const float h2 = __fmul_rn(__int2float_rn(acc[mt][nt2][i]),
                                       __fmul_rn(row_s[1][r], __ldg(swb + c)));
            const float h = __fmaf_rn(h1[mt][nt2][i], __fmul_rn(row_s[0][r], __ldg(swt + c)), h2);
            const float v = __fadd_rn(h, __ldg(bf + c));
            o = __fadd_rn(v > 0.f ? v : 0.f, __ldg(x + ((size_t)b * T + row) * C + c));
          }
          y[((size_t)b * T + row) * C + c] = o;
          rmax[mt][i >> 1] = fmaxf(rmax[mt][i >> 1], fabsf(o));
        }
  }
#pragma unroll
  for (int mt = 0; mt < TBM / 16; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = fk::q_row(mt, 2 * h);
      if (r0 + r < T_pad) atomicMax(&g_max[r >> 3], __float_as_int(rmax[mt][h]));
    }
  __syncthreads();
  if (tid < TBM / 8 && r0 / 8 + tid < G)
    gmax_out[(size_t)b * G + r0 / 8 + tid] = __int_as_float(g_max[tid]);
}

}  // namespace

// One int8 MS-TCN++ layer: pass A then pass B.  c (2, B, T_pad, C) f32
// scratch; smax (2, B, n_tiles) int32 zeros; gmax_in the layer input's 8-row
// group maxima (fk_q8_group_max for layer 0, the previous layer's pass B
// after it).
extern "C" int fk_q8_tower2_layer(const float* x, const int* len, const float* gmax_in,
                                  const int8_t* qk1t, const float* sk1, const float* b1,
                                  const int8_t* qk2t, const float* sk2, const float* b2, float* c,
                                  int* smax, const int8_t* qwtt, const float* swt,
                                  const int8_t* qwbt, const float* swb, const float* bf, float* y,
                                  float* gmax_out, int B, int T, int C, int d1, int d2, int halo,
                                  int tile, int n_tiles, int T_pad, void* stream) {
  if (C % 32 != 0 || tile < 8 || tile % 8 != 0 || T_pad % tile != 0 || halo % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T_pad + TBM - 1) / TBM, B);
  const size_t smem = sizeof(fk::QSmem<TBM>);
  cudaError_t err = fk::set_smem((const void*)q8_tower2_a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  q8_tower2_a_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, len, gmax_in, qk1t, sk1, b1, qk2t, sk2, b2, c, smax, B, T, C, d1, d2, halo, tile,
      n_tiles, T_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = fk::set_smem((const void*)q8_tower2_b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  q8_tower2_b_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      x, len, c, smax, qwtt, swt, qwbt, swb, bf, y, gmax_out, B, T, C, tile, n_tiles, T_pad);
  return (int)cudaGetLastError();
}
