// The int8 towers on tc_int8.cuh's int8 wgmma core: K8e, the MS-TCN++
// tower (int8 evaluation of the f: m2 models, Breakfast and Epic-Kitchens),
// and K8a, the MSTCN tower (the f: m models, the flagship), which runs
// K8e's passes with one conv (below).
//
// K8e replaces fact_clip_tpu/ops/pallas/quant_conv.py::_stack2_layer_q8
// (_stack2_kernel_q8, act_scale="tile"), one layer of
//   c_k = (sum_tap q(x[t + (tap-1) d_k]) . qk_k[tap]) * (s_x * sk_k) + b_k   k = 1, 2
//   h   = (q(c1) . Wt) * (s1 * swt) + (q(c2) . Wb) * (s2 * swb)
//   out = (relu(h + bf) + x[t]) * mask
// with d1 = 2^(L-1-i) and d2 = 2^i, int8 joint-tap conv weights and int8
// fuse halves (per output channel scales), and three activation scales per
// video and JAX tile of ``tile`` frames (ops/quant_conv.py::_tiling): s_x
// the absmax of the layer input over the tile's window [t*tile - halo,
// t*tile + tile + halo) within [0, T_pad), halo = ceil8(max(d1, d2)); s1 and
// s2 the max of |c1| and |c2| over EVERY row of the tile, padded rows
// included (past a video's end c_k is b_k plus the taps of valid frames
// within d_k).  A layer is four launches:
//   W: per (32 window rows, tile, video): s_x from the input's 8-row group
//      maxima, then the tile's window quantized ONCE as int8 (rows outside
//      [0, len) zero) into its own slab of the window buffer (B, n_tiles,
//      tile + 2 halo, Cw).  Each tap of each conv is that slab read at a
//      row offset of halo + (tap - 1) d: nothing is quantized in a product.
//   A: both convs on the int8 wgmma core, per item (128 rows of one tile,
//      BN columns, conv, video) of a persistent grid: K = three taps x
//      ceil32(C), each tap a TMA box of the window slab at its row offset;
//      the f32 epilogue c_k = fma(acc, s_x * sk, b_k) into c (2, B, T_pad,
//      Cq), and |c_k|'s max folded into one word per (conv, video, tile) by
//      atomicMax on the int bits (|c| >= 0: int order is float order; a max
//      does not depend on the order).  An item whose every tap reads past
//      the video (r0 >= len + d_k) runs no product: its c_k is exactly b_k,
//      as in the plain version.
//   Q: c1 and c2 quantized with their tile's s1, s2 into qc (2, B, T_pad, Cq).
//   F: the two fuse products on the core, per item (128 rows of one tile,
//      128 columns, video), h1 and h2 in two accumulators; h = fma(h1, s1 *
//      swt, h2 * (s2 * swb)), relu(h + bf) + x, the mask, and each 8-row
//      group's absmax of the output (atomicMax into the zeroed next layer's
//      group maxima): the next layer's window scales.  Items wholly past the
//      video write zeros and run no product.
// A block of A or F never straddles two JAX tiles (the grid walks each
// tile's rows in blocks of 128; at the default tile of 512 four blocks a
// tile), so one s_x, s1, s2 serves it.  Every dequantization follows JAX's
// kernel as XLA's CPU backend computes it (the CPU tests hold the plain
// version bit-equal to the interpret mode): c_k = fma(acc, s_x * sk, b_k);
// h = fma(h1, s1 * swt, h2 * (s2 * swb)); relu(h + bf) + x, each other step
// rounded on its own.  Any width: each tap's K segment is padded to whole
// 32-byte steps (kseg = ceil32(C)) and a step multiplies only those; the
// rows of the int8 buffers are Cw = ceil16(C) bytes (128 below C = 128, one
// whole TMA box) with zeros past C.
//
// Bound on the H100 (chip_smoke.py::k8e_case), counting the work the
// function needs: the six tap products on the rows whose c feeds a tile's
// scale, the two fuse products and the f32 epilogue on the valid rows.  At
// Breakfast's 4 x 4096 x 512 with every frame valid the ten layers' int8
// products are 0.69 T operations (0.35 ms at 1,979 TOPS).  This design's
// own traffic, a frame and channel of a layer: the input read (4 bytes) and
// its windows written (~1.8 on average over the ten halos; the taps read
// them back from L2), c written (8), read (8) and written as int8 (2), read
// again (2 per column block, L2), the residual read and the output written
// (8): ~32 bytes from device memory, 0.08 ms a layer at 3.35 TB/s (PERF.md's
// K8e findings: why c keeps its f32 round trip).
//
// K8a replaces fact_clip_tpu/ops/pallas/quant_conv.py::_stack_layer_q8
// (_stack_kernel_q8, act_scale="tile"), one layer of
//   a   = relu((sum_tap q(x[t + (tap-1) d]) . qwd[tap]) * (s_x * swd) + bd)
//   out = (q(a) . qw1) * (s_a * sw1) + b1 + x[t]   (-> LayerNorm) * mask
// with int8 joint-tap conv weights and an int8 1x1 weight (per output
// channel scales); s_x the absmax of the layer input over the tile's window
// with halo = ceil8(d), s_a the max of a over every row of the tile, padded
// rows included (a >= 0).  The same passes: W; A with one conv, the ReLU in
// its epilogue (an item past the video writes relu(bd)); Q (a quantized
// with its tile's s_a); B, pass F's kernel with one accumulator: out =
// fma(acc, s_a * sw1, b1) + x, the mask and the group maxima.  With the
// LayerNorm (eps 1e-5), B writes the rows before the norm and pass N
// normalizes them in place, a warp a row (lane l sums channels l, l + 32,
// ... in turn, then the xor-shuffle tree: ops/quant_conv.py::_lane_sum is
// this order), and writes the group maxima: a row's sums span the column
// items of B.  Any width, as K8e.
//
// K8a's bound (chip_smoke.py::k8a_case): the 3-tap product on the rows
// whose a feeds a tile's s_a (the valid rows and, past a video's end, those
// within d of it in its last tile; further on a = relu(bd)), the 1x1
// product and the f32 epilogue on the valid rows.  At the flagship's
// lengths (22,022 valid frames of 8 x 3072, C = 256) the ten layers' int8
// products are 117.2 G operations (0.059 ms at 1,979 TOPS).  Its own
// traffic a frame and channel of a layer: the input read (4) and its
// windows written (~1.6 at d <= 512), a written (4), read (4) and written as
// int8 (1), read again (1 per column item, L2), the residual read and the
// output written (8): ~23 bytes, 0.045 ms a layer at 3.35 TB/s.
//
// The row forms (act_scale="row": _stack_kernel_q8's and _stack2_kernel_q8's
// else: branches) give each frame its own activation scales and each tap
// its own weight scales (quantize_weight per tap), so a tap's int32 product
// cannot be summed with another's: each tap has its own accumulator,
// dequantized into the f32 sum before the next tap runs, in JAX's order as
// XLA's CPU backend contracts it (p_k = fl(idot_k * s_row(t + (k-1) d));
// acc = fma(p0, sw0, p1 * sw1), then fma(p2, sw2, acc); + b).  A layer's
// passes, on the tile form's kernels where they fit:
//   R: each frame's row quantized once with its own absmax (one warp a row,
//      the rounding of K8d's row quantizer) into a row buffer (B, H + T_pad +
//      H, Cw) and its scale into (B, H + T_pad + H); rows at or past a
//      video's end 0 with scale 1e-12, the halos of H = ceil8(max d) rows 0
//      with scale 0 (a tap outside [0, T_pad) reads them, as JAX zeroes
//      both).  Each tap is that buffer read at a row offset.
//   A: per item (128 rows, 128 columns, conv, video) of a persistent grid,
//      the three taps one after another through one int32 accumulator and
//      an f32 sum (128 columns: both fit in a consumer's registers); the
//      epilogue c (K8a: relu'd) into (nconv, B, T_pad, Cq) and each row's
//      max |c| over all C columns, which span column items, by atomicMax on
//      the int bits into (nconv, B, T_pad).  Items wholly past the video are
//      skipped: in the row form nothing past a video's end reaches a valid
//      frame.
//   Q: the tile form's pass with each row's own scale.
//   F / B: the tile form's pass with each row's scales: K8e h = fma(h1 s1,
//      swt, (h2 s2) swb), relu(h + bf) + x; K8a fma(acc s_a, sw1, b1) + x
//      (then pass N with the LayerNorm).  No group maxima: nothing reads
//      them.
// The result depends on the JAX tile only through T_pad.  Its bound counts
// the int8 products on the valid rows (nothing else reaches a valid frame)
// and ~6 more f32 operations a frame and channel for each conv's three
// dequantizations.
#include <math.h>
#include <string.h>

#include "common.cuh"
#include "quant.cuh"
#include "tc_int8.cuh"

namespace {

constexpr int kWinRows = 32;  // window rows per block of pass W
constexpr int kQRows = 32;    // rows per block of pass Q
constexpr int kOutBN = 128;   // columns per block of passes F and B

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// 16 int8 values of row `src` (f32, C wide) from channel c0 on, quantized
// with inv = 127 / s; channels at or past C are 0
__device__ __forceinline__ int4 quant_chunk(const float* __restrict__ src, int c0, int C,
                                            float inv) {
  if (c0 + 16 <= C && (C & 3) == 0) return fk::quant16(src + c0, inv);
  int v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = c0 + i < C ? fk::quant_s8(__ldg(src + c0 + i), inv) : 0;
  return make_int4(fk::pack_s8(v[0], v[1], v[2], v[3]), fk::pack_s8(v[4], v[5], v[6], v[7]),
                   fk::pack_s8(v[8], v[9], v[10], v[11]),
                   fk::pack_s8(v[12], v[13], v[14], v[15]));
}

// Pass W: rows [32 x, 32 x + 32) of tile t's window of video b, and (block
// x = 0) s_x into sx (B, n_tiles)
__global__ void __launch_bounds__(fk::kThreads)
q8e_window_kernel(const float* __restrict__ x, const int* __restrict__ len,
                  const float* __restrict__ gmax, int8_t* __restrict__ qwin,
                  float* __restrict__ sx, int T, int C, int Cw, int halo, int tile, int n_tiles,
                  int T_pad, int wrows) {
  __shared__ float s_scale;
  const int t = blockIdx.y, b = blockIdx.z;
  const int G = T_pad / 8;
  const int lim = min(len[b], T);
  if (threadIdx.x < 32) {
    const int lo = max(0, t * tile - halo) / 8;
    const int hi = min(T_pad, t * tile + tile + halo) / 8;
    float m = 0.f;
    for (int g = lo + threadIdx.x; g < hi; g += 32) m = fmaxf(m, gmax[(size_t)b * G + g]);
    m = fmaxf(fk::warp_max(m), 1e-12f);
    if (threadIdx.x == 0) {
      s_scale = m;
      if (blockIdx.x == 0) sx[(size_t)b * n_tiles + t] = m;
    }
  }
  __syncthreads();
  const float inv = __fdiv_rn(127.f, s_scale);
  const int chunks = Cw / 16;
  const int w0 = blockIdx.x * kWinRows;
  int8_t* dst = qwin + ((size_t)b * n_tiles + t) * wrows * Cw;
  for (int i = threadIdx.x; i < kWinRows * chunks; i += fk::kThreads) {
    const int wr = w0 + i / chunks;
    const int cc = (i - (i / chunks) * chunks) * 16;
    if (wr >= wrows) break;
    const int row = t * tile - halo + wr;
    int4 v = make_int4(0, 0, 0, 0);
    if (row >= 0 && row < lim) v = quant_chunk(x + ((size_t)b * T + row) * C, cc, C, inv);
    *reinterpret_cast<int4*>(dst + (size_t)wr * Cw + cc) = v;
  }
}

struct ConvArgs {
  CUtensorMap amap;  // the window buffer (Cw, wrows, B * n_tiles)
  CUtensorMap bmap;  // the conv weights (Kc, C, nconv): row n of conv z, tap k at k * kseg
  const int* len;
  const float* sx;  // (B, n_tiles)
  const float* sk[2];
  const float* bias[2];
  float* c;   // (nconv, B, T_pad, Cq)
  int* smax;  // (nconv, B, n_tiles): |c|'s maxima, as int bits
  int B, C, Cq, kseg, halo, tile, n_tiles, T_pad, jt, ncol, nconv, relu;
  int d[2];
};

// Pass A, persistent: item (row block, column block, conv z, video b), the
// row block fastest-but-one so that the items of one row block (every conv
// and column block) run side by side and share its window rows in L2.
// The item's c_z on rows [r0, r0 + 128) of tile t (r0 = t * tile + j * 128),
// BN columns from n0; with relu (K8a) c is relu'd, so |c| = c.
template <int BN>
__global__ void __launch_bounds__(tc8::kThreads, 1)
    q8e_conv_kernel(const __grid_constant__ ConvArgs p) {
  extern __shared__ float4 smem_raw[];
  __shared__ float wmax[8];
  __shared__ float col_s[BN], col_b[BN];  // s_x * sk and b of the item's columns
  uint8_t* sm = tc::align1024<uint8_t>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = p.n_tiles * p.jt;
  const int per_row = p.nconv * p.ncol;
  const int items = rows * per_row * p.B;
  const int kbs = ceil_div(p.kseg, tc8::kKB);
  // (t, j, n0, z, b, first row, K steps) of item i
  auto decode = [&](int i, int& t, int& j, int& n0, int& z, int& b, int& r0, int& nk) {
    const int col = i % per_row;
    const int rb = i / per_row;
    b = rb / rows;
    const int r = rb - b * rows;
    t = r / p.jt;
    j = r - t * p.jt;
    z = col / p.ncol;
    n0 = (col - z * p.ncol) * BN;
    r0 = t * p.tile + j * tc8::kBM;
    // every tap of every row past the video: no product, c = b
    nk = r0 >= min(p.len[b], p.T_pad) + p.d[z] ? 0 : 3 * kbs;
  };
  uint64_t* full = tc8::ring_init<BN>(sm);
  __syncthreads();
  int g = 0;
  if (warp < 4) {
    tc::setmaxnreg_dec<40>();
    if (tid == 0)
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        int t, j, n0, z, b, r0, nk;
        decode(i, t, j, n0, z, b, r0, nk);
        const int wrow = p.halo + j * tc8::kBM;  // the item's first row in its tile's window
        const int d = p.d[z];
        tc8::produce<BN>(sm, full, g, nk, [&](int kc, uint8_t* a, uint8_t* w, uint64_t* bar) {
          const int tap = kc / kbs, kb = (kc - tap * kbs) * tc8::kKB;
          tc::tma_load_3d(a, &p.amap, bar, kb, wrow + (tap - 1) * d, b * p.n_tiles + t);
          tc::tma_load_3d(w, &p.bmap, bar, tap * p.kseg + kb, n0, z);
        });
      }
    return;
  }
  tc::setmaxnreg_inc<232>();
  const int wg = (warp >> 2) - 1;
  const int ct = tid - 128;  // consumer thread
  // epilogue: register 4jj + 2h + e holds row rw + 8h, column n0 + 8jj + cq + e
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int acc[1][BN / 2];
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int t, j, n0, z, b, r0, nk;
    decode(i, t, j, n0, z, b, r0, nk);
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[0][k] = 0;
    tc8::consume<BN, 1>(acc, sm, full, g, nk, wg, [&](int kc) {
      const int kb = (kc % kbs) * tc8::kKB;
      return min(4, (p.kseg - kb) / 32);
    });
    const float s_x = p.sx[(size_t)b * p.n_tiles + t];
    for (int c = ct; c < BN; c += 256) {
      const int n = n0 + c;
      col_s[c] = n < p.C ? __fmul_rn(s_x, __ldg(p.sk[z] + n)) : 0.f;
      col_b[c] = n < p.C ? __ldg(p.bias[z] + n) : 0.f;
    }
    tc::bar_sync(1, 256);
    float* cz = p.c + ((size_t)z * p.B + b) * p.T_pad * p.Cq;
    float m = 0.f;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int cl = 8 * jj + cq;  // the column within the item
      const int n = n0 + cl;
      if (n >= p.C) continue;
      const bool n1 = n + 1 < p.C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = j * tc8::kBM + rw + 8 * h;  // row within the tile
        if (rt >= p.tile) continue;
        float v0 = __fmaf_rn(__int2float_rn(acc[0][4 * jj + 2 * h]), col_s[cl], col_b[cl]);
        float v1 =
            __fmaf_rn(__int2float_rn(acc[0][4 * jj + 2 * h + 1]), col_s[cl + 1], col_b[cl + 1]);
        if (p.relu) {
          v0 = v0 > 0.f ? v0 : 0.f;
          v1 = v1 > 0.f ? v1 : 0.f;
        }
        // Cq is a multiple of 16 above C: column n + 1 lies in the row
        *reinterpret_cast<float2*>(cz + (size_t)(t * p.tile + rt) * p.Cq + n) =
            make_float2(v0, v1);
        m = fmaxf(m, fabsf(v0));
        if (n1) m = fmaxf(m, fabsf(v1));
      }
    }
    m = fk::warp_max(m);
    if (lane == 0) wmax[warp - 4] = m;
    tc::bar_sync(1, 256);
    if (ct == 0) {
      float mm = 0.f;
      for (int w = 0; w < 8; ++w) mm = fmaxf(mm, wmax[w]);
      if (mm > 0.f) atomicMax(p.smax + ((size_t)z * p.B + b) * p.n_tiles + t, __float_as_int(mm));
    }
    tc::bar_sync(1, 256);  // wmax, col_s and col_b are free for the next item
  }
}

// Pass R (the row forms): row t of video b quantized with its own absmax
// into qrow (B, H + T_pad + H, Cw) at row H + t, its scale into srow (B, H +
// T_pad + H); rows at or past the video's end are 0 with scale 1e-12 (the
// plain version's zero rows), one warp a row of the B x T_pad rows
__global__ void __launch_bounds__(fk::kThreads)
q8r_rows_kernel(const float* __restrict__ x, const int* __restrict__ len,
                int8_t* __restrict__ qrow, float* __restrict__ srow, int B, int T, int C, int Cw,
                int H, int T_pad) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * fk::kWarps + (threadIdx.x >> 5);
  if (r >= B * T_pad) return;
  const int b = r / T_pad, t = r - b * T_pad;
  const size_t orow = (size_t)b * (T_pad + 2 * H) + H + t;
  const bool valid = t < min(len[b], T);
  const float* xr = x + ((size_t)b * T + (valid ? t : 0)) * C;
  float m = 0.f;
  if (valid)
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(__ldg(xr + c)));
  const float s = fmaxf(fk::warp_max(m), 1e-12f);
  const float inv = __fdiv_rn(127.f, s);
  int8_t* q = qrow + orow * Cw;
  for (int c = 4 * lane; c < Cw; c += 128) {
    int v[4] = {0, 0, 0, 0};
    if (valid)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < C) v[i] = fk::quant_s8(__ldg(xr + c + i), inv);
    *reinterpret_cast<int*>(q + c) = fk::pack_s8(v[0], v[1], v[2], v[3]);
  }
  if (lane == 0) srow[orow] = s;
}

struct RowConvArgs {
  CUtensorMap amap;  // the row buffer (Cw, T_pad + 2 H, B)
  CUtensorMap bmap;  // the conv weights (Kc, C, nconv): row n of conv z, tap k at k * kseg
  const int* len;
  const float* srow;   // (B, T_pad + 2 H) the rows' scales
  const float* sk[2];  // (3, C): each tap's column scales
  const float* bias[2];
  float* c;   // (nconv, B, T_pad, Cq)
  int* rmax;  // (nconv, B, T_pad): each row's max |c|, as int bits
  int B, C, Cq, kseg, H, tile, n_tiles, T_pad, jt, ncol, nconv, relu;
  int d[2];
};

// Pass A of the row forms, persistent: item (row block, column block, conv
// z, video b) as the tile form's pass A, 128 columns.  The three taps run
// one after another through one int32 accumulator; after each, its products
// are scaled by their rows' scales (a register per row) and added into an
// f32 sum in JAX's order; then + b_z (K8a: the ReLU), c written and each
// row's max folded over the four lanes that share it and by atomicMax
// across column items.
__global__ void __launch_bounds__(tc8::kThreads, 1)
    q8r_conv_kernel(const __grid_constant__ RowConvArgs p) {
  constexpr int BN = 128;
  extern __shared__ float4 smem_raw[];
  __shared__ float col_s[3][BN], col_b[BN];  // each tap's sk and b of the item's columns
  uint8_t* sm = tc::align1024<uint8_t>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = p.n_tiles * p.jt;
  const int per_row = p.nconv * p.ncol;
  const int items = rows * per_row * p.B;
  const int kbs = ceil_div(p.kseg, tc8::kKB);
  const int Tw = p.T_pad + 2 * p.H;  // the row buffer's rows a video
  auto decode = [&](int i, int& t, int& j, int& n0, int& z, int& b, int& r0, int& nk) {
    const int col = i % per_row;
    const int rb = i / per_row;
    b = rb / rows;
    const int r = rb - b * rows;
    t = r / p.jt;
    j = r - t * p.jt;
    z = col / p.ncol;
    n0 = (col - z * p.ncol) * BN;
    r0 = t * p.tile + j * tc8::kBM;
    nk = r0 >= min(p.len[b], p.T_pad) ? 0 : 3 * kbs;  // every row past the video: skipped
  };
  uint64_t* full = tc8::ring_init<BN>(sm);
  __syncthreads();
  int g = 0;
  if (warp < 4) {
    tc::setmaxnreg_dec<40>();
    if (tid == 0)
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        int t, j, n0, z, b, r0, nk;
        decode(i, t, j, n0, z, b, r0, nk);
        const int d = p.d[z];
        tc8::produce<BN>(sm, full, g, nk, [&](int kc, uint8_t* a, uint8_t* w, uint64_t* bar) {
          const int tap = kc / kbs, kb = (kc - tap * kbs) * tc8::kKB;
          tc::tma_load_3d(a, &p.amap, bar, kb, p.H + r0 + (tap - 1) * d, b);
          tc::tma_load_3d(w, &p.bmap, bar, tap * p.kseg + kb, n0, z);
        });
      }
    return;
  }
  tc::setmaxnreg_inc<232>();
  const int wg = (warp >> 2) - 1;
  const int ct = tid - 128;  // consumer thread
  // register 4jj + 2h + e holds row rw + 8h, column n0 + 8jj + cq + e
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int acc[1][BN / 2];
  float f[BN / 2];
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int t, j, n0, z, b, r0, nk;
    decode(i, t, j, n0, z, b, r0, nk);
    if (nk == 0) continue;
    for (int c = ct; c < 3 * BN; c += 256) {
      const int tap = c / BN, cl = c - tap * BN;
      col_s[tap][cl] = n0 + cl < p.C ? __ldg(p.sk[z] + tap * p.C + n0 + cl) : 0.f;
    }
    if (ct < BN) col_b[ct] = n0 + ct < p.C ? __ldg(p.bias[z] + n0 + ct) : 0.f;
    tc::bar_sync(1, 256);
    const int d = p.d[z];
#pragma unroll 1
    for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) acc[0][k] = 0;
      tc8::consume<BN, 1>(acc, sm, full, g, kbs, wg,
                          [&](int kc) { return min(4, (p.kseg - kc * tc8::kKB) / 32); });
      float rs[2];  // the tap's rows' scales (0 in the halos)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = j * tc8::kBM + rw + 8 * h;
        rs[h] = rt < p.tile
                    ? __ldg(p.srow + (size_t)b * Tw + p.H + t * p.tile + rt + (tap - 1) * d)
                    : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * jj + 2 * h + e, cl = 8 * jj + cq + e;
            const float pk = __fmul_rn(__int2float_rn(acc[0][k]), rs[h]);
            if (tap == 0)
              f[k] = pk;
            else if (tap == 1)
              f[k] = __fmaf_rn(f[k], col_s[0][cl], __fmul_rn(pk, col_s[1][cl]));
            else
              f[k] = __fmaf_rn(pk, col_s[2][cl], f[k]);
          }
    }
    float* cz = p.c + ((size_t)z * p.B + b) * p.T_pad * p.Cq;
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int cl = 8 * jj + cq;
      const int n = n0 + cl;
      if (n >= p.C) continue;
      const bool n1 = n + 1 < p.C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = j * tc8::kBM + rw + 8 * h;
        if (rt >= p.tile) continue;
        float v0 = __fadd_rn(f[4 * jj + 2 * h], col_b[cl]);
        float v1 = __fadd_rn(f[4 * jj + 2 * h + 1], col_b[cl + 1]);
        if (p.relu) {
          v0 = v0 > 0.f ? v0 : 0.f;
          v1 = v1 > 0.f ? v1 : 0.f;
        }
        // Cq is a multiple of 16 above C: column n + 1 lies in the row
        *reinterpret_cast<float2*>(cz + (size_t)(t * p.tile + rt) * p.Cq + n) =
            make_float2(v0, v1);
        m[h] = fmaxf(m[h], fabsf(v0));
        if (n1) m[h] = fmaxf(m[h], fabsf(v1));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four lanes of a row, then across column items
      float mh = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, 2));
      const int rt = j * tc8::kBM + rw + 8 * h;
      if ((lane & 3) == 0 && rt < p.tile && mh > 0.f)
        atomicMax(p.rmax + ((size_t)z * p.B + b) * p.T_pad + t * p.tile + rt,
                  __float_as_int(mh));
    }
    tc::bar_sync(1, 256);  // col_s and col_b are free for the next item
  }
}

// Pass Q: rows [32 x, 32 x + 32) of c_z of video b quantized with their
// tile's s_z (row: each row's own) into qc; channels at or past C are 0
__global__ void __launch_bounds__(fk::kThreads)
q8e_quant_c_kernel(const float* __restrict__ c, const int* __restrict__ smax,
                   int8_t* __restrict__ qc, int B, int C, int Cq, int tile, int n_tiles,
                   int T_pad, int row) {
  __shared__ float inv_row[kQRows];
  const int z = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * kQRows;
  const size_t plane = ((size_t)z * B + b) * T_pad;
  if (threadIdx.x < kQRows && r0 + (int)threadIdx.x < T_pad) {
    const int t = (r0 + threadIdx.x) / tile;
    const int* m = row ? smax + plane + r0 + threadIdx.x : smax + ((size_t)z * B + b) * n_tiles + t;
    const float s = fmaxf(__int_as_float(*m), 1e-12f);
    inv_row[threadIdx.x] = __fdiv_rn(127.f, s);
  }
  __syncthreads();
  const int chunks = Cq / 16;
  for (int i = threadIdx.x; i < kQRows * chunks; i += fk::kThreads) {
    const int r = i / chunks;
    const int cc = (i - r * chunks) * 16;
    if (r0 + r >= T_pad) break;
    const size_t row = plane + r0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (cc < C) {
      const float inv = inv_row[r];
      const float* src = c + row * Cq + cc;
      int q[16];
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src + k));
        q[k] = cc + k < C ? fk::quant_s8(f.x, inv) : 0;
        q[k + 1] = cc + k + 1 < C ? fk::quant_s8(f.y, inv) : 0;
        q[k + 2] = cc + k + 2 < C ? fk::quant_s8(f.z, inv) : 0;
        q[k + 3] = cc + k + 3 < C ? fk::quant_s8(f.w, inv) : 0;
      }
      v = make_int4(fk::pack_s8(q[0], q[1], q[2], q[3]), fk::pack_s8(q[4], q[5], q[6], q[7]),
                    fk::pack_s8(q[8], q[9], q[10], q[11]), fk::pack_s8(q[12], q[13], q[14], q[15]));
    }
    *reinterpret_cast<int4*>(qc + row * Cq + cc) = v;
  }
}

struct OutArgs {
  CUtensorMap amap;  // the quantized inputs qc (Cq, T_pad, NACC * B)
  CUtensorMap bmap;  // the weights (Kf, C, NACC): K8e's Wt (0) and Wb (1), K8a's W1
  const int* len;
  const float* x;
  const int* smax;     // (NACC, B, n_tiles); the row forms' (NACC, B, T_pad)
  const float* sw[2];  // K8e's swt, swb; K8a's sw1
  const float* bias;   // K8e's bf; K8a's b1
  float* y;
  float* gmax;  // (B, T_pad / 8), zeros: each 8-row group's max |out|
  int B, T, C, kseg, tile, n_tiles, T_pad, jt, ln;
};

// Passes F (K8e, NACC = 2) and B (K8a, NACC = 1), persistent: item (row
// block, column block, video b), out on rows [r0, r0 + 128) of tile t, 128
// columns from n0.  K8e: h = fma(h1, s1 * swt, h2 * (s2 * swb)), out =
// relu(h + bf) + x; K8a: out = fma(acc, s_a * sw1, b1) + x (before its
// LayerNorm when ln: pass N then takes the group maxima).  ROW: the row
// forms' scales, one a row and accumulator (K8e: h = fma(h1 s1, swt, (h2 s2)
// swb); K8a: fma(acc s_a, sw1, b1)), and no group maxima.
template <int NACC, bool ROW = false>
__global__ void __launch_bounds__(tc8::kThreads, 1)
    q8_out_kernel(const __grid_constant__ OutArgs p) {
  constexpr int BN = kOutBN;
  constexpr int JB = 8;  // column groups whose residual loads go out together
  extern __shared__ float4 smem_raw[];
  // the columns' first scale (s1 * swt or s_a * sw1), second (s2 * swb) and bias
  __shared__ float col_t[BN], col_w[BN], col_f[BN];
  uint8_t* sm = tc::align1024<uint8_t>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = p.n_tiles * p.jt;
  const int ncol = ceil_div(p.C, BN);
  const int items = rows * ncol * p.B;
  const int kbs = ceil_div(p.kseg, tc8::kKB);
  auto decode = [&](int i, int& t, int& j, int& n0, int& b, int& r0, int& lim, int& nk) {
    const int rb = i / ncol;
    n0 = (i - rb * ncol) * BN;
    b = rb / rows;
    const int r = rb - b * rows;
    t = r / p.jt;
    j = r - t * p.jt;
    r0 = t * p.tile + j * tc8::kBM;
    lim = min(p.len[b], p.T);
    nk = r0 >= lim ? 0 : NACC * kbs;  // every row masked: zeros, no product
  };
  uint64_t* full = tc8::ring_init<BN>(sm);
  __syncthreads();
  int g = 0;
  if (warp < 4) {
    tc::setmaxnreg_dec<40>();
    if (tid == 0)
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        int t, j, n0, b, r0, lim, nk;
        decode(i, t, j, n0, b, r0, lim, nk);
        tc8::produce<BN>(sm, full, g, nk, [&](int kc, uint8_t* a, uint8_t* w, uint64_t* bar) {
          const int half = kc / kbs, kb = (kc - half * kbs) * tc8::kKB;
          tc::tma_load_3d(a, &p.amap, bar, kb, r0, half * p.B + b);
          tc::tma_load_3d(w, &p.bmap, bar, kb, n0, half);
        });
      }
    return;
  }
  tc::setmaxnreg_inc<232>();
  const int wg = (warp >> 2) - 1;
  const int ct = tid - 128;
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const bool pair = (p.C & 1) == 0;  // float2 access to x and y
  int acc[NACC][BN / 2];
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int t, j, n0, b, r0, lim, nk;
    decode(i, t, j, n0, b, r0, lim, nk);
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) acc[a][k] = 0;
    tc8::consume<BN, NACC>(acc, sm, full, g, nk, wg, [&](int kc) {
      const int half = kc / kbs, kb = (kc - half * kbs) * tc8::kKB;
      return half * 8 + min(4, (p.kseg - kb) / 32);
    });
    if (ct < BN) {
      const int n = n0 + ct;
      if constexpr (ROW) {
        col_t[ct] = n < p.C ? __ldg(p.sw[0] + n) : 0.f;
        if constexpr (NACC == 2) col_w[ct] = n < p.C ? __ldg(p.sw[1] + n) : 0.f;
      } else {
        const float s1 = fmaxf(__int_as_float(p.smax[(size_t)b * p.n_tiles + t]), 1e-12f);
        col_t[ct] = n < p.C ? __fmul_rn(s1, __ldg(p.sw[0] + n)) : 0.f;
        if constexpr (NACC == 2) {
          const float s2 =
              fmaxf(__int_as_float(p.smax[((size_t)p.B + b) * p.n_tiles + t]), 1e-12f);
          col_w[ct] = n < p.C ? __fmul_rn(s2, __ldg(p.sw[1] + n)) : 0.f;
        }
      }
      col_f[ct] = n < p.C ? __ldg(p.bias + n) : 0.f;
    }
    float rs[NACC][2];  // ROW: the rows' scales of each accumulator
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = j * tc8::kBM + rw + 8 * h;
        rs[a][h] = ROW && rt < p.tile
                       ? fmaxf(__int_as_float(p.smax[((size_t)a * p.B + b) * p.T_pad +
                                                     t * p.tile + rt]),
                               1e-12f)
                       : 0.f;
      }
    tc::bar_sync(1, 256);
    float gm[2] = {0.f, 0.f};
#pragma unroll
    for (int jb = 0; jb < BN / 8; jb += JB) {
      // the residual of JB column groups and both rows, loaded ahead of their use
      float2 xv[JB][2];
#pragma unroll
      for (int u = 0; u < JB; ++u) {
        const int n = n0 + 8 * (jb + u) + cq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = j * tc8::kBM + rw + 8 * h;
          const int row = t * p.tile + rt;
          xv[u][h] = make_float2(0.f, 0.f);
          if (n < p.C && rt < p.tile && row < lim) {
            const float* xp = p.x + ((size_t)b * p.T + row) * p.C + n;
            if (pair)
              xv[u][h] = __ldg(reinterpret_cast<const float2*>(xp));
            else
              xv[u][h] = make_float2(__ldg(xp), n + 1 < p.C ? __ldg(xp + 1) : 0.f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < JB; ++u) {
        const int jj = jb + u;
        const int cl = 8 * jj + cq;
        const int n = n0 + cl;
        if (n >= p.C) continue;
        const bool n1 = n + 1 < p.C;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = j * tc8::kBM + rw + 8 * h;
          const int row = t * p.tile + rt;
          if (rt >= p.tile || row >= p.T) continue;
          float o0 = 0.f, o1 = 0.f;
          if (row < lim) {
            const int k = 4 * jj + 2 * h;
            if constexpr (ROW && NACC == 2) {
              // h = fma(h1 s1, swt, (h2 s2) swb); out = relu(h + bf) + x
              const float v0 = __fadd_rn(
                  __fmaf_rn(__fmul_rn(__int2float_rn(acc[0][k]), rs[0][h]), col_t[cl],
                            __fmul_rn(__fmul_rn(__int2float_rn(acc[1][k]), rs[1][h]), col_w[cl])),
                  col_f[cl]);
              const float v1 = __fadd_rn(
                  __fmaf_rn(__fmul_rn(__int2float_rn(acc[0][k + 1]), rs[0][h]), col_t[cl + 1],
                            __fmul_rn(__fmul_rn(__int2float_rn(acc[1][k + 1]), rs[1][h]),
                                      col_w[cl + 1])),
                  col_f[cl + 1]);
              o0 = __fadd_rn(v0 > 0.f ? v0 : 0.f, xv[u][h].x);
              o1 = __fadd_rn(v1 > 0.f ? v1 : 0.f, xv[u][h].y);
            } else if constexpr (ROW) {
              // out = fma(acc s_a, sw1, b1) + x
              o0 = __fadd_rn(__fmaf_rn(__fmul_rn(__int2float_rn(acc[0][k]), rs[0][h]),
                                       col_t[cl], col_f[cl]),
                             xv[u][h].x);
              o1 = __fadd_rn(__fmaf_rn(__fmul_rn(__int2float_rn(acc[0][k + 1]), rs[0][h]),
                                       col_t[cl + 1], col_f[cl + 1]),
                             xv[u][h].y);
            } else if constexpr (NACC == 2) {
              // h = fma(h1, s1 * swt, h2 * (s2 * swb)); out = relu(h + bf) + x
              const float v0 = __fadd_rn(
                  __fmaf_rn(__int2float_rn(acc[0][k]), col_t[cl],
                            __fmul_rn(__int2float_rn(acc[1][k]), col_w[cl])),
                  col_f[cl]);
              const float v1 = __fadd_rn(
                  __fmaf_rn(__int2float_rn(acc[0][k + 1]), col_t[cl + 1],
                            __fmul_rn(__int2float_rn(acc[1][k + 1]), col_w[cl + 1])),
                  col_f[cl + 1]);
              o0 = __fadd_rn(v0 > 0.f ? v0 : 0.f, xv[u][h].x);
              o1 = __fadd_rn(v1 > 0.f ? v1 : 0.f, xv[u][h].y);
            } else {
              // out = fma(acc, s_a * sw1, b1) + x
              o0 = __fadd_rn(__fmaf_rn(__int2float_rn(acc[0][k]), col_t[cl], col_f[cl]),
                             xv[u][h].x);
              o1 = __fadd_rn(
                  __fmaf_rn(__int2float_rn(acc[0][k + 1]), col_t[cl + 1], col_f[cl + 1]),
                  xv[u][h].y);
            }
          }
          float* yp = p.y + ((size_t)b * p.T + row) * p.C + n;
          if (pair) {
            *reinterpret_cast<float2*>(yp) = make_float2(o0, o1);
          } else {
            yp[0] = o0;
            if (n1) yp[1] = o1;
          }
          gm[h] = fmaxf(gm[h], fabsf(o0));
          if (n1) gm[h] = fmaxf(gm[h], fabsf(o1));
        }
      }
    }
    // a warp's rows of one h are one 8-row group (the tile and 128 are
    // multiples of 8); the groups' maxima over the columns of every item
    if (!ROW && !p.ln) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m = fk::warp_max(gm[h]);
        const int rt = j * tc8::kBM + wg * 64 + (warp & 3) * 16 + 8 * h;
        const int row = t * p.tile + rt;
        if (lane == 0 && m > 0.f && rt < p.tile && row < p.T)
          atomicMax(reinterpret_cast<int*>(p.gmax) + (size_t)b * (p.T_pad / 8) + row / 8,
                    __float_as_int(m));
      }
    }
    tc::bar_sync(1, 256);  // col_t, col_w and col_f are free for the next item
  }
}

// Pass N (K8a's LayerNorm): rows [8 g, 8 g + 8) of video b normalized in
// place, a warp a row, in two passes with 1 / sqrt correctly rounded (the
// plain version rounds alike), and the group's max |out| into gmax (B,
// T_pad / 8; null in the row form): the next layer's window maxima.  Rows
// past the video stay 0.
__global__ void __launch_bounds__(fk::kThreads)
q8a_ln_kernel(float* __restrict__ y, const int* __restrict__ len, const float* __restrict__ gamma,
              const float* __restrict__ beta, float eps, float* __restrict__ gmax, int T, int C,
              int G) {
  __shared__ float wm[fk::kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gi = blockIdx.x, b = blockIdx.y;
  const int row = gi * 8 + w;
  float m = 0.f;
  if (row < min(len[b], T)) {
    float* o = y + ((size_t)b * T + row) * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum = __fadd_rn(sum, o[c]);
    const float mean = __fdiv_rn(fk::warp_sum(sum), (float)C);
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = __fsub_rn(o[c], mean);
      var = __fadd_rn(var, __fmul_rn(dv, dv));
    }
    const float inv =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(fk::warp_sum(var), (float)C), eps)));
    for (int c = lane; c < C; c += 32) {
      const float v =
          __fmaf_rn(__fmul_rn(__fsub_rn(o[c], mean), inv), __ldg(gamma + c), __ldg(beta + c));
      o[c] = v;
      m = fmaxf(m, fabsf(v));
    }
  }
  m = fk::warp_max(m);
  if (lane == 0) wm[w] = m;
  __syncthreads();
  if (threadIdx.x == 0 && gmax != nullptr) {
    float mm = 0.f;
    for (int i = 0; i < fk::kWarps; ++i) mm = fmaxf(mm, wm[i]);
    gmax[(size_t)b * G + gi] = mm;
  }
}

template <class Kernel, class Args>
cudaError_t launch_tc8(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  const cudaError_t err = fk::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tc8::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The shapes a layer's launches take (both towers)
struct Layout {
  int B, T, C, Cw, halo, tile, n_tiles, T_pad;
  int kseg() const { return (C + 31) / 32 * 32; }
  int jt() const { return ceil_div(tile, tc8::kBM); }  // blocks of 128 rows in a tile
  bool ok(int Kc, int Kf, int dmax) const {
    return tile >= 8 && tile % 8 == 0 && T_pad % tile == 0 && halo % 8 == 0 && halo >= dmax &&
           Cw % 16 == 0 && Cw >= C && Cw >= tc8::kKB && Kc >= 3 * kseg() && Kc % 16 == 0 &&
           Kc >= tc8::kKB && Kf >= kseg() && Kf % 16 == 0 && Kf >= tc8::kKB;
  }
};

// Passes W, A and Q: the windows quantized once, the nconv convs (relu'd
// when relu) with their tiles' maxima, and c quantized into qc
cudaError_t conv_passes(const Layout& l, const float* x, const int* len, const float* gmax_in,
                        const int8_t* kpack, int Kc, const float* const* sk,
                        const float* const* bias, const int* d, int nconv, int relu,
                        int8_t* qwin, float* sx, float* c, int8_t* qc, int* smax,
                        cudaStream_t st) {
  const int wrows = l.tile + 2 * l.halo;
  const int jt = l.jt();
  q8e_window_kernel<<<dim3(ceil_div(wrows, kWinRows), l.n_tiles, l.B), fk::kThreads, 0, st>>>(
      x, len, gmax_in, qwin, sx, l.T, l.C, l.Cw, l.halo, l.tile, l.n_tiles, l.T_pad, wrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ConvArgs a;
  memset(&a, 0, sizeof(a));
  // 256 columns a block where that still gives the card a full wave
  const bool wide = l.C > 128 && l.n_tiles * jt * l.B * nconv * ceil_div(l.C, 256) >= 132;
  const int bn = wide ? 256 : 128;
  if (!tc8::encode_3d_s8(&a.amap, qwin, l.Cw, wrows, (long long)l.B * l.n_tiles, tc8::kBM) ||
      !tc8::encode_3d_s8(&a.bmap, kpack, Kc, l.C, nconv, bn))
    return cudaErrorInvalidValue;
  a.len = len;
  a.sx = sx;
  for (int z = 0; z < nconv; ++z) {
    a.sk[z] = sk[z];
    a.bias[z] = bias[z];
    a.d[z] = d[z];
  }
  a.c = c;
  a.smax = smax;
  a.B = l.B;
  a.C = l.C;
  a.Cq = l.Cw;
  a.kseg = l.kseg();
  a.halo = l.halo;
  a.tile = l.tile;
  a.n_tiles = l.n_tiles;
  a.T_pad = l.T_pad;
  a.jt = jt;
  a.ncol = ceil_div(l.C, bn);
  a.nconv = nconv;
  a.relu = relu;
  const dim3 agrid(tc8::persistent_blocks(l.n_tiles * jt * nconv * a.ncol * l.B));
  err = wide ? launch_tc8(q8e_conv_kernel<256>, agrid, tc8::Ring<256>::kBytes, st, a)
             : launch_tc8(q8e_conv_kernel<128>, agrid, tc8::Ring<128>::kBytes, st, a);
  if (err != cudaSuccess) return err;

  q8e_quant_c_kernel<<<dim3(ceil_div(l.T_pad, kQRows), nconv, l.B), fk::kThreads, 0, st>>>(
      c, smax, qc, l.B, l.C, l.Cw, l.tile, l.n_tiles, l.T_pad, 0);
  return cudaGetLastError();
}

// Pass F (NACC = 2) or B (NACC = 1) on qc
template <int NACC, bool ROW = false>
cudaError_t out_pass(const Layout& l, const int8_t* qc, const int8_t* wpack, int Kf,
                     const int* len, const float* x, const int* smax, const float* sw0,
                     const float* sw1, const float* bias, int ln, float* y, float* gmax_out,
                     cudaStream_t st) {
  OutArgs f;
  memset(&f, 0, sizeof(f));
  if (!tc8::encode_3d_s8(&f.amap, qc, l.Cw, l.T_pad, (long long)NACC * l.B, tc8::kBM) ||
      !tc8::encode_3d_s8(&f.bmap, wpack, Kf, l.C, NACC, kOutBN))
    return cudaErrorInvalidValue;
  f.len = len;
  f.x = x;
  f.smax = smax;
  f.sw[0] = sw0;
  f.sw[1] = sw1;
  f.bias = bias;
  f.y = y;
  f.gmax = gmax_out;
  f.B = l.B;
  f.T = l.T;
  f.C = l.C;
  f.kseg = l.kseg();
  f.tile = l.tile;
  f.n_tiles = l.n_tiles;
  f.T_pad = l.T_pad;
  f.jt = l.jt();
  f.ln = ln;
  const dim3 grid(tc8::persistent_blocks(l.n_tiles * l.jt() * ceil_div(l.C, kOutBN) * l.B));
  return launch_tc8(q8_out_kernel<NACC, ROW>, grid, tc8::Ring<kOutBN>::kBytes, st, f);
}

// The row forms' passes R, A and Q: the rows quantized once, the nconv
// convs (relu'd when relu) with their rows' maxima, and c quantized into qc
cudaError_t row_conv_passes(const Layout& l, const float* x, const int* len, const int8_t* kpack,
                            int Kc, const float* const* sk, const float* const* bias,
                            const int* d, int nconv, int relu, int8_t* qrow, float* srow,
                            float* c, int8_t* qc, int* rmax, cudaStream_t st) {
  const int H = l.halo;
  q8r_rows_kernel<<<ceil_div(l.B * l.T_pad, fk::kWarps), fk::kThreads, 0, st>>>(
      x, len, qrow, srow, l.B, l.T, l.C, l.Cw, H, l.T_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  RowConvArgs a;
  memset(&a, 0, sizeof(a));
  if (!tc8::encode_3d_s8(&a.amap, qrow, l.Cw, l.T_pad + 2 * H, l.B, tc8::kBM) ||
      !tc8::encode_3d_s8(&a.bmap, kpack, Kc, l.C, nconv, 128))
    return cudaErrorInvalidValue;
  a.len = len;
  a.srow = srow;
  for (int z = 0; z < nconv; ++z) {
    a.sk[z] = sk[z];
    a.bias[z] = bias[z];
    a.d[z] = d[z];
  }
  a.c = c;
  a.rmax = rmax;
  a.B = l.B;
  a.C = l.C;
  a.Cq = l.Cw;
  a.kseg = l.kseg();
  a.H = H;
  a.tile = l.tile;
  a.n_tiles = l.n_tiles;
  a.T_pad = l.T_pad;
  a.jt = l.jt();
  a.ncol = ceil_div(l.C, 128);
  a.nconv = nconv;
  a.relu = relu;
  const dim3 grid(tc8::persistent_blocks(l.n_tiles * a.jt * nconv * a.ncol * l.B));
  err = launch_tc8(q8r_conv_kernel, grid, tc8::Ring<128>::kBytes, st, a);
  if (err != cudaSuccess) return err;
  q8e_quant_c_kernel<<<dim3(ceil_div(l.T_pad, kQRows), nconv, l.B), fk::kThreads, 0, st>>>(
      c, rmax, qc, l.B, l.C, l.Cw, l.tile, l.n_tiles, l.T_pad, 1);
  return cudaGetLastError();
}

}  // namespace

// One int8 MS-TCN++ layer: passes W, A, Q, F.  Buffers (the wrapper's, see
// ops/quant_conv.py::mstcn2_stack_q8): qwin (B, n_tiles, tile + 2 halo, Cw)
// int8, sx (B, n_tiles) f32, c (2, B, T_pad, Cw) f32, qc (2, B, T_pad, Cw)
// int8, smax (2, B, n_tiles) int32 zeros, gmax_out (B, T_pad / 8) zeros;
// gmax_in the layer input's 8-row group maxima (fk_q8_group_max for layer
// 0, the previous layer's pass F after it).  kpack (2, C, Kc) int8: conv z's
// out channel n, tap k's inputs from column k * kseg (zeros past C); fpack
// (2, C, Kf) int8: Wt's (0) and Wb's (1) out channel n (zeros past C).
extern "C" int fk_q8_tower2_layer(const float* x, const int* len, const float* gmax_in,
                                  const int8_t* kpack, int Kc, const float* sk1, const float* b1,
                                  const float* sk2, const float* b2, const int8_t* fpack, int Kf,
                                  const float* swt, const float* swb, const float* bf,
                                  int8_t* qwin, float* sx, float* c, int8_t* qc, int* smax,
                                  float* y, float* gmax_out, int B, int T, int C, int Cw, int d1,
                                  int d2, int halo, int tile, int n_tiles, int T_pad,
                                  void* stream) {
  const Layout l{B, T, C, Cw, halo, tile, n_tiles, T_pad};
  if (!l.ok(Kc, Kf, max(d1, d2))) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sk[2] = {sk1, sk2};
  const float* bias[2] = {b1, b2};
  const int d[2] = {d1, d2};
  cudaError_t err =
      conv_passes(l, x, len, gmax_in, kpack, Kc, sk, bias, d, 2, 0, qwin, sx, c, qc, smax, st);
  if (err != cudaSuccess) return (int)err;
  return (int)out_pass<2>(l, qc, fpack, Kf, len, x, smax, swt, swb, bf, 0, y, gmax_out, st);
}

// One int8 MSTCN layer: passes W, A, Q, B (and N with the LayerNorm).
// Buffers as fk_q8_tower2_layer's with one conv: qwin (B, n_tiles, tile + 2
// halo, Cw), sx (B, n_tiles), a (B, T_pad, Cw) f32, qa (B, T_pad, Cw) int8,
// smax (B, n_tiles) int32 zeros, gmax_out (B, T_pad / 8) zeros.  kpack (C,
// Kc) int8: out channel n, tap k's inputs from column k * kseg; wpack (C,
// Kw) int8: W1's out channel n (zeros past C in both).
extern "C" int fk_q8_tower_layer(const float* x, const int* len, const float* gmax_in,
                                 const int8_t* kpack, int Kc, const float* swd, const float* bd,
                                 const int8_t* wpack, int Kw, const float* sw1, const float* b1,
                                 const float* gamma, const float* beta, int use_ln, float eps,
                                 int8_t* qwin, float* sx, float* a, int8_t* qa, int* smax,
                                 float* y, float* gmax_out, int B, int T, int C, int Cw, int d,
                                 int halo, int tile, int n_tiles, int T_pad, void* stream) {
  const Layout l{B, T, C, Cw, halo, tile, n_tiles, T_pad};
  if (!l.ok(Kc, Kw, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sk[2] = {swd, nullptr};
  const float* bias[2] = {bd, nullptr};
  const int dd[2] = {d, 0};
  cudaError_t err =
      conv_passes(l, x, len, gmax_in, kpack, Kc, sk, bias, dd, 1, 1, qwin, sx, a, qa, smax, st);
  if (err != cudaSuccess) return (int)err;
  err = out_pass<1>(l, qa, wpack, Kw, len, x, smax, sw1, nullptr, b1, use_ln, y, gmax_out, st);
  if (err != cudaSuccess || !use_ln) return (int)err;
  q8a_ln_kernel<<<dim3(ceil_div(T, 8), B), fk::kThreads, 0, st>>>(y, len, gamma, beta, eps,
                                                                 gmax_out, T, C, T_pad / 8);
  return (int)cudaGetLastError();
}

// One int8 MS-TCN++ layer in the row form: passes R, A, Q, F.  Buffers (the
// wrapper's, see ops/quant_conv.py::_mstcn2_q8_row_card): qrow (B, H + T_pad
// + H, Cw) int8 and srow (B, H + T_pad + H) f32, zeros in the halos of H >=
// max(d1, d2) rows; c (2, B, T_pad, Cw) f32, qc (2, B, T_pad, Cw) int8, rmax
// (2, B, T_pad) int32 zeros.  kpack and fpack as fk_q8_tower2_layer's; sk1
// and sk2 (3, C), each tap's scales.
extern "C" int fk_q8_tower2_row_layer(const float* x, const int* len, const int8_t* kpack, int Kc,
                                      const float* sk1, const float* b1, const float* sk2,
                                      const float* b2, const int8_t* fpack, int Kf,
                                      const float* swt, const float* swb, const float* bf,
                                      int8_t* qrow, float* srow, float* c, int8_t* qc, int* rmax,
                                      float* y, int B, int T, int C, int Cw, int d1, int d2, int H,
                                      int tile, int n_tiles, int T_pad, void* stream) {
  const Layout l{B, T, C, Cw, H, tile, n_tiles, T_pad};
  if (!l.ok(Kc, Kf, max(d1, d2))) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sk[2] = {sk1, sk2};
  const float* bias[2] = {b1, b2};
  const int d[2] = {d1, d2};
  cudaError_t err =
      row_conv_passes(l, x, len, kpack, Kc, sk, bias, d, 2, 0, qrow, srow, c, qc, rmax, st);
  if (err != cudaSuccess) return (int)err;
  return (int)out_pass<2, true>(l, qc, fpack, Kf, len, x, rmax, swt, swb, bf, 0, y, nullptr, st);
}

// One int8 MSTCN layer in the row form: passes R, A, Q, B (and N with the
// LayerNorm).  Buffers as fk_q8_tower2_row_layer's with one conv: a (B,
// T_pad, Cw) f32, qa (B, T_pad, Cw) int8, rmax (B, T_pad) int32 zeros; swd
// (3, C), each tap's scales.
extern "C" int fk_q8_tower_row_layer(const float* x, const int* len, const int8_t* kpack, int Kc,
                                     const float* swd, const float* bd, const int8_t* wpack, int Kw,
                                     const float* sw1, const float* b1, const float* gamma,
                                     const float* beta, int use_ln, float eps, int8_t* qrow,
                                     float* srow, float* a, int8_t* qa, int* rmax, float* y, int B,
                                     int T, int C, int Cw, int d, int H, int tile, int n_tiles,
                                     int T_pad, void* stream) {
  const Layout l{B, T, C, Cw, H, tile, n_tiles, T_pad};
  if (!l.ok(Kc, Kw, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sk[2] = {swd, nullptr};
  const float* bias[2] = {bd, nullptr};
  const int dd[2] = {d, 0};
  cudaError_t err =
      row_conv_passes(l, x, len, kpack, Kc, sk, bias, dd, 1, 1, qrow, srow, a, qa, rmax, st);
  if (err != cudaSuccess) return (int)err;
  err = out_pass<1, true>(l, qa, wpack, Kw, len, x, rmax, sw1, nullptr, b1, use_ln, y, nullptr,
                          st);
  if (err != cudaSuccess || !use_ln) return (int)err;
  q8a_ln_kernel<<<dim3(ceil_div(T, 8), B), fk::kThreads, 0, st>>>(y, len, gamma, beta, eps,
                                                                 nullptr, T, C, T_pad / 8);
  return (int)cudaGetLastError();
}
