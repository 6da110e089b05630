// K8d's int8 K / V projection, on tc_int8.cuh's int8 wgmma core: the SCA
// cross-attention with int8 key / value projections, whose attention is
// K3's (mha_attn.cu's fk_k3_attn); K8c projects its keys on it too.
//
// Replaces, with K3's attention, fact_clip_tpu/ops/pallas/quant_conv.py::
// mha_cross_attention_q8 (_mha_kernel_q8): per frame row
//   K = fma(idot(q(x + pos), qWk) * s_k, swk, bk)
//   V = fma(idot(q(x), qWv) * s_v, swv, bv)
// with q() JAX's per-row quantizer (s the row's absmax, floored at 1e-12)
// and per-output-channel folded weight scales (ops/quant_conv.py::_proj_q8:
// the product by the row scale rounded, then one fused multiply-add), then
// f32 softmax attention of the pre-scaled queries over the keys below x_len
// (-1e9 at or past it).  The TPU kernel projects each key tile inside its
// attention loop; a block of the port's first int8 twin did the same per
// (key tile, video) and re-read both weights in every block.  Here the work
// splits as K3's does (PR 11's design):
//   rows: a warp a frame row reads x and its positional term once and
//     writes q(x + pos) and q(x) (2, B, X, Cw) int8 (zeros past C) and their
//     scales (2, B, X);
//   projection: one persistent launch of two problems, the K columns on
//     q(x + pos) and the V columns on q(x): items (128 frames, BN columns of
//     one problem, video), the frames' int8 rows and the weights' rows as
//     TMA boxes through the ring, the dequantization above in the epilogue,
//     written into K3's (B, X, 2E) layout.  Rows at or past a video's
//     attended length (x_len, or X for x_len = 0, as
//     ops/mha_attn.py::attended_lengths) are zeros and a block of them runs
//     no product;
//   attention: mha_attn.cu's fk_k3_attn with the queries pre-scaled by
//     1 / sqrt(hd) (the wrapper, ops/quant_conv.py) and scale 1, no
//     dropout, no stats.
// One library call, fk_q8_mha_cross, makes the four launches into buffers
// the wrapper lays out in one workspace: a call's host time, not its
// device time, bounded the three-call form at the flagship's shape.
// Int32 sums are exact, so the projection equals the plain version's bit for
// bit; the attention differs from the plain softmax by summation order.
//
// K8c (flash_attn.cu's fk_x2y_flash_q8_fwd) takes the rows and the
// projection as they are (fk::q8_rows_kv_proj, at one head: E = d) and
// feeds K2's flash attention.  K8b (x2y_attn.cu's fk_x2y_sx_q8_fwd) takes
// the same two launches for its query side (fk::q8_rows_proj): the rows
// quantizer in its one-output form, q(y + y_pos), and the projection as one
// problem over every query row.
//
// Bound on the H100 (chip_smoke.py::k8d_case): the int8 products, 4 * Xv *
// Cx * E operations over the valid keys Xv (12.9 G at the flagship's B=8,
// X=3072, Cx=512, E=256: 0.007 ms at 1,979 TOPS), the f32 attention, 4 * M *
// E * Xv, and the bytes of x, its positional term and the weights read once
// and the output written.  This design's own traffic: x (and pos) read once
// (4-8 bytes a frame and channel), both int8 rows written and read back
// from L2 (4), and K / V written in f32 and read by the attention (2 x 8
// bytes a frame and output channel): ~150 MB at the flagship, 0.045 ms.
#include <math.h>
#include <string.h>

#include "common.cuh"
#include "quant.cuh"
#include "tc_int8.cuh"

namespace {

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// q(x + pos) into qx[0] and, with TWO, q(x) into qx[1] (row stride Cw,
// zeros past C), their scales into sx[0] and sx[1]; one warp a row of the B x
// N rows.  With vec (C and P multiples of 4) each lane takes four channels
// at a time.  K8d takes both (its K and V), K8b the first (its queries).
template <bool TWO>
__global__ void __launch_bounds__(fk::kThreads)
q8_rows_kv_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                  long long pos_bstride, int P, int N, int C, int Cw, int rows, int vec,
                  int8_t* __restrict__ qx, float* __restrict__ sx) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * fk::kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int b = row / N;
  const float* xr = x + (size_t)row * C;
  const float* pr = pos ? pos + (size_t)b * pos_bstride + (size_t)(row - b * N) * P : nullptr;
  const int pw = pr != nullptr ? P : 0;  // channels that take the positional term
  int8_t* qk = qx + (size_t)row * Cw;
  int8_t* qv = qx + ((size_t)rows + row) * Cw;
  float mk = 0.f, mv = 0.f;
  if (vec) {
    for (int c = 4 * lane; c < C; c += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
      float4 k = v;
      if (c < pw) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(pr + c));
        k = make_float4(__fadd_rn(v.x, p.x), __fadd_rn(v.y, p.y), __fadd_rn(v.z, p.z),
                        __fadd_rn(v.w, p.w));
      }
      mk = fmaxf(mk, fmaxf(fmaxf(fabsf(k.x), fabsf(k.y)), fmaxf(fabsf(k.z), fabsf(k.w))));
      mv = fmaxf(mv, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = __ldg(xr + c);
      mk = fmaxf(mk, fabsf(c < pw ? __fadd_rn(v, __ldg(pr + c)) : v));
      mv = fmaxf(mv, fabsf(v));
    }
  }
  const float sk = fmaxf(fk::warp_max(mk), 1e-12f), sv = fmaxf(fk::warp_max(mv), 1e-12f);
  const float ik = __fdiv_rn(127.f, sk), iv = __fdiv_rn(127.f, sv);
  if (vec) {
    for (int c = 4 * lane; c < Cw; c += 128) {
      int wk = 0, wv = 0;
      if (c < C) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
        float4 k = v;
        if (c < pw) {
          const float4 p = __ldg(reinterpret_cast<const float4*>(pr + c));
          k = make_float4(__fadd_rn(v.x, p.x), __fadd_rn(v.y, p.y), __fadd_rn(v.z, p.z),
                          __fadd_rn(v.w, p.w));
        }
        wk = fk::pack_s8(fk::quant_s8(k.x, ik), fk::quant_s8(k.y, ik), fk::quant_s8(k.z, ik),
                         fk::quant_s8(k.w, ik));
        wv = fk::pack_s8(fk::quant_s8(v.x, iv), fk::quant_s8(v.y, iv), fk::quant_s8(v.z, iv),
                         fk::quant_s8(v.w, iv));
      }
      *reinterpret_cast<int*>(qk + c) = wk;
      if (TWO) *reinterpret_cast<int*>(qv + c) = wv;
    }
  } else {
    for (int c = lane; c < Cw; c += 32) {
      int8_t a = 0, e = 0;
      if (c < C) {
        const float v = __ldg(xr + c);
        a = (int8_t)fk::quant_s8(c < pw ? __fadd_rn(v, __ldg(pr + c)) : v, ik);
        e = (int8_t)fk::quant_s8(v, iv);
      }
      qk[c] = a;
      if (TWO) qv[c] = e;
    }
  }
  if (lane == 0) {
    sx[row] = sk;
    if (TWO) sx[rows + row] = sv;
  }
}

struct KVArgs {
  CUtensorMap amap;  // the int8 rows (Cw, X, nprob B): problem z's rows of video b at z B + b
  CUtensorMap bmap;  // the weights (Kw, nprob E, 1): problem z's at rows z E, zeros past Cx
  const int* xlen;   // (B,) the valid rows, a video of none all X; null: every row
  const float* sx;   // (nprob, B, X) the rows' scales
  const float* sw[2];
  const float* bias[2];
  float* kv;  // (B, X, ldo): problem z at columns z E
  int B, X, E, kseg, nrb, ncol, nprob, ldo;
};

// The projection, persistent: item (row block, column block, problem z,
// video b), the column blocks and the problems of a row block side by side
// (they read the same rows).  Problem z's columns [n0, n0 + BN) of rows
// [r0, r0 + 128) into kv's columns z E + n: K8d's K (z = 0) and V (z = 1)
// into K3's (B, X, 2E) layout, K8b's queries (one problem, every row valid).
template <int BN>
__global__ void __launch_bounds__(tc8::kThreads, 1)
    q8_kv_kernel(const __grid_constant__ KVArgs p) {
  extern __shared__ float4 smem_raw[];
  __shared__ float col_s[BN], col_b[BN];  // the item's columns' weight scales and biases
  uint8_t* sm = tc::align1024<uint8_t>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_rb = p.nprob * p.ncol;
  const int items = p.nrb * per_rb * p.B;
  const int kbs = ceil_div(p.kseg, tc8::kKB);
  auto decode = [&](int i, int& n0, int& z, int& b, int& r0, int& lim, int& nk) {
    const int col = i % per_rb;
    const int rb = i / per_rb;
    b = rb / p.nrb;
    r0 = (rb - b * p.nrb) * tc8::kBM;
    z = col / p.ncol;
    n0 = (col - z * p.ncol) * BN;
    // the attended length
    lim = p.xlen != nullptr && p.xlen[b] > 0 ? min(p.xlen[b], p.X) : p.X;
    nk = r0 >= lim ? 0 : kbs;  // every frame past it: zeros
  };
  uint64_t* full = tc8::ring_init<BN>(sm);
  __syncthreads();
  int g = 0;
  if (warp < 4) {
    tc::setmaxnreg_dec<40>();
    if (tid == 0)
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        int n0, z, b, r0, lim, nk;
        decode(i, n0, z, b, r0, lim, nk);
        tc8::produce<BN>(sm, full, g, nk, [&](int kc, uint8_t* a, uint8_t* w, uint64_t* bar) {
          tc::tma_load_3d(a, &p.amap, bar, kc * tc8::kKB, r0, z * p.B + b);
          tc::tma_load_3d(w, &p.bmap, bar, kc * tc8::kKB, z * p.E + n0, 0);
        });
      }
    return;
  }
  tc::setmaxnreg_inc<232>();
  const int wg = (warp >> 2) - 1;
  const int ct = tid - 128;
  // register 4jj + 2h + e holds frame r0 + rw + 8h, column n0 + 8jj + cq + e
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int acc[1][BN / 2];
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int n0, z, b, r0, lim, nk;
    decode(i, n0, z, b, r0, lim, nk);
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[0][k] = 0;
    tc8::consume<BN, 1>(acc, sm, full, g, nk, wg, [&](int kc) {
      return min(4, (p.kseg - kc * tc8::kKB) / 32);
    });
    for (int c = ct; c < BN; c += 256) {
      const int n = n0 + c;
      col_s[c] = n < p.E ? __ldg(p.sw[z] + n) : 0.f;
      col_b[c] = n < p.E ? __ldg(p.bias[z] + n) : 0.f;
    }
    tc::bar_sync(1, 256);
    float sr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + rw + 8 * h;
      sr[h] = row < lim ? p.sx[((size_t)z * p.B + b) * p.X + row] : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int cl = 8 * jj + cq;
      const int n = n0 + cl;
      if (n >= p.E) continue;  // E is even: column n + 1 is K's or V's too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + rw + 8 * h;
        if (row >= p.X) continue;
        float2 v = make_float2(0.f, 0.f);
        if (row < lim) {
          // fma(idot * s_row, sw, b), as ops/quant_conv.py::_proj_q8
          v.x = __fmaf_rn(__fmul_rn(__int2float_rn(acc[0][4 * jj + 2 * h]), sr[h]), col_s[cl],
                          col_b[cl]);
          v.y = __fmaf_rn(__fmul_rn(__int2float_rn(acc[0][4 * jj + 2 * h + 1]), sr[h]),
                          col_s[cl + 1], col_b[cl + 1]);
        }
        *reinterpret_cast<float2*>(p.kv + ((size_t)b * p.X + row) * p.ldo + z * p.E + n) = v;
      }
    }
    tc::bar_sync(1, 256);  // col_s and col_b are free for the next item
  }
}

template <class Kernel>
cudaError_t launch_tc8(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, const KVArgs& a) {
  const cudaError_t err = fk::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tc8::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// the projection's persistent launch, bn (128 or 256) columns an item
cudaError_t launch_proj(const KVArgs& a, int bn, cudaStream_t st) {
  const dim3 grid(tc8::persistent_blocks(a.nrb * a.nprob * a.ncol * a.B));
  return bn == 256 ? launch_tc8(q8_kv_kernel<256>, grid, tc8::Ring<256>::kBytes, st, a)
                   : launch_tc8(q8_kv_kernel<128>, grid, tc8::Ring<128>::kBytes, st, a);
}

}  // namespace

namespace fk {

// K8b's query side (x2y_attn.cu's fk_x2y_sx_q8_fwd): q(y + pos) of the B x N
// rows y (B, N, C) into qy (B, N, Cw) int8 (zeros past C) and sy (B, N), then
// out = fma(idot(q(y + pos), qW) * s_y, sw, bias) (B, N, E), every row, as
// one persistent launch of one problem.  wpack (E, Kw) int8, zeros past C.
int q8_rows_proj(const float* y, const float* pos, long long pos_bstride, int P,
                 const int8_t* wpack, int Kw, const float* sw, const float* bias, int B, int N,
                 int C, int Cw, int E, int8_t* qy, float* sy, float* out, cudaStream_t st) {
  const int kseg = (C + 31) / 32 * 32;
  if (Cw < C || Cw % 16 != 0 || Cw < tc8::kKB || Kw < kseg || Kw % 16 != 0 || Kw < tc8::kKB ||
      E % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = B * N;
  const int vec = C % 4 == 0 && (pos == nullptr || (P % 4 == 0 && pos_bstride % 4 == 0));
  q8_rows_kv_kernel<false><<<ceil_div(rows, fk::kWarps), fk::kThreads, 0, st>>>(
      y, pos, pos_bstride, P, N, C, Cw, rows, vec, qy, sy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  KVArgs a;
  memset(&a, 0, sizeof(a));
  const int bn = E > 128 ? 256 : 128;
  if (!tc8::encode_3d_s8(&a.amap, qy, Cw, N, B, tc8::kBM) ||
      !tc8::encode_3d_s8(&a.bmap, wpack, Kw, E, 1, bn))
    return (int)cudaErrorInvalidValue;
  a.sx = sy;
  a.sw[0] = sw;
  a.bias[0] = bias;
  a.kv = out;
  a.B = B;
  a.X = N;
  a.E = E;
  a.kseg = kseg;
  a.nrb = ceil_div(N, tc8::kBM);
  a.ncol = ceil_div(E, bn);
  a.nprob = 1;
  a.ldo = E;
  return (int)launch_proj(a, bn, st);
}

}  // namespace fk

namespace fk {

// K8d's and K8c's key side: q(x + pos) and q(x) of the B x X rows x (B, X,
// Cx) (the positional term on the leading P channels, batch stride
// pos_bstride; null for none) into qx (2, B, X, Cw) int8 (zeros past Cx)
// and their scales sx (2, B, X), then kv = [K | V] (B, X, 2E): K = fma(idot(
// q(x + pos), qWk) * s, swk, bk) and V = fma(idot(q(x), qWv) * s, swv, bv),
// zeros at rows at or past the attended length, as one persistent launch of
// two problems.  wpack (2E, Kw) int8: Wk's out channel n at row n and Wv's
// at E + n (the quantize_proj weights, zeros past Cx).
int q8_rows_kv_proj(const float* x, const float* pos, long long pos_bstride, int P,
                    const int8_t* wpack, int Kw, const float* swk, const float* bk,
                    const float* swv, const float* bv, const int* xlen, int B, int X, int Cx,
                    int Cw, int E, int8_t* qx, float* sx, float* kv, cudaStream_t st) {
  const int kseg = (Cx + 31) / 32 * 32;
  if (Cw < Cx || Cw % 16 != 0 || Cw < tc8::kKB || Kw < kseg || Kw % 16 != 0 ||
      Kw < tc8::kKB || E % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = B * X;
  const int vec = Cx % 4 == 0 && (pos == nullptr || (P % 4 == 0 && pos_bstride % 4 == 0));
  q8_rows_kv_kernel<true><<<ceil_div(rows, fk::kWarps), fk::kThreads, 0, st>>>(
      x, pos, pos_bstride, P, X, Cx, Cw, rows, vec, qx, sx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  KVArgs a;
  memset(&a, 0, sizeof(a));
  const int bn = E > 128 ? 256 : 128;
  if (!tc8::encode_3d_s8(&a.amap, qx, Cw, X, 2LL * B, tc8::kBM) ||
      !tc8::encode_3d_s8(&a.bmap, wpack, Kw, 2LL * E, 1, bn))
    return (int)cudaErrorInvalidValue;
  a.xlen = xlen;
  a.sx = sx;
  a.sw[0] = swk;
  a.sw[1] = swv;
  a.bias[0] = bk;
  a.bias[1] = bv;
  a.kv = kv;
  a.B = B;
  a.X = X;
  a.E = E;
  a.kseg = kseg;
  a.nrb = ceil_div(X, tc8::kBM);
  a.ncol = ceil_div(E, bn);
  a.nprob = 2;
  a.ldo = 2 * E;
  return (int)launch_proj(a, bn, st);
}

}  // namespace fk

extern "C" int fk_k3_attn(const float* kv, const float* q, const int* xlen, int B, int X, int M,
                          int H, int hd, float scale, float* part_acc, float* part_ml, float* out,
                          float* stats, const int* seed, int drop_stream, unsigned thresh,
                          float drop_scale, void* stream);

// K8d: x (B, X, Cx) with its positional term on the leading P channels
// (batch stride pos_bstride; null for none) and the pre-scaled queries q
// (B, M, H hd) -> out (B, M, H hd).  wpack, swk, bk, swv, bv and the
// buffers qx (2, B, X, Cw) int8, sx (2, B, X) and kv (B, X, 2E) as
// fk::q8_rows_kv_proj's; part_acc (B, n_t, H M, hd) and part_ml (B, n_t,
// H M, 2) over K3's 64-key tiles.
extern "C" int fk_q8_mha_cross(const float* x, const float* pos, long long pos_bstride, int P,
                               const int8_t* wpack, int Kw, const float* swk, const float* bk,
                               const float* swv, const float* bv, const float* q,
                               const int* xlen, int B, int X, int Cx, int Cw, int M, int H,
                               int hd, int8_t* qx, float* sx, float* kv, float* part_acc,
                               float* part_ml, float* out, void* stream) {
  const int err = fk::q8_rows_kv_proj(x, pos, pos_bstride, P, wpack, Kw, swk, bk, swv, bv, xlen,
                                      B, X, Cx, Cw, H * hd, qx, sx, kv, (cudaStream_t)stream);
  if (err) return err;
  return fk_k3_attn(kv, q, xlen, B, X, M, H, hd, 1.f, part_acc, part_ml, out, nullptr, nullptr, 0,
                    0u, 1.f, stream);
}
