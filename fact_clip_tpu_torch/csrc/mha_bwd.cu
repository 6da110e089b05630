// K3 backward: the multi-head cross-attention of the action queries over the
// frame memory (the SCA layers' cross-attention), from the forward's saves.
//
// Replaces fact_clip_tpu/ops/pallas/mha_attn.py::_mha_bwd (_mha_bwd_kernel).
// The TPU kernel walks the key tiles of a video in order, carries dq and the
// weight gradients in VMEM, and works on a lane-masked row expansion of the
// heads (_expand_rows), a workaround for its 128-lane vector unit.  Blocks on
// the H100 run in no order, so this kernel follows csrc/x2y_bwd.cu's flash
// form instead, per head with hd = E / H: one block per (tile of BK keys,
// video), each on its own:
//   K = (x + pos) Wk + bk, V = x Wv + bv         (the tile, recomputed in shared memory)
//   p = exp(q_h.K_h * scale - m) / l             (m, l: the forward's softmax stats;
//                                                 keys at or past x_len at -1e9)
//   dp = g_h.V_h, dl = p * (dp * keep - D) * scale, zero at masked keys, where
//   D = rowsum(g_h * out_h) per (video, head, query) comes from the caller: it
//   equals sum_x (p * keep) * dp, so it is exact under dropout (mha_attn.py:30-37)
//   dq_h = dl K_h (a per-tile partial), dk_h = dl^T q_h, dv_h = (p * keep)^T g_h
//   dx = dk Wk^T + dv Wv^T
// keep is the (B, H*M, X) mask that dropout.cu regenerated for this layer
// (the forward hashed the same bits in-kernel).  The block writes dk, dv, dx,
// its dq partial and its column sums of dk and dv.  The dq partials over the
// tiles, dWk = (x + pos)^T dk, dWv = x^T dv and the bias sums are grad.cu's
// fk_reduce and fk_atb: fixed order, no float atomics.  The key positional
// term is a constant (JAX's pos_grad=False), so no dxk stream is written.
//
// Bound on the H100: f32 FMA.  The two projections, dx and the two weight
// products are 12 * B*X*Cx*E FLOPs (38.7 GFLOP at B=8, X=3072, Cx=512,
// E=256: ~0.58 ms at 67 TFLOP/s), the attention terms 10 * B*M*X*E more
// (2.5 GFLOP at M=40).  The design keeps K and V of the tile in shared memory
// (never in global memory), takes the projections and dx on the GEMM core of
// common.cuh, and stages one head's q and g rows at a time beside the tile.
// The block holds the GEMM staging, K and V of the tile (2 x (BK, E+1)), one
// head's q and g rows and two (M, BK) panels: 204 KB at the flagship's E=256,
// M=40 with BK = 64, but 366 KB at Breakfast's E=512, M=60, so the caller
// (ops/mha_attn.py::bwd_key_tile) takes the largest tile of 64 or 32 keys
// that fits: 215 KB at BK = 32 there.
#include <math.h>

#include "common.cuh"

namespace {

// BK keys per block (64 or 32): BK / 32 per lane in the row stage
template <int BK>
__global__ void __launch_bounds__(fk::kThreads)
mha_bwd_kernel(const float* __restrict__ x, const float* __restrict__ xpos, long long pos_bstride,
               int Px, const float* __restrict__ q, const float* __restrict__ g,
               const float* __restrict__ stats, const float* __restrict__ Dr,
               const float* __restrict__ keep, const float* __restrict__ wk,
               const float* __restrict__ bk, const float* __restrict__ wv,
               const float* __restrict__ bv, const float* __restrict__ wkvt,
               const int* __restrict__ xlen, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dx, float* __restrict__ part_dq, float* __restrict__ part_b,
               int X, int Cx, int M, int H, int hd, float scale) {
  constexpr int RM = BK / 8;
  constexpr int KPL = BK / 32;  // keys per lane
  const int E = H * hd;
  const int HM = H * M;
  const int lde = E + 1;   // odd stride: lane j reading key row j is conflict-free
  const int ldh = hd + 1;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BK>& s = *reinterpret_cast<fk::GemmSmem<BK>*>(smem_raw);
  float* Ks = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BK>) / sizeof(float);
  float* Vs = Ks + BK * lde;
  float* qh = Vs + BK * lde;  // [M][ldh]: head h's query rows
  float* gh = qh + M * ldh;   // [M][ldh]: head h's cotangent rows
  float* DL = gh + M * ldh;   // [M][BK]: dl of head h
  float* PK = DL + M * BK;    // [M][BK]: p * keep of head h

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int n_t = gridDim.x;
  const int b = blockIdx.y;
  const int x0 = tile * BK;
  const int rows = min(BK, X - x0);
  const int xl = min(xlen[b], X);
  const int blk = b * n_t + tile;
  const float* xb = x + (size_t)b * X * Cx;
  const float* pb = xpos ? xpos + (size_t)b * pos_bstride : nullptr;
  const size_t re = ((size_t)b * X + x0) * E;  // this tile's rows of (B, X, E)
  float acc[RM][8];

  // 1. K and V of the tile, as the forward computes them
  auto project = [&](auto in, const float* __restrict__ W, const float* __restrict__ bias,
                     float* out) {
    for (int n0 = 0; n0 < E; n0 += fk::kBN) {
      fk::gemm_pass<BK>(acc, in, W, E, Cx, n0, E, s);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + fk::pass_col(j);
          if (c < E) out[fk::pass_row<BK>(i) * lde + c] = acc[i][j] + __ldg(bias + c);
        }
    }
  };
  auto xk_in = [&](int r, int k) {
    if (r >= rows) return 0.f;
    float v = __ldg(xb + (size_t)(x0 + r) * Cx + k);
    if (pb != nullptr && k < Px) v += __ldg(pb + (size_t)(x0 + r) * Px + k);
    return v;
  };
  auto xv_in = [&](int r, int k) { return r < rows ? __ldg(xb + (size_t)(x0 + r) * Cx + k) : 0.f; };
  project(xk_in, wk, bk, Ks);
  project(xv_in, wv, bv, Vs);
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
      const int m = i / hd;
      const int dd = i - m * hd;
      const size_t e = ((size_t)b * M + m) * E + h * hd + dd;
      qh[m * ldh + dd] = __ldg(q + e);
      gh[m * ldh + dd] = __ldg(g + e);
    }
    __syncthreads();

    // 2. one warp per query row, BK / 32 keys per lane: p, dp, dl
    for (int m = ty; m < M; m += fk::kWarps) {
      const int hm = h * M + m;
      const size_t row = (size_t)b * HM + hm;
      const float mrow = __ldg(stats + row * 2);
      const float linv = 1.f / fmaxf(__ldg(stats + row * 2 + 1), 1e-30f);
      const float Dv = __ldg(Dr + row);
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int j = u * 32 + tx;
        const int key = x0 + j;
        float dl = 0.f, pk = 0.f;
        if (key < X) {
          const float* kr = Ks + j * lde + h * hd;
          const float* vr = Vs + j * lde + h * hd;
          float dot = 0.f, dp = 0.f;
          for (int dd = 0; dd < hd; ++dd) {
            dot = fmaf(qh[m * ldh + dd], kr[dd], dot);
            dp = fmaf(gh[m * ldh + dd], vr[dd], dp);
          }
          const float lg = key < xl ? dot * scale : fk::kMaskedLogit;
          const float p = expf(lg - mrow) * linv;
          const float kv = keep != nullptr ? __ldg(keep + row * X + key) : 1.f;
          if (key < xl) dl = p * (dp * kv - Dv) * scale;
          pk = p * kv;
        }
        DL[m * BK + j] = dl;
        PK[m * BK + j] = pk;
      }
    }
    __syncthreads();

    // 3. this tile's share of dq_h = dl K_h
    float* pq = part_dq + (((size_t)b * n_t + tile) * M) * E + h * hd;
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
      const int m = i / hd;
      const int dd = i - m * hd;
      const float* dlr = DL + m * BK;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(dlr[j], Ks[j * lde + h * hd + dd], a);
      pq[(size_t)m * E + dd] = a;
    }
    // 4. dk_h = dl^T q_h and dv_h = (p * keep)^T g_h for the tile's keys
    for (int i = threadIdx.x; i < BK * hd; i += fk::kThreads) {
      const int j = i / hd;
      const int dd = i - j * hd;
      if (j >= rows) continue;
      float a = 0.f, c = 0.f;
      for (int m = 0; m < M; ++m) {
        a = fmaf(DL[m * BK + j], qh[m * ldh + dd], a);
        c = fmaf(PK[m * BK + j], gh[m * ldh + dd], c);
      }
      dk[re + (size_t)j * E + h * hd + dd] = a;
      dv[re + (size_t)j * E + h * hd + dd] = c;
    }
    __syncthreads();  // the next head restages qh, gh, DL and PK
  }

  // 5. column sums for dbk, dbv; dk and dv rows were written by this block
  fk::block_colsum(dk + re, E, rows, E, part_b + (size_t)blk * 2 * E);
  fk::block_colsum(dv + re, E, rows, E, part_b + (size_t)blk * 2 * E + E);

  // 6. dx = [dk | dv] @ [Wk^T ; Wv^T]; plain loads: written above
  auto cat = [&](int r, int k) {
    if (r >= rows) return 0.f;
    return k < E ? dk[re + (size_t)r * E + k] : dv[re + (size_t)r * E + (k - E)];
  };
  for (int n0 = 0; n0 < Cx; n0 += fk::kBN) {
    fk::gemm_pass<BK>(acc, cat, wkvt, Cx, 2 * E, n0, Cx, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = fk::pass_row<BK>(i);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < Cx) dx[((size_t)b * X + x0 + r) * Cx + c] = acc[i][j];
      }
    }
  }
}

template <int BK>
cudaError_t launch(const float* x, const float* xpos, long long pos_bstride, int Px,
                   const float* q, const float* g, const float* stats, const float* Dr,
                   const float* keep, const float* wk, const float* bk, const float* wv,
                   const float* bv, const float* wkvt, const int* xlen, float* dk, float* dv,
                   float* dx, float* part_dq, float* part_b, int B, int X, int Cx, int M, int H,
                   int hd, float scale, cudaStream_t stream) {
  const int E = H * hd;
  const size_t smem = sizeof(fk::GemmSmem<BK>) +
                      ((size_t)2 * BK * (E + 1) + (size_t)2 * M * (hd + 1) + (size_t)2 * M * BK) *
                          sizeof(float);
  cudaError_t err = fk::set_smem((const void*)mha_bwd_kernel<BK>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((X + BK - 1) / BK, B);
  mha_bwd_kernel<BK><<<grid, fk::kThreads, smem, stream>>>(
      x, xpos, pos_bstride, Px, q, g, stats, Dr, keep, wk, bk, wv, bv, wkvt, xlen, dk, dv, dx,
      part_dq, part_b, X, Cx, M, H, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// key_tile: 64 or 32 keys per block (the caller's shared-memory choice)
extern "C" int fk_mha_bwd(const float* x, const float* xpos, long long pos_bstride, int Px,
                          const float* q, const float* g, const float* stats, const float* Dr,
                          const float* keep, const float* wk, const float* bk, const float* wv,
                          const float* bv, const float* wkvt, const int* xlen, float* dk,
                          float* dv, float* dx, float* part_dq, float* part_b, int B, int X,
                          int Cx, int M, int H, int hd, float scale, int key_tile, void* stream) {
  if (key_tile != 64 && key_tile != 32) return (int)cudaErrorInvalidValue;
  auto fn = key_tile == 64 ? launch<64> : launch<32>;
  return (int)fn(x, xpos, pos_bstride, Px, q, g, stats, Dr, keep, wk, bk, wv, bv, wkvt, xlen, dk,
                 dv, dx, part_dq, part_b, B, X, Cx, M, H, hd, scale, (cudaStream_t)stream);
}
