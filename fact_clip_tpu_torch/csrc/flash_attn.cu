// Cross-attention of a few query rows over a long projected key/value stream
// on the f32 FMA core of common.cuh: the forward of K2's flash form (single
// head) and its int8 twin K8c.  fk_proj_attn and fk_proj_attn_q8 take heads,
// dropout and softmax stats too, which their single-head callers leave unused.
//
// Replaces fact_clip_tpu/ops/pallas/x2y_attn.py::_x2y_flash_fwd_impl
// (_flash_kernel).  The TPU kernel walks the key axis sequentially per video,
// carrying an online softmax in VMEM scratch.  Blocks on the H100 run in no
// order, so the walk is split instead:
//
//   partial: one block per (key tile of BK keys, video).  It projects the tile
//            K = (x + pos) @ Wk + bk into shared memory, takes per (head,
//            query) row logits = q.K * scale with keys at or past x_len set
//            to -1e9, the tile max m, the weights exp(logit - m) and their
//            sum l; then projects V = x @ Wv + bv into the same buffer and
//            takes acc = sum exp(logit - m) V.  K and V never reach global
//            memory.  The single-head form also streams the masked logits out
//            (the losses and the decode read them).
//   combine: attn_combine.cuh, one block per (head, query row, video); for
//            the single-head form it also writes probs = exp(logit - m_max) /
//            l_total.
//
// Dropout (torch semantics: softmax, then dropout on the probabilities)
// runs in the partial kernel when a seed is given: the keep value of (b, h,
// m, key) is fk::dropout_bits(seed, 0, (b*H*M + h*M + m)*X + key), the mask
// of shape (B, H*M, X) of ops/dropout.py; it multiplies the weights of the
// attend sum only, while l sums the undropped weights.
//
// Bound on the H100: the two projections, 2 * 2 * B*X*Cx*E FLOPs of f32
// FMA (25.8 GFLOP for the u-block's f2a at B=8, X=3072, Cx=E=512).  A tile
// of BK = 64 keys lets every weight value fetched from L2 serve 64 rows; one
// K/V buffer keeps the block within shared memory at E=512.  The partial
// results add B * X/BK * H*M * (hd + 2) floats of traffic each way (32 MB
// for the f2a), small next to the FMA time.  The block holds the GEMM
// staging, the (BK, E+1) K/V buffer and the (H*M, BK) weights: where that
// exceeds the 227 KB a block may hold (E=512, H=8, M=60 needs 296 KB at
// BK = 64), the caller (ops/x2y_attn.py::key_tile) takes the largest tile
// of 64 or 32 that fits; every K2 flash call keeps BK = 64.
//
// K8c, the int8 twin (proj_attn_q8_partial_kernel + the same combine),
// replaces fact_clip_tpu/ops/pallas/quant_conv.py::_x2y_flash_q8_impl
// (_x2y_flash_kernel_q8): the frame rows arrive quantized per row (quant.cu's
// q8_rows_kernel: x + pos for K, x for V, int8 values and each row's absmax),
// the two projections run on quant.cuh's int8 mma.sync core and dequantize in
// JAX's order fma(idot * s_row, sw, b) (ops/quant_conv.py); the softmax and
// attend stages are this file's (partial_attend).  K8d, the multi-head SCA
// twin, projects on the int8 wgmma core and attends through K3's kernels
// (q8_proj.cu).
#include <math.h>

#include "attn_combine.cuh"
#include "common.cuh"
#include "quant.cuh"

namespace {

// The tile's attention once proj_k / proj_v have written K / V (BK x E) into
// kv_s (row stride E + 1): per (head, query) row the logits (keys at or past
// x_len -1e9, past X -inf), the tile max m, exp(logit - m) and their sum l
// (part_ml), then acc = sum exp(logit - m) V (part_acc).  BK / 32 keys a lane.
template <int BK, class ProjK, class ProjV>
__device__ __forceinline__ void partial_attend(ProjK proj_k, ProjV proj_v, float* kv_s,
                                               float* p_s, const float* __restrict__ q, int b,
                                               int tile, int n_t, int xl, int X, int M, int H,
                                               int hd, float scale, float* __restrict__ logits,
                                               float* __restrict__ part_acc,
                                               float* __restrict__ part_ml, fk::Dropout drop) {
  constexpr int KPL = BK / 32;  // keys per lane
  const int E = H * hd;
  const int HM = H * M;
  const int lde = E + 1;  // odd stride: lane j reading row j is conflict-free
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int x0 = tile * BK;
  const uint32_t seed = drop.load_seed();

  proj_k();
  for (int hm = ty; hm < HM; hm += fk::kWarps) {
    const int h = hm / M;
    const int m = hm - h * M;
    const float* qr = q + ((size_t)b * M + m) * E + h * hd;
    float lg[KPL];
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int key = x0 + u * 32 + tx;
      const float* kr = kv_s + (u * 32 + tx) * lde + h * hd;
      float dot = 0.f;
      for (int dd = 0; dd < hd; ++dd) dot = fmaf(__ldg(qr + dd), kr[dd], dot);
      lg[u] = key < X ? (key < xl ? dot * scale : fk::kMaskedLogit) : -INFINITY;
      if (logits != nullptr && key < X) logits[((size_t)b * M + m) * X + key] = lg[u];
    }
    float lm = lg[0];
#pragma unroll
    for (int u = 1; u < KPL; ++u) lm = fmaxf(lm, lg[u]);
    const float mt = fk::warp_max(lm);
    float lt = 0.f;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int key = x0 + u * 32 + tx;
      const float p = key < X ? expf(lg[u] - mt) : 0.f;
      lt += p;  // the normaliser sums the undropped weights
      float pk = p;
      if (drop.seed != nullptr && key < X)
        pk *= drop.keep(((uint32_t)b * (uint32_t)HM + (uint32_t)hm) * (uint32_t)X + (uint32_t)key,
                        seed);
      p_s[hm * BK + u * 32 + tx] = pk;
    }
    lt = fk::warp_sum(lt);
    if (tx == 0) {
      float* ml = part_ml + (((size_t)b * n_t + tile) * HM + hm) * 2;
      ml[0] = mt;
      ml[1] = lt;
    }
  }
  __syncthreads();  // every row is done with K before V overwrites it

  proj_v();
  for (int hm = ty; hm < HM; hm += fk::kWarps) {
    const int h = hm / M;
    const float* pr = p_s + hm * BK;
    float* pa = part_acc + (((size_t)b * n_t + tile) * HM + hm) * hd;
    for (int dd = tx; dd < hd; dd += 32) {
      const float* vc = kv_s + h * hd + dd;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(pr[j], vc[j * lde], a);
      pa[dd] = a;
    }
  }
}

// BK keys per block (64 or 32)
template <int BK>
__global__ void __launch_bounds__(fk::kThreads)
proj_attn_partial_kernel(const float* __restrict__ x, const float* __restrict__ xpos,
                         long long pos_bstride, int Px, const float* __restrict__ q,
                         const float* __restrict__ wk, const float* __restrict__ bk,
                         const float* __restrict__ wv, const float* __restrict__ bv,
                         const int* __restrict__ xlen, int X, int Cx, int M, int H, int hd,
                         float scale, float* __restrict__ logits,
                         float* __restrict__ part_acc, float* __restrict__ part_ml,
                         fk::Dropout drop) {
  constexpr int RM = BK / 8;
  const int E = H * hd;
  const int lde = E + 1;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BK>& s = *reinterpret_cast<fk::GemmSmem<BK>*>(smem_raw);
  float* kv_s = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BK>) / sizeof(float);
  float* p_s = kv_s + BK * lde;  // [HM][BK]: exp(logit - m) per row and key

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int x0 = tile * BK;
  const float* xb = x + (size_t)b * X * Cx;
  const float* pb = xpos ? xpos + (size_t)b * pos_bstride : nullptr;
  float acc[RM][8];

  // out[r][c] = in(r, :) @ W[:, c] + bias[c] for the tile's rows
  auto project = [&](auto in, const float* __restrict__ W, const float* __restrict__ bias) {
    for (int n0 = 0; n0 < E; n0 += fk::kBN) {
      fk::gemm_pass<BK>(acc, in, W, E, Cx, n0, E, s);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + fk::pass_col(j);
          if (c < E) kv_s[fk::pass_row<BK>(i) * lde + c] = acc[i][j] + __ldg(bias + c);
        }
    }
    __syncthreads();
  };
  auto xk_in = [&](int r, int k) {  // x + pos: the key projection's input
    const int key = x0 + r;
    if (key >= X) return 0.f;
    float v = __ldg(xb + (size_t)key * Cx + k);
    if (pb != nullptr && k < Px) v += __ldg(pb + (size_t)key * Px + k);
    return v;
  };
  auto xv_in = [&](int r, int k) {
    const int key = x0 + r;
    return key < X ? __ldg(xb + (size_t)key * Cx + k) : 0.f;
  };
  partial_attend<BK>([&] { project(xk_in, wk, bk); }, [&] { project(xv_in, wv, bv); }, kv_s,
                     p_s, q, b, tile, gridDim.x, min(xlen[b], X), X, M, H, hd, scale, logits,
                     part_acc, part_ml, drop);
}

// The int8 twin: qxk / qxv (B, X, Cx) int8 with row absmaxes sxk / sxv (B, X),
// qwkt / qwvt (E, Cx) int8 with the folded weight scales swk / swv (E,).
template <int BK>
__global__ void __launch_bounds__(fk::kThreads)
proj_attn_q8_partial_kernel(const int8_t* __restrict__ qxk, const float* __restrict__ sxk,
                            const int8_t* __restrict__ qxv, const float* __restrict__ sxv,
                            const float* __restrict__ q, const int8_t* __restrict__ qwkt,
                            const float* __restrict__ swk, const float* __restrict__ bk,
                            const int8_t* __restrict__ qwvt, const float* __restrict__ swv,
                            const float* __restrict__ bv, const int* __restrict__ xlen, int X,
                            int Cx, int M, int H, int hd, float scale,
                            float* __restrict__ logits, float* __restrict__ part_acc,
                            float* __restrict__ part_ml) {
  const int E = H * hd;
  const int lde = E + 1;
  extern __shared__ float4 smem_raw[];
  // the int8 staging sits where the f32 twin keeps its GEMM staging
  fk::QSmem<BK>& s = *reinterpret_cast<fk::QSmem<BK>*>(smem_raw);
  float* kv_s = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BK>) / sizeof(float);
  float* p_s = kv_s + BK * lde;

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int x0 = tile * BK;
  const int rows = min(BK, X - x0);
  int acc[BK / 16][4][4];

  // kv_s[r][c] = fma((qx[r] . qwt[c]) * sx[r], sw[c], bias[c])
  auto project = [&](const int8_t* __restrict__ qx, const float* __restrict__ sx,
                     const int8_t* __restrict__ qwt, const float* __restrict__ sw,
                     const float* __restrict__ bias) {
    const int8_t* qb = qx + ((size_t)b * X + x0) * Cx;
    const float* sb = sx + (size_t)b * X + x0;
    auto stage = [&](int8_t (*as)[fk::kQLD], int k0) {
      fk::q_stage_a_rows<BK>(as, qb, Cx, rows, k0);
    };
    for (int n0 = 0; n0 < E; n0 += fk::kBN) {
      fk::q_gemm_pass<BK>(acc, stage, qwt, Cx, n0, E, s);
#pragma unroll
      for (int mt = 0; mt < BK / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = fk::q_row(mt, i);
            const int c = n0 + fk::q_col(nt, i);
            if (c >= E) continue;
            const float sr = r < rows ? sb[r] : 0.f;
            kv_s[r * lde + c] = __fmaf_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), sr),
                                          __ldg(sw + c), __ldg(bias + c));
          }
    }
    __syncthreads();
  };
  partial_attend<BK>([&] { project(qxk, sxk, qwkt, swk, bk); },
                     [&] { project(qxv, sxv, qwvt, swv, bv); }, kv_s, p_s, q, b, tile,
                     gridDim.x, min(xlen[b], X), X, M, H, hd, scale, logits, part_acc, part_ml,
                     fk::Dropout{nullptr, 0, 0u, 1.f});
}

template <int BK>
cudaError_t launch_partial(const float* x, const float* xpos, long long pos_bstride, int Px,
                           const float* q, const float* wk, const float* bk, const float* wv,
                           const float* bv, const int* xlen, int B, int X, int Cx, int M, int H,
                           int hd, float scale, float* logits, float* part_acc, float* part_ml,
                           fk::Dropout drop, cudaStream_t stream) {
  const int E = H * hd;
  const int n_t = (X + BK - 1) / BK;
  const size_t smem = sizeof(fk::GemmSmem<BK>) +
                      ((size_t)BK * (E + 1) + (size_t)H * M * BK) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)proj_attn_partial_kernel<BK>, smem);
  if (err != cudaSuccess) return err;
  proj_attn_partial_kernel<BK><<<dim3(n_t, B), fk::kThreads, smem, stream>>>(
      x, xpos, pos_bstride, Px, q, wk, bk, wv, bv, xlen, X, Cx, M, H, hd, scale, logits,
      part_acc, part_ml, drop);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_q8_partial(const int8_t* qxk, const float* sxk, const int8_t* qxv,
                              const float* sxv, const float* q, const int8_t* qwkt,
                              const float* swk, const float* bk, const int8_t* qwvt,
                              const float* swv, const float* bv, const int* xlen, int B, int X,
                              int Cx, int M, int H, int hd, float scale, float* logits,
                              float* part_acc, float* part_ml, cudaStream_t stream) {
  const int E = H * hd;
  const int n_t = (X + BK - 1) / BK;
  const size_t smem = sizeof(fk::GemmSmem<BK>) +
                      ((size_t)BK * (E + 1) + (size_t)H * M * BK) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)proj_attn_q8_partial_kernel<BK>, smem);
  if (err != cudaSuccess) return err;
  proj_attn_q8_partial_kernel<BK><<<dim3(n_t, B), fk::kThreads, smem, stream>>>(
      qxk, sxk, qxv, sxv, q, qwkt, swk, bk, qwvt, swv, bv, xlen, X, Cx, M, H, hd, scale, logits,
      part_acc, part_ml);
  return cudaGetLastError();
}

}  // namespace

// key_tile: 64 or 32 keys per partial block (the caller's shared-memory choice)
extern "C" int fk_proj_attn(const float* x, const float* xpos, long long pos_bstride, int Px,
                            const float* q, const float* wk, const float* bk, const float* wv,
                            const float* bv, const int* xlen, int B, int X, int Cx, int M,
                            int H, int hd, float scale, float* logits, float* probs, float* out,
                            float* part_acc, float* part_ml, const int* seed, int drop_stream,
                            unsigned thresh, float drop_scale, float* stats, int key_tile,
                            void* stream) {
  if (key_tile != 64 && key_tile != 32) return (int)cudaErrorInvalidValue;
  const int n_t = (X + key_tile - 1) / key_tile;
  const fk::Dropout drop{seed, drop_stream, thresh, drop_scale};
  cudaError_t err =
      key_tile == 64
          ? launch_partial<64>(x, xpos, pos_bstride, Px, q, wk, bk, wv, bv, xlen, B, X, Cx, M,
                               H, hd, scale, logits, part_acc, part_ml, drop,
                               (cudaStream_t)stream)
          : launch_partial<32>(x, xpos, pos_bstride, Px, q, wk, bk, wv, bv, xlen, B, X, Cx, M,
                               H, hd, scale, logits, part_acc, part_ml, drop,
                               (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(part_acc, part_ml, B, n_t, M, H, hd, out, logits, probs, X, stats,
                             (cudaStream_t)stream);
}

// K8c (logits and probs written): the int8 partial kernel, then the combine
extern "C" int fk_proj_attn_q8(const int8_t* qxk, const float* sxk, const int8_t* qxv,
                               const float* sxv, const float* q, const int8_t* qwkt,
                               const float* swk, const float* bk, const int8_t* qwvt,
                               const float* swv, const float* bv, const int* xlen, int B, int X,
                               int Cx, int M, int H, int hd, float scale, float* logits,
                               float* probs, float* out, float* part_acc, float* part_ml,
                               int key_tile, void* stream) {
  if ((key_tile != 64 && key_tile != 32) || Cx % 16 != 0) return (int)cudaErrorInvalidValue;
  const int n_t = (X + key_tile - 1) / key_tile;
  cudaError_t err =
      key_tile == 64
          ? launch_q8_partial<64>(qxk, sxk, qxv, sxv, q, qwkt, swk, bk, qwvt, swv, bv, xlen, B, X,
                                  Cx, M, H, hd, scale, logits, part_acc, part_ml,
                                  (cudaStream_t)stream)
          : launch_q8_partial<32>(qxk, sxk, qxv, sxv, q, qwkt, swk, bk, qwvt, swv, bv, xlen, B, X,
                                  Cx, M, H, hd, scale, logits, part_acc, part_ml,
                                  (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(part_acc, part_ml, B, n_t, M, H, hd, out, logits, probs, X, nullptr,
                             (cudaStream_t)stream);
}
