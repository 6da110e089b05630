// K3: the multi-head cross-attention of the action queries over the frame
// memory (the SCA layers' cross-attention), forward and backward, per head.
//
// Replaces fact_clip_tpu/ops/pallas/mha_attn.py::_mha_fwd_impl (_mha_kernel)
// and ::_mha_bwd (_mha_bwd_kernel).  The TPU kernels walk a video's key
// tiles in order, project each tile's K and V inside the kernel and work on
// a lane-masked row expansion of the heads (_expand_rows), a workaround for
// the 128-lane vector unit.  On the H100 the work splits by what bounds it:
//
//   the projection  KV = x @ [Wk | Wv] + [bk | bv] + [pos @ Wk | 0], (B, X, 2E):
//     12.9 of the ~13.4 GFLOP of the flagship's forward (B=8, X=3072, Cx=512,
//     E=256), one GEMM on the TF32 tensor cores at f32 accuracy (3xTF32, the
//     towers' GEMM of tc_tower.cuh through fk_k6_gemm, epilogue kProj: the
//     bias and the key's positional term pos @ Wk, itself one GEMM of the
//     same core).  Rows past x_len are never read (zeros).
//   the attention  (this file): one block per (key tile, head, video); a
//     block holds one head's q rows (M x hd) and the tile's K_h, V_h (BK x
//     hd), so its shared memory grows with M * hd only (46 KB at M=200,
//     hd=32): M up to 763 at hd = 64 fits (ops/mha_attn.py::attn_smem).
//     Per query row (a warp takes two at a time, BK / 32 keys a lane):
//     logits q.K * scale, keys at or past x_len -1e9 and past X -inf; the
//     tile max m, the weights
//     exp(logit - m) and their sum l; dropout (torch semantics: the weights
//     of the attend sum only, l sums the undropped ones) re-hashes the
//     layer's mask fk::dropout_bits(seed, 0, (b*H*M + h*M + m)*X + key), the
//     index layout of ops/mha_attn.py::mha_dropout_mask, so the bits equal
//     the mask kernel's; acc = sum p V.  The per-tile (m, l, acc) partials go
//     to attn_combine.cuh's fixed-order combine, which writes out (B, M, E)
//     and the rows' softmax stats (B, H*M, 2) for the backward.
//
// QK^T and PV stay on f32 FMA: 4 * B*M*X*E = 1.0 GFLOP at the flagship's
// shape, 0.015 ms at 67 TFLOP/s, against ~0.08 ms for the projection's three
// TF32 passes; what a block spends is loading its K_h / V_h tile and writing
// its partials, which tensor cores would not shorten.  A tile wholly past
// x_len writes the partials the full computation gives (m = -1e9, l = the
// tile's keys, acc = 0: its V rows are zero) without reading anything.  A
// video with no valid key (x_len = 0) attends uniformly to all X frames, as
// JAX's kernels and the plain version do: the caller projects every frame of
// it (ops/mha_attn.py::attended_lengths) and its tiles run, every logit -1e9.
//
// Backward, from the forward's saves (q, x, the stats, the output):
//   KV recomputed by the forward's projection GEMM (never stored);
//   k3_attn_bwd_kernel, one block per (key tile, head, video): p from the
//     stats, dp = g_h V_h^T, dl = p (dp keep - D) scale (D = rowsum(g_h *
//     out_h) from the caller, exact under dropout), dq's per-tile share dl
//     K_h, dK_h = dl^T q_h and dV_h = (p keep)^T g_h written to dKV (B, X,
//     2E), and the tile's column sums of dK_h and dV_h (the bias gradients);
//     the keep values are hashed again from the forward's seed at the
//     forward's index (b*H*M + h*M + m)*X + key, one hash a (row, key) by
//     the lane that owns the key, so no mask reaches device memory (31.5 MB
//     a layer at the flagship's B=8, H*M=320, X=3072); a (B, H*M, X) mask
//     given instead (keep) is read, as the tests and chip_smoke.py's
//     hashed-against-fed check feed it;
//   dx = dKV @ [Wk | Wv]^T: one GEMM of the tensor cores, K = 2E;
//   dWk | dWv = x^T dKV (and dWk += pos^T dK): mstcn2.cu's k6_wgrad in
//     768-frame chunks; dq's tile shares and the bias sums in two
//     fixed-order stages (ops/_grad.py::sum_groups).  No float atomics: the
//     same bits on every run.
// Its block holds q_h, g_h, K_h, V_h and two (M, BK) panels: 170 KB at M=200,
// hd=32, BK = 64; ops/mha_attn.py::bwd_key_tile takes 32 keys where 64 do not
// fit (M=200 at hd = 64).
#include <math.h>

#include "attn_combine.cuh"
#include "common.cuh"

namespace {

// a value stored as the element type: f32 as it is, bf16 rounded to nearest even
template <class TE>
__device__ __forceinline__ TE to_te(float v) {
  if constexpr (std::is_same<TE, fk::bf16>::value)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// one head's attention over BK keys of one video: per-tile softmax partials.
// HD: the head width as a compile-time constant (32 or 64: the loops over it
// unroll, so their shared-memory loads pipeline), or 0 to read hd_rt.
// TE: the element type of kv and q, float or bf16 (the mixed-precision form:
// the queries arrive scaled (scale 1), the logits and the softmax sum are
// f32 and the weights are rounded to bf16 for the attend sum, as JAX's
// _mha_kernel casts p before its product with v, mha_attn.py:106).
template <int BK, int HD, class TE = float>
__global__ void __launch_bounds__(fk::kThreads)
    k3_attn_kernel(const TE* __restrict__ kv, const TE* __restrict__ q,
                   const int* __restrict__ xlen, int X, int M, int H, int hd_rt, float scale,
                   float* __restrict__ part_acc, float* __restrict__ part_ml, fk::Dropout drop) {
  constexpr bool kB16 = std::is_same<TE, fk::bf16>::value;
  constexpr int KPL = BK / 32;  // keys per lane
  const int hd = HD ? HD : hd_rt;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_t = gridDim.x;
  const int E = H * hd, HM = H * M;
  const int x0 = tile * BK;
  const int rows = min(BK, X - x0);
  const int xl = min(xlen[b], X);
  const int ldk = hd + 1;  // odd stride: lane j reading key row j is conflict-free
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const size_t prow = ((size_t)b * n_t + tile) * HM + (size_t)h * M;  // partial row of m = 0
  float* pa = part_acc + prow * hd;
  float* ml = part_ml + prow * 2;
  if (xl > 0 && x0 >= xl) {  // every key masked at -1e9: p = 1 on the tile's keys, V rows zero
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) pa[i] = 0.f;
    for (int m = threadIdx.x; m < M; m += fk::kThreads) {
      ml[2 * m] = fk::kMaskedLogit;
      ml[2 * m + 1] = (float)rows;
    }
    return;
  }
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [M][hd]: head h's query rows
  float* ks = qs + M * hd;                          // [BK][hd + 1]
  float* vs = ks + BK * ldk;                        // [BK][hd]
  float* ps = vs + BK * hd;                         // [warps][2][BK]: two rows' weights
  for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
    const int m = i / hd;
    qs[i] = fk::ldf(q + ((size_t)b * M + m) * E + h * hd + (i - m * hd));
  }
  const TE* kvb = kv + ((size_t)b * X + x0) * 2 * E + h * hd;
  for (int i = threadIdx.x; i < BK * hd; i += fk::kThreads) {
    const int j = i / hd, d = i - j * hd;
    float kk = 0.f, vv = 0.f;
    if (j < rows) {
      kk = fk::ldf(kvb + (size_t)j * 2 * E + d);
      vv = fk::ldf(kvb + (size_t)j * 2 * E + E + d);
    }
    ks[j * ldk + d] = kk;
    vs[j * hd + d] = vv;
  }
  __syncthreads();

  // a warp takes two query rows at a time, so that each K_h / V_h value it
  // loads from shared memory serves two independent chains
  float* pw = ps + ty * 2 * BK;
  const uint32_t seed = drop.load_seed();
  for (int m0 = 2 * ty; m0 < M; m0 += 2 * fk::kWarps) {
    const int nr = min(2, M - m0);  // rows of this pair
    const float* q0 = qs + m0 * hd;
    const float* q1 = nr > 1 ? q0 + hd : q0;
    float lg[2][KPL];
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = u * 32 + tx;
      const int key = x0 + j;
      const float* kr = ks + j * ldk;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int d = 0; d < hd; ++d) {
        const float kd = kr[d];
        d0 = fmaf(q0[d], kd, d0);
        d1 = fmaf(q1[d], kd, d1);
      }
      lg[0][u] = key < X ? (key < xl ? d0 * scale : fk::kMaskedLogit) : -INFINITY;
      lg[1][u] = key < X ? (key < xl ? d1 * scale : fk::kMaskedLogit) : -INFINITY;
    }
    float mt[2], lt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lm = lg[r][0];
#pragma unroll
      for (int u = 1; u < KPL; ++u) lm = fmaxf(lm, lg[r][u]);
      mt[r] = fk::warp_max(lm);
      const uint32_t hm = (uint32_t)(h * M + m0 + r);
      float l = 0.f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int key = x0 + u * 32 + tx;
        const float p = key < X ? expf(lg[r][u] - mt[r]) : 0.f;
        l += p;  // the normaliser sums the undropped weights
        float pk = p;
        if (drop.seed != nullptr && key < X)
          pk *= drop.keep(((uint32_t)b * (uint32_t)HM + hm) * (uint32_t)X + (uint32_t)key, seed);
        pw[r * BK + u * 32 + tx] = kB16 ? fk::bf16_round(pk) : pk;
      }
      lt[r] = fk::warp_sum(l);
    }
    __syncwarp();
#pragma unroll
    for (int d = tx; d < hd; d += 32) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float v = vs[j * hd + d];
        a0 = fmaf(pw[j], v, a0);
        a1 = fmaf(pw[BK + j], v, a1);
      }
      pa[(size_t)m0 * hd + d] = a0;
      if (nr > 1) pa[(size_t)(m0 + 1) * hd + d] = a1;
    }
    if (tx < nr) {
      ml[2 * (m0 + tx)] = tx ? mt[1] : mt[0];
      ml[2 * (m0 + tx) + 1] = tx ? lt[1] : lt[0];
    }
    __syncwarp();  // the next pair rewrites pw
  }
}

// one head's attention backward over BK keys of one video (HD as above).
// TE: the element type of kv, q and dkv, float or bf16 (the mixed-precision
// form, JAX's _mha_bwd_kernel under bf16, mha_attn.py:386-420: the queries
// arrive scaled (scale 1), g is rounded to bf16 for its products, dl and the
// weights p are rounded to bf16 before theirs, dK and dV are rounded to bf16
// as they are written; their column sums, the bias gradients, stay f32)
template <int BK, int HD, class TE = float>
__global__ void __launch_bounds__(fk::kThreads)
    k3_attn_bwd_kernel(const TE* __restrict__ kv, const TE* __restrict__ q,
                       const float* __restrict__ g, const float* __restrict__ stats,
                       const float* __restrict__ Dr, const float* __restrict__ keep,
                       const int* __restrict__ xlen, int X, int M, int H, int hd_rt,
                       float scale, TE* __restrict__ dkv, float* __restrict__ part_dq,
                       float* __restrict__ part_b, int n_slots, fk::Dropout drop) {
  constexpr bool kB16 = std::is_same<TE, fk::bf16>::value;
  constexpr int KPL = BK / 32;
  const int hd = HD ? HD : hd_rt;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int E = H * hd, HM = H * M;
  const int x0 = tile * BK;
  const int rows = min(BK, X - x0);
  const int xl = min(xlen[b], X);
  const int ldk = hd + 1;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float* dq = part_dq + ((size_t)b * n_slots + tile) * M * E + h * hd;  // row m at + m * E
  float* pb = part_b + ((size_t)b * n_slots + tile) * 2 * E + h * hd;   // dV's sums at + E
  TE* dkvb = dkv + ((size_t)b * X + x0) * 2 * E + h * hd;           // key j at + j * 2E
  if (xl > 0 && x0 >= xl) {  // every key masked: p = 0, so dl, p * keep and all of this are zero
    for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) dq[(size_t)(i / hd) * E + i % hd] = 0.f;
    for (int i = threadIdx.x; i < rows * hd; i += fk::kThreads) {
      const size_t o = (size_t)(i / hd) * 2 * E + i % hd;
      dkvb[o] = to_te<TE>(0.f);
      dkvb[o + E] = to_te<TE>(0.f);
    }
    for (int c = threadIdx.x; c < hd; c += fk::kThreads) pb[c] = pb[E + c] = 0.f;
    return;
  }
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [M][hd]
  float* gs = qs + M * hd;                          // [M][hd]
  float* ks = gs + M * hd;                          // [BK][hd + 1]; dK_h after step 2
  float* vs = ks + BK * ldk;                        // [BK][hd + 1]; dV_h after step 2
  float* DL = vs + BK * ldk;                        // [M][BK]: dl
  float* PK = DL + M * BK;                          // [M][BK]: p * keep
  for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
    const int m = i / hd;
    const size_t e = ((size_t)b * M + m) * E + h * hd + (i - m * hd);
    qs[i] = fk::ldf(q + e);
    gs[i] = kB16 ? fk::bf16_round(__ldg(g + e)) : __ldg(g + e);
  }
  const TE* kvb = kv + ((size_t)b * X + x0) * 2 * E + h * hd;
  for (int i = threadIdx.x; i < BK * hd; i += fk::kThreads) {
    const int j = i / hd, d = i - j * hd;
    float kk = 0.f, vv = 0.f;
    if (j < rows) {
      kk = fk::ldf(kvb + (size_t)j * 2 * E + d);
      vv = fk::ldf(kvb + (size_t)j * 2 * E + E + d);
    }
    ks[j * ldk + d] = kk;
    vs[j * ldk + d] = vv;
  }
  __syncthreads();

  // 1. a warp per query row, BK / 32 keys a lane: p, dp, dl
  const uint32_t seed = drop.load_seed();
  const bool hashed = keep == nullptr && drop.seed != nullptr;
  for (int m = ty; m < M; m += fk::kWarps) {
    const size_t row = (size_t)b * HM + h * M + m;
    const float mrow = __ldg(stats + row * 2);
    const float linv = 1.f / fmaxf(__ldg(stats + row * 2 + 1), 1e-30f);
    const float Dv = __ldg(Dr + row);
    const float* qr = qs + m * hd;
    const float* gr = gs + m * hd;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = u * 32 + tx;
      const int key = x0 + j;
      float dl = 0.f, pk = 0.f;
      if (key < X) {
        const float* kr = ks + j * ldk;
        const float* vr = vs + j * ldk;
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < hd; ++d) {
          dot = fmaf(qr[d], kr[d], dot);
          dp = fmaf(gr[d], vr[d], dp);
        }
        const float lg = key < xl ? dot * scale : fk::kMaskedLogit;
        const float p = expf(lg - mrow) * linv;
        const float kp = keep != nullptr ? __ldg(keep + row * X + key)
                         : hashed ? drop.keep((uint32_t)row * (uint32_t)X + (uint32_t)key, seed)
                                  : 1.f;
        if (key < xl) dl = p * (dp * kp - Dv) * scale;
        pk = p * kp;
      }
      DL[m * BK + j] = kB16 ? fk::bf16_round(dl) : dl;
      PK[m * BK + j] = kB16 ? fk::bf16_round(pk) : pk;
    }
  }
  __syncthreads();
  // 2. this tile's share of dq_h = dl K_h
  for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
    const int m = i / hd, d = i - m * hd;
    const float* dlr = DL + m * BK;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) a = fmaf(dlr[j], ks[j * ldk + d], a);
    dq[(size_t)m * E + d] = a;
  }
  __syncthreads();  // K_h and V_h are read: dK_h and dV_h land in their place
  // 3. dK_h = dl^T q_h, dV_h = (p keep)^T g_h
  for (int i = threadIdx.x; i < BK * hd; i += fk::kThreads) {
    const int j = i / hd, d = i - j * hd;
    float a = 0.f, c = 0.f;
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      a = fmaf(DL[m * BK + j], qs[m * hd + d], a);
      c = fmaf(PK[m * BK + j], gs[m * hd + d], c);
    }
    ks[j * ldk + d] = a;
    vs[j * ldk + d] = c;
  }
  __syncthreads();
  // 4. the tile's rows of dKV and their column sums (row order)
  for (int i = threadIdx.x; i < rows * hd; i += fk::kThreads) {
    const int j = i / hd, d = i - j * hd;
    dkvb[(size_t)j * 2 * E + d] = to_te<TE>(ks[j * ldk + d]);
    dkvb[(size_t)j * 2 * E + E + d] = to_te<TE>(vs[j * ldk + d]);
  }
  for (int c = threadIdx.x; c < 2 * hd; c += fk::kThreads) {
    const float* col = c < hd ? ks + c : vs + (c - hd);
    float s = 0.f;
    for (int j = 0; j < rows; ++j) s += col[j * ldk];
    pb[c < hd ? c : E + (c - hd)] = s;
  }
}

size_t attn_smem(int BK, int M, int hd) {
  return ((size_t)M * hd + (size_t)BK * (hd + 1) + (size_t)BK * hd +
          (size_t)fk::kWarps * 2 * BK) *
         sizeof(float);
}

size_t attn_bwd_smem(int BK, int M, int hd) {
  return ((size_t)2 * M * hd + (size_t)2 * BK * (hd + 1) + (size_t)2 * M * BK) * sizeof(float);
}

template <int BK, int HD, class TE = float>
cudaError_t launch_bwd(const TE* kv, const TE* q, const float* g, const float* stats,
                       const float* Dr, const float* keep, const int* xlen, int B, int X, int M,
                       int H, int hd, float scale, TE* dkv, float* part_dq, float* part_b,
                       int n_slots, fk::Dropout drop, cudaStream_t stream) {
  const size_t smem = attn_bwd_smem(BK, M, hd);
  cudaError_t err = fk::set_smem((const void*)k3_attn_bwd_kernel<BK, HD, TE>, smem);
  if (err != cudaSuccess) return err;
  k3_attn_bwd_kernel<BK, HD, TE><<<dim3((X + BK - 1) / BK, H, B), fk::kThreads, smem, stream>>>(
      kv, q, g, stats, Dr, keep, xlen, X, M, H, hd, scale, dkv, part_dq, part_b, n_slots, drop);
  return cudaGetLastError();
}

template <int BK, class TE = float>
cudaError_t launch_bwd_hd(const TE* kv, const TE* q, const float* g, const float* stats,
                          const float* Dr, const float* keep, const int* xlen, int B, int X,
                          int M, int H, int hd, float scale, TE* dkv, float* part_dq,
                          float* part_b, int n_slots, fk::Dropout drop, cudaStream_t stream) {
  auto fn = hd == 32 ? launch_bwd<BK, 32, TE> : hd == 64 ? launch_bwd<BK, 64, TE>
                                                         : launch_bwd<BK, 0, TE>;
  return fn(kv, q, g, stats, Dr, keep, xlen, B, X, M, H, hd, scale, dkv, part_dq, part_b, n_slots,
            drop, stream);
}

constexpr int kFwdTile = 64;  // keys per block of the forward

template <int HD, class TE = float>
cudaError_t launch_fwd(const TE* kv, const TE* q, const int* xlen, int B, int X, int M,
                       int H, int hd, float scale, float* part_acc, float* part_ml,
                       fk::Dropout drop, cudaStream_t stream) {
  const size_t smem = attn_smem(kFwdTile, M, hd);
  cudaError_t err = fk::set_smem((const void*)k3_attn_kernel<kFwdTile, HD, TE>, smem);
  if (err != cudaSuccess) return err;
  k3_attn_kernel<kFwdTile, HD, TE><<<dim3((X + kFwdTile - 1) / kFwdTile, H, B), fk::kThreads,
                                     smem, stream>>>(kv, q, xlen, X, M, H, hd, scale, part_acc,
                                                     part_ml, drop);
  return cudaGetLastError();
}

}  // namespace

// The forward's attention on the projected kv (B, X, 2E): the per-(tile,
// head, video) partials (part_acc (B, n_t, H*M, hd), part_ml (B, n_t, H*M,
// 2), n_t = ceil(X / 64)), then the combine into out (B, M, E) and, when
// given, stats (B, H*M, 2).
extern "C" int fk_k3_attn(const float* kv, const float* q, const int* xlen, int B, int X, int M,
                          int H, int hd, float scale, float* part_acc, float* part_ml, float* out,
                          float* stats, const int* seed, int drop_stream, unsigned thresh,
                          float drop_scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto fn = hd == 32 ? launch_fwd<32, float> : hd == 64 ? launch_fwd<64, float>
                                             : launch_fwd<0, float>;
  cudaError_t err = fn(kv, q, xlen, B, X, M, H, hd, scale, part_acc, part_ml,
                       fk::Dropout{seed, drop_stream, thresh, drop_scale}, st);
  if (err != cudaSuccess) return (int)err;
  const int n_t = (X + kFwdTile - 1) / kFwdTile;
  return (int)launch_combine(part_acc, part_ml, B, n_t, M, H, hd, out, nullptr, nullptr, X, stats,
                             st);
}

// K3's bf16 form's attention (ops/mha_attn.py::mha_cross16_fwd) on kv (B, X,
// 2E) bf16 (bf16(x + pos) Wk + bk | x Wv + bv, rounded) and q (B, M, E) bf16,
// already scaled by bf16(1 / sqrt(hd)): the partials as fk_k3_attn's, the
// weights rounded to bf16 for the attend sum, then the combine into out (B,
// M, E) f32, and, where stats is not null (the training form), the rows'
// softmax stats (B, H*M, 2), which the backward reads.  No dropout.
extern "C" int fk_k3_attn16(const void* kv, const void* q, const int* xlen, int B, int X, int M,
                            int H, int hd, float* part_acc, float* part_ml, float* out,
                            float* stats, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto fn = hd == 32 ? launch_fwd<32, fk::bf16>
                     : hd == 64 ? launch_fwd<64, fk::bf16> : launch_fwd<0, fk::bf16>;
  cudaError_t err = fn((const fk::bf16*)kv, (const fk::bf16*)q, xlen, B, X, M, H, hd, 1.f,
                       part_acc, part_ml, fk::Dropout{nullptr, 0, 0u, 1.f}, st);
  if (err != cudaSuccess) return (int)err;
  const int n_t = (X + kFwdTile - 1) / kFwdTile;
  return (int)launch_combine(part_acc, part_ml, B, n_t, M, H, hd, out, nullptr, nullptr, X, stats,
                             st);
}

// The backward's attention: dkv (B, X, 2E), part_dq (B, n_slots, M, E) and
// part_b (B, n_slots, 2E), the tiles' shares in slots t < ceil(X / key_tile)
// <= n_slots of each video (the caller zeroes the others).  Its dropout:
// keep (B, H*M, X) where given, else hashed from seed (the forward's (1,)
// int32 seed, stream drop_stream, threshold and scale as fk_k3_attn's);
// neither: no dropout.
extern "C" int fk_k3_attn_bwd(const float* kv, const float* q, const float* g, const float* stats,
                              const float* Dr, const float* keep, const int* xlen, int B, int X,
                              int M, int H, int hd, float scale, float* dkv, float* part_dq,
                              float* part_b, int n_slots, int key_tile, const int* seed,
                              int drop_stream, unsigned thresh, float drop_scale, void* stream) {
  if ((key_tile != 64 && key_tile != 32) || n_slots < (X + key_tile - 1) / key_tile)
    return (int)cudaErrorInvalidValue;
  auto fn = key_tile == 64 ? launch_bwd_hd<64> : launch_bwd_hd<32>;
  return (int)fn(kv, q, g, stats, Dr, keep, xlen, B, X, M, H, hd, scale, dkv, part_dq, part_b,
                 n_slots, fk::Dropout{seed, drop_stream, thresh, drop_scale},
                 (cudaStream_t)stream);
}

// K3's bf16 form's attention backward (ops/mha_attn.py::mha_cross16_bwd):
// kv (B, X, 2E) bf16 as the forward projected it, q (B, M, E) bf16 scaled by
// bf16(1 / sqrt(hd)), g (B, M, E) f32, the forward's stats and the row term D
// -> dkv (B, X, 2E) bf16 (dK, dV rounded), part_dq (B, n_slots, M, E) f32 and
// part_b (B, n_slots, 2E) f32 as fk_k3_attn_bwd's (no dropout).
extern "C" int fk_k3_attn_bwd16(const void* kv, const void* q, const float* g, const float* stats,
                                const float* Dr, const int* xlen, int B, int X, int M, int H,
                                int hd, void* dkv, float* part_dq, float* part_b, int n_slots,
                                int key_tile, void* stream) {
  if ((key_tile != 64 && key_tile != 32) || n_slots < (X + key_tile - 1) / key_tile)
    return (int)cudaErrorInvalidValue;
  auto fn = key_tile == 64 ? launch_bwd_hd<64, fk::bf16> : launch_bwd_hd<32, fk::bf16>;
  return (int)fn((const fk::bf16*)kv, (const fk::bf16*)q, g, stats, Dr, nullptr, xlen, B, X, M,
                 H, hd, 1.f, (fk::bf16*)dkv, part_dq, part_b, n_slots,
                 fk::Dropout{nullptr, 0, 0u, 1.f}, (cudaStream_t)stream);
}
