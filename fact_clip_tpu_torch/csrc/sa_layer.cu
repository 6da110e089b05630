// K4: the post-norm sublayers of the action-token decoders, forward with
// dropout and backward.
//
// Forward: replaces fact_clip_tpu/ops/pallas/sa_layer.py::_sa_fwd_impl
// (_sa_fwd_kernel) and ::_ffn_fwd_impl (_ffn_fwd_kernel):
//   SA:  y = LN(x + drop_o(MHA(x + pos, x + pos, x; drop_a on the probs) @ Wo + bo))
//   FFN: y = LN(x + drop_2(drop_1(relu(x @ W1 + b1)) @ W2 + b2))   (LN eps 1e-6)
// Every projection, the softmax, the dropout, the residual and the LayerNorm
// run in the kernels.  The TPU kernel holds a video's whole SA sublayer in
// VMEM, one grid step a video; on the H100 one block a video ran one SM of
// 132 at epic's batch of 1 (2.9 ms at M=300, its eight heads one after
// another).  So the SA forward is three kernels:
// q, k, v over (32-row tile, video, projection) on the GEMM core
// (sa_qkv_kernel); the attention over (32-query tile, head, video), a warp
// per query row with K_h and V_h of every key staged by cp.async
// (sa_context_kernel, shared with the backward); the out projection, its
// dropout, the residual and the LayerNorm over (32-row tile, video)
// (sa_out_ln_kernel).  At B=1, M=300, H=8 that is 30, 80 and 10 blocks.
// The intermediates (q, k, v, the context) go to buffers the wrapper
// allocates: 1.2 MB a video at M=300, in L2.  The FFN forward takes its
// backward's split (below): x W1 and hk W2 in K slices over (32-row tile,
// column chunk) blocks of the batch's B * M rows, hk staged from the first
// product's slices, then the residual and LayerNorm per 16-row tile; one
// library call of three launches into a workspace the library lays out.
//
// Dropout: the TPU kernels draw from the on-core PRNG seeded per video
// (sa_layer.py:138, :240).  Here a keep value is common.cuh's counter hash of
// (seed, stream, index) over the mask's logical shape (ops/dropout.py): SA
// stream 0 over (B, H*M, M) for the probabilities (rows h*M + m) and stream
// 1 over (B, M, E) for the output; FFN, with its own seed, stream 0 over
// (B, M, F) for the hidden rows and stream 1 over (B, M, E) for the output.
//
// Backward: replaces ::_sa_bwd (_sa_bwd_kernel) and ::_ffn_bwd
// (_ffn_bwd_kernel).  Each recomputes its forward from x (and pos) with the
// call's masks, takes the LayerNorm backward (eps 1e-6) and writes dx.  Both
// hash their two masks inline from the forward's seed, as the forwards do (a
// replayed mask tensor may stand in, for the tests), so that the training
// path makes no mask:
//   SA:  dout = dres * keep_o; dc = dout Wo^T; per head dPd = dc_h v_h^T,
//        dv_h = Pd^T dc_h, dS = P * (dPd * keep_a - D) * scale with the row
//        term D = dc_h . c_h (= rowsum(P * dPd * keep_a)), dq_h = dS k_h,
//        dk_h = dS^T q_h; dxa = dq Wq^T + dk Wk^T; dx = dres + dxa + dv Wv^T.
//        The TPU kernel holds a video's whole sublayer in VMEM (100 MB,
//        _COMPILER_PARAMS).  On the H100 one library call (fk_sa_bwd) of
//        eleven launches takes the batch's B * M token rows as one row
//        space, through a workspace into a buffer of results, both laid out
//        by the library (sa_workspace):
//          0. the packs of the eight weight operands and the rows [x + pos |
//             x | . | 1] (one launch);
//          1. [q | k | v] on mstcn2.cu's 3xTF32 GEMM (tc_rows_gemm: three
//             problems, kProj's epilogue, promoted every 8 deep);
//          2. P and c per (32-query tile, head, video), P kept, four query
//             rows a warp (sa_bwd_probs_kernel);
//          3. c Wo on the GEMM (in K slices, sa_slices); 4. res = x +
//             drop_o(c Wo + bo), its LayerNorm backward per 16-row tile and
//             dout (the FFN backward's LayerNorm kernel); 5. dc = dout Wo^T
//             on the GEMM (K slices);
//          6. dS, P * keep_a and dq per (32-query tile, head, video), from P:
//             the probabilities are computed once;
//          7. dk and dv per (32-key tile, head, video) from dS and P * keep_a;
//          8. dq Wq^T, dk Wk^T and dv Wv^T on the GEMM (K slices);
//          9. the weight products and bias sums (x + pos)^T [dq | dk], x^T dv,
//             c^T dout and 1^T [dq | dk | dv | dout] as one launch of
//             mstcn2.cu's weight-product kernel (tc_wgrad_pairs) over chunks
//             of the rows, so that B = 1 fills the card;
//          10. the chunks' and LayerNorm tiles' sums in two fixed-order
//             stages, dx, and d(pos) = the batch sum of dxa.
//        No float atomics: every run gives the same bits.  The previous design
//        (six kernels over (64-row tile, video) and (query or key tile, head,
//        video) blocks on the f32 FMA core, p computed three times, the
//        weight products and sums from Python) took 0.33 ms of device time at
//        the flagship's B=8, M=40 and 0.68 at epic's B=1, M=300, this one
//        0.107 and 0.163 (H100 80GB HBM3, 700 W): the old row kernels filled
//        5-24 SMs.
//   FFN: dt2 = dres * keep_2; dh = (dt2 W2^T) * keep_1; dz1 = dh * (z1 >
//        0); dx = dres + dz1 W1^T.  One block per video ran one SM at
//        epic's batch of one (1.46 ms at M=300), so the backward's four
//        products go over (32-row tile, 256-column chunk, K slice of 128)
//        blocks of the batch's B * M token rows, and the step after each
//        adds its slices: z1 and h * keep_1, and dz1, as the next product
//        stages its A operand; res, the LayerNorm backward and dt2 on whole
//        E rows per 16-row tile; dx and the tiles' LayerNorm sums (40 blocks a
//        product at B=1, M=300, E=256, F=512), behind one transpose launch
//        for W1^T and W2^T: one library call of six launches, no host-side
//        copies.  It writes dx, the panels dz1, h *
//        keep_1 and dt2, and dgamma, dbeta; dW1 = x^T dz1 and dW2 = (h *
//        keep_1)^T dt2 and the bias sums stay outside, as in the JAX wrapper.
//
// Bound on the H100: latency.  A forward is 2*M*E*(4E) FLOPs per video (21
// MFLOP at M=40, E=256; the backward about three times that).  The FFN
// forward's products give 40 blocks each at epic's B=1, M=300, E=256,
// F=512 (its LayerNorm 19); the chain of its three launches, not the 0.16
// GFLOP (2.3 us at 67 TFLOP/s), is its time.
// The SA forward at epic's B=1, M=300, H=8 gives its attention kernel 80
// blocks and its row kernels 10.  The SA backward's products are 24 R E^2
// FLOPs (0.50 GFLOP at the flagship: 3 us as three TF32 passes at 495
// TFLOP/s), its attention terms 12 B M^2 E; its eleven launches, each a few
// microseconds of latency, are its time (0.107 ms at the flagship's shape,
// four tower GEMMs 0.053 of it).
#include <math.h>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kFwdRows = 32;  // token rows of the SA forward's projection and out-projection blocks

// rows [r0, r0 + TBM) of A @ W (W: K x N, row-major, f32 or bf16), the
// columns from n_lo up to n_hi; epi(r, c, acc) takes each finished value of
// a row r < M
template <int TBM, class LoadA, class Epi, class TW>
__device__ __forceinline__ void rows_gemm(LoadA load_a, const TW* __restrict__ W, int K, int N,
                                          int r0, int M, Epi epi, fk::GemmSmem<TBM>& s,
                                          int n_lo = 0, int n_hi = 1 << 30) {
  constexpr int RM = TBM / 8;
  float acc[RM][8];
  for (int n0 = n_lo; n0 < min(N, n_hi); n0 += fk::kBN) {
    fk::gemm_pass<TBM>(acc, load_a, W, N, K, n0, N, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + fk::pass_row<TBM>(i);
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < N) epi(r, c, acc[i][j]);
      }
    }
  }
}

// A element (r, k) of the row tile at r0: src[r0 + r][k] (+ pos), zero past
// M rows.  `src` may have been written earlier in this kernel: plain loads.
struct Rows {
  const float* src;
  const float* pos;
  int Pp, r0, M, K;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const int row = r0 + r;
    if (row >= M) return 0.f;
    float v = src[(size_t)row * K + k];
    if (pos != nullptr && k < Pp) v += __ldg(pos + (size_t)row * Pp + k);
    return v;
  }
};

// A dropout mask as the SA backward reads it, by the element's index over
// the mask's logical shape: the replayed mask tensor where one is given,
// else the forward's hash of (seed, stream, index) (SA stream 0 over (B,
// H*M, M), stream 1 over (B, M, E): the bits of ops/sa_layer.py::
// sa_dropout_masks), else no dropout.
struct Keep {
  const float* mask;
  fk::Dropout drop;
  uint32_t seed;  // drop's seed, read once a block
  __device__ __forceinline__ Keep(const float* m, fk::Dropout d)
      : mask(m), drop(d), seed(m == nullptr ? d.load_seed() : 0u) {}
  __device__ __forceinline__ bool on() const { return mask != nullptr || drop.seed != nullptr; }
  __device__ __forceinline__ float at(size_t i) const {
    return mask != nullptr ? __ldg(mask + i) : drop.keep((uint32_t)i, seed);
  }
};

// Per-row LayerNorm statistics (two-pass mean and 1/sqrt(var + eps)) of M
// rows of width E, one warp per row, into mean[M], rstd[M].
__device__ __forceinline__ void ln_stats(const float* base, int M, int E, float eps, float* mean,
                                         float* rstd) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < M; r += fk::kWarps) {
    const float* row = base + (size_t)r * E;
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += row[c];
    const float mu = fk::warp_sum(s) / E;
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float inv = rsqrtf(fk::warp_sum(v) / E + eps);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = inv;
    }
  }
}

// The FFN forward and backward over (32-row tile, 256-column chunk, K slice
// of 128) blocks of the batch's B * M token rows (every step works row by
// row: the rows of all the videos are one row space, the dropout masks'
// indices too).  A video a block, as the TPU kernels run, ran one SM of 132
// at epic's batch of one (the forward 0.68 ms at M=300, the backward 1.47).
// Every product is the f32 FMA core's, in K slices of 128 to blocks of
// their own, each writing its partial product; the next step adds the
// partials in slice order: a 16-deep chunk of the core costs about a
// microsecond of latency whatever its work, so a 256- or 512-deep product in
// one block was the longest link of the chain.  The forward is three
// launches (x W1; hk W2, hk staged from the first product's slices; the
// residual and the LayerNorm per 16-row tile), the backward six; both stage
// z1 and hk with the same kernel in the same order, so the backward's
// recomputed ReLU inputs are the forward's bit for bit.  The backward's
// LayerNorm column sums go per row tile (fixed-order partials, added in tile
// order by ffn_finish_kernel).  The workspaces' layout is ffn_workspace's
// alone: the entries and their callers read it from there.
constexpr int kFfnRows = 32;
constexpr int kFfnSlice = 128;  // K of one partial product
constexpr int kLnRows = 16;     // token rows of a LayerNorm block

// sum of the partials of element e in slice order (slice stride n)
__device__ __forceinline__ float slice_sum(const float* __restrict__ part, size_t n, int slices,
                                           size_t e) {
  float v = __ldg(part + e);
#pragma unroll 4
  for (int k = 1; k < slices; ++k) v += __ldg(part + k * n + e);  // loads issued 4 at a time
  return v;
}

// Where a K-slice product's A operand comes from: a panel (x, dt2); or the
// step that follows the product before it, done as the elements are
// staged: hk = relu(z1) * keep_1 with z1 = (x W1's slices) + b1, or dz1 =
// (dt2 W2^T's slices) * keep_1 * (z1 > 0).  The backward's blocks of the
// first column chunk also write what they stage (z1 and hk, or dz1): every
// other block recomputes the same values, so no step waits for another.
// keep_1 is a replayed mask tensor (the backward's, where the caller gives
// one) or hashed inline (FFN stream 0 over (B, M, F), the bits of
// ffn_dropout_masks).
enum FfnA { kPanel = 0, kHidden = 1, kDz1 = 2 };

struct FfnSlice {
  const float* A;     // kPanel: the panel (R x K, row stride ld)
  const float* pa;    // kHidden, kDz1: the previous product's slices (n_pa, R, K)
  int n_pa;
  const float* bias;  // kHidden: b1
  const float* keep;  // keep_1 or null
  float* z1;          // kHidden: written; kDz1: read (R x K)
  float* out;         // kHidden: hk; kDz1: dz1 (written by the first column chunk, row
                      // stride ld; null in the forward, which writes neither)
  int ld;
  fk::Dropout drop;   // without keep: keep_1 hashed (a null seed: none)
};

// per (32-row tile, K slice, 256 columns of N): the slice's partial product
// A[:, slice] W[slice, :] (A: R x K, W: K x N) into part[slice] (R x N)
// B16 (the mixed-precision forms, ffn_sublayer16): kPanel rounds x to bf16
// as it stages it and reads a bf16 W1; kHidden stages hk = relu(z1) with z1 =
// bf16(bf16(x W1's slices) + bf16(b1)) (JAX's bf16=True rounding points);
// kDz1 writes dz1 as it is and multiplies bf16(dz1) (_ffn_bwd_kernel's
// _cast(dz1, bf16) before its product with W1^T)
template <int AM, class TW = float, bool B16 = false>
__global__ void __launch_bounds__(fk::kThreads)
ffn_slice_kernel(const FfnSlice a, const TW* __restrict__ W, float* __restrict__ part, int R,
                 int K, int N) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<kFfnRows>& s = *reinterpret_cast<fk::GemmSmem<kFfnRows>*>(smem_raw);
  const int r0 = blockIdx.x * kFfnRows, k0 = blockIdx.y * kFfnSlice, n0 = blockIdx.z * fk::kBN;
  const int ks = min(kFfnSlice, K - k0);
  const bool write = blockIdx.z == 0 && a.out != nullptr;
  const size_t RK = (size_t)R * K;
  const uint32_t seed = a.drop.load_seed();
  float* out = part + (size_t)blockIdx.y * R * N;
  rows_gemm<kFfnRows>(
      [&](int r, int k) {
        const int row = r0 + r;
        if (row >= R) return 0.f;
        const size_t e = (size_t)row * K + k0 + k, eo = (size_t)row * a.ld + k0 + k;
        if (AM == kPanel) return B16 ? fk::bf16_round(a.A[eo]) : a.A[eo];
        if (AM == kHidden) {  // z1 = x W1 + b1; hk = relu(z1) * keep_1
          const float v =
              B16 ? fk::bf16_round(fk::bf16_round(slice_sum(a.pa, RK, a.n_pa, e)) +
                                   fk::bf16_round(__ldg(a.bias + k0 + k)))
                  : slice_sum(a.pa, RK, a.n_pa, e) + __ldg(a.bias + k0 + k);
          float h = fmaxf(v, 0.f);
          if (a.keep != nullptr)
            h *= __ldg(a.keep + e);
          else if (a.drop.seed != nullptr)
            h *= a.drop.keep((uint32_t)e, seed);
          if (write) {
            a.z1[e] = v;
            a.out[eo] = h;
          }
          return h;
        }
        // dz1 = (dt2 W2^T) * keep_1 * (z1 > 0)
        float v = slice_sum(a.pa, RK, a.n_pa, e);
        if (a.keep != nullptr)
          v *= __ldg(a.keep + e);
        else if (a.drop.seed != nullptr)
          v *= a.drop.keep((uint32_t)e, seed);
        const float d = __ldg(a.z1 + e) > 0.f ? v : 0.f;
        if (write) a.out[eo] = d;
        return B16 ? fk::bf16_round(d) : d;
      },
      W + (size_t)k0 * N, ks, N, r0, R,
      [&](int r, int c, float v) { out[(size_t)r * N + c] = v; }, s, n0, n0 + fk::kBN);
}

// Per 16-row tile, whole E rows: res = x + drop_2((hk W2's slices) + b2)
// into rs (the tile's rows in shared memory, E wide) and, where g is
// given, the tile's g rows into gs; then the rows' LayerNorm statistics
// (ln_stats's two-pass sums).  Four columns a thread at a time with every
// load issued before any is used (a scalar loop where E % 4 != 0 or F >
// 2048): row-serial global loads took ~30 us a tile.  keep_2 is a replayed
// mask tensor (the backward's, where given) or hashed inline (FFN stream 1
// over (B, M, E); the SA backward's keep_o, SA stream 1, the same way).
// Both directions' LayerNorm kernels start so.
constexpr int kMaxSlices = 16;  // F up to 2048 in the four-column staging

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void ffn_ln_stage(const float* __restrict__ x,
                                             const float* __restrict__ t2,
                                             const float* __restrict__ b2,
                                             const float* __restrict__ keep_2,
                                             const fk::Dropout& drop_2,
                                             const float* __restrict__ g, float* rs, float* gs,
                                             float* mean, float* rstd, int r0, int rows, int R,
                                             int E, int slices, float eps) {
  const int n = rows * E;
  const size_t t0 = (size_t)r0 * E, RE = (size_t)R * E;
  const uint32_t seed = drop_2.load_seed();
  const bool hash = keep_2 == nullptr && drop_2.seed != nullptr;
  const auto keep = [&](size_t e) { return drop_2.keep((uint32_t)e, seed); };
  if ((E & 3) == 0 && slices <= kMaxSlices) {
    for (int i = threadIdx.x; i < n / 4; i += fk::kThreads) {
      const size_t e = t0 + 4 * (size_t)i;
      float4 p[kMaxSlices];
#pragma unroll
      for (int k = 0; k < kMaxSlices; ++k)
        if (k < slices) p[k] = ld4(t2 + k * RE + e);
      const float4 bb = ld4(b2 + (4 * i) % E), xv = ld4(x + e);
      const float4 kv = keep_2 != nullptr ? ld4(keep_2 + e)
                        : hash ? make_float4(keep(e), keep(e + 1), keep(e + 2), keep(e + 3))
                               : make_float4(1.f, 1.f, 1.f, 1.f);
      float4 v = p[0];
#pragma unroll
      for (int k = 1; k < kMaxSlices; ++k)
        if (k < slices) {
          v.x += p[k].x;
          v.y += p[k].y;
          v.z += p[k].z;
          v.w += p[k].w;
        }
      v = make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
      if (keep_2 != nullptr || hash)
        v = make_float4(v.x * kv.x, v.y * kv.y, v.z * kv.z, v.w * kv.w);
      reinterpret_cast<float4*>(rs)[i] =
          make_float4(v.x + xv.x, v.y + xv.y, v.z + xv.z, v.w + xv.w);
      if (g != nullptr) reinterpret_cast<float4*>(gs)[i] = ld4(g + e);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += fk::kThreads) {
      const size_t e = t0 + i;
      float v = __ldg(t2 + e);
      for (int k = 1; k < slices; ++k) v += __ldg(t2 + k * RE + e);
      v += __ldg(b2 + i % E);
      if (keep_2 != nullptr)
        v *= __ldg(keep_2 + e);
      else if (hash)
        v *= keep(e);
      rs[i] = v + __ldg(x + e);
      if (g != nullptr) gs[i] = __ldg(g + e);
    }
  }
  __syncthreads();
  ln_stats(rs, rows, E, eps, mean, rstd);
  __syncthreads();
}

// 3 (forward). per 16-row tile: y = LN(x + drop_2(hk W2 + b2)) (row stride E)
__global__ void __launch_bounds__(fk::kThreads)
ffn_fwd_ln_kernel(const float* __restrict__ x, const float* __restrict__ t2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  const float* __restrict__ beta, fk::Dropout drop_2, float* __restrict__ y,
                  int R, int E, int slices, float eps) {
  extern __shared__ float4 smem_raw[];
  float* rs = reinterpret_cast<float*>(smem_raw);  // [rows][E]: res
  __shared__ float mean[kLnRows], rstd[kLnRows];
  const int r0 = blockIdx.x * kLnRows;
  const int rows = min(kLnRows, R - r0);
  ffn_ln_stage(x, t2, b2, nullptr, drop_2, nullptr, rs, nullptr, mean, rstd, r0, rows, R, E,
               slices, eps);
  float* yt = y + (size_t)r0 * E;
  for (int i = threadIdx.x; i < rows * E; i += fk::kThreads) {
    const int r = i / E, c = i - r * E;
    yt[i] = (rs[i] - mean[r]) * rstd[r] * __ldg(gamma + c) + __ldg(beta + c);
  }
}

// 2'. per 16-row tile, whole E rows: res = x + drop_2((hk W2's slices) +
//    b2), its LayerNorm statistics and backward (dres into res; dgamma and
//    dbeta of the tile into part[tile]) and dt2 = dres * keep_2 (row stride
//    ld), the LayerNorm on the tile's res and g rows in shared memory: the
//    rows' two-pass statistics (ln_stats), the column sums in row order, then
//    dres = rstd (gg - mean(gg) - xhat mean(gg xhat)), gg = g gamma.  The SA
//    backward's LayerNorm step too (t2 = c Wo, one slice; b2 = bo; keep_o).
__global__ void __launch_bounds__(fk::kThreads)
ffn_bwd_ln_kernel(const float* __restrict__ x, const float* __restrict__ t2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  const float* __restrict__ keep_2, fk::Dropout drop_2,
                  const float* __restrict__ g, float* __restrict__ res, float* __restrict__ dt2,
                  int ld, float* __restrict__ part, int R, int E, int slices, float eps) {
  extern __shared__ float4 smem_raw[];
  float* rs = reinterpret_cast<float*>(smem_raw);  // [rows][E]: res, then dres
  float* gs = rs + kLnRows * E;                    // [rows][E]: g
  __shared__ float mean[kLnRows], rstd[kLnRows];
  const int tile = blockIdx.x, r0 = tile * kLnRows;
  const int rows = min(kLnRows, R - r0);
  const int n = rows * E;
  const size_t t0 = (size_t)r0 * E;
  ffn_ln_stage(x, t2, b2, keep_2, drop_2, g, rs, gs, mean, rstd, r0, rows, R, E, slices, eps);
  const int lane = threadIdx.x & 31;
  float* pt = part + (size_t)tile * 2 * E;
  for (int c = threadIdx.x; c < E; c += fk::kThreads) {  // the tile's column sums, row order
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float gv = gs[r * E + c];
      sg = fmaf(gv, (rs[r * E + c] - mean[r]) * rstd[r], sg);
      sb += gv;
    }
    pt[c] = sg;
    pt[E + c] = sb;
  }
  __syncthreads();  // every column sum has read rs before it is overwritten
  for (int r = threadIdx.x >> 5; r < rows; r += fk::kWarps) {
    float* row = rs + r * E;
    const float* gr = gs + r * E;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float gg = gr[c] * __ldg(gamma + c);
      s1 += gg;
      s2 += gg * (row[c] - mean[r]) * rstd[r];
    }
    s1 = fk::warp_sum(s1) / E;
    s2 = fk::warp_sum(s2) / E;
    for (int c = lane; c < E; c += 32) {
      const float xhat = (row[c] - mean[r]) * rstd[r];
      row[c] = rstd[r] * (gr[c] * __ldg(gamma + c) - s1 - xhat * s2);
    }
  }
  __syncthreads();
  const uint32_t seed = drop_2.load_seed();
  for (int i = threadIdx.x; i < n; i += fk::kThreads) {
    const float d = rs[i];
    res[t0 + i] = d;
    const float k = keep_2 != nullptr       ? __ldg(keep_2 + t0 + i)
                    : drop_2.seed != nullptr ? drop_2.keep((uint32_t)(t0 + i), seed)
                                             : 1.f;
    dt2[(size_t)(r0 + i / E) * ld + i % E] = d * k;
  }
}

// 4'. dx = (dz1 W1^T's slices) + dres; and (the blocks past dx's elements)
//    dgamma | dbeta = the row tiles' partials (tiles, 2, E) summed in tile order
__global__ void __launch_bounds__(fk::kThreads)
ffn_finish_kernel(const float* __restrict__ t1, const float* __restrict__ dres,
                  float* __restrict__ dx, const float* __restrict__ part, float* __restrict__ dgb,
                  int R, int E, int slices, int tiles) {
  const size_t RE = (size_t)R * E;
  const size_t nx = (RE + fk::kThreads - 1) / fk::kThreads;
  if (blockIdx.x < nx) {
    const size_t e = (size_t)blockIdx.x * fk::kThreads + threadIdx.x;
    if (e < RE) dx[e] = slice_sum(t1, RE, slices, e) + __ldg(dres + e);
    return;
  }
  const int i = (int)(blockIdx.x - nx) * fk::kThreads + threadIdx.x;
  if (i >= 2 * E) return;
  float v = 0.f;
  for (int p = 0; p < tiles; ++p) v += __ldg(part + (size_t)p * 2 * E + i);
  dgb[i] = v;
}

// W1^T and W2^T for steps 3 and 4 (blockIdx.z 0 and 1), through 32 x 33
// tiles of shared memory; and (blockIdx.z 2) x into the weight products'
// rhs and the ones columns of both operands (ffn_workspace)
__global__ void __launch_bounds__(fk::kThreads)
ffn_transpose_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                     float* __restrict__ wt, const float* __restrict__ x, float* __restrict__ lhs,
                     int ldl, float* __restrict__ rhs, int ldr, int n_rows, int E, int F) {
  __shared__ float tile[32][33];
  const int z = blockIdx.z;
  if (z == 2) {
    const int nb = gridDim.x * gridDim.y;
    const size_t nl = (size_t)n_rows * ldl, nr = (size_t)n_rows * ldr;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * fk::kThreads + threadIdx.x;
         i < n_rows * (E + 1); i += nb * fk::kThreads) {
      const int r = i / (E + 1), c = i % (E + 1);
      if (c < E) {
        rhs[(size_t)r * ldr + c] = __ldg(x + (size_t)r * E + c);
        continue;
      }
      rhs[(size_t)r * ldr + E] = rhs[nr + (size_t)r * ldr + E] = 1.f;
      lhs[(size_t)r * ldl + F] = lhs[nl + (size_t)r * ldl + F] = 1.f;
    }
    return;
  }
  const int R = z == 0 ? E : F, Cc = z == 0 ? F : E;  // the source is R x Cc
  const float* src = z == 0 ? w1 : w2;
  float* dst = wt + (size_t)z * E * F;
  const int c0 = blockIdx.x * 32, rr0 = blockIdx.y * 32;
  if (c0 >= Cc || rr0 >= R) return;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += fk::kWarps)
    if (rr0 + i < R && c0 + tx < Cc) tile[i][tx] = __ldg(src + (size_t)(rr0 + i) * Cc + c0 + tx);
  __syncthreads();
  for (int i = ty; i < 32; i += fk::kWarps)
    if (c0 + i < Cc && rr0 + tx < R) dst[(size_t)(c0 + i) * R + rr0 + tx] = tile[tx][i];
}

// ---------------------------------------------------------------------------
// The SA attention kernels, over (tile of QT query rows or keys, head, video)
// blocks, so that a video's attention spreads over H * ceil(M / QT) blocks.

constexpr int QT = 32;  // query rows or keys of an attention block

// Shared memory (floats) of the attention kernels over query tiles: one
// head's k and v rows of every key, the tile's two (QT, hd + 1) panels (q
// or dc, the forward's second one unused), and one M-long row per warp.
__host__ __device__ inline size_t sa_rows_smem_floats(int M, int hd) {
  return (size_t)2 * M * (hd + 1) + (size_t)2 * QT * (hd + 1) + (size_t)fk::kWarps * M;
}

__device__ __forceinline__ float dot_h(const float* a, const float* b, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// 1 (forward). q = (x + pos) Wq + bq, k = (x + pos) Wk + bk, v = x Wv + bv
//    into qkv[b][0..2]: one block per (kFwdRows-row tile, video, projection)
__global__ void __launch_bounds__(fk::kThreads)
sa_qkv_kernel(const float* __restrict__ x, const float* __restrict__ pos, int Pp,
              const float* __restrict__ wq, const float* __restrict__ bq,
              const float* __restrict__ wk, const float* __restrict__ bk,
              const float* __restrict__ wv, const float* __restrict__ bv,
              float* __restrict__ qkv, int M, int E) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<kFwdRows>& s = *reinterpret_cast<fk::GemmSmem<kFwdRows>*>(smem_raw);
  const int r0 = blockIdx.x * kFwdRows;
  const int b = blockIdx.y;
  const int which = blockIdx.z;
  const size_t ME = (size_t)M * E;
  const float* W = which == 0 ? wq : which == 1 ? wk : wv;
  const float* bias = which == 0 ? bq : which == 1 ? bk : bv;
  float* out = qkv + ((size_t)b * 3 + which) * ME;
  rows_gemm<kFwdRows>(Rows{x + b * ME, which < 2 ? pos : nullptr, Pp, r0, M, E}, W, E, E, r0, M,
                      [&](int r, int c, float v) { out[(size_t)r * E + c] = v + __ldg(bias + c); },
                      s);
}

// rows [r0, r0 + n) of head h of a panel with row stride ld into dst[n][hd + 1]
// by cp.async (4-byte copies: the odd row stride), zero past M; the caller
// waits (fk::cp_async_wait_all) and synchronises
__device__ __forceinline__ void stage_head_async(float* dst, const float* src, int ld, int r0,
                                                 int n, int M, int h, int hd) {
  const int ldh = hd + 1;
  for (int i = threadIdx.x; i < n * hd; i += fk::kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const bool ok = r0 + r < M;
    fk::cp_async<4>(dst + r * ldh + d, ok ? src + (size_t)(r0 + r) * ld + h * hd + d : src, ok);
  }
}

// the same from a bf16 panel, converted to f32 as it is stored (plain loads:
// cp.async cannot convert); the caller's wait is then a no-op
__device__ __forceinline__ void stage_head_async(float* dst, const fk::bf16* src, int ld, int r0,
                                                 int n, int M, int h, int hd) {
  const int ldh = hd + 1;
  for (int i = threadIdx.x; i < n * hd; i += fk::kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    dst[r * ldh + d] = r0 + r < M ? fk::ldf(src + (size_t)(r0 + r) * ld + h * hd + d) : 0.f;
  }
}

template <class TE>
__device__ __forceinline__ void stage_head(float* dst, const TE* src, int ld, int r0, int n, int M,
                                           int h, int hd) {
  stage_head_async(dst, src, ld, r0, n, M, h, hd);
}

// 2 (forward). per (query tile, head, video): each query row's softmax over
//    the M keys by one warp and its context c_h = (P * keep) v_h, into c (B,
//    M, E).  q, k and v of video b, token m sit at qkv + b * bstride + m * ld
//    (+ koff, + voff), head h's columns at + h * hd; K_h and V_h of every key
//    and the tile's q rows are staged by cp.async.  The keep values are
//    hashed inline (drop: SA stream 0 over (B, H*M, M), the index layout of
//    ops/sa_layer.py::sa_dropout_masks, so the bits equal the mask
//    kernel's; the backward's probabilities kernel draws the same).
//    TE: the element type of q, k and v: float, or bf16 (the mixed-precision
//    form: the probabilities are rounded to bf16 for the context, as JAX's
//    _sa_fwd_kernel casts P before its product with v; the softmax is f32).
template <class TE>
__global__ void __launch_bounds__(fk::kThreads)
sa_context_kernel(const TE* __restrict__ qkv, long long bstride, int ld, int koff, int voff,
                  fk::Dropout drop, float* __restrict__ c, int M, int E, int H) {
  constexpr bool kB16 = std::is_same<TE, fk::bf16>::value;
  extern __shared__ float4 smem_raw[];
  const int hd = E / H;
  const int ldh = hd + 1;
  const int m0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t ME = (size_t)M * E;
  const TE* qb = qkv + (size_t)b * bstride;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + (size_t)M * ldh;
  float* qs = vs + (size_t)M * ldh;
  float* pw = qs + (size_t)2 * QT * ldh + (size_t)ty * M;
  stage_head(ks, qb + koff, ld, 0, M, M, h, hd);
  stage_head(vs, qb + voff, ld, 0, M, M, h, hd);
  stage_head(qs, qb, ld, m0, QT, M, h, hd);
  const uint32_t seed = drop.load_seed();
  fk::cp_async_wait_all();
  __syncthreads();
  for (int r = ty; r < min(QT, M - m0); r += fk::kWarps) {
    const int m = m0 + r;
    const size_t row = ((size_t)b * H + h) * M + m;
    const float* qr = qs + r * ldh;
    for (int j = tx; j < M; j += 32) pw[j] = dot_h(qr, ks + j * ldh, hd) * scale;
    float mx = -INFINITY;
    for (int j = tx; j < M; j += 32) mx = fmaxf(mx, pw[j]);
    mx = fk::warp_max(mx);
    float sum = 0.f;
    for (int j = tx; j < M; j += 32) sum += expf(pw[j] - mx);
    const float inv = 1.f / fk::warp_sum(sum);
    for (int j = tx; j < M; j += 32) {  // each lane rewrites only its own j
      float p = expf(pw[j] - mx) * inv;
      if (drop.seed != nullptr) p *= drop.keep((uint32_t)row * (uint32_t)M + (uint32_t)j, seed);
      pw[j] = kB16 ? fk::bf16_round(p) : p;
    }
    __syncwarp();
    for (int d = tx; d < hd; d += 32) {
      float o = 0.f;
      for (int j = 0; j < M; ++j) o = fmaf(pw[j], vs[j * ldh + d], o);
      c[(size_t)b * ME + (size_t)m * E + h * hd + d] = o;
    }
    __syncwarp();
  }
}

// 3 (forward). per (TBM-row tile, video): y = LN(x + drop_o(c Wo + bo)), the
//    output dropout hashed inline (SA stream 1 over (B, M, E)); a tile holds
//    whole rows, so the LayerNorm runs in the block
template <int TBM>
__global__ void __launch_bounds__(fk::kThreads)
sa_out_ln_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ wo, const float* __restrict__ bo,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ y, int M, int E, float eps, fk::Dropout drop_o) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<TBM>& s = *reinterpret_cast<fk::GemmSmem<TBM>*>(smem_raw);
  const int r0 = blockIdx.x * TBM;
  const int b = blockIdx.y;
  const size_t off = (size_t)b * M * E;
  const uint32_t seed_o = drop_o.load_seed();
  rows_gemm<TBM>(Rows{c + off, nullptr, 0, r0, M, E}, wo, E, E, r0, M,
                 [&](int r, int col, float v) {
                   const size_t e = (size_t)r * E + col;
                   v += __ldg(bo + col);
                   if (drop_o.seed != nullptr)
                     v *= drop_o.keep((uint32_t)(off + e), seed_o);
                   y[off + e] = v + __ldg(x + off + e);
                 }, s);
  __syncthreads();
  const int rows = min(TBM, M - r0);
  fk::layer_norm_rows(y + off + (size_t)r0 * E, rows, rows, E, gamma, beta, eps);
}

// ---------------------------------------------------------------------------
// The SA backward's own kernels (the entry, fk_sa_bwd, is below).

// The SA backward's workspace (floats; each region starts on 64 floats),
// the batch's R = B * M token rows one row space:
//   lens   R (an int: the GEMMs' one row length)
//   pack   the eight weights as tc_rows_gemm multiplies them (fk_k6_pack's
//          layout: hi then lo, N = E rows of Kp = E rounded up to 32): Wq^T,
//          Wk^T, Wv^T (the q | k | v problems), then, each in S K slices of
//          Kp / S, Wo^T (c Wo), Wo (dout Wo^T), Wq, Wk, Wv (the parts of dx)
//   rows   (R, 3E + 4) = [x + pos | x | c | 1 0 0 0]: the A operand of the q,
//          k, v and out products and of the weight products
//   qkv    (3, R, E): q, k and v
//   o      (S, R, E): c Wo;  dres (R, E);  dc (S, R, E): dout Wo^T
//   grads  (R, 4E) = [dq | dk | dv | dout]: the A operand of dx, the B
//          operand of the weight products
//   dxo    (3, S, R, E): dq Wq^T, dk Wk^T, dv Wv^T
//   P, dS  (B H M, M) each: the probabilities (then P * keep) and dS
//   part   (ceil(R / 16), 2, E): the LayerNorm tiles' dgamma | dbeta
//   wpart  (chunks, Sw): each chunk of Kc rows' weight products side by
//          side, Sw = [dWq | dWk] (E, 2E), dWv (E, E), dWo (E, E), the bias
//          sums (4E)
// and the results, in a buffer of their own (out_floats; the caller's
// gradients may outlive the call, and the scratch need not):
//   dx (R, E), dpos (M, Pp), then dw: dWq, dWk, dWv, dWo (E, E) each, dbq,
//   dbk, dbv, dbo, dgamma, dbeta (E) each
constexpr int kSaPacks = 8;
constexpr int kSaPairs = 4;
constexpr int kH100SMs = 132;  // an H100's SMs: the weight products' chunks fill one wave

struct SaWorkspace {
  size_t lens, pack, rows, qkv, o, dres, dc, grads, dxo, P, dS, part, wpart, total;
  size_t dx, dpos, dw, out_floats;  // offsets into the results' buffer
  int Kp, S, Kc, chunks, ln_tiles;
  long long Sw;  // floats of one chunk's weight products
};

// K slices of the out, dc and dx products: 4 or 2, whichever leaves each
// slice whole 32-deep steps, two or more; else 1.  A 128 x 128 tile's chain of
// K steps is the tower GEMM's time at these row counts (6 tiles a product at
// the flagship's R = 320; ~2.3 us a 32-deep step promoted every 8 deep, H100
// 80GB HBM3, 700 W), so a product takes a problem a slice and its consumer
// adds the slices as it reads them.  q | k | v stays whole: its consumers
// stage every key's rows, in each of a head's query tiles.
inline int sa_slices(int Kp) {
  for (int s = 4; s > 1; s /= 2)
    if (Kp % (32 * s) == 0 && Kp / s >= 64) return s;
  return 1;
}

// the weight products' (a_c0, Ca, b_c0, Cb): [dWq | dWk] = (x + pos)^T [dq |
// dk], dWv = x^T dv, dWo = c^T dout, and the bias sums 1^T [dq | dk | dv | dout]
inline void sa_pairs(int E, int* p) {
  const int v[4 * kSaPairs] = {0, E, 0, 2 * E, E, E, 2 * E, E, 2 * E, E, 3 * E, E, 3 * E, 1, 0,
                               4 * E};
  for (int i = 0; i < 4 * kSaPairs; ++i) p[i] = v[i];
}

inline SaWorkspace sa_workspace(int B, int M, int E, int H, int Pp) {
  const size_t R = (size_t)B * M;
  SaWorkspace w{};
  w.Kp = (E + 31) / 32 * 32;
  w.S = sa_slices(w.Kp);
  int tiles = 0, p[4 * kSaPairs];
  sa_pairs(E, p);
  for (int i = 0; i < kSaPairs; ++i)
    tiles += (p[4 * i + 1] + 127) / 128 * ((p[4 * i + 3] + 127) / 128);
  const int want = kH100SMs / tiles > 1 ? kH100SMs / tiles : 1;
  const int per = (int)((R + want - 1) / want);
  w.Kc = (per + 31) / 32 * 32;
  w.chunks = (int)((R + w.Kc - 1) / w.Kc);
  w.ln_tiles = (int)((R + kLnRows - 1) / kLnRows);
  w.Sw = 4LL * E * E + 4LL * E;
  size_t at = 0;
  const auto take = [&](size_t n) {
    const size_t o = at;
    at += (n + 63) / 64 * 64;
    return o;
  };
  w.lens = take(1);
  w.pack = take((size_t)kSaPacks * 2 * E * w.Kp);
  w.rows = take(R * (3 * E + 4));
  w.qkv = take(3 * R * E);
  w.o = take(w.S * R * E);
  w.dres = take(R * E);
  w.dc = take(w.S * R * E);
  w.grads = take(R * 4 * E);
  w.dxo = take(3 * w.S * R * E);
  w.P = take(R * H * M);
  w.dS = take(R * H * M);
  w.part = take((size_t)w.ln_tiles * 2 * E);
  w.wpart = take((size_t)w.chunks * w.Sw);
  w.total = at;
  at = 0;
  w.dx = take(R * E);
  w.dpos = take((size_t)M * Pp);
  w.dw = take((size_t)w.Sw + 2 * E);
  w.out_floats = at;
  return w;
}

// 0. the GEMMs' operands in one launch: blocks [0, 8 * tiles) pack the
//    weights (a 32 x 32 tile of one pack a block, through shared memory, the
//    TF32 hi and lo parts; K past E zero), the others write rows = [x + pos
//    | x | 0 | 1 0 0 0] (c's columns zeroed: the q, k, v products read past
//    their E channels where E % 32 != 0) and lens[0] = R
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_prep_kernel(const float* __restrict__ x, const float* __restrict__ pos, int Pp,
                   const float* __restrict__ wq, const float* __restrict__ wk,
                   const float* __restrict__ wv, const float* __restrict__ wo,
                   float* __restrict__ pack, float* __restrict__ rows, int* __restrict__ lens,
                   int R, int M, int E, int Kp, int S) {
  __shared__ float tile[32][33];
  const int tn = (E + 31) / 32, tk = Kp / 32, per = tn * tk;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < kSaPacks * per) {
    const int j = blockIdx.x / per, t = blockIdx.x - j * per;
    const float* src = j == 0 || j == 5 ? wq : j == 1 || j == 6 ? wk : j == 2 || j == 7 ? wv : wo;
    const bool tr = j < 4;  // W^T: dst[n][k] = W[k][n]; else dst[n][k] = W[n][k]
    const int n0 = (t / tk) * 32, k0 = (t % tk) * 32;
    const int tx = tid & 31, ty = tid >> 5;
    for (int i = ty; i < 32; i += fk::kWarps) {
      if (tr) {  // tile[k][n], rows of W read whole
        const int k = k0 + i, n = n0 + tx;
        tile[i][tx] = k < E && n < E ? __ldg(src + (size_t)k * E + n) : 0.f;
      } else {
        const int n = n0 + i, k = k0 + tx;
        tile[i][tx] = k < E && n < E ? __ldg(src + (size_t)n * E + k) : 0.f;
      }
    }
    __syncthreads();
    const int Ks = j < 3 ? Kp : Kp / S;  // one K slice; a 32-wide tile lies in one
    const int sl = k0 / Ks;
    float* dst = pack + (size_t)j * 2 * E * Kp + (size_t)sl * 2 * E * Ks;
    for (int i = ty; i < 32; i += fk::kWarps) {
      const int n = n0 + i, k = k0 - sl * Ks + tx;
      if (n >= E) continue;
      float hi, lo;
      tc::split(tr ? tile[tx][i] : tile[i][tx], hi, lo);
      dst[(size_t)n * Ks + k] = hi;
      dst[(size_t)E * Ks + (size_t)n * Ks + k] = lo;
    }
    return;
  }
  const int w4 = (3 * E + 4) / 4;
  const long long nb = (long long)(gridDim.x - kSaPacks * per) * fk::kThreads;
  const long long t0 = (long long)(blockIdx.x - kSaPacks * per) * fk::kThreads + tid;
  if (t0 == 0) lens[0] = R;
  for (long long i = t0; i < (long long)R * w4; i += nb) {
    const long long r = i / w4;
    const int c = (int)(i - r * w4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < 2 * E) {  // x's rows may start off 16 bytes: four loads
      const int cc = c < E ? c : c - E;
      const float* xr = x + r * E + cc;
      v = make_float4(__ldg(xr), __ldg(xr + 1), __ldg(xr + 2), __ldg(xr + 3));
      if (c < E && pos != nullptr) {
        const float* pr = pos + (r % M) * Pp;
        if (cc < Pp) v.x += __ldg(pr + cc);
        if (cc + 1 < Pp) v.y += __ldg(pr + cc + 1);
        if (cc + 2 < Pp) v.z += __ldg(pr + cc + 2);
        if (cc + 3 < Pp) v.w += __ldg(pr + cc + 3);
      }
    } else if (c == 3 * E) {
      v.x = 1.f;
    }
    reinterpret_cast<float4*>(rows + r * (3 * E + 4))[c / 4] = v;
  }
}

// The backward's attention over query tiles: per (32-query tile, head,
// video), warp w owns the tile's rows w, w + 8, w + 16, w + 24 and works on
// the four at once, so that each key row read from shared memory serves four
// query rows (one row at a time, two shared-memory reads a product, took
// 0.038-0.044 ms a kernel at epic's B=1, M=300, four 0.021-0.027; H100 80GB
// HBM3, 700 W).  In
// shared memory: one head's rows of one (M, E) panel at a time (k or v, odd
// row stride hd + 1: lane j reading key j is conflict-free), the tile's rows
// of the query-side panel (q or dc) by dimension, four rows a float4
// (rt[w][d]), and a float4 a key of the four rows' values (pw[w][j]).  Every
// sum runs in the order of the one-row kernels (d, then j, in order), so the
// results are theirs bit for bit.
constexpr int kRows4 = QT / fk::kWarps;  // query rows of a warp (4)

__host__ __device__ inline size_t sa_bwd_rows_smem_floats(int M, int hd) {
  return ((size_t)M * (hd + 1) + 3) / 4 * 4 + (size_t)QT * hd + (size_t)QT * M;
}

// the tile's rows [m0, m0 + QT) of head h of a panel (row stride ld; the sum
// of `slices` K slices sstride apart, at most 4, loaded together and added in
// order) into rt[w][d] (row w + 8 i in component i), zero past M
__device__ __forceinline__ void stage_rows4(float4* rt, const float* __restrict__ src, int ld,
                                            long long sstride, int slices, int m0, int M, int h,
                                            int hd) {
  float* r = reinterpret_cast<float*>(rt);
  for (int e = threadIdx.x; e < QT * hd; e += fk::kThreads) {
    const int row = e / hd;
    const int d = e - row * hd;
    float v = 0.f;
    if (m0 + row < M) {
      const float* p = src + (size_t)(m0 + row) * ld + h * hd + d;
      float t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] = k < slices ? __ldg(p + k * sstride) : 0.f;
      v = t[0];
#pragma unroll
      for (int k = 1; k < 4; ++k)
        if (k < slices) v += t[k];
    }
    r[((row % fk::kWarps) * hd + d) * kRows4 + row / fk::kWarps] = v;
  }
}

// the four rows' dot products with key row kr: a[i] = sum_d rw[d].i kr[d]
__device__ __forceinline__ void dot4(const float4* rw, const float* kr, int hd, float (&a)[4]) {
  a[0] = a[1] = a[2] = a[3] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float k = kr[d];
    const float4 r = rw[d];
    a[0] = fmaf(r.x, k, a[0]);
    a[1] = fmaf(r.y, k, a[1]);
    a[2] = fmaf(r.z, k, a[2]);
    a[3] = fmaf(r.w, k, a[3]);
  }
}

// o[i] = sum_j pw[j].i vs[j][d], j in order
__device__ __forceinline__ void attend4(const float4* pw, const float* vs, int ldh, int d, int M,
                                        float (&o)[4]) {
  o[0] = o[1] = o[2] = o[3] = 0.f;
  for (int j = 0; j < M; ++j) {
    const float v = vs[j * ldh + d];
    const float4 p = pw[j];
    o[0] = fmaf(p.x, v, o[0]);
    o[1] = fmaf(p.y, v, o[1]);
    o[2] = fmaf(p.z, v, o[2]);
    o[3] = fmaf(p.w, v, o[3]);
  }
}

// component i of a float4 (i a constant once the loops over it unroll)
__device__ __forceinline__ float get4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set4(float4& v, int i, float x) {
  if (i == 0)
    v.x = x;
  else if (i == 1)
    v.y = x;
  else if (i == 2)
    v.z = x;
  else
    v.w = x;
}

// 2. per (query tile, head, video): each query row's probabilities P
//    (kept, before the dropout) and its context c_h = (P * keep_a) v_h into
//    c (row stride ldc); q, k, v: (R, E) panels RE apart at qkv; keep_a the
//    replayed mask or hashed (drop: the forward's bits)
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_probs_kernel(const float* __restrict__ qkv, long long RE,
                    const float* __restrict__ keep_a, fk::Dropout drop, float* __restrict__ c,
                    int ldc, float* __restrict__ P, int M, int E, int H) {
  extern __shared__ float4 smem_raw[];
  const int hd = E / H;
  const int ldh = hd + 1;
  const int m0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t vb = (size_t)b * M * E;
  float* kv = reinterpret_cast<float*>(smem_raw);  // k, then v
  float4* rt = reinterpret_cast<float4*>(kv + ((size_t)M * ldh + 3) / 4 * 4);
  float4* pw = rt + (size_t)fk::kWarps * hd + (size_t)ty * M;
  const float4* rw = rt + (size_t)ty * hd;
  stage_head_async(kv, qkv + RE + vb, E, 0, M, M, h, hd);
  stage_rows4(rt, qkv + vb, E, 0, 1, m0, M, h, hd);
  const Keep ka(keep_a, drop);
  size_t row[kRows4];
  bool live[kRows4];
#pragma unroll
  for (int i = 0; i < kRows4; ++i) {
    const int m = m0 + ty + fk::kWarps * i;
    live[i] = m < M;
    row[i] = ((size_t)b * H + h) * M + m;
  }
  fk::cp_async_wait_all();
  __syncthreads();
  float mx[kRows4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int j = tx; j < M; j += 32) {
    float a[4];
    dot4(rw, kv + j * ldh, hd, a);
    const float4 s = make_float4(a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
    pw[j] = s;
    mx[0] = fmaxf(mx[0], s.x);
    mx[1] = fmaxf(mx[1], s.y);
    mx[2] = fmaxf(mx[2], s.z);
    mx[3] = fmaxf(mx[3], s.w);
  }
  float sum[kRows4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kRows4; ++i) mx[i] = fk::warp_max(mx[i]);
  for (int j = tx; j < M; j += 32) {
    float4 s = pw[j];
#pragma unroll
    for (int i = 0; i < kRows4; ++i) sum[i] += expf(get4(s, i) - mx[i]);
  }
  float inv[kRows4];
#pragma unroll
  for (int i = 0; i < kRows4; ++i) inv[i] = 1.f / fk::warp_sum(sum[i]);
  for (int j = tx; j < M; j += 32) {  // each lane rewrites only its own j
    float4 s = pw[j];
#pragma unroll
    for (int i = 0; i < kRows4; ++i) {
      float p = 0.f;
      if (live[i]) {
        p = expf(get4(s, i) - mx[i]) * inv[i];
        P[row[i] * M + j] = p;
        if (ka.on()) p *= ka.at(row[i] * M + j);
      }
      set4(s, i, p);
    }
    pw[j] = s;
  }
  __syncthreads();  // every warp is done with k: v takes its place
  stage_head_async(kv, qkv + 2 * RE + vb, E, 0, M, M, h, hd);
  fk::cp_async_wait_all();
  __syncthreads();
  for (int d = tx; d < hd; d += 32) {
    float o[4];
    attend4(pw, kv, ldh, d, M, o);
#pragma unroll
    for (int i = 0; i < kRows4; ++i)
      if (live[i]) c[((size_t)b * M + m0 + ty + fk::kWarps * i) * ldc + h * hd + d] = o[i];
  }
}

// 5. per (query tile, head, video): each query row m's term D = dc_h[m] .
//    c_h[m] (= sum_j p_mj dPd_mj keep_mj, also under the attention dropout);
//    dS_mj = p_mj (dPd_mj keep_mj - D) scale with p from P and dPd = dc_h
//    v_h^T, into dS, and P * keep into P; dq_h[m] = dS_m k_h into dq (row
//    stride ldg).  k, v: (R, E) panels; dc: an (R, E) panel of `slices` K
//    slices sstride apart; c at c (row stride ldc); keep_a the replayed mask
//    or hashed (drop_a)
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_dq_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dc, int slices, long long sstride,
                 const float* __restrict__ c, int ldc, const float* __restrict__ keep_a,
                 fk::Dropout drop_a, float* __restrict__ P, float* __restrict__ dS,
                 float* __restrict__ dq, int ldg, int M, int E, int H) {
  extern __shared__ float4 smem_raw[];
  const int hd = E / H;
  const int ldh = hd + 1;
  const int m0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t vb = (size_t)b * M * E;  // video b's first row of an (R, E) panel
  float* kv = reinterpret_cast<float*>(smem_raw);  // v, then k
  float4* rt = reinterpret_cast<float4*>(kv + ((size_t)M * ldh + 3) / 4 * 4);
  float4* pw = rt + (size_t)fk::kWarps * hd + (size_t)ty * M;
  const float4* rw = rt + (size_t)ty * hd;
  stage_head_async(kv, v + vb, E, 0, M, M, h, hd);
  stage_rows4(rt, dc + vb, E, sstride, slices, m0, M, h, hd);
  const Keep ka(keep_a, drop_a);
  fk::cp_async_wait_all();
  __syncthreads();
  float D[kRows4];
  size_t row[kRows4];
  bool live[kRows4];
#pragma unroll
  for (int i = 0; i < kRows4; ++i) {
    const int m = m0 + ty + fk::kWarps * i;
    live[i] = m < M;
    row[i] = ((size_t)b * H + h) * M + m;
    float dsum = 0.f;
    if (live[i]) {
      const float* cr = c + ((size_t)b * M + m) * ldc + h * hd;
      for (int d = tx; d < hd; d += 32) dsum = fmaf(get4(rw[d], i), cr[d], dsum);
    }
    D[i] = fk::warp_sum(dsum);
  }
  for (int j = tx; j < M; j += 32) {
    float a[4];
    dot4(rw, kv + j * ldh, hd, a);
    float4 s;
#pragma unroll
    for (int i = 0; i < kRows4; ++i) {
      float ds = 0.f;
      if (live[i]) {
        const size_t e = row[i] * M + j;
        const float p = P[e];
        float dp = a[i];
        if (ka.on()) {
          const float kk = ka.at(e);
          dp *= kk;
          P[e] = p * kk;
        }
        ds = p * (dp - D[i]) * scale;
        dS[e] = ds;
      }
      set4(s, i, ds);
    }
    pw[j] = s;
  }
  __syncthreads();  // every warp is done with v: k takes its place
  stage_head_async(kv, k + vb, E, 0, M, M, h, hd);
  fk::cp_async_wait_all();
  __syncthreads();
  for (int d = tx; d < hd; d += 32) {
    float o[4];
    attend4(pw, kv, ldh, d, M, o);
#pragma unroll
    for (int i = 0; i < kRows4; ++i)
      if (live[i]) dq[((size_t)b * M + m0 + ty + fk::kWarps * i) * ldg + h * hd + d] = o[i];
  }
}

// 6. per (key tile, head, video): dk_h[j] = sum_i dS_ij q_h[i] and dv_h[j] =
//    sum_i (P keep)_ij dc_h[i] in row order, over chunks of QC query rows
//    staged in shared memory at once (their q and dc rows, the tile's columns
//    of dS and P * keep; QC = sa_dkv_rows: every row of the zoo's M in one
//    chunk, its loads issued in batches, so that the block waits on them a
//    few times: 32-row chunks, a wait each, took 0.043 ms at epic's B=1,
//    M=300, this 0.030, on an H100 80GB HBM3 at 700 W); thread (j, u) holds
//    key j's dimensions 4u .. 4u + 3 and 32 + 4u .. 32 + 4u + 3 (hd <= 64,
//    hd % 4 == 0), of both sums.  q: an (R, E) panel; dc: one of `slices` K
//    slices sstride apart.  dk into dk, dv into dk + E (row stride ldg)
constexpr int kDkvBudget = 200 * 1024;  // bytes of a dkv block's staged rows

__host__ __device__ inline int sa_dkv_rows(int M, int hd) {
  const int fit = kDkvBudget / (4 * (2 * hd + 2 * (QT + 1)));
  return M < fit ? M : fit;
}

__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_dkv_kernel(const float* __restrict__ qp, const float* __restrict__ dc, int slices,
                  long long sstride, const float* __restrict__ Pd, const float* __restrict__ dS,
                  float* __restrict__ dk, int ldg, int M, int E, int H, int QC) {
  extern __shared__ float4 smem_raw[];
  const int hd = E / H;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [QC][hd]
  float* gs = qs + (size_t)QC * hd;                 // [QC][hd]: dc
  float* ss = gs + (size_t)QC * hd;                 // [QC][QT + 1]: dS
  float* ps = ss + (size_t)QC * (QT + 1);           // [QC][QT + 1]: P * keep
  const int j0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int jj = tid >> 3, u = tid & 7;
  const size_t row0 = ((size_t)b * H + h) * M;
  const float* qb = qp + (size_t)b * M * E + h * hd;
  const float* db = dc + (size_t)b * M * E + h * hd;
  const int h4 = hd / 4;
  float4 ak[2], av[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) ak[t] = av[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < M; i0 += QC) {
    const int n = min(QC, M - i0);
    for (int e = tid; e < n * h4; e += fk::kThreads) {
      const int i = e / h4, d = (e - i * h4) * 4;
      const float* p = db + (size_t)(i0 + i) * E + d;
      float4 t[4];  // dc's K slices (at most 4), loaded together, added in order
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < slices) t[k] = *reinterpret_cast<const float4*>(p + k * sstride);
      float4 g = t[0];
#pragma unroll
      for (int k = 1; k < 4; ++k)
        if (k < slices) g = make_float4(g.x + t[k].x, g.y + t[k].y, g.z + t[k].z, g.w + t[k].w);
      *reinterpret_cast<float4*>(qs + i * hd + d) =
          *reinterpret_cast<const float4*>(qb + (size_t)(i0 + i) * E + d);
      *reinterpret_cast<float4*>(gs + i * hd + d) = g;
    }
    // dS and P * keep, kBatch rows' loads a thread issued before any store:
    // one row after another, each load waited for, took most of the time
    constexpr int kBatch = 8;
    const int j = tid & 31;
    const bool jok = j0 + j < M;
    for (int i = tid >> 5; i < n; i += kBatch * fk::kWarps) {
      float sv[kBatch], pv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int ii = i + u * fk::kWarps;
        const size_t at = (row0 + i0 + ii) * M + j0 + j;
        const bool ok = jok && ii < n;
        sv[u] = ok ? dS[at] : 0.f;
        pv[u] = ok ? Pd[at] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int ii = i + u * fk::kWarps;
        if (ii < n) {
          ss[ii * (QT + 1) + j] = sv[u];
          ps[ii * (QT + 1) + j] = pv[u];
        }
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float s = ss[i * (QT + 1) + jj], p = ps[i * (QT + 1) + jj];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = 4 * u + 32 * t;
        if (d >= hd) continue;
        const float4 q = *reinterpret_cast<const float4*>(qs + i * hd + d);
        const float4 g = *reinterpret_cast<const float4*>(gs + i * hd + d);
        ak[t] = make_float4(fmaf(s, q.x, ak[t].x), fmaf(s, q.y, ak[t].y), fmaf(s, q.z, ak[t].z),
                            fmaf(s, q.w, ak[t].w));
        av[t] = make_float4(fmaf(p, g.x, av[t].x), fmaf(p, g.y, av[t].y), fmaf(p, g.z, av[t].z),
                            fmaf(p, g.w, av[t].w));
      }
    }
    __syncthreads();
  }
  const int j = j0 + jj;
  if (j >= M) return;
  float* out = dk + ((size_t)b * M + j) * ldg + h * hd;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int d = 4 * u + 32 * t;
    if (d >= hd) continue;
    *reinterpret_cast<float4*>(out + d) = ak[t];
    *reinterpret_cast<float4*>(out + E + d) = av[t];
  }
}

// sum of n partials at p, p + stride, ... in two fixed-order stages: each
// run of G in order, then the runs in order
template <int G>
__device__ __forceinline__ float sum2(const float* __restrict__ p, size_t stride, int n) {
  float s = 0.f;
  for (int r = 0; r < n; r += G) {
    float v[G];  // the run's loads issued together
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = r + k < n ? __ldg(p + (size_t)(r + k) * stride) : 0.f;
    float t = v[0];
#pragma unroll
    for (int k = 1; k < G; ++k)
      if (r + k < n) t += v[k];
    s = r == 0 ? t : s + t;
  }
  return s;
}

// 9. the results, a thread an element: the weight products' chunks summed
//    (into dw's order: [dWq | dWk]'s rows split into dWq and dWk), the
//    LayerNorm tiles' sums (dgamma | dbeta, after dw), dx = dres + (dq Wq^T +
//    dk Wk^T) + dv Wv^T and d(pos) = the batch sum of dxa = dq Wq^T + dk Wk^T
//    on its Pp leading channels
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_finish_kernel(const float* __restrict__ wpart, int chunks, long long Sw,
                     const float* __restrict__ part, int tiles, const float* __restrict__ dres,
                     const float* __restrict__ dxo, int S, float* __restrict__ dw,
                     float* __restrict__ dx, float* __restrict__ dpos, int B, int M, int E,
                     int Pp) {
  const long long R = (long long)B * M;
  const long long RE = R * E;
  const long long n_dw = Sw, n_gb = 2 * E, n_dx = RE, n_pos = (long long)M * Pp;
  // dxo's part p (0: dq Wq^T, 1: dk Wk^T, 2: dv Wv^T) at flat (R, E) index e,
  // its S K slices added in order
  const auto part_of = [&](int p, long long e) {  // S <= 4: the loads issued together
    const float* o = dxo + (long long)p * S * RE + e;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = k < S ? __ldg(o + k * RE) : 0.f;
    float v = t[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (k < S) v += t[k];
    return v;
  };
  const long long n = (long long)gridDim.x * fk::kThreads;
  for (long long i = (long long)blockIdx.x * fk::kThreads + threadIdx.x;
       i < n_dw + n_gb + n_dx + n_pos; i += n) {
    long long k = i;
    if (k < n_dw) {
      long long to = k;  // [dWq | dWk] row m, column n -> dWq or dWk, row m
      if (k < 2LL * E * E) {
        const long long m = k / (2 * E), n2 = k - m * 2 * E;
        to = n2 < E ? m * E + n2 : (long long)E * E + m * E + n2 - E;
      }
      dw[to] = sum2<4>(wpart + k, (size_t)Sw, chunks);
      continue;
    }
    k -= n_dw;
    if (k < n_gb) {
      dw[n_dw + k] = sum2<8>(part + k, 2 * (size_t)E, tiles);
      continue;
    }
    k -= n_gb;
    if (k < n_dx) {
      dx[k] = __ldg(dres + k) + (part_of(0, k) + part_of(1, k)) + part_of(2, k);
      continue;
    }
    k -= n_dx;
    const int m = (int)(k / Pp), cc = (int)(k - (long long)m * Pp);
    float s = 0.f;
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const long long e = ((long long)b * M + m) * E + cc;
      const float a = part_of(0, e) + part_of(1, e);
      s = b == 0 ? a : s + a;
    }
    dpos[k] = s;
  }
}

}  // namespace

namespace fk {
// mstcn2.cu: the 3xTF32 GEMM and weight products over one row space
int tc_rows_gemm(const float* a, int a_ch, int nprob, const int* c0, int K, const float* wpack,
                 int N, int R, const int* lens, float* out, int ldo, int col_step,
                 const float* const* bias, cudaStream_t stream);
int tc_wgrad_pairs(const float* A, int a_ch, const float* Bm, int b_ch, int npair,
                   const int* pairs, const int* lens, int R, int Kc, float* part,
                   cudaStream_t stream);
}  // namespace fk

// The SA forward's projections: q, k, v into qkv (B, 3, M, E), one block
// per (kFwdRows-row tile, video, projection).
extern "C" int fk_sa_qkv(const float* x, const float* pos, int Pp, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, float* qkv, int B, int M, int E, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<kFwdRows>);
  cudaError_t err = fk::set_smem((const void*)sa_qkv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sa_qkv_kernel<<<dim3((M + kFwdRows - 1) / kFwdRows, B, 3), fk::kThreads, smem,
                  (cudaStream_t)stream>>>(x, pos, Pp, wq, bq, wk, bk, wv, bv, qkv, M, E);
  return (int)cudaGetLastError();
}

// The SA forward's attention and out projection from q, k, v (video b, token
// m at qkv + b * bstride + m * ld; k at + koff, v at + voff): the context c
// (B, M, E) per (32-query tile, head, video), then y = LN(x + drop_o(c Wo +
// bo)) per (kFwdRows-row tile, video).
extern "C" int fk_sa_attn_out(const float* qkv, long long bstride, int ld, int koff, int voff,
                              const float* x, const float* wo, const float* bo,
                              const float* gamma, const float* beta, float* c, float* y, int B,
                              int M, int E, int H, float eps, const int* seed_a, int stream_a,
                              unsigned thresh_a, float scale_a, const int* seed_o, int stream_o,
                              unsigned thresh_o, float scale_o, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t rsm = sa_rows_smem_floats(M, E / H) * sizeof(float);
  const size_t osm = sizeof(fk::GemmSmem<kFwdRows>);
  cudaError_t err;
  if ((err = fk::set_smem((const void*)sa_context_kernel<float>, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_out_ln_kernel<kFwdRows>, osm)) != cudaSuccess)
    return (int)err;
  sa_context_kernel<float><<<dim3((M + QT - 1) / QT, H, B), fk::kThreads, rsm, st>>>(
      qkv, bstride, ld, koff, voff, fk::Dropout{seed_a, stream_a, thresh_a, scale_a}, c, M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_out_ln_kernel<kFwdRows><<<dim3((M + kFwdRows - 1) / kFwdRows, B), fk::kThreads, osm, st>>>(
      x, c, wo, bo, gamma, beta, y, M, E, eps, fk::Dropout{seed_o, stream_o, thresh_o, scale_o});
  return (int)cudaGetLastError();
}

// The buffers fk_sa_bwd needs at (B, M, E, H, Pp), for its callers: out[0]
// the workspace's floats, out[1] the results', then the offsets in the latter
// of dx (B, M, E), d(pos) (M, Pp) and dw (dWq, dWk, dWv, dWo (E, E) each,
// then dbq, dbk, dbv, dbo, dgamma, dbeta (E) each).
extern "C" int fk_sa_bwd_workspace(int B, int M, int E, int H, int Pp, long long* out) {
  const SaWorkspace w = sa_workspace(B, M, E, H, Pp);
  const long long v[5] = {(long long)w.total, (long long)w.out_floats, (long long)w.dx,
                          (long long)w.dpos, (long long)w.dw};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// The SA backward in one call over the B * M token rows, through ws into out
// (fk_sa_bwd_workspace's floats of each): the steps at the top of this file,
// eleven launches.  The keep values come from keep_a / keep_o where given,
// else are hashed from the seeds (a null seed: no dropout).
extern "C" int fk_sa_bwd(const float* x, const float* pos, int Pp, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, const float* wo, const float* bo, const float* gamma,
                         const float* keep_a, const float* keep_o, const float* g, float* ws,
                         float* out, int B, int M, int E, int H, float eps, const int* seed_a,
                         int stream_a,
                         unsigned thresh_a, float scale_a, const int* seed_o, int stream_o,
                         unsigned thresh_o, float scale_o, void* stream) {
  const int hd = E / H;
  if (E % H || hd > 64 || hd % 4 || E % 4 || Pp > E) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const SaWorkspace w = sa_workspace(B, M, E, H, Pp);
  const int R = B * M, Kp = w.Kp, lda = 3 * E + 4, ldg = 4 * E;
  float *pack = ws + w.pack, *rows = ws + w.rows, *qkv = ws + w.qkv, *o = ws + w.o,
        *dres = ws + w.dres, *dc = ws + w.dc, *grads = ws + w.grads, *dxo = ws + w.dxo,
        *P = ws + w.P, *dS = ws + w.dS, *part = ws + w.part, *wpart = ws + w.wpart;
  const int* lens = reinterpret_cast<const int*>(ws + w.lens);
  const size_t plane = (size_t)2 * E * Kp;  // one packed weight
  const fk::Dropout drop_a{seed_a, stream_a, thresh_a, scale_a};
  const fk::Dropout drop_o{seed_o, stream_o, thresh_o, scale_o};
  const size_t rsm = sa_bwd_rows_smem_floats(M, hd) * sizeof(float);
  const size_t lsm = (size_t)2 * kLnRows * E * sizeof(float);  // the LN tile's res and g
  const int qc = sa_dkv_rows(M, hd);
  const size_t ksm = (size_t)qc * (2 * hd + 2 * (QT + 1)) * sizeof(float);
  const dim3 attn((M + QT - 1) / QT, H, B);
  cudaError_t err;
  if ((err = fk::set_smem((const void*)sa_bwd_probs_kernel, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_bwd_dq_kernel, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_bwd_dkv_kernel, ksm)) != cudaSuccess ||
      (lsm > 48 * 1024 &&
       (err = fk::set_smem((const void*)ffn_bwd_ln_kernel, lsm)) != cudaSuccess))
    return (int)err;
  const int tiles = kSaPacks * ((E + 31) / 32) * (Kp / 32);
  const long long n4 = (long long)R * lda / 4;
  const int rblocks = (int)((n4 + fk::kThreads - 1) / fk::kThreads < 1056
                                ? (n4 + fk::kThreads - 1) / fk::kThreads : 1056);
  sa_bwd_prep_kernel<<<tiles + rblocks, fk::kThreads, 0, st>>>(
      x, pos, Pp, wq, wk, wv, wo, pack, rows, reinterpret_cast<int*>(ws + w.lens), R, M, E, Kp,
      w.S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // a product of parts p < np (A columns at cp[p], weight pack wp + p * plane)
  // in `sl` K slices of Kp / sl: problem p * sl + s, its output plane at
  // out + (p * sl + s) R E; the bias (if any) on slice 0
  const long long RE = (long long)R * E;
  const auto product = [&](const float* a, int a_ch, int np, const int* cp, const float* wp,
                           int sl, const float* const* bias, float* out) {
    int c0[12];
    const float* bz[12];
    for (int p = 0; p < np; ++p)
      for (int k = 0; k < sl; ++k) {
        c0[p * sl + k] = cp[p] + k * (Kp / sl);
        bz[p * sl + k] = bias != nullptr && k == 0 ? bias[p] : nullptr;
      }
    return fk::tc_rows_gemm(a, a_ch, np * sl, c0, Kp / sl, wp, E, R, lens, out, E, (int)RE, bz,
                            st);
  };
  int rc;
  const int c_qkv[3] = {0, 0, E}, c_o[1] = {2 * E}, c_dc[1] = {3 * E}, c_dx[3] = {0, E, 2 * E};
  const float* b_qkv[3] = {bq, bk, bv};
  // q | k | v, then the attention's P and c (into rows), then o = c Wo
  if ((rc = product(rows, lda, 3, c_qkv, pack, 1, b_qkv, qkv))) return rc;
  sa_bwd_probs_kernel<<<attn, fk::kThreads, rsm, st>>>(qkv, RE, keep_a, drop_a, rows + 2 * E, lda,
                                                       P, M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((rc = product(rows, lda, 1, c_o, pack + 3 * plane, w.S, nullptr, o))) return rc;
  // res = x + drop_o(o + bo) (o's slices added in order), its LayerNorm
  // backward (dres, the tiles' sums) and dout = dres * keep_o into grads'
  // last E columns; dc = dout Wo^T
  ffn_bwd_ln_kernel<<<w.ln_tiles, fk::kThreads, lsm, st>>>(x, o, bo, gamma, keep_o, drop_o, g,
                                                          dres, grads + 3 * E, ldg, part, R, E,
                                                          w.S, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((rc = product(grads, ldg, 1, c_dc, pack + 4 * plane, w.S, nullptr, dc))) return rc;
  // dS, P * keep and dq; dk and dv
  sa_bwd_dq_kernel<<<attn, fk::kThreads, rsm, st>>>(qkv + RE, qkv + 2 * RE, dc, w.S, RE,
                                                    rows + 2 * E, lda, keep_a, drop_a, P, dS,
                                                    grads, ldg, M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_bwd_dkv_kernel<<<attn, fk::kThreads, ksm, st>>>(qkv, dc, w.S, RE, P, dS, grads + E, ldg, M,
                                                     E, H, qc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dq Wq^T, dk Wk^T, dv Wv^T, and the weight products with the bias sums
  int pairs[4 * kSaPairs];
  sa_pairs(E, pairs);
  if ((rc = product(grads, ldg, 3, c_dx, pack + 5 * plane, w.S, nullptr, dxo)) ||
      (rc = fk::tc_wgrad_pairs(rows, lda, grads, ldg, kSaPairs, pairs, lens, R, w.Kc, wpart, st)))
    return rc;
  const long long n = w.Sw + 2 * E + RE + (long long)M * Pp;
  const int fblocks = (int)((n + fk::kThreads - 1) / fk::kThreads < 2112
                                ? (n + fk::kThreads - 1) / fk::kThreads : 2112);
  sa_bwd_finish_kernel<<<fblocks, fk::kThreads, 0, st>>>(
      wpart, w.chunks, w.Sw, part, w.ln_tiles, dres, dxo, w.S, out + w.dw, out + w.dx,
      out + w.dpos, B, M, E, Pp);
  return (int)cudaGetLastError();
}

namespace {

// The FFN's workspaces (floats; each region starts on 64 floats).  The
// backward's: W1^T | W2^T (2 E F); dres, dx (R x E); z1 (R x F); the weight
// products' operands, the batch's two products in one: lhs (2, R, ldl) =
// [dz1 | 1] then [hk | 1], rhs (2, R, ldr) = [x | 1] then [dt2 | 1] (ldl =
// F + 4, ldr = E + 4), so that lhs^T rhs = [[dW1^T, db1], .] and [[dW2, .],
// [db2, .]]; the LayerNorm tiles' sums (ceil(R / 16), 2, E); dgamma | dbeta
// (2, E).  Both directions': the products' K slices sa (ceil(E / 128), R,
// F) and sb (ceil(F / 128), R, E), the forward's only regions.
struct FfnWorkspace {
  size_t wt, res, dx, z1, lhs, rhs, part, dgb, sa, sb, total;
  int ldl, ldr;
};

FfnWorkspace ffn_workspace(int B, int M, int E, int F, bool backward) {
  const size_t R = (size_t)B * M;
  FfnWorkspace w{};
  w.ldl = F + 4;
  w.ldr = E + 4;
  size_t at = 0;
  const auto take = [&](size_t n) {
    const size_t o = at;
    at += (n + 63) / 64 * 64;
    return o;
  };
  if (backward) {
    w.wt = take(2 * (size_t)E * F);
    w.res = take(R * E);
    w.dx = take(R * E);
    w.z1 = take(R * F);
    w.lhs = take(2 * R * w.ldl);
    w.rhs = take(2 * R * w.ldr);
    w.part = take((R + kLnRows - 1) / kLnRows * 2 * E);
    w.dgb = take(2 * (size_t)E);
  }
  w.sa = take((size_t)(E + kFfnSlice - 1) / kFfnSlice * R * F);
  w.sb = take((size_t)(F + kFfnSlice - 1) / kFfnSlice * R * E);
  w.total = at;
  return w;
}

// The grids of both directions over the R = B * M token rows: the
// products over (32-row tile, K slice, 256-column chunk), x W1 and dt2 W2^T
// over E's slices and F's chunks, hk W2 and dz1 W1^T over F's slices and
// E's chunks; the LayerNorm over 16-row tiles.
struct FfnGrid {
  int R, es, fs, ln_tiles;
  dim3 ef, fe;
  FfnGrid(int B, int M, int E, int F) : R(B * M) {
    const int tiles = (R + kFfnRows - 1) / kFfnRows;
    es = (E + kFfnSlice - 1) / kFfnSlice;
    fs = (F + kFfnSlice - 1) / kFfnSlice;
    ln_tiles = (R + kLnRows - 1) / kLnRows;
    ef = dim3(tiles, es, (F + fk::kBN - 1) / fk::kBN);
    fe = dim3(tiles, fs, (E + fk::kBN - 1) / fk::kBN);
  }
};

}  // namespace

// The workspace fk_ffn_fwd needs at (B, M, E, F), for its callers: out[0]
// its floats.
extern "C" int fk_ffn_fwd_workspace(int B, int M, int E, int F, long long* out) {
  out[0] = (long long)ffn_workspace(B, M, E, F, false).total;
  return 0;
}

// The FFN forward in one call over the B * M token rows into ws
// (fk_ffn_fwd_workspace's floats) and y: x W1 into sa's K slices; hk W2
// into sb's, hk = relu(z1) * keep_1 staged from sa's slices + b1 (keep_1
// hashed: FFN stream 0 over (B, M, F)); y = LN(x + drop_2(hk W2 + b2)) per
// 16-row tile (stream 1 over (B, M, E)).  Three launches.
extern "C" int fk_ffn_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* gamma, const float* beta, float* ws,
                          float* y, int B, int M, int E, int F, float eps, const int* seed_1,
                          int stream_1, unsigned thresh_1, float scale_1, const int* seed_2,
                          int stream_2, unsigned thresh_2, float scale_2, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const FfnWorkspace w = ffn_workspace(B, M, E, F, false);
  const FfnGrid gr(B, M, E, F);
  float *sa = ws + w.sa, *sb = ws + w.sb;
  const size_t gsm = sizeof(fk::GemmSmem<kFfnRows>);
  const size_t lsm = (size_t)kLnRows * E * sizeof(float);  // the LN tile's res
  // the slice kernel's 37 KB need no attribute; the LayerNorm's past E = 768 do
  if (lsm > 48 * 1024) {
    const cudaError_t err = fk::set_smem((const void*)ffn_fwd_ln_kernel, lsm);
    if (err != cudaSuccess) return (int)err;
  }
  const fk::Dropout none{nullptr, 0, 0u, 1.f};
  ffn_slice_kernel<kPanel><<<gr.ef, fk::kThreads, gsm, st>>>(
      FfnSlice{x, nullptr, 0, nullptr, nullptr, nullptr, nullptr, E, none}, w1, sa, gr.R, E, F);
  ffn_slice_kernel<kHidden><<<gr.fe, fk::kThreads, gsm, st>>>(
      FfnSlice{nullptr, sa, gr.es, b1, nullptr, nullptr, nullptr, F,
               fk::Dropout{seed_1, stream_1, thresh_1, scale_1}},
      w2, sb, gr.R, F, E);
  ffn_fwd_ln_kernel<<<gr.ln_tiles, fk::kThreads, lsm, st>>>(
      x, sb, b2, gamma, beta, fk::Dropout{seed_2, stream_2, thresh_2, scale_2}, y, gr.R, E, gr.fs,
      eps);
  return (int)cudaGetLastError();  // the first failed launch's error, if any
}

// The workspace fk_ffn_bwd needs at (B, M, E, F), for its callers: out[0]
// its floats, then the offsets of dx, lhs and rhs with their row strides
// ldl and ldr, and dgamma | dbeta.
extern "C" int fk_ffn_bwd_workspace(int B, int M, int E, int F, long long* out) {
  const FfnWorkspace w = ffn_workspace(B, M, E, F, true);
  const long long v[7] = {(long long)w.total, (long long)w.dx, (long long)w.lhs, w.ldl,
                          (long long)w.rhs, w.ldr, (long long)w.dgb};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

namespace {

// fk_ffn_bwd's launches (and fk_ffn_bwd16's, B16: x W1 on a bf16 W1 (w1) with
// x rounded as it is staged, z1 rounded as JAX's bf16 forward rounds it,
// bf16(dz1) multiplied by W1^T, which w1t_src (W1 rounded to bf16, in f32)
// gives the transpose; no dropout there)
template <bool B16>
int ffn_bwd_launches(const float* x, const void* w1, const float* w1t_src, const float* b1,
                     const float* w2, const float* b2, const float* gamma, const float* keep_1,
                     const float* keep_2, const float* g, float* ws, int B, int M, int E, int F,
                     float eps, fk::Dropout drop_1, fk::Dropout drop_2, cudaStream_t st) {
  const FfnWorkspace w = ffn_workspace(B, M, E, F, true);
  const FfnGrid gr(B, M, E, F);
  float *wt = ws + w.wt, *res = ws + w.res, *dx = ws + w.dx, *z1 = ws + w.z1;
  float *lhs = ws + w.lhs, *rhs = ws + w.rhs, *part = ws + w.part, *sa = ws + w.sa,
        *sb = ws + w.sb;
  const int R = gr.R;
  float *dz1 = lhs, *hk = lhs + (size_t)R * w.ldl, *dt2 = rhs + (size_t)R * w.ldr;
  const size_t gsm = sizeof(fk::GemmSmem<kFfnRows>);
  const size_t lsm = (size_t)2 * kLnRows * E * sizeof(float);  // the LN tile's res and g
  const int big = E > F ? E : F;
  const int re = (int)(((size_t)R * E + fk::kThreads - 1) / fk::kThreads);
  // the slice kernel's 37 KB need no attribute; the LayerNorm's past E = 384 do
  if (lsm > 48 * 1024) {
    const cudaError_t err = fk::set_smem((const void*)ffn_bwd_ln_kernel, lsm);
    if (err != cudaSuccess) return (int)err;
  }
  const fk::Dropout none{nullptr, 0, 0u, 1.f};
  ffn_transpose_kernel<<<dim3((big + 31) / 32, (big + 31) / 32, 3), fk::kThreads, 0, st>>>(
      w1t_src, w2, wt, x, lhs, w.ldl, rhs, w.ldr, R, E, F);
  // x W1 -> sa; hk W2 -> sb (z1 and hk from sa as they are staged); the
  // LayerNorm step; dt2 W2^T -> sa; dz1 W1^T -> sb (dz1 from sa); dx and the
  // LN sums
  const FfnSlice panel{x, nullptr, 0, nullptr, nullptr, nullptr, nullptr, E, none};
  if constexpr (B16)
    ffn_slice_kernel<kPanel, fk::bf16, true><<<gr.ef, fk::kThreads, gsm, st>>>(
        panel, static_cast<const fk::bf16*>(w1), sa, R, E, F);
  else
    ffn_slice_kernel<kPanel><<<gr.ef, fk::kThreads, gsm, st>>>(
        panel, static_cast<const float*>(w1), sa, R, E, F);
  ffn_slice_kernel<kHidden, float, B16><<<gr.fe, fk::kThreads, gsm, st>>>(
      FfnSlice{nullptr, sa, gr.es, b1, keep_1, z1, hk, w.ldl, drop_1}, w2, sb, R, F, E);
  ffn_bwd_ln_kernel<<<gr.ln_tiles, fk::kThreads, lsm, st>>>(
      x, sb, b2, gamma, keep_2, drop_2, g, res, dt2, w.ldr, part, R, E, gr.fs, eps);
  ffn_slice_kernel<kPanel><<<gr.ef, fk::kThreads, gsm, st>>>(
      FfnSlice{dt2, nullptr, 0, nullptr, nullptr, nullptr, nullptr, w.ldr, none},
      wt + (size_t)E * F, sa, R, E, F);
  ffn_slice_kernel<kDz1, float, B16><<<gr.fe, fk::kThreads, gsm, st>>>(
      FfnSlice{nullptr, sa, gr.es, nullptr, keep_1, z1, dz1, w.ldl, drop_1}, wt, sb, R, F, E);
  ffn_finish_kernel<<<re + (2 * E + fk::kThreads - 1) / fk::kThreads, fk::kThreads, 0, st>>>(
      sb, res, dx, part, ws + w.dgb, R, E, gr.fs, gr.ln_tiles);
  return (int)cudaGetLastError();  // the first failed launch's error, if any
}

}  // namespace

// The FFN backward in one call over the B * M token rows into ws
// (fk_ffn_bwd_workspace's floats): W1^T and W2^T, x and the ones columns
// into the weight products' operands, then the steps above.  The keep
// values come from keep_1 / keep_2 where given, else are hashed from the
// forward's seeds as fk_ffn_fwd draws them (a null seed: no dropout), so
// that the training path makes no mask.
extern "C" int fk_ffn_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* gamma, const float* keep_1,
                          const float* keep_2, const float* g, float* ws, int B, int M, int E,
                          int F, float eps, const int* seed_1, int stream_1, unsigned thresh_1,
                          float scale_1, const int* seed_2, int stream_2, unsigned thresh_2,
                          float scale_2, void* stream) {
  return ffn_bwd_launches<false>(x, w1, w1, b1, w2, b2, gamma, keep_1, keep_2, g, ws, B, M, E, F,
                                 eps, fk::Dropout{seed_1, stream_1, thresh_1, scale_1},
                                 fk::Dropout{seed_2, stream_2, thresh_2, scale_2},
                                 (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The mixed-precision forms of both forwards (ops/sa_layer.py::
// sa_sublayer16_fwd / ffn_sublayer16_fwd; JAX's sa_sublayer / ffn_sublayer
// with bf16=True, fact_clip_tpu/ops/pallas/sa_layer.py:59-73, :241-244): the
// f32 forms' kernels with bf16 operands where JAX casts, products of bf16
// values in f32 FMAs (exact) and rounding to bf16 where JAX rounds.  Serving
// only (no dropout).  Their bound is the f32 forms': launch latency.

namespace {

// 1 (forward, bf16). q, k = bf16(bf16(bf16(x + pos) W) + bf16(b)) and v =
//    bf16(bf16(bf16(x) Wv) + bf16(bv)) into qkv (B, 3, M, E) bf16, W (E, E)
//    bf16: one block per (kFwdRows-row tile, video, projection)
__global__ void __launch_bounds__(fk::kThreads)
sa_qkv16_kernel(const float* __restrict__ x, const float* __restrict__ pos, int Pp,
                const fk::bf16* __restrict__ wq, const float* __restrict__ bq,
                const fk::bf16* __restrict__ wk, const float* __restrict__ bk,
                const fk::bf16* __restrict__ wv, const float* __restrict__ bv,
                fk::bf16* __restrict__ qkv, int M, int E) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<kFwdRows>& s = *reinterpret_cast<fk::GemmSmem<kFwdRows>*>(smem_raw);
  const int r0 = blockIdx.x * kFwdRows;
  const int b = blockIdx.y;
  const int which = blockIdx.z;
  const size_t ME = (size_t)M * E;
  const fk::bf16* W = which == 0 ? wq : which == 1 ? wk : wv;
  const float* bias = which == 0 ? bq : which == 1 ? bk : bv;
  fk::bf16* out = qkv + ((size_t)b * 3 + which) * ME;
  const Rows rows{x + b * ME, which < 2 ? pos : nullptr, Pp, r0, M, E};
  rows_gemm<kFwdRows>(
      [&](int r, int k) { return fk::bf16_round(rows(r, k)); }, W, E, E, r0, M,
      [&](int r, int c, float v) {
        out[(size_t)r * E + c] =
            __float2bfloat16_rn(fk::bf16_round(v) + fk::bf16_round(__ldg(bias + c)));
      },
      s);
}

}  // namespace

// The SA forward's bf16 projections: q, k, v into qkv (B, 3, M, E) bf16 from
// x and pos (f32) and Wq, Wk, Wv (E, E) bf16, one block per (kFwdRows-row
// tile, video, projection).
extern "C" int fk_sa_qkv16(const float* x, const float* pos, int Pp, const void* wq,
                           const float* bq, const void* wk, const float* bk, const void* wv,
                           const float* bv, void* qkv, int B, int M, int E, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<kFwdRows>);
  cudaError_t err = fk::set_smem((const void*)sa_qkv16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sa_qkv16_kernel<<<dim3((M + kFwdRows - 1) / kFwdRows, B, 3), fk::kThreads, smem,
                    (cudaStream_t)stream>>>(
      x, pos, Pp, (const fk::bf16*)wq, bq, (const fk::bf16*)wk, bk, (const fk::bf16*)wv, bv,
      (fk::bf16*)qkv, M, E);
  return (int)cudaGetLastError();
}

// The SA forward's bf16 attention and out projection from bf16 q, k, v (video
// b, token m at qkv + b * bstride + m * ld; k at + koff, v at + voff): the
// context c (B, M, E) f32 over the bf16-rounded probabilities, then y =
// LN(x + c Wo + bo) in f32 (Wo f32, as JAX leaves it).
extern "C" int fk_sa_attn_out16(const void* qkv, long long bstride, int ld, int koff, int voff,
                                const float* x, const float* wo, const float* bo,
                                const float* gamma, const float* beta, float* c, float* y, int B,
                                int M, int E, int H, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t rsm = sa_rows_smem_floats(M, E / H) * sizeof(float);
  const size_t osm = sizeof(fk::GemmSmem<kFwdRows>);
  const fk::Dropout none{nullptr, 0, 0u, 1.f};
  cudaError_t err;
  if ((err = fk::set_smem((const void*)sa_context_kernel<fk::bf16>, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_out_ln_kernel<kFwdRows>, osm)) != cudaSuccess)
    return (int)err;
  sa_context_kernel<fk::bf16><<<dim3((M + QT - 1) / QT, H, B), fk::kThreads, rsm, st>>>(
      (const fk::bf16*)qkv, bstride, ld, koff, voff, none, c, M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_out_ln_kernel<kFwdRows><<<dim3((M + kFwdRows - 1) / kFwdRows, B), fk::kThreads, osm, st>>>(
      x, c, wo, bo, gamma, beta, y, M, E, eps, none);
  return (int)cudaGetLastError();
}

// The FFN forward's bf16 form in one call, fk_ffn_fwd's three launches and
// workspace (fk_ffn_fwd_workspace): x rounded to bf16 as it is staged against
// W1 (E, F) bf16 into sa's K slices; hk = relu(bf16(bf16(x W1) + bf16(b1)))
// staged from them against W2 (f32) into sb's; y = LN(x + hk W2 + b2).
extern "C" int fk_ffn_fwd16(const float* x, const void* w1, const float* b1, const float* w2,
                            const float* b2, const float* gamma, const float* beta, float* ws,
                            float* y, int B, int M, int E, int F, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const FfnWorkspace w = ffn_workspace(B, M, E, F, false);
  const FfnGrid gr(B, M, E, F);
  float *sa = ws + w.sa, *sb = ws + w.sb;
  const size_t gsm = sizeof(fk::GemmSmem<kFfnRows>);
  const size_t lsm = (size_t)kLnRows * E * sizeof(float);
  if (lsm > 48 * 1024) {
    const cudaError_t err = fk::set_smem((const void*)ffn_fwd_ln_kernel, lsm);
    if (err != cudaSuccess) return (int)err;
  }
  const fk::Dropout none{nullptr, 0, 0u, 1.f};
  ffn_slice_kernel<kPanel, fk::bf16, true><<<gr.ef, fk::kThreads, gsm, st>>>(
      FfnSlice{x, nullptr, 0, nullptr, nullptr, nullptr, nullptr, E, none},
      (const fk::bf16*)w1, sa, gr.R, E, F);
  ffn_slice_kernel<kHidden, float, true><<<gr.fe, fk::kThreads, gsm, st>>>(
      FfnSlice{nullptr, sa, gr.es, b1, nullptr, nullptr, nullptr, F, none}, w2, sb, gr.R, F, E);
  ffn_fwd_ln_kernel<<<gr.ln_tiles, fk::kThreads, lsm, st>>>(x, sb, b2, gamma, beta, none, y,
                                                           gr.R, E, gr.fs, eps);
  return (int)cudaGetLastError();
}

// The FFN backward's bf16 form in one call (ops/sa_layer.py::
// ffn_sublayer16_bwd; JAX's _ffn_bwd_kernel with bf16=True,
// fact_clip_tpu/ops/pallas/sa_layer.py:254-299): fk_ffn_bwd's six launches
// and workspace (fk_ffn_bwd_workspace) without dropout, x rounded to bf16 as
// it is staged against W1 (E, F) bf16 and z1 = bf16(bf16(x W1) + bf16(b1)),
// as the bf16 forward forms them; dz1 rounded to bf16 for its product with
// W1^T, which w1r (W1 rounded to bf16, held in f32) gives the transpose; the
// rest f32.  dz1 itself (for db1) and the panels land where fk_ffn_bwd puts
// them.
extern "C" int fk_ffn_bwd16(const float* x, const void* w1, const float* w1r, const float* b1,
                            const float* w2, const float* b2, const float* gamma,
                            const float* g, float* ws, int B, int M, int E, int F, float eps,
                            void* stream) {
  const fk::Dropout none{nullptr, 0, 0u, 1.f};
  return ffn_bwd_launches<true>(x, w1, w1r, b1, w2, b2, gamma, nullptr, nullptr, g, ws, B, M, E,
                                F, eps, none, none, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The SA backward's bf16 form (ops/sa_layer.py::sa_sublayer16_bwd; JAX's
// _sa_bwd_kernel with bf16=True, fact_clip_tpu/ops/pallas/sa_layer.py:159-226,
// without dropout), over the batch's R = B * M token rows: q | k | v
// recomputed by the bf16 forward's projection kernel, the context over the
// bf16-rounded probabilities by its attention kernel, t = c Wo (f32), the
// LayerNorm backward (the FFN backward's LN kernel: dres, dgamma | dbeta's
// tile partials), dO = dres Wo^T (f32), then per (head, video) the
// attention's cotangents with JAX's roundings: P recomputed (the softmax
// f32), dV = bf16(P)^T dO, dP = dO v^T, dS = P (dP - rowsum(P dP)) /
// sqrt(hd) rounded to bf16, dq = dS k, dk = dS^T q; then dxa = bf16([dq |
// dk]) [Wq | Wk]^T, dx = dres + dxa + bf16(dv) Wv^T (bf16 weights), and the
// weight products bf16(x + pos)^T bf16([dq | dk]), bf16(x)^T bf16(dv) and
// c^T dres over the R rows in one fixed order.  Products of bf16 operands are
// f32 FMAs, exact, as in the forward form; the caller adds the bias and
// LayerNorm sums (grad.cu's fixed-order reduce).

namespace {

// out[r * N + n] = add0[r * N + n] + add1[r * N + n] (each where given) +
// sum_k A[r * lda + k] W[k * N + n], A f32 rounded to bf16 as it is staged
// where RA, W (K, N) f32 or bf16; one block per (32-row tile, 256 columns)
template <class TW, bool RA>
__global__ void __launch_bounds__(fk::kThreads)
rows_mm_kernel(const float* __restrict__ a, int lda, const TW* __restrict__ W, int K, int N,
               int R, const float* __restrict__ add0, const float* __restrict__ add1,
               float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<kFwdRows>& s = *reinterpret_cast<fk::GemmSmem<kFwdRows>*>(smem_raw);
  const int r0 = blockIdx.x * kFwdRows, n0 = blockIdx.y * fk::kBN;
  rows_gemm<kFwdRows>(
      [&](int r, int k) {
        const int row = r0 + r;
        if (row >= R) return 0.f;
        const float v = a[(size_t)row * lda + k];
        return RA ? fk::bf16_round(v) : v;
      },
      W, K, N, r0, R,
      [&](int r, int c, float v) {
        const size_t e = (size_t)r * N + c;
        float base = 0.f;
        if (add0 != nullptr) base = add0[e];
        if (add1 != nullptr) base += add1[e];
        out[e] = base + v;
      },
      s, n0, n0 + fk::kBN);
}

// per (head, video): P, dP, dS and the head's dq, dk, dv, into grads (R, 3E)
// = [dq | dk | dv] f32 and grads_r, the same rounded to bf16 (held in f32)
__global__ void __launch_bounds__(fk::kThreads)
sa_attn_bwd16_kernel(const fk::bf16* __restrict__ qkv, const float* __restrict__ dO,
                     float* __restrict__ grads, float* __restrict__ grads_r, int M, int E, int H) {
  extern __shared__ float4 smem_raw[];
  const int hd = E / H, ldh = hd + 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float scale = 1.f / sqrtf((float)hd);
  float* qs = reinterpret_cast<float*>(smem_raw);  // [M][hd + 1] each
  float* ks = qs + (size_t)M * ldh;
  float* vs = ks + (size_t)M * ldh;
  float* os = vs + (size_t)M * ldh;  // dO's head rows
  float* P = os + (size_t)M * ldh;   // [M][M]: P, then bf16(P)
  float* dS = P + (size_t)M * M;     // [M][M]: dP, then bf16(dS)
  const size_t ME = (size_t)M * E;
  const fk::bf16* qb = qkv + (size_t)b * 3 * ME;
  for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
    const int r = i / hd, d = i - r * hd;
    const size_t e = (size_t)r * E + h * hd + d;
    qs[r * ldh + d] = __bfloat162float(qb[e]);
    ks[r * ldh + d] = __bfloat162float(qb[ME + e]);
    vs[r * ldh + d] = __bfloat162float(qb[2 * ME + e]);
    os[r * ldh + d] = __ldg(dO + (size_t)b * ME + e);
  }
  __syncthreads();
  for (int i = ty; i < M; i += fk::kWarps) {  // a warp a query row
    float* pr = P + (size_t)i * M;
    float* dr = dS + (size_t)i * M;
    float mx = -INFINITY;
    for (int j = lane; j < M; j += 32) {
      const float v = dot_h(qs + i * ldh, ks + j * ldh, hd) * scale;
      pr[j] = v;
      dr[j] = dot_h(os + i * ldh, vs + j * ldh, hd);
      mx = fmaxf(mx, v);
    }
    mx = fk::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    sum = fk::warp_sum(sum);
    float rs = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float pv = pr[j] / sum;
      pr[j] = pv;
      rs += pv * dr[j];
    }
    rs = fk::warp_sum(rs);
    for (int j = lane; j < M; j += 32) {
      const float pv = pr[j];
      dr[j] = fk::bf16_round(pv * (dr[j] - rs) * scale);
      pr[j] = fk::bf16_round(pv);
    }
  }
  __syncthreads();
  const size_t E3 = 3 * (size_t)E;
  for (int i = threadIdx.x; i < M * hd; i += fk::kThreads) {
    const int r = i / hd, d = i - r * hd;
    float aq = 0.f, ak = 0.f, av = 0.f;
    for (int j = 0; j < M; ++j) {
      aq = fmaf(dS[(size_t)r * M + j], ks[j * ldh + d], aq);  // dq[r] = sum_j dS[r][j] k[j]
      ak = fmaf(dS[(size_t)j * M + r], qs[j * ldh + d], ak);  // dk[r] = sum_j dS[j][r] q[j]
      av = fmaf(P[(size_t)j * M + r], os[j * ldh + d], av);   // dv[r] = sum_j P[j][r] dO[j]
    }
    const size_t o = ((size_t)b * M + r) * E3 + h * hd + d;
    grads[o] = aq;
    grads[o + E] = ak;
    grads[o + 2 * E] = av;
    grads_r[o] = fk::bf16_round(aq);
    grads_r[o + E] = fk::bf16_round(ak);
    grads_r[o + 2 * E] = fk::bf16_round(av);
  }
}

// the weight products over the R rows, blockIdx.z the product: 0 dWqk (E,
// 2E) = bf16(x + pos)^T grads_r[:, :2E], 1 dWv (E, E) = bf16(x)^T grads_r[:,
// 2E:], 2 dWo (E, E) = c^T dres; a block a (32-row, 256-column) tile of one
__global__ void __launch_bounds__(fk::kThreads)
sa_wgrad16_kernel(const float* __restrict__ x, const float* __restrict__ pos, int Pp,
                  const float* __restrict__ c, const float* __restrict__ grads_r,
                  const float* __restrict__ dres, float* __restrict__ dw, int R, int M, int E) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<kFwdRows>& s = *reinterpret_cast<fk::GemmSmem<kFwdRows>*>(smem_raw);
  const int z = blockIdx.z;
  const int N = z == 0 ? 2 * E : E;
  const int m0 = blockIdx.x * kFwdRows, n0 = blockIdx.y * fk::kBN;
  if (n0 >= N) return;
  const float* W = z == 0 ? grads_r : z == 1 ? grads_r + 2 * E : dres;
  const int ldw = z == 2 ? E : 3 * E;
  float* out = dw + (z == 0 ? 0 : z == 1 ? (size_t)2 * E * E : (size_t)3 * E * E);
  constexpr int RM = kFwdRows / 8;
  float acc[RM][8];
  fk::gemm_pass<kFwdRows, true>(
      acc,
      [&](int m, int r) {  // A^T's element (m, r): row r of the product's left operand
        const int col = m0 + m;
        if (col >= E) return 0.f;
        const size_t e = (size_t)r * E + col;
        if (z == 2) return __ldg(c + e);
        float v = __ldg(x + e);
        if (z == 0 && pos != nullptr && col < Pp) v += __ldg(pos + (size_t)(r % M) * Pp + col);
        return fk::bf16_round(v);
      },
      W, ldw, R, n0, N, s);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + fk::pass_row<kFwdRows>(i);
    if (m >= E) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + fk::pass_col(j);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// The SA backward's bf16 form, one call of nine launches (see above): x, pos
// (M, Pp) or null, Wq, Wk, Wv (E, E) bf16 with bq, bk, bv; Wo (E, E), bo,
// gamma f32; woT = Wo^T (E, E) f32, wqkT = [Wq | Wk]^T (2E, E) and wvT =
// Wv^T (E, E) bf16; g (B, M, E) -> dx (R, E), dres (R, E), grads (R, 3E) =
// [dq | dk | dv], dxa (R, E), part (ceil(R / 16), 2, E) the LayerNorm tiles'
// dgamma | dbeta, dw = [dWqk (E, 2E) | dWv (E, E) | dWo (E, E)]; qkv (B, 3,
// M, E) bf16, c, t, dout, dO (R, E) and grads_r (R, 3E) scratch.
extern "C" int fk_sa_bwd16(const float* x, const float* pos, int Pp, const void* wq,
                           const float* bq, const void* wk, const float* bk, const void* wv,
                           const float* bv, const float* wo, const float* bo, const float* gamma,
                           const float* woT, const void* wqkT, const void* wvT, const float* g,
                           void* qkv, float* c, float* t, float* dres, float* dout, float* dO,
                           float* grads, float* grads_r, float* dxa, float* part, float* dx,
                           float* dw, int B, int M, int E, int H, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int R = B * M, hd = E / H;
  const fk::Dropout none{nullptr, 0, 0u, 1.f};
  const size_t gsm = sizeof(fk::GemmSmem<kFwdRows>);
  const size_t rsm = sa_rows_smem_floats(M, hd) * sizeof(float);
  const size_t asm_ = ((size_t)4 * M * (hd + 1) + (size_t)2 * M * M) * sizeof(float);
  const size_t lsm = (size_t)2 * kLnRows * E * sizeof(float);
  const int ln_tiles = (R + kLnRows - 1) / kLnRows;
  const dim3 rows_e((R + kFwdRows - 1) / kFwdRows, (E + fk::kBN - 1) / fk::kBN);
  cudaError_t err;
  if ((err = fk::set_smem((const void*)sa_qkv16_kernel, gsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_context_kernel<fk::bf16>, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_attn_bwd16_kernel, asm_)) != cudaSuccess ||
      (err = fk::set_smem((const void*)ffn_bwd_ln_kernel, lsm)) != cudaSuccess)
    return (int)err;
  sa_qkv16_kernel<<<dim3((M + kFwdRows - 1) / kFwdRows, B, 3), fk::kThreads, gsm, st>>>(
      x, pos, Pp, (const fk::bf16*)wq, bq, (const fk::bf16*)wk, bk, (const fk::bf16*)wv, bv,
      (fk::bf16*)qkv, M, E);
  sa_context_kernel<fk::bf16><<<dim3((M + QT - 1) / QT, H, B), fk::kThreads, rsm, st>>>(
      (const fk::bf16*)qkv, 3 * (long long)M * E, E, M * E, 2 * M * E, none, c, M, E, H);
  rows_mm_kernel<float, false><<<rows_e, fk::kThreads, gsm, st>>>(c, E, wo, E, E, R, nullptr,
                                                                   nullptr, t);
  ffn_bwd_ln_kernel<<<ln_tiles, fk::kThreads, lsm, st>>>(x, t, bo, gamma, nullptr, none, g, dres,
                                                         dout, E, part, R, E, 1, eps);
  rows_mm_kernel<float, false><<<rows_e, fk::kThreads, gsm, st>>>(dres, E, woT, E, E, R, nullptr,
                                                                   nullptr, dO);
  sa_attn_bwd16_kernel<<<dim3(H, B), fk::kThreads, asm_, st>>>((const fk::bf16*)qkv, dO, grads,
                                                               grads_r, M, E, H);
  rows_mm_kernel<fk::bf16, true><<<rows_e, fk::kThreads, gsm, st>>>(
      grads, 3 * E, (const fk::bf16*)wqkT, 2 * E, E, R, nullptr, nullptr, dxa);
  rows_mm_kernel<fk::bf16, true><<<rows_e, fk::kThreads, gsm, st>>>(
      grads + 2 * E, 3 * E, (const fk::bf16*)wvT, E, E, R, dres, dxa, dx);
  sa_wgrad16_kernel<<<dim3((E + kFwdRows - 1) / kFwdRows, (2 * E + fk::kBN - 1) / fk::kBN, 3),
                      fk::kThreads, gsm, st>>>(x, pos, Pp, c, grads_r, dres, dw, R, M, E);
  return (int)cudaGetLastError();
}
