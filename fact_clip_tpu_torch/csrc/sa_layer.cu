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
// another).  So the SA forward is three kernels, the backward's split:
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
// call's masks, takes the LayerNorm backward (eps 1e-6) and writes dx.  The
// SA backward hashes its two masks inline from the forward's seed, as the
// forward does (a replayed mask tensor may stand in, for the tests); the
// FFN backward reads the masks that dropout.cu regenerated for the call:
//   SA:  dout = dres * keep_o; dc = dout Wo^T; per head dPd = dc_h v_h^T,
//        dv_h = Pd^T dc_h, dS = P * (dPd * keep_a - D) * scale with the row
//        term D = dc_h . c_h (= rowsum(P * dPd * keep_a)), dq_h = dS k_h,
//        dk_h = dS^T q_h; dxa = dq Wq^T + dk Wk^T; dx = dres + dxa + dv Wv^T.
//        The TPU kernel holds a video's whole sublayer in VMEM (100 MB,
//        _COMPILER_PARAMS); one H100 block cannot hold the two (M, M) panels
//        past M ~ 124 (922 KB at epic's M=300).  So the backward is six
//        kernels in the FlashAttention-2 split, none with atomics: the
//        projections (q, k, v), the per-row softmax with its statistics and
//        the context c, the LayerNorm backward with dout and dc, and dx, over
//        (64-row tile, video) on the GEMM core; dq over (32-query tile, head,
//        video), a warp per query row with p recomputed from the saved
//        statistics; dk and dv over (32-key tile, head, video), each warp
//        walking every query row in order for its 4 keys.  A block holds one
//        head's rows of every key (or query) and of its tile: 97 KB at
//        M=300, hd=32, so any token count of the zoo fits (ops/sa_layer.py::
//        has_backward).  The wrapper takes dWq|dWk = (x + pos)^T [dq | dk],
//        dWv = x^T dv, dWo = c^T dout with grad.cu's fk_atb and sums those
//        partials, the bias columns, the per-tile LN sums and d(pos) =
//        sum_b dxa[b] with fk_reduce, in a fixed order.
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
// The SA forward and backward at epic's B=1, M=300, H=8 give
// each attention kernel 80 blocks and each row kernel 10 (forward) or 5
// (backward); the backward's 0.75 GFLOP is 0.011 ms at 67 TFLOP/s; it
// recomputes p twice more and its key-tile kernel reduces each score over
// the lanes with shuffles.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // token rows per GEMM pass
constexpr int kFwdRows = 32;  // token rows of the SA forward's projection and out-projection blocks

// rows [r0, r0 + TBM) of A @ W (W: K x N, row-major), the columns from n_lo
// up to n_hi; epi(r, c, acc) takes each finished value of a row r < M
template <int TBM = BM, class LoadA, class Epi>
__device__ __forceinline__ void rows_gemm(LoadA load_a, const float* __restrict__ W, int K, int N,
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

// The LayerNorm backward of M rows: `res` holds the LN input and is
// overwritten with dres = rstd * (gg - mean(gg) - xhat * mean(gg * xhat)),
// gg = g * gamma; dgamma = sum_r g * xhat and dbeta = sum_r g go to
// part[0:E], part[E:2E] (row order).  dout != nullptr also writes dout =
// dres * keep_out, row r's element c at keep_out's index k0 + r E + c.  The
// caller synchronises first.
__device__ __forceinline__ void ln_backward(float* res, const float* __restrict__ g,
                                            const float* __restrict__ gamma, const float* mean,
                                            const float* rstd, int M, int E,
                                            float* __restrict__ part, const Keep& keep_out,
                                            size_t k0, float* __restrict__ dout) {
  for (int c = threadIdx.x; c < E; c += fk::kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < M; ++r) {
      const float gv = __ldg(g + (size_t)r * E + c);
      sg = fmaf(gv, (res[(size_t)r * E + c] - mean[r]) * rstd[r], sg);
      sb += gv;
    }
    part[c] = sg;
    part[E + c] = sb;
  }
  __syncthreads();  // every column sum has read res before it is overwritten
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < M; r += fk::kWarps) {
    float* row = res + (size_t)r * E;
    const float* gr = g + (size_t)r * E;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float gg = __ldg(gr + c) * __ldg(gamma + c);
      s1 += gg;
      s2 += gg * (row[c] - mean[r]) * rstd[r];
    }
    s1 = fk::warp_sum(s1) / E;
    s2 = fk::warp_sum(s2) / E;
    for (int c = lane; c < E; c += 32) {
      const float xhat = (row[c] - mean[r]) * rstd[r];
      const float d = rstd[r] * (__ldg(gr + c) * __ldg(gamma + c) - s1 - xhat * s2);
      row[c] = d;
      if (dout != nullptr)
        dout[(size_t)r * E + c] = keep_out.on() ? d * keep_out.at(k0 + (size_t)r * E + c) : d;
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
// keep_1 is the backward's mask tensor or, in the forward, hashed inline
// (FFN stream 0 over (B, M, F), the bits of ffn_dropout_masks).
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
  fk::Dropout drop;   // kHidden without keep: keep_1 hashed (a null seed: none)
};

// per (32-row tile, K slice, 256 columns of N): the slice's partial product
// A[:, slice] W[slice, :] (A: R x K, W: K x N) into part[slice] (R x N)
template <int AM>
__global__ void __launch_bounds__(fk::kThreads)
ffn_slice_kernel(const FfnSlice a, const float* __restrict__ W, float* __restrict__ part, int R,
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
        if (AM == kPanel) return a.A[eo];
        if (AM == kHidden) {  // z1 = x W1 + b1; hk = relu(z1) * keep_1
          const float v = slice_sum(a.pa, RK, a.n_pa, e) + __ldg(a.bias + k0 + k);
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
        if (a.keep != nullptr) v *= __ldg(a.keep + e);
        const float d = __ldg(a.z1 + e) > 0.f ? v : 0.f;
        if (write) a.out[eo] = d;
        return d;
      },
      W + (size_t)k0 * N, ks, N, r0, R,
      [&](int r, int c, float v) { out[(size_t)r * N + c] = v; }, s, n0, n0 + fk::kBN);
}

// Per 16-row tile, whole E rows: res = x + drop_2((hk W2's slices) + b2)
// into rs (the tile's rows in shared memory, E wide) and, where g is
// given, the tile's g rows into gs; then the rows' LayerNorm statistics
// (ln_stats's two-pass sums).  Four columns a thread at a time with every
// load issued before any is used (a scalar loop where E % 4 != 0 or F >
// 2048): row-serial global loads took ~30 us a tile.  keep_2 is the
// backward's mask tensor or, in the forward, hashed inline (FFN stream 1
// over (B, M, E)).  Both directions' LayerNorm kernels start so.
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
//    same sums as ln_stats and ln_backward.
__global__ void __launch_bounds__(fk::kThreads)
ffn_bwd_ln_kernel(const float* __restrict__ x, const float* __restrict__ t2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  const float* __restrict__ keep_2, const float* __restrict__ g,
                  float* __restrict__ res, float* __restrict__ dt2, int ld,
                  float* __restrict__ part, int R, int E, int slices, float eps) {
  extern __shared__ float4 smem_raw[];
  float* rs = reinterpret_cast<float*>(smem_raw);  // [rows][E]: res, then dres
  float* gs = rs + kLnRows * E;                    // [rows][E]: g
  __shared__ float mean[kLnRows], rstd[kLnRows];
  const int tile = blockIdx.x, r0 = tile * kLnRows;
  const int rows = min(kLnRows, R - r0);
  const int n = rows * E;
  const size_t t0 = (size_t)r0 * E;
  ffn_ln_stage(x, t2, b2, keep_2, fk::Dropout{nullptr, 0, 0u, 1.f}, g, rs, gs, mean, rstd, r0,
               rows, R, E, slices, eps);
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
  for (int i = threadIdx.x; i < n; i += fk::kThreads) {
    const float d = rs[i];
    res[t0 + i] = d;
    dt2[(size_t)(r0 + i / E) * ld + i % E] = keep_2 != nullptr ? d * __ldg(keep_2 + t0 + i) : d;
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
// SA backward: six kernels, each over (row tile, video) or (tile of QT query
// rows or keys, head, video), so that a video's attention spreads over
// H * ceil(M / QT) blocks and no (M, M) panel is ever held.

constexpr int QT = 32;  // query rows or keys of an attention block

// Shared memory (floats) of the attention kernels over query tiles: one
// head's k and v rows of every key, the tile's q and dc rows, and one
// M-long row per warp.
__host__ __device__ inline size_t sa_rows_smem_floats(int M, int hd) {
  return (size_t)2 * M * (hd + 1) + (size_t)2 * QT * (hd + 1) + (size_t)fk::kWarps * M;
}

// ... and of the kernel over key tiles: one head's q and dc rows of every
// query, the tile's k and v rows and the row statistics (max, 1 / sum, D).
__host__ __device__ inline size_t sa_keys_smem_floats(int M, int hd) {
  return (size_t)2 * M * (hd + 1) + (size_t)2 * QT * (hd + 1) + (size_t)3 * M;
}

// rows [r0, r0 + n) of head h of an (M, E) panel into dst[n][hd + 1] (odd
// row stride: lane j reading row j is conflict-free), zero past M
__device__ __forceinline__ void stage_head(float* dst, const float* src, int r0, int n, int M,
                                           int E, int h, int hd) {
  const int ldh = hd + 1;
  for (int i = threadIdx.x; i < n * hd; i += fk::kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    dst[r * ldh + d] = r0 + r < M ? src[(size_t)(r0 + r) * E + h * hd + d] : 0.f;
  }
}

__device__ __forceinline__ float dot_h(const float* a, const float* b, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// 1. q = (x + pos) Wq + bq, k = (x + pos) Wk + bk, v = x Wv + bv into
//    qkv[b][0..2]: one block per (TBM-row tile, video, projection); the
//    forward takes 32-row tiles (kFwdRows), the backward 64
template <int TBM>
__global__ void __launch_bounds__(fk::kThreads)
sa_qkv_kernel(const float* __restrict__ x, const float* __restrict__ pos, int Pp,
              const float* __restrict__ wq, const float* __restrict__ bq,
              const float* __restrict__ wk, const float* __restrict__ bk,
              const float* __restrict__ wv, const float* __restrict__ bv,
              float* __restrict__ qkv, int M, int E) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<TBM>& s = *reinterpret_cast<fk::GemmSmem<TBM>*>(smem_raw);
  const int r0 = blockIdx.x * TBM;
  const int b = blockIdx.y;
  const int which = blockIdx.z;
  const size_t ME = (size_t)M * E;
  const float* W = which == 0 ? wq : which == 1 ? wk : wv;
  const float* bias = which == 0 ? bq : which == 1 ? bk : bv;
  float* out = qkv + ((size_t)b * 3 + which) * ME;
  rows_gemm<TBM>(Rows{x + b * ME, which < 2 ? pos : nullptr, Pp, r0, M, E}, W, E, E, r0, M,
                 [&](int r, int c, float v) { out[(size_t)r * E + c] = v + __ldg(bias + c); }, s);
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

// 2. per (query tile, head, video): each query row's softmax over the M keys
//    by one warp and its context c_h = (P * keep) v_h, into c (B, M, E).
//    q, k and v of video b, token m sit at qkv + b * bstride + m * ld (+ koff,
//    + voff), head h's columns at + h * hd; K_h and V_h of every key and the
//    tile's q rows are staged by cp.async.  Both directions hash the keep
//    values inline (drop: SA stream 0 over (B, H*M, M), the index layout of
//    ops/sa_layer.py::sa_dropout_masks, so the bits equal the mask
//    kernel's), or read a replayed mask (keep_a) where one is given; the
//    backward takes each row's statistics (max, 1 / sum) into
//    stats[b][h][m][0..1].
__global__ void __launch_bounds__(fk::kThreads)
sa_context_kernel(const float* __restrict__ qkv, long long bstride, int ld, int koff, int voff,
                  const float* __restrict__ keep_a, fk::Dropout drop, float* __restrict__ c,
                  float* __restrict__ stats, int M, int E, int H) {
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
  const float* qb = qkv + (size_t)b * bstride;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + (size_t)M * ldh;
  float* qs = vs + (size_t)M * ldh;
  float* pw = qs + (size_t)2 * QT * ldh + (size_t)ty * M;
  stage_head_async(ks, qb + koff, ld, 0, M, M, h, hd);
  stage_head_async(vs, qb + voff, ld, 0, M, M, h, hd);
  stage_head_async(qs, qb, ld, m0, QT, M, h, hd);
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
      if (keep_a != nullptr)
        p *= __ldg(keep_a + row * M + j);
      else if (drop.seed != nullptr)
        p *= drop.keep((uint32_t)row * (uint32_t)M + (uint32_t)j, seed);
      pw[j] = p;
    }
    __syncwarp();
    for (int d = tx; d < hd; d += 32) {
      float o = 0.f;
      for (int j = 0; j < M; ++j) o = fmaf(pw[j], vs[j * ldh + d], o);
      c[(size_t)b * ME + (size_t)m * E + h * hd + d] = o;
    }
    if (stats != nullptr && tx == 0) {
      stats[row * 3] = mx;
      stats[row * 3 + 1] = inv;
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

// 3. per (64-row tile, video): res = x + drop_o(c Wo + bo), its LayerNorm
//    statistics and backward (res is overwritten with dres; dgamma and dbeta
//    of the tile into part[b * tiles + tile]), dout = dres * keep_o, and
//    dc = dout Wo^T; keep_o the replayed mask or hashed (drop_o)
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_ln_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ wo, const float* __restrict__ bo,
                 const float* __restrict__ wot, const float* __restrict__ gamma,
                 const float* __restrict__ keep_o, fk::Dropout drop_o, const float* __restrict__ g,
                 float* __restrict__ res, float* __restrict__ dout, float* __restrict__ dc,
                 float* __restrict__ part, int M, int E, float eps) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  float* mean = reinterpret_cast<float*>(smem_raw) + sizeof(fk::GemmSmem<BM>) / sizeof(float);
  float* rstd = mean + BM;
  const int tile = blockIdx.x;
  const int r0 = tile * BM;
  const int b = blockIdx.y;
  const int rows = min(BM, M - r0);
  const size_t off = (size_t)b * M * E;
  const size_t t0 = (size_t)r0 * E;
  const float* xb = x + off;
  const Keep ko(keep_o, drop_o);
  float* rb = res + off;
  float* db = dout + off;
  rows_gemm(Rows{c + off, nullptr, 0, r0, M, E}, wo, E, E, r0, M,
            [&](int r, int col, float v) {
              const size_t e = (size_t)r * E + col;
              v += __ldg(bo + col);
              if (ko.on()) v *= ko.at(off + e);
              rb[e] = v + __ldg(xb + e);
            }, s);
  __syncthreads();
  ln_stats(rb + t0, rows, E, eps, mean, rstd);
  __syncthreads();
  ln_backward(rb + t0, g + off + t0, gamma, mean, rstd, rows, E,
              part + ((size_t)b * gridDim.x + tile) * 2 * E, ko, off + t0, db + t0);
  __syncthreads();
  rows_gemm(Rows{db, nullptr, 0, r0, M, E}, wot, E, E, r0, M,
            [&](int r, int col, float v) { dc[off + (size_t)r * E + col] = v; }, s);
}

// 4. per (query tile, head, video), one warp per query row m: the row term
//    D = dc_h[m] . c_h[m] (= sum_j p_mj dp_mj, also under the attention
//    dropout) into stats[b][h][m][2]; dS_mj = p_mj (dPd_mj keep_mj - D)
//    scale with p recomputed from the saved statistics and dPd = dc_h v_h^T;
//    dq_h[m] = dS_m k_h into the first E columns of dqk; keep_a the replayed
//    mask or hashed (drop_a)
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ c,
                 const float* __restrict__ dc, const float* __restrict__ keep_a,
                 fk::Dropout drop_a, float* __restrict__ stats, float* __restrict__ dqk, int M,
                 int E, int H) {
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
  const float* qb = qkv + (size_t)b * 3 * ME;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + (size_t)M * ldh;
  float* qs = vs + (size_t)M * ldh;
  float* dcs = qs + (size_t)QT * ldh;
  float* pw = dcs + (size_t)QT * ldh + (size_t)ty * M;
  stage_head(ks, qb + ME, 0, M, M, E, h, hd);
  stage_head(vs, qb + 2 * ME, 0, M, M, E, h, hd);
  stage_head(qs, qb, m0, QT, M, E, h, hd);
  stage_head(dcs, dc + (size_t)b * ME, m0, QT, M, E, h, hd);
  const Keep ka(keep_a, drop_a);
  __syncthreads();
  for (int r = ty; r < min(QT, M - m0); r += fk::kWarps) {
    const int m = m0 + r;
    const size_t row = ((size_t)b * H + h) * M + m;
    const float* qr = qs + r * ldh;
    const float* dr = dcs + r * ldh;
    const float* cr = c + (size_t)b * ME + (size_t)m * E + h * hd;
    float dsum = 0.f;
    for (int d = tx; d < hd; d += 32) dsum = fmaf(dr[d], cr[d], dsum);
    const float D = fk::warp_sum(dsum);
    const float mx = stats[row * 3];
    const float inv = stats[row * 3 + 1];
    for (int j = tx; j < M; j += 32) {
      const float p = expf(dot_h(qr, ks + j * ldh, hd) * scale - mx) * inv;
      float dp = dot_h(dr, vs + j * ldh, hd);
      if (ka.on()) dp *= ka.at(row * M + j);
      pw[j] = p * (dp - D) * scale;
    }
    __syncwarp();
    for (int d = tx; d < hd; d += 32) {
      float a = 0.f;
      for (int j = 0; j < M; ++j) a = fmaf(pw[j], ks[j * ldh + d], a);
      dqk[((size_t)b * M + m) * 2 * E + h * hd + d] = a;
    }
    if (tx == 0) stats[row * 3 + 2] = D;
    __syncwarp();
  }
}

// 5. per (key tile, head, video): each warp owns 4 keys of the tile and
//    walks every query row i, lanes over the head's dimensions (NT per
//    lane): p_ij and dS_ij recomputed from the saved statistics and D, then
//    dv_h[j] += (p_ij keep_ij) dc_h[i] and dk_h[j] += dS_ij q_h[i] in
//    registers, in row order; dk_h into the last E columns of dqk, dv_h into
//    dv; keep_a the replayed mask or hashed (drop_a), each lane reading or
//    hashing one of the warp's 4 keys x 8 rows and shuffling it to the others
template <int NT>
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dc,
                  const float* __restrict__ keep_a, fk::Dropout drop_a,
                  const float* __restrict__ stats,
                  float* __restrict__ dqk, float* __restrict__ dv, int M, int E, int H) {
  constexpr int KW = QT / fk::kWarps;  // keys per warp
  extern __shared__ float4 smem_raw[];
  const int hd = E / H;
  const int ldh = hd + 1;
  const int j0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t ME = (size_t)M * E;
  const float* qb = qkv + (size_t)b * 3 * ME;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dcs = qs + (size_t)M * ldh;
  float* kt = dcs + (size_t)M * ldh;
  float* vt = kt + (size_t)QT * ldh;
  float* st = vt + (size_t)QT * ldh;
  const size_t row0 = ((size_t)b * H + h) * M;
  stage_head(qs, qb, 0, M, M, E, h, hd);
  stage_head(dcs, dc + (size_t)b * ME, 0, M, M, E, h, hd);
  stage_head(kt, qb + ME, j0, QT, M, E, h, hd);
  stage_head(vt, qb + 2 * ME, j0, QT, M, E, h, hd);
  for (int i = threadIdx.x; i < 3 * M; i += fk::kThreads) st[i] = stats[row0 * 3 + i];
  const Keep ka(keep_a, drop_a);
  __syncthreads();

  float kr[KW][NT], vr[KW][NT], ak[KW][NT], av[KW][NT];
#pragma unroll
  for (int u = 0; u < KW; ++u)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = tx + 32 * t;
      const int jl = ty * KW + u;
      kr[u][t] = d < hd ? kt[jl * ldh + d] : 0.f;
      vr[u][t] = d < hd ? vt[jl * ldh + d] : 0.f;
      ak[u][t] = av[u][t] = 0.f;
    }
  const int jw = j0 + ty * KW;  // the warp's first key
  constexpr int KR = 32 / KW;   // query rows whose keep values the warp's lanes hold at once
  float kl = 1.f;  // lane tx's keep value of (row i - i % KR + tx / KW, key jw + tx % KW)
  for (int i = 0; i < M; ++i) {
    if (ka.on() && i % KR == 0) {  // warp-uniform: one load or hash a lane for KR rows
      const int il = i + tx / KW, j = jw + tx % KW;
      kl = il < M && j < M ? ka.at((row0 + il) * M + j) : 1.f;
    }
    float qd[NT], dd[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = tx + 32 * t;
      qd[t] = d < hd ? qs[i * ldh + d] : 0.f;
      dd[t] = d < hd ? dcs[i * ldh + d] : 0.f;
    }
    float sp[KW], dp[KW];
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      float a = 0.f, e = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        a = fmaf(qd[t], kr[u][t], a);
        e = fmaf(dd[t], vr[u][t], e);
      }
      sp[u] = fk::warp_sum(a);
      dp[u] = fk::warp_sum(e);
    }
    const float mx = st[3 * i], inv = st[3 * i + 1], D = st[3 * i + 2];
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      const float p = expf(sp[u] * scale - mx) * inv;
      const float keep = ka.on() ? __shfl_sync(0xffffffffu, kl, (i % KR) * KW + u) : 1.f;
      const float pd = p * keep;
      const float ds = p * (dp[u] * keep - D) * scale;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        av[u][t] = fmaf(pd, dd[t], av[u][t]);
        ak[u][t] = fmaf(ds, qd[t], ak[u][t]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KW; ++u) {
    const int j = jw + u;
    if (j >= M) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = tx + 32 * t;
      if (d >= hd) continue;
      dqk[((size_t)b * M + j) * 2 * E + E + h * hd + d] = ak[u][t];
      dv[(size_t)b * ME + (size_t)j * E + h * hd + d] = av[u][t];
    }
  }
}

// 6. per (64-row tile, video): dxa = [dq | dk] @ [Wq^T ; Wk^T] and
//    dx = dres + dxa + dv Wv^T
__global__ void __launch_bounds__(fk::kThreads)
sa_bwd_dx_kernel(const float* __restrict__ dqk, const float* __restrict__ dv,
                 const float* __restrict__ dres, const float* __restrict__ wqkt,
                 const float* __restrict__ wvt, float* __restrict__ dxa, float* __restrict__ dx,
                 int M, int E) {
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  const int r0 = blockIdx.x * BM;
  const int b = blockIdx.y;
  const size_t off = (size_t)b * M * E;
  rows_gemm(Rows{dqk + 2 * off, nullptr, 0, r0, M, 2 * E}, wqkt, 2 * E, E, r0, M,
            [&](int r, int col, float v) { dxa[off + (size_t)r * E + col] = v; }, s);
  __syncthreads();
  // plain loads of dxa: written above, by this thread (same pass mapping)
  rows_gemm(Rows{dv + off, nullptr, 0, r0, M, E}, wvt, E, E, r0, M,
            [&](int r, int col, float v) {
              const size_t e = off + (size_t)r * E + col;
              dx[e] = v + dres[e] + dxa[e];
            }, s);
}

}  // namespace

// The SA forward's projections: q, k, v into qkv (B, 3, M, E), one block
// per (kFwdRows-row tile, video, projection).
extern "C" int fk_sa_qkv(const float* x, const float* pos, int Pp, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, float* qkv, int B, int M, int E, void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<kFwdRows>);
  cudaError_t err = fk::set_smem((const void*)sa_qkv_kernel<kFwdRows>, smem);
  if (err != cudaSuccess) return (int)err;
  sa_qkv_kernel<kFwdRows><<<dim3((M + kFwdRows - 1) / kFwdRows, B, 3), fk::kThreads, smem,
                            (cudaStream_t)stream>>>(x, pos, Pp, wq, bq, wk, bk, wv, bv, qkv, M,
                                                    E);
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
  if ((err = fk::set_smem((const void*)sa_context_kernel, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_out_ln_kernel<kFwdRows>, osm)) != cudaSuccess)
    return (int)err;
  sa_context_kernel<<<dim3((M + QT - 1) / QT, H, B), fk::kThreads, rsm, st>>>(
      qkv, bstride, ld, koff, voff, nullptr, fk::Dropout{seed_a, stream_a, thresh_a, scale_a}, c,
      nullptr, M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_out_ln_kernel<kFwdRows><<<dim3((M + kFwdRows - 1) / kFwdRows, B), fk::kThreads, osm, st>>>(
      x, c, wo, bo, gamma, beta, y, M, E, eps, fk::Dropout{seed_o, stream_o, thresh_o, scale_o});
  return (int)cudaGetLastError();
}

extern "C" int fk_sa_bwd(const float* x, const float* pos, int Pp, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, const float* wo, const float* bo, const float* gamma,
                         const float* wot, const float* wqkt, const float* wvt,
                         const float* keep_a, const float* keep_o, const float* g, float* qkv,
                         float* c, float* res, float* dout, float* dc, float* stats, float* dqk,
                         float* dv, float* dxa, float* dx, float* part, int B, int M, int E,
                         int H, float eps, const int* seed_a, int stream_a, unsigned thresh_a,
                         float scale_a, const int* seed_o, int stream_o, unsigned thresh_o,
                         float scale_o, void* stream) {
  const int hd = E / H;
  if (hd > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const fk::Dropout drop_a{seed_a, stream_a, thresh_a, scale_a};
  const fk::Dropout drop_o{seed_o, stream_o, thresh_o, scale_o};
  const dim3 rows((M + BM - 1) / BM, B);
  const dim3 attn((M + QT - 1) / QT, H, B);
  const size_t gsm = sizeof(fk::GemmSmem<BM>);
  const size_t rsm = sa_rows_smem_floats(M, hd) * sizeof(float);
  const size_t ksm = sa_keys_smem_floats(M, hd) * sizeof(float);
  const void* dkv = hd <= 32 ? (const void*)sa_bwd_dkv_kernel<1> : (const void*)sa_bwd_dkv_kernel<2>;
  cudaError_t err;
  if ((err = fk::set_smem((const void*)sa_qkv_kernel<BM>, gsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_context_kernel, rsm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_bwd_ln_kernel, gsm + 2 * BM * sizeof(float))) !=
          cudaSuccess ||
      (err = fk::set_smem((const void*)sa_bwd_dq_kernel, rsm)) != cudaSuccess ||
      (err = fk::set_smem(dkv, ksm)) != cudaSuccess ||
      (err = fk::set_smem((const void*)sa_bwd_dx_kernel, gsm)) != cudaSuccess)
    return (int)err;
  sa_qkv_kernel<BM><<<dim3(rows.x, B, 3), fk::kThreads, gsm, st>>>(x, pos, Pp, wq, bq, wk, bk, wv,
                                                                   bv, qkv, M, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long ME = (long long)M * E;
  sa_context_kernel<<<attn, fk::kThreads, rsm, st>>>(qkv, 3 * ME, E, (int)ME, (int)(2 * ME),
                                                     keep_a, drop_a, c, stats, M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_bwd_ln_kernel<<<rows, fk::kThreads, gsm + 2 * BM * sizeof(float), st>>>(
      x, c, wo, bo, wot, gamma, keep_o, drop_o, g, res, dout, dc, part, M, E, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_bwd_dq_kernel<<<attn, fk::kThreads, rsm, st>>>(qkv, c, dc, keep_a, drop_a, stats, dqk, M, E,
                                                    H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (hd <= 32)
    sa_bwd_dkv_kernel<1><<<attn, fk::kThreads, ksm, st>>>(qkv, dc, keep_a, drop_a, stats, dqk, dv,
                                                          M, E, H);
  else
    sa_bwd_dkv_kernel<2><<<attn, fk::kThreads, ksm, st>>>(qkv, dc, keep_a, drop_a, stats, dqk, dv,
                                                          M, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sa_bwd_dx_kernel<<<rows, fk::kThreads, gsm, st>>>(dqk, dv, res, wqkt, wvt, dxa, dx, M, E);
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

// The FFN backward in one call over the B * M token rows into ws
// (fk_ffn_bwd_workspace's floats): W1^T and W2^T, x and the ones columns
// into the weight products' operands, then the steps above.
extern "C" int fk_ffn_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* gamma, const float* keep_1,
                          const float* keep_2, const float* g, float* ws, int B, int M, int E,
                          int F, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
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
      w1, w2, wt, x, lhs, w.ldl, rhs, w.ldr, R, E, F);
  // x W1 -> sa; hk W2 -> sb (z1 and hk from sa as they are staged); the
  // LayerNorm step; dt2 W2^T -> sa; dz1 W1^T -> sb (dz1 from sa); dx and the
  // LN sums
  ffn_slice_kernel<kPanel><<<gr.ef, fk::kThreads, gsm, st>>>(
      FfnSlice{x, nullptr, 0, nullptr, nullptr, nullptr, nullptr, E, none}, w1, sa, R, E, F);
  ffn_slice_kernel<kHidden><<<gr.fe, fk::kThreads, gsm, st>>>(
      FfnSlice{nullptr, sa, gr.es, b1, keep_1, z1, hk, w.ldl, none}, w2, sb, R, F, E);
  ffn_bwd_ln_kernel<<<gr.ln_tiles, fk::kThreads, lsm, st>>>(x, sb, b2, gamma, keep_2, g, res,
                                                            dt2, w.ldr, part, R, E, gr.fs, eps);
  ffn_slice_kernel<kPanel><<<gr.ef, fk::kThreads, gsm, st>>>(
      FfnSlice{dt2, nullptr, 0, nullptr, nullptr, nullptr, nullptr, w.ldr, none},
      wt + (size_t)E * F, sa, R, E, F);
  ffn_slice_kernel<kDz1><<<gr.fe, fk::kThreads, gsm, st>>>(
      FfnSlice{nullptr, sa, gr.es, nullptr, keep_1, z1, dz1, w.ldl, none}, wt, sb, R, F, E);
  ffn_finish_kernel<<<re + (2 * E + fk::kThreads - 1) / fk::kThreads, fk::kThreads, 0, st>>>(
      sb, res, dx, part, ws + w.dgb, R, E, gr.fs, gr.ln_tiles);
  return (int)cudaGetLastError();  // the first failed launch's error, if any
}
