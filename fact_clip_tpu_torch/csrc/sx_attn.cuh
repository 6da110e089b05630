// K2's small-X form on the H100: what its forward (x2y_attn.cu,
// fk_x2y_sx_fwd) and its backward (x2y_bwd.cu, fk_x2y_sx_bwd) share.  K8b
// (x2y_attn.cu, fk_x2y_sx_q8_fwd) takes the prep, the key side and the
// attention's panels, K2's flash forward (flash_attn.cu) the prep's lengths
// and sx_attend.
//
// 1. The projections, one host call launching (sx_project; the key / value
//    side on a second stream beside the query side: at epic's and the TDU's
//    shapes each GEMM fills only 24-64 of the 132 SMs):
//      sx_prep_kernel   the GEMMs' inputs: y + y_pos, [x + x_pos | x] (the
//                       key's and the value's inputs side by side), the
//                       lengths (Y for every video's queries; x_len, or all
//                       X keys of a video with x_len = 0, for the keys)
//      fk_k6_pack       Wq^T, Wk^T and Wv^T as the GEMM reads them (3xTF32 hi / lo)
//      fk_k6_gemm       yq = (y + y_pos) Wq + bq, every row, and
//                       kv = [xk | xv] (B, X, 2d): one launch of two problems
//                       (Wk on the first Cx channels, Wv on the next), zero
//                       at keys at or past the key length; epilogue kProj32
//                       (tc_tower.cuh: kProj's, promoted once a 32-deep step).
//    JAX's kernel adds y_pos to y before its product, and so does the prep,
//    at every shape, so that the backward's recomputed yq is the forward's
//    (a table y_pos @ Wq from a GEMM over one video's rows in yq's epilogue
//    was 0.014 ms faster at the flagship's 8 x 3072 x 512, 0.005 ms slower at
//    Breakfast's 4 x 4096 x 512 and ~0.02 ms slower at epic's shapes; H100
//    80GB HBM3, 700 W).
// 2. The panel products of the attention kernels, f32 FMA.  A block takes
//    BQ = 4R query rows of one video, 256 threads: thread row ty (0..3) owns
//    rows R*ty .. R*ty + R - 1, thread column tx (0..63) a key (the dot
//    products against the keys, sx_dots) or four columns of d (the sums over
//    the keys, sx_attend).  The operands come from kv, row-major, staged
//    into one shared-memory panel at a time; the next panel's loads are in
//    registers while this one is multiplied:
//      sx_dots    acc[i] = sum_c A[R ty + i][c] kv[j0 + tx][col0 + c]
//                 (A the block's (BQ, d) rows in shared memory: yq for the
//                 logits, g_attn for the dprobs), through 64-key panels of
//                 64 or 128 columns (SxPanels); a thread's float4 of its key
//                 against the float4 of each of its rows (broadcast);
//      sx_attend  acc[i][q] = sum_{j < nk} S[R ty + i][j] kv[j][col0 + n0 + 4 tx + q]
//                 (S the block's (BQ, X) rows in shared memory: probs for
//                 the attend, dlogits for dyq), through panels of 16-64 keys
//                 x 256 columns; a thread's float4 of the key's row against
//                 one S value of each of its rows (broadcast).
//    sx_dots reads R + 1 shared-memory vectors for 4R FMAs, sx_attend R + 4
//    for 16R, so the shared-memory pipe, not the FMA pipe, is the bound, the
//    less so the larger R: 32-row tiles where the grid gives two blocks or
//    more an SM (the flagship's and Breakfast's a2f), 8 rows where even 16
//    would leave SMs idle (epic's B = 1-2 and Y = 256-300, the TDU's Y = 40).
//    Every sum runs in one fixed order.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "tc_gemm.cuh"

// the towers' GEMM entries (mstcn2.cu) and the fixed-order sum (grad.cu)
extern "C" int fk_k6_pack(const float* src, float* dst, int R, int S, int transpose, int kseg,
                          int kpad, void* stream);
extern "C" int fk_k6_gemm(int mode, const float* a, int a_ch, int nprob, int nseg,
                          const int* segs, int kseg, const float* wpack, int N, int K, int B,
                          int T, const int* lengths, float* out, int ldo, int col_step,
                          const float* bias0, const float* bias1, const float* res, int res_ld,
                          long long res_bstride, float* out2, float* part, const int* seed,
                          int layer, unsigned thresh, float scale, void* stream);
extern "C" int fk_k6_wgrad(const float* A, int a_ch, int a_c0, int Ca, const float* Bm, int b_ch,
                           int b_c0, int Cb, const int* lengths, int shift0, int shift_step,
                           int n_taps, float* part, int B, int T, int Kc, void* stream);
extern "C" int fk_reduce(const float* src, int G, int P, long long pstride, long long gstride,
                         int rows, long long rstride, int cols, float* out, void* stream);
extern "C" int fk_reduce_to(const float* src, int G, int P, long long pstride,
                            long long gstride, int rows, long long rstride, int cols, float* out,
                            long long out_gstride, long long out_rstride, void* stream);

namespace fk {

// tc_tower.cuh's Mode: kMasked, kProj, kProj32
constexpr int kGemmMasked = 0, kGemmProj = 8, kGemmProj32 = 9;

constexpr int kSxKeys = 64;                 // keys per pass of sx_dots (one per thread column)
constexpr int kSxNC = 256;                  // columns of d per pass of sx_attend (four a thread)
constexpr int kSxVS = kSxNC + 4;            // the value panel's row stride
constexpr int kSxMaxKeys = 1024;            // X <= 1024: the small-X form (X > 1024 is flash)

// The panels of a tile of BQ = 4R rows.  The short tile (8 rows) is
// latency-bound on its panels' round trips at epic's and the TDU's shapes and
// has registers to spare, so it stages panels twice as deep; the 32-row tile's
// accumulators leave its value panel's prefetch room for 16 keys only (two
// blocks an SM hold 128 registers a thread).
template <int R>
struct SxPanels {
  static constexpr int DC = R == 2 ? 128 : 64;              // columns of d per key panel
  static constexpr int KS = DC + 4;                         // its row stride: 16-byte rows,
                                                            // conflict-free float4 reads
  static constexpr int VK = R == 2 ? 64 : R == 8 ? 16 : 32;  // keys per value panel
  static constexpr int FLOATS = kSxKeys * KS > VK * kSxVS ? kSxKeys * KS : VK * kSxVS;
};

// floats of the staging panel of a tile of `tile` rows (SxPanels<tile / 4>::FLOATS)
__host__ __device__ __forceinline__ int sx_panel_floats(int tile) {
  return tile == 8 ? SxPanels<2>::FLOATS : tile == 32 ? SxPanels<8>::FLOATS : SxPanels<4>::FLOATS;
}

// a row stride of X floats rounded to 16 bytes: the blocks' S rows, and the
// backward's dlogits and padded probs rows (TMA row strides of the weight products)
__host__ __device__ __forceinline__ int sx_pad(int X) { return (X + 3) & ~3; }

// floats of a block's shared memory: the (BQ, d) rows (yq or g_attn, row
// stride d + 4), the (BQ, X) rows of S, the staging panel
__host__ __device__ __forceinline__ size_t sx_smem_floats(int tile, int X, int d) {
  return (size_t)tile * (d + 4) + (size_t)tile * sx_pad(X) + sx_panel_floats(tile);
}

__device__ __forceinline__ float4 sx_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 sx_ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void sx_st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float4 sx_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the block's rows [0, tile) of a row-major (., d) matrix into dst (row stride
// d + 4), rows at or past `rows` zero; the caller synchronises before reading
__device__ __forceinline__ void sx_stage_rows(float* dst, const float* __restrict__ src, int tile,
                                              int rows, int d) {
  const int n4 = d / 4;
  for (int i = threadIdx.x; i < tile * n4; i += kThreads) {
    const int r = i / n4, c = (i - r * n4) * 4;
    sx_st4(dst + r * (d + 4) + c,
           r < rows ? sx_ldg4(src + (size_t)r * d + c) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// acc[i] = sum_{c < d} A[R ty + i][c] * kv[j0 + tx][col0 + c]; keys at or past
// X read as zero.  Synchronises the block (call it block-uniformly).
template <int R>
__device__ __forceinline__ void sx_dots(float (&acc)[R], const float* A, int d,
                                        const float* __restrict__ kvb, int X, int col0, int j0,
                                        float* panel) {
  constexpr int kDC = SxPanels<R>::DC, kKS = SxPanels<R>::KS;
  constexpr int kPer = kSxKeys * (kDC / 4) / kThreads;  // float4 a thread stages per panel
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const size_t ld = 2 * (size_t)d;
  float4 next[kPer];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (kDC / 4), c = (i - r * (kDC / 4)) * 4;
      next[u] = j0 + r < X && c0 + c < d
                    ? sx_ldg4(kvb + (size_t)(j0 + r) * ld + col0 + c0 + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  fetch(0);
  for (int c0 = 0; c0 < d; c0 += kDC) {
    __syncthreads();  // the panel's last readers are done
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (kDC / 4), c = (i - r * (kDC / 4)) * 4;
      sx_st4(panel + r * kKS + c, next[u]);
    }
    __syncthreads();
    if (c0 + kDC < d) fetch(c0 + kDC);  // in flight while this panel is multiplied
    const int cn = min(kDC, d - c0);
    const float* kr = panel + tx * kKS;
    const float* ar = A + (size_t)R * ty * (d + 4) + c0;
#pragma unroll 4
    for (int c = 0; c < cn; c += 4) {
      const float4 k = sx_ld4(kr + c);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = sx_ld4(ar + (size_t)i * (d + 4) + c);
        acc[i] = fmaf(a.x, k.x, acc[i]);
        acc[i] = fmaf(a.y, k.y, acc[i]);
        acc[i] = fmaf(a.z, k.z, acc[i]);
        acc[i] = fmaf(a.w, k.w, acc[i]);
      }
    }
  }
}

// acc[i][q] = sum_{j < nk} S[R ty + i][j] * kv[j][col0 + n0 + 4 tx + q], the
// keys in order (S row stride ls, a multiple of 4, its values finite up to
// ls: keys past nk are read four at a time against zero rows of the panel);
// columns at or past d read as zero.  Synchronises the block (call it
// block-uniformly).
template <int R>
__device__ __forceinline__ void sx_attend(float (&acc)[R][4], const float* S, int ls,
                                          const float* __restrict__ kvb, int d, int col0, int n0,
                                          int nk, float* panel) {
  constexpr int kVK = SxPanels<R>::VK;
  constexpr int kPer = kVK * (kSxNC / 4) / kThreads;
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const size_t ld = 2 * (size_t)d;
  float4 next[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (kSxNC / 4), c = (i - r * (kSxNC / 4)) * 4;
      next[u] = k0 + r < nk && n0 + c < d
                    ? sx_ldg4(kvb + (size_t)(k0 + r) * ld + col0 + n0 + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (nk > 0) fetch(0);
  for (int k0 = 0; k0 < nk; k0 += kVK) {
    __syncthreads();  // the panel's last readers are done
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (kSxNC / 4), c = (i - r * (kSxNC / 4)) * 4;
      sx_st4(panel + r * kSxVS + c, next[u]);
    }
    __syncthreads();
    if (k0 + kVK < nk) fetch(k0 + kVK);
    const int kn = min(kVK, nk - k0);
    const float* sr = S + (size_t)R * ty * ls + k0;
#pragma unroll 1
    for (int j = 0; j < kn; j += 4) {  // four keys: one float4 of S a row
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = sx_ld4(panel + (j + u) * kSxVS + 4 * tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 p = sx_ld4(sr + (size_t)i * ls + j);
        const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pu[u], v[u].x, acc[i][0]);
          acc[i][1] = fmaf(pu[u], v[u].y, acc[i][1]);
          acc[i][2] = fmaf(pu[u], v[u].z, acc[i][2]);
          acc[i][3] = fmaf(pu[u], v[u].w, acc[i][3]);
        }
      }
    }
  }
}

// The inputs of the projections and where the prep writes.
struct SxProj {
  const float* y;     // (B, Y, Cy)
  const float* ypos;  // (1 or B, Y, Py) or null
  long long ystride;  // its batch stride (0: shared)
  int Py;
  const float* x;     // (B, X, Cx)
  const float* xpos;  // (1 or B, X, Px) or null
  long long xstride;
  int Px;
  const float *wq, *bq, *wk, *bk, *wv, *bv;  // (Cy, d), (d,), (Cx, d), (d,), (Cx, d), (d,)
  const int* xlen;
  int B, Y, X, Cy, Cx, d;
  // workspace (16-byte aligned): lens (2B + 1 ints), yin (B*Y*Cy, with ypos),
  // xin (B*X*2Cx, with xpos), wqp (2*d*Cy), wkvp (2*2*d*Cx), yq (B*Y*d), kv
  // (B*X*2d)
  int* lens;
  float *yin, *xin, *wqp, *wkvp, *yq, *kv;
  // the backward's probs in rows of sx_pad(X) when X % 4 != 0 (else null)
  const float* probs;
  float* probs_p;
};

}  // namespace fk

namespace {

// lens[b] = Y, lens[B + b] = the key length (x_len clipped to X, or X at
// x_len <= 0), lens[2B] = X; yin = y + y_pos on its Py leading channels; xin
// = [x + x_pos | x]; probs_p = probs in rows of sx_pad(X), zero past X.  A
// grid-stride pass of float4s (Cy, Cx, Py, Px multiples of 4).
__global__ void __launch_bounds__(256) sx_prep_kernel(const fk::SxProj p) {
  const long long n = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 < p.B) {
    const int l = p.xlen[t0];
    p.lens[t0] = p.Y;
    p.lens[p.B + t0] = l > 0 ? min(l, p.X) : p.X;
  }
  if (t0 == 0) p.lens[2 * p.B] = p.X;
  if (p.yin != nullptr) {
    const int c4n = p.Cy / 4;
    for (long long i = t0; i < (long long)p.B * p.Y * c4n; i += n) {
      const long long row = i / c4n;
      const int c = (int)(i - row * c4n) * 4;
      const int b = (int)(row / p.Y), t = (int)(row - (long long)b * p.Y);
      float4 v = fk::sx_ldg4(p.y + row * p.Cy + c);
      if (c < p.Py)
        v = fk::sx_add4(v, fk::sx_ldg4(p.ypos + b * p.ystride + (long long)t * p.Py + c));
      fk::sx_st4(p.yin + row * p.Cy + c, v);
    }
  }
  if (p.xin != nullptr) {
    const int c4n = p.Cx / 4;
    for (long long i = t0; i < (long long)p.B * p.X * c4n; i += n) {
      const long long row = i / c4n;
      const int c = (int)(i - row * c4n) * 4;
      const int b = (int)(row / p.X), t = (int)(row - (long long)b * p.X);
      const float4 v = fk::sx_ldg4(p.x + row * p.Cx + c);
      fk::sx_st4(p.xin + row * 2 * p.Cx + p.Cx + c, v);
      fk::sx_st4(p.xin + row * 2 * p.Cx + c,
                 c < p.Px ? fk::sx_add4(v, fk::sx_ldg4(p.xpos + b * p.xstride +
                                                       (long long)t * p.Px + c))
                          : v);
    }
  }
  if (p.probs_p != nullptr) {
    const int xp = fk::sx_pad(p.X);
    for (long long i = t0; i < (long long)p.B * p.Y * xp; i += n) {
      const long long row = i / xp;
      const int k = (int)(i - row * xp);
      p.probs_p[i] = k < p.X ? p.probs[row * p.X + k] : 0.f;
    }
  }
}

// A second stream of the current device and two events (made at first use,
// kept for the process): the key / value projection runs there beside the
// query projection, forked after the prep and joined before the attention.
struct SxSide {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

inline int sx_side(SxSide& side) {
  constexpr int kMaxDevices = 64;
  static SxSide made[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || dev >= kMaxDevices) return err ? err : (int)cudaErrorInvalidDevice;
  if (!ready[dev] &&
      ((err = (int)cudaStreamCreateWithFlags(&made[dev].stream, cudaStreamNonBlocking)) ||
       (err = (int)cudaEventCreateWithFlags(&made[dev].fork, cudaEventDisableTiming)) ||
       (err = (int)cudaEventCreateWithFlags(&made[dev].join, cudaEventDisableTiming))))
    return err;
  ready[dev] = true;
  side = made[dev];
  return 0;
}

// The prep pass: whichever of lens, yin, xin and probs_p the workspace holds.
inline int sx_prep(const fk::SxProj& p, cudaStream_t stream) {
  long long work = p.B;  // the longest of the prep's passes
  auto at_least = [&](bool on, long long n) { work = on && n > work ? n : work; };
  at_least(p.yin != nullptr, (long long)p.B * p.Y * p.Cy / 4);
  at_least(p.xin != nullptr, (long long)p.B * p.X * p.Cx / 4);
  at_least(p.probs_p != nullptr, (long long)p.B * p.Y * fk::sx_pad(p.X));
  const int blocks = (int)((work + 255) / 256 < 1056 ? (work + 255) / 256 : 1056);  // 8 an SM
  sx_prep_kernel<<<blocks, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The key side on the side stream, after what `stream` holds so far: Wk^T,
// Wv^T and kv = [xk | xv] (problem 0: Wk on [x + x_pos] (channels 0..Cx),
// problem 1: Wv on x (Cx..2Cx, or 0..Cx)); side.join marks kv done.
inline int sx_key_side(const fk::SxProj& p, cudaStream_t stream, SxSide& side) {
  int err;
  if ((err = sx_side(side)) || (err = (int)cudaEventRecord(side.fork, stream)) ||
      (err = (int)cudaStreamWaitEvent(side.stream, side.fork, 0)))
    return err;
  const size_t kvz = (size_t)2 * p.d * p.Cx;  // one projection's packed hi / lo parts
  const int two[4] = {0, 0, 0, p.xin ? p.Cx : 0};
  if ((err = fk_k6_pack(p.wk, p.wkvp, p.Cx, p.d, 1, p.Cx, p.Cx, side.stream)) ||
      (err = fk_k6_pack(p.wv, p.wkvp + kvz, p.Cx, p.d, 1, p.Cx, p.Cx, side.stream)) ||
      (err = fk_k6_gemm(fk::kGemmProj32, p.xin ? p.xin : p.x, p.xin ? 2 * p.Cx : p.Cx, 2, 1, two,
                        p.Cx, p.wkvp, p.d, p.Cx, p.B, p.X, p.lens + p.B, p.kv, 2 * p.d, p.d,
                        p.bk, p.bv, nullptr, 0, 0, nullptr, nullptr, nullptr, 0, 0u, 1.f,
                        side.stream)))
    return err;
  return (int)cudaEventRecord(side.join, side.stream);
}

// The prep, the packs and the two projection GEMMs (see the top of this file).
inline int sx_project(const fk::SxProj& p, cudaStream_t stream) {
  SxSide side;
  int err;
  if ((err = sx_prep(p, stream)) || (err = sx_key_side(p, stream, side)) ||
      (err = fk_k6_pack(p.wq, p.wqp, p.Cy, p.d, 1, p.Cy, p.Cy, stream)))
    return err;
  const int one[2] = {0, 0};
  err = fk_k6_gemm(fk::kGemmProj32, p.yin ? p.yin : p.y, p.Cy, 1, 1, one, p.Cy, p.wqp, p.d,
                   p.Cy, p.B, p.Y, p.lens, p.yq, p.d, 0, p.bq, nullptr, nullptr, 0, 0, nullptr,
                   nullptr, nullptr, 0, 0u, 1.f, stream);
  if (err) return err;
  return (int)cudaStreamWaitEvent(stream, side.join, 0);  // kv is ready for what follows
}

// dst (2, Cx, 2d): the TF32 hi and lo parts of [Wk | Wv] (Cx, 2d), as
// fk_k6_pack lays out a weight the GEMM multiplies untransposed: the
// operand of the X side's dx = [dxk | dxv] [Wk | Wv]^T (K = 2d).
__global__ void __launch_bounds__(256) sx_pack_kv_kernel(const float* __restrict__ wk,
                                                         const float* __restrict__ wv, int Cx,
                                                         int d, float* __restrict__ dst) {
  const long long n = (long long)Cx * 2 * d;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (2 * d);
    const int k = (int)(i - r * 2 * d);
    const float w = k < d ? __ldg(wk + r * d + k) : __ldg(wv + r * d + k - d);
    tc::split(w, dst[i], dst[n + i]);
  }
}

}  // namespace
