// K6: the fused MS-TCN++ tower (two dilations per layer), forward (a
// training form and a serving form) and backward, on Hopper's TF32 tensor
// cores at f32 accuracy (3xTF32, csrc/tc_gemm.cuh).
//
// Forward: replaces fact_clip_tpu/ops/pallas/dilated_conv.py::_stack2_layer
// (_stack2_kernel).  Per layer, for the frames of one video,
//   c1 = sum_k x[t + (k-1)d1] @ K1[k] + b1,  c2 = sum_k x[t + (k-1)d2] @ K2[k] + b2
//   h  = relu([c1 | c2] @ Wf + bf)           (Wf = [Wt; Wb], (2C, C))
//   y[t] = (drop(h) + x[t]) for t < len[b], 0 for t >= len[b]
// and, on the tower's last layer, logits[t] = y[t] @ Wo + bo (padded frames
// carry the bias row).  Taps before frame 0 or at or past len[b] read as
// zeros: the tower's input may hold non-zero frames past a video, and the
// A operand's split pass zeroes those rows as it converts the tile.
//   training form: two GEMM launches a layer, (a) [c1 | c2] (both dilations,
//     K = 3C each; written to global, the backward's save) and (b) the fuse
//     over K = 2C with an epilogue for the bias, ReLU, the dropout hash
//     (fk::dropout_bits, stream = layer, index (b*T + t)*C + c: the mask of
//     ops/dropout.py bit for bit), the residual, the write mask and the h save;
//   serving form: one GEMM over K = 6C on the fold W6 = [K1[k] Wt; K2[k] Wb]
//     (ops/dilated_conv.py::mstcn2_fold), bias = b1 Wt + b2 Wb + bf, the same
//     epilogue without dropout or saves;
//   the out projection of the last layer: one more GEMM of the same core
//     (JAX computes it inside _stack2_kernel).
// Backward: replaces _stack2_bwd_layer (_stack2_bwd_dc_kernel,
// _stack2_bwd_dx_kernel), from the saved input stream x, [c1 | c2], h and the
// cotangent g of the layer's output (on the last layer: of the logits):
//   last layer only: g = g_logits @ Wo^T (GEMM, K = O), zero past len[b];
//   k6_ds: ds = g * keep * (h > 0) (the keep mask re-hashed in place), y =
//     (h*keep + x)*valid on the last layer (for dWo), and per-block column
//     sums for dbf (and dob): an elementwise pass, since ds is needed in
//     global memory by the dWf product anyway;
//   [dc1 | dc2] = ds @ Wf^T (GEMM, N = 2C) with per-block column sums for db1, db2;
//   dx[s] = sum_k dc1[s + (1-k)d1] K1[k]^T + dc2[s + (1-k)d2] K2[k]^T + g[s],
//     zero at s >= len[b] (GEMM, K = 6C);
//   the weight gradients dK1, dK2 (x^T dc over three shifted taps each),
//     dWf = [c1|c2]^T ds and dWo = y^T g_logits: k6_wgrad, products over
//     time (K = time): per (128 x 128 tile, 768-frame chunk of one video,
//     tap) partials that grad.cu's fk_reduce sums in a fixed order (no
//     float atomics: the same result on every run).
// The GEMMs run on tc_tower.cuh's kernel (shared with K1; its design and the
// variants tried are written there).
//
// The weight-gradient products (k6_wgrad, which K1, K2 and K3 also launch,
// and K4's SA backward with up to four products of one row space a launch,
// promoted every 8 rows: fk::tc_wgrad_pairs) take both
// operands time-major from TMA and transpose and split them in one
// shared-memory pass into the K-major swizzled layout, into two sets of
// tiles that alternate so that the next step's pass overlaps this step's
// wgmma (a producer warpgroup that transposed B for two consumer
// warpgroups, each transposing its own half of A, took 18.1 ms against
// 16.8 for the Breakfast backward on the H100).
//
// Bound on the H100: the products, 3 TF32 passes at 495 TFLOP/s.  At
// B=4, T=4096, C=512, 10 layers: serving 12 C^2 FMAs a frame and layer,
// 371 GFLOP -> 2.25 ms; training 16 C^2 -> 2.98 ms; backward 32 C^2 ->
// 5.97 ms; bytes (B*T*C*4 per stream pass, ~34 MB) are an order below.
// The design's limits: C and O multiples of 4 (TMA row strides; a tap's K
// segment is padded to whole 32-float steps in the pack); shared memory does
// not depend on C.
#include "tc_tower.cuh"

namespace {

constexpr int WG_STAGE = 2 * TILE;      // raw A, raw B (time-major)
// three raw stages and two sets of split tiles (A hi, A lo, B hi, B lo)
constexpr size_t WGRAD_SMEM = ((size_t)STAGES * WG_STAGE + 8 * TILE) * 4 + 64 + 1024;
constexpr int kMaxPairs = 4;  // products of one weight-product launch
struct WgradArgs {
  CUtensorMap amap;  // (C_a total, T, B), 128 x 32 boxes, plain rows
  CUtensorMap bmap;
  // pair i: dW_i = A[:, a_c0 .. a_c0 + Ca]^T Bm[:, b_c0 .. b_c0 + Cb], over
  // tiles[i] blocks of blockIdx.x (its 128 x 128 tiles), its partials at
  // out_off[i] of each (tap, chunk)'s chunk_floats
  int npair;
  int tiles[kMaxPairs], a_c0[kMaxPairs], Ca[kMaxPairs], b_c0[kMaxPairs], Cb[kMaxPairs];
  long long out_off[kMaxPairs];
  long long chunk_floats;
  int T, Kc, per, n_chunks, shift0, shift_step;
  const int* lengths;
  float* part;
};

// dW[tap][m][n] partial = sum over the chunk's frames t of
// A[b, t + shift, a_c0 + m] * Bm[b, t, b_c0 + n], A's rows outside [0, len)
// and Bm's at or past len zero, for the pair and tile that blockIdx.x picks.
// P8: the products promoted after every 8 frames (as the tower GEMM's kProj),
// else after every 32.
template <bool P8>
__global__ void __launch_bounds__(256, 1) k6_wgrad_kernel(const __grid_constant__ WgradArgs p) {
  extern __shared__ float4 smem_raw[];
  float* sm = tc::align1024<float>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * WG_STAGE + 8 * TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  int pair = 0, tile = blockIdx.x;
  while (pair + 1 < p.npair && tile >= p.tiles[pair]) tile -= p.tiles[pair++];
  const int a_c0 = p.a_c0[pair], b_c0 = p.b_c0[pair], Ca = p.Ca[pair], Cb = p.Cb[pair];
  const int tn = (Cb + BN - 1) / BN;
  const int n0 = (tile % tn) * BN, m0 = (tile / tn) * BM;
  const int tap = blockIdx.z / p.n_chunks;
  const int chunk = blockIdx.z - tap * p.n_chunks;
  const int b = chunk / p.per;
  const int tc0 = (chunk - b * p.per) * p.Kc;
  const int T = p.T;
  const int L = min(p.lengths[b], T);
  const int shift = p.shift0 + tap * p.shift_step;
  // frames t whose product counts: t in [tc0, tc0 + Kc), t < len, 0 <= t + shift < len
  const int lo_t = max(tc0, -shift);
  const int hi_t = min(min(tc0 + p.Kc, L), L - shift);
  const int kstart = hi_t > lo_t ? tc0 + (lo_t - tc0) / tc::kBK * tc::kBK : tc0;
  const int nk = hi_t > lo_t ? (hi_t - kstart + tc::kBK - 1) / tc::kBK : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(&full[s], 1);
    tc::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int kc) {
    const int s = kc % STAGES;
    float* st = sm + s * WG_STAGE;
    const int t = kstart + kc * tc::kBK;
    tc::mbar_expect_tx(&full[s], 2 * TILE * 4);
    tc::tma_load_3d(st, &p.amap, &full[s], a_c0 + m0, t + shift, b);
    tc::tma_load_3d(st + TILE, &p.bmap, &full[s], b_c0 + n0, t, b);
  };
  // transpose (32 frames x 128 channels -> 128 rows of 32 frames, K-major in
  // the 128-byte swizzle) and split both operands of step kc into split set
  // kc % 2; thread item (r, q) takes frames 4q..4q+3 of channel r, so each
  // 16-byte store of 8 neighbouring threads covers the 32 banks once
  auto split_step = [&](int kc) {
    const float* st = sm + (kc % STAGES) * WG_STAGE;
    float* ahi = sm + STAGES * WG_STAGE + (kc & 1) * 4 * TILE;
    tc::mbar_wait(&full[kc % STAGES], (kc / STAGES) & 1);
    const int tb = kstart + kc * tc::kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int item = tid + i * 256;
      const int r = item & (BM - 1);
      const int q = item >> 7;
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * q + u;
        const int t = tb + k;
        const bool ok = t >= lo_t && t < hi_t;
        av[u] = ok ? st[k * BM + r] : 0.f;
        bv[u] = ok ? st[TILE + k * BM + r] : 0.f;
      }
      float4 hi, lo;
      const int o = tc::sw128(r, 4 * q);
      tc::split4(make_float4(av[0], av[1], av[2], av[3]), hi, lo);
      *reinterpret_cast<float4*>(ahi + o) = hi;
      *reinterpret_cast<float4*>(ahi + TILE + o) = lo;
      tc::split4(make_float4(bv[0], bv[1], bv[2], bv[3]), hi, lo);
      *reinterpret_cast<float4*>(ahi + 2 * TILE + o) = hi;
      *reinterpret_cast<float4*>(ahi + 3 * TILE + o) = lo;
    }
    tc::fence_proxy_async();
  };

  float acc[64], big[64], small[64];  // the f32 sum, one K step's two products
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = big[i] = small[i] = 0.f;
  if (tid == 0)
    for (int kc = 0; kc < min(STAGES, nk); ++kc) issue(kc);
  if (nk > 0) split_step(0);
  __syncthreads();
  if (tid == 0 && STAGES < nk) issue(STAGES);  // raw stage 0 is free
  for (int kc = 0; kc < nk; ++kc) {
    const float* set = sm + STAGES * WG_STAGE + (kc & 1) * 4 * TILE;
    const float *ah = set + wg * (TILE / 2), *al = set + TILE + wg * (TILE / 2);
    if (P8) {
#pragma unroll
      for (int k = 0; k < tc::kBK / 8; ++k) {
        tc::wgmma_fence();
        tc::mma3_k8(big, small, ah, al, set + 2 * TILE, set + 3 * TILE, k);
        tc::wgmma_commit();
        if (k == 0 && kc + 1 < nk) split_step(kc + 1);
        tc::wgmma_wait_all();
        tc::promote(acc, big, small);
      }
    } else {
      tc::wgmma_fence();
      tc::mma3_k32(big, small, ah, al, set + 2 * TILE, set + 3 * TILE);
      tc::wgmma_commit();
      if (kc + 1 < nk) split_step(kc + 1);
      tc::wgmma_wait_all();
      tc::promote(acc, big, small);
    }
    __syncthreads();  // split set kc % 2 and raw stage (kc + 1) % STAGES are free
    if (tid == 0 && kc + 1 + STAGES < nk) issue(kc + 1 + STAGES);
  }

  float* out = p.part + ((size_t)tap * p.n_chunks + chunk) * p.chunk_floats + p.out_off[pair];
  const int rw = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + cq;
    if (n >= Cb) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = rw + 8 * h;
      if (m < Ca) store2(out + (size_t)m * Cb + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dst (2, N, Kd): the hi and lo TF32 parts of src (R, S) (N = R, K = S) or
// of its transpose (N = S, K = R), K-major, through a 32 x 32 shared-memory
// tile.  K is a whole number of segments of kseg values; each segment lands
// on kpad >= kseg values of dst's rows (Kd = K / kseg * kpad), the ones past
// kseg zero, so that a GEMM over taps of C channels takes whole 32-float K
// steps at any C.  A block covers 32 x 32 of dst.
__global__ void k6_pack_kernel(const float* __restrict__ src, float* __restrict__ dst, int R,
                               int S, int transpose, int kseg, int kpad) {
  __shared__ float tile[32][33];
  const int N = transpose ? S : R, K = transpose ? R : S;
  const int Kd = K / kseg * kpad;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.y * 32, kd0 = blockIdx.x * 32;
  auto src_k = [&](int kd) {  // the K index that lands on kd, or -1 for padding
    const int seg = kd / kpad, c = kd - seg * kpad;
    return kd < Kd && c < kseg ? seg * kseg + c : -1;
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (transpose) {  // tile[k][n]: src rows are K
      const int k = src_k(kd0 + r), n = n0 + tx;
      tile[r][tx] = (k >= 0 && n < N) ? __ldg(src + (size_t)k * S + n) : 0.f;
    } else {  // tile[n][k]
      const int k = src_k(kd0 + tx), n = n0 + r;
      tile[r][tx] = (k >= 0 && n < N) ? __ldg(src + (size_t)n * S + k) : 0.f;
    }
  }
  __syncthreads();
  const size_t plane = (size_t)N * Kd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 8 * i, kd = kd0 + tx;
    if (n >= N || kd >= Kd) continue;
    float hi, lo;
    tc::split(transpose ? tile[tx][ty + 8 * i] : tile[ty + 8 * i][tx], hi, lo);
    dst[(size_t)n * Kd + kd] = hi;
    dst[plane + (size_t)n * Kd + kd] = lo;
  }
}

// ds = g * keep * (h > 0) on valid frames; on the last layer y = (h * keep +
// x) * valid for dWo; per-block column sums of ds (dbf) and of g_logits (dob).
// A block takes R frames of one video, a thread a column at a time: short
// blocks keep enough loads in flight (64-frame blocks ran at ~1/4 of the
// memory rate on the H100).
__global__ void __launch_bounds__(256) k6_ds_kernel(
    const float* __restrict__ g, const float* __restrict__ h, const float* __restrict__ x,
    const float* __restrict__ glg, const int* __restrict__ lengths, fk::Dropout drop,
    float* __restrict__ ds, float* __restrict__ y_out, float* __restrict__ part,
    float* __restrict__ part_o, int T, int C, int O, int R) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * R;
  const int L = min(lengths[b], T);
  const int rows = min(R, T - t0);
  const int blk = b * gridDim.x + blockIdx.x;
  const uint32_t seed = drop.load_seed();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int t = t0 + r;
      const size_t e = ((size_t)b * T + t) * C + c;
      const bool valid = t < L;
      float keep = 1.f;
      if (drop.seed != nullptr)
        keep = drop.keep(((uint32_t)b * (uint32_t)T + (uint32_t)t) * (uint32_t)C + (uint32_t)c,
                         seed);
      const float hv = __ldg(h + e);
      const float dsv = (valid && hv > 0.f) ? __ldg(g + e) * keep : 0.f;
      ds[e] = dsv;
      s += dsv;
      if (y_out != nullptr) y_out[e] = valid ? hv * keep + __ldg(x + e) : 0.f;
    }
    part[(size_t)blk * C + c] = s;
  }
  if (part_o == nullptr) return;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += __ldg(glg + ((size_t)b * T + t0 + r) * O + o);
    part_o[(size_t)blk * O + o] = s;
  }
}

}  // namespace

// kseg: the values of one K segment (K when the weights are one segment),
// kpad: what each takes in dst (k6_pack_kernel)
extern "C" int fk_k6_pack(const float* src, float* dst, int R, int S, int transpose, int kseg,
                          int kpad, void* stream) {
  const int N = transpose ? S : R, K = transpose ? R : S;
  if (kseg < 1 || K % kseg || kpad < kseg) return (int)cudaErrorInvalidValue;
  dim3 grid((K / kseg * kpad + 31) / 32, (N + 31) / 32);
  k6_pack_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(src, dst, R, S, transpose, kseg,
                                                                  kpad);
  return (int)cudaGetLastError();
}

// One GEMM of the towers' kernel: K6's epilogues kMasked ... kDx, K1's kRelu,
// kResid, kGate, K3's kProj and K2's kProj32 (tc_tower.cuh).  A: (B, T,
// a_ch); W_z's hi and lo parts K-major in wpack (nprob, 2, N, K) (fk_k6_pack,
// each of the nseg segments kseg values); segs: host ints, per problem and
// segment (shift, c0); res at res + b * res_bstride + t * res_ld + n.
extern "C" int fk_k6_gemm(int mode, const float* a, int a_ch, int nprob, int nseg,
                          const int* segs, int kseg, const float* wpack, int N, int K, int B,
                          int T, const int* lengths, float* out, int ldo, int col_step,
                          const float* bias0, const float* bias1, const float* res, int res_ld,
                          long long res_bstride, float* out2, float* part, const int* seed,
                          int layer, unsigned thresh, float scale, void* stream) {
  if (nprob < 1 || nprob > 2 || nseg < 1 || nseg > MAX_SEG || a_ch % 4 || K % 4 || N % 4 ||
      (nseg > 1 && kseg % tc::kBK) || (res != nullptr && res_ld % 4))
    return (int)cudaErrorInvalidValue;
  GemmArgs g;
  memset(&g, 0, sizeof(g));
  if (!tc::encode_3d(&g.amap, a, a_ch, T, B, tc::kBK, BM, true) ||
      !tc::encode_3d(&g.bmap, wpack, K, N, 2 * nprob, tc::kBK, BN, true))
    return (int)cudaErrorInvalidValue;
  for (int z = 0; z < nprob; ++z)
    for (int s = 0; s < nseg; ++s) {
      g.seg_shift[z][s] = segs[(z * nseg + s) * 2];
      g.seg_c0[z][s] = segs[(z * nseg + s) * 2 + 1];
    }
  g.nseg = nseg;
  g.kseg = kseg;
  g.N = N;
  g.T = T;
  g.nprob = nprob;
  g.lengths = lengths;
  g.out = out;
  g.ldo = ldo;
  g.col_step = col_step;
  g.bias[0] = bias0;
  g.bias[1] = bias1;
  g.res = res;
  g.res_ld = res_ld;
  g.res_bstride = res_bstride;
  g.out2 = out2;
  g.part = part;
  g.drop = fk::Dropout{seed, layer, thresh, scale};
  dim3 grid((N + BN - 1) / BN, (T + BM - 1) / BM, B * nprob);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kMasked: return (int)launch_gemm<kMasked>(g, grid, st);
    case kFuse: return (int)launch_gemm<kFuse>(g, grid, st);
    case kFolded: return (int)launch_gemm<kFolded>(g, grid, st);
    case kLogits: return (int)launch_gemm<kLogits>(g, grid, st);
    case kDx: return (int)launch_gemm<kDx>(g, grid, st);
    case kRelu: return (int)launch_gemm<kRelu>(g, grid, st);
    case kResid: return (int)launch_gemm<kResid>(g, grid, st);
    case kGate: return (int)launch_gemm<kGate>(g, grid, st);
    case kProj: return (int)launch_gemm<kProj>(g, grid, st);
    case kProj32: return (int)launch_gemm<kProj32>(g, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

namespace {

// One weight-product launch of w's pairs (w.npair and the pair fields set)
// over A (B, T, a_ch) and Bm (B, T, b_ch) in chunks of Kc frames, promoted
// every 8 frames (p8) or 32.
int launch_wgrad(WgradArgs& w, const float* A, int a_ch, const float* Bm, int b_ch,
                 const int* lengths, int B, int T, int Kc, int n_taps, int shift0,
                 int shift_step, float* part, bool p8, cudaStream_t stream) {
  if (a_ch % 4 || b_ch % 4 || Kc % tc::kBK) return (int)cudaErrorInvalidValue;
  if (!tc::encode_3d(&w.amap, A, a_ch, T, B, BM, tc::kBK, false) ||
      !tc::encode_3d(&w.bmap, Bm, b_ch, T, B, BN, tc::kBK, false))
    return (int)cudaErrorInvalidValue;
  int tiles = 0;
  long long at = 0;
  for (int i = 0; i < w.npair; ++i) {
    if (w.Cb[i] % 2) return (int)cudaErrorInvalidValue;
    w.tiles[i] = (w.Cb[i] + BN - 1) / BN * ((w.Ca[i] + BM - 1) / BM);
    w.out_off[i] = at;
    tiles += w.tiles[i];
    at += (long long)w.Ca[i] * w.Cb[i];
  }
  w.chunk_floats = at;
  w.T = T;
  w.Kc = Kc;
  w.per = (T + Kc - 1) / Kc;
  w.n_chunks = B * w.per;
  w.shift0 = shift0;
  w.shift_step = shift_step;
  w.lengths = lengths;
  w.part = part;
  const void* kernel =
      p8 ? (const void*)k6_wgrad_kernel<true> : (const void*)k6_wgrad_kernel<false>;
  cudaError_t err = fk::set_smem(kernel, WGRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, 1, w.n_chunks * n_taps);
  if (p8)
    k6_wgrad_kernel<true><<<grid, 256, WGRAD_SMEM, stream>>>(w);
  else
    k6_wgrad_kernel<false><<<grid, 256, WGRAD_SMEM, stream>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

// part (n_taps, B * ceil(T / Kc), Ca, Cb): per tap and chunk, sum over the
// chunk's frames t of A[b, t + shift0 + tap*shift_step, a_c0 + m] *
// Bm[b, t, b_c0 + n]; A (B, T, a_ch), Bm (B, T, b_ch)
extern "C" int fk_k6_wgrad(const float* A, int a_ch, int a_c0, int Ca, const float* Bm, int b_ch,
                           int b_c0, int Cb, const int* lengths, int shift0, int shift_step,
                           int n_taps, float* part, int B, int T, int Kc, void* stream) {
  WgradArgs w;
  memset(&w, 0, sizeof(w));
  w.npair = 1;
  w.a_c0[0] = a_c0;
  w.Ca[0] = Ca;
  w.b_c0[0] = b_c0;
  w.Cb[0] = Cb;
  return launch_wgrad(w, A, a_ch, Bm, b_ch, lengths, B, T, Kc, n_taps, shift0, shift_step, part,
                      false, (cudaStream_t)stream);
}

namespace fk {

// K4's SA backward (sa_layer.cu) on this file's kernels, over the R rows of
// one row space (lens[0] = R, in device memory):
// tc_rows_gemm: out[r * ldo + z * col_step + n] = sum_{k < K} A[r, c0[z] + k]
//   W_z[k][n] + bias[z][n] for each problem z < nprob <= MAX_PROB (wpack
//   (nprob, 2, N, K) as fk_k6_pack lays it out, K a multiple of 32; a K
//   split into slices is a problem a slice), kProj's epilogue: promoted every
//   8 deep (against float64 the SA backward's weight gradients came out
//   -1.1e-7 to -2.1e-7 coherently small so, -2.9e-7 to -5.2e-7 promoted once
//   a 32-deep step, for 0.012 ms more a call at the flagship's shape; H100
//   80GB HBM3, 700 W, chip_dev.py sa-f64)
int tc_rows_gemm(const float* a, int a_ch, int nprob, const int* c0, int K, const float* wpack,
                 int N, int R, const int* lens, float* out, int ldo, int col_step,
                 const float* const* bias, cudaStream_t stream) {
  if (nprob < 1 || nprob > MAX_PROB || a_ch % 4 || K % tc::kBK || N % 4)
    return (int)cudaErrorInvalidValue;
  GemmArgs g;
  memset(&g, 0, sizeof(g));
  if (!tc::encode_3d(&g.amap, a, a_ch, R, 1, tc::kBK, BM, true) ||
      !tc::encode_3d(&g.bmap, wpack, K, N, 2 * nprob, tc::kBK, BN, true))
    return (int)cudaErrorInvalidValue;
  for (int z = 0; z < nprob; ++z) {
    g.seg_c0[z][0] = c0[z];
    g.bias[z] = bias != nullptr ? bias[z] : nullptr;
  }
  g.nseg = 1;
  g.kseg = K;
  g.N = N;
  g.T = R;
  g.nprob = nprob;
  g.lengths = lens;
  g.out = out;
  g.ldo = ldo;
  g.col_step = col_step;
  return (int)launch_gemm<kProj>(g, dim3((N + BN - 1) / BN, (R + BM - 1) / BM, nprob), stream);
}

// tc_wgrad_pairs: one launch of npair <= 4 weight products over the same
// rows, pair i = pairs[4i .. 4i + 3] = (a_c0, Ca, b_c0, Cb):
//   part[chunk][off_i + m Cb + n] = sum over the chunk's rows r of
//   A[r, a_c0 + m] Bm[r, b_c0 + n]
// with off_i the sum of Ca Cb over the pairs before i: a chunk's partials are
// the products side by side, ceil(R / Kc) chunks of Kc rows; promoted every
// 8 rows, as tc_rows_gemm's products.
int tc_wgrad_pairs(const float* A, int a_ch, const float* Bm, int b_ch, int npair,
                   const int* pairs, const int* lens, int R, int Kc, float* part,
                   cudaStream_t stream) {
  if (npair < 1 || npair > kMaxPairs) return (int)cudaErrorInvalidValue;
  WgradArgs w;
  memset(&w, 0, sizeof(w));
  w.npair = npair;
  for (int i = 0; i < npair; ++i) {
    w.a_c0[i] = pairs[4 * i];
    w.Ca[i] = pairs[4 * i + 1];
    w.b_c0[i] = pairs[4 * i + 2];
    w.Cb[i] = pairs[4 * i + 3];
  }
  return launch_wgrad(w, A, a_ch, Bm, b_ch, lens, 1, R, Kc, 1, 0, 0, part, true, stream);
}

}  // namespace fk

extern "C" int fk_k6_ds(const float* g, const float* h, const float* x, const float* glg,
                        const int* lengths, const int* seed, int layer, unsigned thresh,
                        float scale, float* ds, float* y_out, float* part, float* part_o, int B,
                        int T, int C, int O, int R, void* stream) {
  dim3 grid((T + R - 1) / R, B);
  k6_ds_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(g, h, x, glg, lengths,
                                                       fk::Dropout{seed, layer, thresh, scale},
                                                       ds, y_out, part, part_o, T, C, O, R);
  return (int)cudaGetLastError();
}
