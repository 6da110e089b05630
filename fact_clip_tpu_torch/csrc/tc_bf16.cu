// The bf16 GEMM of the mixed-precision forms (TPU.compute_dtype: bfloat16;
// ops/bf16.py): K1's bf16 tower (ops/dilated_conv.py::mstcn_stack16, which
// replaces fact_clip_tpu/ops/pallas/dilated_conv.py::_stack_layer under
// mixed precision: its conv3, its 1x1 with the residual and write mask, and
// the out projection of the last layer), K6's bf16 tower
// (mstcn2_stack16, which replaces _stack2_layer: the two dilated conv3s
// into the halves of one [c1 | c2] buffer, the fuse with its ReLU, residual
// and write mask, the logits; and the dx product of its backward, the six
// taps of [dc1 | dc2]), and the key / value / query projections of K2's and
// K3's bf16 forms (x2y_attn.py::_x2y_small_x_fwd_impl and
// _x2y_flash_fwd_impl's projections, mha_attn.py::_mha_fwd_impl's).
//
//   out[b, t, col_off + n] = epilogue(sum over segments s, channels c < kseg
//       of A[b, t + shift[s], c0[s] + c] * W[n][s*kseg + c])
//
// A (B, T, C) and W (N, Kd) are bf16; the products are exact in the f32
// accumulators of `wgmma.mma_async ... m64n128k16.f32.bf16.bf16`, one pass
// (no split, against the f32 towers' three TF32 passes, tc_gemm.cuh), and
// each 64-deep stage's sum is added into an f32 sum of the thread's own
// (the tensor cores add into their accumulator rounding toward zero:
// tc_gemm.cuh).  JAX's rounding points are the epilogues' (Mode):
//   kRelu    bf16(relu(acc + bias))             K1's conv (the h stream)
//   kResid   bf16((acc + bias) + res)           K1's 1x1, the residual res bf16
//   kLogits  acc + bias, f32, every frame       the tower's logits
//   kProj    acc + bias, f32                    K2 flash's [xk | xv]
//   kProjRnd f32(bf16(acc)) + bias, f32         K2 small-X's yq-side keys: XLA's
//                                               bf16 product outside the kernel
//   kProj16  bf16(acc + bias)                   K3's k and v, K6's c1 and c2
//   kFuse    bf16((relu(acc + bias) + res)),    K6's fuse (the residual res bf16;
//            out2 bf16(relu(acc + bias)))       out2, where given, the training
//                                               form's saved ReLU output)
// with 0 at frames at or past len[b] (kLogits: the bias row there).  Rows
// of A outside [0, len[b]) read as zeros: TMA fills zeros outside [0, T),
// and a consumer warpgroup zeroes its rows in [len, T) in shared memory
// before its wgmma where a tile reaches past the video (the tower's input,
// the in map's output, is not zero there).
//
// 128 x 128 output tiles; K in 64-value (128-byte) stages through a ring of
// four, each filled by TMA (3-D maps (C, T, B) for A, so a tap past either
// end of the frames reads zeros and never the next video's rows; (Kd, N, 1)
// for W), the 128-byte swizzle, 8-row atoms of 1,024 bytes; a producer warp
// and two consumer warpgroups of 64 rows.  Bound on the H100: at the
// flagship's K1 (B=8, T=3072, C=256) a layer's two GEMMs are 2.6 GFLOP of
// bf16 (2.6 us at 989 TFLOP/s) against 25 MB of stream traffic (7.5 us at
// 3.35 TB/s): bytes.  At Breakfast's K6 (B=4, T=4096, C=512) a layer's
// three GEMMs are 16 C^2 FLOP a frame, 69 GFLOP (69 us at 989 TFLOP/s),
// against 7 KB a frame of stream, [c1 | c2] and output traffic, 117 MB
// (35 us): operations.  A simple form: no persistence, no cluster, no
// multicast; making it fast is later work.
#include <cuda.h>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int BM = 128;                       // output rows per block (two warpgroups)
constexpr int BN = 128;                       // output columns per block
constexpr int BK = 64;                        // bf16 K values of a stage (128 bytes)
constexpr int STAGES = 4;
constexpr int TILE_BYTES = BM * BK * 2;       // one 128 x 64 bf16 tile (16 KB)
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // A, W
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 64 + 1024;
constexpr int MAX_SEG = 6;  // K6's dx: three taps of dc1, three of dc2
constexpr int THREADS = 384;  // a producer warpgroup, two consumer warpgroups

enum Mode { kRelu = 0, kResid = 1, kLogits = 2, kProj = 3, kProjRnd = 4, kProj16 = 5, kFuse = 6 };

struct Args {
  CUtensorMap amap;  // A (C, T, B), 64 x 128 boxes, 128-byte swizzle
  CUtensorMap bmap;  // W (Kd, N, 1), 64 x 128 boxes, 128-byte swizzle
  int shift[MAX_SEG];
  int c0[MAX_SEG];       // each segment's first channel of A
  int nseg, kseg, N, T;
  const int* lengths;
  void* out;
  int ldo, col_off;
  const float* bias;     // (N,) or null
  const fk::bf16* res;   // kResid, kFuse: (B, T, N)
  fk::bf16* out2;        // kFuse: (B, T, N) or null
};

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void store_bf16x2(fk::bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 load_bf16x2(const fk::bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) b16_gemm_kernel(const __grid_constant__ Args p) {
  extern __shared__ float4 smem_raw[];
  uint8_t* sm = tc::align1024<uint8_t>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int T = p.T;
  const int L = min(p.lengths[b], T);
  const int cps = (p.kseg + BK - 1) / BK;  // stages per segment
  const int nk = t0 < L ? p.nseg * cps : 0;  // a tile past the video: no GEMM
  const int wg = (warp >> 2) - 1;            // the consumer warpgroup, -1 for the producer
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    tc::fence_barrier_init();
  }
  __syncthreads();
  if (wg < 0) {
    tc::setmaxnreg_dec<40>();
    if (tid == 0)
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % STAGES;
        if (kc >= STAGES) tc::mbar_wait(&empty[s], (kc / STAGES - 1) & 1);
        const int seg = kc / cps;
        const int c = (kc - seg * cps) * BK;
        uint8_t* st = sm + s * STAGE_BYTES;
        tc::mbar_expect_tx(&full[s], STAGE_BYTES);
        tc::tma_load_3d(st, &p.amap, &full[s], p.c0[seg] + c, t0 + p.shift[seg], b);
        tc::tma_load_3d(st + TILE_BYTES, &p.bmap, &full[s], seg * p.kseg + c, n0, 0);
      }
    return;
  }
  tc::setmaxnreg_inc<232>();
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % STAGES;
    uint8_t* st = sm + s * STAGE_BYTES;
    tc::mbar_wait(&full[s], (kc / STAGES) & 1);
    uint8_t* a = st + wg * (TILE_BYTES / 2);  // this warpgroup's 64 rows of A
    const int r0 = t0 + wg * 64 + p.shift[kc / cps];
    if (r0 + 64 > L) {  // rows at or past the video's length: zero (128 bytes a row)
      for (int q = tid & 127; q < 64 * 8; q += 128)
        if (r0 + (q >> 3) >= L) reinterpret_cast<uint4*>(a)[q] = make_uint4(0u, 0u, 0u, 0u);
      tc::fence_proxy_async();
      tc::bar_sync(1 + wg, 128);
    }
    const uint64_t da = tc::desc_sw128(a), db = tc::desc_sw128(st + TILE_BYTES);
    tc::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) wgmma_bf16_n128(part, da + 2 * k, db + 2 * k, k > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (lane == 0) tc::mbar_arrive(&empty[s]);
  }

  // epilogue: register 4j + 2h + e holds row rw + 8h, column n0 + 8j + cq + e
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int N = p.N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + cq;
    if (n >= N) continue;  // N is a multiple of 8: n + 1 < N too
    const float2 bv = p.bias != nullptr ? __ldg(reinterpret_cast<const float2*>(p.bias + n))
                                        : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + rw + 8 * h;
      if (t >= T) continue;
      const bool valid = t < L;
      const size_t row = (size_t)b * T + t;
      const float v0 = acc[4 * j + 2 * h] + bv.x, v1 = acc[4 * j + 2 * h + 1] + bv.y;
      if (MODE == kFuse) {
        float h0 = 0.f, h1 = 0.f, y0 = 0.f, y1 = 0.f;
        if (valid) {
          h0 = fmaxf(v0, 0.f);
          h1 = fmaxf(v1, 0.f);
          const float2 r = load_bf16x2(p.res + row * N + n);
          y0 = h0 + r.x;
          y1 = h1 + r.y;
        }
        store_bf16x2(static_cast<fk::bf16*>(p.out) + row * p.ldo + p.col_off + n, y0, y1);
        if (p.out2 != nullptr) store_bf16x2(p.out2 + row * N + n, h0, h1);
      } else if (MODE == kRelu || MODE == kResid || MODE == kProj16) {
        float y0 = 0.f, y1 = 0.f;
        if (valid) {
          if (MODE == kRelu) {
            y0 = fmaxf(v0, 0.f);
            y1 = fmaxf(v1, 0.f);
          } else if (MODE == kResid) {
            const float2 r = load_bf16x2(p.res + row * N + n);
            y0 = v0 + r.x;
            y1 = v1 + r.y;
          } else {
            y0 = v0;
            y1 = v1;
          }
        }
        store_bf16x2(static_cast<fk::bf16*>(p.out) + row * p.ldo + p.col_off + n, y0, y1);
      } else {
        float y0 = v0, y1 = v1;
        if (MODE == kProjRnd) {
          y0 = fk::bf16_round(acc[4 * j + 2 * h]) + bv.x;
          y1 = fk::bf16_round(acc[4 * j + 2 * h + 1]) + bv.y;
        }
        if (MODE != kLogits && !valid) y0 = y1 = 0.f;
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + row * p.ldo + p.col_off + n) =
            make_float2(y0, y1);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  cudaError_t err = fk::set_smem((const void*)b16_gemm_kernel<MODE>, SMEM);
  if (err != cudaSuccess) return err;
  b16_gemm_kernel<MODE><<<grid, THREADS, SMEM, stream>>>(a);
  return cudaGetLastError();
}

// out = bf16(x + pos) on the leading P channels, x elsewhere (two channels a
// thread; C and P even)
__global__ void __launch_bounds__(256)
    b16_add_pos_kernel(const fk::bf16* __restrict__ x, const fk::bf16* __restrict__ pos,
                       long long pstride, int P, int N, int C, fk::bf16* __restrict__ out,
                       size_t pairs) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 2 * i;
    const int c = (int)(e % C);
    const size_t bt = e / C;
    float2 v = load_bf16x2(x + e);
    if (c < P) {
      const size_t bi = bt / N, t = bt - bi * N;
      const float2 q = load_bf16x2(pos + bi * pstride + t * P + c);
      v = make_float2(v.x + q.x, v.y + q.y);
    }
    store_bf16x2(out + e, v.x, v.y);
  }
}

// ---------------------------------------------------------------------------
// the weight products of the bf16 backward forms
//
// dW[tap][m][n] partial = sum over the chunk's frames t of A[b, t + shift,
// a_c0 + m] * Bm[b, t, b_c0 + n], A's rows outside [0, len) and Bm's at or
// past len zero.  Both operands arrive time-major (a frame's channels
// contiguous) by TMA, 64 frames x 128 channels a stage, and every thread
// transposes its share into the K-major 128-byte-swizzled tiles that the
// wgmma above reads (8 frames of one channel a 16-byte store), into two sets
// of tiles that alternate so that the next stage's transposition overlaps
// this stage's products (mstcn2.cu's k6_wgrad_kernel does the same for the
// TF32 towers).  Each 64-deep stage's product is added into an f32 sum of
// the thread's own, as the GEMM above does.
constexpr int WG_BK = 64;                          // frames a stage
constexpr int WG_STAGES = 3;
constexpr int WG_RAW = 128 * WG_BK * 2;            // one operand's raw stage (16 KB)
constexpr int WG_TILE = 128 * WG_BK * 2;           // one K-major tile (16 KB)
constexpr size_t WG_SMEM = (size_t)WG_STAGES * 2 * WG_RAW + 4 * WG_TILE + 64 + 1024;

struct WgradArgs {
  CUtensorMap amap;  // A (a_ch, T, B), 128 x 64 boxes, no swizzle
  CUtensorMap bmap;  // Bm (b_ch, T, B)
  int a_c0, Ca, b_c0, Cb;
  int T, Kc, per, n_chunks, shift0, shift_step;
  const int* lengths;
  float* part;
};

__global__ void __launch_bounds__(256, 1) b16_wgrad_kernel(const __grid_constant__ WgradArgs p) {
  extern __shared__ float4 smem_raw[];
  uint8_t* sm = tc::align1024<uint8_t>(smem_raw);
  uint8_t* split = sm + WG_STAGES * 2 * WG_RAW;
  uint64_t* full = reinterpret_cast<uint64_t*>(split + 4 * WG_TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int tn = (p.Cb + 127) / 128;
  const int n0 = (blockIdx.x % tn) * 128, m0 = (blockIdx.x / tn) * 128;
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
  const int kstart = hi_t > lo_t ? tc0 + (lo_t - tc0) / WG_BK * WG_BK : tc0;
  const int nk = hi_t > lo_t ? (hi_t - kstart + WG_BK - 1) / WG_BK : 0;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) tc::mbar_init(&full[s], 1);
    tc::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int kc) {
    const int s = kc % WG_STAGES;
    uint8_t* st = sm + s * 2 * WG_RAW;
    const int t = kstart + kc * WG_BK;
    tc::mbar_expect_tx(&full[s], 2 * WG_RAW);
    tc::tma_load_3d(st, &p.amap, &full[s], p.a_c0 + m0, t + shift, b);
    tc::tma_load_3d(st + WG_RAW, &p.bmap, &full[s], p.b_c0 + n0, t, b);
  };
  // item (r, q): frames 8q .. 8q + 7 of channel r, one 16-byte store into
  // the swizzled row r (chunk q), for A and for B
  auto split_step = [&](int kc) {
    const fk::bf16* st = reinterpret_cast<const fk::bf16*>(sm + (kc % WG_STAGES) * 2 * WG_RAW);
    uint8_t* set = split + (kc & 1) * 2 * WG_TILE;
    tc::mbar_wait(&full[kc % WG_STAGES], (kc / WG_STAGES) & 1);
    const int tb = kstart + kc * WG_BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int item = tid + i * 256;
      const int r = item & 127;
      const int q = item >> 7;
      uint32_t av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t pa = 0u, pb = 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * q + 2 * u + e;
          const int t = tb + k;
          const bool ok = t >= lo_t && t < hi_t;
          const uint32_t xa = ok ? reinterpret_cast<const uint16_t*>(st)[k * 128 + r] : 0u;
          const uint32_t xb =
              ok ? reinterpret_cast<const uint16_t*>(st + 128 * WG_BK)[k * 128 + r] : 0u;
          pa |= xa << (16 * e);
          pb |= xb << (16 * e);
        }
        av[u] = pa;
        bv[u] = pb;
      }
      const int o = tc::sw128(r, 4 * q) * 4;  // bytes
      *reinterpret_cast<uint4*>(set + o) = make_uint4(av[0], av[1], av[2], av[3]);
      *reinterpret_cast<uint4*>(set + WG_TILE + o) = make_uint4(bv[0], bv[1], bv[2], bv[3]);
    }
    tc::fence_proxy_async();
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  if (tid == 0)
    for (int kc = 0; kc < min(WG_STAGES, nk); ++kc) issue(kc);
  if (nk > 0) split_step(0);
  __syncthreads();
  if (tid == 0 && WG_STAGES < nk) issue(WG_STAGES);  // raw stage 0 is free
  for (int kc = 0; kc < nk; ++kc) {
    uint8_t* set = split + (kc & 1) * 2 * WG_TILE;
    const uint64_t da = tc::desc_sw128(set + wg * (WG_TILE / 2)), db = tc::desc_sw128(set + WG_TILE);
    tc::wgmma_fence();
#pragma unroll
    for (int k = 0; k < WG_BK / 16; ++k) wgmma_bf16_n128(part, da + 2 * k, db + 2 * k, k > 0);
    tc::wgmma_commit();
    if (kc + 1 < nk) split_step(kc + 1);
    tc::wgmma_wait_all();
    tc::fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    __syncthreads();  // split set kc % 2 and raw stage (kc + 1) % STAGES are free
    if (tid == 0 && kc + 1 + WG_STAGES < nk) issue(kc + 1 + WG_STAGES);
  }

  float* out = p.part + ((size_t)tap * p.n_chunks + chunk) * p.Ca * p.Cb;
  const int rw = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + cq;
    if (n >= p.Cb) continue;  // Cb even: n + 1 < Cb too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = rw + 8 * h;
      if (m >= p.Ca) continue;
      *reinterpret_cast<float2*>(out + (size_t)m * p.Cb + n) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out[b, t, c] = bf16(v) and part[blk][c] = the sum over the block's rows, in
// row order, of v = in[b, t, c] (f32, or bf16 where in16) * (gate[b, t, c] >
// 0 where a gate is given), 0 at t >= len[b]; a block is R frames of one
// video (blk = b * ceil(T / R) + t / R), a thread a column at a time
__global__ void __launch_bounds__(256)
    b16_round_kernel(const void* __restrict__ in, int in16, const fk::bf16* __restrict__ gate,
                     const int* __restrict__ lengths, int T, int C, int R,
                     fk::bf16* __restrict__ out, float* __restrict__ part) {
  const int b = blockIdx.y, t0 = blockIdx.x * R;
  const int L = min(lengths[b], T);
  const int rows = min(R, T - t0);
  const size_t base = ((size_t)b * T + t0) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t e = base + (size_t)r * C + c;
      float v = 0.f;
      if (t0 + r < L) {
        v = in16 ? __bfloat162float(static_cast<const fk::bf16*>(in)[e])
                 : static_cast<const float*>(in)[e];
        if (gate != nullptr && !(__bfloat162float(gate[e]) > 0.f)) v = 0.f;
      }
      s += v;
      if (out != nullptr) out[e] = __float2bfloat16_rn(v);
    }
    if (part != nullptr) part[((size_t)b * gridDim.x + blockIdx.x) * C + c] = s;
  }
}

}  // namespace

// part (n_taps, B * ceil(T / Kc), Ca, Cb): per tap and chunk of Kc frames of
// one video, sum over the chunk's frames t of A[b, t + shift0 + tap *
// shift_step, a_c0 + m] * Bm[b, t, b_c0 + n], rows outside [0, lengths[b])
// zero; A (B, T, a_ch) and Bm (B, T, b_ch) bf16 (fk_k6_wgrad's interface)
extern "C" int fk_b16_wgrad(const void* A, int a_ch, int a_c0, int Ca, const void* Bm, int b_ch,
                            int b_c0, int Cb, const int* lengths, int shift0, int shift_step,
                            int n_taps, float* part, int B, int T, int Kc, void* stream) {
  if (a_ch % 8 || b_ch % 8 || Kc % WG_BK || Kc < WG_BK || Cb % 2 || n_taps < 1 || Ca < 1 ||
      Cb < 1)
    return (int)cudaErrorInvalidValue;
  WgradArgs w{};
  if (!tc::encode_3d(&w.amap, A, a_ch, T, B, 128, WG_BK, false, true) ||
      !tc::encode_3d(&w.bmap, Bm, b_ch, T, B, 128, WG_BK, false, true))
    return (int)cudaErrorInvalidValue;
  w.a_c0 = a_c0;
  w.Ca = Ca;
  w.b_c0 = b_c0;
  w.Cb = Cb;
  w.T = T;
  w.Kc = Kc;
  w.per = (T + Kc - 1) / Kc;
  w.n_chunks = B * w.per;
  w.shift0 = shift0;
  w.shift_step = shift_step;
  w.lengths = lengths;
  w.part = part;
  cudaError_t err = fk::set_smem((const void*)b16_wgrad_kernel, WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((Ca + 127) / 128) * ((Cb + 127) / 128), 1, w.n_chunks * n_taps);
  b16_wgrad_kernel<<<grid, 256, WG_SMEM, (cudaStream_t)stream>>>(w);
  return (int)cudaGetLastError();
}

// out (B, T, C) bf16 (or null) = bf16(in * (gate > 0)) with 0 at t >= len[b],
// and part (B * ceil(T / R), C) f32 (or null) the column sums of those f32
// values over each block of R frames (b16_round_kernel); in f32 or, where
// in16, bf16; gate (B, T, C) bf16 or null
extern "C" int fk_b16_round(const void* in, int in16, const void* gate, const int* lengths,
                            int B, int T, int C, int R, void* out, float* part, void* stream) {
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1) return 0;
  b16_round_kernel<<<dim3((T + R - 1) / R, B), 256, 0, (cudaStream_t)stream>>>(
      in, in16, static_cast<const fk::bf16*>(gate), lengths, T, C, R,
      static_cast<fk::bf16*>(out), part);
  return (int)cudaGetLastError();
}

// One launch of the bf16 GEMM (see the top of this file): A (B, T, a_ch)
// bf16 with nseg segments at time shifts `shifts` and first channels `c0s`
// (host arrays; c0s null: every segment from channel 0), W (N, Kd) bf16
// K-major, each segment kseg wide (a multiple of 64 where there are
// several), out at out + (b * T + t) * ldo + col_off + n (bf16 for kRelu,
// kResid, kProj16 and kFuse, f32 otherwise), bias (N,) f32 or null, res (B,
// T, N) bf16 (kResid, kFuse), out2 (B, T, N) bf16 or null (kFuse).
extern "C" int fk_b16_gemm(int mode, const void* a, int a_ch, int nseg, const int* shifts,
                           const int* c0s, int kseg, const void* w, int N, int Kd, int B, int T,
                           const int* lengths, void* out, int ldo, int col_off,
                           const float* bias, const void* res, void* out2, void* stream) {
  if (nseg < 1 || nseg > MAX_SEG || a_ch % 8 || Kd % 8 || N % 8 || kseg < 1 ||
      nseg * kseg > Kd || (nseg > 1 && kseg % BK) ||
      ((mode == kResid || mode == kFuse) && res == nullptr) || mode < kRelu || mode > kFuse)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nseg; ++s)
    if (c0s != nullptr && (c0s[s] < 0 || c0s[s] % 8 || c0s[s] >= a_ch))
      return (int)cudaErrorInvalidValue;
  Args g{};
  if (!tc::encode_3d(&g.amap, a, a_ch, T, B, BK, BM, true, true) ||
      !tc::encode_3d(&g.bmap, w, Kd, N, 1, BK, BN, true, true))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nseg; ++s) {
    g.shift[s] = shifts[s];
    g.c0[s] = c0s != nullptr ? c0s[s] : 0;
  }
  g.nseg = nseg;
  g.kseg = kseg;
  g.N = N;
  g.T = T;
  g.lengths = lengths;
  g.out = out;
  g.ldo = ldo;
  g.col_off = col_off;
  g.bias = bias;
  g.res = static_cast<const fk::bf16*>(res);
  g.out2 = static_cast<fk::bf16*>(out2);
  const dim3 grid((N + BN - 1) / BN, (T + BM - 1) / BM, B);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kRelu: return (int)launch<kRelu>(g, grid, st);
    case kResid: return (int)launch<kResid>(g, grid, st);
    case kLogits: return (int)launch<kLogits>(g, grid, st);
    case kProj: return (int)launch<kProj>(g, grid, st);
    case kProjRnd: return (int)launch<kProjRnd>(g, grid, st);
    case kProj16: return (int)launch<kProj16>(g, grid, st);
    default: return (int)launch<kFuse>(g, grid, st);
  }
}

// bf16(x + pos) of the mixed-precision forms' positional terms: x (B, N, C)
// bf16, pos (1 or B, N, P) bf16 at pos + b * pos_bstride + t * P + c (P <= C,
// both even) -> out (B, N, C) bf16.
extern "C" int fk_b16_add_pos(const void* x, const void* pos, long long pos_bstride, int P,
                              int B, int N, int C, void* out, void* stream) {
  if (C % 2 || P % 2 || P > C) return (int)cudaErrorInvalidValue;
  const size_t pairs = (size_t)B * N * C / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  b16_add_pos_kernel<<<blocks > 0 ? blocks : 1, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const fk::bf16*>(x), static_cast<const fk::bf16*>(pos), pos_bstride, P, N, C,
      static_cast<fk::bf16*>(out), pairs);
  return (int)cudaGetLastError();
}
