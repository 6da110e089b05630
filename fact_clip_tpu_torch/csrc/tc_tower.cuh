// The towers' GEMM on the TF32 tensor cores at f32 accuracy (3xTF32,
// tc_gemm.cuh): one kernel, templated on its epilogue, that K6 (the MS-TCN++
// tower), K1 (the MSTCN tower, ops/dilated_conv.py) and K3 (the SCA
// cross-attention's K / V projection and its dx, ops/mha_attn.py) all launch
// through one entry, mstcn2.cu's fk_k6_gemm (K4's SA backward through
// fk::tc_rows_gemm, which takes more problems a launch).
//
//   out[b, t, z*col_step + n] = epilogue(sum over segments s, channels c < kseg
//       of A[b, t + shift[z][s], c0[z][s] + c] * W_z[s*kseg + c][n])
//
// A segment is a (time shift, first channel) pair: a dilated conv3 is three
// segments at shifts -d, 0, +d, K6's serving form six.  Taps before frame 0
// or at or past len[b] read as zeros: the tower's input may hold non-zero
// frames past a video, and the A operand's split pass zeroes those rows as
// it converts the tile.  Tiles wholly past a video skip their GEMMs and
// write zeros (and the logits' bias row).
//
// 128-row x 128-column output tiles, two consumer warpgroups of 64 rows, K
// in 32-float steps through a ring of three stages filled by TMA (3-D maps
// (C, T, B) for the activations, so a tap past either end of a video's
// frames reads zeros and never the next video's rows; (K, N, 2 x problems)
// for the weights' TF32 hi and lo parts, which fk_k6_pack splits and lays
// out K-major, transposed where needed, once a call in global memory).  A
// producer warpgroup keeps the ring full; each of two consumer warpgroups
// splits its 64 rows of the activation tile in shared memory after it lands
// (hi in place, lo beside it, the rows outside [0, len) zeroed),
// multiplies, and releases the stage, so that one consumer's split and sums
// overlap the other's wgmma.  The SS form keeps all three passes reading
// descriptors.  Tried on the card (H100 80GB HBM3, 700 W, Breakfast serving
// form, one call each): the weights split in shared memory by every block
// instead (less L2 traffic, more shared-memory traffic) took 5.19 ms against
// 4.75; A from registers (the RS form, its fragments split there) 6.48 ms,
// its loads in the way of the wgmma issue; one 256-thread loop (split the
// next step while the tensor cores run this one, then a block-wide barrier)
// 4.87 ms against this design's 4.18.  Every 32-deep step's product lands in
// a fresh accumulator that rounded f32 adds sum (tc::promote), the cross
// terms in an accumulator of their own.
//
// Epilogues (Mode), t < len[b] "valid", every row t < T written:
//   K6  kMasked  valid ? acc + bias : 0, optional per-block column sums
//       kFuse    relu(acc + bias) -> drop -> + res, the h save
//       kFolded  relu(acc + bias) + res
//       kLogits  acc + bias on every frame (padded frames carry the bias row)
//       kDx      acc + res
//   K1  kRelu    relu(acc + bias) (the conv's h)
//       kResid   (acc + bias) * keep + res (the 1x1, dropout, residual)
//       kGate    acc where res > 0 (dc gated by the ReLU), column sums
//   K3  kProj    acc + bias + res on the columns n < res_ld of problem 0 (the
//                key's positional term pos @ Wk, res_bstride 0 when the batch
//                shares it; K2's flash forward: [xk | xv] as two problems;
//                K4's SA backward: its products over one row space, up to
//                twelve problems, mstcn2.cu's fk::tc_rows_gemm)
//   K2  kProj32  kProj's epilogue, promoted once a 32-deep step as the
//                towers are (K2's small-X yq and [xk | xv], the latter as two
//                problems side by side)
// and zero past the video where the mode masks.  The residual-like operand
// res sits at res + b * res_bstride + t * res_ld + n.  The dropout keep is
// fk::dropout_bits (stream = layer, index (b*T + t)*N + n): the mask of
// ops/dropout.py bit for bit.
//
// The design's limits: C and O multiples of 4 (TMA row strides).  A tap's
// K segment is whole 32-float steps: fk_k6_pack pads each segment of the
// weights with zero rows up to a multiple of 32, and a step that reads past a
// segment's C channels multiplies the next segment's channels (or TMA's zero
// fill past the tensor) by those zeros.  Shared memory does not depend on C.
#pragma once

#include <cuda.h>
#include <string.h>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int BM = 128;                 // output rows per block (two warpgroups)
constexpr int BN = 128;                 // output columns per block
constexpr int STAGES = 3;
constexpr int TILE = BM * tc::kBK;      // floats of one 128 x 32 tile (16 KB)
constexpr int GEMM_STAGE = 4 * TILE;    // A (hi), A lo, W (hi), W lo
constexpr size_t GEMM_SMEM = (size_t)STAGES * GEMM_STAGE * 4 + 64 + 1024;
constexpr int MAX_SEG = 6;
constexpr int MAX_PROB = 12;  // problems of one launch (K4's SA backward: q, k, v x 4 K slices)

enum Mode {
  kMasked = 0, kFuse = 1, kFolded = 2, kLogits = 3, kDx = 4,  // K6's
  kRelu = 5, kResid = 6, kGate = 7,                           // K1's
  kProj = 8,                                                  // K3's
  kProj32 = 9                                                 // K2's small-X
};

struct GemmArgs {
  CUtensorMap amap;  // the activations (C_a, T, B), 32 x 128 boxes, 128-byte swizzle
  CUtensorMap bmap;  // the weights' K-major hi and lo parts (K, N, 2 nprob), 32 x 128 boxes
  int seg_shift[MAX_PROB][MAX_SEG];  // per problem and K segment: the time shift of the tap
  int seg_c0[MAX_PROB][MAX_SEG];     // and its first channel in A
  int nseg, kseg, N, T, nprob;
  const int* lengths;
  float* out;
  int ldo, col_step;  // out row stride; problem z writes columns z * col_step + n
  const float* bias[MAX_PROB];  // per problem, or null
  // the residual x (kFuse, kFolded, kResid), the cotangent g (kDx), the
  // ReLU output h (kGate) or the key's positional term (kProj), at
  // res + b * res_bstride + t * res_ld + n
  const float* res;
  int res_ld;
  long long res_bstride;
  float* out2;       // kFuse: h
  float* part;       // kMasked, kGate: per-block column sums, row stride ldo
  fk::Dropout drop;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

constexpr int GEMM_THREADS = 384;  // a producer warpgroup, two consumer warpgroups

// JB: the epilogue's column groups whose global loads go out together (below)
template <int MODE, int JB>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    tower_gemm_kernel(const __grid_constant__ GemmArgs p) {
  constexpr bool kSums = MODE == kMasked || MODE == kGate;
  constexpr bool kDrop = MODE == kFuse || MODE == kResid;
  extern __shared__ float4 smem_raw[];
  float* sm = tc::align1024<float>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * GEMM_STAGE);  // then empty
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Bsz = gridDim.z / p.nprob;
  const int z = blockIdx.z / Bsz, b = blockIdx.z - z * Bsz;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int T = p.T;
  const int L = min(p.lengths[b], T);
  const int cps = (p.kseg + tc::kBK - 1) / tc::kBK;  // K steps per segment
  const int nk = t0 < L ? p.nseg * cps : 0;          // a tile past the video: no GEMM

  auto issue = [&](int kc) {
    const int s = kc % STAGES;
    const int seg = kc / cps;
    const int c = (kc - seg * cps) * tc::kBK;
    float* st = sm + s * GEMM_STAGE;
    tc::mbar_expect_tx(&full[s], 3 * TILE * 4);
    tc::tma_load_3d(st, &p.amap, &full[s], p.seg_c0[z][seg] + c, t0 + p.seg_shift[z][seg], b);
    tc::tma_load_3d(st + 2 * TILE, &p.bmap, &full[s], seg * p.kseg + c, n0, 2 * z);
    tc::tma_load_3d(st + 3 * TILE, &p.bmap, &full[s], seg * p.kseg + c, n0, 2 * z + 1);
  };
  float acc[64], big[64], small[64];  // the f32 sum, one K step's two products
  // warpgroup 0 keeps the ring full; warpgroups 1 and 2 each split and
  // multiply their own 64 rows and release a stage when done with it, so
  // that one's split and sums overlap the other's wgmma
  uint64_t* empty = full + STAGES;
  const int wg = (warp >> 2) - 1;  // the consumer warpgroup, -1 for the producer
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    tc::fence_barrier_init();
  }
  __syncthreads();
  if (wg < 0) {
    tc::setmaxnreg_dec<40>();  // 128 x 40 + 256 x 232 = 384 x 168, the launch's registers
    if (tid == 0)
      for (int kc = 0; kc < nk; ++kc) {
        if (kc >= STAGES) tc::mbar_wait(&empty[kc % STAGES], (kc / STAGES - 1) & 1);
        issue(kc);
      }
    return;
  }
  tc::setmaxnreg_inc<232>();
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = big[i] = small[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % STAGES;
    float* st = sm + s * GEMM_STAGE;
    tc::mbar_wait(&full[s], (kc / STAGES) & 1);
    // split this warpgroup's 64 rows of A: hi in place, lo beside it, the
    // rows outside [0, len) zero
    const int shift = p.seg_shift[z][kc / cps];
    float4* a4 = reinterpret_cast<float4*>(st + wg * (TILE / 2));
#pragma unroll
    for (int i = 0; i < TILE / 8 / 128; ++i) {
      const int q = (tid & 127) + i * 128;
      const int t = t0 + wg * 64 + (q >> 3) + shift;  // 8 float4 per 128-byte row
      float4 v = a4[q];
      if (t < 0 || t >= L) v = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 hi, lo;
      tc::split4(v, hi, lo);
      a4[q] = hi;
      a4[q + TILE / 4] = lo;
    }
    tc::fence_proxy_async();
    tc::bar_sync(1 + wg, 128);
    const float* a_hi = st + wg * (TILE / 2);
    const float* a_lo = st + TILE + wg * (TILE / 2);
    if (MODE == kProj) {
      // K3's K and V feed the softmax and the attend sum of every SCA layer:
      // a promotion after each 8-deep quarter (fresh accumulators) leaves the
      // big product one truncating add of an 8-deep sum each, where the
      // 32-deep chain leaves four of a growing one
#pragma unroll
      for (int k = 0; k < tc::kBK / 8; ++k) {
        tc::wgmma_fence();
        tc::mma3_k8(big, small, a_hi, a_lo, st + 2 * TILE, st + 3 * TILE, k);
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::promote(acc, big, small);
      }
    } else {
      tc::wgmma_fence();
      tc::mma3_k32(big, small, a_hi, a_lo, st + 2 * TILE, st + 3 * TILE);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::promote(acc, big, small);
    }
    if (lane == 0) tc::mbar_arrive(&empty[s]);
  }

  // epilogue: register 4j + 2h + e holds row rw + 8h, column n0 + 8j + cq + e
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int N = p.N;
  const float* bias = p.bias[z];
  const int col_off = z * p.col_step;
  // kProj's and kProj32's positional term goes to problem 0 only (K2's flash
  // forward projects xk and xv as two problems side by side)
  const float* res_p = (MODE == kProj || MODE == kProj32) && z != 0 ? nullptr : p.res;
  const uint32_t seed = kDrop ? p.drop.load_seed() : 0u;
  float csum[32];
  // With JB > 1 the epilogue's global loads (bias, and the residual,
  // cotangent or gate where the mode reads one) go out JB column groups at a
  // time, ahead of their use, so that their latencies overlap instead of
  // adding up; with JB = 1 each load sits where its value is used.  The
  // entry takes eight on a short K (launch_gemm), where the epilogue is a
  // large share of a block, one on a long K.
  constexpr bool kRes = MODE != kMasked && MODE != kLogits && MODE != kRelu;
#pragma unroll
  for (int jb = 0; jb < 16; jb += JB) {
    float2 bvs[JB], rvs[JB][2];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int n = n0 + 8 * (jb + jj) + cq;
      const bool ncol = n < N;  // N is a multiple of 4: n + 1 < N too
      bvs[jj] = make_float2(0.f, 0.f);
      if (bias != nullptr && ncol) bvs[jj] = load2(bias + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + rw + 8 * h;
        rvs[jj][h] = make_float2(0.f, 0.f);
        if (JB > 1 && kRes && t < L && ncol && res_p != nullptr && n < p.res_ld)
          rvs[jj][h] = load2(res_p + (size_t)b * p.res_bstride + (size_t)t * p.res_ld + n);
      }
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = jb + jj;
      const int n = n0 + 8 * j + cq;
      const bool ncol = n < N;
      const float2 bv = bvs[jj];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + rw + 8 * h;
        const bool valid = t < L;
        const bool write = t < T && ncol;
        const size_t row = (size_t)b * T + t;
        // the row's residual, cotangent, gate or positional term (valid && ncol only)
        auto res = [&]() {
          return JB > 1 ? rvs[jj][h]
                        : load2(res_p + (size_t)b * p.res_bstride + (size_t)t * p.res_ld + n);
        };
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (MODE == kMasked) {
          v0 = valid ? v0 + bv.x : 0.f;
          v1 = valid ? v1 + bv.y : 0.f;
          if (write) store2(p.out + row * p.ldo + col_off + n, v0, v1);
          s0 += v0;
          s1 += v1;
        } else if (MODE == kGate) {  // res: the ReLU output h
          float2 hv = make_float2(0.f, 0.f);
          if (valid && ncol) hv = res();
          v0 = hv.x > 0.f ? v0 : 0.f;
          v1 = hv.y > 0.f ? v1 : 0.f;
          if (write) store2(p.out + row * p.ldo + col_off + n, v0, v1);
          s0 += v0;
          s1 += v1;
        } else if (MODE == kRelu) {
          if (write)
            store2(p.out + row * N + n, valid ? fmaxf(v0 + bv.x, 0.f) : 0.f,
                   valid ? fmaxf(v1 + bv.y, 0.f) : 0.f);
        } else if (MODE == kFuse || MODE == kResid) {  // res: the residual x
          const float h0 = MODE == kFuse ? fmaxf(v0 + bv.x, 0.f) : v0 + bv.x;
          const float h1 = MODE == kFuse ? fmaxf(v1 + bv.y, 0.f) : v1 + bv.y;
          if (write) {
            float y0 = 0.f, y1 = 0.f;
            if (valid) {
              float o0 = h0, o1 = h1;
              if (p.drop.seed != nullptr) {
                const uint32_t idx = ((uint32_t)b * (uint32_t)T + (uint32_t)t) * (uint32_t)N + n;
                o0 *= p.drop.keep(idx, seed);
                o1 *= p.drop.keep(idx + 1, seed);
              }
              const float2 x = res();
              y0 = o0 + x.x;
              y1 = o1 + x.y;
            }
            if (MODE == kFuse && p.out2 != nullptr)
              store2(p.out2 + row * N + n, valid ? h0 : 0.f, valid ? h1 : 0.f);
            store2(p.out + row * N + n, y0, y1);
          }
        } else if (MODE == kFolded || MODE == kDx) {  // res: the residual x or the cotangent g
          if (write) {
            float y0 = 0.f, y1 = 0.f;
            if (valid) {
              const float2 r = res();
              y0 = (MODE == kFolded ? fmaxf(v0 + bv.x, 0.f) : v0) + r.x;
              y1 = (MODE == kFolded ? fmaxf(v1 + bv.y, 0.f) : v1) + r.y;
            }
            store2(p.out + row * N + n, y0, y1);
          }
        } else if (MODE == kProj || MODE == kProj32) {  // res: pos @ Wk on res_ld columns, or none
          if (write) {
            float y0 = 0.f, y1 = 0.f;
            if (valid) {
              y0 = v0 + bv.x;
              y1 = v1 + bv.y;
              if (res_p != nullptr && n < p.res_ld) {  // res_ld % 4 == 0: n + 1 too
                const float2 r = res();
                y0 += r.x;
                y1 += r.y;
              }
            }
            store2(p.out + row * p.ldo + col_off + n, y0, y1);
          }
        } else {  // kLogits: every frame of [0, T), the padded ones the bias row
          if (write) store2(p.out + row * p.ldo + n, v0 + bv.x, v1 + bv.y);
        }
      }
      csum[2 * j] = s0;
      csum[2 * j + 1] = s1;
    }
  }
  if (!kSums || p.part == nullptr) return;

  // per-block column sums in a fixed order: the warp's 16 rows by shuffles,
  // then the 8 warps in order, through stage 0's memory
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float v = csum[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    csum[i] = v;
  }
  // stage 0 is free only once both consumer warpgroups are past their main
  // loops: warpgroup 1's sums land on warpgroup 0's rows of A, which it may
  // still be splitting or multiplying
  tc::bar_sync(3, 256);
  float* red = sm;
  const int cwarp = wg * 4 + (warp & 3), ct = tid - 128;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      red[cwarp * BN + 8 * j + cq] = csum[2 * j];
      red[cwarp * BN + 8 * j + cq + 1] = csum[2 * j + 1];
    }
  }
  tc::bar_sync(3, 256);  // the consumer warps
  if (ct >= 0 && ct < BN && n0 + ct < N) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * BN + ct];
    p.part[((size_t)b * gridDim.y + blockIdx.y) * p.ldo + col_off + n0 + ct] = s;
  }
}

// K steps (segments x 32-float steps) up to which a launch takes JB = 8 (H100
// 80GB HBM3, 700 W): K1's 1x1 at the flagship's C=256 (8 steps) took 0.059 ms
// a layer with eight column groups at a time against 0.091 with one; epic's
// K6 training form (C=256, GEMMs of 8-24 steps) 3.367 and 3.384 ms against
// 3.781 and 3.764 with one throughout (one call); eight made K6's Breakfast
// serving form (K = 6C, 96 steps) slower, 4.84 ms against 4.16 in one call.
constexpr int kShortK = 24;

template <int MODE, int JB>
cudaError_t launch_jb(const GemmArgs& a, dim3 grid, cudaStream_t stream) {
  cudaError_t err = fk::set_smem((const void*)tower_gemm_kernel<MODE, JB>, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  tower_gemm_kernel<MODE, JB><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_gemm(const GemmArgs& a, dim3 grid, cudaStream_t stream) {
  const int steps = a.nseg * ((a.kseg + tc::kBK - 1) / tc::kBK);
  return steps <= kShortK ? launch_jb<MODE, 8>(a, grid, stream)
                          : launch_jb<MODE, 1>(a, grid, stream);
}

}  // namespace
