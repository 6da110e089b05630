// Int8 tensor-core GEMM core of the K8 kernels (int8 evaluation).
//
// acc[BM x 256] (int32) = A[BM x K] * B[K x N][:, n0 : n0 + 256] with int8
// operands on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  Int32 sums
// are exact in any order, so every integer product here equals the plain
// version's (an exact integer product) bit for bit; what differs between a
// K8 kernel and its plain twin can only come from its f32 epilogue.
//
// The block's 256 threads (8 warps) stage one chunk of 64 reduction values
// at a time in shared memory: A as BM rows of 64 bytes, B transposed (N-major,
// "col" operand) as 256 rows of 64 bytes, each row padded to 80 bytes so that
// the fragment loads of a warp hit 32 distinct banks.  Warp w owns output
// columns [32 w, 32 w + 32) of the pass and all BM rows: BM/16 x 4 mma tiles
// of 16 x 8, BM/16 x 4 x 4 int32 accumulators a thread.  The caller stages A
// itself (``stage_a(a, k0)`` fills rows [0, BM), bytes [0, 64) of the chunk,
// zeros where there is no value): that is where on-the-fly quantization,
// halo taps and length masks live.  K must be a multiple of 16 and B's rows
// 16-byte aligned.  Single-buffered: simple first, see PERF.md.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace fk {

constexpr int kQK = 64;         // reduction chunk (int8 values)
constexpr int kQLD = kQK + 16;  // row stride of a staged chunk in bytes

template <int BM>
struct QSmem {
  int8_t a[BM][kQLD];
  int8_t b[kBN][kQLD];
};

// Row (within the block's BM) and column (within the 256 of the pass) of
// accumulator acc[mt][nt][i] of this thread.
__device__ __forceinline__ int q_row(int mt, int i) {
  return mt * 16 + ((threadIdx.x & 31) >> 2) + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int q_col(int nt, int i) {
  return (threadIdx.x >> 5) * 32 + nt * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// four int8 values, element 0 in the least significant byte (memory order)
__device__ __forceinline__ int pack_s8(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}

// JAX's quantizer, round(v * (127 / s)) half to even, with inv = 127 / s
__device__ __forceinline__ int quant_s8(float v, float inv) {
  return __float2int_rn(__fmul_rn(v, inv));
}

// 16 f32 values -> 16 int8 values (one 16-byte piece of a staged row)
__device__ __forceinline__ int4 quant16(const float* __restrict__ p, float inv) {
  const float4 v0 = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v1 = __ldg(reinterpret_cast<const float4*>(p + 4));
  const float4 v2 = __ldg(reinterpret_cast<const float4*>(p + 8));
  const float4 v3 = __ldg(reinterpret_cast<const float4*>(p + 12));
  int4 o;
  o.x = pack_s8(quant_s8(v0.x, inv), quant_s8(v0.y, inv), quant_s8(v0.z, inv), quant_s8(v0.w, inv));
  o.y = pack_s8(quant_s8(v1.x, inv), quant_s8(v1.y, inv), quant_s8(v1.z, inv), quant_s8(v1.w, inv));
  o.z = pack_s8(quant_s8(v2.x, inv), quant_s8(v2.y, inv), quant_s8(v2.z, inv), quant_s8(v2.w, inv));
  o.w = pack_s8(quant_s8(v3.x, inv), quant_s8(v3.y, inv), quant_s8(v3.z, inv), quant_s8(v3.w, inv));
  return o;
}

// B chunk: rows n0 .. n0 + 255 of Bt (N x K int8, row-major), bytes [k0, k0 + 64)
__device__ __forceinline__ void q_stage_b(int8_t (*b)[kQLD], const int8_t* __restrict__ Bt,
                                          int K, int k0, int n0, int N) {
#pragma unroll
  for (int j = 0; j < kBN * kQK / 16 / kThreads; ++j) {
    const int f = threadIdx.x + j * kThreads;
    const int r = f >> 2;
    const int c = (f & 3) * 16;
    const int n = n0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (n < N && k0 + c < K) v = __ldg(reinterpret_cast<const int4*>(Bt + (size_t)n * K + k0 + c));
    *reinterpret_cast<int4*>(&b[r][c]) = v;
  }
}

// A chunk from int8 rows in global memory (row stride K); rows >= rows read 0
template <int BM>
__device__ __forceinline__ void q_stage_a_rows(int8_t (*a)[kQLD], const int8_t* __restrict__ A,
                                               int K, int rows, int k0) {
  for (int f = threadIdx.x; f < BM * kQK / 16; f += kThreads) {
    const int r = f >> 2;
    const int c = (f & 3) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows && k0 + c < K) v = __ldg(reinterpret_cast<const int4*>(A + (size_t)r * K + k0 + c));
    *reinterpret_cast<int4*>(&a[r][c]) = v;
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int BM>
__device__ __forceinline__ void q_mma_chunk(int (&acc)[BM / 16][4][4], const QSmem<BM>& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = (lane & 3) * 4;
#pragma unroll
  for (int ks = 0; ks < kQK; ks += 32) {
    int bf[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = warp * 32 + nt * 8 + g;
      bf[nt][0] = *reinterpret_cast<const int*>(&s.b[n][ks + tq]);
      bf[nt][1] = *reinterpret_cast<const int*>(&s.b[n][ks + 16 + tq]);
    }
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt) {
      const int r = mt * 16 + g;
      const int a0 = *reinterpret_cast<const int*>(&s.a[r][ks + tq]);
      const int a1 = *reinterpret_cast<const int*>(&s.a[r + 8][ks + tq]);
      const int a2 = *reinterpret_cast<const int*>(&s.a[r][ks + 16 + tq]);
      const int a3 = *reinterpret_cast<const int*>(&s.a[r + 8][ks + 16 + tq]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a0, a1, a2, a3, bf[nt][0], bf[nt][1]);
    }
  }
}

// acc = A[BM x K] * Bt[n0 : n0 + 256, :]^T; synchronises before and after,
// so the caller may reuse the staging memory once it returns
template <int BM, class StageA>
__device__ __forceinline__ void q_gemm_pass(int (&acc)[BM / 16][4][4], StageA stage_a,
                                            const int8_t* __restrict__ Bt, int K, int n0, int N,
                                            QSmem<BM>& s) {
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  for (int k0 = 0; k0 < K; k0 += kQK) {
    __syncthreads();  // the previous chunk (or the caller) is done with the buffers
    stage_a(s.a, k0);
    q_stage_b(s.b, Bt, K, k0, n0, N);
    __syncthreads();
    q_mma_chunk<BM>(acc, s);
  }
  __syncthreads();
}

}  // namespace fk
