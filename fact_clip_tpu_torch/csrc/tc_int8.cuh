// Hopper's int8 tensor cores for the port's int8 kernels (sm_90a):
// `wgmma.mma_async` m64nNk32 .s32.s8.s8, both operands K-major in shared
// memory, fed by TMA through a ring of stages, on tc_gemm.cuh's mbarrier,
// TMA, setmaxnreg and swizzle helpers and in the producer / consumer
// warpgroup shape of tc_tower.cuh's tower_gemm_kernel.
//
// An operand tile is rows of 128 bytes (128 int8 values along K) in the
// 128-byte swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B), 8-row atoms
// of 1,024 bytes: the TF32 tiles' layout byte for byte, so tc::desc_sw128
// describes it and a 32-deep int8 step adds 32 bytes (2 in the address
// field), as an 8-deep TF32 step does.  Int8 wgmma allows no transpose:
// both operands lie K-major, the activations as rows of frames and the
// weights as (out channel, in channel) rows.
//
// A work item is 128 rows x BN columns: a producer warpgroup (one thread
// issues the TMA boxes of a stage: A 128 x 128 bytes, B BN x 128 bytes) and
// two consumer warpgroups of 64 rows each.  A consumer waits for a stage,
// issues its 32-byte steps, commits, keeps that group in flight while it
// waits for the previous step's group (wgmma.wait_group 1) and then
// releases the previous step's stage.  The kernels are persistent (one
// block an SM walks the items): the ring's step count runs on across
// items, so the producer fills the next item's stages during an epilogue.  Int32 sums are exact in any order,
// so the products equal the plain versions' integer products bit for bit.
// Accumulator layout of m64nN (as f32): register 4j + 2h + e of lane l in
// warp w of the warpgroup holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace tc8 {

constexpr int kBM = 128;       // rows of a block (two consumer warpgroups of 64)
constexpr int kKB = 128;       // bytes of K in a stage (one swizzled 128-byte row)
constexpr int kThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kATile = kBM * kKB;

template <int BN>
struct Ring {
  static constexpr int kStages = BN == 256 ? 4 : 6;  // 192 KB either way
  static constexpr int kStage = kATile + BN * kKB;
  // the ring, the full and empty barriers, and the 1,024-byte alignment slack
  static constexpr size_t kBytes = (size_t)kStages * kStage + 2 * kStages * 8 + 1024;
};

// d[64 x 128] += A[64 x 32] B[128 x 32]^T (s8 x s8 -> s32), both operands K-major
// in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 256] += A[64 x 32] B[256 x 32]^T (s8 x s8 -> s32), both operands K-major
// in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_s8_n256(d, da, db);
  else
    wgmma_s8_n128(d, da, db);
}

// The ring's barriers behind its stages; thread 0 initialises them (the
// caller synchronises the block afterwards).
template <int BN>
__device__ __forceinline__ uint64_t* ring_init(uint8_t* sm) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Ring<BN>::kStages * Ring<BN>::kStage);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ring<BN>::kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&full[Ring<BN>::kStages + s], 8);  // empty: lane 0 of each consumer warp
    }
    tc::fence_barrier_init();
  }
  return full;
}

// The producer's loop over one work item (thread 0 of warpgroup 0):
// issue(kc, a_dst, b_dst, bar) starts the two boxes of the item's K step kc
// on barrier bar.  g counts the block's steps over all its items, so the
// ring runs on from one item into the next: the next item's first stages
// load while the consumers run the epilogue of this one.
template <int BN, class Issue>
__device__ __forceinline__ void produce(uint8_t* sm, uint64_t* full, int& g, int nk,
                                        Issue issue) {
  constexpr int S = Ring<BN>::kStages;
  uint64_t* empty = full + S;
  for (int kc = 0; kc < nk; ++kc, ++g) {
    const int s = g % S;
    if (g >= S) tc::mbar_wait(&empty[s], (g / S - 1) & 1);
    uint8_t* st = sm + s * Ring<BN>::kStage;
    tc::mbar_expect_tx(&full[s], Ring<BN>::kStage);
    issue(kc, st, st + kATile, &full[s]);
  }
}

// The consumers' loop over one work item: step kc multiplies this
// warpgroup's 64 rows of the stage's A tile by its B tile, its first nsub
// 32-byte steps (the rest of a segment's last 128 bytes is padding), into
// accumulator `which` (acc[which]); step(kc) returns which * 8 + nsub.  Each
// stage is released once its products are done (the last one before the
// epilogue).
template <int BN, int NACC, class Step>
__device__ __forceinline__ void consume(int (&acc)[NACC][BN / 2], uint8_t* sm, uint64_t* full,
                                        int& g, int nk, int wg, Step step) {
  constexpr int S = Ring<BN>::kStages;
  uint64_t* empty = full + S;
  const int lane = threadIdx.x & 31;
  for (int kc = 0; kc < nk; ++kc, ++g) {
    const int s = g % S;
    const uint8_t* st = sm + s * Ring<BN>::kStage;
    const int code = step(kc);
    const int which = code >> 3, nsub = code & 7;
    tc::mbar_wait(&full[s], (g / S) & 1);
    const uint64_t da = tc::desc_sw128(st + wg * (kATile / 2));
    const uint64_t db = tc::desc_sw128(st + kATile);
#pragma unroll
    for (int a = 0; a < NACC; ++a) tc::fence_acc(acc[a]);
    tc::wgmma_fence();
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      if (a != which) continue;
#pragma unroll
      for (int k = 0; k < kKB / 32; ++k)
        if (k < nsub) wgmma_s8<BN>(acc[a], da + 2 * k, db + 2 * k);
    }
    tc::wgmma_commit();
    wgmma_wait_1();  // the previous step's products are done: release its stage
    if (kc > 0 && lane == 0) tc::mbar_arrive(&empty[(g - 1) % S]);
  }
  tc::wgmma_wait_all();
  if (nk > 0 && lane == 0) tc::mbar_arrive(&empty[(g - 1) % S]);
#pragma unroll
  for (int a = 0; a < NACC; ++a) tc::fence_acc(acc[a]);
}

// blocks of a persistent launch: one per SM, at most `items`
inline int persistent_blocks(int items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return items < sms ? items : sms;
}

// host: an int8 tensor (d2, d1, d0) row-major (d0 and d0 * d1 multiples of
// 16 bytes), boxes of (1, box1, 128) in the 128-byte swizzle; a box reaching
// past the tensor reads zeros there.  False when cuTensorMapEncodeTiled refuses it.
inline bool encode_3d_s8(CUtensorMap* map, const void* ptr, long long d0, long long d1,
                         long long d2, int box1) {
  tc::EncodeTiledFn fn = tc::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0, (cuuint64_t)(d0 * d1)};
  const cuuint32_t box[3] = {(cuuint32_t)kKB, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc8
