// Hopper tensor-core building blocks of the port (sm_90a): f32 products at
// f32 accuracy on the TF32 tensor cores by the 3xTF32 split.
//
//   a = a_hi + a_lo,  a_hi = tf32_rna(a),  a_lo = tf32_rna(a - a_hi)
//   a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
//
// The dropped a_lo.b_lo term and the rounding of the lo parts leave ~2^-22
// of each product, below f32's own summation error over K in the thousands
// (one TF32 pass alone keeps 2^-11 and would miss a 2e-4 gate at K = 1,536).
// Each pass is `wgmma.mma_async` m64n128k8 with .tf32 operands from shared
// memory and f32 accumulators in registers; all three passes add into one
// accumulator.  TF32 `wgmma` reads both operands K-major (no transpose for
// 32-bit types): a tile is rows of 32 floats (128 bytes) along K, stored
// with the 128-byte swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B),
// 8-row atoms of 1,024 bytes.  Tiles arrive by TMA (`cp.async.bulk.tensor`,
// one thread issues, an `mbarrier` counts the bytes).
//
// The host side encodes the tensor maps with the driver's
// cuTensorMapEncodeTiled, fetched through the runtime (no libcuda link).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace tc {

constexpr int kBK = 32;  // floats of K per tile row (128 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// shared-memory writes of this thread become visible to the async proxy
// (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase `parity` to complete.  A copy that never
// lands (a bad map, a wrong byte count) traps after ~2^34 cycles (~10 s)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// a named barrier for `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// hand a warpgroup's registers to the others / take them (sm_90a).  The
// counts after both must fit in what the launch holds (threads x the
// kernel's register count): an inc that finds too few waits forever.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// one box of a 3-D tensor map into shared memory; coordinates innermost
// first, signed: a box reaching outside the tensor reads zeros there
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// the 3xTF32 split

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - hi);
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
}

// float offset of element (row, k) of a K-major tile of 32-float rows in
// the 128-byte swizzle: the 16-byte chunk k/4 of row r sits at chunk (k/4) ^ (r % 8)
__device__ __forceinline__ int sw128(int row, int k) {
  return row * kBK + ((((k >> 2) ^ row) & 7) << 2) + (k & 3);
}

// ---------------------------------------------------------------------------
// wgmma

// Descriptor of a K-major operand tile in the 128-byte swizzle: start
// address >> 4, leading offset 1 (unused in this layout), stride 1,024
// bytes between 8-row atoms, layout type 1 (SWIZZLE_128B).  The tile base
// is 1,024-byte aligned; step k8 of the 32-float row adds 32 bytes (2 in
// the address field).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator registers across the async ops
// (the f32 and the int32 accumulators)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// dynamic shared memory rounded up to 1,024 bytes, where the 128-byte
// swizzle's pattern repeats
template <class T>
__device__ __forceinline__ T* align1024(void* p) {
  return reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// d[64 x 128] = A[64 x 8] B[8 x 128]^T (+ d when accumulate), both K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
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

// One 32-deep K step of the 3xTF32 product for this warpgroup into fresh
// accumulators: big = A_hi B_hi^T, small = A_hi B_lo^T + A_lo B_hi^T (64 x
// 128 each, from the hi and lo tiles).  The tensor cores add into their
// accumulator rounding toward zero: every add of a term shrinks the sum by
// ~0.5 ulp on average, a bias that does not average out (measured on the
// card: all of a 1,536-deep product summed in one accumulator came out
// ~2.5e-5 small; with a fresh accumulator per step and the cross terms in
// it, ~6e-7 small, coherently, in every output).  So the callers add each
// step's two sums into an f32 sum of their own (rounded to nearest), and the
// cross terms, 2^-11 of the products, add into their own accumulator, where
// their truncation costs ~2^-11 of what it would cost in the big one: the
// big sum takes 4 truncating adds a step instead of 12.
__device__ __forceinline__ void mma3_k32(float (&big)[64], float (&small)[64], const float* a_hi,
                                         const float* a_lo, const float* b_hi,
                                         const float* b_lo) {
  const uint64_t ah = desc_sw128(a_hi), al = desc_sw128(a_lo);
  const uint64_t bh = desc_sw128(b_hi), bl = desc_sw128(b_lo);
#pragma unroll
  for (int k = 0; k < kBK / 8; ++k) {
    wgmma_tf32_n128(small, al + 2 * k, bh + 2 * k, k > 0);
    wgmma_tf32_n128(small, ah + 2 * k, bl + 2 * k, 1);
    wgmma_tf32_n128(big, ah + 2 * k, bh + 2 * k, k > 0);
  }
}

// The 8-deep quarter k of such a step into fresh accumulators (K3's
// projection promotes after each: tc_tower.cuh, kProj).
__device__ __forceinline__ void mma3_k8(float (&big)[64], float (&small)[64], const float* a_hi,
                                        const float* a_lo, const float* b_hi, const float* b_lo,
                                        int k) {
  const uint64_t ah = desc_sw128(a_hi) + 2 * k, al = desc_sw128(a_lo) + 2 * k;
  const uint64_t bh = desc_sw128(b_hi) + 2 * k, bl = desc_sw128(b_lo) + 2 * k;
  wgmma_tf32_n128(small, al, bh, 0);
  wgmma_tf32_n128(small, ah, bl, 1);
  wgmma_tf32_n128(big, ah, bh, 0);
}

// sum += big + small, rounded f32 adds (after the step's wgmma have completed)
__device__ __forceinline__ void promote(float (&sum)[64], float (&big)[64], float (&small)[64]) {
  fence_acc(big);
  fence_acc(small);
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] += big[i] + small[i];
}

// Accumulator layout of m64nN: register 4j + 2h + e of lane l in warp w of
// the warpgroup holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e.

// ---------------------------------------------------------------------------
// host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A float32 tensor (d2, d1, d0) row-major, boxes of (1, box1, box0);
// `swizzle` selects the 128-byte swizzle (box0 = 32) over plain rows;
// `bf16`: a bfloat16 tensor instead (2-byte elements, box0 = 64 for the
// swizzle: tc_bf16.cu).
// Returns false when cuTensorMapEncodeTiled refuses the map.  The last
// kMapCache maps are kept by their arguments: an entry encodes the same maps
// call after call (its buffers come back at the same addresses from
// PyTorch's caching allocator), and each encode costs host time.
struct MapKey {
  const void* ptr;
  long long d0, d1, d2;
  int box0, box1;
  bool swizzle, bf16;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 && box0 == o.box0 &&
           box1 == o.box1 && swizzle == o.swizzle && bf16 == o.bf16;
  }
};

inline bool encode_3d(CUtensorMap* map, const void* ptr, long long d0, long long d1, long long d2,
                      int box0, int box1, bool swizzle, bool bf16 = false) {
  constexpr int kMapCache = 64;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int next = 0;
  static std::mutex mu;
  const MapKey key{ptr, d0, d1, d2, box0, box1, swizzle, bf16};
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < kMapCache; ++i)
      if (keys[i] == key) {
        *map = maps[i];
        return true;
      }
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const long long esz = bf16 ? 2 : 4;
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * esz), (cuuint64_t)(d0 * d1 * esz)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
         const_cast<void*>(ptr), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> lock(mu);
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  return true;
}

}  // namespace tc
