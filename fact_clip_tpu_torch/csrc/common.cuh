// Shared building blocks of the port's Hopper kernels (f32, CUDA cores).
//
// Every kernel in this library runs 256 threads (8 warps) per block and
// computes its projections with one register-blocked GEMM core:
// acc[BM x 256] += A[BM x K] * W[K x N][:, n0 : n0 + 256], in chunks of 16
// along K through a two-stage shared-memory pipeline: while the block
// multiplies chunk c, the W rows of chunk c+1 arrive by cp.async and the A
// values of chunk c+1 wait in registers.  The 8 warps tile the pass 4 x 2
// (rows x columns) and a warp's lanes 2 x 16: each thread owns RM = BM/8
// rows (pass_row) and 8 columns in two runs of 4, 64 apart (pass_col).  Both
// operand reads of the inner loop are 16-byte shared-memory loads; per step
// along K a warp reads two distinct A vectors and 128 W columns (5 shared
// memory wavefronts for 32 FMAs a lane at RM = 4), so the FMA pipes and not
// the shared-memory pipe are the bound.
//
// The caller supplies A as an element function a(r, k) for row r < BM of the
// block's tile and column k < K (zero outside the valid rows): that is where
// halo taps, positional adds and length masks live.  Neighbouring threads
// stage neighbouring k of one row; with kTransA they stage neighbouring rows
// of one k instead, which keeps the loads coalesced when A is read
// transposed (a weight gradient's A^T, rows = channels, k = time).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace fk {

// bf16 in the mixed-precision forms: values convert by the intrinsics only
// (the code builds under -D__CUDA_NO_BFLOAT16_CONVERSIONS__ too), and a
// rounding to bf16 is to nearest, ties to even, as XLA's and PyTorch's
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an element as f32: __ldg for floats, a plain load and conversion for bf16
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;   // reduction chunk
constexpr int kBN = 256;  // output columns per pass
constexpr float kMaskedLogit = -1e9f;  // JAX's masked-key logit

template <int BM>
struct GemmSmem {
  float a[2][kBK][BM + 4];  // A chunks, k-major; +4 keeps rows 16-byte aligned
  float w[2][kBK][kBN];     // W chunks
};

// Row of the pass that this thread owns in slot i (0..BM/8-1).
template <int BM>
__device__ __forceinline__ int pass_row(int i) {
  const int group = (threadIdx.x >> 6) * 2 + ((threadIdx.x >> 4) & 1);  // warp row, lane half
  return group * (BM / 8) + i;
}

// Column of the pass that this thread owns in slot j (0..7).
__device__ __forceinline__ int pass_col(int j) {
  const int c0 = ((threadIdx.x >> 5) & 1) * 128 + (threadIdx.x & 15) * 4;
  return j < 4 ? c0 + j : c0 + 64 + (j - 4);
}

// dst <- src[0 : bytes], zero-filled when !valid (no bytes are read then)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// The n floats at src into dst + off by threads t of nt (the block's by
// default) as asynchronous copies, 16 bytes each but for the unaligned head
// and tail: off (returned,
// 0-3) puts src's 16-byte boundaries on dst's, which must be 16-byte aligned
// and hold n + 3 floats.
__device__ __forceinline__ int cp_async_floats(float* dst, const float* src, int n,
                                               int t = threadIdx.x, int nt = blockDim.x) {
  const int off = (int)(((uintptr_t)src >> 2) & 3);
  const int head = min(n, (4 - off) & 3);
  const int nv = (n - head) >> 2;
  float* d = dst + off;
  for (int i = t; i < head; i += nt) cp_async<4>(d + i, src + i, true);
  for (int i = t; i < nv; i += nt) cp_async<16>(d + head + 4 * i, src + head + 4 * i, true);
  for (int i = head + 4 * nv + t; i < n; i += nt) cp_async<4>(d + i, src + i, true);
  return off;
}

// Start the asynchronous copies of W rows [k0, k0 + kBK), columns [n0, n0 + kBN) into w.
__device__ __forceinline__ void fetch_w(float (*w)[kBN], const float* __restrict__ W, int ldw,
                                        int K, int k0, int n0, int N, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {  // 16-byte copies: N and ldw multiples of 4, W 16-byte aligned
#pragma unroll
    for (int j = 0; j < kBK * kBN / 4 / kThreads; ++j) {
      const int f = tid + j * kThreads;
      const int kk = f / (kBN / 4);
      const int c = (f - kk * (kBN / 4)) * 4;
      const int k = k0 + kk;
      const bool ok = k < K && n0 + c < N;
      cp_async<16>(&w[kk][c], ok ? W + (size_t)k * ldw + n0 + c : W, ok);
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const int k = k0 + kk;
      const bool ok = k < K && n0 + tid < N;
      cp_async<4>(&w[kk][tid], ok ? W + (size_t)k * ldw + n0 + tid : W, ok);
    }
  }
}

// The W chunk [k0, k0 + kBK) x [n0, n0 + kBN) of a bf16 W, held in registers
// by each thread (8 values a 16-byte load) and converted to f32 as it is
// stored to shared memory (the mixed-precision forms' weights; the f32 path
// copies with cp.async instead)
constexpr int kW16Per = kBK * kBN / 8 / kThreads;  // 16-byte loads per thread and chunk

__device__ __forceinline__ void fetch_w16(uint4 (&wv)[kW16Per], const bf16* __restrict__ W,
                                          int ldw, int K, int k0, int n0, int N, bool vec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kW16Per; ++j) {
    const int f = tid + j * kThreads;
    const int kk = f / (kBN / 8);
    const int c = (f - kk * (kBN / 8)) * 8;
    const int k = k0 + kk;
    if (vec) {  // N and ldw multiples of 8, W 16-byte aligned
      wv[j] = k < K && n0 + c < N ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)k * ldw +
                                                                         n0 + c))
                                  : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint16_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = k < K && n0 + c + e < N
                   ? reinterpret_cast<const uint16_t*>(W)[(size_t)k * ldw + n0 + c + e]
                   : (uint16_t)0;
      wv[j] = make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                         h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
    }
  }
}

// the two bf16 of a 32-bit word (the lower one first) as f32
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16((unsigned short)(u & 0xffffu))),
                     __bfloat162float(__ushort_as_bfloat16((unsigned short)(u >> 16))));
}

__device__ __forceinline__ void store_w16(float (*w)[kBN], const uint4 (&wv)[kW16Per]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kW16Per; ++j) {
    const int f = tid + j * kThreads;
    const int kk = f / (kBN / 8);
    const int c = (f - kk * (kBN / 8)) * 8;
    const float2 a = bf16x2_to_float2(wv[j].x), b = bf16x2_to_float2(wv[j].y);
    const float2 e = bf16x2_to_float2(wv[j].z), g = bf16x2_to_float2(wv[j].w);
    *reinterpret_cast<float4*>(&w[kk][c]) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(&w[kk][c + 4]) = make_float4(e.x, e.y, g.x, g.y);
  }
}

// TW: the element type of W, float (staged by cp.async) or bf16 (staged
// through registers and converted, fetch_w16); the products are f32 FMAs
// either way, exact for bf16 operands.
template <int BM, bool kTransA = false, class AElem, class TW = float>
__device__ __forceinline__ void gemm_pass(float (&acc)[BM / 8][8], AElem a_elem,
                                          const TW* __restrict__ W, int ldw,
                                          int K, int n0, int N, GemmSmem<BM>& s) {
  constexpr bool kW16 = std::is_same<TW, bf16>::value;
  constexpr int RM = BM / 8;
  constexpr int kAPer = BM * kBK / kThreads;  // A values each thread stages per chunk
  constexpr int kRowStep = kThreads / kBK;    // rows between them (row-wise staging)
  constexpr int kKStep = kThreads / BM;       // k between them (kTransA)
  static_assert(RM % 4 == 0, "rows per thread must be a multiple of 4");
  static_assert(kKStep * kAPer == kBK, "kTransA staging must cover the chunk");
  const int tid = threadIdx.x;
  const int row0 = pass_row<BM>(0);
  const int col0 = pass_col(0);
  // the first (row, k) of A this thread stages, and where its others lie
  const int ak = kTransA ? tid / BM : tid % kBK;
  const int ar = kTransA ? tid % BM : tid / kBK;
  auto a_row = [&](int i) { return kTransA ? ar : ar + kRowStep * i; };
  auto a_k = [&](int i) { return kTransA ? ak + kKStep * i : ak; };
  const int wvec = kW16 ? 8 : 4;
  const bool vec = (N % wvec == 0) && (ldw % wvec == 0) && ((uintptr_t)W % 16 == 0);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float av[kAPer];
  uint4 wv[kW16 ? kW16Per : 1];
  auto fetch_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int k = k0 + a_k(i);
      av[i] = k < K ? a_elem(a_row(i), k) : 0.f;
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) s.a[buf][a_k(i)][a_row(i)] = av[i];
  };
  auto fetch_w_any = [&](int buf, int k0) {
    if constexpr (kW16)
      fetch_w16(wv, W, ldw, K, k0, n0, N, vec);
    else
      fetch_w(s.w[buf], W, ldw, K, k0, n0, N, vec);
  };
  auto store_w_any = [&](int buf) {
    if constexpr (kW16) store_w16(s.w[buf], wv);
  };

  const int n_chunks = (K + kBK - 1) / kBK;
  fetch_w_any(0, 0);
  fetch_a(0);
  store_a(0);
  store_w_any(0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < n_chunks;
    if (more) {  // the next chunk's loads are in flight during this multiply
      fetch_w_any(cur ^ 1, (c + 1) * kBK);
      fetch_a((c + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[RM];
      float b[8];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&s.a[cur][kk][row0 + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&s.w[cur][kk][col0]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.w[cur][kk][col0 + 64]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      store_w_any(cur ^ 1);
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// In-place LayerNorm of `rows` rows of width E (row stride E) by one warp per
// row: two-pass mean / variance in f32.  Rows r >= valid_rows are zeroed
// instead (the write mask of the tower).  The caller synchronises first.
__device__ __forceinline__ void layer_norm_rows(float* base, int rows, int valid_rows, int E,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, float eps) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    float* row = base + (size_t)r * E;
    if (r >= valid_rows) {
      for (int c = lane; c < E; c += 32) row[c] = 0.f;
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += row[c];
    const float mean = warp_sum(s) / E;
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / E + eps);
    for (int c = lane; c < E; c += 32)
      row[c] = (row[c] - mean) * inv * __ldg(gamma + c) + __ldg(beta + c);
  }
}

// Counter-based dropout bits: the murmur3 finalizer of (seed, stream, index)
// with uint32 wraparound, where index is the element's row-major position in
// the mask's logical shape.  Every kernel that drops out (K1's layers, K3's
// probabilities, K4's sublayers) and the mask kernel (dropout.cu) call this
// one function, and ops/dropout.py computes the same bits with int64 torch
// ops, so a kernel's mask and the plain version's are bit-equal.  Keep where
// bits < (1 - rate) * 2^32.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t stream, uint32_t idx) {
  const uint32_t key = fmix32(seed + stream * 0x85ebca77u);
  return fmix32((idx * 0x9e3779b9u) ^ key);
}

// A kernel's dropout: the seed (device, read once per block), the stream,
// the keep threshold and the scale 1 / (1 - rate).  A null seed: no dropout.
struct Dropout {
  const int* seed;
  int stream;
  unsigned thresh;
  float scale;
  __device__ __forceinline__ uint32_t load_seed() const { return seed ? (uint32_t)seed[0] : 0u; }
  // the scaled keep value of the element at row-major index idx
  __device__ __forceinline__ float keep(uint32_t idx, uint32_t s) const {
    return dropout_bits(s, (uint32_t)stream, idx) < thresh ? scale : 0.f;
  }
};

// Column sums of a (rows x ncols) tile (row stride ld) in global or shared
// memory, in row order, one thread per column: deterministic.  The caller
// synchronises first.
__device__ __forceinline__ void block_colsum(const float* base, int ld, int rows, int ncols,
                                             float* __restrict__ out) {
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += base[(size_t)r * ld + c];
    out[c] = s;
  }
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) on the
// current device, called only where `bytes` is more than this process set
// for that kernel and device before: the entries ask for it before every
// launch, and each such CUDA call costs host time
inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  constexpr int kSlots = 512;
  static const void* keys[kSlots];
  static int devs[kSlots];
  static size_t done[kSlots];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int i = (int)((((uintptr_t)kernel >> 4) * 31u + (unsigned)dev) % kSlots);
  for (int n = 0; n < kSlots && keys[i] != nullptr && (keys[i] != kernel || devs[i] != dev); ++n)
    i = (i + 1) % kSlots;
  const bool known = keys[i] == kernel && devs[i] == dev;
  if (known && done[i] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && (known || keys[i] == nullptr)) {
    keys[i] = kernel;
    devs[i] = dev;
    done[i] = bytes;
  }
  return err;
}

}  // namespace fk
