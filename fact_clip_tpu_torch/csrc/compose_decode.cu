// K7: the composed-action argmaxes of the epic verb/noun model.
//
// Replaces fact_clip_tpu/ops/pallas/compose_decode.py::mxu_argmax
// (_mxu_argmax_kernel), ::blend_argmax (_blend_kernel) and ::factored_argmax
// (_factored_kernel).  The action space is the composition of a verb head
// (n1 log-probs lv) and a noun head (n2 log-probs ln): action a scores
// s_a = lv[vids[a]] + ln[nids[a]], one f32 add, over n_act actions (98 verbs,
// 301 nouns and 3,806 actions at epic scale).  Per frame t of video b:
//
//   fk_compose_argmax:  out[t]   = first argmax_a s_a
//   fk_compose_blend:   pred[t]  = first argmax_a (1-w) q[b, act[t], a] + w exp(s_a)
//                       fb[t]    = first argmax_a s_a      (the all-null fallback)
//   fk_factored_argmax: vstar[t] = first argmax_v lv[v] + max_n (ln[n] + mvn[v, n])
//
// The TPU kernels compose on the MXU as one-hot products with three-term bf16
// splits of the log-probs, a workaround for its matrix unit.  On Hopper a
// gather from shared memory is exact: the composition is the plain version's
// one add, and the blend repeats the plain version's roundings (each product
// and the sum rounded on its own, __fmul_rn / __fadd_rn, so that nvcc
// contracts nothing into an FMA; expf is the full-precision one that
// torch.exp calls).  Equal values pick the lower index, as torch.argmax and
// jnp.argmax do.  Inputs are finite (log-probabilities); an all -inf row
// picks index 0.
//
// Layout of the composed argmax and the blend: one block of 8 warps per tile
// of 32 frames of one video.  The block stages the action table (vids |
// nids << 16, one int per action, 15 KB at epic scale) and the tile's lv and
// ln rows in shared memory.  Each warp owns 4 frames at once; its lanes
// stride over the actions, so a table entry read from shared memory serves
// 4 frames, and each lane keeps each frame's best (value, index) with a
// strict > (its lowest index among equal values).  A shuffle reduction that
// prefers the lower index on equal values ends each frame.  The blend reads
// the voting token's q row from device memory, coalesced across the lanes
// (the (300, 3,806) table, 4.6 MB a video, stays in L2).  The (T, n_act)
// composition never reaches device memory: the plain version materialises
// it, 374 MB for a 24,576-frame video.
//
// The factored argmax keeps the (n1, n2) mask in shared memory (118 KB at
// epic scale, rows padded to an odd stride so that lanes on neighbouring
// verbs hit distinct banks) and runs one frame per warp at a time: each lane
// owns verbs lane, lane + 32, ... and reduces its verbs' masked noun rows;
// the best verb is reduced across lanes as above.  Its ties break verb
// first, then noun, not in action order (by design, as the TPU kernel's).
//
// Bound on the H100: device memory.  At epic scale the kernels read the
// factored log-probs once, T * 399 * 4 B (39 MB at T = 24,576: 11.7 us at
// 3.35 TB/s), and do 2 (argmax), ~8 (blend) or 2 n2 / n_act * n1 (factored)
// operations per (frame, action) on the CUDA cores.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int FPW = 4;                  // frames a warp composes at once
constexpr int TILE = fk::kWarps * FPW;  // frames per block (argmax, blend)
constexpr int FTILE = 64;               // frames per block (factored)

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return bi < 0 || v > bv || (v == bv && i < bi);
}

// the first argmax over the warp's lanes: the larger value, the lower index on equal values
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (oi >= 0 && better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// rows [row0, row0 + rows) of a (.., n) matrix into s (TILE rows), zeros past rows
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, size_t row0, int rows,
                                           int n, float* s) {
  const float* p = src + row0 * n;
  for (int i = threadIdx.x; i < TILE * n; i += fk::kThreads) s[i] = i < rows * n ? __ldg(p + i) : 0.f;
}

template <bool kBlend>
__global__ void __launch_bounds__(fk::kThreads)
compose_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
               const int* __restrict__ vids, const int* __restrict__ nids,
               const float* __restrict__ q, const int* __restrict__ act, int* __restrict__ out,
               int* __restrict__ fb, int T, int n1, int n2, int n_act, int M, float omw,
               float w) {
  extern __shared__ float4 smem_raw[];
  int* tab = reinterpret_cast<int*>(smem_raw);
  float* lvs = reinterpret_cast<float*>(tab + n_act);
  float* lns = lvs + TILE * n1;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int rows = min(TILE, T - t0);
  const size_t row0 = (size_t)b * T + t0;
  for (int a = threadIdx.x; a < n_act; a += fk::kThreads)
    tab[a] = __ldg(vids + a) | (__ldg(nids + a) << 16);
  stage_rows(lv, row0, rows, n1, lvs);
  stage_rows(ln, row0, rows, n2, lns);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int f0 = (threadIdx.x >> 5) * FPW;  // the warp's first frame in the tile
  if (f0 >= rows) return;
  const float* qrow[FPW];
  float bv[FPW], sv[FPW];
  int bi[FPW], si[FPW];
#pragma unroll
  for (int j = 0; j < FPW; ++j) {
    bv[j] = sv[j] = -INFINITY;
    bi[j] = si[j] = -1;
    if (kBlend) {
      const int f = min(f0 + j, rows - 1);
      qrow[j] = q + ((size_t)b * M + __ldg(act + row0 + f)) * n_act;
    }
  }
  for (int a = lane; a < n_act; a += 32) {
    const int e = tab[a];
    const int v = e & 0xffff;
    const int n = e >> 16;
#pragma unroll
    for (int j = 0; j < FPW; ++j) {
      const float s = lvs[(f0 + j) * n1 + v] + lns[(f0 + j) * n2 + n];
      if (s > sv[j] || si[j] < 0) {
        sv[j] = s;
        si[j] = a;
      }
      if (kBlend) {
        const float p = __fadd_rn(__fmul_rn(omw, __ldg(qrow[j] + a)), __fmul_rn(w, expf(s)));
        if (p > bv[j] || bi[j] < 0) {
          bv[j] = p;
          bi[j] = a;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < FPW; ++j) {
    warp_argmax(sv[j], si[j]);
    if (kBlend) warp_argmax(bv[j], bi[j]);
    if (lane == 0 && f0 + j < rows) {
      if (kBlend) {
        out[row0 + f0 + j] = bi[j];
        fb[row0 + f0 + j] = si[j];
      } else {
        out[row0 + f0 + j] = si[j];
      }
    }
  }
}

__global__ void __launch_bounds__(fk::kThreads)
factored_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
                const float* __restrict__ mvn, int* __restrict__ vstar, int T, int n1, int n2,
                int ldm) {
  extern __shared__ float4 smem_raw[];
  float* ms = reinterpret_cast<float*>(smem_raw);  // (n1, ldm)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* lvw = ms + (size_t)n1 * ldm + (size_t)warp * (n1 + n2);  // the warp's frame
  float* lnw = lvw + n1;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FTILE;
  for (int i = threadIdx.x; i < n1 * n2; i += fk::kThreads) {
    const int v = i / n2;
    ms[v * ldm + (i - v * n2)] = __ldg(mvn + i);
  }
  __syncthreads();

  for (int t = t0 + warp; t < min(T, t0 + FTILE); t += fk::kWarps) {
    const size_t row = (size_t)b * T + t;
    for (int i = lane; i < n1; i += 32) lvw[i] = __ldg(lv + row * n1 + i);
    for (int i = lane; i < n2; i += 32) lnw[i] = __ldg(ln + row * n2 + i);
    __syncwarp();
    float best = -INFINITY;
    int bi = -1;
    for (int v = lane; v < n1; v += 32) {  // increasing v: strict > keeps the first verb
      const float* mrow = ms + v * ldm;
      float m = -INFINITY;
      for (int n = 0; n < n2; ++n) m = fmaxf(m, lnw[n] + mrow[n]);
      const float s = lvw[v] + m;
      if (s > best || bi < 0) {
        best = s;
        bi = v;
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) vstar[row] = bi;
    __syncwarp();  // the rows are read before the next frame overwrites them
  }
}

}  // namespace

extern "C" int fk_compose_argmax(const float* lv, const float* ln, const int* vids,
                                 const int* nids, int* out, int B, int T, int n1, int n2,
                                 int n_act, void* stream) {
  const size_t smem = (size_t)n_act * sizeof(int) + (size_t)TILE * (n1 + n2) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)compose_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, B);
  compose_kernel<false><<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      lv, ln, vids, nids, nullptr, nullptr, out, nullptr, T, n1, n2, n_act, 0, 0.f, 0.f);
  return (int)cudaGetLastError();
}

extern "C" int fk_compose_blend(const float* lv, const float* ln, const int* vids,
                                const int* nids, const float* q, const int* act, int* pred,
                                int* fb, int B, int T, int n1, int n2, int n_act, int M,
                                float omw, float w, void* stream) {
  const size_t smem = (size_t)n_act * sizeof(int) + (size_t)TILE * (n1 + n2) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)compose_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, B);
  compose_kernel<true><<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      lv, ln, vids, nids, q, act, pred, fb, T, n1, n2, n_act, M, omw, w);
  return (int)cudaGetLastError();
}

extern "C" int fk_factored_argmax(const float* lv, const float* ln, const float* mvn,
                                  int* vstar, int B, int T, int n1, int n2, void* stream) {
  const int ldm = n2 | 1;  // odd: lanes on neighbouring verbs read distinct banks
  const size_t smem = ((size_t)n1 * ldm + (size_t)fk::kWarps * (n1 + n2)) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)factored_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + FTILE - 1) / FTILE, B);
  factored_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(lv, ln, mvn, vstar, T, n1,
                                                                      n2, ldm);
  return (int)cudaGetLastError();
}
