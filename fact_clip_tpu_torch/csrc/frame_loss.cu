// K5: the fused frame loss, class-weighted CE + clipped log-softmax smoothing.
//
// Replaces fact_clip_tpu/ops/pallas/frame_loss.py::_fwd_impl (_fwd_kernel)
// and ::_loss_bwd (_bwd_kernel).  For logits x (B, T, C), labels, a row mask
// mk and class weights w, with ls = log_softmax(x[t]) over the C classes:
//   ce[b] = sum_t -ls[t][label_t] * w[label_t] * mk[t]
//   sl[b] = sum_{t<T-1} sum_c clip((ls[t+1][c] - ls[t][c])^2, 0, 16) * mk[t] mk[t+1]
// and the backward writes dx from the per-video cotangents (gce, gsl):
//   g_pair[t] = (diff^2 <= 16) ? 2 gsl diff mk[t] mk[t+1] : 0, diff = ls[t+1] - ls[t]
//   dls[t] = g_pair[t-1] - g_pair[t] - gce w[label_t] mk[t] onehot(label_t)
//   dx[t] = dls - softmax(x[t]) * sum_c dls
// which is _bwd_kernel's arithmetic, the <= 16 test included.  C (75 or 40)
// is no multiple of the warp: lane c + 32 j holds class c + 32 j, and lanes
// past C stand out of every max, sum and write, as _ls_valid's masked lanes
// do on the TPU.
//
// The TPU kernel tiles the time axis and reads each tile's neighbour rows
// from strided boundary arrays.  Here a warp walks contiguous rows and keeps
// the previous and next rows' log-softmax in registers; the pair across its
// range's end recomputes the log-softmax of the next range's first row, as
// JAX reads one boundary row a tile.  Forward: one block per (64-row chunk,
// video), 8 rows a warp, each block's (ce, sl) partials (its warps' sums
// added in warp order) into a buffer, then a second launch adds each video's
// partials in chunk order: fixed orders, no atomics.  A block per video (16
// warps walking 192 rows each in series at T=3072) left most of the 132 SMs
// idle at B=8 and took 0.32 ms; 384 blocks hold every SM.  Backward: one
// block per (128 rows, video), 16 rows a warp, one launch.
//
// Bound on the H100: memory.  The forward reads B*T*C floats once (7.4 MB at
// B=8, T=3072, C=75, 2.3 us at 3.35 TB/s) and the backward reads them and
// writes dx; what the forward takes past that is each warp's chain of row
// reductions (warp shuffles) and its two launches.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int KMAX = 16;  // classes per lane: C <= 512
constexpr int FWD_ROWS = 8;  // rows per warp in the forward
constexpr int FWD_CHUNK = fk::kWarps * FWD_ROWS;  // rows of a forward block
constexpr int BWD_ROWS = 16;  // rows per warp in the backward

// log_softmax of one row: v[j] = ls[lane + 32 j] for valid classes, 0 past C
__device__ __forceinline__ void row_ls(const float* __restrict__ row, int C, int lane,
                                       float (&v)[KMAX]) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < C ? __ldg(row + c) : -INFINITY;
    mx = fmaxf(mx, v[j]);
  }
  mx = fk::warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (lane + 32 * j < C) s += expf(v[j] - mx);
  const float lse = mx + logf(fk::warp_sum(s));
#pragma unroll
  for (int j = 0; j < KMAX; ++j) v[j] = lane + 32 * j < C ? v[j] - lse : 0.f;
}

// per (FWD_CHUNK-row chunk, video): warp w walks rows [t_lo, t_lo + 8) of
// the chunk, the pair (t, t + 1) for each (t + 1 < T); the block's (ce, sl)
// into part[b][chunk][0..1]
__global__ void __launch_bounds__(fk::kThreads)
frame_loss_fwd_kernel(const float* __restrict__ x, const int* __restrict__ labels,
                      const float* __restrict__ mk, const float* __restrict__ cw,
                      float* __restrict__ part, int T, int C) {
  __shared__ float red[2][fk::kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * T * C;
  const float* mb = mk + (size_t)b * T;
  const int t_lo = blockIdx.x * FWD_CHUNK + w * FWD_ROWS;
  const int t_hi = min(T, t_lo + FWD_ROWS);
  float ce = 0.f, sl = 0.f;
  float cur[KMAX], nxt[KMAX];
  if (t_lo < t_hi) row_ls(xb + (size_t)t_lo * C, C, lane, cur);
  for (int t = t_lo; t < t_hi; ++t) {
    const float m = __ldg(mb + t);
    if (labels != nullptr) {
      const int l = __ldg(labels + (size_t)b * T + t);
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (lane + 32 * j == l) ce -= cur[j] * __ldg(cw + l) * m;
    }
    if (t + 1 < T) {
      row_ls(xb + (size_t)(t + 1) * C, C, lane, nxt);
      const float pm = m * __ldg(mb + t + 1);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        const float dd = nxt[j] - cur[j];
        sl += fminf(fmaxf(dd * dd, 0.f), 16.f) * pm;
        cur[j] = nxt[j];
      }
    }
  }
  ce = fk::warp_sum(ce);
  sl = fk::warp_sum(sl);
  if (lane == 0) {
    red[0][w] = ce;
    red[1][w] = sl;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = 0.f;
    for (int i = 0; i < fk::kWarps; ++i) v += red[threadIdx.x][i];
    part[((size_t)b * gridDim.x + blockIdx.x) * 2 + threadIdx.x] = v;
  }
}

// out[q * B + b] = the sum of video b's partials q (0: ce, 1: sl) in chunk order
__global__ void __launch_bounds__(fk::kThreads)
frame_loss_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int B,
                      int chunks) {
  const int i = blockIdx.x * fk::kThreads + threadIdx.x;
  if (i >= 2 * B) return;
  const float* p = part + (size_t)(i % B) * chunks * 2 + i / B;
  float v = 0.f;
  for (int c = 0; c < chunks; ++c) v += __ldg(p + 2 * c);
  out[i] = v;
}

__global__ void __launch_bounds__(256)
frame_loss_bwd_kernel(const float* __restrict__ x, const int* __restrict__ labels,
                      const float* __restrict__ mk, const float* __restrict__ cw,
                      const float* __restrict__ gce, const float* __restrict__ gsl,
                      float* __restrict__ dx, int T, int C) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int t_lo = blockIdx.x * 8 * BWD_ROWS + (threadIdx.x >> 5) * BWD_ROWS;
  const int t_hi = min(T, t_lo + BWD_ROWS);
  if (t_lo >= t_hi) return;
  const float* xb = x + (size_t)b * T * C;
  const float* mb = mk + (size_t)b * T;
  const float g_ce = gce != nullptr ? __ldg(gce + b) : 0.f;
  const float g_sl = __ldg(gsl + b);
  float prv[KMAX], cur[KMAX], nxt[KMAX];
  if (t_lo > 0) row_ls(xb + (size_t)(t_lo - 1) * C, C, lane, prv);
  row_ls(xb + (size_t)t_lo * C, C, lane, cur);
  for (int t = t_lo; t < t_hi; ++t) {
    const float m = __ldg(mb + t);
    const float pm_in = t > 0 ? m * __ldg(mb + t - 1) : 0.f;
    const float pm_out = t + 1 < T ? m * __ldg(mb + t + 1) : 0.f;
    if (t + 1 < T) row_ls(xb + (size_t)(t + 1) * C, C, lane, nxt);
    float dls[KMAX];
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      float gi = 0.f, go = 0.f;
      if (t > 0) {
        const float dd = cur[j] - prv[j];
        gi = dd * dd <= 16.f ? 2.f * g_sl * dd * pm_in : 0.f;
      }
      if (t + 1 < T) {
        const float dd = nxt[j] - cur[j];
        go = dd * dd <= 16.f ? 2.f * g_sl * dd * pm_out : 0.f;
      }
      dls[j] = lane + 32 * j < C ? gi - go : 0.f;
    }
    if (labels != nullptr) {
      const int l = __ldg(labels + (size_t)b * T + t);
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (lane + 32 * j == l) dls[j] -= g_ce * __ldg(cw + l) * m;
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) tot += dls[j];
    tot = fk::warp_sum(tot);
    float* drow = dx + ((size_t)b * T + t) * C;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int c = lane + 32 * j;
      if (c < C) drow[c] = dls[j] - expf(cur[j]) * tot;
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      prv[j] = cur[j];
      cur[j] = nxt[j];
    }
  }
}

int fwd_chunks(int T) { return T > 0 ? (T + FWD_CHUNK - 1) / FWD_CHUNK : 1; }

}  // namespace

// The workspace fk_frame_loss_fwd needs for B videos of T rows, for its
// callers: out[0] its floats, ce (B), sl (B), then the chunks' partials
// (B, ceil(T / FWD_CHUNK), 2).
extern "C" int fk_frame_loss_fwd_workspace(int B, int T, long long* out) {
  out[0] = 2LL * B * (1 + fwd_chunks(T));
  return 0;
}

// The forward into ws (fk_frame_loss_fwd_workspace's floats): ws[0:B] = ce,
// ws[B:2B] = sl (ce 0 without labels), summed from the chunks' partials.
extern "C" int fk_frame_loss_fwd(const float* x, const int* labels, const float* mk,
                                 const float* cw, float* ws, int B, int T, int C, void* stream) {
  if (C > 32 * KMAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = fwd_chunks(T);
  float* part = ws + 2 * (size_t)B;
  frame_loss_fwd_kernel<<<dim3(chunks, B), fk::kThreads, 0, st>>>(x, labels, mk, cw, part, T, C);
  frame_loss_sum_kernel<<<(2 * B + fk::kThreads - 1) / fk::kThreads, fk::kThreads, 0, st>>>(
      part, ws, B, chunks);
  return (int)cudaGetLastError();  // the first failed launch's error, if any
}

extern "C" int fk_frame_loss_bwd(const float* x, const int* labels, const float* mk,
                                 const float* cw, const float* gce, const float* gsl, float* dx,
                                 int B, int T, int C, void* stream) {
  if (C > 32 * KMAX) return (int)cudaErrorInvalidValue;
  dim3 grid((T + 8 * BWD_ROWS - 1) / (8 * BWD_ROWS), B);
  frame_loss_bwd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(x, labels, mk, cw, gce, gsl, dx,
                                                               T, C);
  return (int)cudaGetLastError();
}
