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
// from strided boundary arrays.  Forward: one block per (64-row chunk,
// video); a warp walks 8 contiguous rows and keeps the previous and next
// rows' log-softmax in registers, the pair across its range's end
// recomputing the log-softmax of the next range's first row, as JAX reads
// one boundary row a tile; each block's (ce, sl) partials (its warps' sums
// added in warp order) go into a buffer, then a second launch adds each
// video's partials in chunk order: fixed orders, no atomics.  A block per
// video (16 warps walking 192 rows each in series at T=3072) left most of
// the 132 SMs idle at B=8 and took 0.32 ms; 384 blocks hold every SM.
// Backward: one block per (64-row chunk, video), one launch.  The chunk's
// rows and one on each side (66 x 75 floats, 19.8 KB at the flagship's C)
// are contiguous in memory: the block stages them with 16-byte cp.async
// (scalar copies for the unaligned head and tail), their masks and labels
// with them, so that no row's log-softmax waits on a global load in a
// warp's chain.  Each staged row's log-softmax is then computed once, a
// warp a row, in place, and each of the chunk's rows takes its dx from the
// rows above and below it in shared memory, a warp a row, its lanes writing
// the row's contiguous floats.  A lane holds ceil(C / 32) class slots (a
// template argument, 3 at C = 75), not 16.  The parent kernel (a block per
// 128 rows, 16 rows walked in series a warp, each row's loads placed right
// before the reductions that needed them, 16 predicated slots a lane)
// took 0.057 ms at 8 x 3072 x 75.
//
// Bound on the H100: memory.  The forward reads B*T*C floats once (7.4 MB at
// B=8, T=3072, C=75, 2.3 us at 3.35 TB/s) and the backward reads them and
// writes dx (4.4 us); what each takes past that is its warps' chains of row
// reductions (warp shuffles) and its launches.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int KMAX = 16;  // classes per lane: C <= 512
constexpr int FWD_ROWS = 8;  // rows per warp in the forward
constexpr int FWD_CHUNK = fk::kWarps * FWD_ROWS;  // rows of a forward block
constexpr int BWD_CHUNK = 32;  // rows of a backward block

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

// per (BWD_CHUNK-row chunk, video): the chunk's rows and one on each side
// staged in shared memory, each staged row's log-softmax once (a warp a row,
// in place), then dx a warp a row from the staged rows; KS = ceil(C / 32)
// class slots a lane
template <int KS>
__global__ void __launch_bounds__(fk::kThreads)
frame_loss_bwd_kernel(const float* __restrict__ x, const int* __restrict__ labels,
                      const float* __restrict__ mk, const float* __restrict__ cw,
                      const float* __restrict__ gce, const float* __restrict__ gsl,
                      float* __restrict__ dx, int T, int C) {
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // (BWD_CHUNK + 2) * C + 4 floats: the rows
  float* ms = xs + (BWD_CHUNK + 2) * C + 4;         // BWD_CHUNK + 2 row masks
  int* lab = reinterpret_cast<int*>(ms + BWD_CHUNK + 2);  // BWD_CHUNK labels
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BWD_CHUNK;
  const int t1 = min(T, t0 + BWD_CHUNK);
  const int r_lo = max(0, t0 - 1);  // staged rows [r_lo, r_hi)
  const int r_hi = min(T, t1 + 1);
  const int n = (r_hi - r_lo) * C;
  // the rows at xr = xs + off, with their 16-byte boundaries on xs's
  float* const xr = xs + fk::cp_async_floats(xs, x + ((size_t)b * T + r_lo) * C, n);
  const size_t row0 = (size_t)b * T;
  for (int i = tid; i < r_hi - r_lo; i += fk::kThreads) ms[i] = __ldg(mk + row0 + r_lo + i);
  if (labels != nullptr)
    for (int i = tid; i < t1 - t0; i += fk::kThreads) lab[i] = __ldg(labels + row0 + t0 + i);
  const float g_ce = gce != nullptr ? __ldg(gce + b) : 0.f;
  const float g2 = 2.f * __ldg(gsl + b);
  fk::cp_async_wait_all();
  __syncthreads();

  // each staged row's log-softmax in place (lanes past C hold nothing)
  for (int r = w; r < r_hi - r_lo; r += fk::kWarps) {
    float* row = xr + r * C;
    float v[KS];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < C ? row[c] : -INFINITY;
      mx = fmaxf(mx, v[j]);
    }
    mx = fk::warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      if (lane + 32 * j < C) s += expf(v[j] - mx);
    const float lse = mx + logf(fk::warp_sum(s));
#pragma unroll
    for (int j = 0; j < KS; ++j)
      if (lane + 32 * j < C) row[lane + 32 * j] = v[j] - lse;
  }
  __syncthreads();

  // dx of the chunk's rows, a warp a row: the pair into t and the pair out of it
  for (int t = t0 + w; t < t1; t += fk::kWarps) {
    const int r = t - r_lo;
    const float* cur = xr + r * C;
    const float m = ms[r];
    const bool has_in = t > 0, has_out = t + 1 < T;
    const float pm_in = has_in ? m * ms[r - 1] : 0.f;
    const float pm_out = has_out ? m * ms[r + 1] : 0.f;
    const int l = labels != nullptr ? lab[t - t0] : -1;  // a label outside [0, C) adds no CE
    const float gl = l >= 0 && l < C ? g_ce * __ldg(cw + l) * m : 0.f;
    float ls[KS], dls[KS];
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int c = lane + 32 * j;
      dls[j] = 0.f;
      ls[j] = 0.f;
      if (c < C) {
        ls[j] = cur[c];
        float gi = 0.f, go = 0.f;
        if (has_in) {
          const float dd = ls[j] - cur[c - C];
          gi = dd * dd <= 16.f ? g2 * dd * pm_in : 0.f;
        }
        if (has_out) {
          const float dd = cur[c + C] - ls[j];
          go = dd * dd <= 16.f ? g2 * dd * pm_out : 0.f;
        }
        dls[j] = gi - go - (c == l ? gl : 0.f);
      }
      tot += dls[j];
    }
    tot = fk::warp_sum(tot);
    float* drow = dx + (row0 + t) * C;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int c = lane + 32 * j;
      if (c < C) drow[c] = dls[j] - expf(ls[j]) * tot;
    }
  }
}

template <int KS>
cudaError_t launch_bwd(const float* x, const int* labels, const float* mk, const float* cw,
                       const float* gce, const float* gsl, float* dx, int B, int T, int C,
                       cudaStream_t st) {
  const size_t smem = (2 * (size_t)BWD_CHUNK + 2 + (size_t)(BWD_CHUNK + 2) * C + 4) * 4;
  const cudaError_t err = fk::set_smem((const void*)frame_loss_bwd_kernel<KS>, smem);
  if (err != cudaSuccess) return err;
  frame_loss_bwd_kernel<KS><<<dim3((T + BWD_CHUNK - 1) / BWD_CHUNK, B), fk::kThreads, smem, st>>>(
      x, labels, mk, cw, gce, gsl, dx, T, C);
  return cudaGetLastError();
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
  if (B == 0 || T == 0 || C == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((C + 31) / 32) {
#define FK_BWD(KS) \
  case KS:         \
    return (int)launch_bwd<KS>(x, labels, mk, cw, gce, gsl, dx, B, T, C, st);
    FK_BWD(1) FK_BWD(2) FK_BWD(3) FK_BWD(4) FK_BWD(5) FK_BWD(6) FK_BWD(7) FK_BWD(8)
    FK_BWD(9) FK_BWD(10) FK_BWD(11) FK_BWD(12) FK_BWD(13) FK_BWD(14) FK_BWD(15) FK_BWD(16)
#undef FK_BWD
  }
  return (int)cudaErrorInvalidValue;
}
