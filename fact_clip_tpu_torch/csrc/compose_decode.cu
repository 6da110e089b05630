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
// The composed argmax (redesigned for the H100): verb runs, two frames a
// lane.  Each block builds a run table from vids and nids in shared memory
// (the actions grouped by verb, runs padded to packs of 4, a 16-bit noun and
// a 16-bit action index an entry, 16 KB at epic scale; built anew in every
// call, so no cached table can go stale, and the ids need not be sorted).
// Rounding is monotone, so the best rounded sum among verb v's actions is
// S_v = fl(lv[v] + max over v's run of ln[nid]): pass 1 is one gather and
// one fmaxf a (frame, action), with no index kept.  Any action that reaches
// S* = max_v S_v lies in a run with S_v == S*, so pass 2 scans only those
// runs (about 39 actions at epic scale) for the lowest action index whose
// fl(lv + ln) equals S*: bit for bit the plain version's first argmax, ties
// included.  A block of 16 warps lives on each SM and walks tiles of 64
// frames, staged as contiguous as they lie in device memory by 16-byte
// cp.async, the next tile's rows arriving while it composes this one; half
// its warps build the table while the other half stage the first tile.
// Lane l holds frames l and l + 32: a table entry (one 8-byte read of four
// nouns) is one address across the warp, a broadcast, and the lanes' rows
// lie at the odd stride n2 (301 at epic scale), so each gather of one noun
// hits 32 banks.  The warps split the verbs by entries; each frame's pass 2
// goes to a group of 4 lanes anywhere in the block through a block-wide
// queue, whichever warp holds its best verb.  No shuffle reduction
// runs in pass 1.  The parent kernel (a block per 32 frames that staged the
// table again, two shared-memory gathers a (frame, action) at lane-varying
// addresses, two shuffle argmaxes a frame) took 0.077 ms at epic's 1 x
// 24,576.  Its floors: 39 MB of rows at 3.35 TB/s, 11.7 us; 24,576 x 3,806
// 4-byte gathers at 128 bytes a clock an SM on 132 SMs, ~12.6 us at
// 1.755 GHz, beside which the table reads and pass 2 come on top.
//
// Layout of the blend: one block of 8 warps per tile of 32 frames of one
// video.  The block stages the action table (vids | nids << 16, one int per
// action, 15 KB at epic scale) and the tile's lv and ln rows in shared
// memory.  Each warp owns 4 frames at once; its lanes stride over the
// actions, so a table entry read from shared memory serves 4 frames, and
// each lane keeps each frame's best (value, index) with a strict > (its
// lowest index among equal values).  A shuffle reduction that prefers the
// lower index on equal values ends each frame.  The blend reads the voting
// token's q row from device memory, coalesced across the lanes (the (300,
// 3,806) table, 4.6 MB a video, stays in L2).  The (T, n_act) composition
// never reaches device memory: the plain version materialises it, 374 MB
// for a 24,576-frame video.
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

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int FPW = 4;                  // frames a warp composes at once
constexpr int TILE = fk::kWarps * FPW;  // frames per block (blend)
constexpr int FTILE = 64;               // frames per block (factored)
constexpr int AM_TILE = 64;             // frames per tile of the composed argmax, two a lane
constexpr int AM_WARPS = 16;            // warps of an argmax block, each on a share of the verbs
constexpr int AM_QUEUE = 128;           // pass-2 items a tile (a frame's best in one warp or more)
constexpr int AM_GROUP = 4;             // lanes on one pass-2 item: the whole queue in one round
constexpr int AM_VERB_COST = 8;         // a verb's pass-1 cost past its entries, in entries

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

__global__ void __launch_bounds__(fk::kThreads)
blend_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
             const int* __restrict__ vids, const int* __restrict__ nids,
             const float* __restrict__ q, const int* __restrict__ act, int* __restrict__ out,
             int* __restrict__ fb, int T, int n1, int n2, int n_act, int M, float omw, float w) {
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
    const int f = min(f0 + j, rows - 1);
    qrow[j] = q + ((size_t)b * M + __ldg(act + row0 + f)) * n_act;
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
      const float p = __fadd_rn(__fmul_rn(omw, __ldg(qrow[j] + a)), __fmul_rn(w, expf(s)));
      if (p > bv[j] || bi[j] < 0) {
        bv[j] = p;
        bi[j] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < FPW; ++j) {
    warp_argmax(sv[j], si[j]);
    warp_argmax(bv[j], bi[j]);
    if (lane == 0 && f0 + j < rows) {
      out[row0 + f0 + j] = bi[j];
      fb[row0 + f0 + j] = si[j];
    }
  }
}

constexpr int AM_TABLE_THREADS = AM_WARPS / 2 * 32;  // threads that build the table

// the table warps' barrier (named barrier 1)
__device__ __forceinline__ void build_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(AM_TABLE_THREADS) : "memory");
}

// The runs' padded starts from the counts fill[v]: runs[v] and runs[n1] the
// total, fill[v] where v's entries go, then bnd: warp i takes verbs [bnd[i],
// bnd[i + 1]).  By the table warps (threads 0 to AM_TABLE_THREADS - 1); ends
// synchronised among them.
__device__ __forceinline__ void scan_runs(int n1, int* runs, int* fill, int* bnd) {
  const int tid = threadIdx.x;
  build_sync();
  if (tid < 32) {  // the exclusive sum of the padded counts, a chunk of verbs a lane
    const int per = (n1 + 31) / 32;
    const int v0 = min(n1, tid * per), v1 = min(n1, v0 + per);
    int sum = 0;
    for (int v = v0; v < v1; ++v) sum += (fill[v] + 3) & ~3;
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += u;
    }
    int at = incl - sum;
    for (int v = v0; v < v1; ++v) {
      const int c = (fill[v] + 3) & ~3;
      runs[v] = fill[v] = at;
      at += c;
    }
    if (tid == 31) runs[n1] = incl;
  }
  build_sync();
  // a verb costs its entries and AM_VERB_COST more (its loads and its S_v);
  // thread i finds bnd[i], the first verb whose cost reaches i / AM_WARPS of
  // the total, by bisection
  if (tid < AM_WARPS) {
    const int t = (int)((long long)tid * (runs[n1] + AM_VERB_COST * n1) / AM_WARPS);
    int lo = 0, hi = n1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (runs[mid] + AM_VERB_COST * mid >= t) hi = mid;
      else lo = mid + 1;
    }
    bnd[tid] = lo;
  }
  if (tid == 0) bnd[AM_WARPS] = n1;
  build_sync();
}

// The run table of the composed argmax, built by every block from vids and
// nids staged in shared memory (by the table warps, threads 0 to
// AM_TABLE_THREADS - 1, while the other warps stage the first tile; ends
// synchronised among them): the actions grouped by verb, run v in [runs[v],
// runs[v + 1]) of nid16 (its nouns) and act16 (its action indices), each run
// padded to a multiple of 4 entries with copies of its first.  Shared-memory
// atomics count and place the entries: lane l of a warp takes action l * L +
// j (L = ceil(n_act / 32)), so that a warp's 32 atomics fall on distinct
// verbs when the actions come sorted by verb; within a run the order is the
// atomics' (any order gives the same max and the same lowest index).  An
// action whose ids lie outside [0, n1) x [0, n2) is left out.
__device__ __forceinline__ void build_runs(const int* vids, const int* nids, int n1, int n2,
                                           int n_act, unsigned short* nid16,
                                           unsigned short* act16, int* runs, int* fill,
                                           int* bnd) {
  const int tid = threadIdx.x, lane = tid & 31;
  constexpr int nth = AM_TABLE_THREADS, nwarp = nth >> 5;
  const int L = (n_act + 31) / 32;
  for (int v = tid; v < n1; v += nth) fill[v] = 0;
  build_sync();
  for (int pass = 0; pass < 2; ++pass) {  // 0: count the runs; 1: place the entries
    for (int j = tid >> 5; j < L; j += nwarp) {
      const int a = lane * L + j;
      if (a >= n_act) continue;
      const int v = vids[a], n = nids[a];
      if (v < 0 || v >= n1 || n < 0 || n >= n2) continue;
      if (pass == 1) {
        const int at = atomicAdd(&fill[v], 1);
        nid16[at] = (unsigned short)n;
        act16[at] = (unsigned short)a;
      } else {
        atomicAdd(&fill[v], 1);
      }
    }
    if (pass == 0) scan_runs(n1, runs, fill, bnd);
  }
  build_sync();
  for (int v = tid; v < n1; v += nth)
    for (int s = fill[v]; s < runs[v + 1]; ++s) {
      nid16[s] = nid16[runs[v]];
      act16[s] = act16[runs[v]];
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Tile k's 64 frames (video k / tpv, frames 64 (k % tpv) ...) into dst by the
// block's threads: their lv rows, then from dst + ln_at their ln rows, each
// block of rows as contiguous in shared memory as in device memory, by
// 16-byte asynchronous copies (fk::cp_async_floats; the rows start off1 and
// off2 floats in, as the reader computes).  Frames past the video's end are
// not copied.
__device__ __forceinline__ void stage_tile(const float* __restrict__ lv,
                                           const float* __restrict__ ln, float* dst, int ln_at,
                                           int k, int tpv, int T, int n1, int n2,
                                           int t = threadIdx.x, int nt = blockDim.x) {
  const int b = k / tpv;
  const int f0 = (k - b * tpv) * AM_TILE;
  const int rows = min(AM_TILE, T - f0);
  const size_t row0 = (size_t)b * T + f0;
  fk::cp_async_floats(dst, lv + row0 * n1, rows * n1, t, nt);
  fk::cp_async_floats(dst + ln_at, ln + row0 * n2, rows * n2, t, nt);
}

// The best S_v of one frame (pass 1's state): the best value, how many verbs
// reach it, and the first four of them.
struct Best {
  float best = -INFINITY;
  int nt = 0, c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  __device__ __forceinline__ void add(float sv, int v) {
    if (nt == 0 || sv > best) {
      best = sv;
      nt = 1;
      c0 = v;
    } else if (sv == best) {
      c1 = nt == 1 ? v : c1;
      c2 = nt == 2 ? v : c2;
      c3 = nt == 3 ? v : c3;
      ++nt;
    }
  }
};

// Pass 2 for one frame by a group of G lanes (all 32 lanes call it; a group
// whose active is false has no frame): its value top and its best verbs (nt
// of them, the first four c0-c3; every verb of the share [vlo, vhi) past
// four ties); lvf and lnf the frame's lv and ln rows.  The group's lanes
// split each verb's run and reduce the lowest action index whose lv + ln
// rounds to top.
template <int G>
__device__ __forceinline__ int lowest_action(bool active, float top, int nt, int c0, int c1,
                                             int c2, int c3, const float* lvf, const float* lnf,
                                             const unsigned short* nid16,
                                             const unsigned short* act16, const int* runs,
                                             int vlo, int vhi) {
  const int r = threadIdx.x & (G - 1);
  int amin = 0x7fffffff;
  const int nv = !active ? 0 : nt <= 4 ? nt : vhi - vlo;
  for (int i = 0; i < nv; ++i) {
    const int v = nt > 4 ? vlo + i : i == 0 ? c0 : i == 1 ? c1 : i == 2 ? c2 : c3;
    const float lvv = lvf[v];
#pragma unroll 4
    for (int s = runs[v] + r; s < runs[v + 1]; s += G)
      if (lvv + lnf[nid16[s]] == top) amin = min(amin, (int)act16[s]);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) amin = min(amin, __shfl_xor_sync(0xffffffffu, amin, o));
  return amin;
}

// A frame's pass-2 item: frame | owner warp << 8 | min(nt, 255) << 16, c0 | c1
// << 16, c2 | c3 << 16, the bits of top.
__device__ __forceinline__ int4 pack_item(int f, int warp, const Best& p, float top) {
  return make_int4(f | warp << 8 | min(p.nt, 255) << 16, p.c0 | p.c1 << 16, p.c2 | p.c3 << 16,
                   __float_as_int(top));
}

// one table entry's two gathers: one address, the second frame's row d1b
// bytes on
#define FK_GATHER(e)                                                     \
  {                                                                      \
    const char* p_ = lnb0 + ((e) << 2);                                  \
    m0 = fmaxf(m0, *reinterpret_cast<const float*>(p_));                 \
    m1 = fmaxf(m1, *reinterpret_cast<const float*>(p_ + d1b));           \
  }

// The composed argmax, two frames a lane.  A block holds the run table and
// walks tiles of 64 frames, the next tile's rows arriving by cp.async while
// it composes this one; its AM_WARPS warps each take a share of the verbs
// (bnd).  Pass 1, for each verb v: S_v = lv[v] + the max of ln over the
// nouns of v's run, for both of the lane's frames (one table entry, two
// 4-byte gathers and two fmaxf an action), keeping the best S_v and up to
// four verbs that reach it.  S* = the largest of the warps' bests; pass 2,
// for each frame whose best a warp holds, has a group of AM_GROUP lanes
// split the runs of the verbs with S_v == S* (every verb of the warp's
// share past four ties) and reduce the lowest action index whose lv + ln
// rounds to S*.
__global__ void __launch_bounds__(AM_WARPS * 32)
compose_argmax_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
                      const int* __restrict__ vids, const int* __restrict__ nids,
                      int* __restrict__ out, int B, int T, int n1, int n2, int n_act,
                      int slots) {
  extern __shared__ float4 smem_raw[];
  unsigned short* nid16 = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* act16 = nid16 + slots;
  int* runs = reinterpret_cast<int*>(act16 + slots);
  int* fill = runs + n1 + 1;
  int* bnd = fill + n1;
  float2* xbest = reinterpret_cast<float2*>(smem_raw + (slots + 2 * n1 + AM_WARPS + 5) / 4);
  int4* queue = reinterpret_cast<int4*>(xbest + AM_WARPS * 32);  // pass 2's items
  int* amin = reinterpret_cast<int*>(queue + AM_QUEUE);           // [frame]
  int* nq = amin + AM_TILE;                                        // the items queued
  float* buf0 = reinterpret_cast<float*>(nq + 4);
  const int ln_at = (AM_TILE * n1 + 7) & ~3;       // a tile's ln rows, 16-byte aligned
  const int tile_floats = ln_at + ((AM_TILE * n2 + 7) & ~3);
  float* buf1 = buf0 + tile_floats;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tpv = (T + AM_TILE - 1) / AM_TILE;
  const int tiles = B * tpv;

  // the first half of the warps build the run table from the ids, staged in
  // the second tile buffer (free until the first prefetch; argmax_smem
  // refuses ids that do not fit there), while the others stage the first
  // tile's rows
  int k = blockIdx.x;
  if (threadIdx.x < AM_TABLE_THREADS) {
    const int ids_at = (n_act + 7) & ~3;  // nids after vids, 16-byte aligned
    const int* vs =
        reinterpret_cast<const int*>(buf1) +
        fk::cp_async_floats(buf1, reinterpret_cast<const float*>(vids), n_act, threadIdx.x,
                            AM_TABLE_THREADS);
    const int* ns =
        reinterpret_cast<const int*>(buf1 + ids_at) +
        fk::cp_async_floats(buf1 + ids_at, reinterpret_cast<const float*>(nids), n_act,
                            threadIdx.x, AM_TABLE_THREADS);
    cp_async_commit();
    fk::cp_async_wait_all();
    build_sync();
    build_runs(vs, ns, n1, n2, n_act, nid16, act16, runs, fill, bnd);
  } else {
    if (k < tiles)
      stage_tile(lv, ln, buf0, ln_at, k, tpv, T, n1, n2, threadIdx.x - AM_TABLE_THREADS,
                 blockDim.x - AM_TABLE_THREADS);
    cp_async_commit();
  }
  __syncthreads();
  const int vlo = bnd[warp], vhi = bnd[warp + 1];
  const uint2* tab4 = reinterpret_cast<const uint2*>(nid16);  // packs of 4 nouns

  for (int j = 0; k < tiles; ++j, k += gridDim.x) {
    if (k + (int)gridDim.x < tiles)
      stage_tile(lv, ln, (j & 1) ? buf0 : buf1, ln_at, k + gridDim.x, tpv, T, n1, n2);
    cp_async_commit();
    cp_async_wait_one();  // tile k's copies (this thread's) have landed
    if (threadIdx.x < AM_TILE) amin[threadIdx.x] = 0x7fffffff;
    if (threadIdx.x == 0) *nq = 0;
    __syncthreads();      // and every thread's
    const float* bufk = (j & 1) ? buf1 : buf0;
    const int b = k / tpv;
    const int f0 = (k - b * tpv) * AM_TILE;
    const int rows = min(AM_TILE, T - f0);
    // the tile's rows as stage_tile left them; a lane's frames lane, lane + 32
    const size_t row0 = (size_t)b * T + f0;
    const float* lvt = bufk + ((uintptr_t)(lv + row0 * n1) >> 2 & 3);
    const float* lnt = bufk + ln_at + ((uintptr_t)(ln + row0 * n2) >> 2 & 3);
    const float* lvr0 = lvt + lane * n1;
    const float* lnr0 = lnt + lane * n2;
    const char* lnb0 = reinterpret_cast<const char*>(lnr0);
    const int d1b = 32 * n2 * (int)sizeof(float);  // frame lane + 32's ln row

    Best p0, p1;
    for (int v = vlo; v < vhi; ++v) {
      const int q0 = runs[v] >> 2, q1 = runs[v + 1] >> 2;  // the run's packs of 4 entries
      if (q0 == q1) continue;  // a verb with no action
      float m0 = -INFINITY, m1 = -INFINITY;
      int q = q0;
      for (; q + 2 <= q1; q += 2) {  // two packs at once: eight gathers in flight
        const uint2 e = tab4[q], f = tab4[q + 1];
        FK_GATHER(e.x & 0xffffu) FK_GATHER(e.x >> 16) FK_GATHER(e.y & 0xffffu)
        FK_GATHER(e.y >> 16) FK_GATHER(f.x & 0xffffu) FK_GATHER(f.x >> 16)
        FK_GATHER(f.y & 0xffffu) FK_GATHER(f.y >> 16)
      }
      if (q < q1) {
        const uint2 e = tab4[q];
        FK_GATHER(e.x & 0xffffu) FK_GATHER(e.x >> 16) FK_GATHER(e.y & 0xffffu)
        FK_GATHER(e.y >> 16)
      }
      // rounding is monotone: the best rounded sum of v's actions
      p0.add(lvr0[v] + m0, v);
      p1.add(lvr0[v + 32 * n1] + m1, v);
    }
    xbest[warp * 32 + lane] = make_float2(p0.best, p1.best);
    __syncthreads();
    float2 top = xbest[lane];
#pragma unroll
    for (int i = 1; i < AM_WARPS; ++i) {
      const float2 o = xbest[i * 32 + lane];
      top = make_float2(fmaxf(top.x, o.x), fmaxf(top.y, o.y));
    }
    // pass 2: each frame whose best this warp holds becomes an item of the
    // block's queue (one atomic a warp), and the block's groups of AM_GROUP
    // lanes scan the items, one each, whichever warps hold them: in a
    // model's output consecutive frames share their best verb, so one warp
    // may hold the best of every frame of a tile.  A frame that finds no room
    // (ties across more than one warp for most frames) is scanned by its
    // own warp.
    const unsigned all = 0xffffffffu;
    const bool need0 = lane < rows && top.x != -INFINITY && p0.nt > 0 && p0.best == top.x;
    const bool need1 = lane + 32 < rows && top.y != -INFINITY && p1.nt > 0 && p1.best == top.y;
    const unsigned w0 = __ballot_sync(all, need0), w1 = __ballot_sync(all, need1);
    int at = 0;
    if (lane == 0 && (w0 | w1)) at = atomicAdd(nq, __popc(w0) + __popc(w1));
    at = __shfl_sync(all, at, 0);
    const unsigned below = (1u << lane) - 1;
    const int s0 = at + __popc(w0 & below), s1 = at + __popc(w0) + __popc(w1 & below);
    if (need0 && s0 < AM_QUEUE) queue[s0] = pack_item(lane, warp, p0, top.x);
    if (need1 && s1 < AM_QUEUE) queue[s1] = pack_item(lane + 32, warp, p1, top.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Best& p = h ? p1 : p0;
      const float t = h ? top.y : top.x;
      for (unsigned m = __ballot_sync(all, h ? need1 && s1 >= AM_QUEUE : need0 && s0 >= AM_QUEUE);
           m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int a = lowest_action<32>(
            true, __shfl_sync(all, t, src), __shfl_sync(all, p.nt, src),
            __shfl_sync(all, p.c0, src), __shfl_sync(all, p.c1, src), __shfl_sync(all, p.c2, src),
            __shfl_sync(all, p.c3, src), lvt + (src + 32 * h) * n1, lnt + (src + 32 * h) * n2,
            nid16, act16, runs, vlo, vhi);
        if (lane == 0) atomicMin(&amin[src + 32 * h], a);
      }
    }
    __syncthreads();
    const int items = min(*nq, AM_QUEUE);
    for (int i = warp * (32 / AM_GROUP) + lane / AM_GROUP; i < AM_QUEUE;
         i += AM_WARPS * (32 / AM_GROUP)) {
      const bool valid = i < items;
      const int4 it = valid ? queue[i] : make_int4(0, 0, 0, 0);
      const int f = it.x & 0xff, owner = (it.x >> 8) & 0xff;
      const int a = lowest_action<AM_GROUP>(valid, __int_as_float(it.w), it.x >> 16, it.y & 0xffff,
                                            it.y >> 16, it.z & 0xffff, it.z >> 16, lvt + f * n1,
                                            lnt + f * n2, nid16, act16, runs, bnd[owner],
                                            bnd[owner + 1]);
      if (valid && lane % AM_GROUP == 0) atomicMin(&amin[f], a);
    }
    __syncthreads();
    if (threadIdx.x < rows) {  // every action at -inf: the plain argmax picks the first
      const float t = warp == 0 ? top.x : top.y;
      out[(size_t)b * T + f0 + threadIdx.x] = t == -INFINITY ? 0 : amin[threadIdx.x];
    }
  }
}

#undef FK_GATHER

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

// Shared memory of a composed-argmax block, in bytes, and its table's entries
// (each run padded to a multiple of 4: at most 3 n1 more than n_act): the
// table, the run starts, the fill counts and the warps' bounds (padded to 16
// bytes), the warps' bests, pass 2's queue, the frames' picks and the queue's
// count, and two tiles' rows.
size_t argmax_smem(int n1, int n2, int n_act, int* slots) {
  *slots = (n_act + 3 * n1 + 3) & ~3;
  // the ids are staged in a tile's room (a vocabulary of many repeated pairs
  // may not fit there)
  if (2 * ((n_act + 7) & ~3) > ((AM_TILE * n1 + 7) & ~3) + ((AM_TILE * n2 + 7) & ~3))
    return ~(size_t)0;
  return 16 * (size_t)((*slots + 2 * n1 + AM_WARPS + 5) / 4) + 8 * (size_t)AM_WARPS * 32 +
         16 * (size_t)AM_QUEUE + 4 * (size_t)AM_TILE + 16 +
         8 * (size_t)(((AM_TILE * n1 + 7) & ~3) + ((AM_TILE * n2 + 7) & ~3));
}

// The resident blocks of the composed argmax on the current device (SMs x
// blocks an SM at this shared memory), asked once per (device, size).
cudaError_t argmax_blocks(size_t smem, int* blocks) {
  constexpr int kDevs = 64;
  static size_t sizes[kDevs];
  static int counts[kDevs];
  static std::mutex mu;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevs && sizes[dev] == smem) {
    *blocks = counts[dev];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compose_argmax_kernel,
                                                           AM_WARPS * 32, smem)) != cudaSuccess)
    return err;
  *blocks = sms * std::max(per_sm, 1);
  if (dev < kDevs) {
    sizes[dev] = smem;
    counts[dev] = *blocks;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int fk_compose_argmax(const float* lv, const float* ln, const int* vids,
                                 const int* nids, int* out, int B, int T, int n1, int n2,
                                 int n_act, void* stream) {
  if (n_act > 65535 || n1 > 32767 || n2 > 32767) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  int slots = 0;
  const size_t smem = argmax_smem(n1, n2, n_act, &slots);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = fk::set_smem((const void*)compose_argmax_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = argmax_blocks(smem, &blocks)) != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * ((T + AM_TILE - 1) / AM_TILE);
  const int grid = (int)std::min<long long>(tiles, (long long)blocks);
  compose_argmax_kernel<<<grid, AM_WARPS * 32, smem, (cudaStream_t)stream>>>(
      lv, ln, vids, nids, out, B, T, n1, n2, n_act, slots);
  return (int)cudaGetLastError();
}

extern "C" int fk_compose_blend(const float* lv, const float* ln, const int* vids,
                                const int* nids, const float* q, const int* act, int* pred,
                                int* fb, int B, int T, int n1, int n2, int n_act, int M,
                                float omw, float w, void* stream) {
  const size_t smem = (size_t)n_act * sizeof(int) + (size_t)TILE * (n1 + n2) * sizeof(float);
  cudaError_t err = fk::set_smem((const void*)blend_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, B);
  blend_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
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
