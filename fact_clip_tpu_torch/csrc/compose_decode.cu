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
//   fk_factored_argmax: v*       = first argmax_v lv[v] + max_n (ln[n] + mvn[v, n])
//                       out[t]   = a_table[v*, first argmax_n ln[n] + mvn[v*, n]]
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
// call, so no cached table can go stale, and the ids need not be sorted; the
// ids staged in a tile's room, or read from device memory where many
// repeated pairs make them too many for it).
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
// 4-byte gathers at 128 bytes a clock an SM on 132 SMs, ~11.2 us at
// 1.98 GHz, beside which the table reads and pass 2 come on top.
//
// The composed argmax past the run table's shared memory (a vocabulary
// wider than n1 + n2 ~ 407 at epic's 3,806 actions), and the blend past its
// own or on a small vocabulary (below BL_GROUPED_ACTIONS): the tile form, one block of 8 warps per tile of 32 frames of one
// video (tile_kernel).  The block stages the action table (vids | nids << 16,
// one int per action) and the tile's lv and ln rows, 4 n_act + 128 (n1 + n2)
// bytes (ops/compose_decode.py::compose_smem); each warp owns 4 frames at
// once, its lanes stride over the actions, so a table entry read from shared
// memory serves 4 frames, and each lane keeps each frame's best (value,
// index) with a strict > (its lowest index among equal values); a shuffle
// reduction that prefers the lower index on equal values ends each frame.
// The blend's form reads the voting token's q row from device memory.  This
// was the only form of both before the run table and the token grouping (at
// epic's 1 x 24,576 the composed argmax took 0.077 ms, the blend 0.192).
//
// The blend (redesigned for the H100): frames grouped by their voting token.
// One library call, two launches.  blend_prep_kernel sorts each video's
// frames by token (a counting sort in shared memory with warp-private
// counts, one block a video) into runs of at most 32 frames that share a
// token (items), a block builds the composed argmax's run table
// (build_runs) into the workspace, and the others take each token's q row:
// each verb's largest q and the action of its largest (pruning's bounds).
// Then
// blend_runs_kernel: persistent blocks of 16 warps, one an SM at epic's
// 171 KB, each taking every grid-th item; an item's frames' lv and ln rows
// (the ln rows at an odd stride) and its token's q row (15.2 KB once for 32
// frames, not once a frame) arrive by cp.async into one of two buffers while
// the block works on the item before (its item and row indices further
// ahead).  A lane takes a frame, so a table entry and a q value are one
// address across the warp (broadcasts) and only the noun gather varies by
// lane; the warps split the verbs as the composed argmax's.
// Pass A: S_v = fl(lv[v] + max of ln over v's run) for each verb, the
// fallback's pass 1, which gives its S* and best verbs.  Pass B: for each
// verb, p = fl(q' + fl(w expf(fl(lv + ln)))) over its run, the plain
// version's roundings, and P_v = max p; the best P_v and up to four verbs
// that reach it.  Pass 2 (both outputs): the lowest action index of the
// best verbs' runs that reaches the top, through the block-wide queue.
// Exact pruning skips a verb's expf where it cannot hold the pick: its
// p's are at most UB_v = (Qv + w expf(S_v) (1 + 2^-16)) (1 + 2^-16) +
// 2^-126 (Qv: the max of q' over the run; expf is within 2 ulp of exp,
// CUDA's documented bound, so expf(s) <= expf(S_v) (1 + 2^-20) + 2^-146 for
// s <= S_v, and each of the three roundings adds at most 2^-24), while the
// best p is at least L = max(p at the token's best q' action, fl(w
// expf(S*))) (both actual p values or below one: q' >= 0).  A verb with
// UB_v < L for every frame of the warp is skipped: no action of it reaches
// or ties the best, so the picks are those of the exhaustive pass, bit for
// bit.  Pruning needs 0 <= w <= 1 (the host's flag) and q >= 0 (the first
// launch's flag per token); otherwise every expf runs.  The (T, n_act)
// composition never reaches device memory: the plain version materialises
// it, 374 MB for a 24,576-frame video.
//
// The factored argmax (redesigned for the H100): a lane a frame over a
// table of each verb's finite mask entries.  A persistent block of
// AM_WARPS warps lives on each SM and walks tiles of FC_TILE frames, staged
// as K7a stages its tiles (16-byte cp.async into two buffers, the next
// tile's rows arriving while the block works on this one; the ln rows at
// their own stride n2, odd at epic scale, so a gather of one noun across
// the lanes hits 32 banks).  Its prologue builds the table once for the
// block while the first tile's rows arrive, from one coalesced read of the
// dense mask: the entries that are not -inf set bits of a bitmap (kept,
// with each word's prefix count in its verb, in the second tile buffer,
// free until the first prefetch); K7a's scan_runs
// pads each verb's run to a multiple of 4 and splits the verbs among the
// warps by entries; each verb's run then takes (noun, value) in noun
// order, 16-bit nouns and f32 values, the padding copies of its first entry
// (max is idempotent).  Skipping the -inf entries is exact: ln + -inf =
// -inf never raises a max, and a verb with no entry scores -inf, which
// loses to any finite score.
// Pass 1, for the warp's verbs in increasing order: m = max over the run
// of fl(ln[n] + mvn[v, n]) (a table pack of 4 nouns and 4 values is one
// address across the warp, a broadcast; the ln gather varies by lane), then
// S_v = fl(lv[v] + m) and the first verb of the warp's best S_v by a strict
// >.  The warps' bests reduce in warp order (the lower warp holds the
// lower verbs), so v* is the plain version's first argmax; no verb above
// -inf: v* = 0, as torch.argmax picks.  Then the noun and action gathers of
// _factored_action in the same kernel: half a warp a frame scans v*'s run
// for the first noun of its max (the lowest noun among equal values), and
// out = a_table[v*, n*] (n* = 0 where v*'s run is empty, the plain argmax
// over an all -inf row).  A mask whose table outgrows the block's shared
// memory (more finite entries than ~20,000 at epic's widths) is read
// densely from device memory instead, a noun at a time, in the same
// passes.  The parent kernel (the dense 118 KB mask reloaded by each block
// of 64 frames, one frame a warp and each lane scanning all 301 nouns of its
// verbs) took 0.515 ms at epic's 1 x 24,576.
// Bound (chip_smoke.py::k7c_case): the rows read once (39 MB at epic's
// shape, 11.7 us at 3.35 TB/s) against two operations (an add and a max) a
// (frame, finite mask entry), 3,806 of the 29,498 pairs at epic's
// vocabulary: bytes-bound.
//
// Bound on the H100: device memory for the composed and factored argmaxes.
// At epic scale the kernels read the factored log-probs once, T * 399 * 4 B
// (39 MB at T = 24,576: 11.7 us at 3.35 TB/s), and do 2 (argmax) or 2 n2 /
// n_act * n1 (factored) operations per (frame, action) on the CUDA cores.
// The blend's tile form owes one expf a (frame, action): 93.5 M at epic's
// shape, 16 MUFU results a clock an SM on 132 SMs, ~22.4 us at 1.98 GHz,
// above its bytes; the token-grouped form owes those its bounds cannot skip.
#include <math.h>

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;     // a block's dynamic shared memory on sm_90
constexpr int FPW = 4;                  // frames a warp composes at once
constexpr int TILE = fk::kWarps * FPW;  // frames per block (blend)
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

// The tile form: 32 frames of one video a block (see the top).  BLEND:
// the blend into out and the composed argmax into fb; otherwise the composed
// argmax alone into fb (q, act and out unread).
template <bool BLEND>
__global__ void __launch_bounds__(fk::kThreads)
tile_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
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
    qrow[j] = BLEND ? q + ((size_t)b * M + __ldg(act + row0 + f)) * n_act : nullptr;
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
      if (BLEND) {
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
    if (BLEND) warp_argmax(bv[j], bi[j]);
    if (lane == 0 && f0 + j < rows) {
      if (BLEND) out[row0 + f0 + j] = bi[j];
      fb[row0 + f0 + j] = si[j];
    }
  }
}

constexpr int AM_TABLE_THREADS = AM_WARPS / 2 * 32;  // threads that build the table

// the table warps' barrier (named barrier 1), NTH threads
template <int NTH = AM_TABLE_THREADS>
__device__ __forceinline__ void build_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NTH) : "memory");
}

// The runs' padded starts from the counts fill[v]: runs[v] and runs[n1] the
// total, fill[v] where v's entries go, then bnd: warp i takes verbs [bnd[i],
// bnd[i + 1]).  By the table warps (threads 0 to AM_TABLE_THREADS - 1); ends
// synchronised among them.
template <int NTH>
__device__ __forceinline__ void scan_runs(int n1, int* runs, int* fill, int* bnd) {
  const int tid = threadIdx.x;
  build_sync<NTH>();
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
  build_sync<NTH>();
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
  build_sync<NTH>();
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
template <int NTH = AM_TABLE_THREADS>
__device__ __forceinline__ void build_runs(const int* vids, const int* nids, int n1, int n2,
                                           int n_act, unsigned short* nid16,
                                           unsigned short* act16, int* runs, int* fill,
                                           int* bnd) {
  const int tid = threadIdx.x, lane = tid & 31;
  constexpr int nth = NTH, nwarp = nth >> 5;
  const int L = (n_act + 31) / 32;
  for (int v = tid; v < n1; v += nth) fill[v] = 0;
  build_sync<NTH>();
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
    if (pass == 0) scan_runs<NTH>(n1, runs, fill, bnd);
  }
  build_sync<NTH>();
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

// Tile k's frames (tile of them, 64 by default: video k / tpv, frames tile
// (k % tpv) ...) into dst by threads t of nt: their lv rows, then from dst +
// ln_at their ln rows, each block of rows as contiguous in shared memory as
// in device memory, by 16-byte asynchronous copies (fk::cp_async_floats; the
// rows start off1 and off2 floats in, as the reader computes).  Frames past the video's end are
// not copied.
__device__ __forceinline__ void stage_tile(const float* __restrict__ lv,
                                           const float* __restrict__ ln, float* dst, int ln_at,
                                           int k, int tpv, int T, int n1, int n2,
                                           int t = threadIdx.x, int nt = blockDim.x,
                                           int tile = AM_TILE) {
  const int b = k / tpv;
  const int f0 = (k - b * tpv) * tile;
  const int rows = min(tile, T - f0);
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

// The blend's value of one action: fl(q' + fl(w expf(s))), q' = fl((1 - w) q)
// and s = fl(lv + ln), as the plain version rounds it.
__device__ __forceinline__ float blend_value(float qs, float w, float s) {
  return __fadd_rn(qs, __fmul_rn(w, expf(s)));
}

// Pass 2 for one frame by a group of G lanes (all 32 lanes call it; a group
// whose active is false has no frame): its value top and its best verbs (nt
// of them, the first four c0-c3; every verb of the share [vlo, vhi) past
// four ties); lvf and lnf the frame's lv and ln rows.  The group's lanes
// split each verb's run and reduce the lowest action index whose lv + ln
// rounds to top (BLEND: whose blend value is top, qs the token's q row, q' =
// fl(omw q)).
template <int G, bool BLEND = false>
__device__ __forceinline__ int lowest_action(bool active, float top, int nt, int c0, int c1,
                                             int c2, int c3, const float* lvf, const float* lnf,
                                             const unsigned short* nid16,
                                             const unsigned short* act16, const int* runs,
                                             int vlo, int vhi, const float* qs = nullptr,
                                             float w = 0.f, float omw = 0.f) {
  const int r = threadIdx.x & (G - 1);
  int amin = 0x7fffffff;
  const int nv = !active ? 0 : nt <= 4 ? nt : vhi - vlo;
  for (int i = 0; i < nv; ++i) {
    const int v = nt > 4 ? vlo + i : i == 0 ? c0 : i == 1 ? c1 : i == 2 ? c2 : c3;
    const float lvv = lvf[v];
#pragma unroll 4
    for (int s = runs[v] + r; s < runs[v + 1]; s += G) {
      const float val = BLEND ? blend_value(__fmul_rn(omw, qs[act16[s]]), w, lvv + lnf[nid16[s]])
                              : lvv + lnf[nid16[s]];
      if (val == top) amin = min(amin, (int)act16[s]);
    }
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
template <bool IDS_STAGED>
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
  // the second tile buffer (free until the first prefetch) where they fit
  // there (IDS_STAGED) and read from device memory where not, while the
  // others stage the first tile's rows
  int k = blockIdx.x;
  if (threadIdx.x < AM_TABLE_THREADS) {
    const int* vs = vids;
    const int* ns = nids;
    if (IDS_STAGED) {
      const int ids_at = (n_act + 7) & ~3;  // nids after vids, 16-byte aligned
      vs = reinterpret_cast<const int*>(buf1) +
           fk::cp_async_floats(buf1, reinterpret_cast<const float*>(vids), n_act, threadIdx.x,
                               AM_TABLE_THREADS);
      ns = reinterpret_cast<const int*>(buf1 + ids_at) +
           fk::cp_async_floats(buf1 + ids_at, reinterpret_cast<const float*>(nids), n_act,
                               threadIdx.x, AM_TABLE_THREADS);
      cp_async_commit();
      fk::cp_async_wait_all();
      build_sync();
    }
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

constexpr int BL_TILE = 32;         // frames of a blend item, one a lane, all sharing a token
constexpr int BL_WARPS = AM_WARPS;  // warps of a blend block: the composed argmax's verb shares
constexpr int BL_QUEUE = 128;       // pass-2 items a tile (both outputs)
constexpr int PREP_THREADS = 1024;  // threads of a block of the first launch
constexpr int PREP_KEYS = 640;      // tokens a sorting block counts at once (32 warps' counts)
constexpr int PREP_UNROLL = 8;      // frames a lane sorts at once
constexpr int PREP_QV_BLOCKS = 264; // blocks of the first launch on the tokens' Qv and seeds
constexpr float BL_MARGIN = 1.0000152587890625f;  // 1 + 2^-16, the pruning bound's slack
// actions below which the blend's tile form takes less device time than the
// token-grouped form (its block's latency grows with the actions, the
// token-grouped form's sort and per-item passes much less): at epic's 98
// verbs and 301 nouns the two cross at ~1,270 actions at 1,000 frames and
// at 24,576 alike (chip_dev.py k7k3-host)
constexpr int BL_GROUPED_ACTIONS = 1280;

// The blend's workspace, in ints (its size reported by fk_compose_blend_plan):
// the run table (slots 16-bit nouns, then slots 16-bit
// action indices), the run starts, the warps' verb bounds, the items of each
// video (int4: first entry of perm, frames, b * M + token; max_items =
// ceil(T / BL_TILE) + min(M, T) a video, the unused ones empty), perm (B *
// T: the frames' rows, grouped by token), the tokens' Qv (B * M * n1: the
// largest q of each verb's actions) and seeds (B * M int4: the verb and noun
// of the token's largest q, its bits, and whether pruning is off for it).
struct BlendWs {
  int runs, bnd, items, perm, qv, seeds, total, max_items;
  __host__ __device__ BlendWs(int B, int T, int n1, int M, int slots) {
    runs = slots;
    bnd = runs + n1 + 1;
    items = (bnd + BL_WARPS + 1 + 3) & ~3;
    max_items = (T + BL_TILE - 1) / BL_TILE + (M < T ? M : T);
    perm = items + 4 * B * max_items;
    qv = perm + B * T;
    seeds = (qv + B * M * n1 + 3) & ~3;
    total = seeds + 4 * B * M;
  }
};

// The blend's first launch.  Blocks b < B sort video b's frames by voting
// token (a counting sort, PREP_KEYS tokens at a time in shared memory; a warp
// whose 32 frames share a token takes one atomic) and write its items; block
// B builds the composed argmax's run table (build_runs, its first
// AM_TABLE_THREADS threads) into the workspace; the last PREP_QV_BLOCKS blocks
// take the tokens' q rows: each verb's largest q (Qv, the pruning bounds'
// q part: fl((1 - w) q) is monotone in q), and the action of the largest q
// (the lower bound's seed) with a flag where a q is below 0 or NaN (no
// pruning for that token).  Tokens outside [0, M) are read as the nearest
// (the plain version's gather would refuse them).
__global__ void __launch_bounds__(PREP_THREADS)
blend_prep_kernel(const int* __restrict__ act, const int* __restrict__ vids,
                  const int* __restrict__ nids, const float* __restrict__ q, int* __restrict__ ws,
                  int B, int T, int n1, int n2, int n_act, int M, int slots, int in_smem) {
  extern __shared__ float4 smem_raw[];
  const BlendWs L(B, T, n1, M, slots);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned all = 0xffffffffu;
  if (blockIdx.x == B) {
    unsigned short* nid16 = reinterpret_cast<unsigned short*>(smem_raw);
    unsigned short* act16 = nid16 + slots;
    int* runs = reinterpret_cast<int*>(act16 + slots);
    int* fill = runs + n1 + 1;
    int* bnd = fill + n1;
    build_runs<PREP_THREADS>(vids, nids, n1, n2, n_act, nid16, act16, runs, fill, bnd);
    __syncthreads();
    const int* tab = reinterpret_cast<const int*>(smem_raw);
    for (int i = tid; i < slots; i += PREP_THREADS) ws[i] = tab[i];
    for (int i = tid; i <= n1; i += PREP_THREADS) ws[L.runs + i] = runs[i];
    for (int i = tid; i <= BL_WARPS; i += PREP_THREADS) ws[L.bnd + i] = bnd[i];
    return;
  }
  if (blockIdx.x > B) {  // the tokens' Qv and seeds, a (video, token) row at a time
    int* qm = reinterpret_cast<int*>(smem_raw);           // [n1] the bits of each verb's max
    float2* wbest = reinterpret_cast<float2*>(qm + ((n1 + 1) & ~1));  // [32] warps' best
    float* qvo = reinterpret_cast<float*>(ws + L.qv);
    int4* seeds = reinterpret_cast<int4*>(ws + L.seeds);
    for (int r = blockIdx.x - B - 1; r < B * M; r += gridDim.x - B - 1) {
      const float* qr = q + (size_t)r * n_act;
      for (int v = tid; v < n1; v += PREP_THREADS) qm[v] = (int)0x80000000;
      __syncthreads();
      float bv = -INFINITY;
      int ba = 0x7fffffff, neg = 0;
      for (int a = tid; a < n_act; a += PREP_THREADS) {
        const int v = __ldg(vids + a), n = __ldg(nids + a);
        if (v < 0 || v >= n1 || n < 0 || n >= n2) continue;  // not in the run table
        const float x = __ldg(qr + a);
        neg |= !(x >= 0.f);
        atomicMax(&qm[v], __float_as_int(x));  // the order of non-negative floats' bits
        if (x > bv || (x == bv && a < ba)) {
          bv = x;
          ba = a;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(all, bv, o);
        const int oa = __shfl_xor_sync(all, ba, o);
        if (ov > bv || (ov == bv && oa < ba)) {
          bv = ov;
          ba = oa;
        }
      }
      if (lane == 0) wbest[warp] = make_float2(bv, __int_as_float(ba));
      neg = __syncthreads_or(neg);
      for (int v = tid; v < n1; v += PREP_THREADS) qvo[(size_t)r * n1 + v] = __int_as_float(qm[v]);
      if (warp == 0) {
        bv = wbest[lane].x;
        ba = __float_as_int(wbest[lane].y);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(all, bv, o);
          const int oa = __shfl_xor_sync(all, ba, o);
          if (ov > bv || (ov == bv && oa < ba)) {
            bv = ov;
            ba = oa;
          }
        }
        if (lane == 0)
          seeds[r] = ba == 0x7fffffff
                         ? make_int4(0, 0, 0, 1)
                         : make_int4(__ldg(vids + ba), __ldg(nids + ba), __float_as_int(bv), neg);
      }
      __syncthreads();
    }
    return;
  }
  // A counting sort of video b's frames by token with warp-private counts:
  // warp w takes the frames [w R, (w + 1) R), R = ceil(T / 32) in groups of
  // 32, and counts its own (a run of groups of one token is one add, else a
  // shared-memory atomic a frame on the warp's own counters); each token's
  // frames are laid out warp after warp; then each warp places its frames
  // group after group.  PREP_KEYS tokens at a time.
  const int b = blockIdx.x;
  const int kc = min(M, PREP_KEYS);                 // tokens counted at once
  int* wcnt = reinterpret_cast<int*>(smem_raw);     // [32][kc] the warps' counts, then places
  int* tok = wcnt + 32 * kc;                        // [kc] each token's frames, then first place
  int* ioff = tok + kc;                             // [kc + 1] each token's first item
  int2* wsum = reinterpret_cast<int2*>(wcnt + ((34 * kc + 2) & ~1));  // [33] warps' sums, total
  // in_smem: the video's perm in shared memory, copied out whole (coalesced:
  // scattered stores to device memory from one block cost more than its sort)
  int* perm = in_smem ? reinterpret_cast<int*>(wsum + 34) : ws + L.perm + (size_t)b * T;
  const int* actb = act + (size_t)b * T;
  int4* items = reinterpret_cast<int4*>(ws + L.items) + (size_t)b * L.max_items;
  const int R = ((T + 31) / 32 + 31) & ~31;          // a warp's frames
  const int f0 = min(T, warp * R), f1 = min(T, f0 + R);
  int* wc = wcnt + warp * kc;
  int fbase = 0, ibase = 0;  // frames and items of the tokens before this chunk
  for (int k0 = 0; k0 < M; k0 += kc) {
    const int nk = min(kc, M - k0);
    for (int i = tid; i < 32 * kc; i += PREP_THREADS) wcnt[i] = 0;
    __syncthreads();
    // this chunk's token of frame t, or -1; PREP_UNROLL groups' tokens at a
    // time (in place, so that key[] stays in registers)
#define FK_KEYS_AT(g, key)                                                   \
  _Pragma("unroll") for (int u = 0; u < PREP_UNROLL; ++u) {                  \
    const int t_ = (g) + 32 * u + lane;                                      \
    const int a_ = t_ < f1 ? min(max(__ldg(actb + t_), 0), M - 1) - k0 : -1; \
    key[u] = a_ >= 0 && a_ < nk ? a_ : -1;                                   \
  }
    int run = -1, run_n = 0;  // lane 0's run of whole groups of one token
    for (int g = f0; g < f1; g += 32 * PREP_UNROLL) {
      int key[PREP_UNROLL];
      FK_KEYS_AT(g, key)
#pragma unroll
      for (int u = 0; u < PREP_UNROLL; ++u) {
        const int lead = __shfl_sync(all, key[u], 0);
        if (__all_sync(all, key[u] == lead)) {
          if (lane == 0 && lead >= 0) {
            if (lead != run && run >= 0) wc[run] += run_n;
            run_n = lead == run ? run_n + 32 : 32;
            run = lead;
          }
        } else {
          if (lane == 0 && run >= 0) wc[run] += run_n;
          run = -1;
          __syncwarp();
          if (key[u] >= 0) atomicAdd(&wc[key[u]], 1);  // the warp's own counts
          __syncwarp();
        }
      }
    }
    if (lane == 0 && run >= 0) wc[run] += run_n;
    __syncthreads();
    // each token's frames laid out warp after warp: wc holds each warp's
    // first place within the token, tok the token's frames
    for (int k = tid; k < nk; k += PREP_THREADS) {
      int at = 0;
      for (int w2 = 0; w2 < 32; ++w2) {
        const int c = wcnt[w2 * kc + k];
        wcnt[w2 * kc + k] = at;
        at += c;
      }
      tok[k] = at;
    }
    __syncthreads();
    // exclusive scans of the frames and the items (ceil(tok / BL_TILE)) of
    // the chunk's tokens, a contiguous run of tokens a thread
    const int per = (nk + PREP_THREADS - 1) / PREP_THREADS;
    const int i0 = min(nk, tid * per), i1 = min(nk, i0 + per);
    int cs = 0, is = 0;
    for (int i = i0; i < i1; ++i) {
      cs += tok[i];
      is += (tok[i] + BL_TILE - 1) / BL_TILE;
    }
    int ci = cs, ii = is;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int uc = __shfl_up_sync(all, ci, o), ui = __shfl_up_sync(all, ii, o);
      if (lane >= o) {
        ci += uc;
        ii += ui;
      }
    }
    if (lane == 31) wsum[warp] = make_int2(ci, ii);
    __syncthreads();
    if (warp == 0) {
      const int2 v = wsum[lane];
      int wc2 = v.x, wi = v.y;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int uc = __shfl_up_sync(all, wc2, o), ui = __shfl_up_sync(all, wi, o);
        if (lane >= o) {
          wc2 += uc;
          wi += ui;
        }
      }
      __syncwarp();
      wsum[lane] = make_int2(wc2 - v.x, wi - v.y);
      if (lane == 31) wsum[32] = make_int2(wc2, wi);
    }
    __syncthreads();
    {
      int c_at = fbase + wsum[warp].x + ci - cs, i_at = wsum[warp].y + ii - is;
      for (int i = i0; i < i1; ++i) {
        const int c = tok[i];
        tok[i] = c_at;  // the token's first place in the video
        ioff[i] = i_at;
        c_at += c;
        i_at += (c + BL_TILE - 1) / BL_TILE;
      }
      if (tid == 0) ioff[nk] = wsum[32].y;
    }
    __syncthreads();
    // the chunk's items, a thread an item: its token by bisection of ioff
    for (int i = tid; i < wsum[32].y; i += PREP_THREADS) {
      int lo = 0, hi = nk - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (ioff[mid] <= i) lo = mid;
        else hi = mid - 1;
      }
      const int j = i - ioff[lo];
      const int c = (lo + 1 < nk ? tok[lo + 1] : fbase + wsum[32].x) - tok[lo];
      items[ibase + i] = make_int4(b * T + tok[lo] + j * BL_TILE, min(BL_TILE, c - j * BL_TILE),
                                   b * M + k0 + lo, 0);
    }
    // each warp's frames into their places, group after group (within a
    // group of several tokens in the order of the warp's own atomics)
    for (int g = f0; g < f1; g += 32 * PREP_UNROLL) {
      int key[PREP_UNROLL];
      FK_KEYS_AT(g, key)
#pragma unroll
      for (int u = 0; u < PREP_UNROLL; ++u) {
        const int lead = __shfl_sync(all, key[u], 0);
        int at;
        if (__all_sync(all, key[u] == lead)) {
          at = lead >= 0 ? tok[lead] + wc[lead] + lane : 0;
          __syncwarp();
          if (lane == 0 && lead >= 0) wc[lead] += 32;
        } else {
          at = key[u] >= 0 ? tok[key[u]] + atomicAdd(&wc[key[u]], 1) : 0;
        }
        if (key[u] >= 0) perm[at] = b * T + g + 32 * u + lane;
        __syncwarp();
      }
    }
    fbase += wsum[32].x;
    ibase += wsum[32].y;
    __syncthreads();
  }
  for (int i = ibase + tid; i < L.max_items; i += PREP_THREADS) items[i] = make_int4(0, 0, 0, 0);
  if (in_smem) {
    int* out = ws + L.perm + (size_t)b * T;
    for (int t = tid; t < T; t += PREP_THREADS) out[t] = perm[t];
  }
}

#undef FK_KEYS_AT

// The blend's second launch: persistent blocks of BL_WARPS warps, block i
// taking item slots i, i + grid, ... of the first launch's list.  Its copies
// run three items ahead as 4- and 16-byte cp.async, one group an item: the
// slot's item (start, frames, key) three ahead, its frames' rows of perm two
// ahead, and one ahead the frames' lv and ln rows (odd row strides), the
// token's q row in table order, its Qv and seed, into the other of nbuf = 2
// buffers (nbuf = 1, where two do not fit in shared memory: after the item's
// passes).  Shared memory (blend_smem): the run
// table, the run starts and verb bounds, S_v per (verb, frame), the nbuf
// buffers, the item and row rings, the warps' bests of both passes, pass 2's
// queue, the frames' picks of both outputs and the queue's count.
__global__ void __launch_bounds__(BL_WARPS * 32)
blend_runs_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
                  const float* __restrict__ q, int* __restrict__ pred, int* __restrict__ fb,
                  const int* __restrict__ ws, int B, int T, int n1, int n2, int n_act, int M,
                  int slots, int nbuf, float omw, float w, int prune) {
  extern __shared__ float4 smem_raw[];
  const BlendWs L(B, T, n1, M, slots);
  // lv rows at a stride of 16 bytes, each at its source's 16-byte phase (a
  // lane reads its lv once a verb: bank conflicts there cost little); ln rows
  // at an odd stride (every (frame, action) gathers one: 32 banks)
  const int ldv = (n1 + 3 + 3) & ~3, ldn = n2 | 1, ldq = (n_act + 3 + 3) & ~3;
  const int buf_floats = 4 + ldq + ((n1 + 3) & ~3) + 32 * (ldv + ldn);
  unsigned short* nid16 = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* act16 = nid16 + slots;
  int* runs = reinterpret_cast<int*>(smem_raw) + slots;
  int* bnd = runs + n1 + 1;
  float* sv = reinterpret_cast<float*>(runs + ((n1 + BL_WARPS + 5) & ~3));  // [n1][32] S_v
  float* bufs = sv + 32 * n1;  // nbuf x [seed int4 | the token's q row | Qv | lv rows | ln rows]
  int4* meta = reinterpret_cast<int4*>(bufs + nbuf * buf_floats);  // [4] the items ahead
  int* prow = reinterpret_cast<int*>(meta + 4);                     // [3][32] their rows
  float* xs = reinterpret_cast<float*>(prow + 96);                  // [BL_WARPS][32] pass A
  float* xp = xs + BL_WARPS * 32;                                   // [BL_WARPS][32] pass B
  int4* queue = reinterpret_cast<int4*>(xp + BL_WARPS * 32);        // [BL_QUEUE]
  int* amin = reinterpret_cast<int*>(queue + BL_QUEUE);             // [2][32]: blend, fallback
  int* nq = amin + 64;                                              // the queue's count
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned all = 0xffffffffu;
  const int total = B * L.max_items;
  const int4* items = reinterpret_cast<const int4*>(ws + L.items);
  const int* perm = ws + L.perm;
  const float* qvg = reinterpret_cast<const float*>(ws + L.qv);
  const int4* seeds = reinterpret_cast<const int4*>(ws + L.seeds);
  auto slot = [&](int j) { return blockIdx.x + j * gridDim.x; };
  auto buf = [&](int j) { return bufs + (nbuf == 2 ? (j & 1) : 0) * buf_floats; };
  // the copies of item j's stages (each thread its share; no wait)
  auto get_meta = [&](int j) {
    if (tid == 0 && slot(j) < total) fk::cp_async<16>(&meta[j & 3], items + slot(j), true);
  };
  auto get_rows = [&](int j) {
    const int4 m = meta[j & 3];
    if (slot(j) < total && tid < m.y) fk::cp_async<4>(&prow[(j % 3) * 32 + tid], perm + m.x + tid, true);
  };
  auto get_data = [&](int j) {
    const int4 m = meta[j & 3];
    if (slot(j) >= total || m.y == 0) return;
    float* bb = buf(j);
    float* bq = bb + 4;
    float* bqv = bq + ldq;
    float* bl = bqv + ((n1 + 3) & ~3);
    float* bn = bl + 32 * ldv;
    const int* pr = prow + (j % 3) * 32;
    for (int f = warp; f < m.y; f += BL_WARPS) {
      const size_t row = (size_t)pr[f];
      fk::cp_async_floats(bl + f * ldv, lv + row * n1, n1, lane, 32);
      for (int i = lane; i < n2; i += 32) fk::cp_async<4>(bn + f * ldn + i, ln + row * n2 + i, true);
    }
    fk::cp_async_floats(bq, q + (size_t)m.z * n_act, n_act);
    for (int i = tid; i < n1; i += BL_WARPS * 32)
      fk::cp_async<4>(bqv + i, qvg + (size_t)m.z * n1 + i, true);
    if (tid == 0) fk::cp_async<16>(bb, seeds + m.z, true);
  };

  // the run table, the run starts and the bounds, as the first launch left
  // them; the first items' stages
  fk::cp_async_floats(reinterpret_cast<float*>(smem_raw), reinterpret_cast<const float*>(ws),
                      slots);
  fk::cp_async_floats(reinterpret_cast<float*>(runs),
                      reinterpret_cast<const float*>(ws + L.runs), n1 + BL_WARPS + 2);
  get_meta(0);
  get_meta(1);
  get_meta(2);
  cp_async_commit();
  fk::cp_async_wait_all();
  __syncthreads();
  get_rows(0);
  get_rows(1);
  cp_async_commit();
  fk::cp_async_wait_all();
  __syncthreads();
  get_data(0);
  cp_async_commit();
  const int vlo = bnd[warp], vhi = bnd[warp + 1];
  const uint2* tab4 = reinterpret_cast<const uint2*>(nid16);  // packs of 4 nouns
  const uint2* act4 = reinterpret_cast<const uint2*>(act16);  // packs of 4 action indices

  for (int j = 0; slot(j) < total; ++j) {
    fk::cp_async_wait_all();  // item j's data, j + 1's rows, j + 2's item
    __syncthreads();          // (every thread's), and item j - 1 is done
    get_meta(j + 3);
    get_rows(j + 2);
    if (nbuf == 2) get_data(j + 1);
    cp_async_commit();
    const int cnt = meta[j & 3].y;
    if (cnt == 0) {  // an empty slot
      if (nbuf == 1) {
        get_data(j + 1);
        cp_async_commit();
      }
      continue;
    }
    const float* bb = buf(j);
    const int4 seed = *reinterpret_cast<const int4*>(bb);
    const float* bqv = bb + 4 + ldq;
    const float* lvt = bqv + ((n1 + 3) & ~3);  // the item's lv rows, each at its phase
    const float* lnt = lvt + 32 * ldv;
    const int* pr = prow + (j % 3) * 32;
    const bool active = lane < cnt;
    // the token's raw q row (q' = fl(omw q) where used), at its source's phase
    const float* bq = bb + 4 + ((uintptr_t)(q + (size_t)meta[j & 3].z * n_act) >> 2 & 3);
    const float* lvr = lvt + lane * ldv +  // the lane's frame
                       (active ? ((uintptr_t)(lv + (size_t)pr[lane] * n1) >> 2 & 3) : 0);
    const float* lnr = lnt + lane * ldn;
    if (tid < 64) amin[tid] = 0x7fffffff;
    if (tid == 0) *nq = 0;

    // pass A: S_v of each verb of the warp's share, the fallback's pass 1
    Best pa;
    for (int v = vlo; v < vhi; ++v) {
      const int q0 = runs[v] >> 2, q1 = runs[v + 1] >> 2;
      if (q0 == q1) continue;  // a verb with no action
      float m0 = -INFINITY, m1 = -INFINITY;
      int qq = q0;
      for (; qq + 2 <= q1; qq += 2) {
        const uint2 e = tab4[qq], f = tab4[qq + 1];
        m0 = fmaxf(m0, lnr[e.x & 0xffffu]);
        m1 = fmaxf(m1, lnr[e.x >> 16]);
        m0 = fmaxf(m0, lnr[e.y & 0xffffu]);
        m1 = fmaxf(m1, lnr[e.y >> 16]);
        m0 = fmaxf(m0, lnr[f.x & 0xffffu]);
        m1 = fmaxf(m1, lnr[f.x >> 16]);
        m0 = fmaxf(m0, lnr[f.y & 0xffffu]);
        m1 = fmaxf(m1, lnr[f.y >> 16]);
      }
      if (qq < q1) {
        const uint2 e = tab4[qq];
        m0 = fmaxf(m0, lnr[e.x & 0xffffu]);
        m1 = fmaxf(m1, lnr[e.x >> 16]);
        m0 = fmaxf(m0, lnr[e.y & 0xffffu]);
        m1 = fmaxf(m1, lnr[e.y >> 16]);
      }
      const float S = lvr[v] + fmaxf(m0, m1);  // rounding is monotone: v's best rounded sum
      sv[v * 32 + lane] = S;
      pa.add(S, v);
    }
    xs[warp * 32 + lane] = pa.best;
    __syncthreads();
    float top_s = xs[lane];
#pragma unroll
    for (int i = 1; i < BL_WARPS; ++i) top_s = fmaxf(top_s, xs[i * 32 + lane]);

    // the lower bound of the frame's best blend value: the value at the
    // token's largest q, and fl(w expf(S*)) (see the top)
    const bool pruning = prune && seed.w == 0;
    float low = -INFINITY;
    if (pruning)
      low = fmaxf(blend_value(__fmul_rn(omw, __int_as_float(seed.z)), w,
                              lvr[seed.x] + lnr[seed.y]),
                  __fmul_rn(w, expf(top_s)));

    // pass B: the blend over the runs of the warp's share, a verb skipped
    // where no frame of the warp can take its pick from it
    Best pb;
    for (int v = vlo; v < vhi; ++v) {
      const int q0 = runs[v] >> 2, q1 = runs[v + 1] >> 2;
      if (q0 == q1) continue;
      if (pruning) {
        const float qvv = __fmul_rn(omw, bqv[v]);  // the run's largest q'
        const float ub = __fadd_rn(
            __fmul_rn(__fadd_rn(qvv, __fmul_rn(__fmul_rn(w, expf(sv[v * 32 + lane])), BL_MARGIN)),
                      BL_MARGIN),
            1.17549435e-38f);
        if (!__any_sync(all, active && !(ub < low))) continue;
      }
      const float lvv = lvr[v];
      float m0 = -INFINITY, m1 = -INFINITY;
      for (int qq = q0; qq < q1; ++qq) {
        const uint2 e = tab4[qq], a = act4[qq];
        m0 = fmaxf(m0, blend_value(__fmul_rn(omw, bq[a.x & 0xffffu]), w, lvv + lnr[e.x & 0xffffu]));
        m1 = fmaxf(m1, blend_value(__fmul_rn(omw, bq[a.x >> 16]), w, lvv + lnr[e.x >> 16]));
        m0 = fmaxf(m0, blend_value(__fmul_rn(omw, bq[a.y & 0xffffu]), w, lvv + lnr[e.y & 0xffffu]));
        m1 = fmaxf(m1, blend_value(__fmul_rn(omw, bq[a.y >> 16]), w, lvv + lnr[e.y >> 16]));
      }
      pb.add(fmaxf(m0, m1), v);
    }
    xp[warp * 32 + lane] = pb.best;
    __syncthreads();
    float top_p = xp[lane];
#pragma unroll
    for (int i = 1; i < BL_WARPS; ++i) top_p = fmaxf(top_p, xp[i * 32 + lane]);

    // pass 2, both outputs: each frame whose best this warp holds becomes
    // an item of the block's queue; what finds no room is scanned by its
    // own warp
    const bool need_p = active && top_p != -INFINITY && pb.nt > 0 && pb.best == top_p;
    const bool need_s = active && top_s != -INFINITY && pa.nt > 0 && pa.best == top_s;
    const unsigned wp = __ballot_sync(all, need_p), wsb = __ballot_sync(all, need_s);
    int at = 0;
    if (lane == 0 && (wp | wsb)) at = atomicAdd(nq, __popc(wp) + __popc(wsb));
    at = __shfl_sync(all, at, 0);
    const unsigned below = (1u << lane) - 1;
    const int sp = at + __popc(wp & below), ss = at + __popc(wp) + __popc(wsb & below);
    if (need_p && sp < BL_QUEUE) queue[sp] = pack_item(lane, warp, pb, top_p);
    if (need_s && ss < BL_QUEUE) queue[ss] = pack_item(lane | 32, warp, pa, top_s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Best& p = h ? pa : pb;
      const float t = h ? top_s : top_p;
      for (unsigned m = __ballot_sync(all, h ? need_s && ss >= BL_QUEUE : need_p && sp >= BL_QUEUE);
           m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float tt = __shfl_sync(all, t, src);
        const int nt = __shfl_sync(all, p.nt, src), c0 = __shfl_sync(all, p.c0, src),
                  c1 = __shfl_sync(all, p.c1, src), c2 = __shfl_sync(all, p.c2, src),
                  c3 = __shfl_sync(all, p.c3, src);
        const float* lvf = lvt + src * ldv + ((uintptr_t)(lv + (size_t)pr[src] * n1) >> 2 & 3);
        const float* lnf = lnt + src * ldn;
        const int a = h ? lowest_action<32>(true, tt, nt, c0, c1, c2, c3, lvf, lnf, nid16, act16,
                                            runs, vlo, vhi)
                        : lowest_action<32, true>(true, tt, nt, c0, c1, c2, c3, lvf, lnf, nid16,
                                                  act16, runs, vlo, vhi, bq, w, omw);
        if (lane == 0) atomicMin(&amin[h * 32 + src], a);
      }
    }
    __syncthreads();
    const int items_q = min(*nq, BL_QUEUE);
    for (int i = warp * (32 / AM_GROUP) + lane / AM_GROUP; i < BL_QUEUE;
         i += BL_WARPS * (32 / AM_GROUP)) {
      const bool valid = i < items_q;
      const int4 iq = valid ? queue[i] : make_int4(0, 0, 0, 0);
      const int f = iq.x & 31, h = (iq.x >> 5) & 1, owner = (iq.x >> 8) & 0xff;
      const float* lvf = lvt + f * ldv + ((uintptr_t)(lv + (size_t)pr[f] * n1) >> 2 & 3);
      const float* lnf = lnt + f * ldn;
      const int a =
          h ? lowest_action<AM_GROUP>(valid, __int_as_float(iq.w), iq.x >> 16, iq.y & 0xffff,
                                      iq.y >> 16, iq.z & 0xffff, iq.z >> 16, lvf, lnf, nid16,
                                      act16, runs, bnd[owner], bnd[owner + 1])
            : lowest_action<AM_GROUP, true>(valid, __int_as_float(iq.w), iq.x >> 16,
                                            iq.y & 0xffff, iq.y >> 16, iq.z & 0xffff, iq.z >> 16,
                                            lvf, lnf, nid16, act16, runs, bnd[owner],
                                            bnd[owner + 1], bq, w, omw);
      if (valid && lane % AM_GROUP == 0) atomicMin(&amin[h * 32 + f], a);
    }
    __syncthreads();
    if (nbuf == 1) {  // the buffer is read: the next item's data into it
      get_data(j + 1);
      cp_async_commit();
    }
    if (warp == 0 && active) {  // every value at -inf: the plain argmax picks the first
      const int row = pr[lane];
      pred[row] = top_p == -INFINITY ? 0 : amin[lane];
      fb[row] = top_s == -INFINITY ? 0 : amin[32 + lane];
    }
  }
}

constexpr int FC_TILE = 32;  // frames of a factored tile, one a lane
constexpr int FC_LOADS = 16;  // 16-byte mask loads a thread keeps in flight in the prologue

// The factored argmax's shared memory: the two tile buffers (floats each),
// the run starts, fill counts and warp bounds, the warps' bests, and a
// table of cap (noun, value) slots in what is left of the block's
// kMaxSmem bytes.  False where the tiles, or the prologue's bitmap and its
// words' prefix counts in the second buffer, do not fit.
struct FactoredLayout {
  int tile_floats, ln_at, ints_at, best_at, val_at, cap;
  size_t bytes;
  bool ok;
  __host__ __device__ FactoredLayout(int n1, int n2) {
    ln_at = (FC_TILE * n1 + 7) & ~3;
    tile_floats = ln_at + ((FC_TILE * n2 + 7) & ~3);
    ints_at = 2 * tile_floats;
    best_at = ints_at + ((2 * n1 + AM_WARPS + 2 + 3) & ~3);
    val_at = best_at + 2 * AM_WARPS * FC_TILE;
    const long long left = (long long)kMaxSmem - 4LL * val_at;
    cap = left > 0 ? (int)(left / 6) & ~7 : 0;
    bytes = 4 * (size_t)val_at + 6 * (size_t)cap;
    ok = cap >= 8 && 2LL * n1 * ((n2 + 31) / 32) <= tile_floats;
  }
};

// The factored argmax, a lane a frame (see the top): the table built once a
// block, then tiles of FC_TILE frames, pass 1 over each warp's verbs, the
// warps' bests, and v*'s noun and action by half a warp a frame.
__global__ void __launch_bounds__(AM_WARPS * 32)
factored_kernel(const float* __restrict__ lv, const float* __restrict__ ln,
                const float* __restrict__ mvn, const int* __restrict__ atab,
                int* __restrict__ out, int B, int T, int n1, int n2) {
  extern __shared__ float4 smem_raw[];
  const FactoredLayout L(n1, n2);
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + L.tile_floats;
  int* runs = reinterpret_cast<int*>(buf0 + L.ints_at);
  int* fill = runs + n1 + 1;
  int* bnd = fill + n1;
  float2* xbest = reinterpret_cast<float2*>(buf0 + L.best_at);  // (best, verb bits) [warp][frame]
  float* mval = buf0 + L.val_at;
  unsigned short* nid16 = reinterpret_cast<unsigned short*>(mval + L.cap);
  unsigned* bits = reinterpret_cast<unsigned*>(buf1);  // the prologue's bitmap (n1, W)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned all = 0xffffffffu;
  const int W = (n2 + 31) / 32;
  const int tpv = (T + FC_TILE - 1) / FC_TILE;
  const int tiles = B * tpv;

  // the entries above -inf as a bitmap, from one coalesced read of the mask
  // (16-byte loads, FC_LOADS of them in flight a thread; the first ones
  // requested before the first tile's rows, so as not to queue behind them)
  const int nw = n1 * W, total = n1 * n2;
  unsigned* pre = bits + nw;  // [v * W + w]: the entries of v's words before w
  for (int i = threadIdx.x; i < nw; i += blockDim.x) bits[i] = 0u;
  const int head = min(total, (int)((16 - ((uintptr_t)mvn & 15)) & 15) >> 2);
  const int nv = (total - head) >> 2;  // 16-byte pieces after the head
  const float4* mv4 = reinterpret_cast<const float4*>(mvn + head);
  float4 m[FC_LOADS];
  auto load = [&](int p0) {
#pragma unroll
    for (int u = 0; u < FC_LOADS; ++u) {
      const int p = p0 + u * blockDim.x;
      m[u] = p < nv ? __ldg(mv4 + p) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  };
  load(threadIdx.x);
  // the first tile's rows start on their way into buf0 while the block builds its table
  int k = blockIdx.x;
  if (k < tiles) stage_tile(lv, ln, buf0, L.ln_at, k, tpv, T, n1, n2, threadIdx.x, blockDim.x,
                            FC_TILE);
  cp_async_commit();
  __syncthreads();  // the bitmap is zeroed
  auto mark = [&](int v, int n, float x) {  // entry (v, n), n possibly past the row's end
    if (x != -INFINITY) {
      while (n >= n2) {
        ++v;
        n -= n2;
      }
      atomicOr(&bits[v * W + (n >> 5)], 1u << (n & 31));
    }
  };
  for (int i = threadIdx.x; i < head; i += blockDim.x) mark(i / n2, i % n2, __ldg(mvn + i));
  for (int i = head + 4 * nv + threadIdx.x; i < total; i += blockDim.x)
    mark(i / n2, i % n2, __ldg(mvn + i));
  for (int p0 = threadIdx.x; p0 < nv; p0 += FC_LOADS * blockDim.x) {
    if (p0 != (int)threadIdx.x) load(p0);
#pragma unroll
    for (int u = 0; u < FC_LOADS; ++u) {
      const int i = head + 4 * (p0 + u * blockDim.x);
      const int v = i / n2, n = i - v * n2;  // one division a piece
      mark(v, n, m[u].x);
      mark(v, n + 1, m[u].y);
      mark(v, n + 2, m[u].z);
      mark(v, n + 3, m[u].w);
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n1; v += blockDim.x) {
    unsigned c = 0;
    for (int w = 0; w < W; ++w) {
      pre[v * W + w] = c;
      c += __popc(bits[v * W + w]);
    }
    fill[v] = (int)c;
  }
  scan_runs<AM_WARPS * 32>(n1, runs, fill, bnd);
  const bool dense = runs[n1] > L.cap;  // the table does not fit: the mask from device memory
  if (!dense) {
    // each run's entries in noun order, a thread a bitmap word (the values
    // read again from the mask), then its padding
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      const int v = i / W, n0 = (i - v * W) * 32;
      int at = runs[v] + (int)pre[i];
      for (unsigned m = bits[i]; m != 0u; m &= m - 1u, ++at) {
        const int n = n0 + __ffs(m) - 1;
        nid16[at] = (unsigned short)n;
        mval[at] = __ldg(mvn + (size_t)v * n2 + n);
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < n1; v += blockDim.x) {
      const int end = runs[v] + (int)pre[v * W + W - 1] + __popc(bits[v * W + W - 1]);
      for (int s2 = end; s2 < runs[v + 1]; ++s2) {
        nid16[s2] = nid16[runs[v]];
        mval[s2] = mval[runs[v]];
      }
    }
  }
  __syncthreads();  // the table is built; buf1 (the bitmap) is free
  const int vlo = bnd[warp], vhi = bnd[warp + 1];
  const uint2* tab4 = reinterpret_cast<const uint2*>(nid16);  // packs of 4 nouns
  const float4* val4 = reinterpret_cast<const float4*>(mval);

  long long pend_row = -1;  // the previous tile's action, stored a tile later
  int pend = 0;
  for (int j = 0; k < tiles; ++j, k += gridDim.x) {
    if (k + (int)gridDim.x < tiles)
      stage_tile(lv, ln, (j & 1) ? buf0 : buf1, L.ln_at, k + gridDim.x, tpv, T, n1, n2,
                 threadIdx.x, blockDim.x, FC_TILE);
    cp_async_commit();
    cp_async_wait_one();  // tile k's copies (this thread's) have landed
    __syncthreads();      // and every thread's
    const float* bufk = (j & 1) ? buf1 : buf0;
    const int b = k / tpv;
    const int f0 = (k - b * tpv) * FC_TILE;
    const int rows = min(FC_TILE, T - f0);
    const size_t row0 = (size_t)b * T + f0;
    const float* lvt = bufk + ((uintptr_t)(lv + row0 * n1) >> 2 & 3);
    const float* lnt = bufk + L.ln_at + ((uintptr_t)(ln + row0 * n2) >> 2 & 3);
    const float* lvr = lvt + lane * n1;
    const float* lnr = lnt + lane * n2;

    float best = -INFINITY;
    int bv = -1;
    for (int v = vlo; v < vhi; ++v) {
      float m = -INFINITY;
      if (!dense) {
        const int q0 = runs[v] >> 2, q1 = runs[v + 1] >> 2;  // the run's packs of 4 entries
        if (q0 == q1) continue;  // no finite entry: -inf, never the first maximum
#pragma unroll 2
        for (int q = q0; q < q1; ++q) {
          const uint2 e = tab4[q];
          const float4 w = val4[q];
          m = fmaxf(m, __fadd_rn(lnr[e.x & 0xffffu], w.x));
          m = fmaxf(m, __fadd_rn(lnr[e.x >> 16], w.y));
          m = fmaxf(m, __fadd_rn(lnr[e.y & 0xffffu], w.z));
          m = fmaxf(m, __fadd_rn(lnr[e.y >> 16], w.w));
        }
      } else {
        const float* mrow = mvn + (size_t)v * n2;
        for (int n = 0; n < n2; ++n) m = fmaxf(m, __fadd_rn(lnr[n], __ldg(mrow + n)));
      }
      const float s = __fadd_rn(lvr[v], m);
      if (s > best) {  // increasing v: the strict > keeps the first verb
        best = s;
        bv = v;
      }
    }
    xbest[warp * FC_TILE + lane] = make_float2(best, __int_as_float(bv));
    if (pend_row >= 0) out[pend_row] = pend;  // its a_table load has had the pass to arrive
    __syncthreads();
    // v* and its noun: half a warp a frame
    const int f = 2 * warp + (lane >> 4), r = lane & 15;
    float bb = -INFINITY;
    int vs = -1;
#pragma unroll
    for (int i = 0; i < AM_WARPS; ++i) {  // the lower warp first: the lower verb on equal values
      const float2 o = xbest[i * FC_TILE + f];
      const int ov = __float_as_int(o.y);
      if (ov >= 0 && (vs < 0 || o.x > bb)) {
        bb = o.x;
        vs = ov;
      }
    }
    if (vs < 0) vs = 0;  // every verb at -inf: the plain argmax picks the first
    const float* lnf = lnt + f * n2;
    float bm = -INFINITY;
    int bn = -1;
    if (!dense) {
      for (int s = runs[vs] + r; s < runs[vs + 1]; s += 16) {  // entries in noun order
        const float x = __fadd_rn(lnf[nid16[s]], mval[s]);
        if (x > bm) {
          bm = x;
          bn = nid16[s];
        }
      }
    } else {
      const float* mrow = mvn + (size_t)vs * n2;
      for (int n = r; n < n2; n += 16) {
        const float x = __fadd_rn(lnf[n], __ldg(mrow + n));
        if (x > bm) {
          bm = x;
          bn = n;
        }
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // the half warp's first maximum
      const float om = __shfl_xor_sync(all, bm, o);
      const int on = __shfl_xor_sync(all, bn, o);
      if (on >= 0 && (bn < 0 || om > bm || (om == bm && on < bn))) {
        bm = om;
        bn = on;
      }
    }
    pend_row = r == 0 && f < rows ? (long long)(row0 + f) : -1;
    if (pend_row >= 0) pend = __ldg(atab + (size_t)vs * n2 + (bn < 0 ? 0 : bn));
    __syncthreads();  // the tile's rows and the warps' bests are read: both may be refilled
  }
  if (pend_row >= 0) out[pend_row] = pend;
}

// Shared memory of a composed-argmax block, in bytes, and its table's entries
// (each run padded to a multiple of 4: at most 3 n1 more than n_act): the
// table, the run starts, the fill counts and the warps' bounds (padded to 16
// bytes), the warps' bests, pass 2's queue, the frames' picks and the queue's
// count, and two tiles' rows; ids_staged: the ids fit the second tile's room
// (a vocabulary of many repeated pairs may not: its blocks read them from
// device memory).
size_t argmax_smem(int n1, int n2, int n_act, int* slots, int* ids_staged) {
  *slots = (n_act + 3 * n1 + 3) & ~3;
  const int tile = ((AM_TILE * n1 + 7) & ~3) + ((AM_TILE * n2 + 7) & ~3);
  *ids_staged = 2 * ((n_act + 7) & ~3) <= tile;
  return 16 * (size_t)((*slots + 2 * n1 + AM_WARPS + 5) / 4) + 8 * (size_t)AM_WARPS * 32 +
         16 * (size_t)AM_QUEUE + 4 * (size_t)AM_TILE + 16 + 8 * (size_t)tile;
}

// The resident blocks of a persistent kernel on the current device (SMs x
// blocks an SM at this shared memory), asked once per (kernel, device, size).
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, int* blocks) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  constexpr int kSlots = 64;
  static Entry cache[kSlots];
  static int used = 0;
  static std::mutex mu;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return err;
  *blocks = sms * std::max(per_sm, 1);
  if (used < kSlots) cache[used++] = Entry{kernel, dev, smem, *blocks};
  return cudaSuccess;
}

// Shared memory of the tile form, in bytes: the packed ids and 32 frames' rows.
size_t tile_smem(int n1, int n2, int n_act) {
  return (size_t)n_act * sizeof(int) + (size_t)TILE * (n1 + n2) * sizeof(float);
}

// Shared memory of a blend block with nbuf item buffers, in bytes (see
// blend_runs_kernel).
size_t blend_smem(int n1, int n2, int n_act, int slots, int nbuf) {
  const size_t buf = 4 + ((n_act + 6) & ~3) + ((n1 + 3) & ~3) +
                     32 * (size_t)(((n1 + 6) & ~3) + (n2 | 1));
  const size_t floats = (size_t)slots + ((n1 + BL_WARPS + 5) & ~3) + 32 * (size_t)n1 + nbuf * buf +
                        16 + 96 + 2 * BL_WARPS * 32 + 4 * BL_QUEUE + 64 + 4;
  return floats * sizeof(float);
}

// Shared memory of a block of the blend's first launch: a sorting block's
// warps' counts, its tokens' places and items, its warps' sums and, in_smem,
// its frames'
// place; the table's block; or a Qv block's maxima and warps' bests,
// whichever is largest.
size_t prep_smem(int n1, int T, int M, int slots, int in_smem) {
  const int kc = std::min(M, PREP_KEYS);
  const size_t sort =
      4 * (size_t)((34 * kc + 2) & ~1) + 34 * 8 + (in_smem ? 4 * (size_t)T : 0);
  const size_t table = 4 * (size_t)slots + 4 * (size_t)(2 * n1 + 1 + BL_WARPS + 1);
  const size_t qv = 4 * (size_t)((n1 + 1) & ~1) + 32 * 8;
  return std::max(sort, std::max(table, qv));
}

// The composed argmax's block form: 1, the run-table block, where it fits
// in shared memory (n_act <= 65535: 16-bit action indices); 2, the tile form
// (a wider vocabulary); 0, neither (refused).
int argmax_form(int n1, int n2, int n_act, int* slots, int* staged, size_t* smem) {
  *smem = argmax_smem(n1, n2, n_act, slots, staged);
  if (n_act <= 65535 && *smem <= kMaxSmem) return 1;
  return tile_smem(n1, n2, n_act) <= kMaxSmem ? 2 : 0;
}

// The blend's plan: form 1, the token-grouped pair of launches through ws
// ints of workspace, where its block fits with two item buffers or one
// (n_act <= 65535) and the vocabulary holds BL_GROUPED_ACTIONS actions or
// more; form 2, the tile form (one launch, no workspace), for a smaller
// vocabulary or past the token-grouped block; 0, neither (refused).
struct BlendPlan {
  int form, slots, nbuf;
  size_t smem;
  long long ws;
  BlendPlan(int B, int T, int n1, int n2, int n_act, int M) {
    slots = (n_act + 3 * n1 + 3) & ~3;
    nbuf = blend_smem(n1, n2, n_act, slots, 2) <= kMaxSmem ? 2 : 1;
    smem = blend_smem(n1, n2, n_act, slots, nbuf);
    const bool grouped = n_act <= 65535 && smem <= kMaxSmem;
    const bool tile = tile_smem(n1, n2, n_act) <= kMaxSmem;
    form = grouped && !(tile && n_act < BL_GROUPED_ACTIONS) ? 1 : tile ? 2 : 0;
    ws = form == 1 ? BlendWs(B, T, n1, M, slots).total : 0;
  }
};

}  // namespace

// The composed argmax, one launch of the form argmax_form picks.
extern "C" int fk_compose_argmax(const float* lv, const float* ln, const int* vids,
                                 const int* nids, int* out, int B, int T, int n1, int n2,
                                 int n_act, void* stream) {
  if (n1 > 32767 || n2 > 32767) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int slots = 0, staged = 0;
  size_t smem = 0;
  const int form = argmax_form(n1, n2, n_act, &slots, &staged, &smem);
  if (form == 0) return (int)cudaErrorInvalidValue;
  if (form == 2) {
    const size_t tsmem = tile_smem(n1, n2, n_act);
    cudaError_t err = fk::set_smem((const void*)tile_kernel<false>, tsmem);
    if (err != cudaSuccess) return (int)err;
    tile_kernel<false><<<dim3((T + TILE - 1) / TILE, B), fk::kThreads, tsmem, st>>>(
        lv, ln, vids, nids, nullptr, nullptr, nullptr, out, T, n1, n2, n_act, 0, 0.f, 0.f);
    return (int)cudaGetLastError();
  }
  auto kernel = staged ? compose_argmax_kernel<true> : compose_argmax_kernel<false>;
  cudaError_t err = fk::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = resident_blocks((const void*)kernel, AM_WARPS * 32, smem, &blocks)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)B * ((T + AM_TILE - 1) / AM_TILE);
  const int grid = (int)std::min<long long>(tiles, (long long)blocks);
  kernel<<<grid, AM_WARPS * 32, smem, st>>>(lv, ln, vids, nids, out, B, T, n1, n2, n_act, slots);
  return (int)cudaGetLastError();
}

// The blend's plan for a call: out[0] its form, out[1] the ints of its
// workspace (BlendPlan).
extern "C" int fk_compose_blend_plan(int B, int T, int n1, int n2, int n_act, int M,
                                     long long* out) {
  const BlendPlan p(B, T, n1, n2, n_act, M);
  out[0] = p.form;
  out[1] = p.ws;
  return 0;
}

// The blend into pred and the composed argmax into fb, by the form
// BlendPlan picks (the token-grouped form through ws, its plan's ints; ws
// unread by the tile form).  The token-grouped form prunes its expfs where
// 0 <= w <= 1 (exactly: the picks of every expf).
extern "C" int fk_compose_blend(const float* lv, const float* ln, const int* vids,
                                const int* nids, const float* q, const int* act, int* pred,
                                int* fb, int* ws, int B, int T, int n1, int n2, int n_act, int M,
                                float omw, float w, void* stream) {
  if (n1 > 32767 || n2 > 32767 || M < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const BlendPlan p(B, T, n1, n2, n_act, M);
  if (p.form == 0) return (int)cudaErrorInvalidValue;
  if (p.form == 2) {
    const size_t tsmem = tile_smem(n1, n2, n_act);
    cudaError_t err = fk::set_smem((const void*)tile_kernel<true>, tsmem);
    if (err != cudaSuccess) return (int)err;
    tile_kernel<true><<<dim3((T + TILE - 1) / TILE, B), fk::kThreads, tsmem, st>>>(
        lv, ln, vids, nids, q, act, pred, fb, T, n1, n2, n_act, M, omw, w);
    return (int)cudaGetLastError();
  }
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int slots = p.slots;
  const int in_smem = prep_smem(n1, T, M, slots, 1) <= kMaxSmem;
  const size_t psmem = prep_smem(n1, T, M, slots, in_smem);
  cudaError_t err = fk::set_smem((const void*)blend_prep_kernel, psmem);
  if (err != cudaSuccess) return (int)err;
  blend_prep_kernel<<<B + 1 + PREP_QV_BLOCKS, PREP_THREADS, psmem, st>>>(
      act, vids, nids, q, ws, B, T, n1, n2, n_act, M, slots, in_smem);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = fk::set_smem((const void*)blend_runs_kernel, p.smem)) != cudaSuccess)
    return (int)err;
  int blocks = 0;
  if ((err = resident_blocks((const void*)blend_runs_kernel, BL_WARPS * 32, p.smem, &blocks)) !=
      cudaSuccess)
    return (int)err;
  const BlendWs L(B, T, n1, M, slots);
  const int grid = (int)std::min<long long>((long long)B * L.max_items, (long long)blocks);
  blend_runs_kernel<<<grid, BL_WARPS * 32, p.smem, st>>>(lv, ln, q, pred, fb, ws, B, T, n1, n2,
                                                         n_act, M, slots, p.nbuf, omw, w,
                                                         w >= 0.f && w <= 1.f);
  return (int)cudaGetLastError();
}

// Whether the factored block fits (FactoredLayout): out[0] 1 or 0, out[1]
// its bytes of shared memory, out[2] its table's slots.
extern "C" int fk_factored_plan(int n1, int n2, long long* out) {
  const FactoredLayout L(n1, n2);
  out[0] = L.ok && n1 <= 32767 && n2 <= 32767;
  out[1] = (long long)L.bytes;
  out[2] = L.cap;
  return 0;
}

// The factored argmax into out (B, T) int32: action ids a_table[v*, n*].
// Persistent blocks of FactoredLayout's shared memory, one an SM.
extern "C" int fk_factored_argmax(const float* lv, const float* ln, const float* mvn,
                                  const int* atab, int* out, int B, int T, int n1, int n2,
                                  void* stream) {
  if (n1 > 32767 || n2 > 32767) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const FactoredLayout L(n1, n2);
  if (!L.ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = fk::set_smem((const void*)factored_kernel, L.bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = resident_blocks((const void*)factored_kernel, AM_WARPS * 32, L.bytes, &blocks)) !=
      cudaSuccess)
    return (int)err;
  const long long tiles = (long long)B * ((T + FC_TILE - 1) / FC_TILE);
  const int grid = (int)std::min<long long>(tiles, (long long)blocks);
  factored_kernel<<<grid, AM_WARPS * 32, L.bytes, (cudaStream_t)stream>>>(lv, ln, mvn, atab, out,
                                                                          B, T, n1, n2);
  return (int)cudaGetLastError();
}
