// Weight-gradient products and fixed-order reductions of the backward kernels.
//
// The TPU backward kernels (dilated_conv.py::_stack_bwd_layer,
// x2y_attn.py::_x2y_small_x_bwd_impl and ::_x2y_flash_bwd_impl) sum their
// weight gradients over the grid in VMEM scratch, because the TPU grid runs in
// order on one core.  Blocks on the H100 run in no order, and float atomics
// would make every sum wander from run to run, so each such sum is split:
//
//   fk_atb:    dW = sum_n A[n]^T Bm[n] over the rows n of (Bt, T, .) streams,
//              one block per (64 rows of dW, chunk of Kc rows of one video,
//              tap).  Each block writes its partial product; the A operand may
//              be shifted in time (the taps of a dilated conv) and masked by
//              video length, and may carry a positional term on its leading
//              channels (the key projection's input x + pos).  A block whose
//              shifted chunk lies wholly outside [0, length) writes zeros.
//   fk_reduce: out[g][r][c] = sum_p src[g*gstride + p*pstride + r*rstride + c],
//              p in order: the partials' sum, a batch sum of a positional
//              gradient, or the column sums the row kernels write per block;
//              fk_reduce_to writes out[g*out_gstride + r*out_rstride + c].
//
// Bound on the H100: fk_atb is the f32 FMA GEMM core (2 * N * Ca * Cb FLOPs,
// 3.2 GFLOP for one (256 x 256) tap of the flagship tower); its A operand is
// read transposed, staged with neighbouring threads on neighbouring channels
// so that the loads stay coalesced; fk_reduce moves partials * Ca * Cb floats
// once.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // rows of dW per block

__global__ void __launch_bounds__(fk::kThreads)
atb_kernel(const float* __restrict__ A, const float* __restrict__ pos, long long pos_bstride,
           int P, const int* __restrict__ lengths, int shift0, int shift_step,
           const float* __restrict__ Bm, float* __restrict__ part, int T, int Ca, int Cb,
           int Kc, int n_chunks) {
  constexpr int RM = BM / 8;
  extern __shared__ float4 smem_raw[];
  fk::GemmSmem<BM>& s = *reinterpret_cast<fk::GemmSmem<BM>*>(smem_raw);
  const int i0 = blockIdx.x * BM;
  const int chunk = blockIdx.y;
  const int per = (T + Kc - 1) / Kc;
  const int b = chunk / per;
  const int t0 = (chunk - b * per) * Kc;
  const int K = min(Kc, T - t0);
  const int tap = blockIdx.z;
  const int shift = shift0 + tap * shift_step;
  const int Lb = lengths ? min(lengths[b], T) : T;
  const float* Ab = A + (size_t)b * T * Ca;
  const float* pb = pos ? pos + (size_t)b * pos_bstride : nullptr;
  float* out = part + ((size_t)tap * n_chunks + chunk) * Ca * Cb;
  if (t0 + shift >= Lb || t0 + K + shift <= 0) {  // every A row of the chunk reads as zero
    const size_t n = (size_t)min(BM, Ca - i0) * Cb;
    for (size_t e = threadIdx.x; e < n; e += fk::kThreads) out[(size_t)i0 * Cb + e] = 0.f;
    return;
  }
  float acc[RM][8];

  auto a_elem = [&](int r, int k) {  // A^T: row r = channel i0 + r, column k = time t0 + k
    const int i = i0 + r;
    const int t = t0 + k + shift;
    if (i >= Ca || t < 0 || t >= Lb) return 0.f;
    float v = __ldg(Ab + (size_t)t * Ca + i);
    if (pb != nullptr && i < P) v += __ldg(pb + (size_t)t * P + i);
    return v;
  };
  const float* Wb = Bm + ((size_t)b * T + t0) * Cb;
  for (int n0 = 0; n0 < Cb; n0 += fk::kBN) {
    fk::gemm_pass<BM, true>(acc, a_elem, Wb, Cb, K, n0, Cb, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = i0 + fk::pass_row<BM>(i);
      if (r >= Ca) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + fk::pass_col(j);
        if (c < Cb) out[(size_t)r * Cb + c] = acc[i][j];
      }
    }
  }
}

__global__ void reduce_kernel(const float* __restrict__ src, int P, long long pstride,
                              long long gstride, int rows, long long rstride, int cols,
                              float* __restrict__ out, long long out_gstride,
                              long long out_rstride) {
  const long long n = (long long)rows * cols;
  const int g = blockIdx.y;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / cols;
    const long long c = e - r * cols;
    const float* p = src + g * gstride + r * rstride + c;
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += p[q * pstride];
    out[g * out_gstride + r * out_rstride + c] = s;
  }
}

}  // namespace

extern "C" int fk_atb(const float* A, const float* pos, long long pos_bstride, int P,
                      const int* lengths, int shift0, int shift_step, const float* Bm,
                      float* part, int Bt, int T, int Ca, int Cb, int Kc, int n_taps,
                      void* stream) {
  const size_t smem = sizeof(fk::GemmSmem<BM>);
  cudaError_t err = fk::set_smem((const void*)atb_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = Bt * ((T + Kc - 1) / Kc);
  dim3 grid((Ca + BM - 1) / BM, n_chunks, n_taps);
  atb_kernel<<<grid, fk::kThreads, smem, (cudaStream_t)stream>>>(
      A, pos, pos_bstride, P, lengths, shift0, shift_step, Bm, part, T, Ca, Cb, Kc, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int fk_reduce_to(const float* src, int G, int P, long long pstride,
                            long long gstride, int rows, long long rstride, int cols, float* out,
                            long long out_gstride, long long out_rstride, void* stream) {
  const long long n = (long long)rows * cols;
  const int blocks = (int)min((n + 255) / 256, 4096LL);
  dim3 grid(blocks > 0 ? blocks : 1, G);
  reduce_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(src, P, pstride, gstride, rows, rstride,
                                                         cols, out, out_gstride, out_rstride);
  return (int)cudaGetLastError();
}

extern "C" int fk_reduce(const float* src, int G, int P, long long pstride, long long gstride,
                         int rows, long long rstride, int cols, float* out, void* stream) {
  return fk_reduce_to(src, G, P, pstride, gstride, rows, rstride, cols, out,
                      (long long)rows * cols, cols, stream);
}
