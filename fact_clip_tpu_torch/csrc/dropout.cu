// The scaled keep mask of a dropout, any shape: out[i] = keep(seed, stream, i)
// for the n elements of the mask in row-major order (common.cuh's
// dropout_bits; ops/dropout.py's dropout_mask_reference is its plain twin).
//
// Replaces the TPU's mask replays, which redraw a kernel's on-core PRNG bits
// for its backward or for a check: fact_clip_tpu/ops/pallas/dilated_conv.py::
// dropout_mask (K1, (B, T, C) per layer), mha_attn.py::mha_dropout_mask (K3,
// (B, H*M, X)), sa_layer.py::sa_dropout_masks and ::ffn_dropout_masks (K4,
// (B, H*M, M) and (B, M, E); (B, M, F) and (B, M, E)).  Here they are one
// kernel: the bits depend on (seed, stream, index) only, so any shape is a
// flat range of indices.  The backward kernels of K1, K3 and K4 read the mask
// it writes for their layer; the forwards hash the same bits in-kernel.
//
// Bound on the H100: the write, 4 bytes per element (31.5 MB for a K3 mask
// at B=8, H*M=320, X=3072: ~9.4 us at 3.35 TB/s); the hash is ~12 integer
// operations per element.  A grid-stride loop, one element per thread per
// step, with neighbouring threads on neighbouring addresses.
#include "common.cuh"

namespace {

__global__ void dropout_mask_kernel(fk::Dropout drop, float* __restrict__ out, long long n) {
  const uint32_t seed = drop.load_seed();
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = drop.keep((uint32_t)e, seed);
}

}  // namespace

extern "C" int fk_dropout_mask(const int* seed, int stream, unsigned thresh, float scale,
                               float* out, long long n, void* cuda_stream) {
  const int blocks = (int)min((n + 255) / 256, 8192LL);
  fk::Dropout drop{seed, stream, thresh, scale};
  dropout_mask_kernel<<<blocks > 0 ? blocks : 1, 256, 0, (cudaStream_t)cuda_stream>>>(drop, out,
                                                                                      n);
  return (int)cudaGetLastError();
}
