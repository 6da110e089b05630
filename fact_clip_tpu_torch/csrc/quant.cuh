// The int8 quantizer of the K8 kernels (int8 evaluation): JAX's rounding of
// an f32 value to int8 and the packing of four int8 values into a word, as
// the row quantizer (q8_proj.cu) and the towers' window and activation
// passes (quant2.cu) write them.  The integer products themselves run on
// tc_int8.cuh's wgmma core.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace fk {

// four int8 values, element 0 in the least significant byte (memory order)
__device__ __forceinline__ int pack_s8(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}

// JAX's quantizer, round(v * (127 / s)) half to even, with inv = 127 / s
__device__ __forceinline__ int quant_s8(float v, float inv) {
  return __float2int_rn(__fmul_rn(v, inv));
}

// 16 f32 values -> 16 int8 values (one 16-byte piece of a staged row)
__device__ __forceinline__ int4 quant16(const float* __restrict__ p, float inv) {
  const float4 v0 = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v1 = __ldg(reinterpret_cast<const float4*>(p + 4));
  const float4 v2 = __ldg(reinterpret_cast<const float4*>(p + 8));
  const float4 v3 = __ldg(reinterpret_cast<const float4*>(p + 12));
  int4 o;
  o.x = pack_s8(quant_s8(v0.x, inv), quant_s8(v0.y, inv), quant_s8(v0.z, inv), quant_s8(v0.w, inv));
  o.y = pack_s8(quant_s8(v1.x, inv), quant_s8(v1.y, inv), quant_s8(v1.z, inv), quant_s8(v1.w, inv));
  o.z = pack_s8(quant_s8(v2.x, inv), quant_s8(v2.y, inv), quant_s8(v2.z, inv), quant_s8(v2.w, inv));
  o.w = pack_s8(quant_s8(v3.x, inv), quant_s8(v3.y, inv), quant_s8(v3.z, inv), quant_s8(v3.w, inv));
  return o;
}

}  // namespace fk
