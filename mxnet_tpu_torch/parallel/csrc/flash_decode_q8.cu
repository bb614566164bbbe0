// flash_decode_q8.cu: one decode step of attention over a gathered int8 KV
// cache with per-position scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel_q8` of
// mxnet_tpu/parallel/flash_attention.py (launched by `_pallas_decode` with
// quantized caches). It computes what flash_decode.cu computes, per
// (batch, head), one query row against the first lengths[b] keys, with K and
// V stored as int8 and dequantized while they are staged:
//   k_i = (float)k8_i * k_scale[b, i],  v_i = (float)v8_i * v_scale[b, i].
// Each product is the single fp32 multiply that the pool's dequantizing
// gather (`gather_pages_q8` in serving/kvcache.py) performs, and the staged
// tiles then go through the same online-softmax step as the fp32 kernel
// (`decode::tile_step` in flash_common.cuh). So the output is bit-identical
// to flash_decode.cu's on the dequantized cache.
//
// Keys at or beyond lengths[b] are never read, and neither are their scales:
// the dump page's and stale slots' bytes and scales are garbage (a NaN scale
// included) and cannot leak in.
//
// What bounds it on an H100: memory. Each (batch, head) reads 2 * len * D
// bytes of int8 K and V, a quarter of the fp32 kernel's, and the 2 * len
// scales of its row (shared by the row's H heads); it does 6 * len * D
// operations on them (the dequantizing multiplies, q.k and p.v), about
// 3 per byte, below the card's fp32 ridge of 20.
//
// Design: flash_decode.cu's, one block of 128 threads per (batch*head) row,
// tiles of 128 live keys, except for the staging. Int8 rows are loaded in
// granules of G bytes, 16 (one int4) when D % 16 == 0 and both caches are
// 16-byte aligned, else 4 when D % 4 == 0 and they are 4-byte aligned, else
// 1; each byte is converted, multiplied by its position's scale (read from
// global memory, where the row's other granules find it in L1) and stored as
// fp32 into the shared tiles. A thread issues its loads for the whole tile
// before the block synchronises. The scales are (B, T) and indexed at
// b = bh / H, as lengths is: no per-head copy.

#include "flash_common.cuh"

#include <stdint.h>

namespace {

using namespace flash;
using namespace flash::decode;

__device__ __forceinline__ void dequant4(float* dst, int w, float s) {
  dst[0] = (float)(signed char)(w) * s;
  dst[1] = (float)(signed char)(w >> 8) * s;
  dst[2] = (float)(signed char)(w >> 16) * s;
  dst[3] = (float)(signed char)(w >> 24) * s;
}

// G int8 values at `src` (G-byte aligned), dequantized by `s` into dst[0..G).
template <int G>
__device__ __forceinline__ void stage(float* dst, const signed char* src,
                                      float s) {
  if constexpr (G == 16) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(src));
    dequant4(dst, w.x, s);
    dequant4(dst + 4, w.y, s);
    dequant4(dst + 8, w.z, s);
    dequant4(dst + 12, w.w, s);
  } else if constexpr (G == 4) {
    dequant4(dst, __ldg(reinterpret_cast<const int*>(src)), s);
  } else {
    dst[0] = (float)__ldg(src) * s;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
decode_q8_kernel(const float* __restrict__ q, const signed char* __restrict__ k,
                 const signed char* __restrict__ v,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ lengths, float* __restrict__ o, int H,
                 int T, int D, float scale) {
  extern __shared__ float smem[];
  const Tiles s = carve(smem, D);
  const int ld = D + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int n = min(max(lengths[b], 0), T);
  const long rs = (long)H * D;    // bytes between positions
  const signed char* kb = k + ((long)b * T * H + h) * D;
  const signed char* vb = v + ((long)b * T * H + h) * D;
  const float* ksb = k_scale + (long)b * T;
  const float* vsb = v_scale + (long)b * T;
  for (int i = tid; i < D; i += kThreads) s.qs[i] = q[(long)bh * D + i];

  const int per_row = D / G;       // granules per key row
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int nk = min(kBK, n - k0);
    __syncthreads();  // the previous tile's readers are done
    // rows at or beyond nk are neither loaded nor read by tile_step
#pragma unroll 4
    for (int i = tid; i < nk * per_row; i += kThreads) {
      const int r = i / per_row, d = (i - r * per_row) * G;
      const long off = (long)(k0 + r) * rs + d;
      stage<G>(&s.ks[r * ld + d], kb + off, __ldg(ksb + k0 + r));
      stage<G>(&s.vs[r * D + d], vb + off, __ldg(vsb + k0 + r));
    }
    __syncthreads();
    tile_step(s, nk, D, scale, m, l, acc);
  }
  finish(s, D, l, acc, o + (long)bh * D);
}

template <int G>
int launch(const float* q, const signed char* k, const signed char* v,
           const float* k_scale, const float* v_scale, const int* lengths,
           float* o, int B, int H, int T, int D, float scale, void* stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_q8_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_q8_kernel<G><<<B * H, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k, v, k_scale, v_scale, lengths, o, H, T, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D) fp32; k and v (B, T, H, D) int8; k_scale and v_scale (B, T)
// fp32; lengths (B,) int32; o (B, 1, H, D) fp32; all contiguous on the device.
// D <= 128. Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_decode_q8(const float* q, const signed char* k,
                                   const signed char* v, const float* k_scale,
                                   const float* v_scale, const int* lengths,
                                   float* o, int B, int H, int T, int D,
                                   float scale, void* stream) {
  if (D < 1 || D > kThreads) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (D % 16 == 0 && align % 16 == 0)
    return launch<16>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D, scale,
                      stream);
  if (D % 4 == 0 && align % 4 == 0)
    return launch<4>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D, scale,
                     stream);
  return launch<1>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D, scale,
                   stream);
}
