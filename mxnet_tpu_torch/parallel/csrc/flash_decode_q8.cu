// flash_decode_q8.cu: one decode step of attention over a gathered int8 KV
// cache with per-position scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel_q8` of
// mxnet_tpu/parallel/flash_attention.py (launched by `_pallas_decode` with
// quantized caches). It computes what flash_decode.cu computes, per
// (batch, head), one query row against the first lengths[b] keys, with K and
// V stored as int8 and dequantized as they are read:
//   k_i = (float)k8_i * k_scale[b, i],  v_i = (float)v8_i * v_scale[b, i].
// Each product is the single fp32 multiply that the pool's dequantizing
// gather (`gather_pages_q8` in serving/kvcache.py) performs, and the values
// then go through the same online-softmax step and merges as the fp32
// kernel's (namespace decode of flash_common.cuh), on the same split of the
// cache. So the output is bit-identical to flash_decode.cu's on
// the dequantized cache.
//
// Keys at or beyond lengths[b] are never read, and neither are their scales:
// the dump page's and stale slots' bytes and scales are garbage (a NaN scale
// included) and cannot leak in. A row with lengths[b] == 0 gets o = 0, as in
// flash_decode.cu.
//
// What bounds it on an H100: memory. Each (batch, head) reads 2 * len * D
// bytes of int8 K and V, a quarter of the fp32 kernel's, and the 2 * len
// scales of its row (shared by the row's H heads); it does 6 * len * D
// operations on them (the dequantizing multiplies, q.k and p.v), about
// 3 per byte, below the card's fp32 ridge of 20.
//
// Design: flash_decode.cu's — (row, split) grid from decode::pick_splits,
// a two-stage ring of asynchronous copies, lane groups of 4-column lanes,
// a row's splits one cluster, merges in a fixed order; the entry point
// allocates nothing and does not synchronise. The
// ring holds the raw int8 rows and the scales of the stage's positions, so
// the bytes in flight are the cache's own: int8 rows in granules of G bytes,
// 16 (cp.async of one int4) when D % 16 == 0 and both caches are 16-byte
// aligned, else 4 when D % 4 == 0 and they are 4-byte aligned, each
// overlapped with the scoring of the stage before; else 1, as plain loads
// (no model of the repo has D % 4 != 0). The scales are (B, T), copied 4
// bytes each and indexed at b = bh / H, as lengths is: no per-head copy. A
// lane reads its 4 bytes of a staged row as one word and dequantizes them
// with the row's scale (Q8Tile).

#include "flash_common.cuh"

#include <stdint.h>

namespace {

using namespace flash;
using namespace flash::decode;

// 4 int8 values at `p` (4-byte aligned shared memory), each times `s`.
__device__ __forceinline__ float4 dequant4(const signed char* p, float s) {
  const int w = *reinterpret_cast<const int*>(p);
  return make_float4(
      (float)(signed char)(w) * s, (float)(signed char)(w >> 8) * s,
      (float)(signed char)(w >> 16) * s, (float)(signed char)(w >> 24) * s);
}

// A staged int8 stage: rows of 4 L bytes, K and V apart, and the stage's
// scales; read as fp32 as decode::tile_step asks.
struct Q8Tile {
  const signed char *k, *v;
  const float *ks, *vs;
  int ld;
  __device__ __forceinline__ float4 key(int r, int c) const {
    return dequant4(k + r * ld + c, ks[r]);
  }
  __device__ __forceinline__ float4 val(int r, int c) const {
    return dequant4(v + r * ld + c, vs[r]);
  }
};

template <int L>
__global__ void __launch_bounds__(kThreads)
decode_q8_kernel(const float* __restrict__ q, const signed char* __restrict__ k,
                 const signed char* __restrict__ v,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ lengths, float* __restrict__ o, int H,
                 int T, int D, int S, int chunk, int gran, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int TK = tile_keys(L), ld = 4 * L;
  float* kss = reinterpret_cast<float*>(smem4);  // kStages x TK scales
  float* vss = kss + kStages * TK;
  float* red = vss + kStages * TK;
  // kStages stages of TK x ld bytes, 16-byte aligned
  signed char* k8 = reinterpret_cast<signed char*>(red + merge_floats(L));
  signed char* v8 = k8 + kStages * TK * ld;

  const int bh = blockIdx.x / S, split = blockIdx.x - bh * S;
  const int b = bh / H, h = bh - b * H;
  const int c = 4 * ((int)threadIdx.x % L);
  float qv[4];  // loaded beside lengths[b], not after it
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qv[i] = c + i < D ? q[(long)bh * D + c + i] : 0.f;
  const int n = min(max(lengths[b], 0), T);
  // this block's live keys: k0..k1-1 (none when its chunk starts at or
  // beyond lengths[b])
  const int k0 = split * chunk, k1 = min(k0 + chunk, n);
  const int nt = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;  // stages
  const long rs = (long)H * D;  // bytes between positions
  const signed char* kb = k + ((long)b * T * H + h) * D;
  const signed char* vb = v + ((long)b * T * H + h) * D;
  const float* ksb = k_scale + (long)b * T;
  const float* vsb = v_scale + (long)b * T;
  // bytes D..ld-1 of every staged row: the copies never write them
  if (nt > 0 && D < ld)
    for (int i = threadIdx.x; i < 2 * kStages * TK * (ld - D);
         i += kThreads) {
      const int r = i / (ld - D);
      k8[r * ld + D + i - r * (ld - D)] = 0;
    }

  // starts the copies of stage t (rows k0 + t * TK ...) into slot t % kStages
  auto stage = [&](int t) {
    const int r0 = k0 + t * TK, nv = min(TK, k1 - r0);
    const int slot = t % kStages;
    signed char* kd = k8 + slot * TK * ld;
    signed char* vd = v8 + slot * TK * ld;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      cp_async4(kss + slot * TK + i, ksb + r0 + i, true);
      cp_async4(vss + slot * TK + i, vsb + r0 + i, true);
    }
    if (gran == 1) {
      for (int i = threadIdx.x; i < nv * D; i += kThreads) {
        const int r = i / D, cc = i - r * D;
        const long off = (long)(r0 + r) * rs + cc;
        kd[r * ld + cc] = __ldg(kb + off);
        vd[r * ld + cc] = __ldg(vb + off);
      }
      return;
    }
    const int per = D / gran;
    for (int i = threadIdx.x; i < nv * per; i += kThreads) {
      const int r = i / per, cc = (i - r * per) * gran;
      const long off = (long)(r0 + r) * rs + cc;
      if (gran == 16) {
        cp_async16(kd + r * ld + cc, kb + off, true);
        cp_async16(vd + r * ld + cc, vb + off, true);
      } else {
        cp_async4(kd + r * ld + cc, kb + off, true);
        cp_async4(vd + r * ld + cc, vb + off, true);
      }
    }
  };
  State st;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    if (t + kStages - 1 < nt) stage(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of stage t landed
    __syncthreads();               // ... and every thread's
    const int slot = t % kStages;
    tile_step<L>(Q8Tile{k8 + slot * TK * ld, v8 + slot * TK * ld,
                        kss + slot * TK, vss + slot * TK, ld},
                 min(TK, k1 - k0 - t * TK), qv, scale, st);
    __syncthreads();  // slot t % kStages is free for stage t + kStages
  }
  finish<L>(st, red, D, S, split, o + (long)bh * D);
}

template <int L>
int launch(const float* q, const signed char* k, const signed char* v,
           const float* k_scale, const float* v_scale, const int* lengths,
           float* o, int B, int H, int T, int D, float scale, int S,
           cudaStream_t stream) {
  constexpr int TK = tile_keys(L);
  const size_t smem = sizeof(float) * (2 * kStages * TK + merge_floats(L)) +
                      2 * kStages * TK * 4 * L;
  const uintptr_t align = (uintptr_t)k | (uintptr_t)v;
  const int gran = D % 16 == 0 && align % 16 == 0 ? 16
                   : D % 4 == 0 && align % 4 == 0 ? 4
                                                  : 1;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_q8_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(decode_q8_kernel<L>, B * H * S, S, kThreads,
                              smem, stream, q, k, v, k_scale, v_scale,
                              lengths, o, H, T, D, S, chunk_keys(T, S), gran,
                              scale);
}

}  // namespace

// The host's number of splits for a call of mxt_flash_decode_q8 on these
// shapes (flash_decode.cu's rule).
extern "C" int mxt_flash_decode_q8_splits(int B, int H, int T, int D) {
  return pick_splits(B * H, T, D);
}

// q (B, 1, H, D) fp32; k and v (B, T, H, D) int8; k_scale and v_scale (B, T)
// fp32; lengths (B,) int32; o (B, 1, H, D) fp32; all contiguous on the device.
// D <= 128. S as for mxt_flash_decode. Returns the launch's cudaError_t (0 on
// success).
extern "C" int mxt_flash_decode_q8(const float* q, const signed char* k,
                                   const signed char* v, const float* k_scale,
                                   const float* v_scale, const int* lengths,
                                   float* o, int B, int H, int T, int D,
                                   float scale, int S, void* stream) {
  if (S == 0) S = pick_splits(B * H, T, D);
  if (D < 1 || D > 128 || S < 1 || S > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes(D)) {
    case 4:
      return launch<4>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D,
                       scale, S, st);
    case 8:
      return launch<8>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D,
                       scale, S, st);
    case 16:
      return launch<16>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D,
                        scale, S, st);
    default:
      return launch<32>(q, k, v, k_scale, v_scale, lengths, o, B, H, T, D,
                        scale, S, st);
  }
}
