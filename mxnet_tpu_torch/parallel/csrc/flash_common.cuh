// flash_common.cuh: what the flash-attention kernels share — the cp.async
// staging, the mask rule, and for the two backward kernels (flash_bwd_dkdv.cu,
// flash_bwd_dq.cu) their tile shape and the S/dP/P/dS recompute. Each kernel
// source includes it; _build.py hashes it into every library's name, so an edit
// here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash {

// Asynchronous 4-byte global -> shared copy (sm_80+). With `pred` false it
// reads nothing and writes a zero, so ragged tiles need no second path.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The mask of every kernel (the TPU's `_mask_scores`; `_live_pairs` in
// flash_attention.py): query qp sees key kp iff the key exists, it is not
// above the causal diagonal (top-left aligned when Tq != Tk), and in a packed
// batch both lie in the same nonzero segment (id 0 attends to nothing).
__device__ __forceinline__ bool live_pair(int qp, int kp, int Tk, int causal,
                                          bool segmented, int qseg, int kseg) {
  bool live = kp < Tk && (!causal || qp >= kp);
  if (segmented) live = live && qseg > 0 && qseg == kseg;
  return live;
}

namespace bwd {

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = 8;           // rows (query or key) per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr int kLdP = kBK + 1;      // padded row of the P and dS tiles

// S = Q K^T and dP = dO V^T of one (query tile, key tile) pair, all four tiles
// in shared memory with rows of `ld` floats: thread (rg, cg) gets query rows
// rg + 8i and keys cg + 16j, each a D-long fp32 FMA chain.
__device__ __forceinline__ void score_tiles(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int ld, int D, int rg, int cg,
                                            float (&s)[kRows][kCols],
                                            float (&dp)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float kv[kCols], vv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      kv[j] = ks[(cg + 16 * j) * ld + d];
      vv[j] = vs[(cg + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float qv = qs[(rg + 8 * i) * ld + d];
      const float ov = dos[(rg + 8 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(qv, kv[j], s[i][j]);
        dp[i][j] = fmaf(ov, vv[j], dp[i][j]);
      }
    }
  }
}

// P = exp(scale * S - LSE) on a live pair and an exact zero on a masked one;
// dS = P * (dP - Dr) * scale. Returns (P, dS). Callers read the row's LSE and
// Dr into registers once per row: the P/dS stores to shared memory between
// keys would otherwise make the compiler reload them for every key.
__device__ __forceinline__ float2 p_ds(float s, float dp, float scale,
                                       float lse, float dr, bool live) {
  const float p = live ? expf(s * scale - lse) : 0.f;
  return make_float2(p, p * (dp - dr) * scale);
}

}  // namespace bwd
}  // namespace flash
