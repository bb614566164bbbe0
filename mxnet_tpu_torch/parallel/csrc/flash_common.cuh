// flash_common.cuh: what the flash-attention kernels share — the cp.async
// staging, the mask rule, for the two decode kernels (flash_decode.cu,
// flash_decode_q8.cu) their tile shape and the streaming-softmax step over a
// staged tile, and for the two backward kernels (flash_bwd_dkdv.cu,
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

namespace decode {

constexpr int kThreads = 128;
constexpr int kBK = 128;           // keys per tile (one per thread)
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

// Dynamic shared memory of a decode block, in the order `Tiles` carves it: the
// K tile (kBK rows padded to D+1 floats, so thread t reading key row t is free
// of bank conflicts), the V tile (kBK x D), the query row, the tile's
// probabilities, one slot per warp for block reductions, and the P V partial
// sums.
inline size_t smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(kBK * (D + 1) + kBK * D + D + kBK + kWarps + kThreads);
}

struct Tiles {
  float *ks, *vs, *qs, *ps, *wred, *part;
};

__device__ __forceinline__ Tiles carve(float* smem, int D) {
  Tiles t;
  t.ks = smem;
  t.vs = t.ks + kBK * (D + 1);
  t.qs = t.vs + kBK * D;
  t.ps = t.qs + D;
  t.wred = t.ps + kBK;
  t.part = t.wred + kWarps;
  return t;
}

// Block-wide max (op = 0) or sum (op = 1) of one value per thread; every
// thread gets the result. `wred` holds one slot per warp.
__device__ __forceinline__ float block_reduce(float x, float* wred, int op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = op == 0 ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // earlier readers of wred are done
  if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = x;
  __syncthreads();
  x = wred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = op == 0 ? fmaxf(x, wred[w]) : x + wred[w];
  return x;
}

// One tile of the online softmax, after its first `nk` K and V rows are staged
// in fp32: thread t scores key t; the running max m and sum l are kept
// (identical) in every thread; for P V, thread t owns output column t % D and
// every (kThreads / D)-th key of the tile and rescales its partial sum `acc`
// by the same alpha. Both decode kernels run exactly this arithmetic, so
// equal staged values give bit-identical outputs.
__device__ __forceinline__ void tile_step(const Tiles& s, int nk, int D,
                                          float scale, float& m, float& l,
                                          float& acc) {
  const int tid = threadIdx.x, ld = D + 1;
  const int groups = kThreads / D;
  const int gd = tid % D, gg = tid / D;
  float sc = kNeg;
  if (tid < nk) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(s.qs[d], s.ks[tid * ld + d], dot);
    sc = dot * scale;
  }
  const float mnew = fmaxf(m, block_reduce(sc, s.wred, 0));
  const float alpha = expf(m - mnew);  // 0 on the first tile
  const float p = (tid < nk) ? expf(sc - mnew) : 0.f;
  s.ps[tid] = p;
  l = l * alpha + block_reduce(p, s.wred, 1);  // syncs: ps is complete
  m = mnew;
  if (gg < groups) {
    float a = 0.f;
    for (int c = gg; c < nk; c += groups) a = fmaf(s.ps[c], s.vs[c * D + gd], a);
    acc = acc * alpha + a;
  }
}

// Adds the P V partial sums of the key groups and writes o = acc / l for the
// block's row (D floats at `o_row`).
__device__ __forceinline__ void finish(const Tiles& s, int D, float l,
                                       float acc, float* o_row) {
  const int tid = threadIdx.x;
  const int groups = kThreads / D;
  const int gd = tid % D, gg = tid / D;
  __syncthreads();
  if (gg < groups) s.part[gg * D + gd] = acc;
  __syncthreads();
  if (tid < D) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += s.part[g * D + tid];
    o_row[tid] = t / fmaxf(l, 1e-30f);
  }
}

}  // namespace decode

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
