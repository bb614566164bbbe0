// flash_common.cuh: what the flash-attention kernels share — the cp.async
// staging and the mask rule; for the two decode kernels (flash_decode.cu,
// flash_decode_q8.cu) their tile shape and the streaming-softmax step over a
// staged tile; for the forward (flash_fwd.cu) and the two backward kernels
// (flash_bwd_dkdv.cu, flash_bwd_dq.cu) the tensor-core tiles (namespace tc:
// padded rows, 16-byte staging, the 3xTF32 mma.sync product and its fragment
// loads, the hand-over of an accumulator as the next product's A operand);
// and the backward's tile shape and P/dS step. Each kernel source includes
// it; _build.py hashes it into every library's name, so an edit here rebuilds
// them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

namespace tc {

// The tensor-core kernels (forward and backward): blocks of four warps, each
// warp owning 16 rows of the block's own tile. D is padded with zeros to
// 8 * NT columns (NT 8-wide column tiles), and every staged row holds
// 8 * NT + 4 floats: 16-byte copies stay aligned, and since the row length is
// 4 mod 8 words, the fragment loads below hit 32 different banks.
constexpr int kThreads = 128;

template <int NT>
__host__ __device__ constexpr int row_floats() { return 8 * NT + 4; }

// Asynchronous 16-byte global -> shared copy, L2 only; with `pred` false it
// reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of ROWS rows of one (b, h) plane of a (B, T, H, D) operand
// into a tile with rows of row_floats<NT>() floats: tile row r is position
// row0 + r of `base` (the plane's position 0, positions `rs` floats apart),
// zero-filled without a read for r >= nvalid. Granules of 16 bytes when `vec`
// (D and rs multiples of 4, `base` 16-byte aligned), else of 4 bytes.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           int row0, int nvalid, long rs,
                                           int D, int vec) {
  constexpr int ld = row_floats<NT>();
  if (vec) {
    constexpr int per = 2 * NT;  // 16-byte granules of a padded row
    constexpr int n = ROWS * per;
#pragma unroll
    for (int it = 0; it < (n + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / per, c = (i % per) * 4;
      if (i < n && c < D) {
        const bool in = r < nvalid;
        cp_async16(dst + r * ld + c,
                   in ? base + (long)(row0 + r) * rs + c : base, in);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const bool in = r < nvalid;
      cp_async4(dst + r * ld + c, in ? base + (long)(row0 + r) * rs + c : base,
                in);
    }
  }
}

// Zeroes columns D..8*NT-1 of `rows` staged rows; the copies never write them.
template <int NT>
__device__ __forceinline__ void zero_pad(float* s, int rows, int D) {
  const int pad = 8 * NT - D;
  if (pad <= 0) return;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    s[r * row_floats<NT>() + D + i - r * pad] = 0.f;
  }
}

// 3xTF32 on the tensor cores. Each fp32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and a
// product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32
// accumulation: about fp32's accuracy (the dropped a_lo b_lo is ~2^-22 of
// a b), where one TF32 pass keeps ~2^-11.
struct FragA {  // m16n8k8 A fragment: rows g, g+8; columns t, t+4
  uint32_t hi[4], lo[4];
};
struct FragB {  // m16n8k8 B fragment: rows (k) t, t+4; column (n) g
  uint32_t hi[2], lo[2];
};

// The rounding of cvt.rna.tf32.f32 (nearest, ties away from zero; equal to
// it for every finite x) as an integer add and mask: the 13 low bits of the
// magnitude are rounded off, which the sign bit does not take part in. The
// conversion instruction itself made both kernels slower (chip_bwd_variants.py,
// variant cvt.rna).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc += part, element by element in fp32. The tensor cores round each
// mma's sum toward zero, so a sum kept in one accumulator over a whole
// sequence (128 mma steps of 3 products at T = 1024) drifts by about one ulp
// a step; the kernels sum each tile on the tensor cores and add the tiles
// here, rounded to nearest (chip_bwd_variants.py, variant one-sum, shows
// the difference).
template <int NT>
__device__ __forceinline__ void tile_sum(float (&acc)[NT][4],
                                         const float (&part)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// The forward's online-softmax form: acc = alpha * acc + part in fp32 (one
// rounding), alpha[0] for row g of each fragment (elements 0, 1) and alpha[1]
// for row g + 8 (elements 2, 3).
template <int NT>
__device__ __forceinline__ void tile_sum(float (&acc)[NT][4],
                                         const float (&part)[NT][4],
                                         const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], part[n][e]);
}

// Lane coordinates of the mma fragments: group g = lane / 4, t = lane % 4.
__device__ __forceinline__ int lane_g() { return (threadIdx.x >> 2) & 7; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A = rows r0..r0+15, columns c0..c0+7 of a staged tile.
__device__ __forceinline__ FragA load_a(const float* s, int ld, int r0,
                                        int c0) {
  const float* p = s + (r0 + lane_g()) * ld + c0 + lane_t();
  FragA a;
  split(p[0], a.hi[0], a.lo[0]);
  split(p[8 * ld], a.hi[1], a.lo[1]);
  split(p[4], a.hi[2], a.lo[2]);
  split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  return a;
}

// B[k][n] = tile[n0 + n][k0 + k]: a tile whose rows run along n (S = Q K^T
// reads K's rows as the columns of K^T).
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld, int n0,
                                           int k0) {
  const float* p = s + (n0 + lane_g()) * ld + k0 + lane_t();
  FragB b;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4], b.hi[1], b.lo[1]);
  return b;
}

// B[k][n] = tile[k0 + perm(k)][n0 + n] with k = 0..7 taken in the order
// perm = 0, 2, 4, 6, 1, 3, 5, 7 of acc_to_a: row t of the fragment is tile
// row k0 + 2t, row t + 4 is k0 + 2t + 1.
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld, int k0,
                                           int n0) {
  const float* p = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  FragB b;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[ld], b.hi[1], b.lo[1]);
  return b;
}

// A 16 x 8 accumulator (c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8)
// as the A fragment of the next product, its columns in the order perm: the
// fragment's column t is accumulator column 2t and t + 4 is 2t + 1, so P and
// dS go from the score product to the update product without shared memory.
__device__ __forceinline__ FragA acc_to_a(const float (&c)[4]) {
  FragA a;
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
  return a;
}

}  // namespace tc

namespace bwd {

// Both backward kernels: warp w owns rows 16w..16w+15 of the block's own
// 64-row tile (keys in dK/dV, queries in dQ) and walks the other operand in
// tiles of kWalk rows.
constexpr int kRows = 64;
// 32 rows a walked tile: 64 left the dK/dV kernel at 255 registers, and the
// shorter tile also shortens each tensor-core sum (see tile_sum)
constexpr int kWalk = 32;

// P = exp(scale * S - LSE) on a live pair and an exact zero on a masked one;
// dS = P * (dP - Dr) * scale. Returns (P, dS).
__device__ __forceinline__ float2 p_ds(float s, float dp, float scale,
                                       float lse, float dr, bool live) {
  const float p = live ? expf(s * scale - lse) : 0.f;
  return make_float2(p, p * (dp - dr) * scale);
}

}  // namespace bwd
}  // namespace flash
