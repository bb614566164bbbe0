// flash_common.cuh: what the flash-attention kernels share — the cp.async
// staging and the mask rule; for the two decode kernels (flash_decode.cu,
// flash_decode_q8.cu) the host's split of the cache, the lane groups'
// online-softmax step over one stage of keys, and the merges in a fixed
// order within a block and across a cluster of blocks; for the forward
// (flash_fwd.cu) and the two backward kernels (flash_bwd_dkdv.cu,
// flash_bwd_dq.cu) the tensor-core tiles (namespace tc: padded rows, 16-byte
// staging, the 3xTF32 mma.sync product and its fragment loads, the hand-over
// of an accumulator as the next product's A operand); and the backward's
// tile shape and P/dS step. Each kernel source includes it; _build.py hashes
// it into every library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

// Asynchronous global -> shared copies (sm_80+): 4 bytes through L1, 16
// bytes through L2 only. With `pred` false they read nothing and write
// zeros, so ragged tiles need no second path.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// Thread block clusters (sm_90): launch_clusters starts `grid` blocks of
// kernel in clusters of `cluster` consecutive blocks, which the card
// schedules together; a cluster's blocks meet at cluster_sync(), after which
// each sees what the others wrote to their shared memory before it, through
// peer(): the same shared-memory address in another block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ const float* peer(const float* p, int rank) {
  const float* q;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(q) : "l"(p), "r"(rank));
  return q;
}

template <class... Params, class... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int grid,
                                   int cluster, int block, size_t smem,
                                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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

// The two decode kernels (flash_decode.cu, flash_decode_q8.cu) cut each
// (batch, head) row's cached positions into S chunks, one block of kThreads
// threads a chunk, the row's S blocks one cluster, and merge the chunks'
// partial softmax states across the cluster. In a block, lane groups of L
// lanes each take one key at a time: lane i of a group holds columns
// 4i..4i+3 of q, of the key and of the group's running P V sum, so a key
// row is 4 L floats wide (L = lanes(D), 4 L >= D). One stage of the ring of
// staged keys gives every group kBatch keys.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;
constexpr int kStages = 2;
// The grid the host aims at: this many blocks for each SM; and the most
// splits a row: a row's splits form one cluster, of at most 8 blocks on
// every Hopper card.
constexpr int kBlocksPerSM = 4;
constexpr int kMaxSplits = 8;

// Lanes a key row: the least power of two L >= 4 with 4 L >= D (D <= 128).
__host__ __device__ constexpr int lanes(int D) {
  return D <= 16 ? 4 : D <= 32 ? 8 : D <= 64 ? 16 : 32;
}

// Keys in one stage: kBatch for each of the block's kThreads / L groups.
__host__ __device__ constexpr int tile_keys(int L) {
  return kThreads / L * kBatch;
}

// Keys a chunk: T cut into S parts.
inline int chunk_keys(int T, int S) { return ((T > 1 ? T : 1) + S - 1) / S; }

// The host's number of splits for BH rows of T cached positions, from the
// shapes alone (the lengths are on the device, and the entry points do not
// synchronise): enough blocks for kBlocksPerSM on each SM of the current
// device, but no chunk shorter than one stage, and at most kMaxSplits.
inline int pick_splits(int BH, int T, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int tk = tile_keys(lanes(D));
  const int most = (T + tk - 1) / tk;
  const int want = BH > 0 ? (kBlocksPerSM * sms + BH - 1) / BH : 1;
  int S = want < most ? want : most;
  S = S < kMaxSplits ? S : kMaxSplits;
  const int chunk = chunk_keys(T, S > 1 ? S : 1);
  return T > chunk ? (T + chunk - 1) / chunk : 1;
}

// A lane group's online softmax over the keys it has taken: the largest
// score m and l = sum exp(score - m), the same in every lane of the group,
// and this lane's 4 columns of sum exp(score - m) v. No key: m = -inf, l = 0.
struct State {
  float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
};

// Folds (mo, lo, acco) into (m, l, acc), both rescaled to the larger max. A
// side that holds the max keeps weight 1, so two empty sides stay empty (and
// never take exp(-inf + inf)); an empty side gets weight 0 beside a live one.
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[4],
                                      float mo, float lo,
                                      const float (&acco)[4]) {
  const float mn = fmaxf(m, mo);
  const float a = m == mn ? 1.f : expf(m - mn);
  const float b = mo == mn ? 1.f : expf(mo - mn);
  l = fmaf(l, a, lo * b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = fmaf(acc[i], a, acco[i] * b);
  m = mn;
}

// One stage of the online softmax for the calling lane's group g: its keys
// are the stage's rows g, g + G, ..., g + (kBatch - 1) G (G groups in the
// block), those below nk live; `Tile` (F32Tile of flash_decode.cu, Q8Tile
// of flash_decode_q8.cu) gives a row's 4 values at the lane's columns as
// fp32. A score q.k is summed over the group's lanes by a shuffle
// butterfly (every lane of the warp takes part, so all lanes of a group get
// the same sum); the group's state is rescaled once for the batch. Both
// kernels run exactly this on the same fp32 values, so they give
// bit-identical outputs.
template <int L, class Tile>
__device__ __forceinline__ void tile_step(const Tile& t, int nk,
                                          const float (&q)[4], float scale,
                                          State& st) {
  constexpr int G = kThreads / L;
  const int g = (int)threadIdx.x / L;
  const int c = 4 * ((int)threadIdx.x % L);
  float s[kBatch];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int r = g + j * G;
    float dot = 0.f;
    if (r < nk) {
      const float4 k = t.key(r, c);
      dot = fmaf(q[0], k.x, dot);
      dot = fmaf(q[1], k.y, dot);
      dot = fmaf(q[2], k.z, dot);
      dot = fmaf(q[3], k.w, dot);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    s[j] = dot * scale;
    if (r < nk) mx = fmaxf(mx, s[j]);
  }
  if (mx == -INFINITY) return;  // no live key in the group's batch
  const float mn = fmaxf(st.m, mx);
  const float alpha = expf(st.m - mn);  // 0 on the group's first live batch
  st.l *= alpha;
#pragma unroll
  for (int i = 0; i < 4; ++i) st.acc[i] *= alpha;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int r = g + j * G;
    if (r < nk) {
      const float p = expf(s[j] - mn);
      st.l += p;
      const float4 v = t.val(r, c);
      st.acc[0] = fmaf(p, v.x, st.acc[0]);
      st.acc[1] = fmaf(p, v.y, st.acc[1]);
      st.acc[2] = fmaf(p, v.z, st.acc[2]);
      st.acc[3] = fmaf(p, v.w, st.acc[3]);
    }
  }
  st.m = mn;
}

// Shared memory for finish: kWarps slots of (m, l, 4 L columns).
__host__ __device__ constexpr int merge_floats(int L) {
  return kWarps * (2 + 4 * L);
}

// The end of a block of split `split` (of S, the block's rank in its
// cluster) of row bh: its lane groups' states merged, and the row's splits
// merged, into o_row = acc / max(l, 1e-30). Every merge runs in a fixed
// order, so two calls on one input are bit-identical: the groups of each
// warp by a shuffle butterfly; warps 1, 2, 3 into warp 0 in turn, through
// `red` (merge_floats(L) floats of shared memory; warp 0's slot then holds
// the block's state); with S > 1, the cluster's other blocks into the
// block of split 0 in split order, read from their slots across the
// cluster. A block with no live key takes part with m = -inf, l = 0, which
// drops out of every merge (a row with no live key gets o = 0).
template <int L>
__device__ __forceinline__ void finish(State& st, float* red, int D, int S,
                                       int split, float* o_row) {
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
    float ao[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ao[i] = __shfl_xor_sync(0xffffffffu, st.acc[i], off);
    const float mo = __shfl_xor_sync(0xffffffffu, st.m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, st.l, off);
    merge(st.m, st.l, st.acc, mo, lo, ao);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool lead = w == 0 && lane < L;  // holds the block's state
  if (w > 0 && lane < L) {
    float* slot = red + w * (2 + 4 * L);
    slot[0] = st.m;
    slot[1] = st.l;
#pragma unroll
    for (int i = 0; i < 4; ++i) slot[2 + 4 * lane + i] = st.acc[i];
  }
  __syncthreads();
  if (lead) {
    for (int v = 1; v < kWarps; ++v) {
      const float* slot = red + v * (2 + 4 * L);
      const float ao[4] = {slot[2 + 4 * lane], slot[3 + 4 * lane],
                           slot[4 + 4 * lane], slot[5 + 4 * lane]};
      merge(st.m, st.l, st.acc, slot[0], slot[1], ao);
    }
  }
  if (S > 1) {
    if (lead) {  // warp 0's slot, which no warp wrote: the block's state
      red[0] = st.m;
      red[1] = st.l;
#pragma unroll
      for (int i = 0; i < 4; ++i) red[2 + 4 * lane + i] = st.acc[i];
    }
    cluster_sync();  // every block's state is in its slot
    if (lead && split == 0)
      for (int r = 1; r < S; ++r) {
        const float* slot = peer(red, r);
        const float ao[4] = {slot[2 + 4 * lane], slot[3 + 4 * lane],
                             slot[4 + 4 * lane], slot[5 + 4 * lane]};
        merge(st.m, st.l, st.acc, slot[0], slot[1], ao);
      }
    cluster_sync();  // no block leaves while split 0 reads its slot
  }
  if (lead && split == 0) {
    const int c = 4 * lane;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < D) o_row[c + i] = st.acc[i] / fmaxf(st.l, 1e-30f);
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
