// flash_fwd.cu: blocked online-softmax attention forward, fp32-accurate on
// the tensor cores (3xTF32), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (with `_mask_scores`) of
// mxnet_tpu/parallel/flash_attention.py, which `_pallas_forward` launches.
// It computes, per (batch, head), O = softmax(scale * Q K^T + mask) V and the
// per-row LSE = m + log(l), from which the backward kernels recompute P.
// Masks (`live_pair` in flash_common.cuh): keys at or beyond Tk, the causal
// triangle (q_pos >= k_pos, top-left aligned when Tq != Tk), and for packed
// batches every cross-segment pair plus segment id 0. A masked score is
// -1e30, as in the reference, so its softmax weight is an exact zero beside
// any live key; a row with no live key gets the LSE -1e30, as the plain
// version, and an output that a masked loss ignores.
//
// What bounds it on an H100: per live (q, k) pair and head, 4*D flops (the
// two D-long contractions S = Q K^T and P V) against one read of Q, K and V
// and one write of O and the LSE. At the training shape (B8 T1024 H12 D64
// causal: 50.4 M live pairs, 12.9 GFLOP, 101 MB) it is bound by operations:
// in 3xTF32 (three TF32 products per product) 0.078 ms at 495 TFLOP/s; the
// same flops in fp32 on the CUDA cores would take 0.193 ms at 67 TFLOP/s, and
// the bytes 0.030 ms at 3.35 TB/s. The server prefills one prompt at a time
// (B1 H12, T up to 512): 1.2 GFLOP in 3xTF32, 2.4 us of tensor-core time, so
// there it is bound by how many SMs the grid keeps busy and by the latency of
// the longest warp's walk.
//
// Route: mma.sync.m16n8k8 TF32 with fp32 accumulation, 3xTF32 (flash::tc in
// flash_common.cuh, shared with flash_bwd_dkdv.cu and flash_bwd_dq.cu): each
// operand is split into hi = tf32(x) and lo = tf32(x - hi) and a product is
// lo*hi + hi*lo + hi*hi. Design, against what held the first, CUDA-core
// version back:
//   - both products run on the tensor cores. A block has four warps; each
//     warp owns 16 query rows and one of S slices of every walked key tile.
//     It computes S for them, runs the online softmax on the accumulator
//     fragments in registers (a row's max and sum reduce over the 4 lanes of
//     its quad), and feeds P straight into P V (`acc_to_a`, V read in the
//     matching permuted order): no P tile in shared memory and no block
//     barrier between the two products. In 16-row blocks at D <= 64 a
//     warp keeps Q's split fragments in registers for the whole walk; in
//     64-row blocks it re-splits them each tile, which leaves 168 registers
//     a thread and three blocks an SM (scratch/fwd_variants.py times both);
//   - fp32 accuracy: the tensor cores round each mma's sum toward zero, so
//     each walked tile's P V is summed on the tensor cores into a fresh
//     accumulator and added to the running O, rescaled by alpha, in fp32
//     (`tile_sum`);
//   - a grid that fills the card at the server's prefill rungs. S = 1: blocks
//     of 64 queries (four row groups) walk 32-key tiles; S = 4: 16 queries,
//     four warps on the one row group, each taking 16 keys of a 64-key tile
//     and merging its (m, l, O) with the others' through shared memory at
//     the end, in a fixed order. The host takes 64-row blocks when their
//     grid still has two blocks for each SM, else 16-row blocks
//     (`pick_split`): at the training shape 1536 blocks of 64 rows, at the
//     prefill rungs T 64..512 48..384 blocks of 16 rows, where the 64-row
//     grid had 12..96;
//   - staging overlaps the arithmetic: the Q tile stays for the whole block;
//     K/V tiles (with the keys' segment ids) run through a ring of two
//     stages filled by 16-byte cp.async (4-byte granules where D, H*D or a
//     pointer is not aligned to 16 bytes, chosen on the host); rows are D
//     padded to a multiple of 8 plus 4 floats, for aligned 16-byte copies and
//     bank-conflict-free fragment loads;
//   - causal work order: the query tile is the slow grid axis, in reverse, so
//     the last query tile, which walks every key tile, launches first; key
//     tiles past the block's last row are never loaded, and a warp whose
//     slice lies wholly past its rows' diagonal skips it; the mask
//     (`live_pair`) runs only on slices that straddle the diagonal or the
//     ragged edge, or in a segmented batch;
//   - no atomics: every sum runs in a fixed order, so two calls give
//     bit-identical O and LSE (as the TPU's sequential grid).
// Any Tq, Tk (ragged tiles are zero-filled and masked; nothing past Tq or Tk
// is read) and any D <= 128. Shared memory at D = 64: 52 KB (S = 1), 74 KB
// (S = 4); the launch raises the 48 KB default.
// Inputs use the JAX (B, T, H, D) layout directly; the LSE is (B, H, Tq);
// segment ids are one (B, T) plane indexed by b = bh / H.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::tc;

constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // the reference's masked score

// Query rows a block (16 a row group, kWarps / S row groups), keys a warp
// takes of each walked tile, and keys a walked tile.
template <int S>
__host__ __device__ constexpr int block_rows() { return 16 * kWarps / S; }
template <int S>
__host__ __device__ constexpr int warp_keys() { return S == 1 ? 32 : 16; }
template <int S>
__host__ __device__ constexpr int walk_keys() { return S * warp_keys<S>(); }
// Blocks an SM the registers are cut for: three 64-row blocks (168 registers
// a thread, Q not held in registers) at D <= 64, else two.
template <int NT, int S>
constexpr int kMinBlocks = S == 1 && NT <= 8 ? 3 : 2;

// The Q tile and two stages of K and V tiles, then two stages of key segment
// ids. The merge of the warps' (m, l, O) at the end reuses the K/V stages.
template <int NT, int S>
size_t smem_bytes() {
  constexpr int ld = row_floats<NT>(), BK = walk_keys<S>();
  return sizeof(float) * (size_t)(block_rows<S>() + 4 * BK) * ld +
         sizeof(int) * (size_t)(2 * BK);
}

template <int NT, int S>  // D <= 8 * NT; S warps share each row group
__global__ void __launch_bounds__(kThreads, kMinBlocks<NT, S>)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ seg,
           float* __restrict__ o, float* __restrict__ lse, int H, int Tq,
           int Tk, int D, float scale, int causal, int vec) {
  constexpr int ld = row_floats<NT>();
  constexpr int BQ = block_rows<S>(), KW = warp_keys<S>(), BK = S * KW;
  constexpr int NK = KW / 8;        // 8-key column tiles of a warp's slice
  // Q's split fragments stay in registers for the whole walk at S = 4 and
  // D <= 64; at S = 1 those registers buy a third block an SM instead
  constexpr bool kQReg = S > 1 && NT <= 8;
  static_assert(4 * BK * ld >= 16 * kWarps * (ld + 2) + BQ * S,
                "the merge fits in the K/V stages");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x ld
  float* ks = qs + BQ * ld;                     // 2 stages of BK x ld
  float* vs = ks + 2 * BK * ld;                 // 2 stages of BK x ld
  int* kseg = reinterpret_cast<int*>(vs + 2 * BK * ld);  // 2 x BK

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nq = min(BQ, Tq - q0);
  const int tid = threadIdx.x, w = tid >> 5, g = lane_g(), t = lane_t();
  const int r0 = 16 * (w / S);  // this warp's first row of the block's tile
  const int c0 = KW * (w % S);  // ... and first key of each walked tile
  const bool segmented = seg != nullptr;
  const long rs = (long)H * D;  // stride between positions
  const float* qb = q + ((long)b * Tq * H + h) * D;
  const float* kb = k + ((long)b * Tk * H + h) * D;
  const float* vb = v + ((long)b * Tk * H + h) * D;

  zero_pad<NT>(qs, BQ + 4 * BK, D);  // Q and both K/V stages
  stage_rows<BQ, NT>(qs, qb, q0, nq, rs, D, vec);
  cp_async_commit();

  // this thread's two query rows (r0 + g and r0 + g + 8): segment ids, and
  // the running max and this thread's share of the running sum
  int qseg_r[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + g + 8 * i;
    qseg_r[i] = (segmented && qp < Tq) ? seg[(long)b * Tq + qp] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  // one key tile's K and V rows and segment ids into stage st
  auto stage_k = [&](int k0, int st) {
    const int nk = min(BK, Tk - k0);
    stage_rows<BK, NT>(ks + st * BK * ld, kb, k0, nk, rs, D, vec);
    stage_rows<BK, NT>(vs + st * BK * ld, vb, k0, nk, rs, D, vec);
    if (segmented && tid < BK) {
      const bool in = tid < nk;
      cp_async4(reinterpret_cast<float*>(&kseg[st * BK + tid]),
                reinterpret_cast<const float*>(
                    in ? seg + (long)b * Tk + k0 + tid : seg),
                in);
    }
  };

  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  if (ntiles > 0) stage_k(0, 0);
  cp_async_commit();  // the first key tile

  FragA qf[kQReg ? NT : 1];
  if constexpr (kQReg) {
    cp_async_wait<1>();  // the Q tile
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) qf[kk] = load_a(qs, ld, r0, 8 * kk);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = it * BK;
    if (it + 1 < ntiles) {  // the next tile's copies run under this one
      stage_k(k0 + BK, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage has landed for every thread
    const int kw = k0 + c0;  // this warp's first key
    // a slice wholly past Tk, or past the diagonal of all the warp's rows,
    // holds no live pair
    if (kw < Tk && !(causal && kw > q0 + r0 + 15)) {
      const float* kt = ks + st * BK * ld;
      const float* vt = vs + st * BK * ld;

      // S = Q K^T for this warp's 16 queries and KW keys
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        FragA a;
        if constexpr (kQReg) a = qf[kk];
        else a = load_a(qs, ld, r0, 8 * kk);
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mma3(s[n], a, load_b_nk(kt, ld, c0 + 8 * n, 8 * kk));
      }

      // scale and mask (only where the slice needs a mask), the rows' max
      const bool full = !segmented && kw + KW <= Tk &&
                        (!causal || q0 + r0 >= kw + KW - 1);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = c0 + 8 * n + 2 * t + (e & 1);  // key of the tile
          const bool live =
              full || live_pair(q0 + r0 + g + 8 * i, k0 + c, Tk, causal,
                                segmented, qseg_r[i], kseg[st * BK + c]);
          s[n][e] = live ? s[n][e] * scale : kNeg;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      // a row's scores lie in the 4 lanes of its quad
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - mnew);  // 0 on the first slice
        m[i] = mnew;
        l[i] *= alpha[i];
      }
      // P in place; this thread's share of the rows' sums
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }

      // this tile's P V, summed over its keys on the tensor cores, then
      // added to the rescaled O in fp32 (see tile_sum)
      float pv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const FragA ap = acc_to_a(s[j]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma3(pv[n], ap, load_b_kn(vt, ld, c0 + 8 * j, 8 * n));
      }
      tile_sum(acc, pv, alpha);
    }
    __syncthreads();  // every reader is done before the stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the kernel (Tk == 0)

  // the rows' sums over their quads
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if (S == 1) {  // one warp a row group: O = acc / l straight from registers
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 4 * (e & 2), d = 8 * n + 2 * t + (e & 1);
        if (r < nq && d < D)
          o[((long)b * Tq + q0 + r) * rs + (long)h * D + d] =
              acc[n][e] / fmaxf(l[e >> 1], 1e-30f);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (t == 0 && r < nq)
        lse[(long)bh * Tq + q0 + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
    return;
  }

  // S warps a row group: each warp's (m, l, O) into the K/V stages, then
  // per row the merge factors exp(m_s - M) / L, then O = sum_s factor_s O_s
  float* os = ks;                     // kWarps x 16 rows x ld: warp w's O
  float* ms = os + kWarps * 16 * ld;  // kWarps x 16
  float* ls = ms + kWarps * 16;       // kWarps x 16
  float* cf = ls + kWarps * 16;       // BQ x S
  __syncthreads();  // no warp still reads a stage (or pads one: Tk == 0)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      os[(16 * w + g + 4 * (e & 2)) * ld + 8 * n + 2 * t + (e & 1)] =
          acc[n][e];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ms[16 * w + g + 8 * i] = m[i];
      ls[16 * w + g + 8 * i] = l[i];
    }
  }
  __syncthreads();
  if (tid < BQ) {
    // row tid: warp (tid / 16) * S + s holds its slice s at row tid % 16
    const int base = (tid / 16) * S * 16 + tid % 16;
    float mm = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) mm = fmaxf(mm, ms[base + 16 * s]);
    float f[S], sum = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // a slice that saw no key (m = -inf) adds nothing; no key at all
      // (Tk == 0) leaves O = 0 and LSE = -inf, as one warp would
      f[s] = mm == -INFINITY ? 0.f : expf(ms[base + 16 * s] - mm);
      sum = fmaf(f[s], ls[base + 16 * s], sum);
    }
    sum = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int s = 0; s < S; ++s) cf[tid * S + s] = f[s] / sum;
    if (tid < nq) lse[(long)bh * Tq + q0 + tid] = mm + logf(sum);
  }
  __syncthreads();
  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int base = (r / 16) * S * 16 + r % 16;
    float x = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      x = fmaf(cf[r * S + s], os[(base + 16 * s) * ld + d], x);
    o[((long)b * Tq + q0 + r) * rs + (long)h * D + d] = x;
  }
}

template <int NT, int S>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* seg, float* o, float* lse, int B, int H, int Tq,
                   int Tk, int D, float scale, int causal, int vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<NT, S>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<NT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // (b*h, query tile in reverse): the last query tile, the longest under a
  // causal mask, first
  constexpr int BQ = block_rows<S>();
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  fwd_kernel<NT, S><<<grid, kThreads, smem, stream>>>(
      q, k, v, seg, o, lse, H, Tq, Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_split(const float* q, const float* k, const float* v,
                         const int* seg, float* o, float* lse, int B, int H,
                         int Tq, int Tk, int D, float scale, int causal,
                         int vec, int split, cudaStream_t s) {
  if (split == 1)
    return launch<NT, 1>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                         causal, vec, s);
  if (split == 4)
    return launch<NT, 4>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                         causal, vec, s);
  return cudaErrorInvalidValue;
}

// The host's choice of S: 64-row blocks (no staging shared by warps, no
// merge) when their grid has at least two blocks for each SM of the current
// device; else 16-row blocks, four times the grid.
int pick_split(int B, int H, int Tq) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  constexpr int rows = block_rows<1>();
  return (long)((Tq + rows - 1) / rows) * B * H >= 2L * sms ? 1 : 4;
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D), seg (B, Tq) int32 or null (then
// Tq == Tk), o (B, Tq, H, D), lse (B, H, Tq); all contiguous fp32 on the
// device. `split` is S, the warps that share a row group (1 or 4), or 0
// for the host's choice; the port calls mxt_flash_fwd, measurement code
// forces S here. Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_fwd_split(const float* q, const float* k,
                                   const float* v, const int* seg, float* o,
                                   float* lse, int B, int H, int Tq, int Tk,
                                   int D, float scale, int causal, int split,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte granules need 16-byte aligned rows: D % 4 == 0 (then H*D too)
  // and aligned bases
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = D % 4 == 0 && bases % 16 == 0;
  if (split == 0) split = pick_split(B, H, Tq);
  if (D <= 16)
    return launch_split<2>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                           causal, vec, split, s);
  if (D <= 32)
    return launch_split<4>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                           causal, vec, split, s);
  if (D <= 64)
    return launch_split<8>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                           causal, vec, split, s);
  if (D <= 128)
    return launch_split<16>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                            causal, vec, split, s);
  return (int)cudaErrorInvalidValue;
}

// The same with the host's choice of S.
extern "C" int mxt_flash_fwd(const float* q, const float* k, const float* v,
                             const int* seg, float* o, float* lse, int B,
                             int H, int Tq, int Tk, int D, float scale,
                             int causal, void* stream) {
  return mxt_flash_fwd_split(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale,
                             causal, 0, stream);
}
