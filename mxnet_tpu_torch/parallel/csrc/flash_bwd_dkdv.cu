// flash_bwd_dkdv.cu: the key/value half of the flash-attention backward pass,
// fp32-accurate on the tensor cores (3xTF32), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_dkdv_kernel` (with `_mask_scores`) of
// mxnet_tpu/parallel/flash_attention.py, which `_pallas_backward` launches.
// Per (batch, head) and key block it recomputes the probabilities from the
// forward's row LSE instead of reading a stored (Tq, Tk) matrix:
//   S  = scale * Q K^T, masked      P  = exp(S - LSE)   (0 where masked)
//   dV = P^T dO                     dP = dO V^T
//   dS = P * (dP - Dr) * scale      dK = dS^T Q
// where Dr = rowsum(dO * O) comes from the caller. The mask is every kernel's
// (`live_pair` in flash_common.cuh): keys at or beyond Tk, the causal
// triangle (q_pos >= k_pos, top-left aligned when Tq != Tk), and for packed
// batches every cross-segment pair plus segment id 0. A masked pair's P is an
// exact zero, so rows that attend to nothing (segment 0) contribute nothing
// here, whatever their cotangent.
//
// What bounds it on an H100: per live (q, k) pair and head, 8*D flops (the
// four D-long contractions S, dP, dV, dK) against one read of Q, K, V, dO,
// LSE and Dr and one write of dK and dV. At the training shape (B8 T1024 H12
// D64 causal: 50.4 M live pairs, 25.8 GFLOP, 151.8 MB) it is bound by
// operations: in 3xTF32 (three TF32 products per product) 0.156 ms at
// 495 TFLOP/s; the same flops in fp32 on the CUDA cores would take 0.385 ms
// at 67 TFLOP/s, and the bytes 0.045 ms at 3.35 TB/s.
//
// Route: mma.sync.m16n8k8 TF32 with fp32 accumulation, 3xTF32 (flash::tc in
// flash_common.cuh): each operand is split into hi = tf32(x) and
// lo = tf32(x - hi) and a product is lo*hi + hi*lo + hi*hi, which keeps
// fp32's accuracy (one TF32 pass would be ~1e-3 off). Design, against what
// held the first, CUDA-core version back:
//   - all four contractions run on the tensor cores. One block owns one
//     (batch*head, 64-key tile), dK and dV in registers; warp w owns keys
//     16w..16w+15 and computes S^T = K Q^T and dP^T = V dO^T for them, so
//     P^T and dS^T come out as accumulators that feed dV = P^T dO and
//     dK = dS^T Q straight from registers (`acc_to_a`: the query index is
//     taken in a permuted order, and dO and Q are read in the same order);
//   - staging overlaps the arithmetic: the K and V tiles stay for the whole
//     block; the Q/dO tiles (with the rows' LSE, Dr and segment ids) run
//     through a ring of two stages filled by 16-byte cp.async, so the next
//     query tile lands while this one is computed. Where D or H*D is not a
//     multiple of 4 floats, or a pointer is not 16-byte aligned, the host
//     picks 4-byte granules;
//   - rows are D padded to a multiple of 8 plus 4 floats (not D + 1): 16-byte
//     copies stay aligned and every fragment load is free of bank conflicts;
//   - causal work order: the key tile is the slow grid axis and key tile 0,
//     which walks every query tile, launches first, so the longest blocks
//     start first and the short ones fill the tail; query tiles wholly above
//     the key tile are never loaded;
//   - the mask (`live_pair`) runs only on tiles that straddle the diagonal or
//     the ragged edge, or in a segmented batch; other tiles take none;
//   - no atomics: a block sums its query tiles in a fixed order, so two
//     calls give bit-identical dK and dV (as the TPU's sequential grid). The
//     price is recomputing S and dP in flash_bwd_dq.cu.
// Any Tq, Tk (ragged tiles are zero-filled and masked; nothing past Tq or Tk
// is read) and any D <= 128. Shared memory is K and V (64 rows each) and two
// stages of Q and dO (32 rows each): 70 KB at D = 64, above the 48 KB default,
// so the launch raises the limit.
// Inputs use the JAX (B, T, H, D) layout directly; LSE and Dr are (B, H, Tq),
// as flash_fwd.cu writes the LSE; segment ids are one (B, T) plane indexed by
// b = bh / H.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::tc;
using namespace flash::bwd;

template <int NT>
size_t smem_bytes() {
  constexpr int ld = row_floats<NT>(), BQ = kWalk;
  return sizeof(float) * (size_t)(2 * kRows * ld + 4 * BQ * ld + 4 * BQ) +
         sizeof(int) * (size_t)(2 * BQ + kRows);
}

// Two blocks an SM: at D = 64 a thread takes 236 registers (three blocks would
// cap it at 168).
constexpr int kBlocksPerSM = 2;

template <int NT>  // D <= 8 * NT
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dcap,
            const int* __restrict__ seg, float* __restrict__ dk,
            float* __restrict__ dv, int H, int Tq, int Tk, int D, float scale,
            int causal, int vec) {
  constexpr int ld = row_floats<NT>(), BQ = kWalk, NQ = BQ / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kRows x ld
  float* vs = ks + kRows * ld;                  // kRows x ld
  float* qs = vs + kRows * ld;                  // 2 stages of BQ x ld
  float* dos = qs + 2 * BQ * ld;                // 2 stages of BQ x ld
  float* lse_s = dos + 2 * BQ * ld;             // 2 x BQ
  float* dr_s = lse_s + 2 * BQ;                 // 2 x BQ
  int* qseg = reinterpret_cast<int*>(dr_s + 2 * BQ);  // 2 x BQ
  int* kseg = qseg + 2 * BQ;                          // kRows

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kRows;
  const int nk = min(kRows, Tk - k0);
  const int tid = threadIdx.x, w = tid >> 5, g = lane_g(), t = lane_t();
  const bool segmented = seg != nullptr;
  const long rs = (long)H * D;  // stride between positions
  const float* qb = q + ((long)b * Tq * H + h) * D;
  const float* dob = dout + ((long)b * Tq * H + h) * D;
  const float* kb = k + ((long)b * Tk * H + h) * D;
  const float* vb = v + ((long)b * Tk * H + h) * D;

  zero_pad<NT>(ks, 2 * kRows + 4 * BQ, D);  // K, V and both Q/dO stages
  stage_rows<kRows, NT>(ks, kb, k0, nk, rs, D, vec);
  stage_rows<kRows, NT>(vs, vb, k0, nk, rs, D, vec);
  if (segmented && tid < kRows)
    kseg[tid] = tid < nk ? seg[(long)b * Tk + k0 + tid] : 0;

  // one query tile's Q and dO rows, LSE, Dr and segment ids into stage st
  auto stage_q = [&](int q0, int st) {
    const int nq = min(BQ, Tq - q0);
    stage_rows<BQ, NT>(qs + st * BQ * ld, qb, q0, nq, rs, D, vec);
    stage_rows<BQ, NT>(dos + st * BQ * ld, dob, q0, nq, rs, D, vec);
    if (tid < BQ) {
      const bool in = tid < nq;
      const long row = (long)bh * Tq + q0 + tid;
      cp_async4(&lse_s[st * BQ + tid], in ? lse + row : lse, in);
      cp_async4(&dr_s[st * BQ + tid], in ? dcap + row : dcap, in);
      if (segmented)
        cp_async4(reinterpret_cast<float*>(&qseg[st * BQ + tid]),
                  reinterpret_cast<const float*>(
                      in ? seg + (long)b * Tq + q0 + tid : seg),
                  in);
    }
  };

  float acck[NT][4], accv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;

  // causal: query tile q0 sees this key tile iff q0 + BQ - 1 >= k0
  const int qstart = causal ? k0 - k0 % BQ : 0;
  const int ntiles = qstart < Tq ? (Tq - qstart + BQ - 1) / BQ : 0;
  if (ntiles > 0) stage_q(qstart, 0);
  cp_async_commit();  // K, V and the first query tile

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, q0 = qstart + it * BQ;
    if (it + 1 < ntiles) {  // the next tile's copies run under this one
      stage_q(q0 + BQ, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage has landed for every thread
    const float* qt = qs + st * BQ * ld;
    const float* dot = dos + st * BQ * ld;
    const float* lt = lse_s + st * BQ;
    const float* drt = dr_s + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const FragA ak = load_a(ks, ld, 16 * w, 8 * kk);
      const FragA av = load_a(vs, ld, 16 * w, 8 * kk);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        mma3(s[n], ak, load_b_nk(qt, ld, 8 * n, 8 * kk));
        mma3(dp[n], av, load_b_nk(dot, ld, 8 * n, 8 * kk));
      }
    }

    // P^T and dS^T in place; the mask only where the tile needs one
    const bool full = !segmented && q0 + BQ <= Tq && k0 + kRows <= Tk &&
                      (!causal || q0 >= k0 + kRows - 1);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);  // query of the tile
        const int r = 16 * w + g + 4 * (e & 2);  // key of the tile
        const bool live =
            full || (q0 + c < Tq &&
                     live_pair(q0 + c, k0 + r, Tk, causal, segmented,
                               qseg[st * BQ + c], kseg[r]));
        const float2 pd = p_ds(s[n][e], dp[n][e], scale, lt[c], drt[c], live);
        s[n][e] = pd.x;
        dp[n][e] = pd.y;
      }

    // this tile's P^T dO and dS^T Q, summed over its queries on the tensor
    // cores, then added to dV and dK in fp32 (see tile_sum)
    float pv[NT][4], pk[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = pk[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const FragA ap = acc_to_a(s[j]);
      const FragA ads = acc_to_a(dp[j]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(pv[n], ap, load_b_kn(dot, ld, 8 * j, 8 * n));
        mma3(pk[n], ads, load_b_kn(qt, ld, 8 * j, 8 * n));
      }
    }
    tile_sum(accv, pv);
    tile_sum(acck, pk);
    __syncthreads();  // every reader is done before the stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the kernel (no live query tile)

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 4 * (e & 2), d = 8 * n + 2 * t + (e & 1);
      if (r < nk && d < D) {
        const long off = ((long)b * Tk + k0 + r) * rs + (long)h * D + d;
        dk[off] = acck[n][e];
        dv[off] = accv[n][e];
      }
    }
}

template <int NT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dcap,
                   const int* seg, float* dk, float* dv, int B, int H, int Tq,
                   int Tk, int D, float scale, int causal, int vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // (b*h, key tile): key tile 0, the longest under a causal mask, first
  const dim3 grid(B * H, (Tk + kRows - 1) / kRows);
  dkdv_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, seg, dk, dv, H, Tq, Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

}  // namespace

// q and dout (B, Tq, H, D), k and v (B, Tk, H, D), lse and dcap (B, H, Tq),
// seg (B, Tq) int32 or null (then Tq == Tk), dk and dv (B, Tk, H, D); all
// contiguous fp32 on the device. Returns the launch's cudaError_t (0 on
// success).
extern "C" int mxt_flash_bwd_dkdv(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* dcap,
                                  const int* seg, float* dk, float* dv, int B,
                                  int H, int Tq, int Tk, int D, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte granules need 16-byte aligned rows: D % 4 == 0 (then H*D too)
  // and aligned bases
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)dout;
  const int vec = D % 4 == 0 && bases % 16 == 0;
  if (D <= 16)
    return launch<2>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, vec, s);
  if (D <= 32)
    return launch<4>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, vec, s);
  if (D <= 64)
    return launch<8>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, vec, s);
  if (D <= 128)
    return launch<16>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                      scale, causal, vec, s);
  return (int)cudaErrorInvalidValue;
}
