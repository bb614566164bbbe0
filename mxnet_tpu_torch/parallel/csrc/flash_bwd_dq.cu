// flash_bwd_dq.cu: the query half of the flash-attention backward pass,
// fp32-accurate on the tensor cores (3xTF32), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_dq_kernel` (with `_mask_scores`) of
// mxnet_tpu/parallel/flash_attention.py, which `_pallas_backward` launches.
// Per (batch, head) and query block it recomputes the probabilities from the
// forward's row LSE and sums over the key blocks:
//   S  = scale * Q K^T, masked      P  = exp(S - LSE)   (0 where masked)
//   dP = dO V^T                     dS = P * (dP - Dr) * scale
//   dQ = dS K
// where Dr = rowsum(dO * O) comes from the caller. The mask is every kernel's
// (`live_pair` in flash_common.cuh): keys at or beyond Tk, the causal triangle
// (q_pos >= k_pos, top-left aligned when Tq != Tk), cross-segment pairs and
// segment id 0. A masked pair's P is an exact zero, so a row with no live key
// gets an exact-zero dQ.
//
// What bounds it on an H100: per live (q, k) pair and head, 6*D flops (the
// three D-long contractions S, dP, dQ) against one read of Q, K, V, dO, LSE
// and Dr and one write of dQ. At the training shape (B8 T1024 H12 D64 causal:
// 50.4 M live pairs, 19.3 GFLOP, 126.6 MB) it is bound by operations: in
// 3xTF32 0.117 ms at 495 TFLOP/s; the same flops in fp32 on the CUDA cores
// would take 0.289 ms at 67 TFLOP/s, and the bytes 0.038 ms at 3.35 TB/s.
//
// Route: mma.sync.m16n8k8 TF32 with fp32 accumulation, 3xTF32 (flash::tc in
// flash_common.cuh, as flash_bwd_dkdv.cu). Design, against what held the
// first, CUDA-core version back:
//   - all three contractions run on the tensor cores. One block owns one
//     (batch*head, 64-query tile), dQ in registers; warp w owns queries
//     16w..16w+15, computes S = Q K^T and dP = dO V^T for them, and feeds dS
//     from its accumulators straight into dQ = dS K (`acc_to_a`, K read in
//     the matching permuted order); each thread keeps its two rows' LSE, Dr
//     and segment ids in registers;
//   - staging overlaps the arithmetic: Q and dO stay for the whole block; the
//     K/V tiles (with the keys' segment ids) run through a ring of two stages
//     filled by 16-byte cp.async (4-byte granules where D, H*D or a pointer
//     is not aligned to 16 bytes, chosen on the host);
//   - rows are D padded to a multiple of 8 plus 4 floats: aligned 16-byte
//     copies and bank-conflict-free fragment loads;
//   - causal work order: the query tile is the slow grid axis, in reverse, so
//     the last query tile, which walks every key tile, launches first; key
//     tiles past the query tile's last row are never loaded;
//   - the mask (`live_pair`) runs only on tiles that straddle the diagonal or
//     the ragged edge, or in a segmented batch;
//   - no atomics: a block sums its key tiles in a fixed order, so two calls
//     give bit-identical dQ (as the TPU's sequential grid); S and dP are
//     recomputed here rather than shared with flash_bwd_dkdv.cu.
// Any Tq, Tk (ragged tiles are zero-filled and masked; nothing past Tq or Tk
// is read) and any D <= 128. Shared memory is Q and dO (64 rows each) and two
// stages of K and V (32 rows each): 70 KB at D = 64, above the 48 KB default,
// so the launch raises the limit.
// Inputs use the JAX (B, T, H, D) layout directly; LSE and Dr are (B, H, Tq);
// segment ids are one (B, T) plane indexed by b = bh / H.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::tc;
using namespace flash::bwd;

template <int NT>
size_t smem_bytes() {
  constexpr int ld = row_floats<NT>(), BK = kWalk;
  return sizeof(float) * (size_t)(2 * kRows * ld + 4 * BK * ld) +
         sizeof(int) * (size_t)(2 * BK);
}

// Three blocks an SM (70 KB of shared memory each at D = 64): ptxas then
// keeps a thread at 168 registers, without spills at D <= 64.
constexpr int kBlocksPerSM = 3;

template <int NT>  // D <= 8 * NT
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dcap,
          const int* __restrict__ seg, float* __restrict__ dq, int H, int Tq,
          int Tk, int D, float scale, int causal, int vec) {
  constexpr int ld = row_floats<NT>(), BK = kWalk, NK = BK / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kRows x ld
  float* dos = qs + kRows * ld;                 // kRows x ld
  float* ks = dos + kRows * ld;                 // 2 stages of BK x ld
  float* vs = ks + 2 * BK * ld;                 // 2 stages of BK x ld
  int* kseg = reinterpret_cast<int*>(vs + 2 * BK * ld);  // 2 x BK

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nq = min(kRows, Tq - q0);
  const int tid = threadIdx.x, w = tid >> 5, g = lane_g(), t = lane_t();
  const bool segmented = seg != nullptr;
  const long rs = (long)H * D;  // stride between positions
  const float* qb = q + ((long)b * Tq * H + h) * D;
  const float* dob = dout + ((long)b * Tq * H + h) * D;
  const float* kb = k + ((long)b * Tk * H + h) * D;
  const float* vb = v + ((long)b * Tk * H + h) * D;

  zero_pad<NT>(qs, 2 * kRows + 4 * BK, D);  // Q, dO and both K/V stages
  stage_rows<kRows, NT>(qs, qb, q0, nq, rs, D, vec);
  stage_rows<kRows, NT>(dos, dob, q0, nq, rs, D, vec);

  // this thread's two query rows (16w + g and 16w + g + 8)
  float lse_r[2], dr_r[2];
  int qseg_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + 16 * w + g + 8 * i;
    const bool in = qp < Tq;
    lse_r[i] = in ? lse[(long)bh * Tq + qp] : 0.f;
    dr_r[i] = in ? dcap[(long)bh * Tq + qp] : 0.f;
    qseg_r[i] = (segmented && in) ? seg[(long)b * Tq + qp] : 0;
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

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kend = causal ? min(Tk, q0 + kRows) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  if (ntiles > 0) stage_k(0, 0);
  cp_async_commit();  // Q, dO and the first key tile

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
    const float* kt = ks + st * BK * ld;
    const float* vt = vs + st * BK * ld;

    // S = Q K^T and dP = dO V^T for this warp's 16 queries
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const FragA aq = load_a(qs, ld, 16 * w, 8 * kk);
      const FragA ao = load_a(dos, ld, 16 * w, 8 * kk);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mma3(s[n], aq, load_b_nk(kt, ld, 8 * n, 8 * kk));
        mma3(dp[n], ao, load_b_nk(vt, ld, 8 * n, 8 * kk));
      }
    }

    // dS in place; the mask only where the tile needs one
    const bool full = !segmented && q0 + kRows <= Tq && k0 + BK <= Tk &&
                      (!causal || q0 >= k0 + BK - 1);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = 16 * w + g + 8 * i;        // query of the tile
        const int c = 8 * n + 2 * t + (e & 1);   // key of the tile
        const bool live =
            full || (q0 + r < Tq &&
                     live_pair(q0 + r, k0 + c, Tk, causal, segmented,
                               qseg_r[i], kseg[st * BK + c]));
        dp[n][e] = p_ds(s[n][e], dp[n][e], scale, lse_r[i], dr_r[i], live).y;
      }

    // this tile's dS K, summed over its keys on the tensor cores, then added
    // to dQ in fp32 (see tile_sum)
    float pq[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pq[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const FragA ads = acc_to_a(dp[j]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3(pq[n], ads, load_b_kn(kt, ld, 8 * j, 8 * n));
    }
    tile_sum(acc, pq);
    __syncthreads();  // every reader is done before the stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the kernel (Tk == 0)

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 4 * (e & 2), d = 8 * n + 2 * t + (e & 1);
      if (r < nq && d < D)
        dq[((long)b * Tq + q0 + r) * rs + (long)h * D + d] = acc[n][e];
    }
}

template <int NT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dcap,
                   const int* seg, float* dq, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, int vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // (b*h, query tile in reverse): the last query tile, the longest under a
  // causal mask, first
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  dq_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, seg, dq, H, Tq, Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

}  // namespace

// q and dout (B, Tq, H, D), k and v (B, Tk, H, D), lse and dcap (B, H, Tq),
// seg (B, Tq) int32 or null (then Tq == Tk), dq (B, Tq, H, D); all contiguous
// fp32 on the device. Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_bwd_dq(const float* q, const float* k, const float* v,
                                const float* dout, const float* lse,
                                const float* dcap, const int* seg, float* dq,
                                int B, int H, int Tq, int Tk, int D,
                                float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte granules need 16-byte aligned rows: D % 4 == 0 (then H*D too)
  // and aligned bases
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)dout;
  const int vec = D % 4 == 0 && bases % 16 == 0;
  if (D <= 16)
    return launch<2>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, vec, s);
  if (D <= 32)
    return launch<4>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, vec, s);
  if (D <= 64)
    return launch<8>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, vec, s);
  if (D <= 128)
    return launch<16>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                      scale, causal, vec, s);
  return (int)cudaErrorInvalidValue;
}
