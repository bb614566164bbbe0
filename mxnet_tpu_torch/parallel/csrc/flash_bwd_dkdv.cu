// flash_bwd_dkdv.cu: the key/value half of the flash-attention backward pass,
// fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_dkdv_kernel` (with `_mask_scores`) of
// mxnet_tpu/parallel/flash_attention.py, which `_pallas_backward` launches.
// Per (batch, head) and key block it recomputes the probabilities from the
// forward's row LSE instead of reading a stored (Tq, Tk) matrix:
//   S  = scale * Q K^T, masked      P  = exp(S - LSE)   (0 where masked)
//   dV = P^T dO                     dP = dO V^T
//   dS = P * (dP - Dr) * scale      dK = dS^T Q
// where Dr = rowsum(dO * O) comes from the caller. The mask is every kernel's
// (`live_pair` in flash_common.cuh):
// keys at or beyond Tk, the causal triangle (q_pos >= k_pos, top-left aligned
// when Tq != Tk), and for packed batches every cross-segment pair plus segment
// id 0. A masked pair's P is an exact zero, so rows that attend to nothing
// (segment 0) contribute nothing here, whatever their cotangent.
//
// What bounds it on an H100: per live (q, k) pair and head it does 8*D flops
// (two D-long dot products for S and dP, two D-long updates for dV and dK)
// against one read of Q, K, V, dO, LSE and Dr and one write of dK and dV, so at
// the training shapes (T = 1024, D = 64, causal) it is bound by operations:
// 67 TFLOP/s of fp32 on the CUDA cores. This first version runs fp32 FMAs on
// the CUDA cores, not the tensor cores.
//
// Design. The TPU kernel walks the query blocks as a sequential grid axis with
// dK and dV in VMEM scratch. Here one thread block owns one (batch*head,
// 64-key tile) and walks the query tiles in a loop, with dK and dV in
// registers:
//   - the K and V tiles stay in shared memory for the whole block; each query
//     tile's Q and dO rows arrive by cp.async (rows padded to D+1 floats, so
//     the 16 lanes that read 16 different rows hit 16 different banks), with
//     that tile's LSE, Dr and segment ids;
//   - 128 threads: for S and dP, thread (rg = tid/16, cg = tid%16) owns query
//     rows rg + 8i (i < 8) and keys cg + 16j (j < 4), as in flash_fwd.cu; P
//     and dS go to shared memory; for dV and dK the same thread owns key rows
//     rg + 8i and columns cg + 16j (j < D/16), summing over the tile's rows;
//   - causal: query tiles that lie wholly above the key tile are never loaded;
//   - any T (ragged tiles are zero-filled and masked) and any D <= 128.
// Shared memory is 4 tiles of 64 x (D+1) plus P and dS (64 x 65 each): about
// 100 KB at D = 64, above the 48 KB default, so the launch raises the limit.
// Inputs use the JAX (B, T, H, D) layout directly; LSE and Dr are (B, H, Tq),
// as flash_fwd.cu writes the LSE; segment ids are one (B, T) plane indexed by
// b = bh / H.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::bwd;

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
             (size_t)(2 * kBQ * ld + 2 * kBK * ld + 2 * kBQ * kLdP + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <int NJ>  // output columns per thread: D <= 16 * NJ
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dcap,
            const int* __restrict__ seg, float* __restrict__ dk,
            float* __restrict__ dv, int H, int Tq, int Tk, int D, float scale,
            int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                    // kBQ x ld
  float* dos = qs + kBQ * ld;          // kBQ x ld
  float* ks = dos + kBQ * ld;          // kBK x ld
  float* vs = ks + kBK * ld;           // kBK x ld
  float* ps = vs + kBK * ld;           // kBQ x kLdP
  float* dss = ps + kBQ * kLdP;        // kBQ x kLdP
  float* lse_s = dss + kBQ * kLdP;     // kBQ
  float* dcap_s = lse_s + kBQ;         // kBQ
  int* qseg = reinterpret_cast<int*>(dcap_s + kBQ);  // kBQ
  int* kseg = qseg + kBQ;                             // kBK

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const int nk = min(kBK, Tk - k0);
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const long rs = (long)H * D;         // stride between positions
  const float* qb = q + ((long)b * Tq * H + h) * D;
  const float* dob = dout + ((long)b * Tq * H + h) * D;
  const float* kb = k + ((long)b * Tk * H + h) * D;
  const float* vb = v + ((long)b * Tk * H + h) * D;

  for (int i = tid; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const bool in = r < nk;
    const long off = in ? (long)(k0 + r) * rs + d : 0;
    cp_async4(&ks[r * ld + d], kb + off, in);
    cp_async4(&vs[r * ld + d], vb + off, in);
  }
  if (seg != nullptr && tid < kBK)
    kseg[tid] = (tid < nk) ? seg[(long)b * Tk + k0 + tid] : 0;

  float acc_k[kRows][NJ], acc_v[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // causal: query tile q0 sees this key tile iff q0 + kBQ - 1 >= k0
  const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = qstart; q0 < Tq; q0 += kBQ) {
    const int nq = min(kBQ, Tq - q0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = r < nq;
      const long off = in ? (long)(q0 + r) * rs + d : 0;
      cp_async4(&qs[r * ld + d], qb + off, in);
      cp_async4(&dos[r * ld + d], dob + off, in);
    }
    if (tid < kBQ) {
      const bool in = tid < nq;
      const long row = (long)bh * Tq + q0 + tid;
      lse_s[tid] = in ? lse[row] : 0.f;
      dcap_s[tid] = in ? dcap[row] : 0.f;
      qseg[tid] = (seg != nullptr && in) ? seg[(long)b * Tq + q0 + tid] : 0;
    }
    cp_async_wait_all();  // this thread's copies (and K, V) landed
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    score_tiles(qs, dos, ks, vs, ld, D, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg + 8 * i, qp = q0 + r;
      const float l = lse_s[r], dr = dcap_s[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + 16 * j;
        const bool live = qp < Tq && live_pair(qp, k0 + c, Tk, causal,
                                               seg != nullptr, qseg[r],
                                               kseg[c]);
        const float2 pd = p_ds(s[i][j], dp[i][j], scale, l, dr, live);
        ps[r * kLdP + c] = pd.x;
        dss[r * kLdP + c] = pd.y;
      }
    }
    __syncthreads();  // the P and dS tiles are complete

    for (int c = 0; c < nq; ++c) {
      float ov[NJ], qv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        ov[j] = (d < D) ? dos[c * ld + d] : 0.f;
        qv[j] = (d < D) ? qs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[c * kLdP + rg + 8 * i];
        const float ds = dss[c * kLdP + rg + 8 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(p, ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds, qv[j], acc_k[i][j]);
        }
      }
    }
  }

  cp_async_wait_all();  // no copy outlives the kernel (no live query tile)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + rg + 8 * i;
    if (kp >= Tk) continue;
    const long off = ((long)b * Tk + kp) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) {
        dk[off + d] = acc_k[i][j];
        dv[off + d] = acc_v[i][j];
      }
    }
  }
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dcap,
                   const int* seg, float* dk, float* dv, int B, int H, int Tq,
                   int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kBK - 1) / kBK, B * H);
  dkdv_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, seg, dk, dv, H, Tq, Tk, D, scale, causal);
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
  if (D <= 16)
    return launch<1>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, s);
  if (D <= 32)
    return launch<2>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, s);
  if (D <= 64)
    return launch<4>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, s);
  if (D <= 128)
    return launch<8>(q, k, v, dout, lse, dcap, seg, dk, dv, B, H, Tq, Tk, D,
                     scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
