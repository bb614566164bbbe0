// flash_bwd_dq.cu: the query half of the flash-attention backward pass,
// fp32, for Hopper (sm_90a).
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
// segment id 0. A masked pair's P is an exact zero.
//
// What bounds it on an H100: per live (q, k) pair and head it does 6*D flops
// (two D-long dot products for S and dP, one D-long update of dQ) against one
// read of Q, K, V, dO, LSE and Dr and one write of dQ, so at the training
// shapes (T = 1024, D = 64, causal) it is bound by operations: 67 TFLOP/s of
// fp32 on the CUDA cores. This first version runs fp32 FMAs on the CUDA
// cores, not the tensor cores.
//
// Design. The TPU kernel walks the key blocks as a sequential grid axis with
// dQ in VMEM scratch. Here one thread block owns one (batch*head, 64-row
// query tile) and walks the key tiles in a loop, with dQ in registers:
//   - the Q and dO tiles, the rows' LSE and Dr stay in shared memory for the
//     whole block; each key tile's K and V rows arrive by cp.async (rows
//     padded to D+1 floats, so the 16 lanes that read 16 different rows hit
//     16 different banks);
//   - 128 threads: thread (rg = tid/16, cg = tid%16) owns query rows rg + 8i
//     (i < 8) and keys cg + 16j (j < 4) of S and dP, as in flash_fwd.cu, puts
//     its dS into shared memory, and then owns output columns cg + 16j
//     (j < D/16) of the same rows of dQ;
//   - causal: key tiles past the query tile's last row are never loaded;
//   - any T (ragged tiles are zero-filled and masked) and any D <= 128.
// Shared memory is 4 tiles of 64 x (D+1) plus dS (64 x 65): about 84 KB at
// D = 64, above the 48 KB default, so the launch raises the limit. Inputs use
// the JAX (B, T, H, D) layout directly; LSE and Dr are (B, H, Tq); segment
// ids are one (B, T) plane indexed by b = bh / H.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::bwd;

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
             (size_t)(2 * kBQ * ld + 2 * kBK * ld + kBQ * kLdP + 2 * kBQ) +
         sizeof(int) * kBK;
}

template <int NJ>  // output columns per thread: D <= 16 * NJ
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dcap,
          const int* __restrict__ seg, float* __restrict__ dq, int H, int Tq,
          int Tk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                    // kBQ x ld
  float* dos = qs + kBQ * ld;          // kBQ x ld
  float* ks = dos + kBQ * ld;          // kBK x ld
  float* vs = ks + kBK * ld;           // kBK x ld
  float* dss = vs + kBK * ld;          // kBQ x kLdP
  float* lse_s = dss + kBQ * kLdP;     // kBQ
  float* dcap_s = lse_s + kBQ;         // kBQ
  int* kseg = reinterpret_cast<int*>(dcap_s + kBQ);  // kBK

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, Tq - q0);
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const long rs = (long)H * D;         // stride between positions
  const float* qb = q + ((long)b * Tq * H + h) * D;
  const float* dob = dout + ((long)b * Tq * H + h) * D;
  const float* kb = k + ((long)b * Tk * H + h) * D;
  const float* vb = v + ((long)b * Tk * H + h) * D;

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
  }
  int qseg[kRows];
  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg + 8 * i;
    qseg[i] = (seg != nullptr && qp < Tq) ? seg[(long)b * Tq + qp] : 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, Tk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = r < nk;
      const long off = in ? (long)(k0 + r) * rs + d : 0;
      cp_async4(&ks[r * ld + d], kb + off, in);
      cp_async4(&vs[r * ld + d], vb + off, in);
    }
    if (seg != nullptr && tid < kBK)
      kseg[tid] = (tid < nk) ? seg[(long)b * Tk + k0 + tid] : 0;
    cp_async_wait_all();  // this thread's copies (and Q, dO) landed
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
                                               seg != nullptr, qseg[i],
                                               kseg[c]);
        dss[r * kLdP + c] = p_ds(s[i][j], dp[i][j], scale, l, dr, live).y;
      }
    }
    __syncthreads();  // the dS tile is complete

    for (int c = 0; c < nk; ++c) {
      float kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        kv[j] = (d < D) ? ks[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ds = dss[(rg + 8 * i) * kLdP + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

  cp_async_wait_all();  // no copy outlives the kernel (Tk == 0)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg + 8 * i;
    if (qp >= Tq) continue;
    float* out = dq + ((long)b * Tq + qp) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) out[d] = acc[i][j];
    }
  }
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dcap,
                   const int* seg, float* dq, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  dq_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dcap, seg, dq, H, Tq, Tk, D, scale, causal);
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
  if (D <= 16)
    return launch<1>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, s);
  if (D <= 32)
    return launch<2>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, s);
  if (D <= 64)
    return launch<4>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, s);
  if (D <= 128)
    return launch<8>(q, k, v, dout, lse, dcap, seg, dq, B, H, Tq, Tk, D,
                     scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
