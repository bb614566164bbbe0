// flash_fwd.cu: blocked online-softmax attention forward, fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (with `_mask_scores`) of
// mxnet_tpu/parallel/flash_attention.py, which `_pallas_forward` launches.
// It computes, per (batch, head), O = softmax(scale * Q K^T + mask) V and the
// per-row LSE = m + log(l), which the backward kernels read.
// Masks (`live_pair` in flash_common.cuh): keys at or beyond Tk, the causal
// triangle (q_pos >= k_pos), and for packed batches every cross-segment pair
// plus segment id 0. A masked score
// is -1e30, as in the reference, so its softmax weight is an exact zero.
//
// What bounds it on an H100: the causal pass does about 2*T^2*D flops per
// (batch, head) against 16*T*D bytes of Q, K, V and O, so at the serving
// shapes (T in 128..512, D = 64) it sits near the fp32 ridge of the card
// (67 TFLOP/s over 3.35 TB/s = 20 flop/byte) and is bound by operations once
// T passes a few hundred. This first version runs fp32 FMAs on the CUDA
// cores, not the tensor cores.
//
// Design. The TPU kernel walks the key blocks as a sequential grid axis with
// its accumulators in VMEM scratch. Here one thread block owns one
// (batch*head, 64-row query tile) and walks the key blocks in a loop, with
// the running max m, sum l and output accumulator in registers:
//   - the Q tile and one 64-key K/V tile sit in shared memory, rows padded to
//     D+1 floats so the 16 lanes that read 16 different key rows hit 16
//     different banks; tiles arrive by cp.async, so a thread's copies are all
//     in flight at once instead of one load latency per element;
//   - 128 threads: thread (rg = tid/16, cg = tid%16) owns query rows
//     rg + 8i (i < 8) and key columns cg + 16j (j < 4) of the score tile, and
//     output columns cg + 16j (j < D/16) of the accumulator, so a row's
//     statistics live in one 16-lane half-warp and reduce with shuffles;
//   - causal: key tiles past the query tile's last row are never loaded;
//   - any T (ragged tiles are zero-filled and masked) and any D <= 128.
// Inputs use the JAX (B, T, H, D) layout directly; segment ids are one
// (B, T) plane indexed by b = bh / H, with no per-head copy.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = kBQ / 8;     // query rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr float kNeg = -1e30f;     // the reference's masked score

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (size_t)(kBQ * ld + 2 * kBK * ld + kBQ * (kBK + 1)) +
         sizeof(int) * kBK;
}

template <int NJ>  // output columns per thread: D <= 16 * NJ
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ seg,
           float* __restrict__ o, float* __restrict__ lse, int H, int Tq,
           int Tk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                    // kBQ x ld
  float* ks = qs + kBQ * ld;           // kBK x ld
  float* vs = ks + kBK * ld;           // kBK x ld
  float* ps = vs + kBK * ld;           // kBQ x (kBK + 1)
  int* kseg = reinterpret_cast<int*>(ps + kBQ * (kBK + 1));  // kBK

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const long rs = (long)H * D;         // stride between positions
  const float* qb = q + ((long)b * Tq * H + h) * D;
  const float* kb = k + ((long)b * Tk * H + h) * D;
  const float* vb = v + ((long)b * Tk * H + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const bool in = q0 + r < Tq;
    cp_async4(&qs[r * ld + d], in ? qb + (long)(q0 + r) * rs + d : qb, in);
  }
  int qseg[kRows];
  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg + 8 * i;
    qseg[i] = (seg != nullptr && qp < Tq) ? seg[(long)b * Tq + qp] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
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
    cp_async_wait_all();  // this thread's copies (and the Q tile) landed
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(cg + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = qs[(rg + 8 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + rg + 8 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + 16 * j, kp = k0 + c;
        const bool live = live_pair(qp, kp, Tk, causal, seg != nullptr,
                                    qseg[i], kseg[c]);
        s[i][j] = live ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of this half-warp hold the row's 64 scores
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mnew);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - mnew);
        ps[(rg + 8 * i) * (kBK + 1) + cg + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the P tile is complete

    for (int c = 0; c < nk; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        vv[j] = (d < D) ? vs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(rg + 8 * i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  cp_async_wait_all();  // no copy outlives the kernel (Tk == 0)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg + 8 * i;
    if (qp >= Tq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    float* ob = o + ((long)b * Tq + qp) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) ob[d] = acc[i][j] / ll;
    }
    if (cg == 0) lse[(long)bh * Tq + qp] = m[i] + logf(ll);
  }
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* seg, float* o, float* lse, int B, int H, int Tq,
                   int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  fwd_kernel<NJ><<<grid, kThreads, smem, stream>>>(q, k, v, seg, o, lse, H,
                                                   Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D), seg (B, Tq) int32 or null (then
// Tq == Tk), o (B, Tq, H, D), lse (B, H, Tq); all contiguous fp32 on the
// device. Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_fwd(const float* q, const float* k, const float* v,
                             const int* seg, float* o, float* lse, int B,
                             int H, int Tq, int Tk, int D, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch<1>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale, causal, s);
  if (D <= 32)
    return launch<2>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale, causal, s);
  if (D <= 64)
    return launch<4>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale, causal, s);
  if (D <= 128)
    return launch<8>(q, k, v, seg, o, lse, B, H, Tq, Tk, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
