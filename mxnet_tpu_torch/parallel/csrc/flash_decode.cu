// flash_decode.cu: one decode step of attention over a gathered KV cache,
// fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (through `_decode_accumulate`) of
// mxnet_tpu/parallel/flash_attention.py, which `_pallas_decode` launches. It
// computes, per (batch, head), the attention of ONE query row against the
// first lengths[b] keys of a cache of T positions:
//   o = sum_i softmax(scale * q . k_i)_i v_i  over i < lengths[b].
// Keys at or beyond lengths[b] are never read: they get the exact-zero weight
// that the reference's -1e30 masking gives them, and the cache's garbage tail
// (unused page slots, the dump page) cannot leak in, not even a NaN.
//
// What bounds it on an H100: memory. Each (batch, head) reads its live K and V
// rows once (8 * len * D bytes in fp32) and does 4 * len * D flops on them, so
// the kernel is 0.5 flop/byte, far below the card's fp32 ridge of 20; the best
// it can do is stream the cache at the 3.35 TB/s of HBM3.
//
// Design. The TPU kernel walks the key blocks as a sequential grid axis with
// its accumulators in VMEM scratch. Here one thread block of 128 threads owns
// one (batch*head) row and walks the live keys in tiles of 128:
//   - each tile of K and V is staged in shared memory by coalesced cp.async
//     copies, all of a thread's in flight at once (K rows padded to D+1
//     floats, so thread t reading key row t is free of bank conflicts); the
//     query row sits in shared memory too;
//   - thread t scores key t of the tile; the tile's max and sum come from warp
//     shuffles plus a 4-entry shared-memory step across the warps;
//   - the running max m and sum l are kept (identical) in every thread; for
//     P V, thread t owns output column t % D and every (128 / D)-th key of the
//     tile, rescales its partial sum by the same alpha, and the partial sums
//     are added once at the end;
//   - lengths is a (B,) int32 vector indexed by b = bh / H (no per-head copy).
// The grid is B*H blocks, one per row; splitting T across blocks
// (flash-decoding) is left for a later version.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;
constexpr int kBK = 128;           // keys per tile (one per thread)
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(kBK * (D + 1) + kBK * D + D + kBK + kWarps + kThreads);
}

// Block-wide max (op = 0) or sum (op = 1) of one value per thread; every
// thread gets the result. `wred` holds one slot per warp.
__device__ float block_reduce(float x, float* wred, int op) {
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

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ o, int H, int T, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;               // kBK x ld
  float* vs = ks + kBK * ld;      // kBK x D
  float* qs = vs + kBK * D;       // D
  float* ps = qs + D;             // kBK
  float* wred = ps + kBK;         // kWarps
  float* part = wred + kWarps;    // kThreads

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int n = min(max(lengths[b], 0), T);
  const long rs = (long)H * D;    // stride between positions
  const float* kb = k + ((long)b * T * H + h) * D;
  const float* vb = v + ((long)b * T * H + h) * D;
  for (int i = tid; i < D; i += kThreads) qs[i] = q[(long)bh * D + i];

  const int groups = kThreads / D;            // key groups in P V
  const int gd = tid % D, gg = tid / D;
  const bool pv = gg < groups;
  float m = -INFINITY, l = 0.f, acc = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int nk = min(kBK, n - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = r < nk;
      const long off = in ? (long)(k0 + r) * rs + d : 0;
      cp_async4(&ks[r * ld + d], kb + off, in);
      cp_async4(&vs[r * D + d], vb + off, in);
    }
    cp_async_wait_all();  // this thread's copies landed
    __syncthreads();

    float s = kNeg;
    if (tid < nk) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qs[d], ks[tid * ld + d], dot);
      s = dot * scale;
    }
    const float mnew = fmaxf(m, block_reduce(s, wred, 0));
    const float alpha = expf(m - mnew);  // 0 on the first tile
    const float p = (tid < nk) ? expf(s - mnew) : 0.f;
    ps[tid] = p;
    l = l * alpha + block_reduce(p, wred, 1);  // syncs: ps is complete
    m = mnew;
    if (pv) {
      float a = 0.f;
      for (int c = gg; c < nk; c += groups) a = fmaf(ps[c], vs[c * D + gd], a);
      acc = acc * alpha + a;
    }
  }

  __syncthreads();
  if (pv) part[gg * D + gd] = acc;
  __syncthreads();
  if (tid < D) {
    float t = 0.f;
    for (int g = 0; g < groups; ++g) t += part[g * D + tid];
    o[(long)bh * D + tid] = t / fmaxf(l, 1e-30f);
  }
}

}  // namespace

// q (B, 1, H, D), k and v (B, T, H, D), lengths (B,) int32, o (B, 1, H, D);
// all contiguous on the device, fp32 unless stated. D <= 128. Returns the
// launch's cudaError_t (0 on success).
extern "C" int mxt_flash_decode(const float* q, const float* k, const float* v,
                                const int* lengths, float* o, int B, int H,
                                int T, int D, float scale, void* stream) {
  if (D < 1 || D > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, lengths, o, H, T, D, scale);
  return (int)cudaGetLastError();
}
