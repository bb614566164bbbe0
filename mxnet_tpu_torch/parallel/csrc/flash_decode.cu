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
//     copies, all of a thread's in flight at once; the query row sits in
//     shared memory too;
//   - the tile's online-softmax step (scores, block max and sum, rescaled P V
//     partial sums) is `decode::tile_step` of flash_common.cuh, which the
//     int8 kernel (flash_decode_q8.cu) runs too;
//   - lengths is a (B,) int32 vector indexed by b = bh / H (no per-head copy).
// The grid is B*H blocks, one per row; splitting T across blocks
// (flash-decoding) is left for a later version.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::decode;

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ o, int H, int T, int D, float scale) {
  extern __shared__ float smem[];
  const Tiles s = carve(smem, D);
  const int ld = D + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int n = min(max(lengths[b], 0), T);
  const long rs = (long)H * D;    // stride between positions
  const float* kb = k + ((long)b * T * H + h) * D;
  const float* vb = v + ((long)b * T * H + h) * D;
  for (int i = tid; i < D; i += kThreads) s.qs[i] = q[(long)bh * D + i];

  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int nk = min(kBK, n - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = r < nk;
      const long off = in ? (long)(k0 + r) * rs + d : 0;
      cp_async4(&s.ks[r * ld + d], kb + off, in);
      cp_async4(&s.vs[r * D + d], vb + off, in);
    }
    cp_async_wait_all();  // this thread's copies landed
    __syncthreads();
    tile_step(s, nk, D, scale, m, l, acc);
  }
  finish(s, D, l, acc, o + (long)bh * D);
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
