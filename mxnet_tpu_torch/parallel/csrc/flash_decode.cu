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
// (unused page slots, the dump page) cannot leak in, not even a NaN. A row
// with lengths[b] == 0 gets o = 0 (the reference's softmax over nothing but
// masked keys averages the garbage; reading it would break the rule above).
//
// What bounds it on an H100: memory. Each (batch, head) reads its live K and V
// rows once (8 * len * D bytes in fp32) and does 4 * len * D flops on them, so
// the kernel is 0.5 flop/byte, far below the card's fp32 ridge of 20; the best
// it can do is stream the cache at the 3.35 TB/s of HBM3. That takes many
// bytes in flight on every SM at once.
//
// Design (flash-decoding). The TPU kernel walks the key blocks as a sequential
// grid axis with its accumulators in VMEM scratch; one block per row would
// give the server's B8 H12 window 96 blocks for 132 SMs, and one live stream
// only 12. So:
//   - the grid is (row, split): the host cuts T into S chunks
//     (decode::pick_splits: about kBlocksPerSM blocks for each SM, from B*H
//     and T alone — the lengths stay on the device); a block reads only its
//     chunk's live keys, none when its chunk starts at or beyond lengths[b];
//   - a block stages its chunk through a ring of two stages of 16-byte
//     cp.async copies (4-byte copies when D % 4 != 0 or the cache is not
//     16-byte aligned): the next stage is in flight while one is scored;
//   - in a stage, lane groups of L lanes (lanes spanning D, 4 columns a lane)
//     take 4 keys each: q.k summed by shuffles, one online-softmax rescale a
//     batch (decode::tile_step, which flash_decode_q8.cu runs too); no block
//     barrier but the ring's;
//   - a row's S blocks are one thread block cluster (at most 8 blocks): the
//     lane groups merge by a shuffle butterfly, the warps in warp order, and
//     the block of split 0 merges the others' states in split order from
//     their shared memory (decode::finish) and writes o = acc / max(l,
//     1e-30). No second kernel, no workspace, no atomics: two calls on one
//     input are bit-identical;
//   - shared memory is 34 KB a block at any D (a stage holds 512 / L keys),
//     so six blocks share an SM.
// The entry point allocates nothing and does not synchronise, so a CUDA graph
// can capture it.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace flash::decode;

// A staged fp32 stage: rows of 4 L floats, K and V apart.
struct F32Tile {
  const float *k, *v;
  int ld;
  __device__ __forceinline__ float4 key(int r, int c) const {
    return *reinterpret_cast<const float4*>(k + r * ld + c);
  }
  __device__ __forceinline__ float4 val(int r, int c) const {
    return *reinterpret_cast<const float4*>(v + r * ld + c);
  }
};

template <int L>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ o, int H, int T, int D, int S, int chunk,
              int vec, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int TK = tile_keys(L), ld = 4 * L;
  float* ks = reinterpret_cast<float*>(smem4);  // kStages stages of TK x ld
  float* vs = ks + kStages * TK * ld;
  float* red = vs + kStages * TK * ld;

  const int bh = blockIdx.x / S, split = blockIdx.x - bh * S;
  const int b = bh / H, h = bh - b * H;
  const int c = 4 * ((int)threadIdx.x % L);
  float qv[4];  // loaded beside lengths[b], not after it
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qv[i] = c + i < D ? q[(long)bh * D + c + i] : 0.f;
  const int n = min(max(lengths[b], 0), T);
  // this block's live keys: k0..k1-1 (none when its chunk starts at or
  // beyond lengths[b])
  const int k0 = split * chunk, k1 = min(k0 + chunk, n);
  const int nt = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;  // stages
  const long rs = (long)H * D;  // floats between positions
  const float* kb = k + ((long)b * T * H + h) * D;
  const float* vb = v + ((long)b * T * H + h) * D;
  // columns D..ld-1 of every staged row: the copies never write them
  if (nt > 0 && D < ld)
    for (int i = threadIdx.x; i < 2 * kStages * TK * (ld - D);
         i += kThreads) {
      const int r = i / (ld - D);
      ks[r * ld + D + i - r * (ld - D)] = 0.f;
    }

  // starts the copies of stage t (rows k0 + t * TK ...) into slot t % kStages
  auto stage = [&](int t) {
    const int r0 = k0 + t * TK, nv = min(TK, k1 - r0);
    float* kd = ks + (t % kStages) * TK * ld;
    float* vd = vs + (t % kStages) * TK * ld;
    if (vec) {
      const int per = D / 4;
      for (int i = threadIdx.x; i < nv * per; i += kThreads) {
        const int r = i / per, cc = (i - r * per) * 4;
        const long off = (long)(r0 + r) * rs + cc;
        cp_async16(kd + r * ld + cc, kb + off, true);
        cp_async16(vd + r * ld + cc, vb + off, true);
      }
    } else {
      for (int i = threadIdx.x; i < nv * D; i += kThreads) {
        const int r = i / D, cc = i - r * D;
        const long off = (long)(r0 + r) * rs + cc;
        cp_async4(kd + r * ld + cc, kb + off, true);
        cp_async4(vd + r * ld + cc, vb + off, true);
      }
    }
  };
  State st;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    if (t + kStages - 1 < nt) stage(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of stage t landed
    __syncthreads();               // ... and every thread's
    const int slot = (t % kStages) * TK * ld;
    tile_step<L>(F32Tile{ks + slot, vs + slot, ld}, min(TK, k1 - k0 - t * TK),
                 qv, scale, st);
    __syncthreads();  // slot t % kStages is free for stage t + kStages
  }
  finish<L>(st, red, D, S, split, o + (long)bh * D);
}

template <int L>
int launch(const float* q, const float* k, const float* v, const int* lengths,
           float* o, int B, int H, int T, int D, float scale, int S,
           cudaStream_t stream) {
  constexpr int TK = tile_keys(L);
  const size_t smem =
      sizeof(float) * (2 * kStages * TK * 4 * L + merge_floats(L));
  // 16-byte granules need 16-byte aligned rows: D % 4 == 0 (then H*D too)
  // and aligned bases
  const int vec = D % 4 == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(decode_kernel<L>, B * H * S, S, kThreads, smem,
                              stream, q, k, v, lengths, o, H, T, D, S,
                              chunk_keys(T, S), vec, scale);
}

}  // namespace

// The host's number of splits for a call of mxt_flash_decode on these
// shapes.
extern "C" int mxt_flash_decode_splits(int B, int H, int T, int D) {
  return pick_splits(B * H, T, D);
}

// q (B, 1, H, D), k and v (B, T, H, D), lengths (B,) int32, o (B, 1, H, D);
// all contiguous on the device, fp32 unless stated. D <= 128. S splits of
// the cache, 1 to kMaxSplits, or 0 for the host's choice (the port's; S is
// forced only to measure). Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_decode(const float* q, const float* k, const float* v,
                                const int* lengths, float* o, int B, int H,
                                int T, int D, float scale, int S,
                                void* stream) {
  if (S == 0) S = pick_splits(B * H, T, D);
  if (D < 1 || D > 128 || S < 1 || S > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes(D)) {
    case 4:
      return launch<4>(q, k, v, lengths, o, B, H, T, D, scale, S, st);
    case 8:
      return launch<8>(q, k, v, lengths, o, B, H, T, D, scale, S, st);
    case 16:
      return launch<16>(q, k, v, lengths, o, B, H, T, D, scale, S, st);
    default:
      return launch<32>(q, k, v, lengths, o, B, H, T, D, scale, S, st);
  }
}
