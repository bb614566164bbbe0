// nms_sweep.cu: the keep mask of greedy non-maximum suppression, fp32, for
// Hopper (sm_90a).
//
// There is no TPU kernel behind it: it replaces the `lax.scan` chains of the
// JAX package's `_nms_mask` (mxnet_tpu/ops/detection.py:171, for
// MultiBoxDetection and box_nms) and `_greedy_nms_keep`
// (mxnet_tpu/ops/deformable.py:363, for Proposal and MultiProposal). For each
// sample b, over n boxes already in score order, box i is kept iff no kept
// box j < i overlaps it above `thresh` (and, given class ids, shares its
// class):
//   keep[b, i] = !any_{j < i} (keep[b, j] && over(j, i)).
//
// The overlap test is one of two IoU conventions, computed in the JAX
// package's operations and order with round-to-nearest intrinsics, so nvcc
// contracts nothing into an FMA and a comparison at the threshold falls as
// the plain version's does:
//   corner (`_iou_corner`): widths clipped at 0, inter / max(a + b - inter,
//     1e-12);
//   +1 (`_greedy_nms_keep`): areas (x2 - x1 + 1)(y2 - y1 + 1), widths
//     max(x2 - x1 + 1, 0), inter / (a + b - inter).
//
// Two launches on one stream:
//   1. mask: a block takes 64 row boxes against a tile of 64 column boxes
//      staged in shared memory; its thread for row i writes one 64-bit word,
//      bit j set where column j > i overlaps i. The words form (B, n, nw),
//      nw = ceil(n / 64); a block whose column tile lies wholly before its
//      row tile writes nothing (the sweep never reads those words). At SSD's
//      8732 anchors that is 9.6 MB a sample, against an (n, n) fp32 IoU
//      matrix's 305 MB.
//   2. sweep: one block a sample keeps the `removed` bitset (nw words) in
//      shared memory and walks i in order. Every thread reads bit i of the
//      same word; a kept i ORs its row's words from i / 64 on into `removed`,
//      the threads across the words, then the block synchronises (only
//      then: the branch is uniform). Bit i cannot change while i is tested,
//      since a row only sets bits after its own.
// What bounds it: the mask pass's IoUs, n^2 / 2 pairs of about 14 fp32
// operations; the sweep is a serial chain of up to n steps a sample.
// The entry point allocates nothing (the wrapper passes the mask's
// workspace) and does not synchronise, so a CUDA graph can capture it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;          // boxes a tile; bits a mask word
constexpr int kSweepThreads = 128;

__device__ __forceinline__ float clip0(float x) { return x < 0.f ? 0.f : x; }

template <bool kPlusOne>
__device__ __forceinline__ bool overlaps(const float* a, const float* b,
                                         float thresh) {
  if (kPlusOne) {
    const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.f),
                                   __fadd_rn(__fsub_rn(a[3], a[1]), 1.f));
    const float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.f),
                                   __fadd_rn(__fsub_rn(b[3], b[1]), 1.f));
    const float iw = clip0(__fadd_rn(
        __fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 1.f));
    const float ih = clip0(__fadd_rn(
        __fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 1.f));
    const float inter = __fmul_rn(iw, ih);
    return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter)) >
           thresh;
  }
  const float iw = clip0(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])));
  const float ih = clip0(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])));
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(clip0(__fsub_rn(a[2], a[0])),
                                 clip0(__fsub_rn(a[3], a[1])));
  const float area_b = __fmul_rn(clip0(__fsub_rn(b[2], b[0])),
                                 clip0(__fsub_rn(b[3], b[1])));
  const float denom = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter),
                            1e-12f);
  return __fdiv_rn(inter, denom) > thresh;
}

// grid (nw * nw, B), kTile threads; dynamic shared memory: the column
// tile's boxes (kTile x 4) and class ids (kTile).
template <bool kPlusOne>
__global__ void __launch_bounds__(kTile)
mask_kernel(const float* __restrict__ boxes, const float* __restrict__ cls,
            unsigned long long* __restrict__ mask, int n, int nw,
            float thresh) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* tile_cls = tile + 4 * kTile;
  const int rb = blockIdx.x / nw, cb = blockIdx.x - rb * nw;
  if (cb < rb) return;  // every bit would be j < i
  const int b = blockIdx.y, t = threadIdx.x;
  const float* bx = boxes + (size_t)b * n * 4;
  const float* bc = cls ? cls + (size_t)b * n : nullptr;
  const int j0 = cb * kTile, cols = min(kTile, n - j0);
  if (t < cols) {
    for (int k = 0; k < 4; ++k) tile[4 * t + k] = bx[4 * (j0 + t) + k];
    tile_cls[t] = bc ? bc[j0 + t] : 0.f;
  }
  __syncthreads();
  const int i = rb * kTile + t;
  if (i >= n) return;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = bx[4 * i + k];
  const float ca = bc ? bc[i] : 0.f;
  unsigned long long word = 0ull;
  for (int j = (cb == rb ? t + 1 : 0); j < cols; ++j) {
    if (bc && !(tile_cls[j] == ca)) continue;
    if (overlaps<kPlusOne>(a, tile + 4 * j, thresh)) word |= 1ull << j;
  }
  mask[((size_t)b * n + i) * nw + cb] = word;
}

// grid B, kSweepThreads threads; dynamic shared memory: nw words.
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const unsigned long long* __restrict__ mask,
             bool* __restrict__ keep, int n, int nw) {
  extern __shared__ float4 smem4[];
  unsigned long long* removed = reinterpret_cast<unsigned long long*>(smem4);
  const int b = blockIdx.x, t = threadIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * nw;
  for (int w = t; w < nw; w += kSweepThreads) removed[w] = 0ull;
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int wi = i >> 6;
    const bool kept = !((removed[wi] >> (i & 63)) & 1ull);
    if (t == 0) keep[(size_t)b * n + i] = kept;
    if (kept) {
      const unsigned long long* row = m + (size_t)i * nw;
      for (int w = wi + t; w < nw; w += kSweepThreads) removed[w] |= row[w];
      __syncthreads();
    }
  }
}

bool shapes_ok(int B, int n) {
  const long long nw = (n + kTile - 1) / kTile;
  return B <= 65535 && nw * nw <= 0x7fffffffLL &&
         nw * (long long)sizeof(unsigned long long) <= 48 * 1024;
}

}  // namespace

// boxes (B, n, 4) fp32 in score order; cls (B, n) fp32 class ids or null (no
// class gate); mask (B, n, ceil(n / 64)) uint64 workspace; keep (B, n) bool
// out. Returns a cudaError_t.
extern "C" int mxt_nms_sweep(const float* boxes, const float* cls,
                             unsigned long long* mask, bool* keep, int B,
                             int n, float thresh, int plus_one,
                             cudaStream_t stream) {
  if (B <= 0 || n <= 0) return cudaSuccess;
  if (!shapes_ok(B, n)) return cudaErrorInvalidValue;
  const int nw = (n + kTile - 1) / kTile;
  const dim3 grid(nw * nw, B);
  const size_t smem = 5 * kTile * sizeof(float);
  if (plus_one)
    mask_kernel<true><<<grid, kTile, smem, stream>>>(boxes, cls, mask, n, nw,
                                                     thresh);
  else
    mask_kernel<false><<<grid, kTile, smem, stream>>>(boxes, cls, mask, n, nw,
                                                      thresh);
  sweep_kernel<<<B, kSweepThreads, nw * sizeof(unsigned long long), stream>>>(
      mask, keep, n, nw);
  return (int)cudaGetLastError();
}

