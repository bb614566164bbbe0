// nms_sweep.cu: the keep mask of greedy non-maximum suppression, fp32, for
// Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package walks the chain with the
// `lax.scan`s of `_nms_mask` (mxnet_tpu/ops/detection.py:171, MultiBoxDetection
// and box_nms) and `_greedy_nms_keep` (mxnet_tpu/ops/deformable.py:363,
// Proposal and MultiProposal). For each sample b, over n boxes already in
// score order, box i is kept iff no kept box j < i overlaps it above
// `thresh` (and, given class ids, shares its class):
//   keep[b, i] = !any_{j < i} (keep[b, j] && over(j, i)).
// The overlap is one of two IoU conventions, in the JAX package's operations
// and order with round-to-nearest intrinsics (nvcc contracts nothing into an
// FMA), so every decision falls as the plain version's does:
//   corner (`_iou_corner`): widths clipped at 0, inter / max(a + b - inter,
//     1e-12);
//   +1 (`_greedy_nms_keep`): areas (x2 - x1 + 1)(y2 - y1 + 1), widths
//     max(x2 - x1 + 1, 0), inter / (a + b - inter).
//
// What bounds it: the IoUs of the pairs the chains can use, about 14 fp32
// operations each (with a class gate only the pairs of one class: ~61 M of
// SSD300's 1.22 G at B32), against the fp32 peak; the count depends on the
// data. Then the chain itself, serial in the kept boxes.
//
// The design:
//  - One chain a class. With a class gate a box's fate depends only on the
//    earlier boxes of its class, so the wrapper orders each sample by class,
//    stably (`order`: score order within a class), and the chains are the
//    runs of one class in that order (a NaN id is a chain of its own, as it
//    equals nothing). Without a gate a sample is one chain. The list pass (a
//    block a sample) finds the runs, keeps a box alone at once, and lists
//    the rest as short (<= kShortMax boxes) or long chains. The grids of the
//    later passes are fixed by (B, n) and their blocks take chains from
//    those lists, so nothing is read back to the host. Keep bits go straight
//    back to the caller's positions through `order`.
//  - Short chains (a class of SSD's 8732 anchors is ~440 boxes): a block a
//    chain keeps the chain's boxes and its upper-triangle bit mask (64 boxes
//    a word, bit j of row i set when j > i overlaps i) in shared memory,
//    every thread two rows of a 64 x 64 tile, then one warp sweeps it there:
//    no device-memory round trip.
//  - Long chains (the proposals' 6000, a force_suppress SSD's 8732, box_nms's
//    id -1 group): the mask pass spreads the upper-triangle 64 x 64 tiles of
//    every long chain over the whole card, a warp a tile, into a (B, n / 64,
//    n) word mask, column-word major: a warp's 64 rows of one word are
//    contiguous, and so is the column a sweep step pulls.
//  - The sweep goes 64 boxes a step. For word c, the kept rows before it OR
//    their words c into `removed` (a long chain's block pulls column c whole,
//    kStages - 1 stages ahead by cp.async, in pieces of kChunk rows where it
//    is longer; a short chain's warp reads its shared mask), then one warp
//    resolves word c from the diagonal words: the lowest candidate standing
//    is kept and clears what it overlaps, a candidate whose row is empty
//    taking no step. Two barriers a word, not one a kept box.
//  - A pair is decided without the division wherever that is exact: boxes
//    that do not intersect are never above a threshold t >= 0 (0 / x is +-0
//    or NaN); else the sign of one rounded fma, inter - t * denom, says
//    whether the quotient lies below t, and a second, with the next float
//    above t, whether it lies above it. Only a quotient within an ulp of t
//    (or an odd operand) pays the IEEE division. The tests are branch-free
//    over a tile's 64 columns; the rare pairs left go after.
//
// Passes, on one stream: a memset of the header and the list pass; the short
// chains; then, if n > kShortMax, the long mask and the long sweep. The entry
// point allocates nothing (the caller passes the workspace, mxt_nms_workspace
// bytes: 310.7 MB at B32 n8732, 306.2 MB of it the long chains' mask) and
// does not synchronise, so a CUDA graph can capture it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;            // boxes a tile; bits a mask word
constexpr int kShortMax = 512;       // the longest chain kept in shared memory
constexpr int kShortWords = kShortMax / kTile;
constexpr int kThreads = 256;        // a block of the chain passes
constexpr int kWarps = kThreads / 32;
constexpr int kListThreads = 512;    // a block of the list pass
constexpr int kChunk = 4096;         // rows a stage of the long sweep
constexpr int kStages = 3;           // its stages in flight
constexpr int kCopyWords = 2;        // mask words a cp.async copies
constexpr int kSlot = kChunk + 2;    // words a stage's slot (16-byte bounds)
constexpr int kShortBlocksPerSM = 6;
constexpr int kMaskBlocksPerSM = 8;
constexpr int kSweepBlocksPerSM = 2;
constexpr u64 kTileMask = (1ull << 40) - 1;
constexpr float kMaxFloat = 3.40282347e+38f;

struct Header {     // zeroed by each call
  u64 longs;        // (long chains << 40) + their mask tiles
  int shorts;       // short chains listed
  int pad;
};

struct Chain {      // positions [start, start + len) of sample b's class order
  int b, start, len, pad;
  long long tile0;  // a long chain's first tile in the mask pass
};

struct Thresh {
  float t;          // thresh
  float up;         // the next float above it
  int fast;         // thresh >= 0 and finite: the division-free tests hold
};

struct Layout {     // byte offsets in the workspace
  size_t starts, shorts, longs, mask, bytes;
};

size_t round_up(size_t x) { return (x + 255) & ~size_t(255); }

Layout layout(int B, int n) {
  const size_t nw = (n + kTile - 1) / kTile;
  Layout l;
  size_t o = round_up(sizeof(Header));
  l.starts = o;
  o = round_up(o + sizeof(int) * (size_t)B * (n + 1));
  l.shorts = o;
  o = round_up(o + sizeof(Chain) * (size_t)B * (n / 2 + 1));
  l.longs = o;
  o = round_up(o + sizeof(Chain) * (size_t)B * (n / (kShortMax + 1) + 1));
  l.mask = o;
  if (n > kShortMax)  // a stage's copy may read one word past the last
    o = round_up(o + sizeof(u64) * ((size_t)B * nw * n + 2));
  l.bytes = o;
  return l;
}

bool shapes_ok(int B, int n) {
  const long long nw = (n + kTile - 1) / kTile;
  return B > 0 && n > 0 && (long long)B * n <= 0x7fffffffLL &&
         (long long)B * nw * (nw + 1) / 2 < (1LL << 40) &&
         (long long)B * (n / (kShortMax + 1) + 1) < (1LL << 23);
}

// words of a short chain's mask before column word c (column c holds rows
// 0 .. 64 (c + 1) - 1, padded by one word so a warp reading one row across
// columns hits distinct banks)
__host__ __device__ constexpr int col_off(int c) { return 32 * c * (c + 1) + c; }

__device__ __forceinline__ float clip0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float4 load_box(const float* boxes, size_t i) {
  const float* p = boxes + 4 * i;
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <bool kPlusOne>
__device__ __forceinline__ float area(float4 a) {
  if (kPlusOne)
    return __fmul_rn(__fadd_rn(__fsub_rn(a.z, a.x), 1.f),
                     __fadd_rn(__fsub_rn(a.w, a.y), 1.f));
  return __fmul_rn(clip0(__fsub_rn(a.z, a.x)), clip0(__fsub_rn(a.w, a.y)));
}

// The exact decision: the plain version's operations, one IEEE division.
template <bool kPlusOne>
__device__ __noinline__ bool overlaps(float4 a, float area_a, float4 b,
                                      float area_b, float t) {
  float iw, ih;
  if (kPlusOne) {
    iw = clip0(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f));
    ih = clip0(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f));
  } else {
    iw = clip0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
    ih = clip0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  }
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, kPlusOne ? denom : fmaxf(denom, 1e-12f)) > t;
}

// bits j0 <= j < j1 of a word
__device__ __forceinline__ u64 span(int j0, int j1) {
  const u64 hi = j1 >= kTile ? ~0ull : (1ull << j1) - 1ull;
  const u64 lo = j0 >= kTile ? ~0ull : (1ull << j0) - 1ull;
  return hi & ~lo;
}

// The words of R row boxes a[r] against a 64-box column tile, bits live[r]
// only: bit j set where column j overlaps the row above th.t. With t >= 0
// and finite (th.fast) each pair is decided without a branch or a division
// where that is exact: widths clipped by fmaxf (a NaN or -0 width gives an
// intersection of +-0 or NaN either way: never above t); no intersection is
// never above t; else, with denom > 0, the sign of one rounded fma
// inter - t denom says whether the quotient lies below t, and the same
// with the next float above t whether it lies above it. What is left (a
// quotient within an ulp of t, an odd operand) takes the exact decision.
template <bool kPlusOne, int R>
__device__ __forceinline__ void row_words(const float4 (&a)[R],
                                          const float (&area_a)[R],
                                          const float4* cols,
                                          const float* col_area,
                                          const u64 (&live)[R],
                                          const Thresh& th, u64 (&out)[R]) {
  unsigned yes[R][2], odd[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
    yes[r][0] = yes[r][1] = odd[r][0] = odd[r][1] = th.fast ? 0u : ~0u;
  if (th.fast) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float4 b = cols[j];
      const float area_b = col_area[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float iw, ih;
        if (kPlusOne) {
          iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a[r].z, b.z),
                                         fmaxf(a[r].x, b.x)), 1.f), 0.f);
          ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a[r].w, b.w),
                                         fmaxf(a[r].y, b.y)), 1.f), 0.f);
        } else {
          iw = fmaxf(__fsub_rn(fminf(a[r].z, b.z), fmaxf(a[r].x, b.x)), 0.f);
          ih = fmaxf(__fsub_rn(fminf(a[r].w, b.w), fmaxf(a[r].y, b.y)), 0.f);
        }
        const float inter = __fmul_rn(iw, ih);
        float denom = __fsub_rn(__fadd_rn(area_a[r], area_b), inter);
        // corner: denom >= 1e-12 or NaN, and a NaN fails both tests below
        if (!kPlusOne) denom = fmaxf(denom, 1e-12f);
        const bool pos = !kPlusOne || denom > 0.f;
        const bool over = pos && __fmaf_rn(-th.up, denom, inter) > 0.f;
        const bool under = !(inter > 0.f) ||
                           (pos && __fmaf_rn(-th.t, denom, inter) < 0.f);
        yes[r][j >> 5] |= (unsigned)over << (j & 31);
        odd[r][j >> 5] |= (unsigned)(!over && !under) << (j & 31);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    u64 word = ((u64)yes[r][1] << 32 | yes[r][0]) & live[r];
    u64 rest = ((u64)odd[r][1] << 32 | odd[r][0]) & live[r];
    while (rest) {
      const int j = __ffsll((long long)rest) - 1;
      rest &= rest - 1ull;
      if (overlaps<kPlusOne>(a[r], area_a[r], cols[j], col_area[j], th.t))
        word |= 1ull << j;
    }
    out[r] = word;
  }
}

// the position in the caller's order of class-order position k
__device__ __forceinline__ int pos(const long long* order, size_t row, int k) {
  return order ? (int)order[row + k] : k;
}

// Word c's kept bits, by the 32 lanes of a warp together (each gets them):
// from `removed` (its bits set by earlier words) and the diagonal words
// diag[i] (bit j > i set where j overlaps i), rows valid. In order, the
// lowest candidate still standing is kept and clears what its row overlaps.
// A candidate whose row is empty clears nothing, so only the others take a
// step; those left at the end are kept as they stand.
__device__ __forceinline__ u64 resolve(u64 removed, const u64* diag,
                                       int rows) {
  const int lane = threadIdx.x & 31;
  const bool empty_lo = lane >= rows || diag[lane] == 0ull;
  const bool empty_hi = lane + 32 >= rows || diag[lane + 32] == 0ull;
  const u64 empty = (u64)__ballot_sync(0xffffffffu, empty_lo) |
                    (u64)__ballot_sync(0xffffffffu, empty_hi) << 32;
  u64 cand = ~removed & (rows >= kTile ? ~0ull : (1ull << rows) - 1ull);
  u64 kept = 0ull;
  for (u64 busy = cand & ~empty; busy; busy = cand & ~empty) {
    const int i = __ffsll((long long)busy) - 1;
    kept |= 1ull << i;
    cand &= ~(diag[i] | 1ull << i);
  }
  return kept | cand;
}

// `acc` with the words of the rows in `kept` ORed in (rows[i], i < 64)
__device__ __forceinline__ u64 or_kept(u64 acc, u64 kept, const u64* rows) {
#pragma unroll 16
  for (int i = 0; i < kTile; ++i)
    if ((kept >> i) & 1ull) acc |= rows[i];
  return acc;
}

// grid B, kListThreads threads; dynamic shared memory: kListThreads / 32 + 1
// ints. The runs of one class in sample b's class order; a run of one box is
// kept at once, the others listed.
__global__ void __launch_bounds__(kListThreads)
list_kernel(const float* __restrict__ cls, const long long* __restrict__ order,
            int* __restrict__ starts, Header* __restrict__ h,
            Chain* __restrict__ shorts, Chain* __restrict__ longs,
            bool* __restrict__ keep, int n) {
  extern __shared__ float4 smem4[];
  int* warp_n = reinterpret_cast<int*>(smem4);
  int* total = warp_n + kListThreads / 32;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row = (size_t)b * n;
  int* st = starts + (size_t)b * (n + 1);
  if (t == 0) *total = 0;
  for (int k0 = 0; k0 < n; k0 += kListThreads) {
    const int k = k0 + t;
    bool first = false;
    if (k < n) {
      if (k == 0 || !cls)
        first = k == 0;
      else
        first = !(cls[row + order[row + k]] == cls[row + order[row + k - 1]]);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, first);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int idx = *total + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) idx += warp_n[w];
    if (first) st[idx] = k;
    __syncthreads();
    if (t == 0)
      for (int w = 0; w < kListThreads / 32; ++w) *total += warp_n[w];
    __syncthreads();
  }
  const int chains = *total;
  if (t == 0) st[chains] = n;
  __syncthreads();
  for (int c = t; c < chains; c += kListThreads) {
    const int s0 = st[c], len = st[c + 1] - s0;
    if (len == 1) {
      keep[row + pos(order, row, s0)] = true;
    } else if (len <= kShortMax) {
      shorts[atomicAdd(&h->shorts, 1)] = Chain{b, s0, len, 0, 0};
    } else {
      const u64 w = (len + kTile - 1) / kTile;
      const u64 old = atomicAdd(&h->longs, (1ull << 40) + w * (w + 1) / 2);
      longs[old >> 40] = Chain{b, s0, len, 0, (long long)(old & kTileMask)};
    }
  }
}

// kThreads threads; dynamic shared memory: the chain's boxes (kShortMax
// float4), their areas (kShortMax), its mask (col_off(kShortWords) words)
// and `removed` (kShortWords words). A block a short chain at a time.
template <bool kPlusOne>
__global__ void __launch_bounds__(kThreads)
short_kernel(const float* __restrict__ boxes,
             const long long* __restrict__ order,
             const Header* __restrict__ h, const Chain* __restrict__ shorts,
             bool* __restrict__ keep, int n, Thresh th) {
  extern __shared__ float4 smem4[];
  float4* bx = smem4;
  float* ar = reinterpret_cast<float*>(bx + kShortMax);
  u64* mask = reinterpret_cast<u64*>(ar + kShortMax);
  u64* removed = mask + col_off(kShortWords);
  const int t = threadIdx.x;
  const int count = h->shorts;
  for (int ci = blockIdx.x; ci < count; ci += gridDim.x) {
    const Chain ch = shorts[ci];
    const size_t row = (size_t)ch.b * n;
    const int L = ch.len, w = (L + kTile - 1) / kTile;
    for (int r = t; r < L; r += kThreads) {
      const float4 a = load_box(boxes, row + pos(order, row, ch.start + r));
      bx[r] = a;
      ar[r] = area<kPlusOne>(a);
    }
    if (t < w) removed[t] = 0ull;
    __syncthreads();
    // the upper-triangle tiles (rb <= cb), a thread rows r and r + 32 of one
    const int items = 32 * w * (w + 1) / 2;
    for (int q = t; q < items; q += kThreads) {
      int rb = 0, cb = q / 32;
      while (cb >= w - rb) {
        cb -= w - rb;
        ++rb;
      }
      cb += rb;
      const int r = q % 32, cols = min(kTile, L - cb * kTile);
      float4 a[2];
      float aa[2];
      u64 live[2], word[2];
      for (int k = 0; k < 2; ++k) {
        const int i = rb * kTile + r + 32 * k;
        a[k] = bx[i];
        aa[k] = ar[i];
        live[k] = i < L ? span(cb == rb ? r + 32 * k + 1 : 0, cols) : 0ull;
      }
      row_words<kPlusOne, 2>(a, aa, bx + cb * kTile, ar + cb * kTile, live,
                             th, word);
      for (int k = 0; k < 2; ++k) {
        const int i = rb * kTile + r + 32 * k;
        if (i < L) mask[col_off(cb) + i] = word[k];
      }
    }
    __syncthreads();
    if (t < 32) {  // the sweep, one warp: lane x ORs into word c + 1 + x
      for (int c = 0; c < w; ++c) {
        const int rows = min(kTile, L - c * kTile);
        const u64 kept =
            resolve(removed[c], mask + col_off(c) + c * kTile, rows);
        for (int r = t; r < rows; r += 32)
          keep[row + pos(order, row, ch.start + c * kTile + r)] =
              (kept >> r) & 1ull;
        const int cc = c + 1 + t;
        if (cc < w)
          removed[cc] =
              or_kept(removed[cc], kept, mask + col_off(cc) + c * kTile);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// the tile (rb, cb), rb <= cb, of a triangle of w x w tiles numbered row by
// row
__device__ __forceinline__ void tri_tile(long long q, int w, int& rb,
                                         int& cb) {
  const long long m = (long long)w * (w + 1) / 2 - 1 - q;  // from the end
  long long k = (long long)((sqrtf(8.f * (float)m + 1.f) - 1.f) * 0.5f);
  while ((k + 1) * (k + 2) / 2 <= m) ++k;
  while (k * (k + 1) / 2 > m) --k;
  rb = w - 1 - (int)k;
  cb = w - 1 - (int)(m - k * (k + 1) / 2);
}

// kThreads threads; dynamic shared memory: each warp's column tile (kTile
// float4 and kTile areas). A warp a tile of a long chain's mask at a time,
// a lane rows r and r + 32: mask word (b, cb, start + i) = row i's word cb.
template <bool kPlusOne>
__global__ void __launch_bounds__(kThreads)
long_mask_kernel(const float* __restrict__ boxes,
                 const long long* __restrict__ order,
                 const Header* __restrict__ h, const Chain* __restrict__ longs,
                 u64* __restrict__ mask, int n, int nw, Thresh th) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* cbx = smem4 + warp * kTile;
  float* car = reinterpret_cast<float*>(smem4 + kWarps * kTile) + warp * kTile;
  const u64 packed = h->longs;
  const int chains = (int)(packed >> 40);
  const long long tiles = (long long)(packed & kTileMask);
  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < tiles;
       tile += (long long)gridDim.x * kWarps) {
    int lo = 0, hi = chains - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (longs[mid].tile0 <= tile) lo = mid;
      else hi = mid - 1;
    }
    const Chain ch = longs[lo];
    const int L = ch.len, w = (L + kTile - 1) / kTile;
    int rb, cb;
    tri_tile(tile - ch.tile0, w, rb, cb);
    const size_t row = (size_t)ch.b * n;
    const int cols = min(kTile, L - cb * kTile);
    for (int j = lane; j < cols; j += 32) {
      const float4 a =
          load_box(boxes, row + pos(order, row, ch.start + cb * kTile + j));
      cbx[j] = a;
      car[j] = area<kPlusOne>(a);
    }
    float4 a[2];
    float aa[2];
    u64 live[2], word[2];
    for (int k = 0; k < 2; ++k) {
      const int i = rb * kTile + lane + 32 * k;
      a[k] = i < L ? load_box(boxes, row + pos(order, row, ch.start + i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      aa[k] = area<kPlusOne>(a[k]);
      live[k] = i < L ? span(cb == rb ? lane + 32 * k + 1 : 0, cols) : 0ull;
    }
    __syncwarp();
    row_words<kPlusOne, 2>(a, aa, cbx, car, live, th, word);
    for (int k = 0; k < 2; ++k) {
      const int i = rb * kTile + lane + 32 * k;
      if (i < L) mask[((size_t)ch.b * nw + cb) * n + ch.start + i] = word[k];
    }
    __syncwarp();
  }
}

// An asynchronous copy of kCopyWords words global -> shared (sm_80+),
// through L1; both addresses aligned to its size.
__device__ __forceinline__ void cp_async_words(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(8 * kCopyWords));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most kStages - 1 of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// OR of v over the warp's lanes
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
  return (u64)hi << 32 | lo;
}

// A long chain's stages, in order: column word c (rows 0 .. min(64 (c + 1),
// L) - 1 of the chain, each row's word c) in pieces of kChunk rows.
struct Stage {
  int c, p;
  __device__ int rows(int L) const { return min(kTile * (c + 1), L); }
  __device__ void next(int L) {
    if (++p * kChunk >= rows(L)) {
      ++c;
      p = 0;
    }
  }
};

// The mask word of stage st's first row, for the chain whose words start at
// mask word `base`. A stage's copy starts at the kCopyWords boundary at or
// before it, so its row r lands kCopyWords-aligned words in: at slot
// word stage_first % kCopyWords + r - r0.
__device__ __forceinline__ size_t stage_first(size_t base, int n, Stage st) {
  return base + (size_t)st.c * n + st.p * kChunk;
}

__device__ __forceinline__ void stage_rows(u64* dst, const u64* mask,
                                           size_t base, int n, int L,
                                           Stage st) {
  const size_t w0 = stage_first(base, n, st);
  const size_t lo = w0 - w0 % kCopyWords;
  const int words = (int)(w0 + min(kChunk, st.rows(L) - st.p * kChunk) - lo);
  for (int k = kCopyWords * (int)threadIdx.x; k < words;
       k += kCopyWords * kThreads)
    cp_async_words(dst + k, mask + lo + k);
}

// kThreads threads; dynamic shared memory: a ring of kStages stages (kSlot
// words each), the kept bits (nw words) and the warps' partial words
// (kWarps). A block a long chain at a time: for each word c, the kept rows
// before it OR their words c into `removed` (the column is pulled whole,
// kStages - 1 stages ahead by cp.async), then one warp resolves word c.
__global__ void __launch_bounds__(kThreads)
long_sweep_kernel(const long long* __restrict__ order,
                  const Header* __restrict__ h,
                  const Chain* __restrict__ longs, const u64* __restrict__ mask,
                  bool* __restrict__ keep, int n, int nw) {
  extern __shared__ float4 smem4[];
  u64* ring = reinterpret_cast<u64*>(smem4);
  u64* kept_bits = ring + kStages * kSlot;
  u64* part = kept_bits + nw;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int chains = (int)(h->longs >> 40);
  for (int ci = blockIdx.x; ci < chains; ci += gridDim.x) {
    const Chain ch = longs[ci];
    const int L = ch.len, w = (L + kTile - 1) / kTile;
    const size_t row = (size_t)ch.b * n;
    const size_t base = (size_t)ch.b * nw * n + ch.start;
    if (t < kWarps) part[t] = 0ull;
    Stage ld{0, 0}, cur{0, 0};
    for (int q = 0; q < kStages - 1; ++q) {
      if (ld.c < w) {
        stage_rows(ring + q * kSlot, mask, base, n, L, ld);
        ld.next(L);
      }
      cp_async_commit();
    }
    for (int s = 0; cur.c < w; ++s) {
      if (ld.c < w) {
        stage_rows(ring + ((s + kStages - 1) % kStages) * kSlot, mask, base,
                   n, L, ld);
        ld.next(L);
      }
      cp_async_commit();
      cp_async_wait_stages();
      __syncthreads();
      const u64* buf = ring + (s % kStages) * kSlot +
                       stage_first(base, n, cur) % kCopyWords;
      const int c = cur.c, r0 = cur.p * kChunk, rows_c = cur.rows(L);
      const int r1 = min(r0 + kChunk, rows_c), before = min(r1, kTile * c);
      u64 acc = 0ull;
      for (int r = r0 + t; r < before; r += kThreads)
        if ((kept_bits[r >> 6] >> (r & 63)) & 1ull) acc |= buf[r - r0];
      acc = warp_or(acc);
      if (lane == 0) part[warp] |= acc;
      if (r1 == rows_c) {  // the column's last piece holds word c's rows
        __syncthreads();
        if (warp == 0) {
          u64 removed = 0ull;
          for (int k = 0; k < kWarps; ++k) removed |= part[k];
          __syncwarp();
          if (lane < kWarps) part[lane] = 0ull;
          const int rows = rows_c - kTile * c;
          const u64 kept = resolve(removed, buf + (kTile * c - r0), rows);
          for (int k = lane; k < rows; k += 32)
            keep[row + pos(order, row, ch.start + c * kTile + k)] =
                (kept >> k) & 1ull;
          if (lane == 0) kept_bits[c] = kept;
        }
      }
      __syncthreads();
      cur.next(L);
    }
  }
}

size_t short_smem() {
  return kShortMax * (sizeof(float4) + sizeof(float)) +
         (col_off(kShortWords) + kShortWords) * sizeof(u64);
}

size_t sweep_smem(int nw) {
  return (kStages * kSlot + nw + kWarps) * sizeof(u64);
}

template <bool kPlusOne>
int launch(const float* boxes, const float* cls, const long long* order,
           char* work, bool* keep, int B, int n, const Thresh& th, int passes,
           int sms, cudaStream_t stream) {
  const Layout l = layout(B, n);
  const int nw = (n + kTile - 1) / kTile;
  Header* h = reinterpret_cast<Header*>(work);
  int* starts = reinterpret_cast<int*>(work + l.starts);
  Chain* shorts = reinterpret_cast<Chain*>(work + l.shorts);
  Chain* longs = reinterpret_cast<Chain*>(work + l.longs);
  u64* mask = reinterpret_cast<u64*>(work + l.mask);
  cudaError_t err;
  if (passes & 1) {
    err = cudaMemsetAsync(h, 0, sizeof(Header), stream);
    if (err != cudaSuccess) return (int)err;
    list_kernel<<<B, kListThreads, (kListThreads / 32 + 1) * sizeof(int),
                  stream>>>(cls, order, starts, h, shorts, longs, keep, n);
  }
  if (passes & 2) {
    // a block for every 128 boxes at most: a short chain worth a block
    const long long want = ((long long)B * n + 127) / 128;
    const int grid = (int)(want < sms * kShortBlocksPerSM
                               ? want : sms * kShortBlocksPerSM);
    short_kernel<kPlusOne><<<grid, kThreads, short_smem(), stream>>>(
        boxes, order, h, shorts, keep, n, th);
  }
  if (n <= kShortMax) return (int)cudaGetLastError();
  if (passes & 4) {
    const long long want =
        ((long long)B * nw * (nw + 1) / 2 + kWarps - 1) / kWarps;
    const int grid = (int)(want < sms * kMaskBlocksPerSM
                               ? want : sms * kMaskBlocksPerSM);
    long_mask_kernel<kPlusOne><<<grid, kThreads,
                                 kWarps * kTile * (sizeof(float4) +
                                                   sizeof(float)),
                                 stream>>>(boxes, order, h, longs, mask, n,
                                           nw, th);
  }
  if (passes & 8) {
    const size_t smem = sweep_smem(nw);
    err = cudaFuncSetAttribute(long_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long want = (long long)B * (n / (kShortMax + 1));
    const int grid = (int)(want < sms * kSweepBlocksPerSM
                               ? want : sms * kSweepBlocksPerSM);
    long_sweep_kernel<<<grid, kThreads, smem, stream>>>(order, h, longs, mask,
                                                        keep, n, nw);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The bytes of the workspace mxt_nms_sweep takes at (B, n); -1 where the
// shapes are out of its range.
extern "C" long long mxt_nms_workspace(int B, int n) {
  if (!shapes_ok(B, n)) return -1;
  return (long long)layout(B, n).bytes;
}

// boxes (B, n, 4) fp32 in score order; cls (B, n) fp32 class ids and order
// (B, n) int64, each sample's positions in class order (stable: score order
// within a class), both null for no class gate; work: mxt_nms_workspace(B, n)
// bytes of device memory (nothing in it is read before this call writes it);
// keep (B, n) bool out; passes: a bit a pass (1 the header and the lists, 2
// the short chains, 4 the long chains' mask, 8 their sweep; 15 runs the
// call, a single bit reruns that pass over the lists and mask the last call
// left). Returns a cudaError_t.
extern "C" int mxt_nms_sweep(const float* boxes, const float* cls,
                             const long long* order, void* work, bool* keep,
                             int B, int n, float thresh, int plus_one,
                             int passes, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return cudaSuccess;
  if (!shapes_ok(B, n) || (cls == nullptr) != (order == nullptr))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Thresh th{thresh, nextafterf(thresh, INFINITY),
                  thresh >= 0.f && thresh <= kMaxFloat};
  char* w = static_cast<char*>(work);
  return plus_one ? launch<true>(boxes, cls, order, w, keep, B, n, th, passes,
                                 sms, stream)
                  : launch<false>(boxes, cls, order, w, keep, B, n, th, passes,
                                  sms, stream);
}
