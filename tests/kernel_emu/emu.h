// emu.h: runs a CUDA kernel source of mxnet_tpu_torch/parallel/csrc on the
// CPU, for tests/test_torch_kernel_emulation.py. It stands in for
// cuda_runtime.h: every CUDA thread of a block is a std::thread, clusters of
// blocks run one after another (the blocks of a cluster at once; a block
// alone is a cluster of one), __syncthreads is a block-wide std::barrier, a
// cluster barrier a cluster-wide one, and a warp's shuffles and
// mma.sync.m16n8k8 (TF32 inputs, fp32 sums) exchange their lanes' values
// through a warp-wide one, as do its votes (__ballot_sync, __reduce_or_sync)
// and __syncwarp. Atomics are the compiler's, memsets on a stream happen at
// once. Shared memory starts as NaNs, so a read of a slot nothing wrote
// shows. The test rewrites the sources' inline PTX (cp.async, mma.sync, the
// cluster barrier and the mapping of a peer block's shared memory), their
// dynamic shared memory and their <<<...>>> and cluster launches into calls
// of what is here.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t bytes,
                                   cudaStream_t) {
  std::memset(p, v, bytes);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// an H100's 132 SMs, for the kernels' host-side choices
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 132;
  return cudaSuccess;
}

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
// the round-to-nearest intrinsics: one IEEE operation each (x86-64's
// baseline has no FMA to contract them into)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
// one rounding of a * b + c (glibc's fmaf is exact without the instruction)
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
// a read through the read-only cache: a plain read here
template <class T>
T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// A warp's exchange slots, two of each: a lane writes slot n % 2 of its
// n-th exchange, so one barrier an exchange suffices (a lane can only be
// one exchange ahead of the slowest).
struct EmuWarp {
  std::barrier<> bar{32};
  float f[2][32];
  uint32_t m[2][32][6];
};
struct EmuBlock {
  std::barrier<> bar;
  EmuWarp w[32];
  explicit EmuBlock(int n) : bar(n) {}
};
struct EmuCluster {
  std::barrier<> bar;
  std::vector<float4*> smem;  // each block's shared memory, by rank
  explicit EmuCluster(int n) : bar(n) {}
};
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local EmuCluster* emu_cluster = nullptr;
inline thread_local float4* emu_smem = nullptr;
inline thread_local unsigned emu_exchanges = 0;
inline EmuWarp& emu_warp() { return emu_block->w[threadIdx.x >> 5]; }

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void emu_cluster_sync() { emu_cluster->bar.arrive_and_wait(); }

// `p` in the calling block's shared memory, at the same offset in the
// shared memory of the cluster's block `rank`
template <class T>
T* emu_peer(T* p, int rank) {
  const char* base = reinterpret_cast<const char*>(emu_smem);
  const long off = reinterpret_cast<const char*>(p) - base;
  return reinterpret_cast<T*>(
      reinterpret_cast<char*>(emu_cluster->smem[rank]) + off);
}

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  EmuWarp& W = emu_warp();
  const int lane = threadIdx.x & 31, slot = emu_exchanges++ & 1;
  W.f[slot][lane] = v;
  W.bar.arrive_and_wait();
  return W.f[slot][lane ^ mask];
}

// OR of v over the warp's lanes
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  EmuWarp& W = emu_warp();
  const int lane = threadIdx.x & 31, slot = emu_exchanges++ & 1;
  W.m[slot][lane][0] = v;
  W.bar.arrive_and_wait();
  unsigned out = 0u;
  for (int l = 0; l < 32; ++l) out |= W.m[slot][l][0];
  return out;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp().bar.arrive_and_wait();
}

// bit l set where lane l's `pred` is true
inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& W = emu_warp();
  const int lane = threadIdx.x & 31, slot = emu_exchanges++ & 1;
  W.m[slot][lane][0] = pred ? 1u : 0u;
  W.bar.arrive_and_wait();
  unsigned bits = 0u;
  for (int l = 0; l < 32; ++l) bits |= W.m[slot][l][0] << l;
  return bits;
}

// d += a b for the warp's m16n8k8 fragments (a: rows g, g+8 x columns t,
// t+4; b: rows t, t+4 x column g; d: row g columns 2t, 2t+1, then row g+8).
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4],
                    const uint32_t (&b)[2]) {
  EmuWarp& W = emu_warp();
  const int lane = threadIdx.x & 31;
  uint32_t(&m)[32][6] = W.m[emu_exchanges++ & 1];
  for (int i = 0; i < 4; ++i) m[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) m[lane][4 + i] = b[i];
  W.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float s = d[e];
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t av = m[(row % 8) * 4 + kk % 4][(row < 8 ? 0 : 1) +
                                                    (kk < 4 ? 0 : 2)];
      const uint32_t bv = m[col * 4 + kk % 4][4 + (kk < 4 ? 0 : 1)];
      s += __uint_as_float(av) * __uint_as_float(bv);
    }
    d[e] = s;
  }
}

// Runs `grid` blocks of `kernel` in clusters of `cluster` consecutive
// blocks.
template <class K, class... A>
void emu_launch_cluster(K kernel, dim3 grid, int cluster, dim3 block,
                        size_t smem, A... args) {
  gridDim = grid;
  blockDim = block;
  const unsigned nb = grid.x * grid.y;
  std::vector<std::vector<float4>> bufs(cluster);
  for (unsigned c0 = 0; c0 < nb; c0 += cluster) {
    EmuCluster cl(cluster * block.x);
    std::vector<std::unique_ptr<EmuBlock>> blocks;
    for (int r = 0; r < cluster; ++r) {
      bufs[r].assign(smem / sizeof(float4) + 1, float4{NAN, NAN, NAN, NAN});
      cl.smem.push_back(bufs[r].data());
      blocks.emplace_back(new EmuBlock(block.x));
    }
    std::vector<std::thread> threads;
    for (int r = 0; r < cluster; ++r)
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, r, t] {
          const unsigned id = c0 + r;
          threadIdx = dim3(t);
          blockIdx = dim3(id % grid.x, id / grid.x);
          emu_block = blocks[r].get();
          emu_cluster = &cl;
          emu_smem = bufs[r].data();
          emu_exchanges = 0;
          kernel(args...);
        });
    for (auto& th : threads) th.join();
  }
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, A... args) {
  emu_launch_cluster(kernel, grid, 1, block, smem, args...);
}
