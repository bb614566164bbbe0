// emu.h: runs a CUDA kernel source of mxnet_tpu_torch/parallel/csrc on the
// CPU, for tests/test_torch_kernel_emulation.py. It stands in for
// cuda_runtime.h: every CUDA thread of a block is a std::thread, blocks run
// one after another, __syncthreads is a block-wide std::barrier, and a
// warp's shuffles and mma.sync.m16n8k8 (TF32 inputs, fp32 sums) exchange
// their lanes' values through a warp-wide one. Shared memory starts as NaNs,
// so a read of a slot nothing wrote shows. The test rewrites the sources'
// inline PTX (cp.async, mma.sync), their dynamic shared memory and their
// <<<...>>> launches into calls of what is here.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
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
inline EmuBlock* emu_block = nullptr;
inline float4* emu_smem = nullptr;
inline thread_local unsigned emu_exchanges = 0;
inline EmuWarp& emu_warp() { return emu_block->w[threadIdx.x >> 5]; }

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  EmuWarp& W = emu_warp();
  const int lane = threadIdx.x & 31, slot = emu_exchanges++ & 1;
  W.f[slot][lane] = v;
  W.bar.arrive_and_wait();
  return W.f[slot][lane ^ mask];
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

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, A... args) {
  gridDim = grid;
  blockDim = block;
  std::vector<float4> buf(smem / sizeof(float4) + 1);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::fill(buf.begin(), buf.end(), float4{NAN, NAN, NAN, NAN});
      EmuBlock blk(block.x);
      emu_block = &blk;
      emu_smem = buf.data();
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t] {
          threadIdx = dim3(t);
          emu_exchanges = 0;
          blockIdx = dim3(bx, by);
          kernel(args...);
        });
      for (auto& th : threads) th.join();
    }
}
