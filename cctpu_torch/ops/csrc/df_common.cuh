// Code shared by every DF kernel library (df_j.cu, df_k.cu, df_jk_fused.cu,
// df_k_dm.cu; sm_90a, FP64 and FP32): the block size, the fixed-order tree
// sum over a block, the fixed-order sum of per-block partials, the FP64
// tensor-core product, the shared-memory opt-in, and the error-string entry
// each library exports. Every sum here runs in a fixed order, so repeat
// calls give bitwise-equal results.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace dfc {

constexpr int kThreads = 512;  // power of two (tree reduction below)

// Fixed-order tree sums of N values over the block; red holds N * kThreads
// elements and is reusable on return.
template <typename T, int N>
__device__ void block_sum(T (&v)[N], T* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < N; ++s) red[s * kThreads + tid] = v[s];
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) {
#pragma unroll
      for (int s = 0; s < N; ++s)
        red[s * kThreads + tid] += red[s * kThreads + tid + h];
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < N; ++s) v[s] = red[s * kThreads];
  __syncthreads();
}

// out[e] = sum over b = 0, 1, ..., nblk - 1 of w[b * total + e], in that
// order. With tile > 0 the partials are nao x nao matrices that hold only
// the upper triangle of tile x tile blocks (total == nao * nao): an element
// below it is read at its transpose.
template <typename T>
__global__ void partial_sum(const T* __restrict__ w, int nblk, size_t total,
                            int nao, int tile, T* __restrict__ out) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    size_t src = e;
    if (tile > 0) {
      const int i = static_cast<int>(e / nao);
      const int j = static_cast<int>(e - static_cast<size_t>(i) * nao);
      if (i / tile > j / tile) src = static_cast<size_t>(j) * nao + i;
    }
    T s = T(0);
    for (int b = 0; b < nblk; ++b) s += w[static_cast<size_t>(b) * total + src];
    out[e] = s;
  }
}

template <typename T>
cudaError_t launch_partial_sum(const T* w, int nblk, size_t total, int nao,
                               int tile, T* out, cudaStream_t stream) {
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  partial_sum<T><<<static_cast<int>(blocks), threads, 0, stream>>>(
      w, nblk, total, nao, tile, out);
  return cudaGetLastError();
}

// c[16x8] += a[16x4] b[4x8] on the FP64 tensor cores. A lane (g = lane / 4,
// t = lane % 4) holds a0 = a[g][t], a1 = a[g + 8][t], b = b[t][g] and
// c[i] = c[g + 8 (i / 2)][2t + i % 2]. The FP64 tensor cores' full rate on
// the H100; m8n8k4 issues at half of it (ops/bench_mma.py).
__device__ __forceinline__ void mma1684(double (&c)[4], double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// c[16x8] += a[16x16] b[16x8] on the FP64 tensor cores, in one
// instruction (the same rate as m16n8k4, ops/bench_mma.py). A lane holds
// a[i] = a[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = b[t + 4 i][g] and c as
// mma1684's.
__device__ __forceinline__ void mma16816(double (&c)[4], const double (&a)[8],
                                         const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The most dynamic shared memory one block of the current device may opt
// in to, in bytes.
inline cudaError_t smem_optin(size_t* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *cap = static_cast<size_t>(bytes);
  return err;
}

}  // namespace dfc

// Each .cu that includes this header builds into a library of its own, so
// this is defined once per library.
extern "C" const char* df_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
