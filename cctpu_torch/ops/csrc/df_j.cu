// Density-fitted Coulomb J for Hopper (sm_90a), FP64 and FP32.
//
// Replaces the two TPU Pallas kernels of cctpu/ops/df_jk_pallas.py::
// df_j_fast: _jp_kernel (Jp[p] = sum_ij B[p,ij] D[ij]) and _j_kernel
// (J[ij] = sum_p Jp[p] B[p,ij]). For B [naux, nao, nao] and NSET = 1 or 2
// densities D [NSET, nao, nao] (the two spins of UHF/UKS share the reads
// of B) it computes
//     jp[s,p] = sum_ij B[p,i,j] D[s,i,j]      J[s] = sum_p jp[s,p] B[p]
//
// Bound: one read of B, naux*nao^2*8 bytes in FP64 (162 MB at phenoxyl
// 6-31G*, 4.1 GB at C16H34), against 4*NSET flops per element of B: bound
// by device-memory bandwidth (0.05 ms and 1.23 ms at 3.35 TB/s), far below
// the card's FP64 balance point. Two plans (ops/plan.py::j_plan):
//   * one_pass, where the partial J of all densities fits in shared memory
//     (phenoxyl's and phenol's shapes): B is read once. j_partial: block b
//     owns a contiguous range of aux rows and walks it in order. Per row p
//     every thread reads its own elements of B[p] (e = tid, tid + kThreads,
//     ..., coalesced; kU of them per step, all loads issued before the
//     first is used), accumulates its part of jp[s,p], the block reduces jp
//     in a fixed tree order, and each thread adds jp[s,p] B[p,e] into the
//     block's partial J in shared memory at the same elements, re-reading
//     B[p,e] from L1 or L2. df_common.cuh's partial_sum adds the block
//     partials in block order.
//   * two_pass elsewhere (C16H34): a partial J per block would have to
//     live in device memory and be read and written once per aux row, so
//     the halves run apart, as on the TPU, and B is read twice: this plan
//     cannot beat ~2x the bound (2.46 ms at C16H34 in FP64).
//     jp_pass: a block owns a column chunk of B (viewed as [naux, nao^2])
//     and a group of aux rows; each thread keeps its elements of D in
//     registers for the whole group, reads kJpRows rows' elements at once
//     (16-byte loads where nao is even), and the block sums the
//     kJpRows * NSET dot products once per kJpRows rows (warp shuffles,
//     then the warps in order), storing one partial per (chunk, row).
//     partial_sum adds the chunks in chunk order: jp [NSET, naux].
//     j_sweep: each thread owns fixed elements of J for all densities and
//     walks the aux rows in order with kSweepU rows' loads in flight, jp
//     staged through shared memory; it writes J once. Where its blocks
//     number fewer than two an SM (C16H34: 167 of 256 threads, whose
//     loads then leave the memory system idle between a thread's batches)
//     the rows are split into a few groups (at most ops/plan.py's
//     J_SWEEP_MAX_GROUPS), whose partial J partial_sum adds in group order.
//   No float atomics: repeat calls give bitwise-equal J.
//
// C interface (bound with ctypes): pointers and the stream are void*; the
// plan integers are those of ops/plan.py::J_PLAN_INTS; ws is the plan's
// workspace (one_pass: the block partials [nblk, NSET, nao^2]; two_pass:
// the jp partials [nchunk, NSET, naux], jp [NSET, naux], then, with more
// than one sweep group, their partial J [groups, NSET, nao^2]). The return
// value is cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a plan that is inconsistent or over the shared-memory cap.

#include <stdint.h>

#include "df_common.cuh"

namespace {

using dfc::kThreads;
// elements per thread per step of j_partial's row loops: all their loads
// are issued before any is used (one element per step leaves a thread one
// element's loads in flight at a time)
constexpr int kU = 4;
// the two-pass kernels: most threads a block, bytes of B a jp_pass thread
// reads from each aux row, aux rows a jp_pass block reads before one block
// sum, aux rows whose loads a j_sweep thread has in flight, rows of jp a
// j_sweep block stages in shared memory
constexpr int kTwoPassMaxThreads = 256;
constexpr int kJpBytes = 64;
constexpr int kJpRows = 4;
constexpr int kSweepU = 16;
constexpr int kSlab = 512;

inline int cdiv(size_t a, size_t b) {
  return static_cast<int>((a + b - 1) / b);
}

template <typename T, int NSET>
__global__ void __launch_bounds__(kThreads)
j_partial(const T* __restrict__ B, const T* __restrict__ D, int naux,
          int nao, int rows_per_blk, T* __restrict__ Jw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t n2 = static_cast<size_t>(nao) * nao;
  T* red = reinterpret_cast<T*>(smem_raw);                  // [NSET, kThreads]
  T* Jb = red + NSET * kThreads;                            // [NSET, n2]
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;

  for (size_t e = tid; e < NSET * n2; e += kThreads) Jb[e] = T(0);
  // the zeroing (and the copy-out below) walk NSET * n2 elements, the
  // row updates n2 per set: another thread may own an element of set 1
  __syncthreads();
  const int p0 = blk * rows_per_blk;
  const int p1 = min(naux, p0 + rows_per_blk);
  for (int p = p0; p < p1; ++p) {
    const T* Bp = B + static_cast<size_t>(p) * n2;
    T jp[NSET] = {};
    for (size_t e0 = tid; e0 < n2; e0 += kU * kThreads) {
      T b[kU], d[NSET][kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t e = e0 + static_cast<size_t>(u) * kThreads;
        b[u] = e < n2 ? Bp[e] : T(0);
#pragma unroll
        for (int s = 0; s < NSET; ++s)
          d[s][u] = e < n2 ? D[s * n2 + e] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int s = 0; s < NSET; ++s) jp[s] += b[u] * d[s][u];
    }
    dfc::block_sum<T, NSET>(jp, red);
    for (size_t e0 = tid; e0 < n2; e0 += kU * kThreads) {
      T b[kU], j[NSET][kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t e = e0 + static_cast<size_t>(u) * kThreads;
        b[u] = e < n2 ? Bp[e] : T(0);
#pragma unroll
        for (int s = 0; s < NSET; ++s)
          j[s][u] = e < n2 ? Jb[s * n2 + e] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t e = e0 + static_cast<size_t>(u) * kThreads;
        if (e < n2) {
#pragma unroll
          for (int s = 0; s < NSET; ++s)
            Jb[s * n2 + e] = j[s][u] + jp[s] * b[u];
        }
      }
    }
  }
  __syncthreads();
  T* Jg = Jw + static_cast<size_t>(blk) * NSET * n2;
  for (size_t e = tid; e < NSET * n2; e += kThreads) Jg[e] = Jb[e];
}

// W consecutive elements of T in one load: 16 bytes for W > 1 (the caller
// guarantees the alignment), else one element.
template <typename T, int W>
struct Ld {
  static_assert(W == 1, "Ld: unsupported vector width");
  static __device__ __forceinline__ void run(const T* p, T* o) {
    o[0] = __ldg(p);
  }
};
template <>
struct Ld<double, 2> {
  static __device__ __forceinline__ void run(const double* p, double* o) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
};
template <>
struct Ld<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

// jpw[chunk, s, p] = sum over the chunk's elements e of B[p, e] D[s, e],
// for the block's column chunk (blockIdx.x) and aux rows [p0, p1)
// (blockIdx.y); VEC elements a load, U loads of a row a thread.
template <typename T, int NSET, int VEC>
__global__ void __launch_bounds__(kTwoPassMaxThreads)
jp_pass(const T* __restrict__ B, const T* __restrict__ D, int naux,
        size_t n2, int rows, T* __restrict__ jpw) {
  constexpr int U = kJpBytes / static_cast<int>(sizeof(T)) / VEC;
  constexpr int NV = kJpRows * NSET;
  __shared__ T red[2][kTwoPassMaxThreads / 32][NV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const size_t nv = n2 / VEC;
  const size_t v0 = static_cast<size_t>(blockIdx.x) * U * blockDim.x + tid;
  T d[NSET][U][VEC];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const size_t v = v0 + static_cast<size_t>(k) * blockDim.x;
#pragma unroll
    for (int s = 0; s < NSET; ++s) {
      if (v < nv) {
        Ld<T, VEC>::run(D + s * n2 + v * VEC, d[s][k]);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) d[s][k][c] = T(0);
      }
    }
  }
  const int p0 = blockIdx.y * rows;
  const int p1 = min(naux, p0 + rows);
  int buf = 0;
  for (int p = p0; p < p1; p += kJpRows, buf ^= 1) {
    T b[kJpRows][U][VEC];
#pragma unroll
    for (int r = 0; r < kJpRows; ++r) {
      const T* Bp = B + static_cast<size_t>(p + r) * n2;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const size_t v = v0 + static_cast<size_t>(k) * blockDim.x;
        if (p + r < p1 && v < nv) {
          Ld<T, VEC>::run(Bp + v * VEC, b[r][k]);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) b[r][k][c] = T(0);
        }
      }
    }
    T acc[kJpRows][NSET];
#pragma unroll
    for (int r = 0; r < kJpRows; ++r)
#pragma unroll
      for (int s = 0; s < NSET; ++s) {
        T a = T(0);
#pragma unroll
        for (int k = 0; k < U; ++k)
#pragma unroll
          for (int c = 0; c < VEC; ++c) a += b[r][k][c] * d[s][k][c];
        acc[r][s] = a;
      }
    // fixed-order sums: over the warp by shuffles, then over the warps in
    // order; red alternates between two buffers, so one barrier a step
    // keeps the next step's writes off the values still being summed
#pragma unroll
    for (int r = 0; r < kJpRows; ++r)
#pragma unroll
      for (int s = 0; s < NSET; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][s] += __shfl_down_sync(0xffffffffu, acc[r][s], off);
        if (lane == 0) red[buf][warp][r * NSET + s] = acc[r][s];
      }
    __syncthreads();
    if (tid < NV) {
      const int r = tid / NSET, s = tid - (tid / NSET) * NSET;
      if (p + r < p1) {
        T sum = T(0);
        for (int w = 0; w < nwarp; ++w) sum += red[buf][w][tid];
        jpw[(static_cast<size_t>(blockIdx.x) * NSET + s) * naux + p + r] =
            sum;
      }
    }
  }
}

// out[g, s, e] = sum over p = p0, p0 + 1, ..., p1 - 1, in that order, of
// jp[s, p] B[p, e], for the block's elements (blockIdx.x: VEC of them a
// thread) and its group g = blockIdx.y of aux rows [p0, p1).
template <typename T, int NSET, int VEC>
__global__ void __launch_bounds__(kTwoPassMaxThreads)
j_sweep(const T* __restrict__ B, const T* __restrict__ jp, int naux,
        size_t n2, int rows, T* __restrict__ out) {
  __shared__ T jps[NSET][kSlab];
  const size_t nv = n2 / VEC;
  const size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = v < nv;
  const int p0 = blockIdx.y * rows;
  const int p1 = min(naux, p0 + rows);
  const T* src = B + v * VEC;
  T acc[NSET][VEC];
#pragma unroll
  for (int s = 0; s < NSET; ++s)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[s][c] = T(0);
  for (int q0 = p0; q0 < p1; q0 += kSlab) {
    const int q1 = min(p1, q0 + kSlab);
    __syncthreads();                      // the slab before is read
    for (int i = threadIdx.x; i < NSET * kSlab; i += blockDim.x) {
      const int s = i / kSlab, q = i - s * kSlab;
      jps[s][q] = q0 + q < q1 ? jp[static_cast<size_t>(s) * naux + q0 + q]
                              : T(0);
    }
    __syncthreads();
    if (!live) continue;
    int q = q0;
    for (; q + kSweepU <= q1; q += kSweepU) {
      T b[kSweepU][VEC];
#pragma unroll
      for (int u = 0; u < kSweepU; ++u)
        Ld<T, VEC>::run(src + static_cast<size_t>(q + u) * n2, b[u]);
#pragma unroll
      for (int u = 0; u < kSweepU; ++u)
#pragma unroll
        for (int s = 0; s < NSET; ++s)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[s][c] += jps[s][q - q0 + u] * b[u][c];
    }
    for (; q < q1; ++q) {
      T b[VEC];
      Ld<T, VEC>::run(src + static_cast<size_t>(q) * n2, b);
#pragma unroll
      for (int s = 0; s < NSET; ++s)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[s][c] += jps[s][q - q0] * b[c];
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < NSET; ++s)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      out[(static_cast<size_t>(blockIdx.y) * NSET + s) * n2 + v * VEC + c] =
          acc[s][c];
}

// ops/plan.py::J_PLAN_INTS (two_pass: its kind)
struct JPlan {
  int two_pass, nblk, rows, threads, nchunk, sweep_groups, sweep_rows, vec;
};

template <typename T, int NSET>
cudaError_t launch_one_pass(const T* B, const T* D, int naux, int nao,
                            const JPlan& pl, T* ws, T* J, cudaStream_t s) {
  size_t cap = 0;
  cudaError_t err = dfc::smem_optin(&cap);
  if (err != cudaSuccess) return err;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const size_t smem = sizeof(T) * NSET * (kThreads + n2);
  if (smem > cap || pl.threads != kThreads || pl.rows < 1 ||
      pl.nblk != cdiv(naux, pl.rows))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(j_partial<T, NSET>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  j_partial<T, NSET><<<pl.nblk, kThreads, smem, s>>>(B, D, naux, nao,
                                                     pl.rows, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dfc::launch_partial_sum<T>(ws, pl.nblk, NSET * n2, nao, 0, J, s);
}

template <typename T, int NSET, int VEC>
cudaError_t launch_two_pass(const T* B, const T* D, int naux, int nao,
                            const JPlan& pl, T* ws, T* J, cudaStream_t s) {
  const size_t n2 = static_cast<size_t>(nao) * nao;
  T* jpw = ws;
  T* jp = jpw + static_cast<size_t>(pl.nchunk) * NSET * naux;
  T* jsw = jp + static_cast<size_t>(NSET) * naux;
  jp_pass<T, NSET, VEC><<<dim3(pl.nchunk, pl.nblk), pl.threads, 0, s>>>(
      B, D, naux, n2, pl.rows, jpw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = dfc::launch_partial_sum<T>(jpw, pl.nchunk, NSET * naux, nao, 0, jp, s);
  if (err != cudaSuccess) return err;
  const int sweep_blocks = cdiv(n2 / VEC, pl.threads);
  j_sweep<T, NSET, VEC>
      <<<dim3(sweep_blocks, pl.sweep_groups), pl.threads, 0, s>>>(
          B, jp, naux, n2, pl.sweep_rows, pl.sweep_groups > 1 ? jsw : J);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.sweep_groups == 1) return err;
  return dfc::launch_partial_sum<T>(jsw, pl.sweep_groups, NSET * n2, nao, 0,
                                    J, s);
}

template <typename T, int NSET>
int launch(const void* B, const void* D, int naux, int nao, const JPlan& pl,
           void* ws, void* J, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(B);
  const T* d = static_cast<const T*>(D);
  T* w = static_cast<T*>(ws);
  T* j = static_cast<T*>(J);
  if (naux < 1 || nao < 1) return cudaErrorInvalidValue;
  if (!pl.two_pass)
    return launch_one_pass<T, NSET>(b, d, naux, nao, pl, w, j, s);
  const size_t n2 = static_cast<size_t>(nao) * nao;
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(D) % 16 == 0;
  if (pl.threads < 32 || pl.threads > kTwoPassMaxThreads ||
      pl.threads % 32 != 0 ||
      pl.nchunk != cdiv(n2, static_cast<size_t>(pl.threads) * kJpBytes /
                                sizeof(T)) ||
      pl.rows < 1 || pl.nblk != cdiv(naux, pl.rows) || pl.nblk > 65535 ||
      pl.sweep_rows < 1 || pl.sweep_groups != cdiv(naux, pl.sweep_rows) ||
      pl.sweep_groups > 65535 ||
      !(pl.vec == 1 || (pl.vec == kVec && n2 % kVec == 0 && aligned)))
    return cudaErrorInvalidValue;
  if (pl.vec == 1)
    return launch_two_pass<T, NSET, 1>(b, d, naux, nao, pl, w, j, s);
  return launch_two_pass<T, NSET, kVec>(b, d, naux, nao, pl, w, j, s);
}

template <typename T>
int launch_nset(const void* B, const void* D, int naux, int nao, int nset,
                const JPlan& pl, void* ws, void* J, void* stream) {
  if (nset == 1) return launch<T, 1>(B, D, naux, nao, pl, ws, J, stream);
  if (nset == 2) return launch<T, 2>(B, D, naux, nao, pl, ws, J, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int df_j_f64(const void* B, const void* D, int naux, int nao, int nset,
             int two_pass, int nblk, int rows, int threads, int nchunk,
             int sweep_groups, int sweep_rows, int vec, void* ws, void* J,
             void* stream) {
  return launch_nset<double>(
      B, D, naux, nao, nset,
      {two_pass, nblk, rows, threads, nchunk, sweep_groups, sweep_rows, vec},
      ws, J, stream);
}

int df_j_f32(const void* B, const void* D, int naux, int nao, int nset,
             int two_pass, int nblk, int rows, int threads, int nchunk,
             int sweep_groups, int sweep_rows, int vec, void* ws, void* J,
             void* stream) {
  return launch_nset<float>(
      B, D, naux, nao, nset,
      {two_pass, nblk, rows, threads, nchunk, sweep_groups, sweep_rows, vec},
      ws, J, stream);
}

}  // extern "C"
