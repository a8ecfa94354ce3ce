// Density-fitted Coulomb J for Hopper (sm_90a), FP64 and FP32.
//
// Replaces the two TPU Pallas kernels of cctpu/ops/df_jk_pallas.py::
// df_j_fast: _jp_kernel (Jp[p] = sum_ij B[p,ij] D[ij]) and _j_kernel
// (J[ij] = sum_p Jp[p] B[p,ij]), which read B twice. For B [naux, nao, nao]
// and NSET = 1 or 2 densities D [NSET, nao, nao] (the two spins of UHF/UKS
// share one pass over B) it computes
//     jp[s,p] = sum_ij B[p,i,j] D[s,i,j]      J[s] = sum_p jp[s,p] B[p]
//
// Bound: the call reads B once, naux*nao^2*8 bytes in FP64 (162 MB at
// phenoxyl 6-31G*, 4.1 GB at C16H34), against 4*NSET flops per element of
// B: bound by device-memory bandwidth (0.05 ms and 1.23 ms at 3.35 TB/s).
//
// Design: jp[p] needs only B[p], so one pass does both halves.
//   * j_partial: block b owns a contiguous range of aux rows and walks it
//     in order. Per row p every thread reads its own elements of B[p]
//     (e = tid, tid + kThreads, ..., coalesced; kU of them per step, all
//     loads issued before the first is used), accumulates its part of
//     jp[s,p], the block reduces jp in a fixed tree order, and each thread
//     adds jp[s,p] B[p,e] into the block's partial J at the same elements,
//     re-reading B[p,e] (from L1 or L2: the same thread read it a moment
//     before). A thread touches only its own elements of each row, so the
//     row loop needs no barrier beyond the reduction's. The partial J lives
//     in shared memory when NSET*nao^2 fits (phenoxyl), else in a workspace
//     [nblk, NSET, nao, nao] in device memory.
//   * df_common.cuh's partial_sum sums the nblk partials in block order.
//   No float atomics: repeat calls give bitwise-equal J.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include "df_common.cuh"

namespace {

using dfc::kThreads;
// elements per thread per step of the row loops: all their loads are
// issued before any is used (one element per step leaves a thread one
// element's loads in flight at a time)
constexpr int kU = 4;

template <typename T, int NSET>
__global__ void __launch_bounds__(kThreads)
j_partial(const T* __restrict__ B, const T* __restrict__ D, int naux,
          int nao, int rows_per_blk, int j_in_smem, T* __restrict__ Jw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t n2 = static_cast<size_t>(nao) * nao;
  T* red = reinterpret_cast<T*>(smem_raw);                  // [NSET, kThreads]
  T* Jsm = red + NSET * kThreads;                           // [NSET, n2]
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  T* Jg = Jw + static_cast<size_t>(blk) * NSET * n2;
  T* Jb = j_in_smem ? Jsm : Jg;

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
  if (j_in_smem) {
    __syncthreads();
    for (size_t e = tid; e < NSET * n2; e += kThreads) Jg[e] = Jsm[e];
  }
}

template <typename T, int NSET>
int launch(const void* B, const void* D, int naux, int nao, int nblk,
           int rows_per_blk, void* Jw, void* J, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t cap = 0;
  cudaError_t err = dfc::smem_optin(&cap);
  if (err != cudaSuccess) return err;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  // the partial J on chip when it fits: it is read and written every row
  const size_t red_bytes = sizeof(T) * NSET * kThreads;
  const size_t j_bytes = red_bytes + sizeof(T) * NSET * n2;
  const int j_in_smem = j_bytes <= cap;
  const size_t smem = j_in_smem ? j_bytes : red_bytes;
  err = cudaFuncSetAttribute(j_partial<T, NSET>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  j_partial<T, NSET><<<nblk, kThreads, smem, s>>>(
      static_cast<const T*>(B), static_cast<const T*>(D), naux, nao,
      rows_per_blk, j_in_smem, static_cast<T*>(Jw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dfc::launch_partial_sum<T>(static_cast<const T*>(Jw), nblk,
                                    NSET * n2, nao, 0, static_cast<T*>(J),
                                    s);
}

template <typename T>
int launch_nset(const void* B, const void* D, int naux, int nao, int nset,
                int nblk, int rows_per_blk, void* Jw, void* J,
                void* stream) {
  if (nset == 1)
    return launch<T, 1>(B, D, naux, nao, nblk, rows_per_blk, Jw, J, stream);
  if (nset == 2)
    return launch<T, 2>(B, D, naux, nao, nblk, rows_per_blk, Jw, J, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int df_j_f64(const void* B, const void* D, int naux, int nao, int nset,
             int nblk, int rows_per_blk, void* Jw, void* J, void* stream) {
  return launch_nset<double>(B, D, naux, nao, nset, nblk, rows_per_blk, Jw,
                             J, stream);
}

int df_j_f32(const void* B, const void* D, int naux, int nao, int nset,
             int nblk, int rows_per_blk, void* Jw, void* J, void* stream) {
  return launch_nset<float>(B, D, naux, nao, nset, nblk, rows_per_blk, Jw,
                            J, stream);
}

}  // extern "C"
