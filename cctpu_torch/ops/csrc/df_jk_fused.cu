// Fused density-fitted J/K build for Hopper (sm_90a), FP64 and FP32.
//
// Replaces the TPU Pallas kernel cctpu/ops/df_jk_pallas.py::_fused_jk_kernel
// (entry df_jk_fused). For B [naux, nao, nao], D [nao, nao] and
// C = Cocc [nao, nocc] (columns carry sqrt(occupation)) it computes
//     jp[p] = sum_ij B[p,i,j] D[i,j]        J = sum_p jp[p] B[p]
//     W_p   = (B[p] C)^T  ([nocc, nao])    K = sum_p W_p^T W_p
// streaming B through shared memory, without ever writing the full
// W [naux, nocc, nao] to device memory.
//
// Design (simple first: FMA loops, no wgmma/TMA/pipelining yet):
//   * df_jk_partial: block b owns a contiguous range of aux rows and walks
//     it in order. Per row p it loads B[p] in column tiles B[p][:, k0:k0+kt]
//     into shared memory (accumulating the jp partial while loading), adds
//     the tile's contribution to W_p, reduces jp[p] over the block in a
//     fixed tree order, and then adds jp[p] B[p] and W_p^T W_p into the
//     block's own partial J and K in a workspace [nblk, nao, nao]. When the
//     whole B[p] fits in shared memory (kt == nao: nao up to ~150 in FP64)
//     it is read from device memory exactly once; otherwise the J update
//     re-reads the row the block has just streamed, which mostly hits L2.
//     W_p lives in shared memory when it fits, else in a per-block scratch
//     slab of one aux row's W_p in device memory.
//     Each thread computes 4x4 register micro-tiles of W_p and of K (two
//     shared-memory loads per four FMAs instead of two per one), and K, a
//     symmetric product, only on the upper triangle of 4x4 tiles.
//   * df_jk_reduce: sums the nblk partials in block-index order and
//     mirrors K's lower tile triangle from the upper one.
//   No float atomics anywhere: two calls on the same inputs give
//   bitwise-equal J and K.
//
// Bound: B is naux*nao^2*8 bytes per call in FP64 (171 MB at phenol
// 6-31G*, 4.1 GB at C16H34), which makes the call bound by device-memory
// bandwidth at small nocc; the W and K products add 4*nocc flops per B
// element, so from nocc ~ 25 on the FP64 FMA rate is the other bound.
// The design streams B once per call from device memory (the J sweep's
// second look at a row comes from shared memory or L2) and keeps W on
// chip or in one small slab per block, so bytes stay near the B floor;
// the flops move to the tensor cores (DMMA/wgmma) in a later version.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;  // power of two (tree reduction below)
constexpr int kR = 4;          // register micro-tile edge (W and K updates)

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Fixed-order tree sum over the block. Leaves red[] reusable on return.
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const T out = red[0];
  __syncthreads();
  return out;
}

// First index of row I in the row-major upper triangle (J >= I) of an
// nt x nt tile grid.
__device__ inline int tri_row_start(int I, int nt) {
  return I * nt - I * (I - 1) / 2;
}

// Layout (all in units of T): ldw = round_up(nao, kR) and
// ldc = round_up(nocc, kR) pad W, B rows and C columns with zeros so that
// every micro-tile is full; the padding never reaches J or K.
template <typename T>
__global__ void __launch_bounds__(kThreads)
df_jk_partial(const T* __restrict__ B, const T* __restrict__ D,
              const T* __restrict__ C, int naux, int nao, int nocc,
              int rows_per_blk, int kt, int w_in_smem, T* __restrict__ Jw,
              T* __restrict__ Kw, T* __restrict__ Wslab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldw = round_up(nao, kR);
  const int ldc = round_up(nocc, kR);
  // B[p] column tile [ldw, kt], row stride kt + 1 (odd: consecutive rows
  // fall in different banks)
  const int ldb = kt + 1;
  T* red = reinterpret_cast<T*>(smem_raw);          // [kThreads]
  T* Bs = red + kThreads;                           // [ldw, ldb]
  T* Cs = Bs + static_cast<size_t>(ldw) * ldb;      // [kt, ldc]
  T* Wsm = Cs + static_cast<size_t>(kt) * ldc;      // [ldc, ldw] if in smem

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const int nw = ldc * ldw;
  T* W = w_in_smem ? Wsm : Wslab + static_cast<size_t>(blk) * nw;
  T* Jb = Jw + static_cast<size_t>(blk) * n2;
  T* Kb = Kw + static_cast<size_t>(blk) * n2;
  const bool whole = kt >= nao;  // B[p] fully staged: read once
  const int n_at = ldc / kR, n_it = ldw / kR;
  const int n_tri = n_it * (n_it + 1) / 2;

  for (size_t e = tid; e < n2; e += kThreads) {
    Jb[e] = T(0);
    Kb[e] = T(0);
  }
  // zero padding rows of Bs and padding columns of Cs once: the loads
  // below never write them
  for (int e = tid; e < (ldw - nao) * ldb; e += kThreads)
    Bs[static_cast<size_t>(nao) * ldb + e] = T(0);
  for (int e = tid; e < kt * ldc; e += kThreads) Cs[e] = T(0);

  const int p0 = blk * rows_per_blk;
  const int p1 = min(naux, p0 + rows_per_blk);
  for (int p = p0; p < p1; ++p) {
    const T* Bp = B + static_cast<size_t>(p) * n2;
    __syncthreads();  // previous row's readers of W/Bs are done
    for (int e = tid; e < nw; e += kThreads) W[e] = T(0);
    T jp_part = T(0);
    for (int k0 = 0; k0 < nao; k0 += kt) {
      const int kn = min(kt, nao - k0);
      __syncthreads();  // W zeroed / previous tile consumed
      for (int e = tid; e < nao * kn; e += kThreads) {
        const int i = e / kn;
        const int k = e - i * kn;
        const size_t g = static_cast<size_t>(i) * nao + k0 + k;
        const T b = Bp[g];
        Bs[i * ldb + k] = b;
        jp_part += b * D[g];
      }
      for (int e = tid; e < kn * nocc; e += kThreads) {
        const int k = e / nocc;
        const int a = e - k * nocc;
        Cs[k * ldc + a] = C[static_cast<size_t>(k0 + k) * nocc + a];
      }
      __syncthreads();
      // W[a, i] += sum_k B[p, i, k0 + k] * C[k0 + k, a]  (= (B[p] C)^T:
      // exact for any B, symmetric or not), kR x kR (a, i) per thread
      for (int e = tid; e < n_at * n_it; e += kThreads) {
        const int a0 = (e % n_at) * kR;
        const int i0 = (e / n_at) * kR;
        T acc[kR][kR] = {};
        for (int k = 0; k < kn; ++k) {
          T bv[kR], cv[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            bv[r] = Bs[(i0 + r) * ldb + k];
            cv[r] = Cs[k * ldc + a0 + r];
          }
#pragma unroll
          for (int s = 0; s < kR; ++s)
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[s][r] += cv[s] * bv[r];
        }
#pragma unroll
        for (int s = 0; s < kR; ++s)
#pragma unroll
          for (int r = 0; r < kR; ++r)
            W[(a0 + s) * ldw + i0 + r] += acc[s][r];
      }
    }
    const T jp = block_sum(jp_part, red);  // its barriers also publish W
    // J += jp[p] B[p]
    for (size_t e = tid; e < n2; e += kThreads) {
      const int i = static_cast<int>(e / nao);
      const int j = static_cast<int>(e - static_cast<size_t>(i) * nao);
      Jb[e] += jp * (whole ? Bs[i * ldb + j] : Bp[e]);
    }
    // K += W_p^T W_p on the tiles (I, J >= I) of the upper triangle;
    // df_jk_reduce mirrors the rest
    for (int e = tid; e < n_tri; e += kThreads) {
      int I = static_cast<int>(
          (2.0 * n_it + 1.0 -
           sqrt((2.0 * n_it + 1.0) * (2.0 * n_it + 1.0) - 8.0 * e)) / 2.0);
      while (I > 0 && tri_row_start(I, n_it) > e) --I;
      while (tri_row_start(I + 1, n_it) <= e) ++I;
      const int i0 = I * kR;
      const int j0 = (I + e - tri_row_start(I, n_it)) * kR;
      T acc[kR][kR] = {};
      for (int a = 0; a < ldc; ++a) {
        T wi[kR], wj[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          wi[r] = W[a * ldw + i0 + r];
          wj[r] = W[a * ldw + j0 + r];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kR; ++c) acc[r][c] += wi[r] * wj[c];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int i = i0 + r, j = j0 + c;
          if (i < nao && j < nao)
            Kb[static_cast<size_t>(i) * nao + j] += acc[r][c];
        }
    }
  }
}

template <typename T>
__global__ void df_jk_reduce(const T* __restrict__ Jw,
                             const T* __restrict__ Kw, int nblk, int nao,
                             T* __restrict__ J, T* __restrict__ K) {
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n2; e += stride) {
    const int i = static_cast<int>(e / nao);
    const int j = static_cast<int>(e - static_cast<size_t>(i) * nao);
    // K partials hold the upper tile triangle only: read (j, i) below it
    const size_t ek = (i / kR <= j / kR) ? e : static_cast<size_t>(j) * nao + i;
    T sj = T(0), sk = T(0);
    for (int b = 0; b < nblk; ++b) {  // fixed order: deterministic
      sj += Jw[static_cast<size_t>(b) * n2 + e];
      sk += Kw[static_cast<size_t>(b) * n2 + ek];
    }
    J[e] = sj;
    K[e] = sk;
  }
}

// Shared-memory plan: stage the whole B[p] if possible (one read of B),
// keep W_p on chip if possible, else fall back to column tiles / the slab.
size_t smem_bytes(size_t es, int nao, int nocc, int kt, int w_in_smem) {
  const size_t ldw = round_up(nao, kR), ldc = round_up(nocc, kR);
  return es * (kThreads + ldw * (kt + 1) + static_cast<size_t>(kt) * ldc +
               (w_in_smem ? ldc * ldw : 0));
}

template <typename T>
int launch(const void* B, const void* D, const void* C, int naux, int nao,
           int nocc, int nblk, int rows_per_blk, void* Jw, void* Kw,
           void* Wslab, void* J, void* K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t es = sizeof(T);
  const size_t cap = static_cast<size_t>(max_smem);
  const int plans[][2] = {{nao, 1}, {nao, 0}, {32, 1}, {16, 1},
                          {8, 1},   {16, 0}, {8, 0},  {1, 0}};
  int kt = -1, w_in_smem = 0;
  for (const auto& pl : plans) {
    const int k = pl[0] < nao ? pl[0] : nao;
    if (smem_bytes(es, nao, nocc, k, pl[1]) <= cap) {
      kt = k;
      w_in_smem = pl[1];
      break;
    }
  }
  if (kt < 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(es, nao, nocc, kt, w_in_smem);
  err = cudaFuncSetAttribute(df_jk_partial<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  df_jk_partial<T><<<nblk, kThreads, smem, s>>>(
      static_cast<const T*>(B), static_cast<const T*>(D),
      static_cast<const T*>(C), naux, nao, nocc, rows_per_blk, kt, w_in_smem,
      static_cast<T*>(Jw), static_cast<T*>(Kw), static_cast<T*>(Wslab));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const int threads = 256;
  size_t blocks = (n2 + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  df_jk_reduce<T><<<static_cast<int>(blocks), threads, 0, s>>>(
      static_cast<const T*>(Jw), static_cast<const T*>(Kw), nblk, nao,
      static_cast<T*>(J), static_cast<T*>(K));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int df_jk_fused_f64(const void* B, const void* D, const void* C, int naux,
                    int nao, int nocc, int nblk, int rows_per_blk, void* Jw,
                    void* Kw, void* Wslab, void* J, void* K, void* stream) {
  return launch<double>(B, D, C, naux, nao, nocc, nblk, rows_per_blk, Jw, Kw,
                        Wslab, J, K, stream);
}

int df_jk_fused_f32(const void* B, const void* D, const void* C, int naux,
                    int nao, int nocc, int nblk, int rows_per_blk, void* Jw,
                    void* Kw, void* Wslab, void* J, void* K, void* stream) {
  return launch<float>(B, D, C, naux, nao, nocc, nblk, rows_per_blk, Jw, Kw,
                       Wslab, J, K, stream);
}

const char* df_jk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
