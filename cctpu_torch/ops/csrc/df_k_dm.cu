// Density-fitted exchange contracted with general densities, for Hopper
// (sm_90a), FP64.
//
// No TPU kernel of cctpu computes this: it replaces the XLA einsum of
// cctpu/ints/df.py::DFJK._k_of (cocc=None), the exchange of a density that
// has no occupied factor (the TDDFT transition densities; any D, not assumed
// symmetric). For B [naux, nao, nao] and D [nset, nao, nao] it computes
//     K[s] = sum_p B[p] D[s] B[p]^T      (einsum "pik,skl,pjl->sij")
// as W = B[p] D[s], K[s] += W B[p]^T, with no symmetry of B[p] or D[s]
// assumed.
//
// Bound: B is read once (naux*nao^2*8 bytes, 171 MB at phenol 6-31G*),
// against 4*nao flops per element of B and density: compute-bound from one
// density on (phenol: 0.051 ms of bytes, 0.141 ms of FP64 at 67 TFLOP/s
// per density).
//
// Design (simple and exact):
//   * Block b owns a contiguous aux range [p0, p0 + rows) and keeps one
//     partial K per density in device memory, Kw [nblk, nset, nao, nao].
//     For each aux row p of its range (B[p] comes from device memory once
//     per call: the block's re-reads of the row for each density and panel
//     come from L2), each density s and each panel of kR rows of K:
//       1. W_I = B[p][I, :] D[s] ([kR, nao], columns in panels of kC);
//       2. K[s][I, :] += W_I B[p]^T, the accumulators loaded from the
//          block's partial before and stored after.
//     Both products run on the FP64 tensor cores (mma.sync.m16n8k4, the
//     fragment layout of df_common.cuh): the 8 warps form a 2 x 4 grid of
//     32 x 32 output tiles, 2 x 4 mma tiles a warp in registers, and each
//     16-deep step stages its tiles through shared memory, the next step's
//     tiles loaded into registers during the current step's products.
//     W_I lives in shared memory, never in device memory. Every staged
//     array has rows of 4 mod 16 doubles, so that the 16 lanes of a
//     fragment load (rows g, columns t, or the transpose) fall into
//     different bank pairs; B[p]'s tiles for the second product stay in
//     B's own row order (element (k, j) of B[p]^T is row j, column k),
//     which the mma's column-major operand reads as it is.
//   * partial_sum (df_common.cuh) adds the partials in block order. No
//     float atomics: repeat calls are bitwise equal, and a density's K does
//     not depend on the other densities of the call (the wrapper may split
//     a batch).
//
// C interface (bound with ctypes): pointers and the stream are void*; Kw is
// the per-block workspace [nblk, nset, nao, nao]. The return value is
// cudaGetLastError() after the launches, or cudaErrorInvalidValue where the
// shared memory of this nao is over the card's cap.

#include "df_common.cuh"

namespace {

constexpr int kT = 256;           // threads: 8 warps, a 2 x 4 grid
constexpr int kR = 64;            // rows of a panel of W and K
constexpr int kC = 128;           // columns of a column panel
constexpr int kKT = 16;           // depth of a staged tile
constexpr int kMT = 2;            // 16-row mma tiles a warp
constexpr int kNT = 4;            // 8-column mma tiles a warp
constexpr int kLdA = kKT + 4;     // row stride of a [rows, kKT] tile
constexpr int kLdB = kC + 4;      // row stride of a [kKT, kC] tile
constexpr int kBt = kC * kLdA > kKT * kLdB ? kC * kLdA : kKT * kLdB;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Stride of W_I's rows in shared memory: its columns up to the last k-tile
// (zeros past nao), plus 4 (4 mod 16, see above).
__host__ __device__ inline int w_stride(int nao) {
  return round_up(nao, kKT) + 4;
}

size_t smem_bytes(int nao) {
  return sizeof(double) *
         (static_cast<size_t>(kR) * w_stride(nao) + kR * kLdA + kBt);
}

// acc += A[i0 + rows, 0:nao] op(Bsrc)[0:nao, j0 + cols] over k-tiles of kKT
// on the warp's 32 x 32 tile. A comes from shared memory (Ws, stride lda)
// when A_SMEM, else from the rows of Ag [nao, nao] in device memory, staged
// into At. op(Bsrc) is Bsrc [nao, nao] itself (TRANS_B false: row k, column
// j; staged as [kKT, kC]) or its transpose (TRANS_B: element (k, j) is
// Bsrc[j, k]; staged as Bsrc's rows, [kC, kKT]). Elements past nao are
// staged as zeros. Each thread loads its elements of the next k-tile into
// registers before the products of the current one, so that their latency
// hides behind the products.
constexpr int kQA = kR * kKT / kT;   // a thread's elements of a tile of A
constexpr int kQB = kKT * kC / kT;   // of a tile of op(B)

template <bool A_SMEM, bool TRANS_B>
__device__ __forceinline__ void panel_product(
    double (&acc)[kMT][kNT][4], const double* __restrict__ Ag,
    const double* Ws, int lda, const double* __restrict__ Bsrc, int nao,
    int i0, int j0, double* At, double* Bt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  double ra[A_SMEM ? 1 : kQA], rb[kQB];
  // this thread's element e = tid + q kT of a tile: A's (row e / kKT,
  // column e % kKT); op(B)'s (row e / kC, column e % kC), or with TRANS_B
  // Bsrc's (row e / kKT, column e % kKT)
  auto load = [&](int k0) {
    if (!A_SMEM) {
#pragma unroll
      for (int q = 0; q < kQA; ++q) {
        const int e = tid + q * kT, i = e / kKT, kk = e % kKT;
        ra[q] = i0 + i < nao && k0 + kk < nao
                    ? Ag[static_cast<size_t>(i0 + i) * nao + k0 + kk]
                    : 0.0;
      }
    }
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      const int e = tid + q * kT;
      if (TRANS_B) {
        const int j = e / kKT, kk = e % kKT;
        rb[q] = k0 + kk < nao && j0 + j < nao
                    ? Bsrc[static_cast<size_t>(j0 + j) * nao + k0 + kk]
                    : 0.0;
      } else {
        const int kk = e / kC, j = e % kC;
        rb[q] = k0 + kk < nao && j0 + j < nao
                    ? Bsrc[static_cast<size_t>(k0 + kk) * nao + j0 + j]
                    : 0.0;
      }
    }
  };
  load(0);
  for (int k0 = 0; k0 < nao; k0 += kKT) {
    __syncthreads();  // the previous tiles have been read
    if (!A_SMEM) {
#pragma unroll
      for (int q = 0; q < kQA; ++q) {
        const int e = tid + q * kT;
        At[(e / kKT) * kLdA + e % kKT] = ra[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      const int e = tid + q * kT;
      if (TRANS_B)
        Bt[(e / kKT) * kLdA + e % kKT] = rb[q];
      else
        Bt[(e / kC) * kLdB + e % kC] = rb[q];
    }
    __syncthreads();  // the tiles have landed
    if (k0 + kKT < nao) load(k0 + kKT);
#pragma unroll
    for (int k4 = 0; k4 < kKT; k4 += 4) {
      double a0[kMT], a1[kMT], b[kNT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int r = m0 + 16 * m + g;
        if (A_SMEM) {
          a0[m] = Ws[r * lda + k0 + k4 + t];
          a1[m] = Ws[(r + 8) * lda + k0 + k4 + t];
        } else {
          a0[m] = At[r * kLdA + k4 + t];
          a1[m] = At[(r + 8) * kLdA + k4 + t];
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        b[n] = TRANS_B ? Bt[(n0 + 8 * n + g) * kLdA + k4 + t]
                       : Bt[(k4 + t) * kLdB + n0 + 8 * n + g];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          dfc::mma1684(acc[m][n], a0[m], a1[m], b[n]);
    }
  }
}

__global__ void __launch_bounds__(kT)
kdm_partial(const double* __restrict__ B, const double* __restrict__ D,
            int naux, int nao, int nset, int rows_per_blk,
            double* __restrict__ Kw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldw = w_stride(nao);
  double* Ws = reinterpret_cast<double*>(smem_raw);  // W_I [kR, ldw]
  double* At = Ws + static_cast<size_t>(kR) * ldw;     // [kR, kLdA]
  double* Bt = At + kR * kLdA;                         // kBt
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  const int blk = blockIdx.x;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const int p0 = blk * rows_per_blk;
  const int nrows = min(naux, p0 + rows_per_blk) - p0;
  const int kpad = round_up(nao, kKT);  // W_I's columns that are read

  for (int r = 0; r < nrows; ++r) {
    const double* Bp = B + static_cast<size_t>(p0 + r) * n2;
    for (int s = 0; s < nset; ++s) {
      const double* Ds = D + static_cast<size_t>(s) * n2;
      double* Ks = Kw + (static_cast<size_t>(blk) * nset + s) * n2;
      for (int i0 = 0; i0 < nao; i0 += kR) {
        // 1. W_I = B[p][i0:i0+kR, :] D[s], column panel by column panel
        for (int j0 = 0; j0 < kpad; j0 += kC) {
          double acc[kMT][kNT][4] = {};
          panel_product<false, false>(acc, Bp, nullptr, 0, Ds, nao, i0, j0,
                                      At, Bt);
          // (rows past nao hold zeros; columns past nao too, up to kpad)
#pragma unroll
          for (int m = 0; m < kMT; ++m)
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int i = m0 + 16 * m + g + 8 * (q >> 1);
                const int j = j0 + n0 + 8 * n + 2 * t + (q & 1);
                if (j < kpad) Ws[i * ldw + j] = acc[m][n][q];
              }
        }
        // (the first barrier of the next panel_product orders these
        // writes before W_I is read)
        // 2. K[s][i0:i0+kR, :] += W_I B[p]^T
        for (int j0 = 0; j0 < nao; j0 += kC) {
          double acc[kMT][kNT][4];
#pragma unroll
          for (int m = 0; m < kMT; ++m)
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int i = i0 + m0 + 16 * m + g + 8 * (q >> 1);
                const int j = j0 + n0 + 8 * n + 2 * t + (q & 1);
                acc[m][n][q] = r > 0 && i < nao && j < nao
                                   ? Ks[static_cast<size_t>(i) * nao + j]
                                   : 0.0;
              }
          panel_product<true, true>(acc, nullptr, Ws, ldw, Bp, nao, i0, j0,
                                    At, Bt);
#pragma unroll
          for (int m = 0; m < kMT; ++m)
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int i = i0 + m0 + 16 * m + g + 8 * (q >> 1);
                const int j = j0 + n0 + 8 * n + 2 * t + (q & 1);
                if (i < nao && j < nao)
                  Ks[static_cast<size_t>(i) * nao + j] = acc[m][n][q];
              }
        }
        // (the next W_I is written only after the first barrier of its
        // panel_product, which every reader of this one has passed)
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes at this nao.
long long df_k_dm_smem_bytes(int nao) {
  return static_cast<long long>(smem_bytes(nao));
}

int df_k_dm_f64(const void* B, const void* D, int naux, int nao, int nset,
                int nblk, int rows_per_blk, void* Kw, void* K, void* stream) {
  if (naux < 1 || nao < 1 || nset < 1 || nblk < 1 || rows_per_blk < 1 ||
      static_cast<long long>(nblk) * rows_per_blk < naux)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t cap = 0;
  cudaError_t err = dfc::smem_optin(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(nao);
  if (smem > cap) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kdm_partial,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kdm_partial<<<nblk, kT, smem, st>>>(
      static_cast<const double*>(B), static_cast<const double*>(D), naux,
      nao, nset, rows_per_blk, static_cast<double*>(Kw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(nset) * nao * nao;
  err = dfc::launch_partial_sum<double>(static_cast<const double*>(Kw), nblk,
                                        total, nao, 0,
                                        static_cast<double*>(K), st);
  return static_cast<int>(err);
}

}  // extern "C"
