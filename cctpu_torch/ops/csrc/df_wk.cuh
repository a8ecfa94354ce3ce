// Device code shared by the DF exchange kernels (sm_90a, FP64 and FP32):
// the streaming W_p = (B[p] C)^T / K = sum_p W_p^T W_p pass, optionally
// fused with the Coulomb pass jp[p] = sum_ij B[p,i,j] D[i,j],
// J = sum_p jp[p] B[p] (WITH_J). df_jk_fused.cu instantiates it with J
// (the closed-shell fused J+K), df_k.cu without (exchange only, one call
// per spin). The design notes are at the head of those two files.
//
// Layout (all in units of T): ldw = round_up(nao, kR) and
// ldc = round_up(nocc, kR) pad W, B rows and C columns with zeros so that
// every micro-tile is full; the padding never reaches J or K.

#pragma once

#include "df_common.cuh"

namespace dfk {

using dfc::kThreads;
constexpr int kR = 4;  // register micro-tile edge (W and K updates)

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// First index of row I in the row-major upper triangle (J >= I) of an
// nt x nt tile grid.
__device__ inline int tri_row_start(int I, int nt) {
  return I * nt - I * (I - 1) / 2;
}

template <typename T, bool WITH_J>
__global__ void __launch_bounds__(kThreads)
wk_partial(const T* __restrict__ B, const T* __restrict__ D,
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
  T* Jb = WITH_J ? Jw + static_cast<size_t>(blk) * n2 : nullptr;
  T* Kb = Kw + static_cast<size_t>(blk) * n2;
  const bool whole = kt >= nao;  // B[p] fully staged: read once
  const int n_at = ldc / kR, n_it = ldw / kR;
  const int n_tri = n_it * (n_it + 1) / 2;

  for (size_t e = tid; e < n2; e += kThreads) {
    if (WITH_J) Jb[e] = T(0);
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
        if (WITH_J) jp_part += b * D[g];
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
    if (WITH_J) {
      T jp[1] = {jp_part};
      dfc::block_sum<T, 1>(jp, red);  // its barriers also publish W
      // J += jp[p] B[p]
      for (size_t e = tid; e < n2; e += kThreads) {
        const int i = static_cast<int>(e / nao);
        const int j = static_cast<int>(e - static_cast<size_t>(i) * nao);
        Jb[e] += jp[0] * (whole ? Bs[i * ldb + j] : Bp[e]);
      }
    } else {
      __syncthreads();  // publish W
    }
    // K += W_p^T W_p on the tiles (I, J >= I) of the upper triangle;
    // the final sum mirrors the rest
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

// Shared-memory plan: stage the whole B[p] if possible (one read of B),
// keep W_p on chip if possible, else fall back to column tiles / the slab.
inline size_t smem_bytes(size_t es, int nao, int nocc, int kt,
                         int w_in_smem) {
  const size_t ldw = round_up(nao, kR), ldc = round_up(nocc, kR);
  return es * (kThreads + ldw * (kt + 1) + static_cast<size_t>(kt) * ldc +
               (w_in_smem ? ldc * ldw : 0));
}

// Launch the partial pass and the fixed-order sums of the partials on
// ``stream``.
// Without J, D, Jw and J are unused (pass null). Returns cudaGetLastError()
// (or the first failing runtime call's code).
template <typename T, bool WITH_J>
int launch_wk(const void* B, const void* D, const void* C, int naux,
              int nao, int nocc, int nblk, int rows_per_blk, void* Jw,
              void* Kw, void* Wslab, void* J, void* K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t cap = 0;
  cudaError_t err = dfc::smem_optin(&cap);
  if (err != cudaSuccess) return err;
  const size_t es = sizeof(T);
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
  err = cudaFuncSetAttribute(wk_partial<T, WITH_J>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wk_partial<T, WITH_J><<<nblk, kThreads, smem, s>>>(
      static_cast<const T*>(B), static_cast<const T*>(D),
      static_cast<const T*>(C), naux, nao, nocc, rows_per_blk, kt, w_in_smem,
      static_cast<T*>(Jw), static_cast<T*>(Kw), static_cast<T*>(Wslab));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  if (WITH_J) {
    err = dfc::launch_partial_sum<T>(static_cast<const T*>(Jw), nblk, n2, nao,
                                     0, static_cast<T*>(J), s);
    if (err != cudaSuccess) return err;
  }
  // K partials hold the upper kR-tile triangle only
  return dfc::launch_partial_sum<T>(static_cast<const T*>(Kw), nblk, n2, nao,
                                    kR, static_cast<T*>(K), s);
}

}  // namespace dfk
