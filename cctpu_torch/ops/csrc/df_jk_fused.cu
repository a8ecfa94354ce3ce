// Fused density-fitted J/K build for Hopper (sm_90a), FP64 and FP32.
//
// Replaces the TPU Pallas kernel cctpu/ops/df_jk_pallas.py::_fused_jk_kernel
// (entry df_jk_fused). For B [naux, nao, nao], D [nao, nao] and
// C = Cocc [nao, nocc] (columns carry sqrt(occupation)) it computes
//     jp[p] = sum_ij B[p,i,j] D[i,j]        J = sum_p jp[p] B[p]
//     W_p   = (B[p] C)^T  ([nocc, nao])    K = sum_p W_p^T W_p
// streaming B through shared memory, without ever writing the full
// W [naux, nocc, nao] to device memory. The device code is
// df_wk.cuh's wk_partial with WITH_J = true, then df_common.cuh's
// partial_sum.
//
// Design (simple first: FMA loops, no wgmma/TMA/pipelining yet):
//   * wk_partial: block b owns a contiguous range of aux rows and walks
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
//   * partial_sum: sums the nblk partials of J, then of K, in block-index
//     order, and mirrors K's lower tile triangle from the upper one.
//   No float atomics anywhere: two calls on the same inputs give
//   bitwise-equal J and K.
//
// Bound: B is naux*nao^2*8 bytes per call in FP64 (171 MB at phenol
// 6-31G*, 4.1 GB at C16H34), which makes the call bound by device-memory
// bandwidth at small nocc; the W and K products add 3*nocc flops per B
// element (2 for W, 1 for the symmetric K), so from nocc ~ 25 on the FP64
// rate is the other bound.
// The design streams B once per call from device memory (the J sweep's
// second look at a row comes from shared memory or L2) and keeps W on
// chip or in one small slab per block, so bytes stay near the B floor;
// the flops move to the tensor cores (DMMA/wgmma) in a later version.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include "df_wk.cuh"

extern "C" {

int df_jk_fused_f64(const void* B, const void* D, const void* C, int naux,
                    int nao, int nocc, int nblk, int rows_per_blk, void* Jw,
                    void* Kw, void* Wslab, void* J, void* K, void* stream) {
  return dfk::launch_wk<double, true>(B, D, C, naux, nao, nocc, nblk,
                                      rows_per_blk, Jw, Kw, Wslab, J, K,
                                      stream);
}

int df_jk_fused_f32(const void* B, const void* D, const void* C, int naux,
                    int nao, int nocc, int nblk, int rows_per_blk, void* Jw,
                    void* Kw, void* Wslab, void* J, void* K, void* stream) {
  return dfk::launch_wk<float, true>(B, D, C, naux, nao, nocc, nblk,
                                     rows_per_blk, Jw, Kw, Wslab, J, K,
                                     stream);
}

}  // extern "C"
