// Density-fitted exchange K for Hopper (sm_90a), FP64 and FP32.
//
// Replaces the TPU Pallas kernel cctpu/ops/df_jk_pallas.py::_k_kernel
// (entry df_k_fast), together with the W = einsum('pik,ka->pai') that
// df_k_fast builds in XLA outside that kernel. For B [naux, nao, nao] and
// C = Cocc [nao, nocc] (columns carry sqrt(occupation); a column of zeros,
// as for the beta spin of a one-electron system, adds nothing) it computes
//     W_p = (B[p] C)^T  ([nocc, nao])      K = sum_p W_p^T W_p
// One launch per spin in UHF/UKS, each with its own nocc.
//
// Bound: the call reads B once, naux*nao^2*8 bytes in FP64 (162 MB at
// phenoxyl 6-31G*, 4.1 GB at C16H34), and does 3*naux*nao^2*nocc flops
// (2 for W, 1 for K, which is symmetric): bound by device-memory bandwidth
// at phenoxyl (nocc 25), by the FP64 rate at C16H34 (nocc 65).
//
// Design: the same device code as the fused J+K (df_wk.cuh's wk_partial,
// then df_common.cuh's partial_sum) with WITH_J = false. Each block owns a
// contiguous aux range, streams B[p] through shared memory in column
// tiles, builds W_p in shared
// memory (or a one-row slab per block) so that W never goes to device
// memory as [naux, nocc, nao], and adds W_p^T W_p on the upper tile
// triangle into the block's own partial K; a second kernel sums the
// partials in block order and mirrors the triangle. No float atomics:
// repeat calls are bitwise equal. FMA loops for now; DMMA/wgmma later.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include "df_wk.cuh"

extern "C" {

int df_k_f64(const void* B, const void* C, int naux, int nao, int nocc,
             int nblk, int rows_per_blk, void* Kw, void* Wslab, void* K,
             void* stream) {
  return dfk::launch_wk<double, false>(B, nullptr, C, naux, nao, nocc, nblk,
                                       rows_per_blk, nullptr, Kw, Wslab,
                                       nullptr, K, stream);
}

int df_k_f32(const void* B, const void* C, int naux, int nao, int nocc,
             int nblk, int rows_per_blk, void* Kw, void* Wslab, void* K,
             void* stream) {
  return dfk::launch_wk<float, false>(B, nullptr, C, naux, nao, nocc, nblk,
                                      rows_per_blk, nullptr, Kw, Wslab,
                                      nullptr, K, stream);
}

}  // extern "C"
