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
// at phenoxyl (nocc 25), by the FP64 tensor-core rate at C16H34 (nocc 65).
//
// Design: the same device code as the fused J+K (df_wk.cuh, whose head has
// the details) with WITH_J = false. In FP64, wk_mma: B[p] arrives in column
// tiles by tensor copies (TMA; cp.async where nao is odd), W_p^T is
// accumulated on FP64 tensor-core tiles in registers over the whole k
// range and written to shared memory once per aux row (W never goes to
// device memory), and W_p^T W_p is added on tensor-core tiles of the upper
// triangle, in registers for the block's whole aux range at phenoxyl's
// size, in a per-block partial in device memory at C16H34's; wk_sum adds
// the partials in block order and mirrors the triangle. No float atomics:
// repeat calls are bitwise equal.
// FP32, and FP64 shapes whose W_p does not fit in shared memory, run
// wk_partial (FMA loops).
//
// C interface (bound with ctypes): pointers and the stream are void*; the
// plan integers are those of ops/plan.py::PLAN_INTS, then vec16 (B, and D,
// 16-byte aligned and nao even: else no tensor copies); Wslab is the
// scratch of the plan (the FMA kernel's W_p slab, or room for the packed
// C); the return value is cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan that is inconsistent or over the
// shared-memory cap.

#include "df_wk.cuh"

extern "C" {

int df_k_f64(const void* B, const void* C, int naux, int nao, int nocc,
             int nblk, int rows_per_blk,
             int kind, int variant, int kt, int stages, int wm, int mt_panel,
             int w_in_smem, int j_in_smem, int alias, int tma, int smem_bytes,
             int vec16,
             void* Kw, void* Wslab, void* K, void* stream) {
  return dfk::launch_wk<double, false>(
      B, nullptr, C, naux, nao, nocc, nblk, rows_per_blk,
      {kind, variant, kt, stages, wm, mt_panel, w_in_smem, j_in_smem,
       alias, tma, smem_bytes},
      vec16, nullptr, Kw, Wslab, nullptr, K, stream);
}

int df_k_f32(const void* B, const void* C, int naux, int nao, int nocc,
             int nblk, int rows_per_blk,
             int kind, int variant, int kt, int stages, int wm, int mt_panel,
             int w_in_smem, int j_in_smem, int alias, int tma, int smem_bytes,
             int vec16,
             void* Kw, void* Wslab, void* K, void* stream) {
  return dfk::launch_wk<float, false>(
      B, nullptr, C, naux, nao, nocc, nblk, rows_per_blk,
      {kind, variant, kt, stages, wm, mt_panel, w_in_smem, j_in_smem,
       alias, tma, smem_bytes},
      vec16, nullptr, Kw, Wslab, nullptr, K, stream);
}

}  // extern "C"
