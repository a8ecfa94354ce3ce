"""Density-fitted exchange K: the hand-written Hopper kernel and its twin.

Replaces the TPU kernel ``cctpu/ops/df_jk_pallas.py::_k_kernel`` (entry
``df_k_fast``) together with the W = einsum('pik,ka->pai') that
``df_k_fast`` builds in XLA and writes to device memory before the kernel
accumulates K = sum_rows W^T W. The CUDA C++ kernel is ``csrc/df_k.cu``
(sm_90a, FP64 and FP32), built on the device code it shares with the fused
J+K (``csrc/df_wk.cuh``).

What bounds it on the card: the call reads B once, naux*nao^2*8 bytes in
FP64 (162 MB at phenoxyl/6-31G*, 4.1 GB at C16H34/6-31G*), and does
3*naux*nao^2*nocc flops (2 for W, 1 for the symmetric K): bound by
device-memory bandwidth at phenoxyl (nocc 25, ~0.05 ms at 3.35 TB/s) and by
the FP64 rate at C16H34 (nocc 65, ~1.5 ms at the 67 TFLOP/s FP64
tensor-core peak). What the design does
about it (``csrc/df_wk.cuh``): one streaming pass over B by asynchronous
copies into a ring of tiles; W_p^T = B[p] C accumulated on FP64 tensor-core
tiles (``mma.sync.m16n8k4``) in registers over the whole k range, written
to shared memory once per aux row, never as [naux, nocc, nao] to device
memory; K on tensor-core tiles of the upper triangle, kept in registers
for a block's whole aux range where it fits (phenoxyl), else in a
per-block partial in device memory; partials summed in block order by a
second kernel (no float atomics: repeat calls are bitwise equal).
``ops/plan.py::wk_plan`` chooses the plan; f32 calls, and f64 shapes whose
W_p does not fit in shared memory, run the FMA kernel of the same file.

UHF/UKS call it once per spin, each with its own nocc; a Cocc of zero
columns (the beta spin of a one-electron system) gives K = 0.

Dispatch: CPU tensors take ``df_k_reference`` (plain torch); CUDA tensors
launch the kernel or raise. Built by ``ops/build.py`` at first use.
"""

from __future__ import annotations

import torch

from cctpu_torch.ops import build as _build
from cctpu_torch.ops import plan as _plan

# kernel launches on the card since import (one per df_k_fast call that
# reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
# the plan (ops/plan.py::wk_plan) of the last launch
LAST_PLAN = None
_LIB = None


def df_k_reference(B, Cocc):
    """Plain torch: cctpu's W = B C, K = sum W W^T einsums."""
    W = torch.einsum("pik,ka->pia", B, Cocc)
    return torch.einsum("pia,pja->ij", W, W)


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load("df_k")
        _build.bind(lib, ("df_k_f64", "df_k_f32"), 2,
                    5 + len(_plan.PLAN_INTS) + 1, 4)
        _LIB = lib
    return _LIB


def df_k_fast(B, Cocc):
    """Exchange matrix of the DF factor B [naux, nao, nao] for the
    occupied factor Cocc [nao, nocc] (columns carry sqrt(occupation)).
    CPU tensors: plain torch. CUDA tensors: the Hopper kernel, or raise."""
    global LAUNCHES, LAST_PLAN
    if B.device.type == "cpu" and Cocc.device.type == "cpu":
        return df_k_reference(B, Cocc)
    _build.check_inputs("df_k_fast", {"B": B, "Cocc": Cocc})
    if B.ndim != 3 or B.shape[1] != B.shape[2] or B.shape[0] < 1 \
            or Cocc.ndim != 2 or Cocc.shape[0] != B.shape[1] \
            or Cocc.shape[1] < 1:
        raise ValueError(f"df_k_fast: shapes B {tuple(B.shape)}, "
                         f"Cocc {tuple(Cocc.shape)} are not "
                         "[naux,nao,nao], [nao,nocc>=1]")
    lib = build()
    naux, nao, _ = B.shape
    nocc = Cocc.shape[1]
    nblk, rows = _build.blocks(naux, B.device)
    plan = _plan.wk_plan(nao, nocc, B.element_size(),
                         _build.smem_cap(B.device), False)
    _, Kw, Ws = _plan.workspaces(plan, nblk, naux, B)
    K = torch.empty((nao, nao), dtype=B.dtype, device=B.device)
    fn = lib.df_k_f64 if B.dtype == torch.float64 else lib.df_k_f32
    vec16 = int(nao % 2 == 0 and B.data_ptr() % 16 == 0)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(B.data_ptr(), Cocc.data_ptr(), naux, nao, nocc, nblk, rows,
                 *_plan.plan_ints(plan), vec16, Kw.data_ptr(),
                 _plan.ptr(Ws), K.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("df_k_fast launch failed: "
                           + lib.df_error_string(err).decode())
    LAUNCHES += 1
    LAST_PLAN = plan
    return K
