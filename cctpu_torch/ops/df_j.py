"""Density-fitted Coulomb J: the hand-written Hopper kernels and their twin.

Replaces the TPU kernels ``cctpu/ops/df_jk_pallas.py::_jp_kernel`` and
``::_j_kernel`` (entry ``df_j_fast``), which make two passes over B: the
row reduction Jp[p] = sum_ij B[p,ij] D[ij], then J = sum_p Jp[p] B[p]
accumulated over naux tiles. The CUDA C++ kernels are in ``csrc/df_j.cu``
(sm_90a, FP64 and FP32).

What bounds it on the card: one read of B, naux*nao^2*8 bytes in FP64 (162
MB at phenoxyl/6-31G*, 4.1 GB at C16H34/6-31G*), against 4 flops per
element and density, so the call is bound by device-memory bandwidth:
about 0.05 ms and 1.23 ms at 3.35 TB/s. ``ops/plan.py::j_plan`` chooses
one of two plans, kept in ``LAST_PLAN``:

``one_pass`` where the partial J of all densities fits in shared memory
    (phenoxyl, phenol; every SCF of ``chip_smoke.py``): B is read once for
    both halves and both spin densities of UHF/UKS; each block owns a
    contiguous aux range and adds jp[p] B[p] into its partial J in shared
    memory, and a second kernel sums the block partials in block order.
``two_pass`` elsewhere (C16H34): a jp pass (each thread's elements of D
    held in registers, one block sum per four aux rows, one partial per
    column chunk and row, summed in chunk order), then a J sweep in which
    each thread owns fixed elements of J and walks the aux rows in order,
    writing J once: no partial J in device memory. B is read twice, so
    this plan cannot beat ~2x the bound.

No float atomics: repeat calls are bitwise equal. Dispatch: CPU tensors
take ``df_j_reference`` (plain torch); CUDA tensors launch the kernels or
raise. Built by ``ops/build.py`` at first use.
"""

from __future__ import annotations

import torch

from cctpu_torch.ops import build as _build
from cctpu_torch.ops import plan as _plan

# kernel launches on the card since import (one per df_j_fast call that
# reached the kernels); chip_smoke.py resets and reads it
LAUNCHES = 0
# the plan (ops/plan.py::j_plan) of the last launch
LAST_PLAN = None
_LIB = None


def df_j_reference(B, D):
    """Plain torch: cctpu's two einsums ("pij,...ij->...p", then back)."""
    Jp = torch.einsum("pij,...ij->...p", B, D)
    return torch.einsum("...p,pij->...ij", Jp, B)


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load("df_j")
        _build.bind(lib, ("df_j_f64", "df_j_f32"), 2,
                    3 + len(_plan.J_PLAN_INTS), 3)
        _LIB = lib
    return _LIB


def workspace(plan, like):
    """The plan's workspace (``ws_elems`` elements) as a tensor like
    ``like`` (B)."""
    return torch.empty(plan["ws_elems"], dtype=like.dtype, device=like.device)


def df_j_fast(B, D):
    """Coulomb matrix of the DF factor B [naux, nao, nao] for D [nao, nao]
    or [nset, nao, nao] (nset <= 2: the spin densities share the reads of
    B); J has D's shape. CPU tensors: plain torch. CUDA tensors: the
    Hopper kernels, or raise."""
    global LAUNCHES, LAST_PLAN
    if B.device.type == "cpu" and D.device.type == "cpu":
        return df_j_reference(B, D)
    _build.check_inputs("df_j_fast", {"B": B, "D": D})
    if B.ndim != 3 or B.shape[1] != B.shape[2] or B.shape[0] < 1 \
            or D.shape[-2:] != B.shape[1:] or D.ndim not in (2, 3) \
            or (D.ndim == 3 and not 1 <= D.shape[0] <= 2):
        raise ValueError(f"df_j_fast: shapes B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)} are not [naux,nao,nao], "
                         "[nao,nao] or [nset<=2,nao,nao]")
    lib = build()
    naux, nao, _ = B.shape
    nset = 1 if D.ndim == 2 else D.shape[0]
    plan = _plan.j_plan(
        naux, nao, nset, B.element_size(), _build.smem_cap(B.device),
        torch.cuda.get_device_properties(B.device).multi_processor_count,
        aligned=B.data_ptr() % 16 == 0 and D.data_ptr() % 16 == 0)
    ws = workspace(plan, B)
    J = torch.empty(D.shape, dtype=B.dtype, device=B.device)
    fn = lib.df_j_f64 if B.dtype == torch.float64 else lib.df_j_f32
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(B.data_ptr(), D.data_ptr(), naux, nao, nset,
                 *_plan.j_plan_ints(plan), ws.data_ptr(), J.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError("df_j_fast launch failed: "
                           + lib.df_error_string(err).decode())
    LAUNCHES += 1
    LAST_PLAN = plan
    return J
