"""Density-fitted exchange of general densities: the hand-written Hopper
kernel and its twin.

K[s] = sum_p B[p] D[s] B[p]^T for B [naux, nao, nao] and D [nao, nao] or
[nset, nao, nao], no symmetry of B[p] or D[s] assumed: the exchange of a
density that has no occupied factor (the TDDFT transition densities). No
TPU kernel of cctpu computes it: it replaces the XLA einsum of
``cctpu/ints/df.py::DFJK._k_of`` with ``cocc=None``. The CUDA C++ kernel is
``csrc/df_k_dm.cu`` (sm_90a, FP64 on the tensor cores). It takes float64
only: the FP64 tensor-core product (``mma.sync...f64``) has no FP32 form,
and the port's response code runs in float64.

What bounds it on the card: one read of B (171 MB at phenol/6-31G* in
FP64) against 4*nao flops per element of B and density: compute-bound
from one density on (phenol: 0.051 ms of bytes, 0.141 ms of FP64 at 67
TFLOP/s per density; ``utils/measure.py::work``). What the design does
about it (``csrc/df_k_dm.cu``): each block owns a contiguous aux range and
walks it once for every density of the call; W = B[p] D[s] is formed panel
by panel on the FP64 tensor cores and kept in shared memory, never written
to device memory as [naux, nao, nao]; the per-block partial K of each
density lives in device memory and a second kernel sums the partials in
block order (no float atomics: repeat calls are bitwise equal). A large
batch of densities is split into calls whose workspace fits
``WS_BUDGET_BYTES``; a density's K is bitwise the same whatever batch it
rides in.

Dispatch: CPU tensors take ``df_k_dm_reference`` (plain torch); CUDA
tensors launch the kernel or raise. Built by ``ops/build.py`` at first use.
"""

from __future__ import annotations

import ctypes

import torch

from cctpu_torch.ops import build as _build

# kernel launches on the card since import (one per batch of densities
# that reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
# bytes of the per-block partials [nblk, nset, nao, nao] one launch may take
WS_BUDGET_BYTES = 2 << 30
_LIB = None


def df_k_dm_reference(B, D):
    """Plain torch: cctpu's einsum "pik,...kl,pjl->...ij"."""
    return torch.einsum("pik,...kl,pjl->...ij", B, D, B)


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load("df_k_dm")
        _build.bind(lib, ("df_k_dm_f64",), 2, 5, 3)
        lib.df_k_dm_smem_bytes.argtypes = [ctypes.c_int]
        lib.df_k_dm_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def batch_size(nblk: int, nao: int, nset: int) -> int:
    """Densities one launch takes: as many as the per-block partials of
    ``WS_BUDGET_BYTES`` hold, at least one."""
    return max(1, min(nset, WS_BUDGET_BYTES // (nblk * nao * nao * 8)))


def df_k_dm(B, D):
    """Exchange matrices K[s] = sum_p B[p] D[s] B[p]^T of the DF factor B
    [naux, nao, nao] for D [nao, nao] or [nset, nao, nao]; K has D's shape.
    CPU tensors: plain torch. CUDA tensors: the Hopper kernel, or raise."""
    global LAUNCHES
    if B.device.type == "cpu" and D.device.type == "cpu":
        return df_k_dm_reference(B, D)
    D3 = (D[None] if D.ndim == 2 else D).contiguous()
    _build.check_inputs("df_k_dm", {"B": B, "D": D3})
    if B.dtype != torch.float64:
        raise ValueError("df_k_dm takes float64 only: its products run on "
                         "the FP64 tensor cores, which have no FP32 form")
    if B.ndim != 3 or B.shape[1] != B.shape[2] or B.shape[0] < 1 \
            or D.ndim not in (2, 3) or D.shape[-2:] != B.shape[1:] \
            or D3.shape[0] < 1:
        raise ValueError(f"df_k_dm: shapes B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)} are not [naux,nao,nao], "
                         "[nao,nao] or [nset>=1,nao,nao]")
    lib = build()
    naux, nao, _ = B.shape
    nset = D3.shape[0]
    smem = lib.df_k_dm_smem_bytes(nao)
    cap = _build.smem_cap(B.device)
    if smem > cap:
        raise ValueError(f"df_k_dm: nao {nao} needs {smem} bytes of shared "
                         f"memory a block, over the card's {cap}")
    nblk, rows = _build.blocks(naux, B.device)
    per = batch_size(nblk, nao, nset)
    K = torch.empty_like(D3)
    Kw = torch.empty((nblk, per, nao, nao), dtype=B.dtype, device=B.device)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        for s0 in range(0, nset, per):
            nb = min(per, nset - s0)
            err = lib.df_k_dm_f64(B.data_ptr(), D3[s0].data_ptr(), naux,
                                  nao, nb, nblk, rows, Kw.data_ptr(),
                                  K[s0].data_ptr(), stream)
            if err != 0:
                raise RuntimeError("df_k_dm launch failed: "
                                   + lib.df_error_string(err).decode())
            LAUNCHES += 1
    return K if D.ndim == 3 else K[0]
