"""Density-fitted Coulomb J: the hand-written Hopper kernel and its twin.

Replaces the TPU kernels ``cctpu/ops/df_jk_pallas.py::_jp_kernel`` and
``::_j_kernel`` (entry ``df_j_fast``), which make two passes over B: the
row reduction Jp[p] = sum_ij B[p,ij] D[ij], then J = sum_p Jp[p] B[p]
accumulated over naux tiles. The CUDA C++ kernel is ``csrc/df_j.cu``
(sm_90a, FP64 and FP32).

What bounds it on the card: B is naux*nao^2*8 bytes per call in FP64
(162 MB at phenoxyl/6-31G*, 4.1 GB at C16H34/6-31G*) against 4 flops per
element and density, so the call is bound by device-memory bandwidth:
about 0.05 ms and 1.23 ms at 3.35 TB/s. What the design does about it:
one pass over B for both halves (Jp[p] needs only B[p]) and for both spin
densities of UHF/UKS at once, each thread with four elements' loads in
flight per step; each block owns a contiguous aux range and
adds jp[p] B[p] into its own partial J (on chip when it fits), and a
second kernel sums the partials in block order (no float atomics: repeat
calls are bitwise equal).

Dispatch: CPU tensors take ``df_j_reference`` (plain torch); CUDA tensors
launch the kernel or raise. Built by ``ops/build.py`` at first use.
"""

from __future__ import annotations

import torch

from cctpu_torch.ops import build as _build

# kernel launches on the card since import (one per df_j_fast call that
# reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
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
        _build.bind(lib, ("df_j_f64", "df_j_f32"), 2, 5, 3)
        _LIB = lib
    return _LIB


def df_j_fast(B, D):
    """Coulomb matrix of the DF factor B [naux, nao, nao] for D [nao, nao]
    or [nset, nao, nao] (nset <= 2: the spin densities share one pass over
    B); J has D's shape. CPU tensors: plain torch. CUDA tensors: the
    Hopper kernel, or raise."""
    global LAUNCHES
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
    nblk, rows = _build.blocks(naux, B.device)
    Jw = torch.empty((nblk, nset, nao, nao), dtype=B.dtype, device=B.device)
    J = torch.empty(D.shape, dtype=B.dtype, device=B.device)
    fn = lib.df_j_f64 if B.dtype == torch.float64 else lib.df_j_f32
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(B.data_ptr(), D.data_ptr(), naux, nao, nset, nblk, rows,
                 Jw.data_ptr(), J.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("df_j_fast launch failed: "
                           + lib.df_error_string(err).decode())
    LAUNCHES += 1
    return J
