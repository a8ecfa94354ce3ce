"""Pulay DIIS (CDIIS) with fixed-size ring buffers.

Port of ``cctpu/scf/diis.py``: the history lives in [space, size] buffers;
empty slots are masked out of the B-matrix solve, which is a symmetric
pseudo-inverse through ``eigh`` — the same numerics as the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class DIISState(NamedTuple):
    focks: torch.Tensor   # [m, size] flattened Fock history
    errs: torch.Tensor    # [m, size] flattened error-vector history
    count: int            # how many slots are filled (saturates at m)
    head: int             # next write position


def diis_init(space: int, size: int, dtype=torch.float64,
              device=None) -> DIISState:
    return DIISState(
        focks=torch.zeros((space, size), dtype=dtype, device=device),
        errs=torch.zeros((space, size), dtype=dtype, device=device),
        count=0, head=0)


def diis_update(state: DIISState, fock: torch.Tensor,
                err: torch.Tensor) -> Tuple[DIISState, torch.Tensor]:
    """Push (fock, err), return (new_state, extrapolated fock)."""
    m = state.focks.shape[0]
    focks = state.focks.clone()
    errs = state.errs.clone()
    focks[state.head] = fock.reshape(-1)
    errs[state.head] = err.reshape(-1)
    count = min(state.count + 1, m)
    head = (state.head + 1) % m

    dt, dev = errs.dtype, errs.device
    Bm = errs @ errs.T                                    # [m, m]
    active = torch.arange(m, device=dev) < count
    # Masked augmented system:
    #   [B  -1][c]   [0]
    #   [-1  0][l] = [-1]
    big = torch.zeros((m + 1, m + 1), dtype=dt, device=dev)
    mask2 = active[:, None] & active[None, :]
    big[:m, :m] = torch.where(mask2, Bm, torch.zeros_like(Bm))
    # identity rows for inactive slots keep the system nonsingular
    big[:m, :m] += torch.diag((~active).to(dt))
    big[:m, m] = -active.to(dt)
    big[m, :m] = -active.to(dt)
    rhs = torch.zeros(m + 1, dtype=dt, device=dev)
    rhs[m] = -1.0

    w, V = torch.linalg.eigh(big)
    tol = 1e-7 if dt == torch.float32 else 1e-14
    wmax = torch.max(torch.abs(w))
    keep = torch.abs(w) > tol * torch.clamp(wmax, min=1.0)
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    sol = V @ (winv * (V.T @ rhs))
    c = torch.where(active, sol[:m], torch.zeros_like(sol[:m]))
    f_new = c @ focks
    return DIISState(focks, errs, count, head), f_new.reshape(fock.shape)
