"""Numerical integration: AO values and first derivatives on grid points.

Port of ``cctpu/dft/numint.py::eval_ao``. Per angular-momentum group all
shells are evaluated at all points at once, with the point axis last in
every intermediate; the [npts, nao] planes come from one transpose.
"""

from __future__ import annotations

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, cart_components, nsph
from cctpu_torch.ints.one_electron import c2s


def eval_ao(basis: BasisSet, coords: torch.Tensor, pts: torch.Tensor,
            deriv: int = 0) -> torch.Tensor:
    """AO values [npts, nao] (deriv=0) or [4, npts, nao] with
    (value, d/dx, d/dy, d/dz) (deriv=1), on ``pts``' device."""
    dev, dt = pts.device, pts.dtype
    npts = pts.shape[0]
    nout = 1 if deriv == 0 else 4
    planes = torch.zeros((nout, basis.nao, npts), dtype=dt, device=dev)
    ptsT = pts.T                                          # [3, npts]
    for l, g in basis.groups.items():
        centers = coords[torch.as_tensor(g.atom_idx, device=dev)]
        d = ptsT[None, :, :] - centers[:, :, None]        # [ns, 3, npts]
        r2 = torch.sum(d * d, dim=1)                      # [ns, npts]
        exps = torch.as_tensor(g.exps, dtype=dt, device=dev)
        coefs = torch.as_tensor(g.coefs, dtype=dt, device=dev)
        ex = torch.exp(-exps[:, :, None] * r2[:, None, :])   # [ns, np, npts]
        R0 = torch.einsum("sp,spn->sn", coefs, ex)
        comps = cart_components(l)
        x, y, z = d[:, 0, :], d[:, 1, :], d[:, 2, :]
        M = torch.stack([x ** ax * y ** ay * z ** az
                         for (ax, ay, az) in comps])     # [ncart, ns, npts]
        T = c2s(l, pts)                                   # [nsph, ncart]
        val = torch.einsum("mc,csn,sn->msn", T, M, R0)    # [nsph, ns, npts]
        rows = torch.as_tensor(
            (g.ao_start[:, None] + np.arange(nsph(l))).T.ravel(), device=dev)
        planes[0, rows] = val.reshape(-1, npts)
        if deriv >= 1:
            R1 = torch.einsum("sp,sp,spn->sn", coefs, exps, ex)
            for dd in range(3):
                dmons = []
                for pw3 in comps:
                    pw = pw3[dd]
                    if pw == 0:
                        dmons.append(torch.zeros_like(x))
                    else:
                        pws = list(pw3)
                        pws[dd] -= 1
                        dmons.append(pw * x ** pws[0] * y ** pws[1]
                                     * z ** pws[2])
                dM = torch.stack(dmons)
                dval = torch.einsum("mc,csn,sn->msn", T, dM, R0) \
                    - 2.0 * torch.einsum("mc,csn,sn,sn->msn", T, M, R1,
                                         d[:, dd, :])
                planes[1 + dd, rows] = dval.reshape(-1, npts)
    out = planes.transpose(1, 2)
    return out[0] if deriv == 0 else out


def eval_tau(ao: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """Kinetic-energy density tau = 1/2 sum_d ao_d D ao_d [npts] of a
    density matrix ``dm`` from AO values and gradients ao [4, npts, nao]
    (cctpu's ``eval_rho`` for MGGA): the meta-GGAs' tau of one spin with
    that spin's density."""
    return 0.5 * sum(torch.sum((ao[1 + d] @ dm) * ao[1 + d], -1)
                     for d in range(3))
