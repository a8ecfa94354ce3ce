"""NMR shielding tensors with a common gauge origin (CGO), via CPHF.

Port of ``cctpu/response/nmr.py``:

  sigma_ab(N) = sigma^dia_ab + sigma^para_ab
  sigma^dia = (1/2c^2) Tr[D * dia_ints(N)]
  sigma^para = (1/2c^2) Tr[Dresp[a] * h01[b](N)],
  Dresp[a] = -2 (Cv v_a^T Co^T - Co v_a Cv^T),  (A-B) v_a = L_ov[a]

with v the CPHF response to the external-field angular-momentum
perturbation, (A-B) the TDDFT matvec (``response/tddft.py``; only exact
exchange couples to imaginary densities). The three field directions
share each matvec; cctpu's stopping rule (scipy's cg at rtol 1e-8,
maxiter 200) per direction. Gauge: per nucleus by default. This class is
the fallback of ``giao_nmr.make_nmr`` for references outside the GIAO
surface; closed shells only, as cctpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from cctpu_torch.core.constants import LIGHT_SPEED_AU as C
from cctpu_torch.ints.magnetic import (angmom_integrals, dia_integrals,
                                       h01_integrals)
from cctpu_torch.response.giao_nmr import cg_solve

CG_RTOL = 1e-8
CG_MAXITER = 200


class NMR:
    def __init__(self, mf, gauge_origin="nucleus"):
        """gauge_origin: 'nucleus' (per-nucleus origin: the accurate CGO
        choice), 'charge-center', or an explicit [3] vector."""
        self.mf = mf
        self.gauge = gauge_origin
        self.shielding = None
        self.stats = {}

    def _origin_for(self, N):
        mol = self.mf.mol
        if isinstance(self.gauge, str):
            if self.gauge == "nucleus":
                return np.asarray(mol.coords[N])
            Z = mol.charges
            return (Z[:, None] * mol.coords).sum(0) / Z.sum()
        return np.asarray(self.gauge, dtype=float)

    def _cphf(self, Lov):
        """(A-B) v = L_ov for the three field directions [3, no, nv]."""
        td = self._td
        no, nv = td.nocc, td.nvir
        diag = torch.as_tensor(td.ediff, dtype=Lov.dtype, device=Lov.device)
        v, its = cg_solve(lambda x: td._amb_mv(x.reshape(-1, no, nv))
                          .reshape(x.shape[0], -1), Lov.reshape(3, -1),
                          diag, CG_RTOL, CG_MAXITER)
        self.stats.setdefault("cg_iterations", []).append(its)
        return v.reshape(3, no, nv)

    def kernel(self):
        from cctpu_torch.response.tddft import TDDFT
        mf = self.mf
        mol = mf.mol
        basis, coords = mol.basis_set, mf.coords
        if mf.dm.ndim == 3:
            raise NotImplementedError("common-gauge-origin NMR of an "
                                      "open-shell reference")
        D = mf.dm
        self._td = TDDFT(mf, nstates=1)
        self._td._setup()
        Co, Cv = self._td.Co, self._td.Cv

        def t(x):
            return torch.as_tensor(x, dtype=coords.dtype,
                                   device=coords.device)

        sig = np.zeros((mol.natm, 3, 3))
        cache = {}
        for N in range(mol.natm):
            G = self._origin_for(N)
            key = tuple(np.round(G, 10))
            if key not in cache:
                L = angmom_integrals(basis, coords, t(G))
                v = self._cphf(Co.T @ L @ Cv)
                # response density (real-antisymmetric representation,
                # per unit B_a): the perturbation is -l, so X = -v
                cache[key] = -2.0 * (Cv @ v.transpose(1, 2) @ Co.T
                                     - Co @ v @ Cv.T)
            Dresp = cache[key]
            dia = dia_integrals(basis, coords, coords[N], t(G))
            h01 = h01_integrals(basis, coords, coords[N])
            s = (torch.einsum("abpq,pq->ab", dia, D)
                 + torch.einsum("amn,bnm->ab", Dresp, h01))
            sig[N] = (0.5 / C ** 2 * s).cpu().numpy()
        self.shielding = sig * 1e6              # ppm
        return self.shielding

    def isotropic(self):
        if self.shielding is None:
            self.kernel()
        return np.trace(self.shielding, axis1=1, axis2=2) / 3.0

    def anisotropy(self):
        if self.shielding is None:
            self.kernel()
        out = []
        for s in self.shielding:
            w = np.sort(np.linalg.eigvals(0.5 * (s + s.T)).real)
            out.append(w[2] - 0.5 * (w[0] + w[1]))
        return np.array(out)
