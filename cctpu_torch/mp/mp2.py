"""MP2 (restricted and unrestricted), in core and on a DF/Cholesky factor.

Port of ``cctpu/mp/mp2.py``. cctpu runs MP2 as einsums outside any Pallas
kernel, so the port is plain torch products, in f64 on the SCF's device:

- RMP2 on B (``mf.density_fit`` truthy: DF or the Cholesky factor):
  Bov[p] = C_o^T B[p] C_v, (ia|jb) = sum_p Bov[p,i,a] Bov[p,j,b];
- RMP2 and UMP2 in core: (ia|jb) from the in-core tensor by four quarter
  transforms (never one 5-operand einsum, which may contract through an
  nao^4 * nocc * nvir intermediate).

DF-UMP2 raises: cctpu's unrestricted path reads the in-core tensor, which
a DF SCF does not have.
"""

from __future__ import annotations

import torch


def _ovov(eri, Co1, Cv1, Co2, Cv2):
    """(ia|jb) from the in-core tensor [n^2, n^2] as four quarter
    transforms: [no1, nv1, no2, nv2]."""
    n = Co1.shape[0]
    t = (Co1.T @ eri.reshape(n, n ** 3)).reshape(-1, n, n, n)   # i q r s
    t = torch.einsum("qa,iqrs->iars", Cv1, t)
    t = torch.einsum("rj,iars->iajs", Co2, t)
    return torch.einsum("sb,iajs->iajb", Cv2, t)


def _denom(e1, no1, e2, no2):
    return (e1[:no1, None, None, None] - e1[None, no1:, None, None]
            + e2[None, None, :no2, None] - e2[None, None, None, no2:])


class MP2:
    """``MP2(mf).kernel() -> (e_corr, e_tot)`` on a converged RHF or UHF."""

    def __init__(self, mf):
        self.mf = mf
        self.e_corr = None
        self.e_tot = None

    def kernel(self):
        mf = self.mf
        C = mf.mo_coeff
        if C.ndim == 3:
            return self._ump2()
        nocc = mf.mol.nelectron // 2
        e = mf.mo_energy
        Co, Cv = C[:, :nocc], C[:, nocc:]
        if mf.density_fit:
            B = mf._jk.B                                  # [naux, n, n]
            Bov = torch.matmul(torch.matmul(Co.T, B), Cv)  # [naux, no, nv]
            Bov = Bov.reshape(B.shape[0], -1)
            nvir = Cv.shape[1]
            ovov = (Bov.T @ Bov).reshape(nocc, nvir, nocc, nvir)
        else:
            ovov = _ovov(mf._jk.eri, Co, Cv, Co, Cv)
        t = ovov / _denom(e, nocc, e, nocc)
        self.e_corr = float(torch.sum(
            t * (2.0 * ovov - ovov.transpose(1, 3))))
        self.e_tot = float(mf.e_tot) + self.e_corr
        return self.e_corr, self.e_tot

    def _ump2(self):
        mf = self.mf
        if mf.density_fit:
            raise NotImplementedError(
                "DF-UMP2 is not ported: cctpu's unrestricted MP2 reads the "
                "in-core ERI tensor, which a density-fitted SCF does not "
                "have; run UMP2 with density_fit=False")
        C, e = mf.mo_coeff, mf.mo_energy
        occs = (mf.mol.nalpha, mf.mol.nbeta)
        eri = mf._jk.eri

        def block(s1, s2):
            return _ovov(eri, C[s1][:, :occs[s1]], C[s1][:, occs[s1]:],
                         C[s2][:, :occs[s2]], C[s2][:, occs[s2]:])

        e_corr = 0.0
        for s in range(2):                                # same spin
            v = block(s, s)
            v = v - v.transpose(1, 3)
            e_corr += 0.25 * float(torch.sum(
                v * v / _denom(e[s], occs[s], e[s], occs[s])))
        v = block(0, 1)                                   # opposite spin
        e_corr += float(torch.sum(
            v * v / _denom(e[0], occs[0], e[1], occs[1])))
        self.e_corr = e_corr
        self.e_tot = float(mf.e_tot) + e_corr
        return self.e_corr, self.e_tot
