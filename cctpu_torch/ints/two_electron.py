"""Two-electron repulsion integrals: the McMurchie–Davidson quartet kernel.

Port of ``cctpu/ints/two_electron.py``: shell quartets are grouped by
angular-momentum class so one call evaluates a whole batch of quartets with
static per-class shapes. Where cctpu ``vmap``s a per-quartet kernel, the
port writes the quartet axis out as the leading dimension of every tensor.
This stays plain torch: cctpu never wrote the quartet kernel in Pallas.

A 3c2e integral (P|ab) is the same kernel with a dummy s-function (exponent
0, coefficient 1) paired with the auxiliary shell.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, ncart
from cctpu_torch.ints.md import e3_components, r_box
from cctpu_torch.ints.one_electron import c2s, shell_pairs


def _hermite_3d(la: int, lb: int, ea, eb, A, B, coef):
    """Hermite expansion tensor E3[..., K, ncA*ncB, (lab+1)^3] of a pair.

    ea: [..., npA], eb: [..., npB], A, B: [..., 3]; coef: [..., npA, npB].
    K = npA*npB flattened primitive-pair axis."""
    E3 = e3_components(la, lb, ea[..., :, None], eb[..., None, :], A, B)
    E3 = E3 * coef[..., None, None]
    return E3.reshape(*E3.shape[:-4], E3.shape[-4] * E3.shape[-3],
                      E3.shape[-2], E3.shape[-1])


@lru_cache(maxsize=None)
def _gather_idx(lab: int, lcd: int) -> np.ndarray:
    """IDX[(lab+1)^3, (lcd+1)^3] flat index into the (ltot+1)^3 R box."""
    bt = lab + lcd + 1
    b1, b2 = lab + 1, lcd + 1
    idx = np.zeros((b1 ** 3, b2 ** 3), dtype=np.int64)
    for i1, (t, u, v) in enumerate(np.ndindex(b1, b1, b1)):
        for i2, (tt, uu, vv) in enumerate(np.ndindex(b2, b2, b2)):
            idx[i1, i2] = ((t + tt) * bt + (u + uu)) * bt + (v + vv)
    return idx


@lru_cache(maxsize=None)
def _sign_vec(lcd: int) -> np.ndarray:
    """(-1)^(t+u+v) over the ket Hermite box."""
    b = lcd + 1
    s = np.empty(b ** 3)
    for i, (t, u, v) in enumerate(np.ndindex(b, b, b)):
        s[i] = (-1.0) ** (t + u + v)
    return s


def eri_quartet_kernel(ls: Tuple[int, int, int, int],
                       eA, cA, A, eB, cB, B, eC, cC, C, eD, cD, D):
    """Contracted spherical ERI blocks [..., nsA, nsB, nsC, nsD].

    e*: [..., np*] exponents (padded with 1s), c*: [..., np*] coefficients
    (padded with 0s), centers [..., 3]; ``...`` is the quartet batch."""
    la, lb, lc, ld = ls
    lab, lcd = la + lb, lc + ld
    dev, dt = eA.device, eA.dtype

    p = eA[..., :, None] + eB[..., None, :]
    q = eC[..., :, None] + eD[..., None, :]
    wab = cA[..., :, None] * cB[..., None, :]
    wcd = cC[..., :, None] * cD[..., None, :]
    P = (eA[..., :, None, None] * A[..., None, None, :]
         + eB[..., None, :, None] * B[..., None, None, :]) / p[..., None]
    Q = (eC[..., :, None, None] * C[..., None, None, :]
         + eD[..., None, :, None] * D[..., None, None, :]) / q[..., None]

    Eb = _hermite_3d(la, lb, eA, eB, A, B, wab)        # [..., Kab, nab, T1]
    Ek = _hermite_3d(lc, ld, eC, eD, C, D, wcd)        # [..., Kcd, ncd, T2]
    Ek = Ek * torch.as_tensor(_sign_vec(lcd), dtype=dt, device=dev)

    batch = p.shape[:-2]
    pf = p.reshape(*batch, -1)
    qf = q.reshape(*batch, -1)
    Pf = P.reshape(*batch, -1, 3)
    Qf = Q.reshape(*batch, -1, 3)

    ps = pf[..., :, None] + qf[..., None, :]
    alpha = pf[..., :, None] * qf[..., None, :] / ps
    PQ = Pf[..., :, None, :] - Qf[..., None, :, :]
    pref = 2.0 * math.pi ** 2.5 / (pf[..., :, None] * qf[..., None, :]
                                   * torch.sqrt(ps))
    Rb = r_box(lab + lcd, alpha, PQ) * pref[..., None]  # [..., Kab, Kcd, Tb]
    idx = torch.as_tensor(_gather_idx(lab, lcd), device=dev)
    Rbig = Rb[..., idx]                                # [..., Kab,Kcd,T1,T2]

    tmp = torch.einsum("...kqxy,...qcy->...kxc", Rbig, Ek)  # [.,Kab,T1,ncd]
    cart = torch.einsum("...kax,...kxc->...ac", Eb, tmp)     # [..., nab, ncd]
    cart = cart.reshape(*batch, ncart(la), ncart(lb), ncart(lc), ncart(ld))
    x = torch.einsum("pa,...abcd->...pbcd", c2s(la, cart), cart)
    x = torch.einsum("qb,...pbcd->...pqcd", c2s(lb, cart), x)
    x = torch.einsum("rc,...pqcd->...pqrd", c2s(lc, cart), x)
    return torch.einsum("sd,...pqrd->...pqrs", c2s(ld, cart), x)


def class_chunk(ls, npA, npB, npC, npD, budget: int = 1 << 25,
                cap: int = 1 << 16) -> int:
    """Quartets per kernel call for a class: bounds the dominant
    intermediate Rbig [chunk, Kab, Kcd, T1, T2] to ``budget`` elements
    (256 MB in f64). Power of two."""
    T1 = (ls[0] + ls[1] + 1) ** 3
    T2 = (ls[2] + ls[3] + 1) ** 3
    cost = max(npA * npB * npC * npD * T1 * T2, npA * npB * npC * npD * 16)
    c = max(16, min(cap, budget // max(cost, 1)))
    return 1 << (c.bit_length() - 1)


# ----------------------------------------------------------------------------
# Pair bookkeeping (host side, numpy)
# ----------------------------------------------------------------------------

class PairClass:
    """All shell pairs of one (la, lb) class, la <= lb; i <= j when la==lb."""

    def __init__(self, basis: BasisSet, la: int, lb: int):
        ga, gb = basis.groups[la], basis.groups[lb]
        ia, ib = shell_pairs(len(ga.shell_idx), len(gb.shell_idx), la == lb)
        self.la, self.lb = la, lb
        self.ia, self.ib = ia, ib
        self.exps_a = ga.exps[ia]
        self.coefs_a = ga.coefs[ia]
        self.exps_b = gb.exps[ib]
        self.coefs_b = gb.coefs[ib]
        self.atom_a = ga.atom_idx[ia]
        self.atom_b = gb.atom_idx[ib]
        self.ao_a = ga.ao_start[ia]
        self.ao_b = gb.ao_start[ib]
        self.n = len(ia)

    def tables(self, coords):
        """(eA, cA, A, eB, cB, B) of every pair, on ``coords``' device."""
        dev, dt = coords.device, coords.dtype

        def t(x):
            return torch.as_tensor(x, dtype=dt, device=dev)

        return (t(self.exps_a), t(self.coefs_a),
                coords[torch.as_tensor(self.atom_a, device=dev)],
                t(self.exps_b), t(self.coefs_b),
                coords[torch.as_tensor(self.atom_b, device=dev)])


def pair_classes(basis: BasisSet) -> List[PairClass]:
    ls = sorted(basis.groups)
    out = []
    for i, la in enumerate(ls):
        for lb in ls[i:]:
            pc = PairClass(basis, la, lb)
            if pc.n:
                out.append(pc)
    return out


def schwarz_q(pcs: List[PairClass], coords) -> List[torch.Tensor]:
    """Schwarz factors per pair class: Q[pair] = sqrt(max_ab |(ab|ab)|).

    |(ab|cd)| <= Q_ab * Q_cd (Cauchy–Schwarz on the ERI inner product)."""
    out = []
    for pc in pcs:
        ls = (pc.la, pc.lb, pc.la, pc.lb)
        chunk = class_chunk(ls, pc.exps_a.shape[1], pc.exps_b.shape[1],
                            pc.exps_a.shape[1], pc.exps_b.shape[1])
        tabs = pc.tables(coords)
        q = []
        for s in range(0, pc.n, chunk):
            args = tuple(x[s:s + chunk] for x in tabs)
            blocks = eri_quartet_kernel(ls, *args, *args)
            diag = torch.abs(torch.einsum("qabab->qab", blocks))
            q.append(torch.sqrt(diag.amax(dim=(1, 2))))
        out.append(torch.cat(q))
    return out
