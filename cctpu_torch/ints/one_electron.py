"""One-electron integrals: overlap, kinetic, nuclear attraction, dipole.

Port of ``cctpu/ints/one_electron.py::build_int1e_eager``: for each
(la, lb) shell-class pair the contracted cartesian blocks are evaluated for
all shell pairs of the class at once (a written-out leading pair axis; the
primitive dimension is padded per class, zero coefficients kill the
padding), transformed to spherical AOs and scattered into the AO matrices
on the device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from cctpu_torch.core.basis import (BasisSet, cart2sph, cart_components,
                                    ncart, nsph)
from cctpu_torch.ints.md import e3_components, e_table_1d, r_box

# shell pairs evaluated per batch (bounds the [pairs, npA, npB, natm, box^3]
# nuclear-attraction intermediate)
_PAIR_CHUNK = 2048


def _pair_e_tables(la: int, lb: int, a, b, A, B):
    """E tables for all 3 directions. a: [..., npA, 1], b: [..., 1, npB]."""
    return [e_table_1d(la, lb, a, b, (A[..., d] - B[..., d])[..., None, None])
            for d in range(3)]


def _overlap_kinetic_block(la: int, lb: int, ea, ca, A, eb, cb, B):
    """Contracted cartesian overlap and kinetic blocks [..., ncA, ncB].

    ea, ca: [..., npA]; eb, cb: [..., npB]; A, B: [..., 3]."""
    a = ea[..., :, None]
    b = eb[..., None, :]
    p = a + b
    coef = ca[..., :, None] * cb[..., None, :]
    pref = (math.pi / p) ** 1.5 * coef
    E = _pair_e_tables(la, lb + 2, a, b, A, B)

    def s1d(d, i, j):
        if j < 0:
            return 0.0
        return E[d][i][j][0]

    def t1d(d, i, j):
        out = -2.0 * b * b * s1d(d, i, j + 2) + b * (2 * j + 1) * s1d(d, i, j)
        if j >= 2:
            out = out - 0.5 * j * (j - 1) * s1d(d, i, j - 2)
        return out

    S, T = [], []
    for (ax, ay, az) in cart_components(la):
        rowS, rowT = [], []
        for (bx, by, bz) in cart_components(lb):
            sx, sy, sz = s1d(0, ax, bx), s1d(1, ay, by), s1d(2, az, bz)
            rowS.append(torch.sum(pref * sx * sy * sz, dim=(-2, -1)))
            tx, ty, tz = t1d(0, ax, bx), t1d(1, ay, by), t1d(2, az, bz)
            rowT.append(torch.sum(pref * (tx * sy * sz + sx * ty * sz
                                          + sx * sy * tz), dim=(-2, -1)))
        S.append(torch.stack(rowS, dim=-1))
        T.append(torch.stack(rowT, dim=-1))
    return torch.stack(S, dim=-2), torch.stack(T, dim=-2)


def _nuclear_block(la: int, lb: int, ea, ca, A, eb, cb, B,
                   atom_coords, atom_charges):
    """Contracted cartesian nuclear-attraction block [..., ncA, ncB]."""
    a = ea[..., :, None]
    b = eb[..., None, :]
    p = a + b
    coef = ca[..., :, None] * cb[..., None, :]
    P = (a[..., None] * A[..., None, None, :]
         + b[..., None] * B[..., None, None, :]) / p[..., None]
    E3 = e3_components(la, lb, a, b, A, B)          # [..., npA,npB,nc2,box^3]
    PC = P[..., None, :] - atom_coords               # [..., npA,npB,natm,3]
    R = r_box(la + lb, p[..., None], PC)            # [..., npA,npB,natm,box^3]
    pref = (2.0 * math.pi / p) * coef
    V = -torch.einsum("...pqcx,...pq,...pqnx,n->...c", E3, pref, R,
                      atom_charges)
    return V.reshape(*V.shape[:-1], ncart(la), ncart(lb))


def _dipole_block(la: int, lb: int, ea, ca, A, eb, cb, B, origin):
    """Contracted cartesian dipole blocks [..., 3, ncA, ncB] about origin."""
    a = ea[..., :, None]
    b = eb[..., None, :]
    p = a + b
    coef = ca[..., :, None] * cb[..., None, :]
    pref = (math.pi / p) ** 1.5 * coef
    P = (a[..., None] * A[..., None, None, :]
         + b[..., None] * B[..., None, None, :]) / p[..., None]
    E = _pair_e_tables(la, lb, a, b, A, B)

    def s1d(d, i, j):
        return E[d][i][j][0]

    def m1d(d, i, j):
        # <i| (x - origin_d) |j>: E_1 + (P - C) E_0
        e1 = E[d][i][j][1] if i + j >= 1 else 0.0
        return e1 + (P[..., d] - origin[d]) * E[d][i][j][0]

    out = []
    for d in range(3):
        mat = []
        for ii in cart_components(la):
            row = []
            for jj in cart_components(lb):
                fac = [s1d(k, ii[k], jj[k]) for k in range(3)]
                fac[d] = m1d(d, ii[d], jj[d])
                row.append(torch.sum(pref * fac[0] * fac[1] * fac[2],
                                     dim=(-2, -1)))
            mat.append(torch.stack(row, dim=-1))
        out.append(torch.stack(mat, dim=-2))
    return torch.stack(out, dim=-3)


@lru_cache(maxsize=None)
def _c2s_np(l: int) -> np.ndarray:
    return cart2sph(l)


def c2s(l: int, like: torch.Tensor) -> torch.Tensor:
    """cart->sph matrix T[2l+1, ncart] on ``like``'s device and dtype."""
    return torch.as_tensor(_c2s_np(l), dtype=like.dtype, device=like.device)


def _to_sph(block_cart, la: int, lb: int):
    return torch.einsum("ac,...cd,bd->...ab", c2s(la, block_cart),
                        block_cart, c2s(lb, block_cart))


def shell_pairs(na: int, nb: int, same: bool):
    """Index pairs (ia, ib) of two shell groups; ia <= ib within a group."""
    ia, ib = np.mgrid[0:na, 0:nb]
    ia, ib = ia.ravel(), ib.ravel()
    if same:
        keep = ia <= ib
        ia, ib = ia[keep], ib[keep]
    return ia, ib


def build_int1e_eager(basis: BasisSet, coords, charges,
                      with_dipole: bool = False, dipole_origin=None):
    """S, T, V (+ dipole [3, nao, nao]) as tensors on ``coords``' device.

    coords: [natm, 3] Bohr tensor; charges: [natm] tensor."""
    dev, dt = coords.device, coords.dtype
    nao = basis.nao
    S = torch.zeros((nao, nao), dtype=dt, device=dev)
    T = torch.zeros_like(S)
    V = torch.zeros_like(S)
    D = torch.zeros((3, nao, nao), dtype=dt, device=dev) if with_dipole \
        else None
    origin = (torch.zeros(3, dtype=dt, device=dev) if dipole_origin is None
              else torch.as_tensor(dipole_origin, dtype=dt, device=dev))

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    ls = sorted(basis.groups)
    for la in ls:
        ga = basis.groups[la]
        for lb in ls:
            if lb < la:
                continue
            gb = basis.groups[lb]
            ia_all, ib_all = shell_pairs(len(ga.shell_idx), len(gb.shell_idx),
                                         la == lb)
            sa, sb = nsph(la), nsph(lb)
            for s in range(0, len(ia_all), _PAIR_CHUNK):
                ia = ia_all[s:s + _PAIR_CHUNK]
                ib = ib_all[s:s + _PAIR_CHUNK]
                argsA = (t(ga.exps[ia]), t(ga.coefs[ia]),
                         coords[torch.as_tensor(ga.atom_idx[ia], device=dev)])
                argsB = (t(gb.exps[ib]), t(gb.coefs[ib]),
                         coords[torch.as_tensor(gb.atom_idx[ib], device=dev)])
                sblk, tblk = _overlap_kinetic_block(la, lb, *argsA, *argsB)
                sblk, tblk = _to_sph(sblk, la, lb), _to_sph(tblk, la, lb)
                vblk = _to_sph(_nuclear_block(la, lb, *argsA, *argsB, coords,
                                              charges), la, lb)
                r = torch.as_tensor(ga.ao_start[ia][:, None]
                                    + np.arange(sa), device=dev)
                c = torch.as_tensor(gb.ao_start[ib][:, None]
                                    + np.arange(sb), device=dev)
                ri, ci = r[:, :, None], c[:, None, :]
                for M_, B_ in ((S, sblk), (T, tblk), (V, vblk)):
                    M_[ri, ci] = B_
                    M_[ci.transpose(1, 2), ri.transpose(1, 2)] = \
                        B_.transpose(1, 2)
                if with_dipole:
                    dblk = _to_sph(_dipole_block(la, lb, *argsA, *argsB,
                                                 origin), la, lb)
                    dblk = dblk.transpose(0, 1)          # [3, pairs, sa, sb]
                    D[:, ri, ci] = dblk
                    D[:, ci.transpose(1, 2), ri.transpose(1, 2)] = \
                        dblk.transpose(2, 3)
    out = {"S": S, "T": T, "V": V}
    if with_dipole:
        out["dipole"] = D
    return out
