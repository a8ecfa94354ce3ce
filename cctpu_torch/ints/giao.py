"""GIAO (gauge-including atomic orbital) integral machinery.

Port of ``cctpu/ints/giao.py``: every moment integral comes from
*bra-raised* McMurchie–Davidson blocks,

    <mu| r_c O |nu> = blk_{la+1,lb}[raise(ii, c), jj] + A_c blk_{la,lb}[ii, jj]

because r_c = (r - A)_c + A_c and (r-A)_c chi_mu is the cartesian
component ii+e_c of the (la+1) shell with the same radial part. So the
overlap/kinetic, nuclear, W and ERI kernels give their moment counterparts
with no new E-table machinery.

All B-linear quantities are kept in the real antisymmetric representation
X_phys = (i/2c) * Xtilde, as cctpu does.

The two-electron builders walk the bra-raised classes (la+1, lb, lc, ld)
and (la+1, lb, lP, 0) in chunks of ``class_chunk`` quartets, as
``ints/df.py::walk_3c2e`` does, on the device; each chunk's blocks go into
the result with one indexed write per symmetric image (cctpu loops over
the quartets of a chunk on the host).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, cart_components, ncart, nsph
from cctpu_torch.ints.magnetic import (_hermite_cost, _nuclei, assemble_1e,
                                       chunk_scale, h01_of, nabla_block,
                                       w_block)
from cctpu_torch.ints.one_electron import (_nuclear_block,
                                           _overlap_kinetic_block)
from cctpu_torch.ints.two_electron import (CHUNK_BUDGET, class_chunk,
                                           eri_quartet_cart, pair_classes,
                                           quartet_to_sph, shell_pairs)


@lru_cache(maxsize=None)
def _raise_map(l: int, c: int) -> np.ndarray:
    """Index map: component ii of shell l -> index of ii+e_c in shell l+1."""
    lo = cart_components(l)
    hi = {comp: k for k, comp in enumerate(cart_components(l + 1))}
    out = np.zeros(len(lo), dtype=np.int64)
    for k, comp in enumerate(lo):
        out[k] = hi[tuple(v + (d == c) for d, v in enumerate(comp))]
    return out


@lru_cache(maxsize=None)
def _raise_on(l: int, c: int, device) -> torch.Tensor:
    return torch.as_tensor(_raise_map(l, c), device=device)


def _moment_of(blk_hi, blk_lo, la: int, A, axis: int):
    """Moment blocks [batch, 3, ...] from the raised-bra blocks: blk_hi
    [batch, ...] with ncart(la+1) bra components on ``axis``, evaluated
    with the la shell's exponents and coefficients; blk_lo [batch, ...]
    with ncart(la) there; A [batch, 3] the bra centers."""
    Ab = A.reshape(A.shape[0], 3, *[1] * (blk_lo.ndim - 1))
    return torch.stack([
        blk_hi.index_select(axis, _raise_on(la, c, blk_hi.device))
        + Ab[:, c] * blk_lo for c in range(3)], 1)


def ao_centers(basis: BasisSet, coords) -> torch.Tensor:
    """[nao, 3] center coordinate of each (spherical) AO, on ``coords``'
    device."""
    atom = np.zeros(basis.nao, dtype=np.int64)
    for sh in basis.shells:
        atom[sh.ao_start:sh.ao_start + nsph(sh.l)] = sh.atom
    return coords[torch.as_tensor(atom, device=coords.device)]


# ----------------------------------------------------------------------------
# One-electron moment integrals
# ----------------------------------------------------------------------------

def moment_st_integrals(basis: BasisSet, coords):
    """(mS, mT): <mu| r_c |nu> and <mu| r_c T |nu>, both [3, nao, nao]
    (T acting on the ket)."""
    def block(la, lb, ea, ca, A, eb, cb, B):
        s_hi, t_hi = _overlap_kinetic_block(la + 1, lb, ea, ca, A, eb, cb, B)
        s_lo, t_lo = _overlap_kinetic_block(la, lb, ea, ca, A, eb, cb, B)
        return torch.cat([_moment_of(s_hi, s_lo, la, A, -2),
                          _moment_of(t_hi, t_lo, la, A, -2)], 1)

    out = assemble_1e(basis, coords, block, (6,),
                      lambda la, lb: 12 * ncart(la + 1) * ncart(lb + 2))
    return out[:3], out[3:]


def moment_v_integrals(basis: BasisSet, coords, charges):
    """<mu| r_c V |nu> [3, nao, nao] with V the full nuclear attraction."""
    charges = torch.as_tensor(charges, dtype=coords.dtype,
                              device=coords.device)
    natm = coords.shape[0]

    def block(la, lb, ea, ca, A, eb, cb, B):
        v_hi = _nuclear_block(la + 1, lb, ea, ca, A, eb, cb, B, coords,
                              charges)
        v_lo = _nuclear_block(la, lb, ea, ca, A, eb, cb, B, coords, charges)
        return _moment_of(v_hi, v_lo, la, A, -2)

    return assemble_1e(basis, coords, block, (3,),
                       lambda la, lb: (natm + ncart(la + 1) * ncart(lb))
                       * (la + lb + 2) ** 3)


def nabla_integrals(basis: BasisSet, coords):
    """<mu| d/dr_c |nu> [3, nao, nao] (real; antisymmetric)."""
    return assemble_1e(basis, coords, nabla_block, (3,),
                       lambda la, lb: 9 * ncart(la) * ncart(lb))


def moment_w_integrals(basis: BasisSet, coords, R):
    """<mu| r_d (1/|r-R|) d_beta |nu> [3(d), 3(beta), nao, nao] at a
    nucleus R [3], or [nR, 3, 3, nao, nao] for R [nR, 3]."""
    Rn, one = _nuclei(R, coords)

    def block(la, lb, ea, ca, A, eb, cb, B):
        hi = w_block(la + 1, lb, ea, ca, A, eb, cb, B, Rn)
        lo = w_block(la, lb, ea, ca, A, eb, cb, B, Rn)
        return _moment_of(hi, lo, la, A, -2).movedim(1, 2)

    out = assemble_1e(basis, coords, block, (len(Rn), 3, 3),
                      lambda la, lb: len(Rn) * _hermite_cost(la + 1, lb, 3))
    return out[0] if one else out


def mh01_integrals(basis: BasisSet, coords, R):
    """<mu| r_d [(r-R) x grad]_g / |r-R|^3 |nu> [3(d), 3(g), nao, nao] at
    a nucleus R [3], or [nR, 3, 3, nao, nao] for R [nR, 3]: the
    bra-raised counterpart of ``magnetic.h01_integrals``."""
    Rn, one = _nuclei(R, coords)

    def block(la, lb, ea, ca, A, eb, cb, B):
        hi = h01_of(w_block(la + 1, lb, ea, ca, A, eb, cb, B, Rn,
                            deriv=True))
        lo = h01_of(w_block(la, lb, ea, ca, A, eb, cb, B, Rn, deriv=True))
        return _moment_of(hi, lo, la, A, -2).movedim(1, 2)

    out = assemble_1e(basis, coords, block, (len(Rn), 3, 3),
                      lambda la, lb: len(Rn) * 3
                      * _hermite_cost(la + 1, lb, 3))
    return out[0] if one else out


# ----------------------------------------------------------------------------
# Two-electron moment integrals
# ----------------------------------------------------------------------------

def _chunk(ls, npA, npB, npC, npD, device) -> int:
    """Quartets per call of a raised class: ``class_chunk`` at
    ``CHUNK_BUDGET`` (and its quartet cap) times ``chunk_scale``, the
    budget bounding the pairs' Hermite tensors [K, ncA*ncB, T] too: with
    an s-type ket (the 3c2e's aux side) the bra's outgrows Rbig, and a
    raised (1, 1, 0, 0) chunk took 23 GB at phenol/6-311G** without it."""
    k = chunk_scale(device)
    la, lb, lc, ld = ls
    e3 = max(npA * npB * ncart(la) * ncart(lb) * (la + lb + 1) ** 3,
             npC * npD * ncart(lc) * ncart(ld) * (lc + ld + 1) ** 3)
    c = max(16, CHUNK_BUDGET * k // e3)
    return min(class_chunk(ls, npA, npB, npC, npD, budget=CHUNK_BUDGET * k,
                           cap=(1 << 16) * k), 1 << (c.bit_length() - 1))


def moment_eri_quartet(ls, eA, cA, A, eB, cB, B, eC, cC, C, eD, cD, D,
                       omega: Optional[float] = None):
    """Spherical moment-ERI blocks [..., 3, nsA, nsB, nsC, nsD]: (mu r_c
    nu|lm sg) with the moment on electron 1 (the bra pair); ``...`` is the
    quartet batch."""
    la, lb, lc, ld = ls
    hi = eri_quartet_cart((la + 1, lb, lc, ld), eA, cA, A, eB, cB, B,
                          eC, cC, C, eD, cD, D, omega)
    lo = eri_quartet_cart(ls, eA, cA, A, eB, cB, B, eC, cC, C, eD, cD, D,
                          omega)
    return quartet_to_sph(_moment_of(hi, lo, la, A, 1), ls)


def build_moment_eri_incore(basis: BasisSet, coords,
                            omega: Optional[float] = None) -> torch.Tensor:
    """(mu r_c nu | la sg) [3, nao, nao, nao, nao] on ``coords``' device
    (validation size only): every bra pair class with every ket pair class
    (the moment breaks the pair-swap symmetry), all their pairs, in chunks
    of the raised class; each chunk's blocks written to the four places
    symmetric within the bra and the ket pair, one indexed write each."""
    dev, dt = coords.device, coords.dtype
    n = basis.nao
    out = torch.zeros((3, n, n, n, n), dtype=dt, device=dev)
    pcs = pair_classes(basis)
    sides = [pc.shells(dev, dt) for pc in pcs]
    xi = torch.arange(3, device=dev).reshape(1, 3, 1, 1, 1, 1)
    for i1, p1 in enumerate(pcs):
        for i2, p2 in enumerate(pcs):
            q1, q2 = shell_pairs(p1.n, p2.n, False)
            q1, q2 = (torch.as_tensor(q, device=dev) for q in (q1, q2))
            ls = (p1.la, p1.lb, p2.la, p2.lb)
            chunk = _chunk((p1.la + 1, p1.lb, p2.la, p2.lb),
                           p1.exps_a.shape[1], p1.exps_b.shape[1],
                           p2.exps_a.shape[1], p2.exps_b.shape[1], dev)
            (shA, shB), (shC, shD) = sides[i1], sides[i2]
            for s in range(0, len(q1), chunk):
                j1, j2 = q1[s:s + chunk], q2[s:s + chunk]
                blocks = moment_eri_quartet(
                    ls, *shA.at(j1, coords), *shB.at(j1, coords),
                    *shC.at(j2, coords), *shD.at(j2, coords), omega=omega)
                a = shA.rows(j1)[:, None, :, None, None, None]
                b = shB.rows(j1)[:, None, None, :, None, None]
                c = shC.rows(j2)[:, None, None, None, :, None]
                d = shD.rows(j2)[:, None, None, None, None, :]
                for i, j, k, l in ((a, b, c, d), (a, b, d, c), (b, a, c, d),
                                   (b, a, d, c)):
                    out[xi, i, j, k, l] = blocks
    return out


def build_moment_3c2e_eager(basis: BasisSet, aux: BasisSet, coords,
                            omega: Optional[float] = None) -> torch.Tensor:
    """(P| mu r_c nu) [3, naux, nao, nao] on ``coords``' device (the
    moment on the AO pair; no screening, as cctpu): per (aux l-group, AO
    pair class) the quartets (a r_c b | P 0), the aux shell with a dummy s
    partner as the ket, in chunks of the raised class (la+1, lb, lP, 0);
    each chunk's blocks and their ab <-> ba mirrors written with one
    indexed write each."""
    from cctpu_torch.ints.df import _aux_shells
    dev, dt = coords.device, coords.dtype
    out = torch.zeros((3, aux.nao, basis.nao, basis.nao), dtype=dt,
                      device=dev)
    pcs = pair_classes(basis)
    auxs = _aux_shells(aux, dev, dt)
    sides = [pc.shells(dev, dt) for pc in pcs]
    xi = torch.arange(3, device=dev).reshape(1, 3, 1, 1, 1)
    for lP in sorted(aux.groups):
        gP, shP = aux.groups[lP], auxs[lP]
        for ipc, pc in enumerate(pcs):
            q1, q2 = shell_pairs(len(gP.shell_idx), pc.n, False)
            q1, q2 = (torch.as_tensor(q, device=dev) for q in (q1, q2))
            ls = (pc.la, pc.lb, lP, 0)
            chunk = _chunk((pc.la + 1, pc.lb, lP, 0), pc.exps_a.shape[1],
                           pc.exps_b.shape[1], gP.exps.shape[1], 1, dev)
            shA, shB = sides[ipc]
            for s in range(0, len(q1), chunk):
                i1, i2 = q1[s:s + chunk], q2[s:s + chunk]
                blocks = moment_eri_quartet(
                    ls, *shA.at(i2, coords), *shB.at(i2, coords),
                    *shP.bra(i1, coords), omega=omega)[..., 0]
                a = shA.rows(i2)[:, None, :, None, None]
                b = shB.rows(i2)[:, None, None, :, None]
                P = shP.rows(i1)[:, None, None, None, :]
                out[xi, P, a, b] = blocks
                out[xi, P, b, a] = blocks
    return out

