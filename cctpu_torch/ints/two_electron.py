"""Two-electron repulsion integrals: the McMurchie–Davidson quartet kernel.

Port of ``cctpu/ints/two_electron.py``: shell quartets are grouped by
angular-momentum class so one call evaluates a whole batch of quartets with
static per-class shapes. Where cctpu ``vmap``s a per-quartet kernel, the
port writes the quartet axis out as the leading dimension of every tensor.
This stays plain torch: cctpu never wrote the quartet kernel in Pallas.

A 3c2e integral (P|ab) is the same kernel with a dummy s-function (exponent
0, coefficient 1) paired with the auxiliary shell.

``walk_4c`` walks the unique 4-center shell quartets in chunks; over it,
``build_eri_incore`` scatters the full in-core tensor and
``energy_2e_direct`` contracts each block with the density at once (the
direct energy, and by autograd the direct nuclear gradient). With
``omega`` every builder gives the erf-attenuated operator of the
range-separated functionals; ``IncoreLR`` is their long-range exchange
from the attenuated in-core tensor.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, ncart, nsph
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


@lru_cache(maxsize=None)
def _on_device(table, key, device, dtype) -> torch.Tensor:
    """A host table ``table(*key)`` on ``device`` once: a copy from host
    memory waits for the device's queue, once per kernel call otherwise."""
    arr = table(*key) if isinstance(key, tuple) else table(key)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def eri_quartet_kernel(ls: Tuple[int, int, int, int],
                       eA, cA, A, eB, cB, B, eC, cC, C, eD, cD, D,
                       omega: Optional[float] = None):
    """Contracted spherical ERI blocks [..., nsA, nsB, nsC, nsD].

    e*: [..., np*] exponents (padded with 1s), c*: [..., np*] coefficients
    (padded with 0s), centers [..., 3]; ``...`` is the quartet batch. With
    ``omega`` the operator is the attenuated erf(omega r)/r of the
    range-separated functionals: with s = omega^2/(alpha + omega^2), R is
    evaluated at s*alpha and the prefactor scaled by sqrt(s)."""
    return quartet_to_sph(eri_quartet_cart(ls, eA, cA, A, eB, cB, B,
                                           eC, cC, C, eD, cD, D, omega),
                          ls)


def quartet_to_sph(cart, ls):
    """Cartesian quartet blocks [..., ncA, ncB, ncC, ncD] to spherical
    [..., nsA, nsB, nsC, nsD]."""
    la, lb, lc, ld = ls
    x = torch.einsum("pa,...abcd->...pbcd", c2s(la, cart), cart)
    x = torch.einsum("qb,...pbcd->...pqcd", c2s(lb, cart), x)
    x = torch.einsum("rc,...pqcd->...pqrd", c2s(lc, cart), x)
    return torch.einsum("sd,...pqrd->...pqrs", c2s(ld, cart), x)


def eri_quartet_cart(ls: Tuple[int, int, int, int],
                     eA, cA, A, eB, cB, B, eC, cC, C, eD, cD, D,
                     omega: Optional[float] = None):
    """Contracted cartesian ERI blocks [..., ncA, ncB, ncC, ncD] of
    ``eri_quartet_kernel`` (its arguments), before the spherical
    transformation."""
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
    Ek = Ek * _on_device(_sign_vec, lcd, dev, dt)

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
    if omega is not None:
        s = omega * omega / (alpha + omega * omega)
        alpha = s * alpha
        pref = pref * torch.sqrt(s)
    Rb = r_box(lab + lcd, alpha, PQ) * pref[..., None]  # [..., Kab, Kcd, Tb]
    idx = _on_device(_gather_idx, (lab, lcd), dev, None)
    Rbig = Rb[..., idx]                                # [..., Kab,Kcd,T1,T2]

    tmp = torch.einsum("...kqxy,...qcy->...kxc", Rbig, Ek)  # [.,Kab,T1,ncd]
    cart = torch.einsum("...kax,...kxc->...ac", Eb, tmp)     # [..., nab, ncd]
    return cart.reshape(*batch, ncart(la), ncart(lb), ncart(lc), ncart(ld))


# element budget of a kernel call's largest intermediate (256 MB in f64)
CHUNK_BUDGET = 1 << 25


def class_chunk(ls, npA, npB, npC, npD, budget: int = CHUNK_BUDGET,
                cap: int = 1 << 16) -> int:
    """Quartets per kernel call for a class: bounds the dominant
    intermediate Rbig [chunk, Kab, Kcd, T1, T2] to ``budget`` elements.
    Power of two."""
    T1 = (ls[0] + ls[1] + 1) ** 3
    T2 = (ls[2] + ls[3] + 1) ** 3
    cost = max(npA * npB * npC * npD * T1 * T2, npA * npB * npC * npD * 16)
    c = max(16, min(cap, budget // max(cost, 1)))
    return 1 << (c.bit_length() - 1)


# ----------------------------------------------------------------------------
# Pair bookkeeping (host side, numpy)
# ----------------------------------------------------------------------------

class Shells:
    """One l-group of shells on the device: exponents, coefficients, atoms
    and first AOs. The centers are gathered from the coordinates each call
    is given, so a chunk's centers follow them under autograd."""

    def __init__(self, l, exps, coefs, atom, ao_start, dev, dt):
        self.l = l
        self.e = torch.as_tensor(exps, dtype=dt, device=dev)
        self.c = torch.as_tensor(coefs, dtype=dt, device=dev)
        self.atom = torch.as_tensor(atom, device=dev)
        self.ao = torch.as_tensor(ao_start, device=dev)

    @classmethod
    def of_group(cls, l, g, dev, dt):
        return cls(l, g.exps, g.coefs, g.atom_idx, g.ao_start, dev, dt)

    def at(self, i, coords):
        """(exps, coefs, centers) of shells ``i``."""
        return self.e[i], self.c[i], coords[self.atom[i]]

    def bra(self, i, coords):
        """(eP, cP, P, e_dummy, c_dummy, P) of aux shells ``i``: the dummy
        s-function (exponent 0, coefficient 1) turns the 4-center quartet
        kernel into a 2- or 3-center one."""
        e, c, xyz = self.at(i, coords)
        return (e, c, xyz, torch.zeros_like(e[:, :1]),
                torch.ones_like(c[:, :1]), xyz)

    def rows(self, i):
        """AO indices [len(i), 2l+1] of shells ``i``."""
        return self.ao[i][:, None] + torch.arange(nsph(self.l),
                                                  device=self.ao.device)


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

    def shells(self, dev, dt):
        """(Shells of the a sides, Shells of the b sides), pair by pair."""
        return (Shells(self.la, self.exps_a, self.coefs_a, self.atom_a,
                       self.ao_a, dev, dt),
                Shells(self.lb, self.exps_b, self.coefs_b, self.atom_b,
                       self.ao_b, dev, dt))

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


# Schwarz threshold of the direct 4-center walk: a shell quartet is skipped
# when Q_ab * Q_cd falls below it (cctpu's energy_2e_grad_eager)
SCREEN_TOL_4C = 1e-13


def walk_4c(basis: BasisSet, coords, budget: int = CHUNK_BUDGET,
            screen: bool = True):
    """The quartet-kernel chunks of the unique shell quartets (ab|cd): pair
    classes in cctpu's order (class i with classes i, i+1, ...), shell
    pairs i <= j within a class, pair indices q1 <= q2 within one class,
    cut into chunks of ``class_chunk(..., budget)`` quartets (the last one
    ragged). With ``screen``, the quartets that the Schwarz bound at
    ``coords`` puts below ``SCREEN_TOL_4C`` are skipped (the direct energy
    and gradient); the in-core build keeps every quartet. The one walk of
    ``build_eri_incore``, ``energy_2e_direct`` and the direct nuclear
    gradient.

    Yields (ls, args, (A, B, C, D), mult): ``args(c)`` is the kernel's
    argument tuple with the centers gathered from ``c``; A..D [nq, s] are
    the AO indices of the blocks' four axes; ``mult`` [nq] is the 8-fold
    multiplicity w_ab * w_cd * w_bk (2 for a pair of two shells, 2 for two
    different pairs) with which a quartet stands for its images."""
    dev, dt = coords.device, coords.dtype
    pcs = pair_classes(basis)
    qs = None
    if screen:
        with torch.no_grad():
            qs = [q.cpu().numpy() for q in schwarz_q(pcs, coords.detach())]
    sides = [pc.shells(dev, dt) for pc in pcs]
    for i1, p1 in enumerate(pcs):
        for i2 in range(i1, len(pcs)):
            p2 = pcs[i2]
            q1, q2 = shell_pairs(p1.n, p2.n, i1 == i2)
            if qs is not None:
                keep = qs[i1][q1] * qs[i2][q2] > SCREEN_TOL_4C
                q1, q2 = q1[keep], q2[keep]
                if len(q1) == 0:
                    continue
            w1 = np.where(p1.ia[q1] == p1.ib[q1], 1.0, 2.0) \
                if p1.la == p1.lb else np.full(len(q1), 2.0)
            w2 = np.where(p2.ia[q2] == p2.ib[q2], 1.0, 2.0) \
                if p2.la == p2.lb else np.full(len(q2), 2.0)
            wbk = np.where((i1 == i2) & (q1 == q2), 1.0, 2.0)
            mult = torch.as_tensor(w1 * w2 * wbk, dtype=dt, device=dev)
            q1, q2 = (torch.as_tensor(q, device=dev) for q in (q1, q2))
            ls = (p1.la, p1.lb, p2.la, p2.lb)
            chunk = class_chunk(ls, p1.exps_a.shape[1], p1.exps_b.shape[1],
                                p2.exps_a.shape[1], p2.exps_b.shape[1],
                                budget=budget)
            (shA, shB), (shC, shD) = sides[i1], sides[i2]
            for s in range(0, len(q1), chunk):
                j1, j2 = q1[s:s + chunk], q2[s:s + chunk]

                def args(c, j1=j1, j2=j2, shA=shA, shB=shB, shC=shC,
                         shD=shD):
                    return (*shA.at(j1, c), *shB.at(j1, c),
                            *shC.at(j2, c), *shD.at(j2, c))

                rows = (shA.rows(j1), shB.rows(j1), shC.rows(j2),
                        shD.rows(j2))
                yield ls, args, rows, mult[s:s + chunk]


def build_eri_incore(basis: BasisSet, coords,
                     omega: Optional[float] = None) -> torch.Tensor:
    """The full (ij|kl) tensor [nao, nao, nao, nao] in f64 on ``coords``'
    device: every unique quartet of ``walk_4c`` (no screening, as cctpu),
    its block written to all 8 symmetric places, of the erf-attenuated
    operator with ``omega``. Plain writes, no adds: where index sets
    repeat (a pair of one shell with itself), the writes to one address
    come in a fixed order."""
    n = basis.nao
    out = torch.zeros(n ** 4, dtype=coords.dtype, device=coords.device)
    for ls, args, (A, B, C, D), _ in walk_4c(basis, coords, screen=False):
        blocks = eri_quartet_kernel(ls, *args(coords),
                                    omega=omega).reshape(-1)
        a = A[:, :, None, None, None]
        b = B[:, None, :, None, None]
        c = C[:, None, None, :, None]
        d = D[:, None, None, None, :]
        for i, j, k, l in ((a, b, c, d), (b, a, c, d), (a, b, d, c),
                           (b, a, d, c), (c, d, a, b), (d, c, a, b),
                           (c, d, b, a), (d, c, b, a)):
            out[(((i * n + j) * n + k) * n + l).reshape(-1)] = blocks
    return out.reshape(n, n, n, n)


def exchange_view(eri: torch.Tensor) -> torch.Tensor:
    """The [nao^2, nao^2] matrix (ij, kl) -> (ik|jl) of an (ij|kl) tensor
    [nao, nao, nao, nao]: K_ij = sum_kl (ik|jl) D_kl is one matrix product
    with it (``contract_view``). A copy: the tensor can be freed after."""
    n2 = eri.shape[0] * eri.shape[1]
    return eri.permute(0, 2, 1, 3).reshape(n2, n2)


def contract_view(view: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """A [nao^2, nao^2] view times a [nao, nao] or [..., nao, nao] dm, as
    the dm's shape."""
    d = dm.reshape(-1, dm.shape[-1] ** 2).T
    return (view @ d).T.reshape(dm.shape)


class LRCache:
    """The attenuated tensors of a J/K builder's long-range exchange, built
    once per omega (``prepare_lr``, which returns them) from the basis and
    coordinates the builder was made from. A builder made on given tensors
    (no basis) holds only the ones it was given, and raises for another
    omega. Subclasses set them with ``_init_lr`` and build with
    ``_build_lr``."""

    def _init_lr(self, basis=None, coords=None, given=None):
        self._basis, self._coords = basis, coords
        self._lr = dict(given or {})

    def prepare_lr(self, omega: float):
        if omega not in self._lr:
            if self._basis is None:
                raise ValueError(f"no attenuated tensors at omega {omega} "
                                 "and no basis to build them from")
            self._lr[omega] = self._build_lr(omega)
        return self._lr[omega]


class IncoreLR(LRCache):
    """Long-range exchange of the range-separated functionals from the
    erf-attenuated in-core tensor (cctpu's ``k_lr`` of its in-core and
    Cholesky builders), kept in exchange order only: K_lr is one matrix
    product. cctpu computes it outside any Pallas kernel, so no kernel of
    the port runs here."""

    def _build_lr(self, omega: float):
        return exchange_view(build_eri_incore(self._basis, self._coords,
                                              omega))

    def k_lr(self, dm, omega: float, cocc=None):
        """K_lr of a [nao, nao] or [2, nao, nao] dm (``cocc`` is not
        needed)."""
        return contract_view(self.prepare_lr(omega), dm)


def e2_densities(dm, k_weight: float):
    """(Dt, Dks, kw) of ``chunk_energy_2e``: the total density, the
    exchange densities (the dm itself, or its two spins) and the exchange
    weight (``k_weight``, doubled for spin densities)."""
    if dm.ndim == 3:
        return dm[0] + dm[1], dm, 2.0 * k_weight
    return dm, dm[None], k_weight


def chunk_energy_2e(blocks, rows, mult, Dt, Dks, kw: float):
    """A chunk's share of E_2e: sum_q mult_q [1/2 (ab|cd) Dt_ab Dt_cd
    - kw/8 sum_s (ab|cd) (Ds_ac Ds_bd + Ds_ad Ds_bc)] over its blocks
    [nq, sa, sb, sc, sd] with AO indices ``rows`` (A, B, C, D); the
    exchange part alone for a ``Dt`` of None."""
    A, B, C, D = rows

    def g(M, X, Y):
        return M[X[:, :, None], Y[:, None, :]]

    mb = mult[:, None, None, None, None] * blocks
    e = 0.0 if Dt is None else 0.5 * torch.einsum(
        "qabcd,qab,qcd->", mb, g(Dt, A, B), g(Dt, C, D))
    if kw:
        for Dk in Dks:
            e = e - 0.125 * kw * (
                torch.einsum("qabcd,qac,qbd->", mb, g(Dk, A, C), g(Dk, B, D))
                + torch.einsum("qabcd,qad,qbc->", mb, g(Dk, A, D),
                               g(Dk, B, C)))
    return e


def energy_2e_direct(basis: BasisSet, coords, dm, k_weight: float):
    """E_2e = 1/2 Tr[D J(D)] - k_weight/4 Tr[D K(D)] for a total density
    [nao, nao] (k_weight 1 is Hartree-Fock exchange), or 1/2 Tr[D J(D)] -
    k_weight/2 sum_s Tr[D_s K(D_s)] for spin densities [2, nao, nao]:
    ``walk_4c``'s screened unique quartets, each block contracted with the
    gathered density blocks and never stored. Differentiable in
    ``coords``."""
    Dt, Dks, kw = e2_densities(dm, k_weight)
    e = torch.zeros((), dtype=dm.dtype, device=dm.device)
    for ls, args, rows, mult in walk_4c(basis, coords):
        e = e + chunk_energy_2e(eri_quartet_kernel(ls, *args(coords)), rows,
                                mult, Dt, Dks, kw)
    return e
