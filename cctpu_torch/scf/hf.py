"""Hartree–Fock: closed-shell RHF and open-shell UHF with DIIS, level
shift and damping.

Port of the f64 path of ``cctpu/scf/hf.py``. The per-cycle work — J/K
build, Fock assembly, DIIS extrapolation, generalized eigensolve — runs
eagerly in torch on the molecule's device; the Python loop checks the
convergence scalars. Supports the ``kernel(dm0=dm)`` warm start. UHF keeps
the two spin densities stacked as [2, nao, nao].

J/K comes from the in-core ERI tensor (``density_fit`` False or None),
the pivoted-Cholesky factor (``"cd"``) or dense density fitting (True).
ROHF, pair-compressed DF and the mixed/f32 precision modes are later
slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Optional

import torch

from cctpu_torch.core import elements as elem
from cctpu_torch.core.basis import (BasisSet, build_basis, get_basis_text,
                                    parse_nwchem)
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.device import DTYPE, default_device
from cctpu_torch.dft.dispersion import dispersion_energy
from cctpu_torch.ints.one_electron import build_int1e_eager
from cctpu_torch.ints.two_electron import (IncoreLR, build_eri_incore,
                                           contract_view, exchange_view)
from cctpu_torch.scf.diis import diis_init, diis_update


class IncoreJK(IncoreLR):
    """J/K from the full in-core ERI tensor, as two matrix products over
    its [nao^2, nao^2] views: J_ij = sum_kl (ij|kl) D_kl on the tensor as
    built, K_ij = sum_kl (ik|jl) D_kl on a copy in exchange order made once
    here (twice the tensor's memory, and no copy per call); K_lr of a
    range-separated functional from the attenuated tensor
    (``IncoreLR``). cctpu computes the same einsums outside any Pallas
    kernel, so no kernel of the port runs here."""

    def __init__(self, mol: Molecule, coords: torch.Tensor):
        self._set(build_eri_incore(mol.basis_set, coords))
        self._init_lr(mol.basis_set, coords)

    @classmethod
    def from_eri(cls, eri: torch.Tensor, lr=None) -> "IncoreJK":
        """A builder on a given (ij|kl) tensor [nao, nao, nao, nao] (another
        package's, say) with no build; ``lr`` {omega: attenuated tensor}
        for a range-separated functional."""
        jk = cls.__new__(cls)
        jk._set(eri)
        jk._init_lr(given={om: exchange_view(e)
                           for om, e in (lr or {}).items()})
        return jk

    def _set(self, eri):
        n2 = eri.shape[0] * eri.shape[1]
        self.eri = eri.reshape(n2, n2)
        self.eri_k = exchange_view(eri)

    def __call__(self, dm, with_k: bool = True, cocc=None):
        """(J, K) of a [nao, nao] or [2, nao, nao] dm (K None without
        ``with_k``); ``cocc`` is not needed."""
        return self.j(dm), (self.k(dm) if with_k else None)

    def j(self, dm):
        """J of a batch of densities [..., nao, nao]."""
        return contract_view(self.eri, dm)

    def k(self, dm):
        """K of a batch of densities [..., nao, nao], none assumed
        symmetric."""
        return contract_view(self.eri_k, dm)


def _aufbau_configuration(z: int) -> dict:
    """Ground-state electron counts keyed by (l, shell-index-within-l),
    e.g. (0,0)=1s, (1,1)=3p, in Aufbau (Madelung) order."""
    order = [(0, 0, 2), (0, 1, 2), (1, 0, 6), (0, 2, 2), (1, 1, 6),
             (0, 3, 2), (2, 0, 10), (1, 2, 6), (0, 4, 2), (2, 1, 10),
             (1, 3, 6), (0, 5, 2), (3, 0, 14), (2, 2, 10), (1, 4, 6)]
    conf = {}
    left = int(z)
    for l, k, cap in order:
        if left <= 0:
            break
        take = min(left, cap)
        conf[(l, k)] = float(take)
        left -= take
    return conf


def _minao_guess(mol: Molecule, coords: torch.Tensor) -> torch.Tensor:
    """SAD density in the molecular basis by projection from STO-3G:
    dm = G D_min G^T with G = S_mol^{-1} S_cross and D_min the
    block-diagonal aufbau occupancies (open shells spherically averaged),
    renormalized to the electron count."""
    mol_bs = mol.basis_set
    min_bs = build_basis(mol.element_symbols, mol.coords, "sto-3g")
    # union basis (deep-copied shells: BasisSet.__init__ rewrites ao_start)
    union = BasisSet(copy.deepcopy(list(mol_bs.shells))
                     + copy.deepcopy(list(min_bs.shells)), mol.coords)
    S_all = build_int1e_eager(union, coords,
                              torch.zeros_like(coords[:, 0]))["S"]
    n1 = mol_bs.nao
    S_mol = S_all[:n1, :n1]
    S_cross = S_all[:n1, n1:]

    occ = []
    for ia, (sym, z) in enumerate(zip(mol.element_symbols,
                                      mol.charges.astype(int))):
        zel = elem.symbol_to_z(sym.split(":")[-1] if ":" in sym else sym)
        conf = _aufbau_configuration(zel if z != 0 else 0)
        counts = {0: 0, 1: 0, 2: 0, 3: 0}   # per-l shell counter
        for sh in min_bs.shells:
            if sh.atom != ia:
                continue
            k = counts[sh.l]
            counts[sh.l] = k + 1
            ne = conf.get((sh.l, k), 0.0) if z != 0 else 0.0
            occ += [ne / (2 * sh.l + 1)] * (2 * sh.l + 1)
    occ = torch.as_tensor(occ, dtype=coords.dtype, device=coords.device)
    G = torch.linalg.solve(S_mol, S_cross)
    dm = (G * occ[None, :]) @ G.T
    ne_now = float(torch.einsum("ij,ij->", dm, S_mol))
    if ne_now > 1e-8:
        dm = dm * (mol.nelectron / ne_now)
    return dm


def _minao_covers(mol: Molecule) -> bool:
    """Whether every element of ``mol`` has an STO-3G table, which the
    minao guess projects from (else the guess is the core Hamiltonian's)."""
    table = parse_nwchem(get_basis_text("sto-3g"))
    return all(el in table for el in mol.element_symbols)


def occ_rhf(mo_energy: torch.Tensor, nelec: int) -> torch.Tensor:
    n = mo_energy.shape[-1]
    return (torch.arange(n, device=mo_energy.device) < nelec // 2).to(
        mo_energy.dtype) * 2.0


def occ_uhf(mo_energy: torch.Tensor, nalpha: int,
            nbeta: int) -> torch.Tensor:
    """[2, n] occupations (alpha, beta) of 1 or 0."""
    idx = torch.arange(mo_energy.shape[-1], device=mo_energy.device)
    return torch.stack([idx < nalpha, idx < nbeta]).to(mo_energy.dtype)


def _orthogonalizer(S: torch.Tensor) -> torch.Tensor:
    """Canonical orthogonalizer X = U s^{-1/2} (X^T S X = I), f64 eigh on
    S's device; near-null overlap directions (s <= 1e-10) are dropped."""
    s, U = torch.linalg.eigh(S)
    keep = s > 1e-10
    s_inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(
        torch.where(keep, s, torch.ones_like(s))), torch.zeros_like(s))
    return U * s_inv_sqrt[None, :]


def _fock_eig(F, X):
    Fp = X.T @ F @ X
    e, Cp = torch.linalg.eigh(Fp)
    return e, X @ Cp


@dataclasses.dataclass
class SCFOptions:
    conv_tol: float = 1e-10
    conv_tol_grad: Optional[float] = None
    max_cycle: int = 100
    diis_space: int = 8
    diis_start: int = 1
    level_shift: float = 0.0
    damp: float = 0.0
    verbose: int = 0
    precision: str = "f64"      # only f64 is ported


class SCFBase:
    """Shared SCF loop. Subclasses define occupations and veff."""

    restricted = True

    def __init__(self, mol: Molecule, density_fit=False,
                 device=None, **opts):
        self.mol = mol.build() if mol._basis_set is None else mol
        self.density_fit = density_fit
        self.opts = SCFOptions(**{k: v for k, v in opts.items()
                                  if hasattr(SCFOptions, k)})
        if self.opts.precision != "f64":
            raise NotImplementedError(
                f"precision={self.opts.precision!r}: only 'f64' is ported "
                "(mixed/f32 is a later slice, ROADMAP.md queue 1)")
        self.device = default_device(device)
        self.coords = torch.as_tensor(self.mol.coords, dtype=DTYPE,
                                      device=self.device)
        self._jk = None
        self._ints = None
        self.converged = False
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.dm = None
        self.n_cycles = 0

    # -- integral setup ------------------------------------------------------
    def build_ints(self):
        if self._ints is None:
            self._ints = build_int1e_eager(
                self.mol.basis_set, self.coords,
                torch.as_tensor(self.mol.charges, dtype=DTYPE,
                                device=self.device))
        return self._ints

    def get_jk_builder(self):
        """The J/K builder of ``density_fit``, built on first use: in-core
        for False or None, pivoted Cholesky for "cd", dense DF for True."""
        if self._jk is None:
            df = self.density_fit
            if df == "compressed":
                raise NotImplementedError(
                    "pair-compressed density fitting is not ported "
                    "(ROADMAP.md queue 1 item 19)")
            if df == "cd":
                from cctpu_torch.ints.df import CholeskyJK
                self._jk = CholeskyJK(self.mol, self.coords)
            elif df:
                from cctpu_torch.ints.df import DFJK
                self._jk = DFJK(self.mol, self.coords)
            else:
                self._jk = IncoreJK(self.mol, self.coords)
        return self._jk

    # -- model-specific pieces ---------------------------------------------
    def get_veff(self, dm, cocc=None):
        raise NotImplementedError

    def _factor_cocc(self, dm):
        """Occupied-orbital factor of a density matrix: the top-nocc
        eigenpairs in descending order, columns scaled by
        sqrt(eigenvalue) (clipped at 0). Exact for an idempotent dm; for a
        guess dm the truncation only perturbs the first Fock. A [2, n, n]
        dm gives one factor per spin, each of at least one column."""
        def one(d, nocc):
            w, U = torch.linalg.eigh(d)
            w = torch.clamp(w.flip(0), min=0.0)
            U = U.flip(1)
            return (U[:, :nocc] * torch.sqrt(w[None, :nocc])).contiguous()
        if dm.ndim == 3:
            return (one(dm[0], max(self.mol.nalpha, 1)),
                    one(dm[1], max(self.mol.nbeta, 1)))
        return one(dm, max(self.mol.nelectron // 2, 1))

    def init_guess_dm(self):
        """Superposition of spherically averaged atomic densities projected
        from STO-3G (cctpu's 'minao' guess), split by spin for UHF; the
        core-Hamiltonian guess when an element has no STO-3G table."""
        if not _minao_covers(self.mol):
            ints = self.build_ints()
            X = _orthogonalizer(ints["S"])
            e, C = _fock_eig(ints["T"] + ints["V"], X)
            return self._dm_from_mo(e, C)
        dm = _minao_guess(self.mol, self.coords)
        if self.restricted:
            return dm
        na, nb = self.mol.nalpha, self.mol.nbeta
        if na == nb:
            # unrestricted singlet: a spin-symmetric guess is a fixed point
            # of the UHF map, so go through the natural orbitals of the
            # minao density and let _dm_from_mo rotate the beta frontier
            # pair
            S = self.build_ints()["S"]
            X = _orthogonalizer(S)
            w, V = torch.linalg.eigh(X.T @ S @ dm @ S @ X)
            order = torch.argsort(-w)
            return self._dm_from_mo(-w[order], X @ V[:, order])
        ne = self.mol.nelectron
        return torch.stack([dm * (na / ne), dm * (nb / ne)])

    def _dm_from_mo(self, e, C):
        raise NotImplementedError

    # -- main loop ---------------------------------------------------------
    def kernel(self, dm0=None) -> float:
        o = self.opts
        ints = self.build_ints()
        S = ints["S"]
        H = ints["T"] + ints["V"]
        self.get_jk_builder()
        dm = (torch.as_tensor(dm0, dtype=DTYPE, device=self.device)
              if dm0 is not None else self.init_guess_dm())
        func = getattr(self, "func", None)
        if func is not None and func.rsh is not None:
            # the attenuated tensors are set-up, not part of cycle 1
            self._jk.prepare_lr(func.rsh[0])
        # the terms constant in dm: nuclear repulsion and dispersion
        e_nuc = self.mol.energy_nuc()
        if func is not None:
            e_nuc += dispersion_energy(func, self.mol)
        conv_tol_grad = o.conv_tol_grad or max(math.sqrt(o.conv_tol), 1e-7)
        # the dE-waiving exit (three cycles below the gradient tolerance)
        # gates on a stricter threshold than the plain conv_tol_grad
        grad_tight = min(conv_tol_grad, 1e-6)

        t0 = time.time()
        cocc = self._factor_cocc(dm)
        X = _orthogonalizer(S)
        diis = diis_init(o.diis_space, dm.numel(), dtype=dm.dtype,
                         device=dm.device)
        e_last = 0.0
        dm_last = dm
        grad_ok = 0
        for cycle in range(o.max_cycle):
            dm_in = dm
            if o.damp > 0 and cycle > 0:
                dm_in = (1 - o.damp) * dm + o.damp * dm_last
                # damped dm no longer matches cocc's factorization
                cocc = self._factor_cocc(dm_in)
            use_diis = cycle >= o.diis_start
            diis, dm_new, cocc, e_elec, err_norm, mo_e, mo_c = self._step(
                H, S, X, diis, dm_in, cocc, use_diis)
            e_tot = float(e_elec) + e_nuc
            g = float(err_norm)
            de = e_tot - e_last
            if o.verbose >= 2:
                print(f"cycle {cycle:3d}  E = {e_tot:.12f}  "
                      f"dE = {de: .3e}  |g| = {g:.3e}")
            dm_last = dm
            dm = dm_new
            grad_ok = grad_ok + 1 if g < grad_tight else 0
            if cycle > 0 and g < conv_tol_grad \
                    and (abs(de) < o.conv_tol or grad_ok >= 3):
                self.converged = True
                break
            e_last = e_tot

        self.e_tot = e_tot
        self.mo_energy = mo_e
        self.mo_coeff = mo_c
        self.mo_occ = self._occ(mo_e)
        self.dm = dm
        self.n_cycles = cycle + 1
        if o.verbose >= 1:
            tag = "converged" if self.converged else "NOT CONVERGED"
            print(f"SCF {tag}: E = {e_tot:.12f} Ha "
                  f"({cycle + 1} cycles, {time.time() - t0:.2f}s)")
        return self.e_tot

    def make_rdm1(self):
        return self.dm

    def dip_moment(self, unit: str = "Debye"):
        """Dipole moment vector (electronic + nuclear), origin at (0,0,0);
        a host numpy array."""
        from cctpu_torch.core.constants import AU2DEBYE
        ints = build_int1e_eager(
            self.mol.basis_set, self.coords,
            torch.as_tensor(self.mol.charges, dtype=DTYPE,
                            device=self.device), with_dipole=True)
        dm = self.dm.sum(0) if self.dm.ndim == 3 else self.dm
        el = -torch.einsum("dij,ij->d", ints["dipole"], dm)
        nuc = torch.einsum("i,ix->x", torch.as_tensor(
            self.mol.charges, dtype=DTYPE, device=self.device), self.coords)
        mu = (el + nuc).cpu().numpy()
        return mu * AU2DEBYE if unit.lower().startswith("d") else mu


class RHF(SCFBase):
    restricted = True

    def _occ(self, mo_e):
        return occ_rhf(mo_e, self.mol.nelectron)

    def _dm_from_mo(self, e, C):
        occ = occ_rhf(e, self.mol.nelectron)
        return (C * occ[None, :]) @ C.T

    def get_veff(self, dm, cocc=None):
        J, K = self._jk(dm, cocc=cocc)
        veff = J - 0.5 * K
        ecoul = 0.5 * torch.einsum("ij,ij->", dm, J)
        exx = -0.25 * torch.einsum("ij,ij->", dm, K)
        return veff, ecoul + exx

    def _step(self, H, S, X, diis, dm, cocc, use_diis):
        """One SCF cycle: Fock build at dm, DIIS, diagonalization."""
        nelec = self.mol.nelectron
        nocc = max(nelec // 2, 1)
        ls = self.opts.level_shift
        veff, e2 = self.get_veff(dm, cocc=cocc)
        F = H + veff
        e_elec = torch.einsum("ij,ij->", dm, H) + e2
        # DIIS error in AO: S D F - F D S (orthonormalized)
        sdf = S @ dm @ F
        err = X.T @ (sdf - sdf.T) @ X
        err_norm = torch.linalg.norm(err)
        diis, F_x = diis_update(diis, F, err)
        F_use = F_x if use_diis else F
        if ls:
            F_use = F_use + ls * (S - S @ (dm * 0.5) @ S)
        mo_e, mo_c = _fock_eig(F_use, X)
        occ = occ_rhf(mo_e, nelec)
        dm_new = (mo_c * occ[None, :]) @ mo_c.T
        cocc_new = (mo_c[:, :nocc] * torch.sqrt(occ[None, :nocc])).contiguous()
        return diis, dm_new, cocc_new, e_elec, err_norm, mo_e, mo_c


class UHF(SCFBase):
    """Unrestricted HF: dm, Fock, orbitals and energies stacked over the
    two spins (alpha, beta)."""

    restricted = False

    def _occ(self, mo_e):
        return occ_uhf(mo_e, self.mol.nalpha, self.mol.nbeta)

    def _dm_from_mo(self, e, C):
        """Spin-restricted orbitals -> (alpha, beta) densities. For
        nalpha == nbeta the beta HOMO/LUMO pair is rotated by 45 degrees:
        a strictly spin-symmetric guess is a fixed point of the UHF map
        (singlet biradicals would converge to the RHF saddle point)."""
        occ = occ_uhf(e, self.mol.nalpha, self.mol.nbeta)
        Cb = C
        nb = self.mol.nbeta
        if self.mol.nalpha == nb and 0 < nb < C.shape[1]:
            h, lo = nb - 1, nb
            c = s = math.sqrt(0.5)
            Cb = C.clone()
            Cb[:, h] = c * C[:, h] - s * C[:, lo]
            Cb[:, lo] = s * C[:, h] + c * C[:, lo]
        dma = (C * occ[0][None, :]) @ C.T
        dmb = (Cb * occ[1][None, :]) @ Cb.T
        return torch.stack([dma, dmb])

    def get_veff(self, dm, cocc=None):
        J, K = self._jk(dm, cocc=cocc)          # [2, n, n] each
        Jtot = J[0] + J[1]
        veff = torch.stack([Jtot - K[0], Jtot - K[1]])
        ecoul = 0.5 * torch.einsum("sij,ij->", dm, Jtot)
        exx = -0.5 * torch.einsum("sij,sij->", dm, K)
        return veff, ecoul + exx

    def _step(self, H, S, X, diis, dm, cocc, use_diis):
        """One SCF cycle on both spins: Fock build at dm, stacked DIIS
        (per-spin error vectors), level shift, per-spin diagonalization."""
        na, nb = self.mol.nalpha, self.mol.nbeta
        na_c, nb_c = max(na, 1), max(nb, 1)
        ls = self.opts.level_shift
        veff, e2 = self.get_veff(dm, cocc=cocc)
        F = H[None] + veff                       # [2, n, n]
        e_elec = torch.einsum("sij,ij->", dm, H) + e2
        sdf = S @ dm @ F
        err = X.T @ (sdf - sdf.transpose(1, 2)) @ X
        err_norm = torch.linalg.norm(err)
        diis, F_x = diis_update(diis, F, err)
        F_use = F_x if use_diis else F
        if ls:
            F_use = F_use + ls * (S - S @ dm @ S)
        ea, Ca = _fock_eig(F_use[0], X)
        eb, Cb = _fock_eig(F_use[1], X)
        mo_e = torch.stack([ea, eb])
        occ = occ_uhf(mo_e, na, nb)
        dm_new = torch.stack([(Ca * occ[0][None, :]) @ Ca.T,
                              (Cb * occ[1][None, :]) @ Cb.T])
        # nbeta = 0 keeps one zero column (a K of 0, through the kernel)
        cocc_new = ((Ca[:, :na_c] * torch.sqrt(occ[0][None, :na_c]))
                    .contiguous(),
                    (Cb[:, :nb_c] * torch.sqrt(occ[1][None, :nb_c]))
                    .contiguous())
        return (diis, dm_new, cocc_new, e_elec, err_norm, mo_e,
                torch.stack([Ca, Cb]))

    def spin_square(self):
        """(<S^2>, multiplicity 2S+1) of the converged UHF determinant."""
        S = self.build_ints()["S"]
        na, nb = self.mol.nalpha, self.mol.nbeta
        ovlp = self.mo_coeff[0][:, :na].T @ S @ self.mo_coeff[1][:, :nb]
        sz = 0.5 * (na - nb)
        s2 = sz * sz + sz + nb - float(torch.sum(ovlp * ovlp))
        return s2, 2 * math.sqrt(s2 + 0.25)
