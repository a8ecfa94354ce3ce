"""Density fitting: automatic auxiliary basis, 3c2e/2c2e integrals, DF-J/K.

Port of the production DF path of ``cctpu/ints/df.py``. With
B[P,i,j] = sum_Q Linv[P,Q] (Q|ij) and M^+ = Linv^T Linv, the SCF hot loop
is J = B^T (B.D) and K from occupied orbitals, run by the Hopper kernels
of ``cctpu_torch/ops/`` on the card (``df_jk``: fused closed-shell J+K;
``df_j``: J alone or for two spins; ``df_k``: K per spin).

Everything is built on the device in f64: the quartet kernel fills X and
the metric class by class, ``metric_factor`` whitens on the device (eigh)
or, for large aux sets, selects a well-conditioned subset with LAPACK's
pivoted Cholesky on the host, and B = Linv @ X is one f64 matmul.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, Shell, normalize_contraction, nsph
from cctpu_torch.device import as_tensor
from cctpu_torch.ints.two_electron import (class_chunk, eri_quartet_kernel,
                                           pair_classes, schwarz_q)
from cctpu_torch.ops.df_j import df_j_fast
from cctpu_torch.ops.df_jk import df_jk_fused
from cctpu_torch.ops.df_k import df_k_fast

# naux above which metric_factor switches from eigh to pivoted-Cholesky
# subset selection (the same switch point as cctpu's _EIGH_NAUX_MAX)
_EIGH_NAUX_MAX = 3072


def autoaux(basis: BasisSet, beta: float = 1.8, extra_l: int = 2,
            lmax_cap: int = 4) -> BasisSet:
    """Even-tempered auto-generated auxiliary basis for Coulomb/exchange
    fitting, built per atom from the products of orbital primitives
    (same construction as cctpu's autoaux)."""
    per_atom = {}
    for sh in basis.shells:
        d = per_atom.setdefault(sh.atom, {})
        d.setdefault(sh.l, []).extend([float(e) for e in sh.exps])

    aux_shells = []
    for atom, ldata in sorted(per_atom.items()):
        lmax_orb = max(ldata)
        for laux in range(min(2 * lmax_orb + extra_l, lmax_cap) + 1):
            lreq = min(laux, 2 * lmax_orb)
            prods = [a + b
                     for l1, e1 in ldata.items()
                     for l2, e2 in ldata.items() if l1 + l2 >= lreq
                     for a in e1 for b in e2]
            if not prods:
                continue
            amin = min(prods) / beta
            amax = max(prods)
            if laux > 0:
                # high-l fitting channels don't need core-steep exponents
                amax = min(amax, max(60.0, 30.0 * amin))
            n = max(1, int(math.ceil(math.log(amax / amin) / math.log(beta))))
            for k in range(n + 1):
                earr = np.array([amin * beta ** k])
                carr = normalize_contraction(laux, earr, np.array([1.0]))
                aux_shells.append(Shell(atom=atom, l=laux, exps=earr,
                                        coefs=carr))
    aux_shells.sort(key=lambda s: (s.atom, s.l))
    natm = max(sh.atom for sh in basis.shells) + 1
    atom_coords = np.zeros((natm, 3))
    for l, g in basis.groups.items():
        atom_coords[g.atom_idx] = g.centers
    return BasisSet(aux_shells, atom_coords)


class _AuxTables:
    """One aux l-group's (exps, coefs, centers) on the device, plus the
    dummy s-function (exponent 0, coefficient 1) that turns a 4-center
    quartet kernel into a 2- or 3-center one."""

    def __init__(self, g, coords):
        dev, dt = coords.device, coords.dtype
        self.e = torch.as_tensor(g.exps, dtype=dt, device=dev)
        self.c = torch.as_tensor(g.coefs, dtype=dt, device=dev)
        self.xyz = coords[torch.as_tensor(g.atom_idx, device=dev)]
        self.de = torch.zeros(1, dtype=dt, device=dev)
        self.dc = torch.ones(1, dtype=dt, device=dev)

    def bra(self, i):
        """(eP, cP, P, e_dummy, c_dummy, P) for aux shells ``i``."""
        n = len(i)
        return (self.e[i], self.c[i], self.xyz[i],
                self.de.expand(n, 1), self.dc.expand(n, 1), self.xyz[i])


def _aux_schwarz_max(aux: BasisSet, coords) -> float:
    """max_P sqrt((P|P)) over the auxiliary set (screening bound)."""
    q_max = 1e-30
    for lP in sorted(aux.groups):
        tab = _AuxTables(aux.groups[lP], coords)
        i = torch.arange(len(aux.groups[lP].shell_idx), device=coords.device)
        blk = eri_quartet_kernel((lP, 0, lP, 0), *tab.bra(i), *tab.bra(i))
        diag = torch.abs(torch.einsum("qaa->qa", blk[:, :, 0, :, 0]))
        q_max = max(q_max, float(torch.sqrt(diag.max())))
    return q_max


def build_3c2e(basis: BasisSet, aux: BasisSet, coords,
               screen_tol: float = 1e-12) -> torch.Tensor:
    """(P|ab) tensor [naux, nao, nao] on ``coords``' device.

    One quartet-kernel batch per (aux l-group, AO pair class) chunk, then a
    scatter of the blocks and their ab<->ba mirrors. AO pairs with
    Q_ab * max_P Q_P below ``screen_tol`` are skipped (|(P|ab)| <=
    Q_P Q_ab), the same Schwarz selection as cctpu's production builder."""
    dev = coords.device
    naux, nao = aux.nao, basis.nao
    out = torch.zeros((naux, nao, nao), dtype=coords.dtype, device=dev)
    pcs = pair_classes(basis)
    qs = schwarz_q(pcs, coords) if screen_tol > 0 else None
    q_aux_max = _aux_schwarz_max(aux, coords) if screen_tol > 0 else 1.0
    pair_tabs = [pc.tables(coords) for pc in pcs]
    for lP in sorted(aux.groups):
        gP = aux.groups[lP]
        tabP = _AuxTables(gP, coords)
        sP = nsph(lP)
        for ipc, pc in enumerate(pcs):
            pair_sel = np.arange(pc.n, dtype=np.int64)
            if qs is not None:
                keep = (qs[ipc] * q_aux_max > screen_tol).cpu().numpy()
                pair_sel = pair_sel[keep]
                if len(pair_sel) == 0:
                    continue
            ls = (lP, 0, pc.la, pc.lb)
            q1, q2 = np.mgrid[0:len(gP.shell_idx), 0:len(pair_sel)]
            q1 = q1.ravel()
            q2 = pair_sel[q2.ravel()]
            chunk = class_chunk(ls, gP.exps.shape[1], 1,
                                pc.exps_a.shape[1], pc.exps_b.shape[1])
            sa, sb = nsph(pc.la), nsph(pc.lb)
            for s in range(0, len(q1), chunk):
                i1 = torch.as_tensor(q1[s:s + chunk], device=dev)
                i2 = torch.as_tensor(q2[s:s + chunk], device=dev)
                ket = tuple(x[i2] for x in pair_tabs[ipc])
                blocks = eri_quartet_kernel(ls, *tabP.bra(i1), *ket)
                blocks = blocks[:, :, 0]                 # [nq, sP, sa, sb]
                pi = torch.as_tensor(gP.ao_start[q1[s:s + chunk]][:, None]
                                     + np.arange(sP), device=dev)
                ai = torch.as_tensor(pc.ao_a[q2[s:s + chunk]][:, None]
                                     + np.arange(sa), device=dev)
                bi = torch.as_tensor(pc.ao_b[q2[s:s + chunk]][:, None]
                                     + np.arange(sb), device=dev)
                P_, A_, B_ = (pi[:, :, None, None], ai[:, None, :, None],
                              bi[:, None, None, :])
                out[P_, A_, B_] = blocks
                out[P_, B_.transpose(2, 3), A_.transpose(2, 3)] = \
                    blocks.transpose(2, 3)
    return out


def build_2c2e(aux: BasisSet, coords) -> torch.Tensor:
    """(P|Q) Coulomb metric [naux, naux] on ``coords``' device."""
    dev = coords.device
    naux = aux.nao
    out = torch.zeros((naux, naux), dtype=coords.dtype, device=dev)
    ls_sorted = sorted(aux.groups)
    for i, lP in enumerate(ls_sorted):
        gP = aux.groups[lP]
        tabP = _AuxTables(gP, coords)
        for lQ in ls_sorted[i:]:
            gQ = aux.groups[lQ]
            tabQ = _AuxTables(gQ, coords)
            q1, q2 = np.mgrid[0:len(gP.shell_idx), 0:len(gQ.shell_idx)]
            q1, q2 = q1.ravel(), q2.ravel()
            if lP == lQ:
                keep = q1 <= q2
                q1, q2 = q1[keep], q2[keep]
            ls = (lP, 0, lQ, 0)
            chunk = class_chunk(ls, gP.exps.shape[1], 1, gQ.exps.shape[1], 1)
            sP, sQ = nsph(lP), nsph(lQ)
            for s in range(0, len(q1), chunk):
                s1, s2 = q1[s:s + chunk], q2[s:s + chunk]
                blocks = eri_quartet_kernel(
                    ls, *tabP.bra(torch.as_tensor(s1, device=dev)),
                    *tabQ.bra(torch.as_tensor(s2, device=dev)))
                blocks = blocks[:, :, 0, :, 0]           # [nq, sP, sQ]
                pi = torch.as_tensor(gP.ao_start[s1][:, None]
                                     + np.arange(sP), device=dev)
                qi = torch.as_tensor(gQ.ao_start[s2][:, None]
                                     + np.arange(sQ), device=dev)
                out[pi[:, :, None], qi[:, None, :]] = blocks
                out[qi[:, :, None], pi[:, None, :]] = blocks.transpose(1, 2)
    return out


def metric_factor(M: torch.Tensor, rcond: float = 1e-11,
                  method: str = "auto") -> torch.Tensor:
    """Whitening factor Linv of the Coulomb metric: M^+ = Linv^T Linv
    (pseudo-inverse on the well-conditioned subspace). Linv may be
    RECTANGULAR [nkeep, naux]: near-null directions are dropped.

    Both paths filter on the diagonally preconditioned metric
    M' = D^{-1/2} M D^{-1/2}, D = diag(M):

    - ``eigh`` (naux <= 3072): f64 ``torch.linalg.eigh`` on M's device,
      keeping eigenvalues > rcond * max.
    - ``pivot`` (larger): LAPACK dpstrf pivoted Cholesky on the host
      SELECTS a well-conditioned aux subset (rank r where the Schur
      complement falls below rcond), then whitens exactly on it. The
      metric is only naux^2 elements, so the host trip is cheap.
    """
    naux = M.shape[0]
    if method == "auto":
        method = "eigh" if naux <= _EIGH_NAUX_MAX else "pivot"
    if method == "pivot":
        from scipy.linalg import solve_triangular
        from scipy.linalg.lapack import dpstrf
        M_np = M.cpu().numpy()
        d_np = np.sqrt(np.clip(np.diagonal(M_np).copy(), 1e-300, None))
        Mh = M_np / d_np[:, None] / d_np[None, :]
        _, piv, rank, info = dpstrf(Mh, tol=rcond, lower=1)
        if info >= 0 and 0 < rank <= naux:
            piv = np.asarray(piv[:rank]) - 1          # LAPACK is 1-based
            Msub = Mh[np.ix_(piv, piv)]
            try:
                L = np.linalg.cholesky(Msub)
            except np.linalg.LinAlgError:
                L = None                # kept subset still too dependent
            if L is not None:
                Linv_sub = solve_triangular(L, np.eye(rank), lower=True,
                                            check_finite=False)
                Linv = np.zeros((rank, naux))
                Linv[:, piv] = Linv_sub
                return torch.as_tensor(Linv / d_np[None, :], dtype=M.dtype,
                                       device=M.device)
        # dpstrf/Cholesky breakdown (shouldn't happen for PSD) -> eigh
    d = torch.sqrt(torch.clamp(torch.diagonal(M), min=1e-300))
    Mp = M / d[:, None] / d[None, :]
    w, V = torch.linalg.eigh(Mp)
    keep = w > rcond * w[-1]
    inv_sqrt = 1.0 / torch.sqrt(w[keep])
    Linv = (V[:, keep] * inv_sqrt[None, :]).T
    return Linv / d[None, :]


class _BContractions:
    """J/K contractions over a factor tensor B [naux, nao, nao]
    ((ij|kl) ~= sum_P B[P,i,j] B[P,k,l]).

    Every branch but the dm-contracted K runs a Hopper kernel on the card
    and its plain torch twin on the CPU: the fused J+K for a closed-shell
    cocc, ``df_j_fast`` for J otherwise (both spins in one pass for a
    [2, nao, nao] dm), and ``df_k_fast`` once per spin of a tuple cocc."""

    def _k_of(self, B, dm, cocc):
        """Exchange via B: occupied-orbital form when cocc is given
        (exact for dm = C C^T; C columns carry sqrt(occupation)), else the
        dm contraction."""
        if cocc is None:
            if B.is_cuda:
                raise NotImplementedError(
                    "DF K contracted with dm (cocc=None) has no kernel on "
                    "the card: cctpu has no TPU kernel for it and only "
                    "response code uses it (ROADMAP.md queue 2 item 5)")
            return torch.einsum("pik,...kl,pjl->...ij", B, dm, B)
        if isinstance(cocc, (tuple, list)):          # spin-resolved
            return torch.stack([self._k_of(B, None, c) for c in cocc])
        return df_k_fast(B, cocc.contiguous())

    def __call__(self, dm, with_k: bool = True, cocc=None):
        B = self.B
        if (dm.ndim == 2 and with_k and cocc is not None
                and not isinstance(cocc, (tuple, list))):
            # the fused single-pass J+K (the kernels take row-major
            # tensors; a caller's dm0 need not be)
            return df_jk_fused(B, dm.contiguous(), cocc.contiguous())
        # K first: the one branch without a kernel raises before any launch
        K = self._k_of(B, dm, cocc) if with_k else None
        return df_j_fast(B, dm.contiguous()), K


class DFJK(_BContractions):
    """Density-fitted J/K builder.

    B[P,i,j] = sum_Q Linv[P,Q] (Q|ij), built on ``coords``' device:
      1. (P|Q) and (P|ab) from the quartet kernel, class by class,
      2. Linv from ``metric_factor``,
      3. B = Linv @ X as one f64 matmul (X freed right after).
    """

    def __init__(self, mol, coords=None, beta: float = 1.8,
                 extra_l: int = 2, lmax_cap: int = 4):
        if coords is None:
            coords = as_tensor(mol.coords)
        basis = mol.basis_set
        self.aux = autoaux(basis, beta=beta, extra_l=extra_l,
                           lmax_cap=lmax_cap)
        naux, nao = self.aux.nao, basis.nao
        M = build_2c2e(self.aux, coords)
        # kept for the DF nuclear gradient: M^+ = Linv^T Linv
        self._Linv = metric_factor(M)
        del M
        X = build_3c2e(basis, self.aux, coords)
        B = self._Linv @ X.reshape(naux, nao * nao)
        del X
        self.B = B.reshape(self._Linv.shape[0], nao, nao)
