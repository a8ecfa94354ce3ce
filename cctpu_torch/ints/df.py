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

``CholeskyJK`` runs the same contractions on another factor: the pivoted
Cholesky vectors of the in-core ERI tensor (``cholesky_B``), exact to the
decomposition's tolerance.

The long-range exchange of a range-separated functional: ``DFJK`` runs
``df_k`` on B_lr, the same factor of the erf-attenuated integrals (its
metric factored at rcond 1e-10, as cctpu's); ``CholeskyJK`` contracts the
attenuated in-core tensor, as cctpu does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, Shell, normalize_contraction
from cctpu_torch.device import as_tensor
from cctpu_torch.ints.two_electron import (CHUNK_BUDGET, IncoreLR, LRCache,
                                           Shells, build_eri_incore,
                                           class_chunk,
                                           eri_quartet_kernel, pair_classes,
                                           schwarz_q)
from cctpu_torch.ops.df_j import df_j_fast
from cctpu_torch.ops.df_jk import df_jk_fused
from cctpu_torch.ops.df_k import df_k_fast
from cctpu_torch.ops.df_k_dm import df_k_dm

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


# Schwarz screening threshold of the 3c2e walk: an AO pair is skipped when
# Q_ab * max_P Q_P falls below it (|(P|ab)| <= Q_P Q_ab)
SCREEN_TOL = 1e-12
# the pivoted Cholesky's stop: the largest residual diagonal (cctpu's tol)
CHOLESKY_TOL = 1e-9


def _aux_shells(aux: BasisSet, dev, dt):
    return {l: Shells.of_group(l, g, dev, dt) for l, g in aux.groups.items()}


def _aux_schwarz_max(aux: BasisSet, coords) -> float:
    """max_P sqrt((P|P)) over the auxiliary set (screening bound)."""
    q_max = 1e-30
    for lP, sh in _aux_shells(aux, coords.device, coords.dtype).items():
        i = torch.arange(len(aux.groups[lP].shell_idx), device=coords.device)
        blk = eri_quartet_kernel((lP, 0, lP, 0), *sh.bra(i, coords),
                                 *sh.bra(i, coords))
        diag = torch.abs(torch.einsum("qaa->qa", blk[:, :, 0, :, 0]))
        q_max = max(q_max, float(torch.sqrt(diag.max())))
    return q_max


def walk_3c2e(basis: BasisSet, aux: BasisSet, coords,
              budget: int = CHUNK_BUDGET):
    """The quartet-kernel chunks that make up (P|ab): one class per (aux
    l-group, AO pair class), each AO pair once, with the pairs that the
    Schwarz bound at ``coords`` puts below ``SCREEN_TOL`` skipped (cctpu's
    production selection), cut into chunks of ``class_chunk(..., budget)``
    quartets. The one walk of both ``build_3c2e`` and the nuclear gradient
    (``grad/df_grad.py``), so the gradient differentiates the integrals the
    SCF used.

    Yields (ls, args, (P, A, B), mult): ``args(c)`` is the kernel's argument
    tuple with the centers gathered from ``c``; P, A, B broadcast to the
    AO indices [nq, sP, sa, sb] of the blocks ``kernel(...)[:, :, 0]``;
    ``mult`` [nq] is 0.5 for a pair of one shell with itself, else 1."""
    dev, dt = coords.device, coords.dtype
    pcs = pair_classes(basis)
    with torch.no_grad():
        qs = schwarz_q(pcs, coords.detach())
        q_aux_max = _aux_schwarz_max(aux, coords.detach())
    auxs = _aux_shells(aux, dev, dt)
    sides = [pc.shells(dev, dt) for pc in pcs]
    for lP in sorted(aux.groups):
        gP, shP = aux.groups[lP], auxs[lP]
        for ipc, pc in enumerate(pcs):
            keep = (qs[ipc] * q_aux_max > SCREEN_TOL).cpu().numpy()
            pair_sel = np.arange(pc.n, dtype=np.int64)[keep]
            if len(pair_sel) == 0:
                continue
            ls = (lP, 0, pc.la, pc.lb)
            q1, q2 = np.mgrid[0:len(gP.shell_idx), 0:len(pair_sel)]
            q1 = q1.ravel()
            q2 = pair_sel[q2.ravel()]
            same = (pc.ia[q2] == pc.ib[q2]) if pc.la == pc.lb \
                else np.zeros(len(q2), bool)
            mult = torch.as_tensor(np.where(same, 0.5, 1.0), dtype=dt,
                                   device=dev)
            q1, q2 = (torch.as_tensor(q, device=dev) for q in (q1, q2))
            chunk = class_chunk(ls, gP.exps.shape[1], 1, pc.exps_a.shape[1],
                                pc.exps_b.shape[1], budget=budget)
            shA, shB = sides[ipc]
            for s in range(0, len(q1), chunk):
                i1, i2 = q1[s:s + chunk], q2[s:s + chunk]

                def args(c, i1=i1, i2=i2, shA=shA, shB=shB, shP=shP):
                    return (*shP.bra(i1, c), *shA.at(i2, c), *shB.at(i2, c))

                rows = (shP.rows(i1)[:, :, None, None],
                        shA.rows(i2)[:, None, :, None],
                        shB.rows(i2)[:, None, None, :])
                yield ls, args, rows, mult[s:s + chunk]


def walk_2c2e(aux: BasisSet, coords, budget: int = CHUNK_BUDGET):
    """The quartet-kernel chunks that make up the metric (P|Q): aux
    l-groups lP <= lQ, shells q1 <= q2 within one l, cut as ``walk_3c2e``
    cuts. Yields (ls, args, (P, Q), mult): P, Q broadcast to the AO indices
    [nq, sP, sQ] of the blocks ``kernel(...)[:, :, 0, :, 0]``; ``mult`` is
    0.5 on q1 == q2 within one l, else 1."""
    dev, dt = coords.device, coords.dtype
    auxs = _aux_shells(aux, dev, dt)
    ls_sorted = sorted(aux.groups)
    for i, lP in enumerate(ls_sorted):
        gP = aux.groups[lP]
        for lQ in ls_sorted[i:]:
            gQ = aux.groups[lQ]
            q1, q2 = np.mgrid[0:len(gP.shell_idx), 0:len(gQ.shell_idx)]
            q1, q2 = q1.ravel(), q2.ravel()
            if lP == lQ:
                keep = q1 <= q2
                q1, q2 = q1[keep], q2[keep]
            mult = torch.as_tensor(np.where((lP == lQ) & (q1 == q2), 0.5,
                                            1.0), dtype=dt, device=dev)
            q1, q2 = (torch.as_tensor(q, device=dev) for q in (q1, q2))
            ls = (lP, 0, lQ, 0)
            chunk = class_chunk(ls, gP.exps.shape[1], 1, gQ.exps.shape[1], 1,
                                budget=budget)
            shP, shQ = auxs[lP], auxs[lQ]
            for s in range(0, len(q1), chunk):
                i1, i2 = q1[s:s + chunk], q2[s:s + chunk]

                def args(c, i1=i1, i2=i2, shP=shP, shQ=shQ):
                    return (*shP.bra(i1, c), *shQ.bra(i2, c))

                rows = (shP.rows(i1)[:, :, None], shQ.rows(i2)[:, None, :])
                yield ls, args, rows, mult[s:s + chunk]


def build_3c2e(basis: BasisSet, aux: BasisSet, coords,
               omega: Optional[float] = None,
               budget: int = CHUNK_BUDGET) -> torch.Tensor:
    """(P|ab) tensor [naux, nao, nao] on ``coords``' device: the blocks of
    ``walk_3c2e``'s chunks (at ``budget``) and their ab<->ba mirrors,
    scattered; of the erf-attenuated operator with ``omega`` (on the
    Coulomb operator's Schwarz selection, as cctpu: the attenuated
    integrals are smaller)."""
    naux, nao = aux.nao, basis.nao
    out = torch.zeros((naux, nao, nao), dtype=coords.dtype,
                      device=coords.device)
    for ls, args, (P_, A_, B_), _ in walk_3c2e(basis, aux, coords,
                                               budget=budget):
        blocks = eri_quartet_kernel(ls, *args(coords), omega=omega)[:, :, 0]
        out[P_, A_, B_] = blocks
        out[P_, B_.transpose(2, 3), A_.transpose(2, 3)] = \
            blocks.transpose(2, 3)
    return out


def build_2c2e(aux: BasisSet, coords,
               omega: Optional[float] = None) -> torch.Tensor:
    """(P|Q) Coulomb metric [naux, naux] on ``coords``' device (the
    erf-attenuated one with ``omega``)."""
    naux = aux.nao
    out = torch.zeros((naux, naux), dtype=coords.dtype, device=coords.device)
    for ls, args, (P_, Q_), _ in walk_2c2e(aux, coords):
        blocks = eri_quartet_kernel(ls, *args(coords),
                                    omega=omega)[:, :, 0, :, 0]
        out[P_, Q_] = blocks
        out[Q_.transpose(1, 2), P_.transpose(1, 2)] = blocks.transpose(1, 2)
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


def eigh_whiten(X: torch.Tensor, M: torch.Tensor,
                rcond: float) -> torch.Tensor:
    """B = (V w^-1/2)^T X [nkeep-padded naux, nao, nao] from (P|ab) X and
    the metric M = V diag(w) V^T, the eigenvalues at or below ``rcond``
    times the largest given weight 0: cctpu's ``hessian/cphf.py::_traced_B``
    (plain eigh, no diagonal preconditioning, unlike ``metric_factor``),
    differentiable twice through ``torch.linalg.eigh``."""
    w, V = torch.linalg.eigh(M)
    keep = w > rcond * torch.max(w)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(
        torch.where(keep, w, torch.ones_like(w))), torch.zeros_like(w))
    naux = X.shape[0]
    return ((V * inv_sqrt[None, :]).T
            @ X.reshape(naux, -1)).reshape(X.shape)


class _BContractions:
    """J/K contractions over a factor tensor B [naux, nao, nao]
    ((ij|kl) ~= sum_P B[P,i,j] B[P,k,l]).

    Every branch runs a Hopper kernel on the card and its plain torch twin
    on the CPU: the fused J+K for a closed-shell cocc, ``df_j_fast`` for J
    otherwise (both spins in one pass for a [2, nao, nao] dm),
    ``df_k_fast`` once per spin of a tuple cocc, and ``df_k_dm`` for K of
    densities without an occupied factor (any [..., nao, nao] batch: the
    TDDFT transition densities)."""

    def _k_of(self, B, dm, cocc):
        """Exchange via B: occupied-orbital form when cocc is given
        (exact for dm = C C^T; C columns carry sqrt(occupation)), else the
        dm contraction."""
        if cocc is None:
            return df_k_dm(B, dm)
        if isinstance(cocc, (tuple, list)):          # spin-resolved
            return torch.stack([self._k_of(B, None, c) for c in cocc])
        return df_k_fast(B, cocc.contiguous())

    def j(self, dm):
        """J of a batch of densities [nset, nao, nao] (any nset):
        ``df_j_fast`` on two densities a call."""
        return torch.cat([df_j_fast(self.B, dm[s:s + 2].contiguous())
                          for s in range(0, dm.shape[0], 2)])

    def k(self, dm):
        """K of densities without an occupied factor, [..., nao, nao] (the
        TDDFT transition densities): one ``df_k_dm`` call."""
        return self._k_of(self.B, dm, None)

    def __call__(self, dm, with_k: bool = True, cocc=None):
        B = self.B
        if (dm.ndim == 2 and with_k and cocc is not None
                and not isinstance(cocc, (tuple, list))):
            # the fused single-pass J+K (the kernels take row-major
            # tensors; a caller's dm0 need not be)
            return df_jk_fused(B, dm.contiguous(), cocc.contiguous())
        K = self._k_of(B, dm, cocc) if with_k else None
        return df_j_fast(B, dm.contiguous()), K


class DFJK(_BContractions, LRCache):
    """Density-fitted J/K builder.

    B[P,i,j] = sum_Q Linv[P,Q] (Q|ij), built on ``coords``' device:
      1. (P|Q) and (P|ab) from the quartet kernel, class by class,
      2. Linv from ``metric_factor``,
      3. B = Linv @ X as one f64 matmul (X freed right after).
    The long-range exchange of a range-separated functional runs the same
    contractions on B_lr, built the same way from the erf-attenuated
    integrals (``prepare_lr``).
    """

    def __init__(self, mol, coords=None, beta: float = 1.8,
                 extra_l: int = 2, lmax_cap: int = 4):
        if coords is None:
            coords = as_tensor(mol.coords)
        basis = mol.basis_set
        self.aux = autoaux(basis, beta=beta, extra_l=extra_l,
                           lmax_cap=lmax_cap)
        self._init_lr(basis, coords)
        # kept for the DF nuclear gradient: M^+ = Linv^T Linv
        self.B, self._Linv = self._factor()

    def _factor(self, omega=None):
        """(B, Linv) of the Coulomb operator, or (B_lr, Linv_lr) of the
        erf-attenuated one with ``omega``, its metric factored at rcond
        1e-10 (cctpu's ``_ensure_lr``)."""
        basis, coords = self._basis, self._coords
        naux, nao = self.aux.nao, basis.nao
        M = build_2c2e(self.aux, coords, omega)
        Linv = metric_factor(M) if omega is None else \
            metric_factor(M, rcond=1e-10)
        del M
        X = build_3c2e(basis, self.aux, coords, omega)
        B = Linv @ X.reshape(naux, nao * nao)
        del X
        return B.reshape(Linv.shape[0], nao, nao), Linv

    _build_lr = _factor

    def k_lr(self, dm, omega: float, cocc=None):
        """Long-range exchange K_lr through B_lr (``prepare_lr``):
        ``df_k_fast`` on B_lr per occupied factor, ``df_k_dm`` for
        densities without one, on the card (their plain twins on the
        CPU)."""
        return self._k_of(self.prepare_lr(omega)[0], dm, cocc)

    @classmethod
    def from_tensors(cls, aux: BasisSet, B: torch.Tensor,
                     Linv: torch.Tensor, lr=None) -> "DFJK":
        """A builder on a given aux basis, B [nkeep, nao, nao] and Linv
        [nkeep, naux] (another package's DF tensors, say) with no build;
        ``lr`` {omega: (B_lr, Linv_lr)} for a range-separated
        functional."""
        jk = cls.__new__(cls)
        jk.aux, jk.B, jk._Linv = aux, B, Linv
        jk._init_lr(given=lr)
        return jk


def cholesky_B(mol, coords: torch.Tensor) -> torch.Tensor:
    """Pivoted (Beebe-Linderberg) Cholesky factor of the ERI supermatrix,
    B [K, nao, nao] on ``coords``' device with (ij|kl) = sum_P B[P,i,j]
    B[P,k,l] up to a residual diagonal below ``CHOLESKY_TOL``, so |E -
    E_incore| is of that order (the 1e-8 Ha contract path), where
    basis-set density fitting errs by ~1e-6 Ha.

    M is the [nao^2, nao^2] view of ``build_eri_incore``'s tensor. Each
    step takes the largest residual diagonal (the first on ties) and one
    matrix-vector product of the vectors so far, col = M[:, p] - V^T V[:,
    p], and stops when that diagonal falls below ``CHOLESKY_TOL``; B is
    then symmetrized in (i, j), as cctpu does. One host read per step."""
    n = mol.nao
    M = build_eri_incore(mol.basis_set, coords).reshape(n * n, n * n)
    diag = torch.diagonal(M).clone()
    V = torch.empty((8 * n, n * n), dtype=M.dtype, device=M.device)
    k = 0
    while k < n * n:
        dmax, p = torch.max(diag, 0)
        dmax_h, p_h = torch.stack([dmax, p.to(dmax.dtype)]).tolist()
        if dmax_h < CHOLESKY_TOL:
            break
        if k == V.shape[0]:
            V = torch.cat([V, torch.empty_like(V)])
        p_h = int(p_h)
        v = (M[:, p_h] - V[:k].T @ V[:k, p_h]) / torch.sqrt(dmax)
        V[k] = v
        diag = torch.clamp(diag - v * v, min=0.0)
        k += 1
    del M
    B = V[:k].reshape(k, n, n)
    return 0.5 * (B + B.transpose(1, 2))


class CholeskyJK(_BContractions, IncoreLR):
    """J/K from the pivoted-Cholesky factor (``cholesky_B``): the same
    contractions, and so the same Hopper kernels, as ``DFJK``, on a factor
    exact to ``CHOLESKY_TOL``. Long-range exchange comes from the
    attenuated in-core tensor (``IncoreLR``), as in cctpu."""

    def __init__(self, mol, coords: torch.Tensor):
        self.B = cholesky_B(mol, coords)
        self._init_lr(mol.basis_set, coords)
