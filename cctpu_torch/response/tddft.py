"""TDDFT / TDA excited states (UV-Vis), Davidson-solved.

Port of ``cctpu/response/tddft.py``: the A-matrix action is an AO-basis
contraction on the SCF's device, batched over the Davidson block: J of the
transition densities through the SCF's J/K builder (``df_j_fast``, two
densities a call, on DF and Cholesky factors; the in-core product), K of
the whole batch in one call (``df_k_dm`` on DF and Cholesky factors, the
in-core product), K_lr of a range-separated functional through the
builder's ``k_lr`` (``df_k_dm`` on B_lr), and the XC kernel's action
(``dft/rks.py::fxc_operator``, set up once per TDDFT: cctpu's ``jax.jvp``
through its AD vxc). The host runs the Davidson solvers
(``response/davidson.py``) on numpy arrays.

TDA (CIS-like) uses the Hermitian Davidson; full TDDFT (RPA) solves the
Casida problem densely up to 600 single excitations and by the paired
Davidson above, with cctpu's thresholds and normalization. Restricted
references give singlets; UHF/UKS references the spin-resolved space.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cctpu_torch.core.constants import HARTREE2EV
from cctpu_torch.ints.one_electron import build_int1e_eager
from cctpu_torch.response.davidson import davidson, rpa_davidson
from cctpu_torch.utils.profiling import phase


class TDDFT:
    """td = TDDFT(mf); td.nstates = N; td.kernel() — cctpu's API. With
    ``timer`` (a ``utils.profiling.PhaseTimer``) the matvecs' seconds go
    to its phases ``J``, ``K``, ``K_lr``, ``fxc`` and ``matvec`` (the
    whole of each matvec call, transfers included); ``n_matvec`` counts
    the vectors the operators were applied to, ``wall_s`` is the last
    ``kernel()``'s seconds."""

    def __init__(self, mf, nstates: int = 5, tda: bool = False,
                 singlet: bool = True, timer=None):
        self.mf = mf
        self.nstates = nstates
        self.tda = tda
        self.singlet = singlet
        self.timer = timer
        self.n_matvec = 0
        self.wall_s = None
        self.e = None                 # excitation energies (Ha)
        self.xy = None                # (X, Y) amplitudes, Y=0 for TDA
        self.converged = False

    # -- operator pieces -----------------------------------------------------
    def _setup_common(self):
        mf = self.mf
        func = getattr(mf, "func", None)
        self.ax = 1.0 if func is None else func.hyb
        self.rsh = None if func is None else func.rsh
        self.has_xc = func is not None and func.exc is not None
        self._fxc = None
        self.jk = mf.get_jk_builder()
        if self.rsh is not None:
            self.jk.prepare_lr(self.rsh[0])

    def fxc(self, P):
        """The XC kernel's action on a batch of densities P
        (``dft/rks.py::fxc_operator`` at the SCF's density), built on the
        first call: (A-B) alone never needs it."""
        if self._fxc is None:
            self._fxc = self.mf.fxc_operator(self.mf.dm)
        return self._fxc(P)

    def _v_ao(self, P, mode, singlet):
        """The AO-basis response of a batch of transition densities P
        [nvec, nao, nao] (restricted: the total; V gets J with weight 2
        for the singlet spin sum and fxc + fxc^T) or [nvec, 2, nao, nao]
        (the two spins: J of the total, 0.5 (fxc_s + fxc_s^T)).

        TDA  : V = 2 J(P) - ax K(P) - beta K_lr(P) + fxc terms
        A+B  : the same with P -> P + P^T
        A-B  : V = -ax K(P - P^T) - beta K_lr(P - P^T)
        (J and fxc of an antisymmetric density vanish)."""
        jk, t = self.jk, self.timer
        if mode == "apb":
            P = P + P.transpose(-1, -2)
        elif mode == "amb":
            P = P - P.transpose(-1, -2)
        unres = P.ndim == 4
        flat = P.reshape(-1, *P.shape[-2:])
        V = torch.zeros_like(P)
        if singlet and mode != "amb":
            with phase(t, "J"):
                if unres:
                    V = V + jk.j(P[:, 0] + P[:, 1])[:, None]
                else:
                    V = V + 2.0 * jk.j(P)
        if self.ax:
            with phase(t, "K"):
                V = V - self.ax * jk.k(flat).reshape(P.shape)
        if self.rsh is not None:
            omega, _, beta = self.rsh
            with phase(t, "K_lr"):
                V = V - beta * jk.k_lr(flat, omega).reshape(P.shape)
        if self.has_xc and singlet and mode != "amb":
            with phase(t, "fxc"):
                f = self.fxc(P)
                f = f + f.transpose(-1, -2)
                V = V + (0.5 * f if unres else f)
        return V

    def _setup(self):
        mf = self.mf
        C = mf.mo_coeff
        if C.ndim == 3:
            return self._setup_unrestricted()
        self.unrestricted = False
        nocc = mf.mol.nelectron // 2
        self.Co = C[:, :nocc]
        self.Cv = C[:, nocc:]
        e = mf.mo_energy.cpu().numpy()
        self.eo = e[:nocc]
        self.ev = e[nocc:]
        self.nocc = nocc
        self.nvir = C.shape[1] - nocc
        self.ediff = (self.ev[None, :] - self.eo[:, None]).ravel()
        self._setup_common()
        Co, Cv = self.Co, self.Cv
        ediag = torch.as_tensor(self.ediff.reshape(nocc, self.nvir),
                                dtype=C.dtype, device=C.device)

        def make_mv(mode):
            def mv(Xb):                      # [nvec, nocc, nvir]
                P = Co @ Xb @ Cv.T
                V = self._v_ao(P, mode, self.singlet)
                return Xb * ediag + Co.T @ V @ Cv
            return mv

        self._a_mv = make_mv("tda")
        self._apb_mv = make_mv("apb")
        self._amb_mv = make_mv("amb")

    def _setup_unrestricted(self):
        """Spin-resolved excitation space (ia)_alpha + (ia)_beta — the UKS
        TDDFT of radicals (cctpu's ``_setup_unrestricted``)."""
        mf = self.mf
        self.unrestricted = True
        C = mf.mo_coeff
        na, nb = mf.mol.nalpha, mf.mol.nbeta
        nmo = C.shape[-1]
        self.nocc_s = (na, nb)
        self.nvir_s = (nmo - na, nmo - nb)
        self.Co_s = (C[0][:, :na], C[1][:, :nb])
        self.Cv_s = (C[0][:, na:], C[1][:, nb:])
        e = mf.mo_energy.cpu().numpy()
        ed_a = (e[0][na:][None, :] - e[0][:na][:, None]).ravel()
        ed_b = (e[1][nb:][None, :] - e[1][:nb][:, None]).ravel()
        self.ediff = np.concatenate([ed_a, ed_b])
        self._sizes = (na * (nmo - na), nb * (nmo - nb))
        self._setup_common()
        Co, Cv = self.Co_s, self.Cv_s
        ediag = [torch.as_tensor(ed.reshape(n, nmo - n), dtype=C.dtype,
                                 device=C.device)
                 for ed, n in ((ed_a, na), (ed_b, nb))]
        sa, _ = self._sizes

        def make_mv(mode):
            def mv(Vb):                      # [nvec, sa + sb]
                X = (Vb[:, :sa].reshape(-1, na, nmo - na),
                     Vb[:, sa:].reshape(-1, nb, nmo - nb))
                P = torch.stack([Co[s] @ X[s] @ Cv[s].T for s in range(2)],
                                1)
                V = self._v_ao(P, mode, True)
                r = [X[s] * ediag[s] + Co[s].T @ V[:, s] @ Cv[s]
                     for s in range(2)]
                return torch.cat([r[0].flatten(1), r[1].flatten(1)], 1)
            return mv

        self._a_mv = make_mv("tda")
        self._apb_mv = make_mv("apb")
        self._amb_mv = make_mv("amb")
        self.nocc = None
        self.nvir = None

    def _mv_flat(self, mv):
        """The batched device matvec as numpy's Davidson calls it: V [n, k]
        -> [n, k]."""
        C = self.mf.mo_coeff
        shape = (-1, sum(self._sizes)) if self.unrestricted \
            else (-1, self.nocc, self.nvir)

        def f(V):
            with phase(self.timer, "matvec"):
                self.n_matvec += V.shape[1]
                X = torch.as_tensor(np.ascontiguousarray(V.T),
                                    dtype=C.dtype, device=C.device)
                out = mv(X.reshape(shape))
                return out.reshape(V.shape[1], -1).cpu().numpy().T
        return f

    def _split(self, v):
        """Flat unrestricted vector -> (Xa [na,nva], Xb [nb,nvb])."""
        sa, _ = self._sizes
        na, nb = self.nocc_s
        nva, nvb = self.nvir_s
        return v[:sa].reshape(na, nva), v[sa:].reshape(nb, nvb)

    def _shape_x(self, v):
        """Flat amplitude vector -> per-spin tuple (unrestricted) or
        [no, nv] matrix (restricted)."""
        if self.unrestricted:
            return self._split(v)
        return v.reshape(self.nocc, self.nvir)

    def _zeros_x(self):
        if self.unrestricted:
            return self._split(np.zeros(sum(self._sizes)))
        return np.zeros((self.nocc, self.nvir))

    # -- main ----------------------------------------------------------------
    def kernel(self):
        t0 = time.time()
        self._solve()
        self.wall_s = time.time() - t0
        return self.e

    def _solve(self):
        self._setup()
        if self.unrestricted:
            nov = sum(self._sizes)
        else:
            nov = self.nocc * self.nvir
        nst = min(self.nstates, nov)

        if self.tda:
            w, Y, conv = davidson(self._mv_flat(self._a_mv), self.ediff,
                                  nst, tol=1e-6)
            self.e = w
            self.xy = [(self._shape_x(Y[:, k]), self._zeros_x())
                       for k in range(nst)]
            self.converged = conv
            return self.e

        # Full TDDFT: dense Casida for small problems, paired Davidson
        # (Stratmann-Scuseria-style) beyond.
        apb = self._mv_flat(self._apb_mv)
        amb = self._mv_flat(self._amb_mv)
        if nov > 600:
            w, xpy, xmy, conv = rpa_davidson(apb, amb, self.ediff, nst,
                                             tol=1e-6)
            self.e = w
            self.xy = [(self._shape_x(0.5 * (xpy[:, k] + xmy[:, k])),
                        self._shape_x(0.5 * (xpy[:, k] - xmy[:, k])))
                       for k in range(nst)]
            self.converged = conv
            return self.e
        # nov <= 600 from here on: dense Casida always fits
        I = np.eye(nov)
        APB = apb(I)
        AMB = amb(I)
        w2, sq = np.linalg.eigh(0.5 * (AMB + AMB.T))
        w2 = np.maximum(w2, 1e-12)
        S12 = (sq * np.sqrt(w2)[None, :]) @ sq.T
        M = S12 @ (0.5 * (APB + APB.T)) @ S12
        ww, Z = np.linalg.eigh(0.5 * (M + M.T))
        idx = np.argsort(ww)[:nst]
        self.e = np.sqrt(np.maximum(ww[idx], 0.0))
        self.xy = []
        Sm12 = (sq / np.sqrt(w2)[None, :]) @ sq.T
        for k, i in enumerate(idx):
            w = self.e[k]
            z = Z[:, i]
            # |X+Y> = (A-B)^{1/2} Z / sqrt(w);  |X-Y> = w^{-1}(A+B)|X+Y>
            xpy = S12 @ z / np.sqrt(max(w, 1e-12))
            xmy = Sm12 @ z * np.sqrt(max(w, 1e-12))
            X = 0.5 * (xpy + xmy)
            Yv = 0.5 * (xpy - xmy)
            # normalize <X|X> - <Y|Y> = 1
            nrm = X @ X - Yv @ Yv
            s = 1.0 / np.sqrt(abs(nrm)) if abs(nrm) > 1e-12 else 1.0
            self.xy.append((self._shape_x(X * s), self._shape_x(Yv * s)))
        self.converged = True
        return self.e

    # -- properties ----------------------------------------------------------
    def transition_dipoles(self):
        mf = self.mf
        ints = build_int1e_eager(
            mf.mol.basis_set, mf.coords,
            torch.as_tensor(mf.mol.charges, dtype=mf.coords.dtype,
                            device=mf.coords.device), with_dipole=True)
        r_ao = ints["dipole"].cpu().numpy()          # [3, nao, nao]
        if self.unrestricted:
            r_ov = [np.einsum("pi,dpq,qa->dia", self.Co_s[s].cpu().numpy(),
                              r_ao, self.Cv_s[s].cpu().numpy())
                    for s in range(2)]
            out = []
            for (X, Y) in self.xy:
                t = sum(np.einsum("dia,ia->d", r_ov[s],
                                  np.asarray(X[s]) + np.asarray(Y[s]))
                        for s in range(2))
                out.append(t)
            return np.array(out)
        r_ov = np.einsum("pi,dpq,qa->dia", self.Co.cpu().numpy(), r_ao,
                         self.Cv.cpu().numpy())
        out = []
        for (X, Y) in self.xy:
            t = np.sqrt(2.0) * np.einsum("dia,ia->d", r_ov, X + Y)
            out.append(t)
        return np.array(out)

    def oscillator_strength(self):
        t = self.transition_dipoles()
        return (2.0 / 3.0) * self.e * np.einsum("nd,nd->n", t, t)

    def analyze(self, threshold: float = 0.1, log=print):
        osc = self.oscillator_strength()
        for n, (e, f) in enumerate(zip(self.e, osc)):
            ev = e * HARTREE2EV
            nm = 1239.841984 / ev if ev > 0 else float("inf")
            log(f"Excited state {n + 1}: {ev:.4f} eV  {nm:.1f} nm  "
                f"f = {f:.4f}")
            X = self.xy[n][0]
            if self.unrestricted:
                for s, tag in ((0, "a"), (1, "b")):
                    Xs = np.asarray(X[s])
                    for (i, a) in zip(*np.where(np.abs(Xs) > threshold)):
                        log(f"    {i}{tag} -> {self.nocc_s[s] + a}{tag}"
                            f"   amp {Xs[i, a]:+.3f}")
            else:
                for (i, a) in zip(*np.where(np.abs(X) > threshold)):
                    log(f"    {i} -> {self.nocc + a}   amp {X[i, a]:+.3f}")
        return osc


class TDA(TDDFT):
    def __init__(self, mf, **kw):
        kw["tda"] = True
        super().__init__(mf, **kw)
