"""GIAO NMR shielding tensors (gauge-including atomic orbitals).

Port of ``cctpu/response/giao_nmr.py`` (its parity target is
pyscf.prop.nmr.NMR, which is GIAO-based), in real arithmetic as cctpu:
every B-linear quantity is kept as X_phys = (i/2c) Xtilde with Xtilde
real antisymmetric. With AO centers R_mu and eps the Levi-Civita tensor,

  gw(M)[a]_mn  = eps_abc (R_mu - R_nu)_b M[c]_mn        (GIAO phase weight)
  S1[a]        = gw(<r>)                                 (overlap)
  h1[a]        = -l(ket-center)[a] + gw(rT + rV)[a]      (core, G-free)
  G1[a](D)     = gw(mJ)[a] - (ax/2) Kg[a](D) - (beta/2) Kg_lr[a](D)
                 + gw(mXC)[a]                              (2e skeleton)

for RHF/RKS (LDA, GGA, global and range-separated hybrids, meta-GGA with
tau's gauge correction omitted, as cctpu) and, spin-resolved, UHF/UKS.
The CPHF operator is the TDDFT (A-B) matvec (only exact exchange couples
to imaginary densities):

  amb(X) = F1_ov + G(Doo)_ov - S1_ov * eps_occ
  Dresp  = 2 (Cv X^T Co^T - Co X Cv^T) - 2 Co S1oo Co^T

  sigma_ab(N) = (1/2c^2) [ Tr(D dia0_ab(N)) + cross_ab(N)
                           + Tr(Dresp[a] h01[b](N)) ]
  cross_ab(N) = sum_mn D_mn eps_acd (R_mu,c mh01[d,b]_mn
                                     + R_nu,c mh01[d,b]_nm)

Everything runs on the SCF's device. The 2e skeleton builds the moment
3c2e (DF, or autoaux above nao 64 without DF) or the moment ERIs (in core
up to nao 64), whitens with its own eigh of the metric as cctpu does, and
contracts M1 and M2 chunk by chunk over aux rows within ``SKELETON_BYTES``
(cctpu forms a [3, 3, naux, nao, nao] intermediate on the host). The XC
skeleton is ``torch.autograd.grad`` of the chunk-summed energy with
respect to the moment probe, on the SCF's cached AO values. The CG's
matvec is ``response/tddft.py``'s (A-B), whose exchange is ``df_k_dm``
on DF and Cholesky factors; the three field directions share each matvec;
the exchange of Doo goes straight to the builder's ``k`` and ``k_lr``.
The integrals of the per-nucleus assembly are built for all nuclei at
once. With ``timer`` (a ``utils.profiling.PhaseTimer``) the seconds go to
``1e``, ``2e``, ``xc``, ``cg`` and ``assembly``; ``stats`` gets the CG's
iterations per field direction.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cctpu_torch.core.constants import LIGHT_SPEED_AU as C
from cctpu_torch.ints.giao import (ao_centers, build_moment_3c2e_eager,
                                   build_moment_eri_incore, mh01_integrals,
                                   moment_st_integrals, moment_v_integrals,
                                   nabla_integrals)
from cctpu_torch.ints.magnetic import (_EPS, angmom_integrals, chunk_scale,
                                       dia_integrals, h01_integrals)
from cctpu_torch.ints.two_electron import CHUNK_BUDGET
from cctpu_torch.utils.profiling import phase

# bytes of one aux-row chunk's [rows, nao, 4 nao] product in the exchange
# skeleton (1 GiB)
SKELETON_BYTES = 1 << 30
# without DF, the exact moment ERIs up to this nao, autoaux fitting above
# (cctpu's rule: 3 nao^4 doubles)
INCORE_NAO_MAX = 64
# the GIAO CPHF's stopping rule, per field direction (cctpu's scipy cg):
# ||r|| <= CG_RTOL ||b|| or CG_MAXITER iterations
CG_RTOL = 1e-10
CG_MAXITER = 400


def _eps3_np() -> np.ndarray:
    out = np.zeros((3, 3, 3))
    for g in range(3):
        for (a, b, s) in _EPS[g]:
            out[g, a, b] = s      # eps[g, b, c]: L_g = eps r_b d_c
    return out


@lru_cache(maxsize=None)
def _eps3(device, dtype) -> torch.Tensor:
    return torch.as_tensor(_eps3_np(), dtype=dtype, device=device)


def _gw(Rc, M):
    """GIAO phase weight: out[a]_mn = eps_abc (Rc[m,b]-Rc[n,b]) M[c]_mn."""
    dR = Rc[:, None, :] - Rc[None, :, :]             # [nao, nao, 3]
    return torch.einsum("abc,mnb,cmn->amn", _eps3(Rc.device, Rc.dtype), dR,
                        M)


def cg_solve(mv, b, diag, rtol: float, maxiter: int):
    """x [k, n] with mv(x) = b for each row of b [k, n] (mv: [m, n] ->
    [m, n], symmetric positive definite): conjugate gradients preconditioned
    by ``diag`` (the operator's diagonal), all unconverged rows in one
    matvec. A row stops when its residual ||r|| <= rtol ||b|| (scipy's
    ``cg`` rule, with the unpreconditioned residual) or after ``maxiter``
    matvecs. Returns (x, iterations per row)."""
    k = b.shape[0]
    x = torch.zeros_like(b)
    r = b.clone()
    z = r / diag
    p = z.clone()
    rz = torch.sum(r * z, 1)
    bound = rtol * torch.linalg.norm(b, dim=1)
    its = [0] * k
    active = (torch.linalg.norm(r, dim=1) > bound).tolist()
    for _ in range(maxiter):
        idx = [i for i in range(k) if active[i]]
        if not idx:
            break
        ii = torch.as_tensor(idx, device=b.device)
        pa = p[ii]
        Ap = mv(pa)
        alpha = rz[ii] / torch.sum(pa * Ap, 1)
        x[ii] += alpha[:, None] * pa
        ra = r[ii] - alpha[:, None] * Ap
        r[ii] = ra
        za = ra / diag
        rz_new = torch.sum(ra * za, 1)
        p[ii] = za + (rz_new / rz[ii])[:, None] * pa
        rz[ii] = rz_new
        done = (torch.linalg.norm(ra, dim=1) <= bound[ii]).tolist()
        for i, d in zip(idx, done):
            its[i] += 1
            active[i] = not d
    return x, its


class GIAONMR:
    """nmr = GIAONMR(mf); nmr.kernel() -> shielding [natm, 3, 3] in ppm."""

    def __init__(self, mf, timer=None, stats=None):
        self.mf = mf
        self.shielding = None
        self.timer = timer
        self.stats = {} if stats is None else stats
        self._factors = {}
        func = getattr(mf, "func", None)
        self._rsh = None if func is None else func.rsh

    # -- 2e skeleton ---------------------------------------------------------
    def _ax(self):
        func = getattr(self.mf, "func", None)
        return 1.0 if func is None else func.hyb

    def _aux(self):
        """The auxiliary basis of the skeleton: the DF builder's, autoaux
        above ``INCORE_NAO_MAX`` without DF (the skeleton's fit need not
        match the SCF's J/K), else None (the exact moment ERIs)."""
        from cctpu_torch.ints.df import DFJK, autoaux
        jk = self.mf.get_jk_builder()
        if isinstance(jk, DFJK):
            return jk.aux
        basis = self.mf.mol.basis_set
        return autoaux(basis) if basis.nao > INCORE_NAO_MAX else None

    def _lr(self):
        """(omega, beta) of a range-separated functional's long-range
        exchange, or None."""
        if self._rsh is not None and self._rsh[2]:
            return self._rsh[0], self._rsh[2]
        return None

    def _skeleton_2e(self, D, Rc):
        """(mJ, Kg, ax, Kg_lr, beta): the gw-weighted J part and the
        exchange skeletons, full range and, for a range-separated hybrid,
        the erf-attenuated long range (Fock convention veff -= 0.5 ax K +
        0.5 beta K_lr)."""
        ax, aux = self._ax(), self._aux()
        mJ, Kg = self._range_skeleton(D, Rc, aux, None, True, bool(ax))
        Kg_lr, beta = None, 0.0
        lr = self._lr()
        if lr is not None:
            omega, beta = lr
            _, Kg_lr = self._range_skeleton(D, Rc, aux, omega, False, True)
        return mJ, Kg, ax, Kg_lr, beta

    def _skeleton_2e_spin(self, Ds, Rc):
        """Spin-resolved: the Coulomb mJ of the total density and each
        spin's exchange skeletons (veff_s = J - ax K(D_s) - beta
        K_lr(D_s))."""
        ax, aux = self._ax(), self._aux()
        mJ, _ = self._range_skeleton(Ds[0] + Ds[1], Rc, aux, None, True,
                                     False)
        Kg_s, Kg_lr_s, beta = [None, None], [None, None], 0.0
        lr = self._lr()
        for s in range(2):
            if ax:
                _, Kg_s[s] = self._range_skeleton(Ds[s], Rc, aux, None,
                                                  False, True)
            if lr is not None:
                omega, beta = lr
                _, Kg_lr_s[s] = self._range_skeleton(Ds[s], Rc, aux, omega,
                                                     False, True)
        return mJ, Kg_s, ax, Kg_lr_s, beta

    def _range_skeleton(self, D, Rc, aux, omega, want_j, want_k):
        """(mJ, Kg) for one interaction range (omega None: 1/r12; omega:
        erf(omega r12)/r12, the moment 3c2e or ERIs and the DF metric
        attenuated alike)."""
        n = self.mf.mol.nao
        mJ = Kg = None
        if aux is None:
            meri = self._factor(aux, omega)
            if want_j:
                mJ = torch.einsum("cmnls,ls->cmn", meri, D)
            if want_k:
                M1 = torch.einsum("cmlns,ls->cmn", meri, D)
                M2 = torch.einsum("cmlns,lb,ls->cbmn", meri, Rc, D)
                Kg = self._kg_combine(M1, M2, Rc)
            return mJ, Kg
        Bm, B = self._factor(aux, omega)
        naux = B.shape[0]
        if want_j:
            mJ = torch.einsum("cpij,p->cij", Bm,
                              torch.einsum("pkl,kl->p", B, D))
        if want_k:
            # M1_c = sum_P Bm_c[P] D B[P]^T, M2_cb the same with D's rows
            # weighted by Rc[:, b]: four densities side by side, chunks of
            # aux rows
            Dcat = torch.cat([D] + [Rc[:, b, None] * D for b in range(3)],
                             1)                            # [n, 4n]
            rows = max(1, SKELETON_BYTES // (8 * 4 * n * n))
            M = torch.zeros((3, 4, n, n), dtype=D.dtype, device=D.device)
            for c in range(3):
                for s in range(0, naux, rows):
                    T = (Bm[c, s:s + rows] @ Dcat).reshape(-1, n, 4, n)
                    M[c] += torch.einsum("pmks,pns->kmn", T, B[s:s + rows])
            Kg = self._kg_combine(M[:, 0], M[:, 1:], Rc)
        return mJ, Kg

    def _factor(self, aux, omega):
        """The moment ERIs [3, n, n, n, n] (``aux`` None), or the whitened
        moment and plain 3c2e factors (Bm [3, naux, n, n], B [naux, n,
        n]) of one interaction range, built once per range and kept until
        the skeletons are done (cctpu rebuilds them per skeleton)."""
        if omega in self._factors:
            return self._factors[omega]
        mf = self.mf
        basis, coords = mf.mol.basis_set, mf.coords
        n = basis.nao
        if aux is None:
            out = build_moment_eri_incore(basis, coords, omega=omega)
        else:
            from cctpu_torch.ints.df import build_2c2e, build_3c2e
            # the whitening of cctpu's _range_skeleton: its own eigh of
            # the metric, rows of dropped eigenvalues zero, the same W for
            # Bm and B (eigenvector signs and order are not canonical, so
            # the SCF's own B is never mixed in)
            w, V = torch.linalg.eigh(build_2c2e(aux, coords, omega=omega))
            keep = w > 1e-12 * torch.max(w)
            inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(
                torch.where(keep, w, torch.ones_like(w))),
                torch.zeros_like(w))
            W = (V * inv_sqrt[None, :]).T
            del V
            naux = W.shape[0]
            Bm = build_moment_3c2e_eager(basis, aux, coords, omega=omega)
            for c in range(3):
                Bm[c] = (W @ Bm[c].reshape(naux, -1)).reshape(naux, n, n)
            X0 = build_3c2e(basis, aux, coords, omega=omega,
                            budget=CHUNK_BUDGET * chunk_scale(coords.device))
            B = (W @ X0.reshape(naux, -1)).reshape(naux, n, n)
            del X0
            out = (Bm, B)
        self._factors[omega] = out
        return out

    @staticmethod
    def _kg_combine(M1, M2, Rc):
        """Exchange skeleton Kg[a] = A[a] - A[a]^T with
        A[a]_mn = eps_abc (R_mu,b M1_c,mn - M2_cb,mn) (antisymmetrized:
        the GIAO-ERI derivative has no ket-pair symmetry; cctpu's
        complex-SCF oracle pins it)."""
        eps = _eps3(Rc.device, Rc.dtype)
        A = (torch.einsum("abc,mb,cmn->amn", eps, Rc, M1)
             - torch.einsum("abc,cbmn->amn", eps, M2))
        return A - A.transpose(1, 2)

    # -- XC skeleton ---------------------------------------------------------
    @staticmethod
    def _probe_vars(ao, rc, Ds, Dm, mgga: bool):
        """rho [S, chunk], grad rho [S, chunk, 3] and tau (meta-GGA, else
        None) of spin densities Ds [S, nao, nao] plus the moment probe
        sum_c r_c Dm[:, c] (Dm [S, 3, nao, nao]) entering as a density
        does (cctpu's _skeleton_xc); ao [4, chunk, nao], rc [3, chunk]."""
        aoT = ao.transpose(1, 2)                         # [4, nao, chunk]
        da = Ds @ aoT[0]                                 # [S, nao, chunk]
        dmc = Dm @ aoT[0]                                # [S, 3, nao, chunk]
        Pc = torch.sum(aoT[0] * dmc, -2)                 # [S, 3, chunk]
        rho = torch.sum(aoT[0] * da, -2) + torch.sum(rc * Pc, -2)
        grad = torch.stack([
            2.0 * torch.sum(aoT[1 + d] * da, -2)
            + torch.sum(rc * (2.0 * torch.sum(aoT[1 + d] * dmc, -2)), -2)
            + Pc[:, d] for d in range(3)], -1)
        tau = None
        if mgga:
            t = 0.5 * sum(torch.sum(aoT[1 + d] * (Ds @ aoT[1 + d]), -2)
                          for d in range(3))
            Tc = 0.5 * sum(torch.sum(aoT[1 + d] * (Dm @ aoT[1 + d]), -2)
                           for d in range(3))
            tau = t + torch.sum(rc * Tc, -2)
        return rho, grad, tau

    def _xc_probe_grad(self, Ds, scale: float):
        """d/dDm of E_xc with the probe Dm = scale * leaf [S, 3, nao,
        nao] at leaf 0, chunk by chunk (the sum of the chunk gradients is
        the gradient of the sum), symmetrized in the AO indices."""
        mf = self.mf
        func = mf.func
        mgga = func.xctype == "MGGA"
        mf._prepare_xc_f64()
        S, n = Ds.shape[0], Ds.shape[-1]
        leaf = torch.zeros((S, 3, n, n), dtype=Ds.dtype, device=Ds.device,
                           requires_grad=True)
        out = torch.zeros_like(leaf, requires_grad=False)
        with torch.enable_grad():
            for k in range(mf._w_chunks.shape[0]):
                rho, grad, tau = self._probe_vars(
                    mf._chunk_ao(k), mf._pts_chunks[k].T, Ds, scale * leaf,
                    mgga)
                if S == 1:
                    saa = torch.sum(grad[0] * grad[0], -1)
                    t = tau[0] if mgga else torch.zeros_like(rho[0])
                    e = func.exc(rho[0], rho[0], saa, saa, saa, t, t)
                else:
                    s = [torch.sum(grad[i] * grad[j], -1)
                         for i, j in ((0, 0), (0, 1), (1, 1))]
                    t = tau if mgga else torch.zeros_like(rho)
                    e = func.exc(rho[0], rho[1], *s, t[0], t[1])
                out += torch.autograd.grad(torch.sum(mf._w_chunks[k] * e),
                                           leaf)[0]
        return 0.5 * (out + out.transpose(-1, -2))

    def _skeleton_xc(self, D):
        """Moment-weighted XC potential mXC[c]_mn: d/d(dmm_c) E_xc[rho +
        sum_c r_c P_c(dmm)] at dmm = 0, the probe entering as dm does (the
        SCF's AD vxc convention); None without a functional."""
        func = getattr(self.mf, "func", None)
        if func is None or func.exc is None:
            return None
        return self._xc_probe_grad((0.5 * D)[None], 0.5)[0]

    def _skeleton_xc_spin(self, Ds):
        """Per-spin moment-weighted XC potential mXC[s, c]_mn."""
        func = getattr(self.mf, "func", None)
        if func is None or func.exc is None:
            return None
        return self._xc_probe_grad(Ds, 1.0)

    # -- first-order (imaginary) response density ---------------------------
    def _exchange(self, Doo, weight: float):
        """-weight (ax K(Doo) + beta K_lr(Doo)) of a batch [m, nao, nao]
        through the builder's ``k`` and ``k_lr`` (``df_k_dm`` on DF)."""
        jk = self.mf.get_jk_builder()
        G = torch.zeros_like(Doo)
        ax = self._ax()
        if ax:
            G -= weight * ax * jk.k(Doo)
        lr = self._lr()
        if lr is not None:
            omega, beta = lr
            G -= weight * beta * jk.k_lr(Doo, omega)
        return G

    def _solve(self, td, mv, rhs):
        """The CPHF for the three field directions, rhs [3, nov]."""
        diag = torch.as_tensor(td.ediff, dtype=rhs.dtype, device=rhs.device)
        X, its = cg_solve(mv, rhs, diag, CG_RTOL, CG_MAXITER)
        self.stats["cg_iterations"] = its
        return X

    def _response_density(self, D, Rc, h1, S1):
        """Closed-shell CPHF: the total B-response density [3, nao, nao]."""
        from cctpu_torch.response.tddft import TDDFT
        with phase(self.timer, "2e"):
            mJ, Kg, ax, Kg_lr, beta = self._skeleton_2e(D, Rc)
            F1 = h1 + _gw(Rc, mJ)
            if Kg is not None:
                F1 = F1 - 0.5 * ax * Kg
            if Kg_lr is not None:
                F1 = F1 - 0.5 * beta * Kg_lr
            self._factors.clear()
        with phase(self.timer, "xc"):
            mxc = self._skeleton_xc(D)
            if mxc is not None:
                F1 = F1 + _gw(Rc, mxc)

        td = TDDFT(self.mf, nstates=1)
        td._setup()
        Co, Cv = td.Co, td.Cv
        no, nv = td.nocc, td.nvir
        eo = torch.as_tensor(td.eo, dtype=D.dtype, device=D.device)
        with phase(self.timer, "cg"):
            S1oo = Co.T @ S1 @ Co
            Doo = -2.0 * Co @ S1oo @ Co.T
            # only exact exchange (full and long range) couples to the
            # antisymmetric imaginary density
            G = self._exchange(Doo, 0.5)
            rhs = (Co.T @ (F1 + G) @ Cv - (Co.T @ S1 @ Cv) * eo[:, None])
            X = self._solve(td, lambda x: td._amb_mv(x.reshape(-1, no, nv))
                            .reshape(x.shape[0], -1),
                            rhs.reshape(3, -1)).reshape(3, no, nv)
        return (2.0 * (Cv @ X.transpose(1, 2) @ Co.T - Co @ X @ Cv.T)
                + Doo)

    def _response_density_spin(self, dm, Rc, h1, S1):
        """UHF/UKS CPHF: per-spin occupied-virtual responses (only
        same-spin exact exchange couples imaginary densities, so the spins
        share the unrestricted TDDFT's (A-B)), summed into the total
        B-response density [3, nao, nao]."""
        from cctpu_torch.response.tddft import TDDFT
        Ds = dm
        with phase(self.timer, "2e"):
            mJ, Kg_s, ax, Kg_lr_s, beta = self._skeleton_2e_spin(Ds, Rc)
            self._factors.clear()
        with phase(self.timer, "xc"):
            mxc = self._skeleton_xc_spin(Ds)

        td = TDDFT(self.mf, nstates=1)
        td._setup()
        Co_s, Cv_s = td.Co_s, td.Cv_s
        no_s = td.nocc_s
        e = self.mf.mo_energy
        with phase(self.timer, "cg"):
            F1_s, Doo = [], []
            for s in range(2):
                F1 = h1 + _gw(Rc, mJ)
                if Kg_s[s] is not None:
                    F1 = F1 - ax * Kg_s[s]
                if Kg_lr_s[s] is not None:
                    F1 = F1 - beta * Kg_lr_s[s]
                if mxc is not None:
                    F1 = F1 + _gw(Rc, mxc[s])
                Co = Co_s[s]
                Doo.append(-Co @ (Co.T @ S1 @ Co) @ Co.T)
                F1_s.append(F1)
            Doo = torch.stack(Doo)                       # [2, 3, nao, nao]
            G = self._exchange(Doo.reshape(-1, *Doo.shape[2:]),
                               1.0).reshape(Doo.shape)
            rhs = torch.cat([
                (Co_s[s].T @ (F1_s[s] + G[s]) @ Cv_s[s]
                 - (Co_s[s].T @ S1 @ Cv_s[s]) * e[s, :no_s[s], None])
                .reshape(3, -1) for s in range(2)], 1)
            X = self._solve(td, td._amb_mv, rhs)
        sa = td._sizes[0]
        Dresp = Doo[0] + Doo[1]
        for s, Xs in enumerate((X[:, :sa], X[:, sa:])):
            Xs = Xs.reshape(3, no_s[s], -1)
            Co, Cv = Co_s[s], Cv_s[s]
            Dresp = Dresp + Cv @ Xs.transpose(1, 2) @ Co.T - Co @ Xs @ Cv.T
        return Dresp

    # -- main ----------------------------------------------------------------
    def kernel(self):
        mf = self.mf
        mol = mf.mol
        basis, coords = mol.basis_set, mf.coords
        dm = mf.dm
        unres = dm.ndim == 3
        D = dm[0] + dm[1] if unres else dm
        Rc = ao_centers(basis, coords)
        eps = _eps3(coords.device, coords.dtype)

        with phase(self.timer, "1e"):
            mS, mT = moment_st_integrals(basis, coords)
            mV = moment_v_integrals(basis, coords, torch.as_tensor(
                mol.charges, dtype=coords.dtype, device=coords.device))
            l0 = angmom_integrals(basis, coords, torch.zeros_like(coords[0]))
            nab = nabla_integrals(basis, coords)
            S1 = _gw(Rc, mS)
            # l about the ket center, elementwise:
            # l_ket[a]_mn = l0[a]_mn - eps_abc Rc[n,b] nab[c]_mn
            l_ket = l0 - torch.einsum("abc,nb,cmn->amn", eps, Rc, nab)
            h1 = -l_ket + _gw(Rc, mT + mV)
            del mS, mT, mV, l0, nab, l_ket

        if unres:
            Dresp = self._response_density_spin(dm, Rc, h1, S1)
        else:
            Dresp = self._response_density(D, Rc, h1, S1)

        # the shielding of every nucleus at once
        with phase(self.timer, "assembly"):
            dia0 = dia_integrals(basis, coords, coords,
                                 torch.zeros_like(coords[0]))
            h01 = h01_integrals(basis, coords, coords)
            mh01 = mh01_integrals(basis, coords, coords)
            sig = torch.einsum("Nabmn,mn->Nab", dia0, D)
            # cross term: GIAO phase x nuclear-paramagnetic operator
            sig += torch.einsum("acd,mc,Ndbmn,mn->Nab", eps, Rc, mh01, D)
            sig += torch.einsum("acd,nc,Ndbnm,mn->Nab", eps, Rc, mh01, D)
            sig += torch.einsum("amn,Nbnm->Nab", Dresp, h01)
            self.shielding = (0.5 / C ** 2 * sig * 1e6).cpu().numpy()
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


def make_nmr(mf, log=None, **kw):
    """GIAO NMR when supported (the pyscf.prop.nmr parity path), else the
    common-gauge-origin class (cctpu's contract: reached only for a
    reference outside the GIAO surface, which ``GIAONMR`` would report
    with NotImplementedError)."""
    try:
        return GIAONMR(mf, **kw)
    except NotImplementedError as exc:
        if log:
            log(f"GIAO NMR unavailable ({exc}); using CGO")
        from cctpu_torch.response.nmr import NMR
        return NMR(mf)
