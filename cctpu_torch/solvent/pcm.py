"""PCM implicit solvation (IEF-PCM and C-PCM).

Port of ``cctpu/solvent/pcm.py``: a van-der-Waals cavity discretized per
atom by the product angular grid of the DFT module, buried points removed
smoothly by a switching function (so the solvation energy stays
differentiable in the coordinates), the 12-solvent dielectric table, and
``PCM(mf)``, which wraps an SCF's ``get_veff`` with the solvent's Fock term
and energy.

What differs from cctpu is how, not what:

 - ``potential_integrals`` evaluates a class of shell pairs on chunks of
   points (cctpu maps one class over all points at once: a d-d class's
   Hermite box would take GBs at a drug-sized molecule's 2,000 points).
 - The Fock term is in closed form, v_s = -sum_n u_n v_n with
   u = 1/2 (Q + Q^T) V, the function cctpu takes by jax.grad of
   1/2 (QV).V.
 - The nuclear gradient and the Hessian's derivatives of the potential
   integrals come from walks over the same chunks, each chunk's points on
   one atom; the cavity's n x n matrices are differentiated by autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from cctpu_torch.core.basis import ncart, nsph
from cctpu_torch.core.constants import ANG2BOHR
from cctpu_torch.dft.grids import angular_product
from cctpu_torch.ints.md import e3_components, r_box
from cctpu_torch.ints.one_electron import _to_sph, shell_pairs
from cctpu_torch.utils.profiling import phase

SOLVENT_PARAMS = {
    "water": 78.39, "methanol": 32.70, "ethanol": 24.55,
    "acetone": 20.70, "acetonitrile": 36.64, "dmso": 46.70,
    "dichloromethane": 8.93, "chloroform": 4.81, "thf": 7.58,
    "toluene": 2.38, "benzene": 2.27, "hexane": 1.88,
}

# UFF-ish vdW radii (Angstrom) scaled by 1.2 (standard PCM cavity)
_VDW = {1: 1.20, 6: 1.70, 7: 1.55, 8: 1.52, 9: 1.47, 15: 1.80, 16: 1.80,
        17: 1.75, 35: 1.85, 53: 1.98}

# element budget of a chunk's Hermite box [pairs, npA, npB, points, box^3]
# (128 MB in f64); the Hessian's derivative walk takes a quarter (its
# batched double backwards run 6 directions at once)
PCM_BUDGET = 1 << 24
_WALK_BUDGET = PCM_BUDGET // 4


def _potential_block(la, lb, ea, ca, A, eb, cb, B, points):
    """Spherical (mu nu | 1/|r - P|) blocks [pairs, npts, 2la+1, 2lb+1] of
    a class's shell pairs (exponents and coefficients [pairs, np], centres
    [pairs, 3]) at ``points`` [npts, 3]: the nuclear-attraction MD
    expansion with the charge centres replaced by the points."""
    a = ea[:, :, None]
    b = eb[:, None, :]
    p = a + b
    coef = ca[:, :, None] * cb[:, None, :]
    P = (a[..., None] * A[:, None, None, :]
         + b[..., None] * B[:, None, None, :]) / p[..., None]
    E3 = e3_components(la, lb, a, b, A, B)       # [k, npA, npB, nc, box^3]
    PC = P[:, :, :, None, :] - points            # [k, npA, npB, npts, 3]
    R = r_box(la + lb, p[..., None], PC)         # [k, npA, npB, npts, box^3]
    pref = (2.0 * math.pi / p) * coef
    V = torch.einsum("kpqcx,kpq,kpqnx->knc", E3, pref, R)
    return _to_sph(V.reshape(*V.shape[:2], ncart(la), ncart(lb)), la, lb)


def _walk(basis, coords, ranges, budget):
    """The chunks of the potential integrals: per shell-pair class and
    point range of ``ranges``, pairs in chunks whose Hermite box holds at
    most ``budget`` elements. Yields (la, lb, A-args, B-args, rows [k, sa],
    cols [k, sb], mult [k] (2 for a pair of two shells, whose mirror block
    is the transpose, else 1), point range)."""
    dev, dt = coords.device, coords.dtype
    ls = sorted(basis.groups)
    for la in ls:
        ga = basis.groups[la]
        for lb in ls:
            if lb < la:
                continue
            gb = basis.groups[lb]
            ia_all, ib_all = shell_pairs(len(ga.shell_idx), len(gb.shell_idx),
                                         la == lb)
            npab = ga.exps.shape[1] * gb.exps.shape[1]
            for p0, p1 in ranges:
                box = (la + lb + 1) ** 3
                step = max(1, budget // (npab * (p1 - p0) * box))
                for s in range(0, len(ia_all), step):
                    ia, ib = ia_all[s:s + step], ib_all[s:s + step]

                    def args(g, i):
                        return (torch.as_tensor(g.exps[i], dtype=dt,
                                                device=dev),
                                torch.as_tensor(g.coefs[i], dtype=dt,
                                                device=dev),
                                torch.as_tensor(g.atom_idx[i], device=dev))
                    rows = torch.as_tensor(ga.ao_start[ia][:, None]
                                           + np.arange(nsph(la)), device=dev)
                    cols = torch.as_tensor(gb.ao_start[ib][:, None]
                                           + np.arange(nsph(lb)), device=dev)
                    mult = torch.as_tensor(
                        np.where((la == lb) & (ia == ib), 1.0, 2.0),
                        dtype=dt, device=dev)
                    yield (la, lb, args(ga, ia), args(gb, ib), rows, cols,
                           mult, (p0, p1))


def potential_integrals(basis, coords, points, chunk: int = 256):
    """(mu nu | 1/|r - P|) for external points: [npts, nao, nao], on
    ``coords``' device. Same McMurchie-Davidson machinery as nuclear
    attraction, with the charge centres replaced by surface points,
    ``chunk`` points at a time. Differentiable in ``coords`` and
    ``points``."""
    npts, nao = points.shape[0], basis.nao
    out = torch.zeros((npts, nao, nao), dtype=coords.dtype,
                      device=coords.device)
    ranges = [(s, min(s + chunk, npts)) for s in range(0, npts, chunk)]
    for la, lb, (ea, ca, ta), (eb, cb, tb), rows, cols, _, (p0, p1) in \
            _walk(basis, coords, ranges, PCM_BUDGET):
        blk = _potential_block(la, lb, ea, ca, coords[ta], eb, cb,
                               coords[tb], points[p0:p1])
        n = torch.arange(p0, p1, device=coords.device)[None, :, None, None]
        r, c = rows[:, None, :, None], cols[:, None, None, :]
        out[n, r, c] = blk
        out[n, c.transpose(2, 3), r.transpose(2, 3)] = blk.transpose(2, 3)
    return out


class PCMModel:
    """Polarizable-continuum cavity model.

    ``method``: 'ief-pcm' (default, pyscf.solvent.PCM's) solves the
    integral-equation-formalism equations K q = R V with
    K = S - f/(2pi) D A S and R = -f (I - D A / (2pi)),
    f = (eps-1)/(eps+1); 'c-pcm' is the conductor-like limit K = S,
    R = -f I with f = (eps-1)/eps.

    ``PCM(mf)`` stores on the model, at the SCF's geometry, the points
    ``pts``, the factor ``Q`` = K^{-1} R and the potential integrals
    ``v_ints``, which the gradient and the Hessian reuse."""

    def __init__(self, mol, eps: float = 78.39, n_ang: int = 17,
                 scale: float = 1.2, method: str = "ief-pcm"):
        self.mol = mol
        self.eps = eps
        self.method = method.lower().replace("_", "-")
        Z = mol.charges.astype(int)
        u, wa = angular_product(n_ang)           # unit sphere, sum w = 4 pi
        radii = np.array([_VDW.get(int(z), 1.8) * scale * ANG2BOHR
                          for z in Z])
        self.template = np.concatenate([u * r for r in radii])
        self.areas0 = np.concatenate([wa * r * r for r in radii])
        self.atom_of = np.repeat(np.arange(mol.natm), len(u))
        self.radii = radii
        self.pts = self.Q = self.v_ints = None

    def _on(self, like):
        """The cavity's constants as tensors on ``like``'s device."""
        key = (like.device, like.dtype)
        if getattr(self, "_consts", (None,))[0] != key:
            t = lambda x: torch.as_tensor(x, dtype=like.dtype,  # noqa: E731
                                          device=like.device)
            self._consts = (key, t(self.template), t(self.areas0),
                            t(self.radii),
                            torch.as_tensor(self.atom_of, device=like.device),
                            t(self.mol.charges))
        return self._consts[1:]

    def f_eps(self):
        if self.method.startswith("c"):
            return (self.eps - 1.0) / self.eps
        return (self.eps - 1.0) / (self.eps + 1.0)

    def point_ranges(self):
        """The points of each atom, (start, stop) ranges in order."""
        n = len(self.template) // self.mol.natm
        return [(i * n, (i + 1) * n) for i in range(self.mol.natm)]

    def cavity(self, coords):
        """Surface points + smoothly switched areas (differentiable)."""
        tmpl, areas0, radii, atom_of, _ = self._on(coords)
        pts = tmpl + coords[atom_of]
        # smooth switching: scale area by prod over other atoms of
        # sigmoid((|r - R_j| - a_j)/w)
        w = 0.2
        d = torch.linalg.norm(pts[:, None, :] - coords[None, :, :], dim=-1)
        inside = torch.sigmoid((d - radii[None, :]) / w)
        other = atom_of[:, None] != torch.arange(
            self.mol.natm, device=coords.device)[None, :]
        sw = torch.prod(torch.where(other, inside, 1.0), dim=1)
        return pts, areas0 * sw

    def kernel_matrices(self, coords):
        """Cavity discretization + the (K, R) pair of K q = R V.

        Buried points are suppressed smoothly: the switching function
        drives their areas to 0, which (a) blows up the S diagonal
        ~1/sqrt(a) so their charges vanish and (b) zeroes their columns
        in D A. Everything is differentiable in ``coords``; the area floor
        is ``torch.maximum``, which splits the gradient at a tie as
        cctpu's ``jnp.maximum`` does."""
        pts, areas = self.cavity(coords)
        _, _, radii, atom_of, _ = self._on(coords)
        n = pts.shape[0]
        eye = torch.eye(n, dtype=torch.bool, device=coords.device)
        ident = torch.eye(n, dtype=coords.dtype, device=coords.device)
        floor = torch.tensor(1e-10, dtype=coords.dtype, device=coords.device)
        rij = torch.linalg.norm(pts[:, None, :] - pts[None, :, :] + 1e-30,
                                dim=-1)
        Smat = torch.where(eye, 0.0, 1.0 / (rij + 1e-30))
        diag = 1.0694 * torch.sqrt(4.0 * math.pi / torch.maximum(areas,
                                                                  floor))
        Smat = Smat + torch.diag(diag)
        f = self.f_eps()
        if self.method.startswith("c"):
            # conductor-like: K = S (+ tiny ridge), R = -f I
            return pts, areas, Smat + ident * 1e-10, -f * ident
        # IEF-PCM: double-layer operator D_ij = (r_i - r_j).n_j / r^3,
        # diagonal from the Gauss sum rule sum_j D_ij a_j = -2 pi
        nrm = (pts - coords[atom_of]) / radii[atom_of][:, None]
        diff = pts[:, None, :] - pts[None, :, :]
        Dmat = torch.where(eye, 0.0, torch.sum(diff * nrm[None, :, :], dim=-1)
                           / (rij ** 3 + 1e-30))
        a = torch.maximum(areas, floor)
        Ddiag = -(2.0 * math.pi + torch.sum(Dmat * areas[None, :], dim=1)) / a
        Dmat = Dmat + torch.diag(Ddiag)
        DA = Dmat * areas[None, :]
        inv2pi = 1.0 / (2.0 * math.pi)
        K = Smat - f * inv2pi * (DA @ Smat) + ident * 1e-10
        R = -f * (ident - inv2pi * DA)
        return pts, areas, K, R

    def _v_nuc(self, coords, pts):
        """The nuclei's potential on the points."""
        charges = self._on(coords)[4]
        dnuc = torch.linalg.norm(pts[:, None, :] - coords[None, :, :], dim=-1)
        return torch.sum(charges[None, :] / (dnuc + 1e-30), dim=1)

    def potential(self, coords, dm, pts, v_ints=None):
        """Total electrostatic potential V(dm) on the surface points."""
        Dtot = dm[0] + dm[1] if dm.ndim == 3 else dm
        if v_ints is None:
            v_ints = potential_integrals(self.mol.basis_set, coords, pts)
        V_el = -torch.einsum("nij,ij->n", v_ints, Dtot)
        return V_el + self._v_nuc(coords, pts)

    def energy(self, coords, dm, v_ints=None):
        """E_solv[D] (differentiable in dm and coords): the from-scratch
        path, one autograd graph over all points (small systems; the
        gradient and Hessian walk chunks instead)."""
        Dtot = dm[0] + dm[1] if dm.ndim == 3 else dm
        if v_ints is None:
            v_ints = potential_integrals(self.mol.basis_set, coords,
                                         self.cavity(coords)[0])
        return self.energy_of_potential(
            -torch.einsum("nij,ij->n", v_ints, Dtot), coords)

    def energy_of_potential(self, W, coords):
        """E_solv as a function of the electrons' potential W on the
        points (held fixed as the points move) and of ``coords``: the
        cavity, K, R and the nuclei's potential follow ``coords``."""
        pts, _, K, R = self.kernel_matrices(coords)
        V = W + self._v_nuc(coords, pts)
        return 0.5 * torch.dot(torch.linalg.solve(K, R @ V), V)

    # -- derivatives at the stored geometry ---------------------------------
    def _electron_potential(self, dm):
        Dt = dm.sum(0) if dm.ndim == 3 else dm
        return -torch.einsum("nij,ij->n", self.v_ints, Dt), Dt

    def response(self, D1t):
        """The solvent's second derivative in D along a batch of total
        densities D1t [m, nao, nao]: -sum_n w_n v_n, w = 1/2 (Q + Q^T)
        (-v . D1t), per density."""
        V1 = -torch.einsum("nij,mij->mn", self.v_ints, D1t)
        W = 0.5 * (V1 @ self.Q.T + V1 @ self.Q)
        return -torch.einsum("mn,nij->mij", W, self.v_ints)

    def nuclear_gradient(self, coords, dm):
        """dE_solv/dR [natm, 3] at fixed ``dm`` (cctpu's jax.grad of
        ``energy``), at the geometry ``PCM`` factored. The cavity's part
        by autograd of ``energy_of_potential``, which also gives
        u = dE/dV; then the linear functional sum_n u_n V_el,n(R) by a
        walk of the potential integrals' chunks, one backward a chunk."""
        W0, Dt = self._electron_potential(dm)
        W = W0.detach().requires_grad_(True)
        R = coords.detach().requires_grad_(True)
        with torch.enable_grad():
            g, u = torch.autograd.grad(self.energy_of_potential(W, R),
                                       [R, W])
        return g - self._walk_gradient(coords, u, Dt)

    def _walk_gradient(self, coords, w, Dt):
        """d/dR of sum_n w_n <v_n(R), Dt> (points moving with their
        atoms), Dt symmetric: per chunk the centres' gradients, the
        points' atom by translational invariance."""
        g = torch.zeros_like(coords)
        for la, lb, (ea, ca, ta), (eb, cb, tb), rows, cols, mult, (p0, p1) \
                in _walk(self.mol.basis_set, coords, self.point_ranges(),
                         PCM_BUDGET):
            A = coords[ta].detach().requires_grad_(True)
            B = coords[tb].detach().requires_grad_(True)
            Dm = Dt[rows[:, :, None], cols[:, None, :]] * mult[:, None, None]
            with torch.enable_grad():
                blk = _potential_block(la, lb, ea, ca, A, eb, cb, B,
                                       self.pts[p0:p1].detach())
                gA, gB = torch.autograd.grad(
                    torch.einsum("knab,n,kab->", blk, w[p0:p1], Dm), [A, B])
            # sorted, not atomic, accumulation: repeat calls bitwise equal
            g.index_put_((ta,), gA, accumulate=True)
            g.index_put_((tb,), gB, accumulate=True)
            g[int(self._on(coords)[3][p0])] -= gA.sum(0) + gB.sum(0)
        return g

    def potential_derivatives(self, coords, Dt, u):
        """The derivatives of the potential integrals that the analytic
        Hessian needs, at the stored geometry (points moving with their
        atoms), per chunk one batched double backward along the six
        directions of its pairs' two centres (forward mode in its
        double-vjp form; the points' atom by translational invariance):

          J [3N, npts]     d<v_n, Dt>/dR_k
          G [3N, nao, nao] sum_n u_n dv_n/dR_k
          H [3N, 3N]       d2/dR2 of sum_n u_n <v_n, Dt>

        ``Dt`` symmetric."""
        natm, nao = self.mol.natm, self.mol.nao
        n3 = 3 * natm
        dev, dt = coords.device, coords.dtype
        J = torch.zeros((n3, self.pts.shape[0]), dtype=dt, device=dev)
        G = torch.zeros((n3, nao, nao), dtype=dt, device=dev)
        H = torch.zeros((natm, 3, natm, 3), dtype=dt, device=dev)
        atom_of = self._on(coords)[3]
        eye3 = torch.eye(3, dtype=dt, device=dev)
        for la, lb, (ea, ca, ta), (eb, cb, tb), rows, cols, mult, (p0, p1) \
                in _walk(self.mol.basis_set, coords, self.point_ranges(),
                         _WALK_BUDGET):
            k = len(ta)
            A = coords[ta].detach().requires_grad_(True)
            B = coords[tb].detach().requires_grad_(True)
            Dm = Dt[rows[:, :, None], cols[:, None, :]] * mult[:, None, None]
            U = (u[p0:p1][None, :, None, None] * Dm[:, None]) \
                .requires_grad_(True)
            # direction 3 s + d moves coordinate d of slot s (A, B) of
            # every pair
            tang = torch.zeros((2, 6, k, 3), dtype=dt, device=dev)
            for s in range(2):
                tang[s, 3 * s:3 * s + 3] = eye3[:, None, :]
            with torch.enable_grad():
                blk = _potential_block(la, lb, ea, ca, A, eb, cb, B,
                                       self.pts[p0:p1].detach())
                gA, gB = torch.autograd.grad(blk, [A, B], grad_outputs=U,
                                             create_graph=True)
                dblk, hA, hB = torch.autograd.grad(
                    [gA, gB], [U, A, B], [tang[0], tang[1]],
                    is_grads_batched=True)
            # the slots (P, A, B), P's rows and columns minus the others'
            atoms = [atom_of[p0].expand(k), ta, tb]
            onehot = [torch.nn.functional.one_hot(a, natm).to(dt)
                      for a in atoms]
            y = torch.einsum("tknab,kab->tkn", dblk, Dm).reshape(2, 3, k, -1)
            z = torch.einsum("tknab,n->tkab", dblk, u[p0:p1]) \
                .reshape(2, 3, k, *dblk.shape[3:])
            y, z = [torch.cat([-x.sum(0, keepdim=True), x]) for x in (y, z)]
            r, c = rows[None, :, :, None], cols[None, :, None, :]
            two = mult == 2.0
            for s in range(3):
                Js = torch.einsum("qa,dqn->adn", onehot[s], y[s])
                J[:, p0:p1] += Js.reshape(n3, -1)
                idx = (3 * atoms[s][None, :] + torch.arange(3, device=dev)
                       [:, None])[:, :, None, None]
                # each (direction, row, column) once a call: an
                # accumulation without races
                G.index_put_((idx, r, c), z[s], accumulate=True)
                G.index_put_((idx[:, two], c[:, two].transpose(2, 3),
                              r[:, two].transpose(2, 3)),
                             z[s][:, two].transpose(2, 3), accumulate=True)
            # H_q[(s, d), (s2, e)]: rows of slots A, B from autograd, P's
            # minus their sum; columns the same
            rows_h = [h.detach().reshape(2, 3, k, 3) for h in (hA, hB)]
            rows_h = [-(rows_h[0] + rows_h[1])] + rows_h
            for s2 in range(3):
                cols_h = torch.cat([-rows_h[s2].sum(0, keepdim=True),
                                    rows_h[s2]])
                for s in range(3):
                    H += torch.einsum("qa,dqe,qb->bead", onehot[s],
                                      cols_h[s], onehot[s2])
        return J, G, H.reshape(n3, n3)


def PCM(mf, eps: float = 78.39, solvent: Optional[str] = None,
        method: str = "ief-pcm", timer=None):
    """Wrap a (not-yet-run) SCF object with PCM solvation.

    The cavity kernel Q = K^{-1} R and the surface potential integrals are
    factored once per geometry here, on the SCF's device; each SCF cycle
    then costs two [npts, nao^2] contractions and two matvecs. For UHF/UKS
    both spins get the same Fock term, from D_alpha + D_beta. ``timer``, a
    ``utils.profiling.PhaseTimer``, gets the set-up's phases
    ``pcm_cavity`` (points, K, R, Q) and ``pcm_ints``."""
    if solvent is not None:
        eps = SOLVENT_PARAMS[solvent.lower()]
    model = PCMModel(mf.mol, eps=eps, method=method)
    mf._pcm = model
    coords = mf.coords
    with phase(timer, "pcm_cavity"):
        pts, _, K, R = model.kernel_matrices(coords)
        model.pts, model.Q = pts, torch.linalg.solve(K, R)
        del K, R
    with phase(timer, "pcm_ints"):
        model.v_ints = potential_integrals(mf.mol.basis_set, coords, pts)
    orig_get_veff = mf.get_veff

    def get_veff(dm, cocc=None):
        veff, e2 = orig_get_veff(dm, cocc=cocc)
        V = model.potential(coords, dm, model.pts, v_ints=model.v_ints)
        QV = model.Q @ V
        u = 0.5 * (QV + model.Q.T @ V)
        v_s = -torch.einsum("n,nij->ij", u, model.v_ints)
        v_s = 0.5 * (v_s + v_s.T)
        return veff + v_s, e2 + 0.5 * torch.dot(QV, V)

    mf.get_veff = get_veff
    mf.with_solvent = model
    return mf
