"""Analytic SCF Hessians by AD-native CPHF (the orbital-rotation Schur
complement).

Port of ``cctpu/hessian/cphf.py``, with cctpu's formulation: with the
converged orbitals C0 at R0,

    C(kappa, R) = L(R)^{-T} L0^T C0 U(kappa),   S(R) = L(R) L(R)^T

(the Cholesky-transported frame) and U(kappa) the Cayley transform of the
occupied-virtual rotation kappa (per spin); the SCF energy L(kappa, R) is
stationary in kappa at (0, R0), so

    d2E/dR2 = H = L_RR - L_kR^T L_kk^{-1} L_kR.

The blocks are the same function as cctpu's; how they are computed differs
where the port has no autograd (the CUDA kernels) or no memory for one
whole-molecule graph:

 - L_kk (the orbital Hessian, the CPHF operator) acts as an operator: with
   D1 = (dD/dkappa) v, L_kk v = (dD/dkappa)^T G(D1) + the second
   derivative of <F, D(kappa)> along v, F the SCF's Fock matrix and G the
   J/K builder's ``j``, ``k`` and ``k_lr`` of the batch of D1 (``df_j`` and
   ``df_k_dm`` on the card) plus ``dft/rks.py::fxc_operator``. Both kappa
   derivatives of D have closed forms at kappa = 0. The conjugate gradient
   runs cctpu's arithmetic and stopping rule on ``rhs_chunk`` right-hand
   sides at a time, one batched matvec an iteration.
 - L_kR and L_RR: with D(kappa, R) = T(R) D(kappa) T(R)^T, T = L^{-T}
   L0^T, each energy term E(D, R) gives its Fock contribution dE/dD at
   (D0, R0) and, along each of the 3N directions (dD_k, e_k) (dD_k =
   dD/dR_k at kappa = 0), the directional derivatives of dE/dD and dE/dR.
   A term that is a sum over chunks (the one-electron energy, the XC energy
   per grid chunk with the grid rebuilt at R, the direct two-electron
   energy per quartet chunk) takes them by a batched double backward per
   chunk. The density-fitted energy, quadratic in the 3c2e tensor X, is
   split: the first-derivative tensors dX/dR_k and dM/dR_k (forward mode,
   per quartet centre), a double backward of the energy as a function of
   (D, X, M), and the second derivatives of X and M contracted with the
   energy's first derivatives W and Z per chunk.
 - A PCM solvent's energy, quadratic in its surface potential V and not
   a sum over chunks, is split as the DF energy is: dV/dR_k and the
   derivatives of the potential integrals contracted with D0 and with the
   solvent's weights u from one walk of their chunks
   (``PCMModel.potential_derivatives``), then a double backward of the
   cavity's small function of (V, R); its CPHF response is
   ``PCMModel.response``.
 - The dipole derivatives (``with_dipole``): dmu/dR = mu_R - mu_kappa X.

The DF energy whitens X by cctpu's eigh of the metric, the eigenvalues at
or below rcond (1e-12; 1e-10 for B_lr) times the largest dropped; where
none is dropped, a Cholesky factor of the metric gives the same function
with derivatives free of eigenvalue differences.
"""

from __future__ import annotations

import torch

from cctpu_torch.dft.dispersion import dispersion_energy
from cctpu_torch.ints.df import (build_2c2e, build_3c2e, eigh_whiten,
                                 walk_2c2e, walk_3c2e)
from cctpu_torch.ints.one_electron import build_int1e_eager
from cctpu_torch.ints.two_electron import (CHUNK_BUDGET, chunk_energy_2e,
                                           e2_densities, eri_quartet_kernel,
                                           walk_4c)
from cctpu_torch.utils.profiling import phase

# element budget of a walk chunk's largest intermediate in the Hessian's
# per-chunk double backward (batched over the 3-9 directions of a chunk's
# centre slots): the walks are launch-bound, and at phenol 6-31G* on the
# H100 the 3c walk took 23.3 s at 2**24, 13.0 s at 2**25 and 10.2 s at
# 2**26 for a peak of 22.9, 22.9 and 30.9 GB
_HESS_BUDGET = 2 * CHUNK_BUDGET
# directions (dD_k, e_k) of one batched double backward of a quartet chunk
_TANGENTS = 8
# the most bytes of dX/dR_k and dM/dR_k (all 3N directions) with which the
# density-fitted Hessian is known to fit on one H100 (80 GB): phenol
# 6-31G*'s 7.7 GB peaked at 36 GB; aspirin 6-31G*'s 64 GB cannot fit, and
# a version that walked in passes of 5 atoms ran out of memory in the
# walks' batched double backwards. ``hessian_auto`` takes the FD route
# above it.
DF_DX_BYTES_MAX = 8 << 30
# elements of the directions x [nao, grid chunk] tensors of one batched
# double backward of an XC chunk (2**26: 512 MiB in f64)
_XC_ELEMS = 1 << 26


def _cayley(K):
    """U = (I - K/2)^{-1} (I + K/2); K antisymmetric -> U orthogonal."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.linalg.solve(eye - 0.5 * K, eye + 0.5 * K)


def df_dx_bytes(mf) -> int:
    """Bytes of the DF term's dX/dR_k and dM/dR_k for all 3N directions
    (0 for an SCF that is not density-fitted)."""
    if mf.density_fit in (False, None, "cd"):
        return 0
    naux, nao = mf.get_jk_builder().aux.nao, mf.mol.nao
    return 3 * mf.mol.natm * 8 * (naux * nao * nao + naux * naux)


def _check_supported(mf):
    if mf.density_fit == "compressed":
        raise NotImplementedError(
            "the pair-compressed DF Hessian is not ported (ROADMAP.md "
            "queue 1 item 19)")
    if mf.dm is None or mf.mo_coeff is None:
        raise ValueError("analytic_hessian needs a converged SCF: run "
                         "kernel() first")


class _Frame:
    """The orbital-rotation frame of a converged SCF: per spin (C0,
    nocc, occupation weight), the stacked density D0 of the occupied
    orbitals ([nao, nao], or [2, nao, nao]), and the rotation's flat
    layout (cctpu's ravel_pytree: each spin's [nocc, nvir] row-major)."""

    def __init__(self, mf):
        mol, C = mf.mol, mf.mo_coeff
        self.restricted = C.ndim == 2
        self.spins = ([(C, mol.nelectron // 2, 2.0)] if self.restricted
                      else [(C[0], mol.nalpha, 1.0),
                            (C[1], mol.nbeta, 1.0)])
        self.nmo = C.shape[-1]
        self.sizes = [no * (self.nmo - no) for _, no, _ in self.spins]
        self.nk = sum(self.sizes)
        dms = [w * C0[:, :no] @ C0[:, :no].T for C0, no, w in self.spins]
        self.D0 = dms[0] if self.restricted else torch.stack(dms)

    def _blocks(self, V):
        """[m, nk] -> per spin [m, nocc, nvir]."""
        out, s = [], 0
        for (_, no, _), n in zip(self.spins, self.sizes):
            out.append(V[:, s:s + n].reshape(-1, no, self.nmo - no))
            s += n
        return out

    def _stack(self, mats):
        return mats[0] if self.restricted else torch.stack(mats, 1)

    def dm_of(self, kappa):
        """D(kappa) of a flat rotation [nk] at R0 (cctpu's ``dm_of``,
        untransported); at R the transported frame gives T(R) D(kappa)
        T(R)^T."""
        dms = []
        for (C0, no, w), k in zip(self.spins, self._blocks(kappa[None])):
            k = k[0]
            nv = self.nmo - no
            zo = torch.zeros((no, no), dtype=k.dtype, device=k.device)
            zv = torch.zeros((nv, nv), dtype=k.dtype, device=k.device)
            K = torch.cat([torch.cat([zo, -k], 1), torch.cat([k.T, zv], 1)])
            C = C0 @ _cayley(K)
            dms.append(w * C[:, :no] @ C[:, :no].T)
        return dms[0] if self.restricted else torch.stack(dms)

    def d1(self, V):
        """D1 = (dD/dkappa) v at kappa = 0 for a batch V [m, nk]:
        w (Co k Cv^T + Cv k^T Co^T) per spin; [m, *D0.shape]."""
        out = []
        for (C0, no, w), k in zip(self.spins, self._blocks(V)):
            Co, Cv = C0[:, :no], C0[:, no:]
            P = Co @ k @ Cv.T
            out.append(w * (P + P.transpose(1, 2)))
        return self._stack(out)

    def d1_t(self, G):
        """(dD/dkappa)^T G for a batch G [m, *D0.shape]: w Co^T (G + G^T)
        Cv per spin; [m, nk]."""
        out = []
        for s, (C0, no, w) in enumerate(self.spins):
            Gs = G if self.restricted else G[:, s]
            Co, Cv = C0[:, :no], C0[:, no:]
            out.append((w * Co.T @ (Gs + Gs.transpose(1, 2)) @ Cv)
                       .reshape(G.shape[0], -1))
        return torch.cat(out, 1)

    def d2_hvp(self, F, V):
        """The second kappa-derivative of <F, D(kappa)> at 0 along V [m,
        nk]: with D(kappa)'s second-order term w C0 [[-k k^T, 0], [0, k^T
        k]] C0^T, w (-2 F'oo k + 2 k F'vv) per spin, F' = C0^T F C0
        symmetrized; [m, nk]."""
        out = []
        for s, ((C0, no, w), k) in enumerate(zip(self.spins,
                                                 self._blocks(V))):
            Fs = F if self.restricted else F[s]
            Fm = C0.T @ Fs @ C0
            Fm = 0.5 * (Fm + Fm.T)
            out.append((2 * w * (k @ Fm[no:, no:] - Fm[:no, :no] @ k))
                       .reshape(V.shape[0], -1))
        return torch.cat(out, 1)


def _transport(basis, R, L0):
    """T(R) = L(R)^{-T} L0^T, S(R) = L(R) L(R)^T: C(R) = T C0 stays
    orthonormal in S(R)."""
    S = build_int1e_eager(basis, R, torch.zeros_like(R[:, 0]),
                          overlap_only=True)["S"]
    L = torch.linalg.cholesky(S)
    return torch.linalg.solve_triangular(L.T, L0.T, upper=True)


def _grad(outputs, inputs, grad_outputs, **kw):
    """torch.autograd.grad with zeros for inputs the outputs do not
    reach."""
    gs = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                             allow_unused=True, **kw)
    batch = grad_outputs[0].shape[:1] if kw.get("is_grads_batched") else ()
    return [torch.zeros(batch + x.shape, dtype=x.dtype, device=x.device)
            if g is None else g for g, x in zip(gs, inputs)]


def _jac(f, R):
    """df/dR_k [3N, *f.shape] of a tensor function of R [natm, 3]: the
    double-vjp form of forward mode (d/du of u . df/dR), one batched
    backward."""
    n3 = R.numel()
    leaf = R.detach().requires_grad_(True)
    with torch.enable_grad():
        out = f(leaf)
        u = torch.zeros_like(out, requires_grad=True)
        g, = torch.autograd.grad(out, leaf, grad_outputs=u,
                                 create_graph=True)
        eye = torch.eye(n3, dtype=R.dtype, device=R.device)
        J, = _grad(g.reshape(-1), [u], [eye], is_grads_batched=True)
    return J.detach()


def _hess(f, R):
    """d2f/dR2 [3N, 3N] of a scalar function of R [natm, 3]."""
    n3 = R.numel()
    leaf = R.detach().requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(f(leaf), leaf, create_graph=True)
        eye = torch.eye(n3, dtype=R.dtype, device=R.device)
        H, = _grad(g.reshape(-1), [leaf], [eye], is_grads_batched=True)
    return H.reshape(n3, n3).detach()


def _directional(energies, D0, R0, dD, per=_TANGENTS):
    """(F, dF, rho) of a sum of energy terms e(D, R) (callables, each a
    0-d tensor with its graph): F = dE/dD at (D0, R0); along each direction
    (dD_k, e_k), dF[k] the derivative of dE/dD and rho[k] that of dE/dR
    (flat), each chunk's graph freed after its batched double backwards of
    ``per`` directions a call."""
    n3 = dD.shape[0]
    eye = torch.eye(n3, dtype=R0.dtype, device=R0.device).reshape(
        n3, *R0.shape)
    F = torch.zeros_like(D0)
    dF = torch.zeros_like(dD)
    rho = torch.zeros((n3, n3), dtype=R0.dtype, device=R0.device)
    for energy in energies:
        Dl = D0.detach().requires_grad_(True)
        Rl = R0.detach().requires_grad_(True)
        with torch.enable_grad():
            gD, gR = _grad(energy(Dl, Rl), [Dl, Rl], None,
                           create_graph=True)
            for s in range(0, n3, per):
                hD, hR = _grad([gD, gR], [Dl, Rl],
                               [dD[s:s + per], eye[s:s + per]],
                               retain_graph=s + per < n3,
                               is_grads_batched=True)
                dF[s:s + per] += hD
                rho[s:s + per] += hR.reshape(-1, n3)
        F += gD.detach()
    return F, dF, rho


# ---------------------------------------------------------------------------
# walks of quartet chunks: per-centre first and second derivatives
# ---------------------------------------------------------------------------

def _slots(args, R):
    """The quartet kernel's arguments at R and its distinct centre slots:
    [(argument positions, atom index per quartet)]. A 2c/3c auxiliary
    shell and its dummy s-function share one slot."""
    base = args(R)
    natm = R.shape[0]
    index = torch.arange(natm, dtype=R.dtype, device=R.device)[:, None] \
        .expand(natm, 3)
    atoms = args(index)
    slots = []
    for pos in (2, 5, 8, 11):
        for s in slots:
            if base[s[0][0]] is base[pos]:
                s[0].append(pos)
                break
        else:
            slots.append(([pos], atoms[pos][:, 0].long()))
    return base, slots


def _with_centres(ls, base, slots, omega):
    def blocks(*centres):
        x = list(base)
        for (pos, _), c in zip(slots, centres):
            for p in pos:
                x[p] = c
        return eri_quartet_kernel(ls, *x, omega=omega)
    return blocks


def _slot_tangents(centres):
    """One-hot directions of the centre slots but the first, a batch of
    3 (nslots - 1): direction 3 (s - 1) + d moves coordinate d of slot s of
    every quartet. The first slot's derivatives follow from translational
    invariance: minus the sum over the others."""
    ns = len(centres)
    tang = [torch.zeros((3 * (ns - 1), *c.shape), dtype=c.dtype,
                        device=c.device) for c in centres]
    for s in range(1, ns):
        for d in range(3):
            tang[s][3 * (s - 1) + d, :, d] = 1.0
    return tang


def _by_slot(rows):
    """[3 (ns - 1), ...] derivatives along slots 1.. -> per slot [3, ...],
    slot 0's by translational invariance."""
    out = [rows[3 * i:3 * i + 3] for i in range(rows.shape[0] // 3)]
    return [-sum(out)] + out


def _walk_derivatives(walk, R, shape, pick, scatter, weights,
                      omega=None):
    """(dT/dR_k [3N, *shape], H [3N, 3N]) of the tensor T that ``walk``'s
    chunks fill and of sum_q mult_q pick(blocks_q) . weights[rows_q]. Per
    chunk one batched double backward along the centre slots: of g(u) =
    (dblocks/dcentres)^T u with u the chunk's weights, d/du gives the
    blocks' derivatives (forward mode in its double-vjp form), added at
    the slot's atom by ``scatter(out, k, rows, mult, blk)`` (with mirrors),
    and d/dcentres the second derivatives, added at the atoms."""
    natm = R.shape[0]
    n3 = 3 * natm
    dT = torch.zeros((n3, *shape), dtype=R.dtype, device=R.device)
    H = torch.zeros((natm, 3, natm, 3), dtype=R.dtype, device=R.device)
    for ls, args, rows, mult in walk:
        base, slots = _slots(args, R)
        blocks = _with_centres(ls, base, slots, omega)
        centres = [base[pos[0]].detach().requires_grad_(True)
                   for pos, _ in slots]
        with torch.enable_grad():
            blk = pick(blocks(*centres))
            u = (mult.reshape(-1, *[1] * (blk.ndim - 1)) * weights[rows]) \
                .requires_grad_(True)
            g = torch.autograd.grad(blk, centres, grad_outputs=u,
                                    create_graph=True)
            du, *dc = _grad(g, [u] + centres, _slot_tangents(centres),
                            is_grads_batched=True)
        for (_, atom), dslot in zip(slots, _by_slot(du)):
            for d in range(3):
                scatter(dT, 3 * atom + d, rows, mult, dslot[d])
        # H_q[(s, d), (s2, e)] = rows[s2][s][d, q, e]
        rows_h = [_by_slot(h2.detach()) for h2 in dc]
        onehot = [torch.nn.functional.one_hot(atom, natm).to(R.dtype)
                  for _, atom in slots]
        for s in range(len(slots)):
            for s2 in range(len(slots)):
                H += torch.einsum("qa,dqe,qb->adbe", onehot[s],
                                  rows_h[s2][s], onehot[s2])
    return dT, H.reshape(n3, n3)


def _scatter_3c(out, k, rows, mult, blk):
    """dX[k, P, a, b] += blk and, for a pair of two shells, the (b, a)
    mirror."""
    P_, A_, B_ = rows
    k = k[:, None, None, None]
    out.index_put_((k, P_, A_, B_), blk, accumulate=True)
    two = mult == 1.0
    out.index_put_((k[two], P_[two], B_[two].transpose(2, 3),
                    A_[two].transpose(2, 3)), blk[two].transpose(2, 3),
                   accumulate=True)


def _scatter_2c(out, k, rows, mult, blk):
    """dM[k, P, Q] += blk and, off one shell's diagonal, the (Q, P)
    mirror."""
    P_, Q_ = rows
    k = k[:, None, None]
    out.index_put_((k, P_, Q_), blk, accumulate=True)
    two = mult == 1.0
    out.index_put_((k[two], Q_[two].transpose(1, 2),
                    P_[two].transpose(1, 2)), blk[two].transpose(1, 2),
                   accumulate=True)


def _pick_3c(blk):
    return blk[:, :, 0]


def _pick_2c(blk):
    return blk[:, :, 0, :, 0]


# ---------------------------------------------------------------------------
# the energy terms
# ---------------------------------------------------------------------------

def _whiten(X, M, rcond):
    """cctpu's whitened factor (``ints/df.py::eigh_whiten``), or, where no
    metric eigenvalue falls at or below ``rcond`` times the largest, the
    same contraction B^T B = X^T M^{-1} X from M's Cholesky factor."""
    w = torch.linalg.eigvalsh(M.detach())
    if bool((w > rcond * w.max()).all()):
        naux = X.shape[0]
        L = torch.linalg.cholesky(M)
        return torch.linalg.solve_triangular(
            L, X.reshape(naux, -1), upper=False).reshape(X.shape)
    return eigh_whiten(X, M, rcond)


def _df_energy(D, X, M, k_weight, with_j, rcond):
    """cctpu's DF energy at (D, X, M) (``cphf.py::_energy_pieces``):
    1/2 |B.Dtot|^2 - k_weight/2 sum_s sum_P Tr[B_P D_s B_P^T D_s^T] with
    the spin densities D_s (D/2 twice for a total density), B =
    ``_whiten(X, M)``; the exchange part alone without ``with_j``."""
    B = _whiten(X, M, rcond)
    e = 0.0
    if with_j:
        Dt = D.sum(0) if D.ndim == 3 else D
        jp = torch.einsum("pij,ij->p", B, Dt)
        e = 0.5 * torch.dot(jp, jp)
    if k_weight:
        dms = D if D.ndim == 3 else 0.5 * D[None].expand(2, *D.shape)
        for s in range(2):
            BD = B @ dms[s]
            e = e - 0.5 * k_weight * torch.einsum(
                "pij,ij->", BD @ B.transpose(1, 2), dms[s])
    return e


def _df_term(mf, D0, dD, k_weight, omega=None, rcond=1e-12):
    """(F, dF, rho) of the density-fitted energy, the Coulomb and
    exchange part (``omega`` None) or the long-range exchange at
    ``omega``: its first derivatives F = dE/dD, W = dE/dX and Z = dE/dM,
    one walk of the 3c and of the 2c chunks for dX/dR_k, dM/dR_k and the
    second derivatives of X and M contracted with W and Z, then a double
    backward of ``_df_energy`` along (dD_k, dX_k, dM_k) for each k."""
    basis, aux, R0 = mf.mol.basis_set, mf.get_jk_builder().aux, mf.coords
    X = build_3c2e(basis, aux, R0, omega)
    M = build_2c2e(aux, R0, omega)
    n3 = dD.shape[0]
    leaves = [t.detach().requires_grad_(True) for t in (D0, X, M)]
    with torch.enable_grad():
        g = torch.autograd.grad(
            _df_energy(*leaves, k_weight, omega is None, rcond), leaves,
            create_graph=True)
    F, W, Z = (t.detach() for t in g)
    dX, rho = _walk_derivatives(walk_3c2e(basis, aux, R0, _HESS_BUDGET), R0,
                                X.shape, _pick_3c, _scatter_3c,
                                W + W.transpose(1, 2), omega)
    dM, rho2 = _walk_derivatives(walk_2c2e(aux, R0, _HESS_BUDGET), R0,
                                 M.shape, _pick_2c, _scatter_2c, Z + Z.T,
                                 omega)
    rho += rho2
    dF = torch.zeros_like(dD)
    with torch.enable_grad():
        for k in range(n3):
            hD, hX, hM = _grad(g, leaves, [dD[k], dX[k], dM[k]],
                               retain_graph=k + 1 < n3)
            dF[k] = hD
            rho[k] += (dX.reshape(n3, -1) @ hX.reshape(-1)
                       + dM.reshape(n3, -1) @ hM.reshape(-1))
    return F, dF, rho


def _direct_energies(mf, ax, rsh):
    """The direct two-electron energy (cctpu's ``energy_2e_direct`` at the
    functional's exchange weight, the long-range exchange of a
    range-separated one) as ``walk_4c``'s chunk energies e(D, R), the
    Schwarz selection fixed at the SCF's geometry."""
    basis, R0 = mf.mol.basis_set, mf.coords

    def chunk(ls, args, rows, mult, omega, weight, coulomb):
        def energy(D, R):
            Dt, Dks, kw = e2_densities(D, weight)
            return chunk_energy_2e(
                eri_quartet_kernel(ls, *args(R), omega=omega), rows, mult,
                Dt if coulomb else None, Dks, kw)
        return energy

    out = [chunk(*c, None, ax, True) for c in walk_4c(basis, R0,
                                                      _HESS_BUDGET)]
    if rsh is not None:
        omega, _, beta = rsh
        out += [chunk(*c, omega, beta, False)
                for c in walk_4c(basis, R0, _HESS_BUDGET)]
    return out


def _pcm_term(mf, D0, dD):
    """(F, dF, rho) of the solvation energy E(D, R) = e(W(D, R), R), e
    the cavity's small function of the electrons' potential W on the
    points (``PCMModel.energy_of_potential``) and W = -<v(R), D>: the
    derivatives of the potential integrals from one walk of their chunks
    (J = d<v, D0>/dR, G = sum_n u_n dv_n/dR, the second derivative of
    sum_n u_n <v_n, D0>; u = de/dW), then a double backward of e along
    (dW_k, e_k), dW_k = -J_k - <v, dD_k>."""
    model, R0 = mf._pcm, mf.coords
    W0, Dt0 = model._electron_potential(D0)
    dDt = dD if D0.ndim == 2 else dD.sum(1)
    Wl = W0.detach().requires_grad_(True)
    with torch.enable_grad():
        u, = torch.autograd.grad(model.energy_of_potential(Wl, R0), Wl)
    J, G, Hw = model.potential_derivatives(R0, Dt0, u)
    v = model.v_ints
    dW = -J - torch.einsum("nij,kij->kn", v, dDt)
    _, du, rho = _directional([model.energy_of_potential], W0, R0, dW)
    F = -torch.einsum("n,nij->ij", u, v)
    dF = -torch.einsum("kn,nij->kij", du, v) - G
    rho = rho - du @ J.T - Hw - torch.einsum("lij,kij->kl", G, dDt)
    if D0.ndim == 3:
        F, dF = F.expand(D0.shape), dF[:, None].expand(dD.shape)
    return F, dF, rho


def _response(jk, frame, D1, ax, rsh, fxc, pcm=None):
    """G(D1): the second derivative of the SCF's energy in D along a
    batch D1 [m, *D0.shape] at fixed geometry, by the J/K builder (J, K,
    K_lr of the batch), the XC kernel ``fxc`` (``fxc_operator``) and the
    solvent model ``pcm`` (``PCMModel.response``)."""
    if frame.restricted:
        G = jk.j(D1)
        if ax:
            G = G - 0.5 * ax * jk.k(D1)
        if rsh is not None:
            G = G - 0.5 * rsh[2] * jk.k_lr(D1, rsh[0])
    else:
        m = D1.shape[0]
        flat = D1.reshape(2 * m, *D1.shape[2:])
        G = jk.j(D1[:, 0] + D1[:, 1])[:, None].expand(D1.shape).clone()
        if ax:
            G = G - ax * jk.k(flat).reshape(D1.shape)
        if rsh is not None:
            G = G - rsh[2] * jk.k_lr(flat, rsh[0]).reshape(D1.shape)
    if fxc is not None:
        G = G + fxc(D1)
    if pcm is not None:
        if frame.restricted:
            G = G + pcm.response(D1)
        else:
            G = G + pcm.response(D1.sum(1))[:, None]
    return G


def orbital_hessian(mf, frame=None):
    """v -> L_kk v for a batch V [nk, m] (the CPHF operator of cctpu's
    ``mv_flat``, on all m columns at once): (dD/dkappa)^T G(D1) + the
    second kappa-derivative of <F, D(kappa)>, F the SCF's Fock matrix."""
    frame = frame or _Frame(mf)
    func = getattr(mf, "func", None)
    ax = 1.0 if func is None else func.hyb
    rsh = None if func is None else func.rsh
    has_xc = func is not None and func.exc is not None
    jk = mf.get_jk_builder()
    if rsh is not None:
        jk.prepare_lr(rsh[0])
    H0 = mf.build_ints()
    H0 = H0["T"] + H0["V"]
    F = H0 + mf.get_veff(frame.D0)[0]
    fxc = mf.fxc_operator(frame.D0) if has_xc else None
    pcm = getattr(mf, "_pcm", None)

    def mv(V):
        Vt = V.T.contiguous()
        G = _response(jk, frame, frame.d1(Vt), ax, rsh, fxc, pcm)
        return (frame.d1_t(G) + frame.d2_hvp(F, Vt)).T
    return mv


def _cg(mv, rhs, tol, maxiter, chunk):
    """cctpu's ``cg_block``: conjugate gradient on ``chunk`` columns of
    ``rhs`` at a time, stopped when every column's residual norm is below
    ``tol`` or after ``maxiter`` iterations. Returns (X, iterations per
    chunk)."""
    X = torch.zeros_like(rhs)
    iters = []
    for s in range(0, rhs.shape[1], chunk):
        r = rhs[:, s:s + chunk].clone()
        x = torch.zeros_like(r)
        p = r.clone()
        rs = torch.einsum("ij,ij->j", r, r)
        for it in range(maxiter):
            Ap = mv(p)
            alpha = rs / torch.clamp(torch.einsum("ij,ij->j", p, Ap),
                                     min=1e-300)
            x += p * alpha[None, :]
            r -= Ap * alpha[None, :]
            rs_new = torch.einsum("ij,ij->j", r, r)
            if float(torch.sqrt(rs_new).max()) < tol:
                break
            p = r + p * (rs_new / torch.clamp(rs, min=1e-300))[None, :]
            rs = rs_new
        iters.append(it + 1)
        X[:, s:s + chunk] = x
    return X, iters


def analytic_hessian(mf, cg_tol: float = 1e-8, cg_maxiter: int = 60,
                     rhs_chunk: int = 12, with_dipole: bool = False,
                     timer=None, stats=None):
    """Cartesian Hessian [3N, 3N] (Ha/bohr^2, host numpy) of a converged
    RHF, RKS, UHF or UKS ``mf`` (density-fitted, in-core or Cholesky;
    range-separated and dispersion-corrected functionals and a PCM solvent
    included), on the SCF's device.

    ``with_dipole`` also returns dmu/dR [3N, 3] (a.u.) for IR intensities
    from the same CPHF solutions: dmu/dR = mu_R - mu_kappa X. ``timer``, a
    ``utils.profiling.PhaseTimer``, gets the phases ``transport``, ``1e``,
    ``2e`` (DF or direct, long-range included), ``xc``, ``pcm`` (a PCM
    solvent), ``nuc``, ``cg`` and ``dipole``; a dict ``stats`` gets the CG
    iterations per chunk, the rotation's size and |H - H^T| before the
    final symmetrization."""
    _check_supported(mf)
    mol = mf.mol
    R0 = mf.coords
    n3 = R0.numel()
    basis = mol.basis_set
    frame = _Frame(mf)
    D0 = frame.D0
    func = getattr(mf, "func", None)
    ax = 1.0 if func is None else func.hyb
    rsh = None if func is None else func.rsh
    has_xc = func is not None and func.exc is not None
    charges = torch.as_tensor(mol.charges, dtype=R0.dtype, device=R0.device)

    def spin_pair(A, B):        # A [.., nao, nao] times each spin of B
        return A @ B if frame.restricted else A[:, None] @ B[None]

    with phase(timer, "transport"):
        S0 = build_int1e_eager(basis, R0, charges, overlap_only=True)["S"]
        L0 = torch.linalg.cholesky(S0)
        Tk = _jac(lambda R: _transport(basis, R, L0), R0)     # [3N, n, n]
        dD = spin_pair(Tk, D0)
        dD = dD + dD.transpose(-1, -2)                         # dD/dR_k
    with phase(timer, "1e"):
        def one_e(D, R):
            ints = build_int1e_eager(basis, R, charges)
            return torch.einsum("...ij,ij->", D, ints["T"] + ints["V"])
        F, dF, rho = _directional([one_e], D0, R0, dD)
    with phase(timer, "2e"):
        if mf.density_fit in (False, None, "cd"):
            terms = [_directional(_direct_energies(mf, ax, rsh), D0, R0,
                                  dD)]
        else:
            terms = [_df_term(mf, D0, dD, ax)]
            if rsh is not None:
                terms.append(_df_term(mf, D0, dD, rsh[2], omega=rsh[0],
                                      rcond=1e-10))
    if has_xc:
        with phase(timer, "xc"):
            nchunk, chunk = mf._w_chunks.shape
            terms.append(_directional(
                [lambda D, R, k=k: mf.exc_chunk_at(D, R, k)
                 for k in range(nchunk)], D0, R0, dD,
                per=max(1, _XC_ELEMS // (mol.nao * chunk))))
    if getattr(mf, "_pcm", None) is not None:
        with phase(timer, "pcm"):
            terms.append(_pcm_term(mf, D0, dD))
    for Ft, dFt, rhot in terms:
        F, dF, rho = F + Ft, dF + dFt, rho + rhot
    del terms
    with phase(timer, "transport"):
        Fd = F.detach()

        def psi(R):                 # <F, T(R) D0 T(R)^T>
            T = _transport(basis, R, L0)
            return torch.einsum("...ij,...ij->", Fd, T @ D0 @ T.T)
        H_psi = _hess(psi, R0)
        # <F, dD/dkappa dR_k v> = <T_k^T F + F T_k, D1(v)>
        gamma = dF + spin_pair(Tk.transpose(1, 2), F) + (
            F @ Tk if frame.restricted else F[None] @ Tk[:, None])
        L_kR = frame.d1_t(gamma).T                              # [nk, 3N]
    with phase(timer, "nuc"):
        H_nuc = _hess(mol.energy_nuc_t, R0)
        if getattr(func, "dispersion", None):
            H_nuc = H_nuc + _hess(lambda R: dispersion_energy(func, mol, R),
                                  R0)
    L_RR = (torch.einsum("k...,l...->kl", dF, dD) + rho + H_psi + H_nuc)
    L_RR = 0.5 * (L_RR + L_RR.T)

    with phase(timer, "cg"):
        X, iters = _cg(orbital_hessian(mf, frame), L_kR, cg_tol, cg_maxiter,
                       rhs_chunk)
    H = L_RR - L_kR.T @ X
    if stats is not None:
        stats.update({"cg_iterations": iters, "nk": frame.nk, "n3": n3,
                      "max_abs_asymmetry": float((H - H.T).abs().max())})
    H = 0.5 * (H + H.T)
    if not with_dipole:
        return H.cpu().numpy()

    with phase(timer, "dipole"):
        dip = build_int1e_eager(basis, R0, charges,
                                with_dipole=True)["dipole"]      # [3, n, n]
        Dt = D0 if frame.restricted else D0.sum(0)
        cot = -dip if frame.restricted else -dip[:, None].expand(
            3, 2, *dip.shape[1:])
        M_k = frame.d1_t(cot)                                   # [3, nk]
        dDt = dD if frame.restricted else dD.sum(1)
        M_R = _jac(lambda R: -torch.einsum(
            "dij,ij->d", build_int1e_eager(basis, R, charges,
                                           with_dipole=True)["dipole"], Dt),
            R0).T                                               # [3, 3N]
        M_R = M_R - torch.einsum("dij,kij->dk", dip, dDt)
        M_R = M_R + torch.einsum("a,de->dae", charges, torch.eye(
            3, dtype=R0.dtype, device=R0.device)).reshape(3, n3)
        dmu = (M_R - M_k @ X).T                                 # [3N, 3]
    return H.cpu().numpy(), dmu.cpu().numpy()
