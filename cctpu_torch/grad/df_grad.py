"""Nuclear gradient of the density-fitted two-electron energy.

Port of ``cctpu/grad/df_grad.py``. With M^+ = Linv^T Linv, B = Linv X and
the fitted ERIs (ab|cd) = X^T M^+ X (the SCF's own J/K energy):

  E_J = 1/2 u^T M^+ u,            u_P   = sum_ab X_P,ab D_ab
  E_K = -(ax/2) sum_s tr-chain,   t^s_PQ = Tr[X_P D_s X_Q D_s]

  dE_2 = sum_P,ab dX_P,ab W_P,ab + sum_PQ dM_PQ Z_PQ with
    W_P  = gamma_P D - ax sum_s (D_s Xt_P D_s),   gamma = M^+ u
    Z_PQ = -1/2 gamma_P gamma_Q
           + (ax/2) sum_s Tr[Xt_P D_s Xt_Q D_s],  Xt = M^+ X

(the pseudo-inverse's dropped near-null directions contribute only
fit-tolerance noise, the standard DF-gradient approximation). Everything
is f64. The K terms go through the occupied factors C_s (D_s = C_s C_s^T),
so no [naux, nao, nao] tensor but W itself is formed: Y_s[k] = C_s^T B_k
C_s and M_s = Linv^T Y_s are [naux, nocc, nocc]. dX and dM are contracted
with W and Z by autograd through the quartet kernel, class by class and
chunk by chunk, with the same class walk and Schwarz selection as
``ints/df.py::build_3c2e`` and ``build_2c2e``.

A range-separated functional's long-range exchange -beta/4 Tr[D K_lr]
adds the same terms on the erf-attenuated factors: W/Z of its exchange
part alone from B_lr and Linv_lr at weight beta (cctpu forms them at beta
minus at 0, where the J parts cancel), and the 3c and 2c terms of the
attenuated quartet kernel over the same walks.

cctpu's TPU guards (``GradKernelCorrupt``, the host-FD spot checks of its
gradient executables, the compile memos) and its f32 W/Z assembly have no
counterpart here.
"""

from __future__ import annotations

import torch

from cctpu_torch.ints.df import walk_2c2e, walk_3c2e
from cctpu_torch.ints.two_electron import eri_quartet_kernel
from cctpu_torch.utils.profiling import phase

# element budget of a gradient chunk's largest intermediate (1 GB in f64,
# 4x the forward build's): the terms are launch-bound, and at phenol
# 6-31G* on the H100 the 3c term took 11.8 s at 2**23, 4.1 s at 2**25 and
# 2.1 s at 2**27 for a peak device memory of 3.7, 3.7 and 4.9 GB (the 3c
# seconds of profile_grad.py with this constant set to each value)
_GRAD_BUDGET = 1 << 27


def occupied_factors(mf):
    """[(C_s, weight)] with D_s = C_s C_s^T the density of spin s: the
    occupied columns of ``mo_coeff`` scaled by sqrt(occupation per spin).
    Closed shell: one factor of D/2 counted twice. Raises if a factor does
    not reproduce ``mf.dm`` to 1e-10."""
    dm, C, occ = mf.dm, mf.mo_coeff, mf.mo_occ
    if dm.ndim == 3:
        facs = [(C[s][:, occ[s] > 0] * torch.sqrt(occ[s][occ[s] > 0]), 1.0)
                for s in range(2)]
        dms = [dm[0], dm[1]]
    else:
        facs = [(C[:, occ > 0] * torch.sqrt(0.5 * occ[occ > 0]), 2.0)]
        dms = [0.5 * dm]
    for (c, _), d in zip(facs, dms):
        dev = float((c @ c.T - d).abs().max())
        if dev > 1e-10:
            raise ValueError(
                f"the occupied orbitals do not reproduce the density "
                f"(max |C C^T - D| = {dev:.2e}): the gradient needs a "
                "converged SCF state")
    return [(c.contiguous(), w) for c, w in facs]


def _wz(B, Linv, Dt, facs, ax: float, with_j: bool = True):
    """(Ws, Zs): Ws = W + W^T [naux, nao, nao] and Zs = Z + Z^T
    [naux, naux] from B [nkeep, nao, nao], Linv [nkeep, naux], the total
    density Dt and the occupied factors [(C_s, weight)] of the spin
    densities; without ``with_j`` those of the exchange part alone (then
    ``ax`` must not be 0)."""
    nk = B.shape[0]
    W = Z = 0.0
    if with_j:
        u = B.reshape(nk, -1) @ Dt.reshape(-1)
        gam = Linv.T @ u
        W = gam[:, None, None] * Dt[None]
        Z = -0.5 * torch.outer(gam, gam)
    if ax:
        for C, wt in facs:
            nocc = C.shape[1]
            Y = C.T @ (B @ C)                             # [nk, nocc, nocc]
            M = (Linv.T @ Y.reshape(nk, -1)).reshape(-1, nocc, nocc)
            W = W - (ax * wt) * (C @ M @ C.T)
            Mf = M.reshape(M.shape[0], -1)
            Z = Z + (0.5 * ax * wt) * (Mf @ Mf.T)
    return W + W.transpose(1, 2), Z + Z.T


def grad_of_walk(walk, coords, chunk_energy, omega=None):
    """sum over ``walk``'s chunks of ``chunk_energy(blocks, rows, mult)``,
    differentiated in the coordinates chunk by chunk: [natm, 3]; the blocks
    are those of the erf-attenuated operator with ``omega``. Each chunk's
    centers are rows of the leaf, so each chunk's graph is freed after its
    backward."""
    leaf = coords.detach().requires_grad_(True)
    g = torch.zeros_like(coords)
    for ls, args, rows, mult in walk:
        with torch.enable_grad():
            e = chunk_energy(eri_quartet_kernel(ls, *args(leaf), omega=omega),
                             rows, mult)
            gc, = torch.autograd.grad(e, leaf)
        g = g + gc
    return g


def _weighted(weights, pick):
    """A chunk energy sum_q mult * pick(blocks) * weights[rows]."""
    return lambda blocks, rows, mult: torch.einsum(
        "q,q...,q...->", mult, pick(blocks), weights[rows])


def _grad_3c(basis, aux, coords, Ws, omega=None):
    """sum_{P,ab} d(P|ab)/dR Ws[P,a,b] / 2 over ``walk_3c2e``'s AO pairs
    (each pair once, a same-shell pair at half weight), of the attenuated
    operator with ``omega``: [natm, 3]."""
    return grad_of_walk(walk_3c2e(basis, aux, coords, budget=_GRAD_BUDGET),
                        coords, _weighted(Ws, lambda blk: blk[:, :, 0]),
                        omega)


def _grad_2c(aux, coords, Zs, omega=None):
    """sum_PQ d(P|Q)/dR Zs[P,Q] / 2 over ``walk_2c2e``'s aux shell pairs
    (lP <= lQ, q1 <= q2 within one l, q1 == q2 at half weight), of the
    attenuated operator with ``omega``: [natm, 3]."""
    return grad_of_walk(walk_2c2e(aux, coords, budget=_GRAD_BUDGET), coords,
                        _weighted(Zs, lambda blk: blk[:, :, 0, :, 0]), omega)


def df_e2_gradient(mf, timer=None) -> torch.Tensor:
    """d(E_2e)/dR [natm, 3] of a converged density-fitted SCF (RHF, UHF,
    RKS, UKS, range-separated or not), on the SCF's device. ``timer``, a
    ``utils.profiling.PhaseTimer``, receives the phases ``wz`` (the W/Z
    assembly), ``3c`` and ``2c``, and ``3c_lr`` and ``2c_lr`` (the
    long-range terms)."""
    func = getattr(mf, "func", None)
    ax = 1.0 if func is None else func.hyb
    jk = mf.get_jk_builder()
    dm = mf.dm
    Dt = dm.sum(0) if dm.ndim == 3 else dm
    basis = mf.mol.basis_set
    with phase(timer, "wz"):
        facs = occupied_factors(mf)
        Ws, Zs = _wz(jk.B, jk._Linv, Dt, facs, ax)
    with phase(timer, "3c"):
        g = _grad_3c(basis, jk.aux, mf.coords, Ws)
    del Ws
    with phase(timer, "2c"):
        g = g + _grad_2c(jk.aux, mf.coords, Zs)
    rsh = getattr(func, "rsh", None)
    if rsh is not None:
        omega, _, beta = rsh
        with phase(timer, "wz"):
            Ws, Zs = _wz(*jk.prepare_lr(omega), Dt, facs, beta,
                         with_j=False)
        with phase(timer, "3c_lr"):
            g = g + _grad_3c(basis, jk.aux, mf.coords, Ws, omega)
        del Ws
        with phase(timer, "2c_lr"):
            g = g + _grad_2c(jk.aux, mf.coords, Zs, omega)
    return g
