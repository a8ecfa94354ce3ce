"""Magnetic one-electron integrals for NMR shielding (common gauge origin).

Port of ``cctpu/ints/magnetic.py``: three McMurchie–Davidson kernels,

 - angmom:    l[gamma,mu,nu]  = <mu| [(r-G) x grad]_gamma |nu>   (real,
              antisymmetric; the physical operator is -i*l)
 - W:         W[beta,mu,nu]   = <mu| (1/|r-R|) d/dr_beta |nu>
 - M:         M[alpha,mu,nu]  = <mu| (r-G)_alpha / |r-R| |nu>

from which h01 (paramagnetic nuclear) and the diamagnetic shielding
operator follow by differentiating with respect to the nucleus R. cctpu
takes those derivatives with ``jax.jacfwd``; here they are exact Hermite
identities, dR_tuv/dR_x = -R_(t+1)uv (R_tuv is the t-th derivative in the
product center P of a function of P - R), so W and M and their
R-derivatives come from one Hermite box of one order more, with no
automatic differentiation.

Each (la, lb) class of shell pairs is one batch: per direction the
Hermite coefficients of the operator are dense [la+1, lb+1, t] tables,
gathered to the class's cartesian component pairs and multiplied into a
[components, t*u*v] tensor that one einsum contracts with the Hermite box
and the primitive weights. Every nucleus (``R`` [nR, 3]) rides one more
batch axis. The blocks go to spherical AOs and into the [.., nao, nao]
result with one indexed write per chunk of pairs (every ordered pair once,
no padding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, ncart, nsph
from cctpu_torch.ints.md import _e3_index, e_table_1d, r_box
from cctpu_torch.ints.one_electron import _to_sph

_EPS = [[(1, 2, 1.0), (2, 1, -1.0)],     # (alpha, beta, sign) for L_x
        [(2, 0, 1.0), (0, 2, -1.0)],     # L_y
        [(0, 1, 1.0), (1, 0, -1.0)]]     # L_z

# elements of a class chunk's largest intermediate (256 MB in f64)
_BLOCK_ELEMS = 1 << 25
# on the card the class chunks are launch-bound, so the GIAO builders take
# this many times larger ones there (phenol/6-311G**, nao 162: mh01 of 13
# nuclei 8.5-9.0 s at 2**25 elements, 1.9 s at 4x, 0.60 s at 16x; the
# moment 3c2e 14.1-20.0 s, 3.4 s, 1.5 s, on an NVIDIA H100 80GB HBM3,
# 700 W; at 16x the nmr CLI's peak reached 55 GB)
CARD_CHUNK_SCALE = 4


def chunk_scale(device) -> int:
    """The chunk budgets' factor on ``device``: ``CARD_CHUNK_SCALE`` on
    the card, 1 on the host."""
    return CARD_CHUNK_SCALE if torch.device(device).type == "cuda" else 1


# ----------------------------------------------------------------------------
# Hermite coefficient tables of a class
# ----------------------------------------------------------------------------

def _dense(la: int, lb: int, a, b, ab, T: int):
    """e_table_1d's E[i][j][t] as one tensor [la+1, lb+1, T, *shape] (zero
    for t > i + j; T >= la + lb + 1)."""
    tab = e_table_1d(la, lb, a, b, ab)
    shape = torch.broadcast_shapes(a.shape, b.shape, ab.shape)
    zero = torch.zeros(shape, dtype=a.dtype, device=a.device)
    flat = [torch.broadcast_to(tab[i][j][t], shape) if t <= i + j else zero
            for i in range(la + 1) for j in range(lb + 1) for t in range(T)]
    return torch.stack(flat).reshape(la + 1, lb + 1, T, *shape)


def _ket_derivative(E, b, lb: int):
    """Coefficients of phi_mu * d/dr phi_nu along one direction from E
    [la+1, lb+2, T, ...] (the ket raised once): -2b E_(j+1) + j E_(j-1)."""
    j = torch.arange(lb + 1, dtype=E.dtype, device=E.device).reshape(
        1, -1, *[1] * (E.ndim - 2))
    lower = torch.cat([torch.zeros_like(E[:, :1]), E[:, :lb]], 1)
    return -2.0 * b * E[:, 1:lb + 2] + j * lower


def _moment(E, Pd, Gd, inv2p):
    """Coefficients of (x - G) along one direction from E [.., T, ...]:
    (P - G) E_t + E_(t-1)/(2p) + (t+1) E_(t+1) (the Hermite moment
    relation; T leaves room for t = i + j + 1)."""
    T = E.shape[2]
    t1 = torch.arange(1, T + 1, dtype=E.dtype, device=E.device).reshape(
        1, 1, T, *[1] * (E.ndim - 3))
    z = torch.zeros_like(E[:, :, :1])
    down = torch.cat([z, E[:, :, :T - 1]], 2)
    up = torch.cat([E[:, :, 1:], z], 2)
    return (Pd - Gd) * E + inv2p * down + t1 * up


def _gather(tabs, la: int, lb: int):
    """Per direction the dense tables [la+1, lb+1, ...] at the class's
    cartesian component pairs: [ncA*ncB, ...] each."""
    return [tabs[d][IA, IB]
            for d, (IA, IB) in enumerate(_e3_index(la, lb, tabs[0].device))]


def _product3(X):
    """[nx, nc, T^3, ...] from per-direction tables X[d] [nx, nc, T, ...]."""
    x, y, z = X
    E3 = (x[:, :, :, None, None] * y[:, :, None, :, None]
          * z[:, :, None, None, :])
    T = x.shape[2]
    return E3.reshape(*x.shape[:2], T ** 3, *x.shape[3:])


def _pair_geometry(ea, ca, A, eb, cb, B):
    a = ea[:, :, None]
    b = eb[:, None, :]
    p = a + b
    coef = ca[:, :, None] * cb[:, None, :]
    P = (a[..., None] * A[:, None, None, :]
         + b[..., None] * B[:, None, None, :]) / p[..., None]
    return a, b, p, coef, P


def _coulomb_box(ltot: int, p, P, R, deriv: bool):
    """The Hermite box of 1/|r - R| for each nucleus R [nR, 3]:
    [pairs, npA, npB, nR, T^3] (T = ltot + 1), or with ``deriv`` its
    derivatives in R [pairs, npA, npB, nR, 3, T^3] (-R_(tuv + e_x))."""
    PC = P[:, :, :, None, :] - R
    T = ltot + 1
    if not deriv:
        return r_box(ltot, p[..., None], PC)
    full = r_box(ltot + 1, p[..., None], PC)
    full = full.reshape(*full.shape[:-1], T + 1, T + 1, T + 1)
    out = [-full[..., 1:, :T, :T], -full[..., :T, 1:, :T],
           -full[..., :T, :T, 1:]]
    return torch.stack([o.reshape(*o.shape[:-3], T ** 3) for o in out], -2)


def _contract(E3, pref, Rb, deriv: bool):
    """The sum over primitives and Hermite indices of E3 [nx, nc, T^3,
    pairs, npA, npB] with the box Rb of ``_coulomb_box``: [pairs, nR, nx,
    (3,) nc]."""
    if deriv:
        return torch.einsum("ycxbpq,bpq,bpqndx->bnydc", E3, pref, Rb)
    return torch.einsum("ycxbpq,bpq,bpqnx->bnyc", E3, pref, Rb)


# ----------------------------------------------------------------------------
# Cartesian blocks (a batch of shell pairs of one class)
# ----------------------------------------------------------------------------

def _s_m_d_tables(la, lb, a, b, A, B, P, G):
    """Per direction the 1-D overlap, moment-about-G and ket-derivative
    tables [la+1, lb+1, ...] (t = 0 of the Hermite expansion)."""
    S, M, Dd = [], [], []
    for d in range(3):
        ab = (A[:, d] - B[:, d])[:, None, None]
        E = _dense(la, lb + 1, a, b, ab, la + lb + 2)
        S.append(E[:, :lb + 1, 0])
        M.append(E[:, :lb + 1, 1] + (P[..., d] - G[d]) * E[:, :lb + 1, 0])
        Dd.append(_ket_derivative(E, b, lb)[:, :, 0])
    return S, M, Dd


def angmom_block(la, lb, ea, ca, A, eb, cb, B, G):
    """Cartesian blocks [pairs, 3, ncA, ncB] of (r - G) x grad."""
    a, b, p, coef, P = _pair_geometry(ea, ca, A, eb, cb, B)
    pref = (math.pi / p) ** 1.5 * coef
    S, M, Dd = (_gather(t, la, lb) for t in _s_m_d_tables(
        la, lb, a, b, A, B, P, G))
    out = []
    for gamma in range(3):
        val = 0.0
        for (al, be, sg) in _EPS[gamma]:
            f = [M[d] if d == al else Dd[d] if d == be else S[d]
                 for d in range(3)]
            val = val + sg * f[0] * f[1] * f[2]
        out.append(val)
    blk = torch.einsum("gcbpq,bpq->bgc", torch.stack(out), pref)
    return blk.reshape(-1, 3, ncart(la), ncart(lb))


def nabla_block(la, lb, ea, ca, A, eb, cb, B):
    """Cartesian blocks [pairs, 3, ncA, ncB] of d/dr_c."""
    a, b, p, coef, P = _pair_geometry(ea, ca, A, eb, cb, B)
    pref = (math.pi / p) ** 1.5 * coef
    S, _, Dd = (_gather(t, la, lb) for t in _s_m_d_tables(
        la, lb, a, b, A, B, P, torch.zeros(3, dtype=P.dtype,
                                           device=P.device)))
    out = [(Dd[0] if c == 0 else S[0]) * (Dd[1] if c == 1 else S[1])
           * (Dd[2] if c == 2 else S[2]) for c in range(3)]
    blk = torch.einsum("gcbpq,bpq->bgc", torch.stack(out), pref)
    return blk.reshape(-1, 3, ncart(la), ncart(lb))


def w_block(la, lb, ea, ca, A, eb, cb, B, R, deriv: bool = False):
    """Cartesian blocks of <mu| 1/|r-R| d_beta |nu> for nuclei R [nR, 3]:
    [pairs, nR, 3(beta), ncA, ncB], or with ``deriv`` their derivatives in
    R, [pairs, nR, 3(beta), 3(R_alpha), ncA, ncB]."""
    a, b, p, coef, P = _pair_geometry(ea, ca, A, eb, cb, B)
    ltot = la + lb + 1
    T = ltot + 1
    E0, dE = [], []
    for d in range(3):
        ab = (A[:, d] - B[:, d])[:, None, None]
        E = _dense(la, lb + 1, a, b, ab, T)
        E0.append(E[:, :lb + 1])
        dE.append(_ket_derivative(E, b, lb))
    E0, dE = _gather(E0, la, lb), _gather(dE, la, lb)
    X = [torch.stack([dE[d] if d == beta else E0[d] for beta in range(3)])
         for d in range(3)]
    Rb = _coulomb_box(ltot, p, P, R, deriv)
    blk = _contract(_product3(X), (2.0 * math.pi / p) * coef, Rb, deriv)
    return blk.reshape(*blk.shape[:-1], ncart(la), ncart(lb))


def m_block(la, lb, ea, ca, A, eb, cb, B, R, G, deriv: bool = False):
    """Cartesian blocks of <mu| (r-G)_alpha / |r-R| |nu> for nuclei R
    [nR, 3]: [pairs, nR, 3(alpha), ncA, ncB], or with ``deriv`` their
    derivatives in R, [pairs, nR, 3(alpha), 3(R_d), ncA, ncB]."""
    a, b, p, coef, P = _pair_geometry(ea, ca, A, eb, cb, B)
    ltot = la + lb + 1
    T = ltot + 1
    inv2p = 0.5 / p
    E0, Em = [], []
    for d in range(3):
        ab = (A[:, d] - B[:, d])[:, None, None]
        E = _dense(la, lb, a, b, ab, T)
        E0.append(E)
        Em.append(_moment(E, P[..., d], G[d], inv2p))
    E0, Em = _gather(E0, la, lb), _gather(Em, la, lb)
    X = [torch.stack([Em[d] if d == alpha else E0[d] for alpha in range(3)])
         for d in range(3)]
    Rb = _coulomb_box(ltot, p, P, R, deriv)
    blk = _contract(_product3(X), (2.0 * math.pi / p) * coef, Rb, deriv)
    return blk.reshape(*blk.shape[:-1], ncart(la), ncart(lb))


def h01_of(JW):
    """h01[gamma] = sum_(al,be,sg) sg dW_be/dR_al from W's R-derivatives
    [..., 3(beta), 3(alpha), ncA, ncB] -> [..., 3(gamma), ncA, ncB]."""
    return torch.stack([sum(sg * JW[..., be, al, :, :]
                            for (al, be, sg) in _EPS[g]) for g in range(3)],
                       -3)


def dia_of(JM):
    """dia[al, be] = -dM_be/dR_al + delta_ab sum_g dM_g/dR_g from M's
    R-derivatives [..., 3(alpha_m), 3(R_d), ncA, ncB] -> [..., 3, 3, ncA,
    ncB]."""
    trace = sum(JM[..., g, g, :, :] for g in range(3))
    eye = torch.eye(3, dtype=JM.dtype, device=JM.device)[:, :, None, None]
    return -JM.transpose(-3, -4) + eye * trace[..., None, None, :, :]


# ----------------------------------------------------------------------------
# Assembly
# ----------------------------------------------------------------------------

def pair_chunk(npA: int, npB: int, per_prim: int, budget: int) -> int:
    """Shell pairs of a class per call: bounds ``per_prim`` elements per
    primitive pair to ``budget``."""
    return max(1, budget // max(npA * npB * per_prim, 1))


def assemble_1e(basis: BasisSet, coords, block_fn, lead, per_prim):
    """[*lead, nao, nao] from ``block_fn(la, lb, ea, ca, A, eb, cb, B)`` ->
    cartesian [pairs, *lead, ncA, ncB] over every ordered shell pair of
    every (la, lb) class (no symmetry assumed), in chunks of
    ``pair_chunk(..., per_prim(la, lb), budget)`` pairs (``_BLOCK_ELEMS``
    times ``chunk_scale``); each chunk's blocks go to
    spherical AOs and into the result with one indexed write."""
    dev, dt = coords.device, coords.dtype
    nao = basis.nao
    out = torch.zeros((*lead, nao, nao), dtype=dt, device=dev)
    budget = _BLOCK_ELEMS * chunk_scale(dev)
    ls = sorted(basis.groups)
    for la in ls:
        ga = basis.groups[la]
        for lb in ls:
            gb = basis.groups[lb]
            ia, ib = np.mgrid[0:len(ga.shell_idx), 0:len(gb.shell_idx)]
            ia, ib = ia.ravel(), ib.ravel()
            chunk = pair_chunk(ga.exps.shape[1], gb.exps.shape[1],
                               per_prim(la, lb), budget)
            for s in range(0, len(ia), chunk):
                i, j = ia[s:s + chunk], ib[s:s + chunk]
                blk = block_fn(
                    la, lb, torch.as_tensor(ga.exps[i], dtype=dt, device=dev),
                    torch.as_tensor(ga.coefs[i], dtype=dt, device=dev),
                    coords[torch.as_tensor(ga.atom_idx[i], device=dev)],
                    torch.as_tensor(gb.exps[j], dtype=dt, device=dev),
                    torch.as_tensor(gb.coefs[j], dtype=dt, device=dev),
                    coords[torch.as_tensor(gb.atom_idx[j], device=dev)])
                blk = _to_sph(blk, la, lb).movedim(0, len(lead))
                r = torch.as_tensor(ga.ao_start[i][:, None]
                                    + np.arange(nsph(la)), device=dev)
                c = torch.as_tensor(gb.ao_start[j][:, None]
                                    + np.arange(nsph(lb)), device=dev)
                out[..., r[:, :, None], c[:, None, :]] = blk
    return out


def _hermite_cost(la: int, lb: int, nx: int) -> int:
    """Elements per primitive pair of a W/M class: the [nx, nc, T^3]
    coefficient product beside a derivative box [3, T^3]."""
    T3 = (la + lb + 3) ** 3
    return nx * ncart(la) * ncart(lb) * T3 + 3 * T3


def _nuclei(R, like):
    R = torch.as_tensor(R, dtype=like.dtype, device=like.device)
    return R.reshape(-1, 3), R.ndim == 1


def angmom_integrals(basis: BasisSet, coords, gauge_origin):
    """l [3, nao, nao] about ``gauge_origin``."""
    G = torch.as_tensor(gauge_origin, dtype=coords.dtype,
                        device=coords.device)
    return assemble_1e(
        basis, coords,
        lambda la, lb, *args: angmom_block(la, lb, *args, G), (3,),
        lambda la, lb: 9 * ncart(la) * ncart(lb))


def w_integrals(basis: BasisSet, coords, R):
    """W [3(beta), nao, nao] at a nucleus R [3], or [nR, 3, nao, nao] for
    R [nR, 3]."""
    Rn, one = _nuclei(R, coords)
    out = assemble_1e(
        basis, coords,
        lambda la, lb, *args: w_block(la, lb, *args, Rn), (len(Rn), 3),
        lambda la, lb: len(Rn) * _hermite_cost(la, lb, 3))
    return out[0] if one else out


def m_integrals(basis: BasisSet, coords, R, G):
    """M [3(alpha), nao, nao] at a nucleus R [3] about G, or [nR, 3, nao,
    nao] for R [nR, 3]."""
    Rn, one = _nuclei(R, coords)
    G = torch.as_tensor(G, dtype=coords.dtype, device=coords.device)
    out = assemble_1e(
        basis, coords,
        lambda la, lb, *args: m_block(la, lb, *args, Rn, G), (len(Rn), 3),
        lambda la, lb: len(Rn) * _hermite_cost(la, lb, 3))
    return out[0] if one else out


def h01_integrals(basis: BasisSet, coords, R):
    """h01[gamma] = <mu| [(r-R) x grad]_gamma / |r-R|^3 |nu> [3, nao, nao]
    at a nucleus R [3], or [nR, 3, nao, nao] for R [nR, 3] (the real
    antisymmetric part; the physical operator is -i*h01)."""
    Rn, one = _nuclei(R, coords)
    out = assemble_1e(
        basis, coords,
        lambda la, lb, *args: h01_of(w_block(la, lb, *args, Rn,
                                             deriv=True)), (len(Rn), 3),
        lambda la, lb: len(Rn) * _hermite_cost(la, lb, 3) * 3)
    return out[0] if one else out


def dia_integrals(basis: BasisSet, coords, R, G):
    """dia[alpha, beta] = <mu| [(r-G).(r-R) d_ab - (r-R)_alpha (r-G)_beta]
    / |r-R|^3 |nu> [3, 3, nao, nao] at a nucleus R [3], or [nR, 3, 3, nao,
    nao] for R [nR, 3]."""
    Rn, one = _nuclei(R, coords)
    G = torch.as_tensor(G, dtype=coords.dtype, device=coords.device)
    out = assemble_1e(
        basis, coords,
        lambda la, lb, *args: dia_of(m_block(la, lb, *args, Rn, G,
                                             deriv=True)), (len(Rn), 3, 3),
        lambda la, lb: len(Rn) * _hermite_cost(la, lb, 3) * 3)
    return out[0] if one else out

