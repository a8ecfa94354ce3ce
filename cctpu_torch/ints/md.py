"""McMurchie–Davidson (MD) Hermite-expansion machinery.

The same formulation as ``cctpu/ints/md.py`` in torch. All recursions run
over static angular-momentum bounds (Python loops), and every function takes
any number of leading batch axes, so the integral builders batch a whole
class of shell pairs or quartets as one written-out leading dimension.

 - E-table: Hermite expansion coefficients E_t^{ij} per cartesian
   direction, each (i, j) row over all t at once.
 - R-tensor: Hermite Coulomb integrals R_{tuv} from the Boys ladder, level
   t + u + v by level.

Both recursions are laid out as a few tensor operations a row or level, in
place of one per entry (each a kernel launch on the card), with the same
terms summed in the same order, so every integral is bitwise the entry-wise
recursion's; their index tables are copied to the device once.

References: Helgaker, Jørgensen, Olsen, "Molecular Electronic-Structure
Theory", ch. 9.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cctpu_torch.core.basis import cart_components
from cctpu_torch.ints.boys import boys


def e_table_1d(li: int, lj: int, a, b, ab) -> list:
    """Hermite expansion coefficients E_t^{ij} for one cartesian direction.

    a, b: primitive exponents (any broadcastable shapes); ab = A_x - B_x.
    Returns nested list E[i][j][t] of tensors, i<=li, j<=lj, t<=i+j.
    Includes the Gaussian prefactor exp(-mu*ab^2) in E_0^{00}.
    """
    p = a + b
    inv2p = 0.5 / p
    mu = a * b / p
    pa = -(b / p) * ab
    pb = (a / p) * ab

    # E[i][j] as one tensor over t, level by level: with the previous
    # row padded by zeros, E_t = inv2p E'_{t-1} + x E'_t + (t+1) E'_{t+1}
    # for all t at once (x = pa along i, pb along j); a padding zero adds
    # exactly nothing, so each entry is the sum of the recursion's terms
    # in their order
    rows = [[None] * (lj + 1) for _ in range(li + 1)]
    rows[0][0] = torch.exp(-mu * ab * ab)[None]
    if li + lj == 0:
        return [[[rows[0][0][0]]]]
    shape = torch.broadcast_shapes(inv2p.shape, pa.shape, pb.shape,
                                   rows[0][0].shape[1:])
    z = torch.zeros((1, *shape), dtype=p.dtype, device=p.device)
    coefs = torch.arange(1, li + lj + 2, dtype=p.dtype,
                         device=p.device).reshape(-1, *[1] * len(shape))

    def step(prev, x):
        n = prev.shape[0]
        pad = torch.cat([z, torch.broadcast_to(prev, (n, *shape)), z, z])
        return (inv2p * pad[:n + 1] + x * pad[1:n + 2]) \
            + coefs[:n + 1] * pad[2:n + 3]

    for i in range(1, li + 1):
        rows[i][0] = step(rows[i - 1][0], pa)
    for i in range(li + 1):
        for j in range(1, lj + 1):
            rows[i][j] = step(rows[i][j - 1], pb)
    return [[list(rows[i][j].unbind(0)) for j in range(lj + 1)]
            for i in range(li + 1)]


@lru_cache(maxsize=None)
def _e3_index(la: int, lb: int, device) -> list:
    """Per direction the cartesian powers (IA, IB) of the component pairs
    of a (la, lb) shell pair, on ``device`` once (a copy from host memory
    waits for the device's queue)."""
    comps_a, comps_b = cart_components(la), cart_components(lb)
    out = []
    for d in range(3):
        ia = np.array([c[d] for c in comps_a])
        ib = np.array([c[d] for c in comps_b])
        out.append((torch.as_tensor(np.repeat(ia, len(comps_b)),
                                    device=device),
                    torch.as_tensor(np.tile(ib, len(comps_a)),
                                    device=device)))
    return out


def e3_components(la: int, lb: int, a, b, A, B):
    """Hermite expansion of a shell pair over all three directions.

    a: [..., npA, 1], b: [..., 1, npB]; A, B: [..., 3] (leading axes
    broadcast). Returns E3 [..., npA, npB, ncartA*ncartB, (lab+1)^3].
    """
    box = la + lb + 1
    shape = torch.broadcast_shapes(a.shape, b.shape)
    zero = torch.zeros(shape, dtype=a.dtype, device=a.device)
    sel = []
    for d, (IA, IB) in enumerate(_e3_index(la, lb, a.device)):
        ab = (A[..., d] - B[..., d])[..., None, None]
        tab = e_table_1d(la, lb, a, b, ab)
        flat = []
        for i in range(la + 1):
            for j in range(lb + 1):
                for t in range(box):
                    v = tab[i][j][t] if t <= i + j else None
                    flat.append(zero if v is None
                                else torch.broadcast_to(v, shape))
        arr = torch.stack(flat).reshape(la + 1, lb + 1, box, *shape)
        sel.append(arr[IA, IB])                      # [ncomp, box, ...]

    ex, ey, ez = sel
    E3 = (ex[:, :, None, None] * ey[:, None, :, None]
          * ez[:, None, None, :])                    # [nc, box^3 axes, ...]
    ncomp = E3.shape[0]
    E3 = E3.reshape(ncomp, box ** 3, *shape)
    return E3.permute(*range(2, E3.ndim), 0, 1)      # [..., nc, box^3]


@lru_cache(maxsize=None)
def _r_plan(lmax: int):
    """The Hermite-Coulomb recursion laid out by level k = t + u + v: per
    level the entries (t, u, v) in a fixed order, for each the axis a it
    recurs along (the first of t, u, v above 0), its index m on that axis
    and its two parents' positions in levels k - 1 (e - 1_a) and k - 2
    (e - 2_a; position 0 where m < 2, its coefficient m - 1 being 0); and
    the level and position of each (t, u, v) of the dense box."""
    levels = [[(0, 0, 0)]]
    pos = {(0, 0, 0): (0, 0)}
    steps = []
    for k in range(1, lmax + 1):
        ents = [(t, u, k - t - u) for t in range(k, -1, -1)
                for u in range(k - t, -1, -1)]
        axis, m1, p1, p2 = [], [], [], []
        for e in ents:
            a = next(i for i in range(3) if e[i] > 0)
            down1 = tuple(x - (i == a) for i, x in enumerate(e))
            down2 = tuple(x - 2 * (i == a) for i, x in enumerate(e))
            axis.append(a)
            m1.append(e[a] - 1)
            p1.append(pos[down1][1])
            p2.append(pos[down2][1] if e[a] >= 2 else 0)
        for i, e in enumerate(ents):
            pos[e] = (k, i)
        levels.append(ents)
        steps.append((np.array(axis), np.array(m1, float), np.array(p1),
                      np.array(p2)))
    return levels, pos, steps


def _r_levels(lmax: int, p, PC):
    """R_{n,t,u,v} by levels: a list over k of [lmax - k + 1 (n), entries
    of level k, ...]: the same recursion, term by term, as the dict of
    scalars it replaces (R_{n,e} = (m - 1) R_{n+1, e - 2_a} + X_a R_{n+1,
    e - 1_a}), a few tensor operations a level."""
    T = p * torch.sum(PC * PC, dim=-1)
    F = boys(T, lmax)
    neg2p = -2.0 * p
    pw = torch.ones_like(p)
    r0 = []
    for n in range(lmax + 1):
        r0.append(pw * F[n])
        pw = pw * neg2p
    L = [torch.stack(r0)[:, None]]                  # [n, 1, ...]
    XYZ = torch.movedim(PC, -1, 0)                  # [3, ...]
    tail = (1,) * T.ndim
    for k, (axis, m1, p1, p2) in enumerate(
            _r_plan_on(lmax, p.device, p.dtype), start=1):
        nn = lmax - k + 1
        term = XYZ[axis] * L[k - 1][1:nn + 1][:, p1]
        if k >= 2:
            term = m1.reshape(-1, *tail) * L[k - 2][1:nn + 1][:, p2] + term
        L.append(term)
    return L


@lru_cache(maxsize=None)
def _r_plan_on(lmax: int, device, dtype) -> list:
    """``_r_plan``'s index and coefficient arrays on ``device`` once."""
    return [(torch.as_tensor(axis, device=device),
             torch.as_tensor(m1, dtype=dtype, device=device),
             torch.as_tensor(p1, device=device),
             torch.as_tensor(p2, device=device))
            for axis, m1, p1, p2 in _r_plan(lmax)[2]]


@lru_cache(maxsize=None)
def _box_index(ltot: int, device):
    """Position of each (t, u, v) of the dense box among the concatenated
    levels' n = 0 entries, the slot after them (a zero) where t + u + v >
    ltot."""
    levels, pos, _ = _r_plan(ltot)
    offs = np.cumsum([0] + [len(lv) for lv in levels])
    box = ltot + 1
    idx = [offs[pos[(t, u, v)][0]] + pos[(t, u, v)][1]
           if t + u + v <= ltot else offs[-1]
           for t in range(box) for u in range(box) for v in range(box)]
    return torch.as_tensor(idx, device=device)


def r_box(ltot: int, alpha, PQ):
    """Dense Hermite-Coulomb box R[..., (ltot+1)^3] (zeros where t+u+v >
    ltot). alpha: [...]; PQ: [..., 3]."""
    L = _r_levels(ltot, alpha, PQ)
    flat = torch.cat([lv[0] for lv in L] + [torch.zeros_like(L[0][0])])
    return torch.movedim(flat[_box_index(ltot, flat.device)], 0, -1)


def r_tensor(lmax: int, p, PC) -> dict:
    """Hermite Coulomb integrals {(t,u,v): R_{tuv}(p, PC)}, t+u+v <= lmax."""
    L = _r_levels(lmax, p, PC)
    _, pos, _ = _r_plan(lmax)
    return {e: L[k][0, i] for e, (k, i) in pos.items()}
