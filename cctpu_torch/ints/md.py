"""McMurchie–Davidson (MD) Hermite-expansion machinery.

The same formulation as ``cctpu/ints/md.py`` in torch. All recursions run
over static angular-momentum bounds (Python loops), and every function takes
any number of leading batch axes, so the integral builders batch a whole
class of shell pairs or quartets as one written-out leading dimension.

 - E-table: Hermite expansion coefficients E_t^{ij} per cartesian direction.
 - R-tensor: Hermite Coulomb integrals R_{tuv} from the Boys ladder.

References: Helgaker, Jørgensen, Olsen, "Molecular Electronic-Structure
Theory", ch. 9.
"""

from __future__ import annotations

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

    E = [[[None] * (li + lj + 1) for _ in range(lj + 1)]
         for _ in range(li + 1)]
    E[0][0][0] = torch.exp(-mu * ab * ab)

    def get(i, j, t):
        if t < 0 or t > i + j or i < 0 or j < 0:
            return 0.0
        return E[i][j][t]

    for i in range(li + 1):
        for j in range(lj + 1):
            if i == 0 and j == 0:
                continue
            for t in range(i + j + 1):
                if j == 0:
                    E[i][j][t] = (inv2p * get(i - 1, j, t - 1)
                                  + pa * get(i - 1, j, t)
                                  + (t + 1) * get(i - 1, j, t + 1))
                else:
                    E[i][j][t] = (inv2p * get(i, j - 1, t - 1)
                                  + pb * get(i, j - 1, t)
                                  + (t + 1) * get(i, j - 1, t + 1))
    return E


def e3_components(la: int, lb: int, a, b, A, B):
    """Hermite expansion of a shell pair over all three directions.

    a: [..., npA, 1], b: [..., 1, npB]; A, B: [..., 3] (leading axes
    broadcast). Returns E3 [..., npA, npB, ncartA*ncartB, (lab+1)^3].
    """
    box = la + lb + 1
    shape = torch.broadcast_shapes(a.shape, b.shape)
    zero = torch.zeros(shape, dtype=a.dtype, device=a.device)
    comps_a = cart_components(la)
    comps_b = cart_components(lb)

    sel = []
    for d in range(3):
        ab = (A[..., d] - B[..., d])[..., None, None]
        tab = e_table_1d(la, lb, a, b, ab)
        flat = []
        for i in range(la + 1):
            for j in range(lb + 1):
                for t in range(box):
                    v = tab[i][j][t] if t <= i + j else None
                    flat.append(zero if v is None else v + zero)
        arr = torch.stack(flat).reshape(la + 1, lb + 1, box, *shape)
        ia = np.array([c[d] for c in comps_a])
        ib = np.array([c[d] for c in comps_b])
        IA = torch.as_tensor(np.repeat(ia, len(comps_b)), device=a.device)
        IB = torch.as_tensor(np.tile(ib, len(comps_a)), device=a.device)
        sel.append(arr[IA, IB])                      # [ncomp, box, ...]

    ex, ey, ez = sel
    E3 = (ex[:, :, None, None] * ey[:, None, :, None]
          * ez[:, None, None, :])                    # [nc, box^3 axes, ...]
    ncomp = E3.shape[0]
    E3 = E3.reshape(ncomp, box ** 3, *shape)
    return E3.permute(*range(2, E3.ndim), 0, 1)      # [..., nc, box^3]


def r_box(ltot: int, alpha, PQ):
    """Dense Hermite-Coulomb box R[..., (ltot+1)^3] (zeros where t+u+v >
    ltot). alpha: [...]; PQ: [..., 3]."""
    Rn = _r_recursion(ltot, alpha, PQ)
    box = ltot + 1
    zero = torch.zeros_like(Rn[(0, 0, 0, 0)])
    entries = []
    for t in range(box):
        for u in range(box):
            for v in range(box):
                entries.append((Rn[(0, t, u, v)] + zero)
                               if t + u + v <= ltot else zero)
    return torch.stack(entries, dim=-1)


def _r_recursion(lmax: int, p, PC) -> dict:
    """Hermite-Coulomb recursion: {(n,t,u,v): tensor}."""
    T = p * torch.sum(PC * PC, dim=-1)
    F = boys(T, lmax)
    Rn = {}
    neg2p = -2.0 * p
    pw = torch.ones_like(p)
    for n in range(lmax + 1):
        Rn[(n, 0, 0, 0)] = pw * F[n]
        pw = pw * neg2p
    x, y, z = PC[..., 0], PC[..., 1], PC[..., 2]

    def get(n, t, u, v):
        if t < 0 or u < 0 or v < 0:
            return 0.0
        return Rn[(n, t, u, v)]

    for total in range(1, lmax + 1):
        for t in range(total + 1):
            for u in range(total - t + 1):
                v = total - t - u
                for n in range(lmax - total + 1):
                    if t > 0:
                        Rn[(n, t, u, v)] = ((t - 1) * get(n + 1, t - 2, u, v)
                                            + x * get(n + 1, t - 1, u, v))
                    elif u > 0:
                        Rn[(n, t, u, v)] = ((u - 1) * get(n + 1, t, u - 2, v)
                                            + y * get(n + 1, t, u - 1, v))
                    else:
                        Rn[(n, t, u, v)] = ((v - 1) * get(n + 1, t, u, v - 2)
                                            + z * get(n + 1, t, u, v - 1))
    return Rn


def r_tensor(lmax: int, p, PC) -> dict:
    """Hermite Coulomb integrals {(t,u,v): R_{tuv}(p, PC)}, t+u+v <= lmax."""
    Rn = _r_recursion(lmax, p, PC)
    return {(t, u, v): Rn[(0, t, u, v)]
            for t in range(lmax + 1)
            for u in range(lmax + 1 - t)
            for v in range(lmax + 1 - t - u)}
