"""Redundant internal coordinates with an autodiff Wilson B matrix.

Port of ``cctpu/geomopt/internal.py``. The coordinate selection (bond
perception, fragment linking, angle and dihedral lists) is host numpy,
copied as it is, so the index lists are cctpu's. q(x) is written once,
vectorized over index tensors (bonds [nb, 2], angles [na, 3], dihedrals
[nd, 4]) with cctpu's ``clip(+-(1 - 1e-10))`` and ``atan2`` forms, and
B = ``torch.func.jacfwd(q)`` in f64.

This is host bookkeeping of size nq x 3N, like the optimizer's ``pinv``
and RFO ``eigh``: it runs on the CPU on purpose, whatever device the SCF
runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from cctpu_torch.core import elements as elem
from cctpu_torch.core.constants import ANG2BOHR


def detect_bonds(Z: np.ndarray, coords: np.ndarray, scale: float = 1.3):
    """Bond list from covalent radii; guarantees a connected graph by
    linking nearest fragments."""
    natm = len(Z)
    rad = np.array([elem.COVALENT_RADII[int(z)] if z > 0 else 0.3
                    for z in Z]) * ANG2BOHR
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    cut = scale * (rad[:, None] + rad[None, :])
    bonds = [(i, j) for i in range(natm) for j in range(i + 1, natm)
             if d[i, j] < cut[i, j]]
    # union-find to connect fragments
    parent = list(range(natm))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in bonds:
        parent[find(i)] = find(j)
    while True:
        roots = {find(i) for i in range(natm)}
        if len(roots) <= 1:
            break
        # link closest pair across two fragments
        best = None
        for i in range(natm):
            for j in range(i + 1, natm):
                if find(i) != find(j):
                    if best is None or d[i, j] < best[0]:
                        best = (d[i, j], i, j)
        _, i, j = best
        bonds.append((i, j))
        parent[find(i)] = find(j)
    return sorted(bonds)


def build_internals(Z: np.ndarray, coords: np.ndarray):
    """Return (bonds, angles, dihedrals) index lists."""
    natm = len(Z)
    bonds = detect_bonds(Z, coords)
    nbrs = [[] for _ in range(natm)]
    for i, j in bonds:
        nbrs[i].append(j)
        nbrs[j].append(i)

    def ang_value(i, j, k):
        v1 = coords[i] - coords[j]
        v2 = coords[k] - coords[j]
        c = v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2))
        return np.degrees(np.arccos(np.clip(c, -1, 1)))

    angles = []
    for j in range(natm):
        ns = sorted(nbrs[j])
        for a in range(len(ns)):
            for b in range(a + 1, len(ns)):
                i, k = ns[a], ns[b]
                if ang_value(i, j, k) < 175.0:   # skip near-linear
                    angles.append((i, j, k))

    dihedrals = []
    for (j, k) in bonds:
        for i in nbrs[j]:
            if i == k:
                continue
            if ang_value(i, j, k) > 175.0 or ang_value(i, j, k) < 5:
                continue
            for l in nbrs[k]:
                if l == j or l == i:
                    continue
                if ang_value(j, k, l) > 175.0 or ang_value(j, k, l) < 5:
                    continue
                dihedrals.append((i, j, k, l))
    return bonds, angles, dihedrals


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _index(pairs, width: int) -> torch.Tensor:
    return torch.as_tensor(np.asarray(pairs, dtype=np.int64).reshape(
        -1, width))


class InternalCoords:
    """q(x) in torch, vectorized over the index lists; B = jacfwd(q) on the
    CPU in f64; diagonal model Hessian guess."""

    def __init__(self, Z: np.ndarray, coords: np.ndarray):
        self.bonds, self.angles, self.dihedrals = build_internals(Z, coords)
        self.n_bond = len(self.bonds)
        self.n_ang = len(self.angles)
        self.n_dih = len(self.dihedrals)
        self.nq = self.n_bond + self.n_ang + self.n_dih
        self._b = _index(self.bonds, 2)
        self._a = _index(self.angles, 3)
        self._d = _index(self.dihedrals, 4)
        self._jac = torch.func.jacfwd(self.q_of_flat)

    def q_of_flat(self, xflat: torch.Tensor) -> torch.Tensor:
        """[nq]: bond lengths, angles (arccos of the clipped cosine) and
        dihedrals (atan2), in the order of the index lists."""
        x = xflat.reshape(-1, 3)
        b = self._b
        bond = torch.linalg.vector_norm(x[b[:, 0]] - x[b[:, 1]], dim=-1)
        a = self._a
        v1 = x[a[:, 0]] - x[a[:, 1]]
        v2 = x[a[:, 2]] - x[a[:, 1]]
        c = _dot(v1, v2) / torch.sqrt(_dot(v1, v1) * _dot(v2, v2))
        ang = torch.arccos(torch.clamp(c, -1 + 1e-10, 1 - 1e-10))
        d = self._d
        b1 = x[d[:, 1]] - x[d[:, 0]]
        b2 = x[d[:, 2]] - x[d[:, 1]]
        b3 = x[d[:, 3]] - x[d[:, 2]]
        n1 = torch.linalg.cross(b1, b2)
        n2 = torch.linalg.cross(b2, b3)
        m1 = torch.linalg.cross(
            n1, b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True))
        dih = torch.atan2(_dot(m1, n2), _dot(n1, n2))
        return torch.cat([bond, ang, dih])

    @staticmethod
    def _flat(coords) -> torch.Tensor:
        return torch.as_tensor(np.asarray(coords, dtype=np.float64).ravel())

    def q(self, coords) -> np.ndarray:
        return self.q_of_flat(self._flat(coords)).numpy()

    def B(self, coords) -> np.ndarray:
        return self._jac(self._flat(coords)).numpy()

    def diff(self, q1, q0):
        """q1 - q0 with dihedral 2π wrapping."""
        d = q1 - q0
        s = self.n_bond + self.n_ang
        dih = d[s:]
        dih = (dih + np.pi) % (2 * np.pi) - np.pi
        d[s:] = dih
        return d

    def guess_hessian(self) -> np.ndarray:
        h = ([0.5] * self.n_bond + [0.2] * self.n_ang + [0.1] * self.n_dih)
        return np.diag(np.array(h))
