"""Molecular quadrature grids: Treutler–Ahlrichs radial x spherical product
angular grids with Becke fuzzy-cell partitioning.

Port of ``cctpu/dft/grids.py``. The radial/angular template (points in the
atomic frame + quadrature weights) is static host numpy; atom centering and
the Becke partition weights are computed in torch from the coordinates, on
their device, chunked over points.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cctpu_torch.core import elements as elem

# Treutler-Ahlrichs xi parameters (JCP 102, 346 (1995), Table 1).
_TA_XI = {
    1: 0.8, 2: 0.9,
    3: 1.8, 4: 1.4, 5: 1.3, 6: 1.1, 7: 0.9, 8: 0.9, 9: 0.9, 10: 0.9,
    11: 1.4, 12: 1.3, 13: 1.3, 14: 1.2, 15: 1.1, 16: 1.0, 17: 1.0, 18: 1.0,
    19: 1.5, 20: 1.4, 35: 1.1, 53: 1.1,
}


def radial_treutler(n: int, xi: float) -> Tuple[np.ndarray, np.ndarray]:
    """Treutler-Ahlrichs M4 radial grid (Chebyshev 2nd kind mapping)."""
    i = np.arange(1, n + 1)
    t = i * math.pi / (n + 1)
    x = np.cos(t)
    a = 0.6
    ln2 = 1.0 / math.log(2.0)
    r = xi * ln2 * (1 + x) ** a * np.log(2.0 / (1 - x))
    drdx = xi * ln2 * (1 + x) ** a * (
        a / (1 + x) * np.log(2.0 / (1 - x)) + 1.0 / (1 - x))
    w_cheb = math.pi / (n + 1) * np.sin(t) ** 2
    w = w_cheb / np.sin(t) * drdx * r ** 2
    return r, w


def angular_product(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Product angular grid exact for spherical harmonics up to `degree`:
    Gauss-Legendre in cos(theta) x uniform in phi. Returns unit vectors
    [n, 3] and weights summing to 4 pi."""
    n_t = degree // 2 + 1
    n_p = degree + 1
    xt, wt = np.polynomial.legendre.leggauss(n_t)
    phi = 2 * math.pi * np.arange(n_p) / n_p
    st = np.sqrt(1 - xt ** 2)
    pts = np.stack([
        np.outer(st, np.cos(phi)).ravel(),
        np.outer(st, np.sin(phi)).ravel(),
        np.outer(xt, np.ones(n_p)).ravel(),
    ], axis=1)
    w = np.outer(wt, np.ones(n_p) * (2 * math.pi / n_p)).ravel()
    return pts, w


# grid level -> (n_rad_H, n_rad_heavy, ang_degree_H, ang_degree_heavy)
_LEVELS = {
    0: (25, 35, 11, 17),
    1: (35, 50, 17, 23),
    2: (45, 60, 23, 29),
    3: (55, 75, 29, 35),
    4: (65, 90, 35, 41),
    5: (80, 105, 41, 47),
}


class Grids:
    """Molecular Becke grid. Template is static; weights follow coords."""

    def __init__(self, mol, level: int = 3):
        self.mol = mol
        self.level = level
        nr_h, nr_x, ad_h, ad_x = _LEVELS[level]
        Z = mol.charges.astype(int)
        atom_pts = []
        atom_wts = []
        for ia, z in enumerate(Z):
            nrad, adeg = (nr_h, ad_h) if z <= 2 else (nr_x, ad_x)
            xi = _TA_XI.get(int(z), 1.0)
            r, wr = radial_treutler(nrad, xi)
            u, wa = angular_product(adeg)
            pts = r[:, None, None] * u[None, :, :]
            w = wr[:, None] * wa[None, :]
            atom_pts.append(pts.reshape(-1, 3))
            atom_wts.append(w.reshape(-1))
        self.npts = sum(len(p) for p in atom_pts)
        self.point_atom = np.concatenate([
            np.full(len(p), ia, dtype=np.int64)
            for ia, p in enumerate(atom_pts)])
        self.template_pts = np.concatenate(atom_pts)     # atomic frame
        self.template_wts = np.concatenate(atom_wts)
        # Becke atomic-size adjustment from Bragg radii
        rad = np.array([elem.BRAGG_RADII[int(z)] if z > 0 else 1.0
                        for z in Z])
        chi = rad[:, None] / rad[None, :]
        uu = (chi - 1) / (chi + 1)
        a = uu / (uu ** 2 - 1)
        self._a_adjust = np.clip(a, -0.5, 0.5)

    def build(self, coords: torch.Tensor, start: int = 0,
              stop: int = None):
        """(points [n, 3], weights [n]) of the grid points ``start`` to
        ``stop`` (all of them by default) on ``coords``' device. Both follow
        ``coords`` under autograd: the points move with their atoms and the
        Becke weights with every atom."""
        dev, dt = coords.device, coords.dtype
        stop = self.npts if stop is None else min(stop, self.npts)
        own = torch.as_tensor(self.point_atom[start:stop], device=dev)
        pts = torch.as_tensor(self.template_pts[start:stop], dtype=dt,
                              device=dev) + coords[own]
        w0 = torch.as_tensor(self.template_wts[start:stop], dtype=dt,
                             device=dev)
        return pts, w0 * self._becke_weights(pts, coords, own)

    def _becke_weights(self, pts, coords, own):
        natm = coords.shape[0]
        dev, dt = coords.device, coords.dtype
        eye = torch.eye(natm, dtype=dt, device=dev)
        # the identity inside the sqrt keeps the zero diagonal finite
        dR = coords[:, None, :] - coords[None, :, :]
        R = torch.sqrt(torch.sum(dR * dR, dim=-1) + eye)
        a_adj = torch.as_tensor(self._a_adjust, dtype=dt, device=dev)
        eyeb = eye.bool()
        # the mu tensor is [chunk, natm, natm]: chunk over points
        chunk = max(256, int(2e7) // (natm * natm))
        chunk = 1 << (chunk.bit_length() - 1)
        out = []
        for s in range(0, pts.shape[0], chunk):
            p = pts[s:s + chunk]
            d = torch.linalg.vector_norm(p[:, None, :] - coords[None], dim=-1)
            mu = (d[:, :, None] - d[:, None, :]) / R[None, :, :]
            f = mu + a_adj[None] * (1 - mu ** 2)
            for _ in range(3):
                f = 1.5 * f - 0.5 * f ** 3
            sw = 0.5 * (1 - f)
            sw = torch.where(eyeb[None], torch.ones_like(sw), sw)
            P = torch.prod(sw, dim=2)                    # [chunk, natm]
            mine = torch.gather(P, 1, own[s:s + chunk, None])[:, 0]
            out.append(mine / torch.sum(P, dim=1))
        return torch.cat(out)
