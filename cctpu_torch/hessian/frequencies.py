"""Hessians by finite differences, harmonic frequencies, IR intensities.

Port of ``cctpu/hessian/frequencies.py``. The Hessian is the central
difference of the analytic gradient over 6N displaced geometries, each
SCF warm-started from the reference density; the dipole derivatives for
IR intensities come from the same displaced SCFs. Each SCF and gradient
runs on the SCF's device; the normal-mode analysis is host numpy.

The analytic (CPHF) Hessian is not ported (ROADMAP.md queue 1 item 12):
``hessian_auto`` takes the FD route and says so.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from cctpu_torch.core.constants import AMU2AU, HARTREE2WAVENUMBER, \
    IR_KM_MOL
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.grad.scf_grad import gradient as scf_gradient

FD_STEP = 1e-3      # bohr


@dataclasses.dataclass
class HarmonicResult:
    freq_wavenumber: np.ndarray      # [nmode] (imaginary as negative)
    modes: np.ndarray                # [nmode, natm, 3], mass-weighted
    hessian: np.ndarray              # [natm*3, natm*3] cartesian (Ha/Bohr^2)
    ir_intensity: Optional[np.ndarray] = None   # [nmode] km/mol
    n_imaginary: int = 0
    freq_au: Optional[np.ndarray] = None


def hessian_fd(mf_factory: Callable[[Molecule], object], mol: Molecule,
               dm0=None, step: float = FD_STEP, with_dipole: bool = True,
               verbose: int = 0):
    """Cartesian Hessian by central differences (``step`` bohr) of
    analytic gradients, and, ``with_dipole``, the dipole derivatives of the
    same SCFs.

    Returns (H [3N,3N], dmu_dR [3N,3] or None), host numpy. Each of the 6N
    displaced SCF solves is warm-started from dm0.
    """
    natm = mol.natm
    n3 = 3 * natm
    H = np.zeros((n3, n3))
    dmu = np.zeros((n3, 3)) if with_dipole else None

    for k in range(n3):
        ia, d = divmod(k, 3)
        gs = []
        mus = []
        for sgn in (+1, -1):
            c = mol.coords.copy()
            c[ia, d] += sgn * step
            mf = mf_factory(mol.with_coords(c))
            mf.opts.verbose = 0
            mf.kernel(dm0=dm0)
            gs.append(scf_gradient(mf).cpu().numpy().ravel())
            if with_dipole:
                mus.append(mf.dip_moment(unit="au"))
            del mf
        H[k] = (gs[0] - gs[1]) / (2 * step)
        if with_dipole:
            dmu[k] = (mus[0] - mus[1]) / (2 * step)
        if verbose:
            print(f"  hessian displacement {k + 1}/{n3} done")
    H = 0.5 * (H + H.T)
    return H, dmu


def harmonic_analysis(mol: Molecule, H: np.ndarray,
                      dmu_dR: Optional[np.ndarray] = None) -> HarmonicResult:
    """Mass-weighted normal-mode analysis with translation/rotation
    projection; IR intensities from dipole derivatives if given.

    Matches PySCF hessian.thermo.harmonic_analysis semantics (frequencies in
    cm^-1, imaginary reported as negative values).
    """
    natm = mol.natm
    masses = mol.masses * AMU2AU              # electron-mass units
    sq = np.repeat(np.sqrt(masses), 3)
    Hmw = H / sq[:, None] / sq[None, :]

    # projection of translations+rotations
    coords = mol.coords - (mol.masses[:, None] * mol.coords).sum(0) \
        / mol.masses.sum()
    vecs = []
    for d in range(3):
        t = np.zeros((natm, 3))
        t[:, d] = np.sqrt(masses)
        vecs.append(t.ravel())
    for d in range(3):
        r = np.zeros((natm, 3))
        ax = np.zeros(3)
        ax[d] = 1.0
        r[:] = np.cross(np.tile(ax, (natm, 1)), coords)
        r *= np.sqrt(masses)[:, None]
        vecs.append(r.ravel())
    V = np.stack(vecs, axis=1)
    # an orthonormal basis of the rigid modes' span (5 or 6 vectors): a
    # linear molecule off the axes has three nonzero rotation vectors of
    # rank 2, where cctpu's QR keeps a spurious sixth column that projects
    # out a vibration (ROADMAP.md queue 3)
    U, s, _ = np.linalg.svd(V, full_matrices=False)
    Q = U[:, s > 1e-8 * s.max()]
    P = np.eye(3 * natm) - Q @ Q.T
    Hmw = P @ Hmw @ P

    w, U = np.linalg.eigh(Hmw)
    # drop the 5/6 smallest-|w| TR modes
    ntr = 5 if _is_linear(mol) else 6
    order = np.argsort(np.abs(w))
    keep = np.sort(order[ntr:])
    w = w[keep]
    U = U[:, keep]

    freq_au = np.sign(w) * np.sqrt(np.abs(w))
    freq_cm = freq_au * HARTREE2WAVENUMBER
    modes = (U / sq[:, None]).T.reshape(-1, natm, 3)

    ir = None
    if dmu_dR is not None:
        # dmu/dQ_k = sum_i dmu/dx_i * U_ik / sqrt(m_i)
        # (in e*bohr/(bohr*sqrt(me)))
        dmudq = np.einsum("id,ik->kd", dmu_dR, U / sq[:, None])
        # convert to (e*bohr/ (bohr*sqrt(amu))): multiply sqrt(AMU2AU)
        dmudq_amu = dmudq * np.sqrt(AMU2AU)
        ir = IR_KM_MOL * np.einsum("kd,kd->k", dmudq_amu, dmudq_amu)

    nimag = int((freq_cm < -5.0).sum())
    return HarmonicResult(freq_wavenumber=freq_cm, modes=modes, hessian=H,
                          ir_intensity=ir, n_imaginary=nimag,
                          freq_au=freq_au)


def _is_linear(mol: Molecule, tol: float = 1e-6) -> bool:
    if mol.natm < 3:
        return True
    c = mol.coords - mol.coords.mean(0)
    _, s, _ = np.linalg.svd(c)
    return s[1] < tol


def hessian_auto(mf, factory, mol, dm0=None, with_dipole: bool = True,
                 log=None, step: float = FD_STEP):
    """The Hessian of the converged SCF ``mf`` at ``mol``: the FD of
    analytic gradients, each displaced SCF warm-started from ``dm0``.
    cctpu tries its analytic CPHF Hessian first; that is not ported, so
    this takes the FD route outright. Returns (H [3N,3N], dmu_dR [3N,3] or
    None)."""
    if log:
        log("  Hessian: FD of analytic gradients (analytic CPHF: ROADMAP "
            "queue 1 item 12)")
    return hessian_fd(factory, mol, dm0=dm0, step=step,
                      with_dipole=with_dipole)
