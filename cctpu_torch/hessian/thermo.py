"""Ideal-gas RRHO thermochemistry at (T, P).

A copy of ``cctpu/hessian/thermo.py`` (host numpy). Mirrors PySCF
``hessian.thermo.thermo`` semantics used by the reference
(reference opt-freq.py:499-506: dict with 'ZPE', 'E_tot', 'H_tot', 'G_tot',
'S_tot'; values are (value, unit) pairs with [0] the total in Ha). Defaults
T=298.15 K, P=101325 Pa.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from cctpu_torch.core import constants as const
from cctpu_torch.core.molecule import Molecule


def thermo(mol: Molecule, freq_au: np.ndarray, e_elec: float,
           temperature: float = const.T_STANDARD,
           pressure: float = const.P_STANDARD,
           sym_number: float = 1.0) -> Dict:
    """freq_au: harmonic frequencies in atomic units (sqrt of mass-weighted
    Hessian eigenvalues); imaginary (negative) modes are excluded."""
    T = temperature
    kB = const.KB_SI
    h = const.PLANCK_SI
    R = const.R_GAS_SI
    beta_h = h / (kB * T)

    freq_au = np.asarray(freq_au)
    real = freq_au[freq_au > 1e-8]
    # nu in Hz: E_h = freq_au * Hartree; nu = freq_au * (E_h/h)
    nu = real * const.HARTREE2J / h

    # vibrational
    zpe_J = 0.5 * h * nu.sum()                      # per molecule
    x = beta_h * nu
    e_vib_J = (h * nu / (np.exp(x) - 1.0)).sum()
    s_vib = R * (x / (np.exp(x) - 1.0) - np.log1p(-np.exp(-x))).sum()

    # translational
    M_kg = mol.masses.sum() * const.AMU2KG
    q_trans = ((2 * math.pi * M_kg * kB * T / h ** 2) ** 1.5
               * kB * T / pressure)
    s_trans = R * (math.log(q_trans) + 2.5)
    e_trans_J = 1.5 * kB * T

    # rotational
    com = (mol.masses[:, None] * mol.coords).sum(0) / mol.masses.sum()
    c = (mol.coords - com) * const.BOHR_SI          # Bohr -> m
    m = mol.masses * const.AMU2KG
    I = np.zeros((3, 3))
    for i in range(mol.natm):
        r = c[i]
        I += m[i] * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
    Ivals = np.sort(np.linalg.eigvalsh(I))
    linear = Ivals[0] < 1e-50 or mol.natm < 3 and abs(Ivals[0]) < 1e-47
    if mol.natm == 1:
        s_rot = 0.0
        e_rot_J = 0.0
    elif linear:
        Ib = Ivals[-1]
        q_rot = 8 * math.pi ** 2 * Ib * kB * T / (sym_number * h ** 2)
        s_rot = R * (math.log(q_rot) + 1.0)
        e_rot_J = kB * T
    else:
        qs = (8 * math.pi ** 2 * kB * T / h ** 2) ** 1.5
        q_rot = (math.pi ** 0.5 / sym_number
                 * qs * np.prod(Ivals) ** 0.5)
        s_rot = R * (math.log(q_rot) + 1.5)
        e_rot_J = 1.5 * kB * T

    J2Ha = 1.0 / const.HARTREE2J
    zpe = zpe_J * J2Ha
    e_therm = (e_vib_J + e_trans_J + e_rot_J) * J2Ha + zpe
    h_corr = e_therm + kB * T * J2Ha
    s_tot_J = s_trans + s_rot + s_vib                  # J/mol/K
    s_tot_Ha = s_tot_J / const.AVOGADRO * J2Ha         # Ha/K per molecule
    g_corr = h_corr - T * s_tot_Ha

    res = {
        "temperature": (T, "K"),
        "pressure": (pressure, "Pa"),
        "ZPE": (zpe, "Eh"),
        "E_elec": (e_elec, "Eh"),
        "E_vib": ((e_vib_J * J2Ha + zpe), "Eh"),
        "E_trans": (e_trans_J * J2Ha, "Eh"),
        "E_rot": (e_rot_J * J2Ha, "Eh"),
        "E_0K": (e_elec + zpe, "Eh"),
        "E_tot": (e_elec + e_therm, "Eh"),
        "H_tot": (e_elec + h_corr, "Eh"),
        "G_tot": (e_elec + g_corr, "Eh"),
        "S_tot": (s_tot_J, "J/mol/K"),
        "S_trans": (s_trans, "J/mol/K"),
        "S_rot": (s_rot, "J/mol/K"),
        "S_vib": (s_vib, "J/mol/K"),
    }
    return res
