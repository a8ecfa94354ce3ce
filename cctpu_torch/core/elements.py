"""Periodic-table data: symbols, masses, radii.

Masses are standard atomic weights (IUPAC, matching PySCF's
``pyscf.data.elements.MASSES`` to the digits shown). Bragg–Slater radii (in
Angstrom) drive the Becke partitioning; covalent radii drive bond perception
in the SMILES/3D front-end.
"""

from __future__ import annotations

ELEMENTS = [
    "X",  # ghost / dummy
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
]

SYMBOL2Z = {s: z for z, s in enumerate(ELEMENTS)}
SYMBOL2Z.update({s.upper(): z for z, s in enumerate(ELEMENTS)})

# Standard atomic weights (amu).
MASSES = [
    0.0,
    1.008, 4.002602,
    6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999, 18.998403163, 20.1797,
    22.98976928, 24.305, 26.9815385, 28.085, 30.973761998, 32.06, 35.45,
    39.948,
    39.0983, 40.078, 44.955908, 47.867, 50.9415, 51.9961, 54.938044,
    55.845, 58.933194, 58.6934, 63.546, 65.38,
    69.723, 72.630, 74.921595, 78.971, 79.904, 83.798,
    85.4678, 87.62, 88.90584, 91.224, 92.90637, 95.95, 98.0, 101.07,
    102.90550, 106.42, 107.8682, 112.414,
    114.818, 118.710, 121.760, 127.60, 126.90447, 131.293,
]

# Most-abundant-isotope masses (amu) — used for vibrational analysis, matching
# PySCF's hessian.thermo which uses isotope masses (e.g. 1H = 1.00782503).
ISOTOPE_MASSES = [
    0.0,
    1.00782503207, 4.002603254,
    7.016004548, 9.012182201, 11.009305406, 12.0, 14.003074005, 15.994914620,
    18.998403224, 19.99244017,
    22.989769281, 23.985041699, 26.981538627, 27.976926532, 30.973761629,
    31.972070999, 34.968852682, 39.962383123,
    38.963706679, 39.962590983, 44.955911909, 47.947946281, 50.943959507,
    51.940507472, 54.938045141, 55.934937475, 58.933195048, 57.935342907,
    62.929597474, 63.929142222,
    68.925573587, 73.921177767, 74.921596478, 79.916521271, 78.918337087,
    85.910610729,
    84.911789737, 87.905612124, 88.905848295, 89.904704416, 92.906378058,
    97.905408169, 98.906254747, 101.904349312, 102.905504292, 105.903485715,
    106.90509682, 113.90335854,
    114.903878484, 119.902194676, 120.903815686, 129.906224399, 126.904472681,
    131.904153457,
]

# Bragg–Slater atomic radii (Angstrom) for Becke fuzzy-cell weights.
# (J. C. Slater, JCP 41, 3199 (1964); H gets 0.35 as in PySCF's dft.radi.)
BRAGG_RADII = [
    1.0,
    0.35, 1.40,
    1.45, 1.05, 0.85, 0.70, 0.65, 0.60, 0.50, 1.50,
    1.80, 1.50, 1.25, 1.10, 1.00, 1.00, 1.00, 1.88,
    2.20, 1.80, 1.60, 1.40, 1.35, 1.40, 1.40, 1.40, 1.35, 1.35, 1.35, 1.35,
    1.30, 1.25, 1.15, 1.15, 1.15, 2.02,
    2.35, 2.00, 1.80, 1.55, 1.45, 1.45, 1.35, 1.30, 1.35, 1.40, 1.60, 1.55,
    1.55, 1.45, 1.45, 1.40, 1.40, 2.16,
]

# Covalent radii (Angstrom, Pyykkö & Atsumi 2009 single-bond) for bond
# perception / initial geometry embedding in the cheminformatics front-end.
COVALENT_RADII = [
    0.5,
    0.32, 0.46,
    1.33, 1.02, 0.85, 0.75, 0.71, 0.63, 0.64, 0.67,
    1.55, 1.39, 1.26, 1.16, 1.11, 1.03, 0.99, 0.96,
    1.96, 1.71, 1.48, 1.36, 1.34, 1.22, 1.19, 1.16, 1.11, 1.10, 1.12, 1.18,
    1.24, 1.21, 1.21, 1.16, 1.14, 1.17,
    2.10, 1.85, 1.63, 1.54, 1.47, 1.38, 1.28, 1.25, 1.25, 1.20, 1.28, 1.36,
    1.42, 1.40, 1.40, 1.36, 1.33, 1.31,
]

# Valence-electron counts for common organic elements (SMILES implicit-H rules).
DEFAULT_VALENCE = {
    "B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2, "F": 1, "Cl": 1,
    "Br": 1, "I": 1, "H": 1,
}


def symbol_to_z(sym: str) -> int:
    s = sym.strip()
    if s.lower().startswith("ghost"):
        return 0
    # Allow e.g. "Ghost:C" / "X-C" style ghosts handled by caller.
    if s in SYMBOL2Z:
        return SYMBOL2Z[s]
    s2 = s.capitalize()
    if s2 in SYMBOL2Z:
        return SYMBOL2Z[s2]
    raise ValueError(f"unknown element symbol: {sym!r}")
