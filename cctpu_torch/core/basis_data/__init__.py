"""Embedded Gaussian basis-set library.

The deployment environment has no network and no PySCF install, so the basis
sets the reference workflows default to (SURVEY.md §2.3: STO-3G, 6-31G,
6-31G*, 6-31+G*, 6-31+G**, 6-311G**, cc-pVDZ, def2-TZVP) are embedded here.

Provenance:
 - STO-3G is *generated* from the canonical least-squares 3-Gaussian fits to
   Slater orbitals (Hehre, Stewart, Pople, JCP 51, 2657 (1969)): universal
   fit exponents/coefficients per shell type scaled by tabulated zeta values.
 - Pople split-valence sets are the published tables (Hehre/Ditchfield/Pople
   6-31G; Krishnan/Binkley/Seeger/Pople 6-311G) with standard polarization
   (d=0.8 first row, p=1.1 on H; 6-311G**: d C 0.626 / N 0.913 / O 1.292,
   p H 0.75) and diffuse augmentations.
 - cc-pVDZ from Dunning (JCP 90, 1007 (1989)).
Each table records the digits of the published sets; golden tests pin total
energies so that regressions in this data are caught.
"""

from cctpu_torch.core.basis_data.sto3g import STO3G_NWCHEM
from cctpu_torch.core.basis_data.pople import POPLE_SETS
from cctpu_torch.core.basis_data.dunning import CCPVDZ_NWCHEM


# User-registered basis sets (NWChem-format text), consulted before the
# embedded tables — the analog of PySCF's `basis={'X': gto.parse(...)}`
# custom-basis input, exercised by scripts/derive_basis.py.
_CUSTOM = {}


def register_custom_basis(name: str, text: str) -> None:
    """Register (or override) a basis set by name with NWChem-format text."""
    _CUSTOM[name.lower().replace(" ", "")] = text


def get_basis_text(name: str) -> str:
    """Return NWChem-format text for a named basis set."""
    key = name.lower().replace(" ", "")
    if key in _CUSTOM:
        return _CUSTOM[key]
    aliases = {
        "sto-3g": "sto-3g", "sto3g": "sto-3g",
        "6-31g": "6-31g", "631g": "6-31g",
        "6-31g*": "6-31g*", "6-31g(d)": "6-31g*", "631g*": "6-31g*",
        "6-31g**": "6-31g**", "6-31g(d,p)": "6-31g**", "631g**": "6-31g**",
        "6-31+g*": "6-31+g*", "6-31+g(d)": "6-31+g*",
        "6-31+g**": "6-31+g**", "6-31+g(d,p)": "6-31+g**",
        "6-311g**": "6-311g**", "6-311g(d,p)": "6-311g**",
        "cc-pvdz": "cc-pvdz", "ccpvdz": "cc-pvdz",
        "def2-tzvp": "def2-tzvp", "def2tzvp": "def2-tzvp",
    }
    if key not in aliases:
        raise ValueError(f"unknown basis set {name!r}; available: "
                         f"{sorted(set(aliases.values()))}")
    key = aliases[key]
    if key == "sto-3g":
        return STO3G_NWCHEM
    if key == "cc-pvdz":
        return CCPVDZ_NWCHEM
    if key == "def2-tzvp":
        from cctpu_torch.core.basis_data.def2 import DEF2_TZVP_NWCHEM
        return DEF2_TZVP_NWCHEM
    return POPLE_SETS[key]


# Per-element fallback chain for elements missing from a named set
# (documented approximation; build_basis logs the substitution).
FALLBACK_CHAIN = ("6-311g**", "6-31g**", "6-31g", "sto-3g")
