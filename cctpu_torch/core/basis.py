"""Gaussian basis machinery: parsing, normalization, spherical AOs, and the
TPU-friendly class-grouped shell layout.

Design (SURVEY.md §7.1 layer 0): TPU/XLA wants static shapes and regular
batches, so after parsing we group shells by angular momentum `l`, pad the
primitive dimension per group to a common width, and keep per-group arrays
(exps, coefs, centers, AO offsets). All integral kernels then vmap over the
members of an (la, lb) class with fully static shapes.

Conventions:
 - Spherical (pure) AOs everywhere, matching PySCF's ``cart=False`` default
   that the reference templates rely on.
 - AO_{lm}(r) = R(r) * S_lm(theta, phi) with S_lm the orthonormal real
   spherical harmonic and R(r) = r^l sum_i d_i exp(-a_i r^2) normalized to
   int R^2 r^2 dr = 1. The cart->sph matrix T satisfies
   r^l S_lm = sum_cart T[m, cart] x^a y^b z^c exactly (harmonic polynomial),
   so spherical integrals are T @ I_cart @ T'.
 - Cartesian monomials within a shell are ordered lexicographically with lx
   descending (xx, xy, xz, yy, yz, zz for d) like libcint.
"""

from __future__ import annotations

import dataclasses
import math
import re
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from cctpu_torch.core.basis_data import get_basis_text

_L_OF = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4, "H": 5, "I": 6}
L_SYMBOLS = "spdfghi"


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def nsph(l: int) -> int:
    return 2 * l + 1


def cart_components(l: int) -> List[Tuple[int, int, int]]:
    """Cartesian monomial powers, lx descending then ly descending."""
    out = []
    for lx in range(l, -1, -1):
        for ly in range(l - lx, -1, -1):
            out.append((lx, ly, l - lx - ly))
    return out


# ----------------------------------------------------------------------------
# Real spherical harmonics -> cartesian monomial coefficients (exact, solved
# numerically from the polynomial identity on unit vectors).
# ----------------------------------------------------------------------------

def _real_sph_harm(l: int, m: int, xyz: np.ndarray) -> np.ndarray:
    """Orthonormal real spherical harmonics S_lm on unit vectors xyz [n,3].

    Built from associated Legendre polynomials with Condon-Shortley phase
    removed (standard real-solid-harmonic convention used by quantum
    chemistry codes): S_{l0} = N P_l^0(cos t); S_{lm} ~ cos(m phi), m>0;
    ~ sin(|m| phi), m<0.
    """
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    ct = np.clip(z, -1.0, 1.0)
    phi = np.arctan2(y, x)
    am = abs(m)
    # Associated Legendre P_l^m(ct) without Condon-Shortley phase.
    # Stable upward recursion.
    st = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
    pmm = np.ones_like(ct)
    for i in range(1, am + 1):
        pmm = pmm * (2 * i - 1) * st
    if l == am:
        plm = pmm
    else:
        pmmp1 = ct * (2 * am + 1) * pmm
        if l == am + 1:
            plm = pmmp1
        else:
            for ll in range(am + 2, l + 1):
                plm_new = ((2 * ll - 1) * ct * pmmp1 -
                           (ll + am - 1) * pmm) / (ll - am)
                pmm, pmmp1 = pmmp1, plm_new
            plm = pmmp1
    norm = math.sqrt((2 * l + 1) / (4 * math.pi) *
                     math.factorial(l - am) / math.factorial(l + am))
    if m == 0:
        return norm * plm
    if m > 0:
        return math.sqrt(2.0) * norm * plm * np.cos(am * phi)
    return math.sqrt(2.0) * norm * plm * np.sin(am * phi)


@lru_cache(maxsize=None)
def cart2sph(l: int) -> np.ndarray:
    """T[2l+1, ncart] with r^l S_lm = sum T[m,c] * monomial_c (exact)."""
    comps = cart_components(l)
    nc = len(comps)
    # Deterministic well-conditioned unit vectors (Fibonacci sphere).
    n = max(4 * nc, 64)
    k = np.arange(n, dtype=np.float64)
    zc = 1.0 - 2.0 * (k + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - zc * zc))
    golden = math.pi * (3.0 - math.sqrt(5.0))
    xyz = np.stack([r * np.cos(golden * k), r * np.sin(golden * k), zc], 1)
    A = np.stack([xyz[:, 0] ** a * xyz[:, 1] ** b * xyz[:, 2] ** c
                  for (a, b, c) in comps], 1)       # [n, ncart]
    T = np.empty((2 * l + 1, nc))
    # Order m = -l..l (PySCF spherical ordering).
    for i, m in enumerate(range(-l, l + 1)):
        yv = _real_sph_harm(l, m, xyz)
        coef, *_ = np.linalg.lstsq(A, yv, rcond=None)
        coef[np.abs(coef) < 1e-12] = 0.0
        T[i] = coef
    return T


# ----------------------------------------------------------------------------
# Parsing + normalization
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Shell:
    atom: int           # atom index in the molecule
    l: int
    exps: np.ndarray    # [nprim]
    coefs: np.ndarray   # [nprim] — includes radial norms; contraction normalized
    ao_start: int = 0   # offset into the spherical AO vector


def _radial_norm(alpha: np.ndarray, l: int) -> np.ndarray:
    """N with int (N r^l e^{-a r^2})^2 r^2 dr = 1."""
    return np.sqrt(2.0 * (2.0 * alpha) ** (l + 1.5) / math.gamma(l + 1.5))


def normalize_contraction(l: int, exps: np.ndarray,
                          coefs: np.ndarray) -> np.ndarray:
    """Scale raw contraction coefficients so the contracted AO is normalized.

    Returns d_i = c_i * N_rad(a_i) / sqrt(S) with
    S = sum_ij c_i c_j N_i N_j * Gamma(l+3/2) / (2 (a_i+a_j)^{l+3/2}).
    """
    N = _radial_norm(exps, l)
    d = coefs * N
    aij = exps[:, None] + exps[None, :]
    S = np.einsum("i,j,ij->", d, d,
                  math.gamma(l + 1.5) / (2.0 * aij ** (l + 1.5)))
    return d / math.sqrt(S)


def parse_nwchem(text: str) -> Dict[str, List[Tuple[int, np.ndarray, np.ndarray]]]:
    """Parse NWChem-format basis text -> {element: [(l, exps, coefs), ...]}.

    SP shells are split into separate S and P shells sharing exponents.
    """
    out: Dict[str, List[Tuple[int, np.ndarray, np.ndarray]]] = {}
    lines = [ln for ln in text.splitlines()
             if ln.strip() and not ln.strip().startswith(("#", "!"))]
    i = 0
    cur = None  # (element, kind, rows)
    def flush():
        nonlocal cur
        if cur is None:
            return
        el, kind, rows = cur
        arr = np.array(rows, dtype=np.float64)
        exps = arr[:, 0]
        shells = out.setdefault(el, [])
        if kind == "SP":
            shells.append((0, exps, arr[:, 1]))
            shells.append((1, exps, arr[:, 2]))
        else:
            l = _L_OF[kind]
            for col in range(1, arr.shape[1]):
                shells.append((l, exps, arr[:, col]))
        cur = None

    header = re.compile(r"^([A-Za-z]{1,2})\s+(S|P|D|F|G|H|I|SP)\s*$")
    while i < len(lines):
        ln = lines[i].strip()
        up = ln.upper()
        if up in ("BASIS", "END") or up.startswith("BASIS"):
            flush()
            i += 1
            continue
        m = header.match(ln)
        if m:
            flush()
            cur = (m.group(1).capitalize(), m.group(2).upper(), [])
            i += 1
            continue
        if cur is None:
            raise ValueError(f"unexpected basis line: {ln!r}")
        cur[2].append([float(tok.replace("D", "E").replace("d", "e"))
                       for tok in ln.split()])
        i += 1
    flush()
    return out


# ----------------------------------------------------------------------------
# BasisSet: molecule-level shell list + class-grouped padded layout
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class ShellGroup:
    """All shells of one angular momentum, padded to a common nprim."""
    l: int
    shell_idx: np.ndarray    # [ns] index into BasisSet.shells
    atom_idx: np.ndarray     # [ns]
    exps: np.ndarray         # [ns, npmax] zero-padded (pad exp=1, coef=0)
    coefs: np.ndarray        # [ns, npmax]
    centers: np.ndarray      # [ns, 3] Bohr
    ao_start: np.ndarray     # [ns] offsets into AO vector


class BasisSet:
    def __init__(self, shells: List[Shell], coords: np.ndarray):
        """shells in input order; coords [natm,3] Bohr."""
        self.shells = shells
        ao = 0
        for sh in shells:
            sh.ao_start = ao
            ao += nsph(sh.l)
        self.nao = ao
        self.lmax = max((sh.l for sh in shells), default=0)
        self.groups: Dict[int, ShellGroup] = {}
        for l in sorted({sh.l for sh in shells}):
            idx = [i for i, sh in enumerate(shells) if sh.l == l]
            npmax = max(len(shells[i].exps) for i in idx)
            ns = len(idx)
            exps = np.ones((ns, npmax))
            coefs = np.zeros((ns, npmax))
            for r, i in enumerate(idx):
                k = len(shells[i].exps)
                exps[r, :k] = shells[i].exps
                coefs[r, :k] = shells[i].coefs
            self.groups[l] = ShellGroup(
                l=l,
                shell_idx=np.array(idx, dtype=np.int64),
                atom_idx=np.array([shells[i].atom for i in idx], dtype=np.int64),
                exps=exps,
                coefs=coefs,
                centers=coords[[shells[i].atom for i in idx]],
                ao_start=np.array([shells[i].ao_start for i in idx],
                                  dtype=np.int64),
            )

    def ao_labels(self, symbols: List[str]) -> List[str]:
        labels = []
        per_atom_l_count: Dict[Tuple[int, int], int] = {}
        for sh in self.shells:
            n = per_atom_l_count.get((sh.atom, sh.l), 0)
            per_atom_l_count[(sh.atom, sh.l)] = n + 1
            for m in range(-sh.l, sh.l + 1):
                labels.append(
                    f"{sh.atom} {symbols[sh.atom]} "
                    f"{n + sh.l + 1}{L_SYMBOLS[sh.l]}({m:+d})")
        return labels


def build_basis(symbols: List[str], coords_bohr: np.ndarray,
                basis_name: str) -> BasisSet:
    """Build a BasisSet for a molecule. Ghost atoms (Z=0 via 'Ghost:X' or
    'X-' prefix handled upstream) get the basis of the underlying element but
    contribute no nuclear charge (handled in Molecule)."""
    from cctpu_torch.core.basis_data import FALLBACK_CHAIN
    table = parse_nwchem(get_basis_text(basis_name))
    fallback_tables = None
    shells: List[Shell] = []
    warned = set()
    for ia, sym in enumerate(symbols):
        el = sym.split(":")[-1].capitalize() if ":" in sym else sym.capitalize()
        el_table = table
        if el not in table:
            # per-element fallback down the chain (e.g. def2-TZVP lacks S:
            # S gets 6-31G** while C/H/O keep def2-TZVP) — logged, never
            # silent, and preferable to failing the whole workflow
            if fallback_tables is None:
                fallback_tables = [
                    (fb, parse_nwchem(get_basis_text(fb)))
                    for fb in FALLBACK_CHAIN
                    if fb.lower() != basis_name.lower()]
            for fb_name, fb_table in fallback_tables:
                if el in fb_table:
                    tz = basis_name.lower().startswith("def2-tz")
                    if (el, fb_name) not in warned:
                        import sys
                        extra = " (+2d1f TZ enrichment)" if tz else ""
                        print(f"WARNING: element {el} not in embedded "
                              f"{basis_name}; using {fb_name}{extra} "
                              f"for {el}", file=sys.stderr)
                        warned.add((el, fb_name))
                    if tz:
                        from cctpu_torch.core.basis_data.def2 import enrich_to_tz
                        el_table = dict(fb_table)
                        el_table[el] = enrich_to_tz(el, fb_table[el])
                    else:
                        el_table = fb_table
                    break
            else:
                raise ValueError(
                    f"element {el} not available in embedded basis "
                    f"{basis_name!r} or any fallback (have: {sorted(table)})")
        for (l, exps, coefs) in el_table[el]:
            d = normalize_contraction(l, exps, coefs)
            shells.append(Shell(atom=ia, l=l, exps=exps.copy(), coefs=d))
    return BasisSet(shells, coords_bohr)
