"""SMILES parser and molecular-graph model.

The reference front-end is RDKit (C++), used purely host-side for
SMILES -> 3D structures (reference smiles_to_xyz, e.g.
templates/calculate_energy.py:62-81). RDKit is not available in this
deployment, so the framework ships its own parser + graph model +
3D embedding (io/embed3d.py) with the same deterministic-seed contract.

Supported: organic subset + bracket atoms ([NH4+], [O-], [nH], isotopes
ignored), bonds - = # : / \\, branches, ring closures (incl. %nn),
dot-separated fragments, aromatic perception of lowercase atoms with
kekulization by perfect matching, and STEREOCHEMISTRY: tetrahedral
@/@@ (neighbor order recorded in MolGraph.chiral_order, enforced as a
signed-volume constraint by io/embed3d.py) and cis/trans / and \\ bond
directions (Bond.direction, enforced as a double-bond torsion target).
The reference gets both from RDKit's ETKDG (templates/
calculate_energy.py:62-81, calculate_bde.py:57-60).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from cctpu_torch.core import elements as elem


@dataclasses.dataclass
class Atom:
    symbol: str
    charge: int = 0
    n_h: int = -1            # -1 = to be determined (implicit)
    aromatic: bool = False
    isotope: int = 0
    idx: int = 0
    chiral: str = ""         # "", "@" (anticlockwise) or "@@" (clockwise)


@dataclasses.dataclass
class Bond:
    i: int                   # written-order: i appeared before j
    j: int
    order: int = 1           # 1/2/3; aromatic resolved by kekulization
    aromatic: bool = False
    direction: int = 0       # +1 "/", -1 "\" (oriented i -> j), 0 plain


@dataclasses.dataclass
class MolGraph:
    atoms: List[Atom]
    bonds: List[Bond]
    # chiral atom idx -> neighbor indices in SMILES written order
    # (-1 marks the implicit H's slot); len 4 after H resolution
    chiral_order: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)

    @property
    def natoms(self):
        return len(self.atoms)

    def neighbors(self, i):
        out = []
        for b in self.bonds:
            if b.i == i:
                out.append((b.j, b))
            elif b.j == i:
                out.append((b.i, b))
        return out

    def bond_order_sum(self, i):
        return sum(b.order for _, b in self.neighbors(i))

    def formula(self) -> str:
        from collections import Counter
        c = Counter()
        for a in self.atoms:
            c[a.symbol] += 1
            c["H"] += max(a.n_h, 0)
        parts = []
        for s in ["C", "H"] + sorted(k for k in c if k not in ("C", "H")):
            if c[s]:
                parts.append(f"{s}{c[s] if c[s] > 1 else ''}")
        return "".join(parts)


_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_OK = {"b", "c", "n", "o", "p", "s", "se", "as"}

_BRACKET = re.compile(
    r"\[(?P<iso>\d+)?(?P<sym>[A-Za-z][a-z]?|\*)(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d)?)?"
    r"(?P<h>H\d*)?(?P<chg>[+-]+\d*|\+\d+|-\d+)?(?::(?P<map>\d+))?\]")


class SmilesError(ValueError):
    pass


def parse_smiles(s: str) -> MolGraph:
    atoms: List[Atom] = []
    bonds: List[Bond] = []
    stack: List[int] = []
    prev: Optional[int] = None
    pending_bond: Optional[str] = None
    ring: Dict[str, Tuple[int, Optional[str]]] = {}
    # per-atom neighbor record in WRITTEN order (chirality reference frame):
    # ints are neighbor atom indices, -1 the implicit H, ("r", label) a
    # still-open ring bond placeholder filled at closure
    slots: Dict[int, List] = {}

    i = 0
    n = len(s)

    def add_atom(sym, aromatic, charge=0, n_h=-1, isotope=0, chiral=""):
        a = Atom(symbol=sym, charge=charge, n_h=n_h, aromatic=aromatic,
                 isotope=isotope, idx=len(atoms), chiral=chiral)
        atoms.append(a)
        slots[a.idx] = []
        return a.idx

    def add_bond(i_, j_, btype, flip_dir=False):
        order = {None: 1, "-": 1, "=": 2, "#": 3, ":": 1,
                 "/": 1, "\\": 1}[btype]
        arom = (btype in (None, ":") and atoms[i_].aromatic
                and atoms[j_].aromatic)
        d = {"/": 1, "\\": -1}.get(btype, 0)
        if flip_dir:
            d = -d
        bonds.append(Bond(i_, j_, order=order, aromatic=arom, direction=d))

    while i < n:
        ch = s[i]
        if ch in "-=#:/\\":
            pending_bond = ch
            i += 1
            continue
        if ch == "(":
            stack.append(prev)
            i += 1
            continue
        if ch == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {s!r}")
            prev = stack.pop()
            i += 1
            continue
        if ch == ".":
            prev = None
            pending_bond = None
            i += 1
            continue
        if ch.isdigit() or ch == "%":
            if ch == "%":
                label = s[i + 1:i + 3]
                i += 3
            else:
                label = ch
                i += 1
            if label in ring:
                j, b0 = ring.pop(label)
                bt = pending_bond or b0
                # a direction marker recorded at ring OPEN was written
                # opener->closer; Bond stores (closer, opener) here
                add_bond(prev, j, bt, flip_dir=pending_bond is None)
                slots[prev].append(j)
                k = slots[j].index(("r", label))
                slots[j][k] = prev
            else:
                ring[label] = (prev, pending_bond)
                slots[prev].append(("r", label))
            pending_bond = None
            continue
        if ch == "[":
            m = _BRACKET.match(s, i)
            if not m:
                raise SmilesError(f"bad bracket atom at {s[i:]!r}")
            sym = m.group("sym")
            aromatic = sym[0].islower()
            sym_cap = sym.capitalize()
            hg = m.group("h")
            n_h = 0
            if hg:
                n_h = 1 if hg == "H" else int(hg[1:])
            cg = m.group("chg") or ""
            charge = 0
            if cg:
                if cg in ("+", "-"):
                    charge = 1 if cg == "+" else -1
                elif set(cg) <= {"+", "-"}:
                    charge = cg.count("+") - cg.count("-")
                else:
                    charge = int(cg[1:]) * (1 if cg[0] == "+" else -1)
            iso = int(m.group("iso") or 0)
            craw = m.group("chiral") or ""
            chiral = ""
            if craw:
                # @=TH1 (anticlockwise), @@=TH2 (clockwise); AL/SP classes
                # are not tetrahedral and are ignored
                if craw.startswith("@@") or craw.endswith("TH2"):
                    chiral = "@@"
                elif craw in ("@",) or craw.endswith("TH1"):
                    chiral = "@"
            idx = add_atom(sym_cap, aromatic, charge, n_h, iso, chiral)
            if prev is not None:
                add_bond(prev, idx, pending_bond)
                slots[prev].append(idx)
                slots[idx].append(prev)
            if chiral and n_h >= 1:
                slots[idx].append(-1)     # the implicit H's written slot
            pending_bond = None
            prev = idx
            i = m.end()
            continue
        # organic subset (possibly two letters: Cl, Br)
        two = s[i:i + 2]
        if two in ("Cl", "Br"):
            sym, aromatic = two, False
            i += 2
        elif ch in "BCNOPSFI":
            sym, aromatic = ch, False
            i += 1
        elif ch in "bcnops":
            sym, aromatic = ch.upper(), True
            i += 1
        elif ch == "*":
            sym, aromatic = "C", False
            i += 1
        else:
            raise SmilesError(f"unexpected character {ch!r} in {s!r}")
        idx = add_atom(sym, aromatic)
        if prev is not None:
            add_bond(prev, idx, pending_bond)
            slots[prev].append(idx)
            slots[idx].append(prev)
        pending_bond = None
        prev = idx

    if ring:
        raise SmilesError(f"unclosed ring bonds {sorted(ring)} in {s!r}")
    if stack:
        raise SmilesError(f"unbalanced '(' in {s!r}")

    g = MolGraph(atoms, bonds)
    for a in atoms:
        if a.chiral and len(slots[a.idx]) == 4:
            g.chiral_order[a.idx] = list(slots[a.idx])
        # any other count (e.g. 3-coordinate N/S chirality) is unsupported:
        # the marker is kept on the Atom but imposes no constraint
    _kekulize(g)
    _assign_implicit_h(g)
    return g


def _kekulize(g: MolGraph):
    """Assign alternating double bonds in aromatic systems via perfect
    matching on the pi-needing aromatic atoms (backtracking)."""
    needs_pi = []
    for a in g.atoms:
        if not a.aromatic:
            needs_pi.append(False)
            continue
        if a.symbol in ("O", "S"):
            needs_pi.append(False)
        elif a.symbol == "N":
            # pyrrole-type ([nH] or n with 3 ring connections or anionic)
            deg = len(g.neighbors(a.idx))
            if a.n_h > 0 or a.charge < 0 or deg == 3:
                needs_pi.append(False)
            else:
                needs_pi.append(True)
        elif a.symbol == "C":
            # exocyclic double bond (e.g. quinone written aromatic) — rare;
            # aromatic carbon needs one pi bond
            needs_pi.append(a.charge == 0)
        else:
            needs_pi.append(True)
    arom_bonds = [b for b in g.bonds if b.aromatic]
    adj: Dict[int, List[Bond]] = {}
    for b in arom_bonds:
        adj.setdefault(b.i, []).append(b)
        adj.setdefault(b.j, []).append(b)
    unmatched = {a.idx for a in g.atoms if needs_pi[a.idx]}

    def backtrack():
        if not unmatched:
            return True
        i = min(unmatched)
        for b in adj.get(i, []):
            j = b.j if b.i == i else b.i
            if j in unmatched:
                unmatched.discard(i)
                unmatched.discard(j)
                b.order = 2
                if backtrack():
                    return True
                b.order = 1
                unmatched.add(i)
                unmatched.add(j)
        return False

    if unmatched and not backtrack():
        raise SmilesError("kekulization failed (non-alternant aromatic ring)")


_DEFAULT_VALENCES = {
    "B": (3,), "C": (4,), "N": (3,), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}


def _assign_implicit_h(g: MolGraph):
    for a in g.atoms:
        if a.n_h >= 0:
            continue
        vs = _DEFAULT_VALENCES.get(a.symbol)
        if vs is None:
            a.n_h = 0
            continue
        bond_sum = g.bond_order_sum(a.idx)
        # charge adjustment: N+ -> 4, O- -> 1, etc. (organic subset rules)
        adjust = a.charge if a.symbol in ("B",) else a.charge
        eff = [v + (a.charge if a.symbol in ("N", "O", "P", "S", "C")
                    else -abs(a.charge)) for v in vs]
        nh = 0
        for v in eff:
            if bond_sum <= v:
                nh = v - bond_sum
                break
        a.n_h = max(0, nh)


def total_charge(g: MolGraph) -> int:
    return sum(a.charge for a in g.atoms)


def atom_features(g: MolGraph):
    """6 features per atom matching the reference GCN featurization
    (ms-pred-gcn-eims-cupy.py:113-122): Z, degree, formal charge,
    hybridization (sp=1/sp2=2/sp3=3), aromatic flag, numHs."""
    import numpy as np
    feats = []
    for a in g.atoms:
        deg = len(g.neighbors(a.idx))
        orders = [b.order for _, b in g.neighbors(a.idx)]
        if a.aromatic or 2 in orders:
            hyb = 2
        elif 3 in orders:
            hyb = 1
        else:
            hyb = 3
        feats.append([float(elem.symbol_to_z(a.symbol)), float(deg),
                      float(a.charge), float(hyb), float(a.aromatic),
                      float(a.n_h)])
    return np.array(feats, dtype=np.float32)
