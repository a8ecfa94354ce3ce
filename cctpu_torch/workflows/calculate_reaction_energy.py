"""Reaction energetics workflow: dE / dE0 / dH / dG and K_eq.

Port of ``cctpu/workflows/calculate_reaction_energy.py``: the
stoichiometry parser ('2A + B -> C'), per species an optimization, the FD
Hessian of analytic gradients and thermochemistry, the special cases H+
(no electrons: translational terms only) and the H atom (spin 1, no
optimization), K_eq = exp(-dG/RT) at 298.15 K. Each SCF and gradient runs
on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import math
import re
from typing import List, Tuple

import numpy as np

from cctpu_torch.core import constants as const
from cctpu_torch.geomopt.optimizer import optimize
from cctpu_torch.hessian.frequencies import harmonic_analysis, hessian_auto
from cctpu_torch.hessian.thermo import thermo
from cctpu_torch.io.embed3d import smiles_to_molecule
from cctpu_torch.workflows.common import (Timer, make_scf, open_reports,
                                          resolve_basis, run_scf)


def parse_side(side: str) -> List[Tuple[int, str]]:
    """'2A + B' -> [(2, 'A'), (1, 'B')]. A '+' inside a bracket atom
    ('[H+]', '[OH3+]') is a charge, not a separator; cctpu splits there
    too, so its CLI never reaches the proton's special case (ROADMAP.md
    queue 3)."""
    out = []
    for term in re.split(r"\+(?![^\[]*\])", side):
        term = term.strip()
        m = re.match(r"^(\d+)\s*(.*)$", term)
        if m and m.group(2):
            out.append((int(m.group(1)), m.group(2).strip()))
        else:
            out.append((1, term))
    return out


def species_thermo(smiles: str, method: str, basis: str, density_fit,
                   grid_level, skip_freq=False, log=print, device=None):
    """{"E", "E0", "H", "G"} (Ha) of one species; each SCF on ``device``
    (the card unless ``"cpu"``)."""
    if smiles in ("[H+]",):
        # the proton: no electronic energy, translational terms only
        kT = const.KB_HARTREE * const.T_STANDARD
        z = {"E": 0.0, "E0": 0.0, "H": 2.5 * kT}
        z["G"] = z["H"] - const.T_STANDARD * (108.95 / const.AVOGADRO
                                              / const.HARTREE2J)
        return z
    spin = 1 if smiles in ("[H]",) else 0
    mol = smiles_to_molecule(smiles, spin=spin, basis=basis)
    if mol.natm == 1:
        mf, e = run_scf(mol, method, density_fit, log=log,
                        grid_level=grid_level, device=device)
        th = thermo(mol, np.array([]), e)
        return {"E": e, "E0": e, "H": th["H_tot"][0], "G": th["G_tot"][0]}

    def factory(m):
        return make_scf(m, method, density_fit, grid_level=grid_level,
                        device=device)

    res = optimize(factory, mol, maxsteps=50)
    e = res.e_tot
    if skip_freq:
        return {"E": e, "E0": e, "H": e, "G": e}
    H, _ = hessian_auto(res.mf, factory, res.mol, dm0=res.mf.make_rdm1(),
                        with_dipole=False, log=log)
    ha = harmonic_analysis(res.mol, H)
    th = thermo(res.mol, ha.freq_au, e)
    return {"E": e, "E0": th["E_0K"][0], "H": th["H_tot"][0],
            "G": th["G_tot"][0]}


def main(argv=None):
    p = argparse.ArgumentParser(description="reaction energetics")
    p.add_argument("--reaction", required=True,
                   help="e.g. 'CCO + [O] -> CC=O + O'")
    p.add_argument("--method", default="b3lyp")
    p.add_argument("--basis", default="6-31+g*")
    p.add_argument("--density-fit", action="store_true", default=None)
    p.add_argument("--grid-level", type=int, default=3)
    p.add_argument("--skip-freq", action="store_true")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--use-gpu", action="store_true",
                   help="accepted for reference CLI compatibility")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the SCFs and gradients run (default cuda; "
                        "without a card, cuda raises)")
    args = p.parse_args(argv)

    class _A:
        smiles = args.reaction
        method = args.method
        basis = args.basis
        output_dir = args.output_dir
    out, short, log, tag = open_reports(_A, "reaction")
    t = Timer()
    try:
        basis = resolve_basis(args.basis, out.print)
        lhs, rhs = args.reaction.split("->")
        reactants = parse_side(lhs)
        products = parse_side(rhs)
        out.print(f"=== reaction: {args.reaction}  "
                  f"{args.method}/{basis} ===")

        table = {}
        for coef, smi in reactants + products:
            if smi not in table:
                out.print(f"\nspecies {smi} (x{coef})...")
                table[smi] = species_thermo(
                    smi, args.method, basis, args.density_fit,
                    args.grid_level, args.skip_freq, log=out.print,
                    device=args.device)
                d = table[smi]
                out.print(f"  E={d['E']:.8f}  G={d['G']:.8f} Ha")

        def tot(side, key):
            return sum(c * table[s][key] for c, s in side)

        dE = tot(products, "E") - tot(reactants, "E")
        dE0 = tot(products, "E0") - tot(reactants, "E0")
        dH = tot(products, "H") - tot(reactants, "H")
        dG = tot(products, "G") - tot(reactants, "G")
        K = const.HARTREE2KCAL
        out.print(f"\ndE  = {dE * K:10.2f} kcal/mol")
        out.print(f"dE0 = {dE0 * K:10.2f} kcal/mol (with ZPE)")
        out.print(f"dH  = {dH * K:10.2f} kcal/mol (298.15 K)")
        out.print(f"dG  = {dG * K:10.2f} kcal/mol (298.15 K)")
        RT = const.KB_HARTREE * const.T_STANDARD
        keq = math.exp(-dG / RT) if abs(dG / RT) < 500 else (
            float("inf") if dG < 0 else 0.0)
        out.print(f"K_eq = {keq:.3e}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return dE, dH, dG, keq


if __name__ == "__main__":
    main()
