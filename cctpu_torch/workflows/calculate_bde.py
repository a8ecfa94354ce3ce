"""All-bond homolytic BDE sweep workflow.

Port of ``cctpu/workflows/calculate_bde.py``: enumerate the breakable
single bonds (heavy-heavy single non-aromatic bonds and every X-H bond),
homolyze each into two radical fragments (spin 1 doublets), BDE =
E(f1) + E(f2) - E(parent), three fragment-geometry tiers (the embedding as
it is, a B3LYP/6-31G* optimization, an optimization at the method
itself), statistics and the weakest bond, TXT + CSV reports. Each SCF runs
on ``--device`` (the card by default): the closed-shell parent through the
fused DF-J/K kernel where it is density fitted, each UKS fragment through
``df_j`` and ``df_k``.

cctpu runs the ``mmff`` tier as one batched SCF over every fragment
(``parallel/task_batch.py``), falling back to its serial loop; the batch
is not ported (ROADMAP.md queue 1 item 20), so the port takes the serial
loop at every tier and says so.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from cctpu_torch.core.constants import BOHR, HARTREE2KCAL
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.io.embed3d import embed_molecule
from cctpu_torch.io.smiles import MolGraph, parse_smiles
from cctpu_torch.workflows.common import (Timer, add_common_args, make_scf,
                                          open_reports, resolve_basis,
                                          run_scf)


def single_bonds(g: MolGraph) -> List[Tuple[int, int]]:
    """Breakable single, non-aromatic heavy-heavy bonds."""
    return [(b.i, b.j) for b in g.bonds
            if b.order == 1 and not b.aromatic]


def enumerate_bonds(g: MolGraph, h_owner) -> List[Tuple[int, int]]:
    """All breakable single bonds in global atom indexing: heavy-heavy
    single non-aromatic bonds, then every X-H bond as (owner, H)."""
    bonds = single_bonds(g)
    bonds += sorted((own, h) for h, own in h_owner.items())
    return bonds


def _components(adj, natm):
    """Connected components of an adjacency dict, each sorted, in the
    order of their smallest atom."""
    seen = set()
    comps = []
    for start in range(natm):
        if start in seen:
            continue
        stack = [start]
        comp = []
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            comp.append(x)
            stack.extend(adj[x] - seen)
        comps.append(sorted(comp))
    return comps


def fragment_atoms(g: MolGraph, h_owner, natm: int,
                   bond: Tuple[int, int]):
    """Homolysis in global indexing (H atoms included): two sorted atom
    lists, or None when ``bond`` is in a ring."""
    i0, j0 = bond
    adj = {a: set() for a in range(natm)}
    for b in g.bonds:
        adj[b.i].add(b.j)
        adj[b.j].add(b.i)
    for h, own in h_owner.items():
        adj[h].add(own)
        adj[own].add(h)
    adj[i0].discard(j0)
    adj[j0].discard(i0)
    comps = _components(adj, natm)
    return comps if len(comps) == 2 else None


def fragment_graphs(g: MolGraph, bond: Tuple[int, int]):
    """Homolysis of the heavy-atom graph: two fragment atom lists, or None
    for a ring bond. Coordinates come from the parent's embedding."""
    i0, j0 = bond
    adj = {a.idx: set() for a in g.atoms}
    for b in g.bonds:
        if {b.i, b.j} == {i0, j0}:
            continue
        adj[b.i].add(b.j)
        adj[b.j].add(b.i)
    comps = _components(adj, g.natoms)
    return comps if len(comps) == 2 else None


def _serial_frag_sp(mol, method, density_fit, device=None, dm0=None):
    """The sweep's single point (parent or fragment): conv_tol 1e-6,
    at most 100 cycles, with ``run_scf``'s fallback ladder. Returns
    (mf, e); the caller checks ``mf.converged``."""
    return run_scf(mol, method, density_fit, dm0=dm0, log=lambda *a: None,
                   conv_tol=1e-6, max_cycle=100, device=device)


def bde_sweep(smiles: str, method: str, basis: str, tier: str = "mmff",
              density_fit=None, log=print, limit: Optional[int] = None,
              device=None):
    """(E_parent, [(label, i, j, BDE kcal/mol), ...]) of the first
    ``limit`` breakable bonds; each SCF on ``device`` (the card unless
    ``"cpu"``)."""
    g = parse_smiles(smiles)
    symbols, coords_ang = embed_molecule(g)
    nheavy = g.natoms
    parent = Molecule.from_atoms(list(zip(symbols, coords_ang)),
                                 basis=basis)
    # the embedding appends the H atoms after the heavy atoms, in the
    # order of their heavy owner
    h_owner = {}
    k = nheavy
    for a in g.atoms:
        for _ in range(a.n_h):
            h_owner[k] = a.idx
            k += 1

    def run_opt_sp(mol):
        if tier in ("b3lyp", "same"):
            from cctpu_torch.geomopt.optimizer import optimize
            opt_method = "b3lyp" if tier == "b3lyp" else method
            opt_basis = "6-31g*" if tier == "b3lyp" else basis

            def factory(m):
                return make_scf(m, opt_method, density_fit, device=device)
            res = optimize(factory,
                           Molecule(symbols=list(mol.symbols),
                                    coords=mol.coords.copy(),
                                    charge=mol.charge, spin=mol.spin,
                                    basis=opt_basis),
                           maxsteps=30)
            mol = Molecule(symbols=list(mol.symbols),
                           coords=res.mol.coords.copy(), charge=mol.charge,
                           spin=mol.spin, basis=mol.basis)
        mf, e = _serial_frag_sp(mol, method, density_fit, device)
        return e, mf.converged

    bonds = enumerate_bonds(g, h_owner)
    if limit:
        bonds = bonds[:limit]

    if tier == "mmff":
        log("batched sweep not ported (ROADMAP queue 1 item 20); using "
            "the serial path")

    log(f"parent single point ({method}/{basis}, tier={tier})")
    e_parent, conv = run_opt_sp(parent)
    if not conv:
        raise RuntimeError("parent SCF did not converge")

    results = []
    for (i, j) in bonds:
        comps = fragment_atoms(g, h_owner, parent.natm, (i, j))
        if comps is None:
            log(f"bond {i}-{j}: ring bond, skipped")
            continue
        try:
            es = []
            for comp in comps:
                syms = [symbols[a] for a in comp]
                crd = parent.coords[comp] * BOHR
                frag = Molecule.from_atoms(list(zip(syms, crd)), spin=1,
                                           basis=basis)
                e_f, conv_f = run_opt_sp(frag)
                if not conv_f:
                    raise RuntimeError("fragment SCF not converged")
                es.append(e_f)
            bde = (es[0] + es[1] - e_parent) * HARTREE2KCAL
            lbl = f"{symbols[i]}{i}-{symbols[j]}{j}"
            results.append((lbl, i, j, bde))
            log(f"bond {lbl}: BDE = {bde:.2f} kcal/mol")
        except Exception as exc:
            # per-bond isolation: one failed bond does not end the sweep
            log(f"bond {i}-{j} FAILED: {exc}")
    return e_parent, results


def main(argv=None):
    p = argparse.ArgumentParser(description="homolytic BDE sweep")
    add_common_args(p, default_method="m06-2x", default_basis="def2-tzvp")
    p.add_argument("--tier", default="mmff",
                   choices=["mmff", "b3lyp", "same"],
                   help="fragment-geometry tier")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "bde")
    t = Timer()
    try:
        basis = resolve_basis(args.basis, out.print)
        method = args.method
        from cctpu_torch.dft.xc import get_functional
        try:
            get_functional(method)
        except ValueError:
            out.print(f"NOTE: functional {method} not yet implemented; "
                      f"using b3lyp")
            method = "b3lyp"

        out.print(f"=== BDE sweep: {args.smiles} {method}/{basis} "
                  f"tier={args.tier} ===")
        e_parent, results = bde_sweep(args.smiles, method, basis, args.tier,
                                      args.density_fit, log=out.print,
                                      limit=args.limit, device=args.device)
        if results:
            bdes = np.array([r[3] for r in results])
            out.print(f"\nbonds evaluated: {len(results)}")
            out.print(f"mean BDE: {bdes.mean():.2f}  min: {bdes.min():.2f}"
                      f"  max: {bdes.max():.2f} kcal/mol")
            weakest = results[int(np.argmin(bdes))]
            out.print(f"weakest bond: {weakest[0]} "
                      f"({weakest[3]:.2f} kcal/mol)")
            csv_path = os.path.join(args.output_dir, f"{tag}_bde.csv")
            with open(csv_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["bond", "atom_i", "atom_j", "bde_kcal_mol"])
                for r in results:
                    w.writerow([r[0], r[1], r[2], f"{r[3]:.3f}"])
            out.print(f"CSV -> {csv_path}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return results


if __name__ == "__main__":
    main()
