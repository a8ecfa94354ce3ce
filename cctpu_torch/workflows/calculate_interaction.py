"""Intermolecular interaction workflow with counterpoise BSSE.

Port of ``cctpu/workflows/calculate_interaction.py``: dimer construction
(aligned/parallel/perpendicular), E_int = E_AB - E_A - E_B with the
ghost-atom counterpoise correction, a distance scan, the interaction-type
classification and a best-effort well-depth plot. The default method is
MP2 (``mp/mp2.py`` on the RHF reference). Each SCF runs on ``--device``
(the card by default).

cctpu batches the scan over distances (``scan_batched``, on
``parallel/task_batch.py``), falling back to its serial warm-start loop;
the batch is not ported (ROADMAP.md queue 1 item 20), so the port runs
the serial loop and says so.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cctpu_torch.core.constants import ANG2BOHR, HARTREE2KCAL
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.io.embed3d import smiles_to_molecule
from cctpu_torch.workflows.common import (Timer, open_reports,
                                          resolve_basis, run_scf)


def make_dimer(mol_a: Molecule, mol_b: Molecule, distance_ang: float,
               orientation: str = "aligned") -> Molecule:
    """Monomer B placed at a centroid distance along x from monomer A."""
    ca = mol_a.coords - mol_a.coords.mean(0)
    cb = mol_b.coords - mol_b.coords.mean(0)
    if orientation == "perpendicular":
        cb = cb[:, [2, 0, 1]]
    shift = np.array([distance_ang * ANG2BOHR, 0.0, 0.0])
    symbols = list(mol_a.symbols) + list(mol_b.symbols)
    coords = np.concatenate([ca, cb + shift])
    return Molecule(symbols=symbols, coords=coords,
                    charge=mol_a.charge + mol_b.charge,
                    spin=mol_a.spin + mol_b.spin, basis=mol_a.basis)


def ghosted(dimer: Molecule, real: str) -> Molecule:
    """Counterpoise monomer in the dimer basis: the other monomer's atoms
    are ghosts (basis functions, no charge or electrons). ``real`` 'A'
    keeps the first ``dimer._monomer_split`` atoms real, 'B' the rest."""
    split = dimer._monomer_split
    symbols = []
    for i, s in enumerate(dimer.symbols):
        is_a = i < split
        keep = (real == "A" and is_a) or (real == "B" and not is_a)
        symbols.append(s if keep else f"Ghost:{s}")
    charge = dimer._charges_ab[0 if real == "A" else 1]
    spin = dimer._spins_ab[0 if real == "A" else 1]
    return Molecule(symbols=symbols, coords=dimer.coords.copy(),
                    charge=charge, spin=spin, basis=dimer.basis)


def interaction_energy(smiles_a, smiles_b, distance, basis, method,
                       orientation="aligned", bsse=True, density_fit=None,
                       log=print, warm=None, device=None):
    """One counterpoise-corrected point: (E_int CP, E_int raw, BSSE
    correction) in Ha. ``warm`` (a dict) carries the monomer energies
    (independent of the distance: computed once per scan) and the dimer
    and ghost densities between neighbouring scan distances. Each SCF runs
    on ``device`` (the card unless ``"cpu"``)."""
    warm = warm if warm is not None else {}
    mol_a = smiles_to_molecule(smiles_a, basis=basis)
    mol_b = smiles_to_molecule(smiles_b, basis=basis)
    dimer = make_dimer(mol_a, mol_b, distance, orientation)
    dimer._monomer_split = mol_a.natm
    dimer._charges_ab = (mol_a.charge, mol_b.charge)
    dimer._spins_ab = (mol_a.spin, mol_b.spin)

    mf_ab, e_ab = run_scf(dimer, method, density_fit, log=log,
                          dm0=warm.get("ab"), device=device)
    warm["ab"] = mf_ab.make_rdm1()
    if "e_a" not in warm:
        _, warm["e_a"] = run_scf(mol_a, method, density_fit, log=log,
                                 device=device)
        _, warm["e_b"] = run_scf(mol_b, method, density_fit, log=log,
                                 device=device)
    e_a, e_b = warm["e_a"], warm["e_b"]
    e_int = e_ab - e_a - e_b
    bsse_corr = 0.0
    if bsse:
        mf_adb, e_a_db = run_scf(ghosted(dimer, "A"), method, density_fit,
                                 log=log, dm0=warm.get("adb"), device=device)
        mf_bdb, e_b_db = run_scf(ghosted(dimer, "B"), method, density_fit,
                                 log=log, dm0=warm.get("bdb"), device=device)
        warm["adb"] = mf_adb.make_rdm1()
        warm["bdb"] = mf_bdb.make_rdm1()
        bsse_corr = (e_a - e_a_db) + (e_b - e_b_db)
    return e_int + bsse_corr, e_int, bsse_corr


def classify(e_kcal: float, has_polar: bool) -> str:
    """The reference's interaction-type thresholds."""
    if e_kcal < -5.0:
        return "hydrogen bond (strong)" if has_polar else "strong attraction"
    if e_kcal < -1.0:
        return "hydrogen bond / dipole" if has_polar else \
            "pi-pi / dispersion"
    if e_kcal < -0.1:
        return "van der Waals"
    return "repulsive / negligible"


def main(argv=None):
    p = argparse.ArgumentParser(description="intermolecular interaction")
    p.add_argument("--smiles", required=True, help="monomer A")
    p.add_argument("--smiles2", required=True, help="monomer B")
    p.add_argument("--method", default="mp2")
    p.add_argument("--basis", default="6-31+g*")
    p.add_argument("--charge", type=int, default=None)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--use-gpu", action="store_true",
                   help="accepted for reference CLI compatibility")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the SCFs run (default cuda; without a card, "
                        "cuda raises)")
    p.add_argument("--density-fit", action="store_true", default=None)
    p.add_argument("--output-dir", default=".")
    p.add_argument("--grid-level", type=int, default=3)
    p.add_argument("--distance", type=float, default=3.5)
    p.add_argument("--orientation", default="aligned",
                   choices=["aligned", "parallel", "perpendicular"])
    p.add_argument("--scan", action="store_true")
    p.add_argument("--scan-range", nargs=2, type=float, default=[2.0, 8.0])
    p.add_argument("--scan-step", type=float, default=0.5)
    p.add_argument("--no-bsse", action="store_true")
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "interaction")
    t = Timer()
    try:
        basis = resolve_basis(args.basis, out.print)
        out.print(f"=== interaction: {args.smiles} ... {args.smiles2} "
                  f"{args.method}/{basis} ===")
        e_cp, e_raw, bsse = interaction_energy(
            args.smiles, args.smiles2, args.distance, basis, args.method,
            args.orientation, bsse=not args.no_bsse,
            density_fit=args.density_fit, log=out.print, device=args.device)
        ek = e_cp * HARTREE2KCAL
        out.print(f"R = {args.distance:.2f} A")
        out.print(f"  E_int (raw)  = {e_raw * HARTREE2KCAL:.3f} kcal/mol")
        out.print(f"  BSSE corr    = {bsse * HARTREE2KCAL:.3f} kcal/mol")
        out.print(f"  E_int (CP)   = {ek:.3f} kcal/mol")
        polar = any(ch in (args.smiles + args.smiles2) for ch in "NOF")
        out.print(f"  type: {classify(ek, polar)}")

        if args.scan:
            rs = np.arange(args.scan_range[0], args.scan_range[1] + 1e-9,
                           args.scan_step)
            out.print("batched scan not ported (ROADMAP queue 1 item 20); "
                      "using the serial warm-start loop")
            out.print(f"\n{'R (A)':>7} {'E_int CP (kcal/mol)':>20}")
            es = []
            warm = {}
            for r in rs:
                e_i, _, _ = interaction_energy(
                    args.smiles, args.smiles2, float(r), basis,
                    args.method, args.orientation, bsse=not args.no_bsse,
                    density_fit=args.density_fit, log=lambda *a: None,
                    warm=warm, device=args.device)
                es.append(e_i * HARTREE2KCAL)
                out.print(f"{r:7.2f} {es[-1]:20.3f}")
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                fig, ax = plt.subplots()
                ax.plot(rs, es, "o-")
                ax.axhline(0, color="gray", lw=0.5)
                ax.set_xlabel("COM distance (A)")
                ax.set_ylabel("E_int (kcal/mol)")
                png = os.path.join(args.output_dir, f"{tag}_scan.png")
                fig.savefig(png, dpi=150)
                plt.close(fig)
                out.print(f"scan plot -> {png}")
            except Exception as exc:        # the plot is best-effort
                out.print(f"plot skipped: {exc}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return e_cp


if __name__ == "__main__":
    main()
