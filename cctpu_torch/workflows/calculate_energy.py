"""Single-point energy + MO analysis workflow.

Port of ``cctpu/workflows/calculate_energy.py``: SMILES -> 3D -> HF,
MP2 or DFT single point with any functional of the registry (UHF/UKS for
``--spin`` != 0); HOMO/LUMO/gap (the alpha spin's when open shell),
dipole moment; dual short/log reports.
"""

from __future__ import annotations

import argparse

import numpy as np

from cctpu_torch.core.constants import HARTREE2EV
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, homo_lumo,
                                          open_reports, run_scf)


def main(argv=None):
    p = argparse.ArgumentParser(description="single-point energy")
    add_common_args(p, default_method="b3lyp", default_basis="6-31g")
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "energy")
    t = Timer()
    try:
        out.print("=== cctpu_torch single-point energy ===")
        out.print(f"SMILES: {args.smiles}  method: {args.method}  "
                  f"basis: {args.basis}")
        mol = build_molecule(args, log=out.print)
        out.print(f"atoms: {mol.natm}  electrons: {mol.nelectron}  "
                  f"nao: {mol.nao}  charge: {mol.charge}  spin: {mol.spin}")

        mf, e = run_scf(mol, args.method, args.density_fit, log=out.print,
                        grid_level=args.grid_level, device=args.device)
        out.print(f"\nTotal energy: {e:.10f} Ha  "
                  f"({e * 627.5094740631:.4f} kcal/mol)")
        if hasattr(mf, "e_corr"):
            out.print(f"  SCF energy:  {mf.e_tot:.10f} Ha")
            out.print(f"  MP2 corr:    {mf.e_corr:.10f} Ha")
        out.print(f"converged: {mf.converged}  cycles: {mf.n_cycles}")

        homo, lumo = homo_lumo(mf)
        out.print(f"\nHOMO: {homo:.6f} Ha ({homo * HARTREE2EV:.3f} eV)")
        out.print(f"LUMO: {lumo:.6f} Ha ({lumo * HARTREE2EV:.3f} eV)")
        out.print(f"gap:  {(lumo - homo) * HARTREE2EV:.3f} eV")

        mu = mf.dip_moment()
        out.print(f"\ndipole moment (Debye): "
                  f"[{mu[0]:.4f} {mu[1]:.4f} {mu[2]:.4f}]  "
                  f"|mu| = {np.linalg.norm(mu):.4f}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return e


if __name__ == "__main__":
    main()
