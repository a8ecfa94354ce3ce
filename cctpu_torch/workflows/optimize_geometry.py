"""Geometry optimization + frequencies workflow (v1).

Port of ``cctpu/workflows/optimize_geometry.py``: optimization in
redundant internals, harmonic frequencies from the FD Hessian of analytic
gradients, imaginary-mode check, ZPE/H/G/S, RMSD, XYZ output. The SCFs and
gradients run on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cctpu_torch.core.constants import BOHR
from cctpu_torch.geomopt.optimizer import optimize
from cctpu_torch.hessian.frequencies import harmonic_analysis, hessian_auto
from cctpu_torch.hessian.thermo import thermo
from cctpu_torch.workflows import common
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, make_scf,
                                          open_reports)


def rmsd(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1)))) * BOHR


def scf_factory(args):
    """The workflow's SCF at a geometry, on ``args.device``."""
    def factory(m):
        return make_scf(m, args.method, args.density_fit,
                        grid_level=args.grid_level, device=args.device)
    return factory


def main(argv=None):
    p = argparse.ArgumentParser(description="geometry optimization + freq")
    add_common_args(p, default_method="b3lyp", default_basis="6-31g*")
    p.add_argument("--maxsteps", type=int, default=50)
    p.add_argument("--skip-freq", action="store_true")
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "opt")
    t = Timer()
    try:
        mol = build_molecule(args, log=out.print)
        out.print(f"=== geometry optimization: {args.smiles} "
                  f"{args.method}/{args.basis} ===")
        factory = scf_factory(args)
        res = optimize(factory, mol, maxsteps=args.maxsteps, verbose=1,
                       timer=common.PHASES)
        out.print(f"\noptimization {'converged' if res.converged else 'NOT '
                  'converged'} in {res.nsteps} steps")
        out.print(f"final energy: {res.e_tot:.10f} Ha")
        out.print(f"RMSD initial->final: "
                  f"{rmsd(mol.coords, res.mol.coords):.4f} A")

        xyz_path = os.path.join(args.output_dir, f"{tag}_optimized.xyz")
        with open(xyz_path, "w") as f:
            f.write(res.mol.to_xyz(comment=f"E = {res.e_tot:.10f} Ha"))
        out.print(f"optimized geometry -> {xyz_path}")

        if not args.skip_freq:
            out.print("\ncomputing Hessian (FD of analytic gradients)...")
            H, dmu = hessian_auto(res.mf, factory, res.mol,
                                  dm0=res.mf.make_rdm1(), log=out.print)
            ha = harmonic_analysis(res.mol, H, dmu)
            out.print(f"frequencies (cm-1): "
                      f"{np.array2string(ha.freq_wavenumber, precision=1)}")
            if ha.n_imaginary:
                out.print(f"WARNING: {ha.n_imaginary} imaginary frequencies "
                          f"— not a true minimum")
            else:
                out.print("no imaginary frequencies: true minimum confirmed")
            th = thermo(res.mol, ha.freq_au, res.e_tot)
            out.print("\nthermochemistry @ 298.15 K, 1 atm:")
            for k in ("ZPE", "E_tot", "H_tot", "G_tot", "S_tot"):
                v, u = th[k]
                out.print(f"  {k:6s} = {v:.6f} {u}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return res


if __name__ == "__main__":
    main()
