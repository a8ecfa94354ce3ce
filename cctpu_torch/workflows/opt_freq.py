"""Production opt + freq + IR workflow (v2).

Port of ``cctpu/workflows/opt_freq.py``: optimization, the FD Hessian of
analytic gradients with dipole derivatives from the same displaced SCFs
(no second 6N sweep), IR intensities, CSV export, thermochemistry, dual
logging with phase reporting. The SCFs and gradients run on ``--device``
(the card by default).
"""

from __future__ import annotations

import argparse
import csv
import os

from cctpu_torch.geomopt.optimizer import optimize
from cctpu_torch.hessian.frequencies import harmonic_analysis, hessian_auto
from cctpu_torch.hessian.thermo import thermo
from cctpu_torch.workflows import common
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, open_reports)
from cctpu_torch.workflows.optimize_geometry import scf_factory


def main(argv=None):
    p = argparse.ArgumentParser(description="opt + freq + IR (production)")
    add_common_args(p, default_method="b3lyp", default_basis="6-31+g**")
    p.add_argument("--maxsteps", type=int, default=50)
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "optfreq")
    t = Timer()
    try:
        out.print(f"[1/5] structure generation: {args.smiles}")
        mol = build_molecule(args, log=out.print)
        factory = scf_factory(args)

        out.print("[2/5] geometry optimization")
        res = optimize(factory, mol, maxsteps=args.maxsteps, verbose=1,
                       timer=common.PHASES)
        out.print(f"  E = {res.e_tot:.10f} Ha  converged={res.converged}")

        out.print("[3/5] Hessian + dipole derivatives")
        H, dmu = hessian_auto(res.mf, factory, res.mol,
                              dm0=res.mf.make_rdm1(), log=out.print)
        ha = harmonic_analysis(res.mol, H, dmu)

        out.print("[4/5] harmonic analysis")
        out.print(f"  modes: {len(ha.freq_wavenumber)}  "
                  f"imaginary: {ha.n_imaginary}")
        for f, ir in zip(ha.freq_wavenumber, ha.ir_intensity):
            out.print(f"    {f:10.1f} cm-1   IR {ir:10.2f} km/mol")

        csv_path = os.path.join(args.output_dir, f"{tag}_ir.csv")
        with open(csv_path, "w", newline="") as f:
            wtr = csv.writer(f)
            wtr.writerow(["frequency_cm-1", "ir_intensity_km_mol"])
            for fr, ir in zip(ha.freq_wavenumber, ha.ir_intensity):
                wtr.writerow([f"{fr:.2f}", f"{ir:.4f}"])
        out.print(f"  IR table -> {csv_path}")

        out.print("[5/5] thermochemistry (298.15 K, 101325 Pa)")
        th = thermo(res.mol, ha.freq_au, res.e_tot)
        for k in ("ZPE", "E_0K", "E_tot", "H_tot", "G_tot", "S_tot"):
            v, u = th[k]
            out.print(f"  {k:6s} = {v:.6f} {u}")
        with open(os.path.join(args.output_dir, f"{tag}_optimized.xyz"),
                  "w") as f:
            f.write(res.mol.to_xyz(comment=f"E = {res.e_tot:.10f}"))
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return res, ha, th


if __name__ == "__main__":
    main()
