"""IR spectrum workflow: opt -> frequencies/intensities -> assignment/plot.

Port of ``cctpu/workflows/calculate_ir_spectrum.py``: optimization, the
FD Hessian of analytic gradients with dipole derivatives from the same
displaced SCFs, IR intensities, wavenumber-window mode assignment, a
transmittance plot (reversed 4000->400 axis, sigma 20 cm^-1) and
thermochemistry. Each SCF and gradient runs on ``--device`` (the card by
default). The plot needs matplotlib; without it the frequency/intensity
table is still written to the reports and the PNG is skipped.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cctpu_torch.geomopt.optimizer import optimize
from cctpu_torch.hessian.frequencies import harmonic_analysis, hessian_auto
from cctpu_torch.hessian.thermo import thermo
from cctpu_torch.workflows import common
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, open_reports)
from cctpu_torch.workflows.optimize_geometry import scf_factory


def assign_mode(freq: float) -> str:
    """The reference's wavenumber windows of vibration types."""
    rules = [
        (3550, 3800, "O-H stretch (free)"),
        (3200, 3550, "O-H/N-H stretch (H-bonded)"),
        (3000, 3200, "C-H stretch (aromatic/alkene)"),
        (2840, 3000, "C-H stretch (alkane)"),
        (2100, 2300, "C#C / C#N stretch"),
        (1650, 1800, "C=O stretch"),
        (1550, 1650, "C=C stretch / N-H bend"),
        (1350, 1550, "C-H bend"),
        (1000, 1350, "C-O / C-N stretch"),
        (650, 1000, "out-of-plane bend"),
        (0, 650, "skeletal deformation"),
    ]
    for lo, hi, name in rules:
        if lo <= freq < hi:
            return name
    return "other"


def plot_ir(freqs, inten, path, sigma=20.0) -> bool:
    """Write the transmittance plot to ``path``; False (nothing written)
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    x = np.linspace(400, 4000, 1800)
    absorb = np.zeros_like(x)
    for f, i in zip(freqs, inten):
        if f > 0:
            absorb += i * np.exp(-0.5 * ((x - f) / sigma) ** 2)
    if absorb.max() > 0:
        absorb = absorb / absorb.max()
    trans = 100 * (1 - 0.95 * absorb)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(x, trans)
    ax.set_xlim(4000, 400)                      # reversed IR convention
    ax.set_xlabel("wavenumber (cm$^{-1}$)")
    ax.set_ylabel("transmittance (%)")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description="IR spectrum")
    add_common_args(p, default_method="b3lyp", default_basis="6-31g*")
    p.add_argument("--maxsteps", type=int, default=50)
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "ir")
    t = Timer()
    try:
        mol = build_molecule(args, log=out.print)
        out.print(f"=== IR spectrum: {args.smiles} "
                  f"{args.method}/{args.basis} ===")
        factory = scf_factory(args)
        res = optimize(factory, mol, maxsteps=args.maxsteps, verbose=1,
                       timer=common.PHASES)
        out.print(f"optimized E = {res.e_tot:.10f} Ha")
        H, dmu = hessian_auto(res.mf, factory, res.mol,
                              dm0=res.mf.make_rdm1(), log=out.print)
        ha = harmonic_analysis(res.mol, H, dmu)

        out.print(f"\n{'freq (cm-1)':>12} {'IR (km/mol)':>12}  assignment")
        for f, i in zip(ha.freq_wavenumber, ha.ir_intensity):
            out.print(f"{f:12.1f} {i:12.2f}  {assign_mode(f)}")

        png = os.path.join(args.output_dir, f"{tag}_ir.png")
        if plot_ir(ha.freq_wavenumber, ha.ir_intensity, png):
            out.print(f"IR plot -> {png}")
        else:
            out.print("IR plot skipped: matplotlib is not installed")

        th = thermo(res.mol, ha.freq_au, res.e_tot)
        out.print("\nthermochemistry:")
        for k in ("ZPE", "H_tot", "G_tot", "S_tot"):
            v, u = th[k]
            out.print(f"  {k:6s} = {v:.6f} {u}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return ha


if __name__ == "__main__":
    main()
