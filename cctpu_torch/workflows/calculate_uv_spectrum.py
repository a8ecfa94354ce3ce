"""TDDFT UV-Vis spectrum workflow.

Port of ``cctpu/workflows/calculate_uv_spectrum.py``: TD-DFT excitations
(full TDDFT, or TDA with ``--tda``), the lambda/f table, orbital
contributions (threshold 0.1), perceived-color assignment and a
Gaussian-broadened spectrum plot (sigma = 20 nm over 200-800 nm). The SCF
and the response run on ``--device`` (the card by default), on the
``energy`` CLI's route (in-core J/K up to nao 160, density fitted above
it or with ``--density-fit``). The plot needs matplotlib; without it the
table is still written to the reports and the PNG is skipped.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cctpu_torch.core.constants import EV2NM, HARTREE2EV
from cctpu_torch.response.tddft import TDDFT
from cctpu_torch.utils.profiling import PhaseTimer
from cctpu_torch.workflows import common
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, open_reports,
                                          run_scf)


def assign_color(lam_nm: float) -> str:
    """Perceived color from the absorbed wavelength (the reference's
    ``assign_color`` logic)."""
    if lam_nm < 380:
        return "colorless (UV absorber)"
    table = [(450, "yellow-orange"), (495, "red-orange"),
             (570, "violet-red"), (590, "blue-violet"),
             (620, "green-blue"), (750, "blue-green")]
    for ub, color in table:
        if lam_nm < ub:
            return color
    return "colorless (IR absorber)"


def plot_spectrum(energies_ev, osc, path, sigma_nm=20.0) -> bool:
    """Write the broadened spectrum to ``path``; False (nothing written)
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    lam = np.linspace(200, 800, 1200)
    eps = np.zeros_like(lam)
    for e, f in zip(energies_ev, osc):
        if e <= 0:
            continue
        l0 = EV2NM / e
        eps += f * np.exp(-0.5 * ((lam - l0) / sigma_nm) ** 2)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(lam, eps)
    ax.set_xlabel("wavelength (nm)")
    ax.set_ylabel("intensity (arb.)")
    ax.set_title("simulated UV-Vis spectrum")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description="TDDFT UV-Vis spectrum")
    add_common_args(p, default_method="b3lyp", default_basis="6-31g*")
    p.add_argument("--nstates", type=int, default=6)
    p.add_argument("--tda", action="store_true")
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "uv")
    t = Timer()
    try:
        mol = build_molecule(args, log=out.print)
        out.print(f"=== UV-Vis: {args.smiles} "
                  f"TD-{args.method}/{args.basis} ===")
        mf, e0 = run_scf(mol, args.method, args.density_fit,
                         log=out.print, grid_level=args.grid_level,
                         device=args.device)
        out.print(f"ground state: {e0:.8f} Ha")

        td = TDDFT(mf, nstates=args.nstates, tda=args.tda,
                   timer=PhaseTimer(mf.device))
        with common.PHASES.phase("tddft"):
            td.kernel()
        osc = td.oscillator_strength()
        out.print(f"\n{'state':>5} {'E (eV)':>8} {'lambda (nm)':>11} "
                  f"{'f':>8}")
        lam_max, f_max = None, 0.0
        for n, (e, f) in enumerate(zip(td.e, osc)):
            ev = e * HARTREE2EV
            nm = EV2NM / ev if ev > 0 else float("inf")
            out.print(f"{n + 1:5d} {ev:8.4f} {nm:11.1f} {f:8.4f}")
            if f > f_max:
                f_max, lam_max = f, nm
            X = td.xy[n][0]
            if td.unrestricted:
                for s, tag_s in ((0, "a"), (1, "b")):
                    Xs = np.asarray(X[s])
                    for (i, a) in zip(*np.where(np.abs(Xs) > 0.1)):
                        out.print(f"        MO {i + 1}{tag_s} -> "
                                  f"MO {td.nocc_s[s] + a + 1}{tag_s}  "
                                  f"amp {Xs[i, a]:+.3f}")
            else:
                for (i, a) in zip(*np.where(np.abs(X) > 0.1)):
                    out.print(f"        MO {i + 1} -> MO {td.nocc + a + 1}"
                              f"  amp {X[i, a]:+.3f}")
        if lam_max:
            out.print(f"\nstrongest absorption: {lam_max:.0f} nm  "
                      f"-> {assign_color(lam_max)}")
        png = os.path.join(args.output_dir, f"{tag}_spectrum.png")
        if plot_spectrum(np.array(td.e) * HARTREE2EV, osc, png):
            out.print(f"spectrum plot -> {png}")
        else:
            out.print("spectrum plot skipped: matplotlib is not installed")
        sec = td.timer.phases
        out.print(f"TDDFT: converged {td.converged}, {td.n_matvec} "
                  f"matvecs, {td.wall_s:.2f} s: J {sec.get('J', 0.0):.2f}, "
                  f"K {sec.get('K', 0.0) + sec.get('K_lr', 0.0):.2f}, "
                  f"fxc {sec.get('fxc', 0.0):.2f}, host "
                  f"{td.wall_s - sec.get('matvec', 0.0):.2f} s")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return td


if __name__ == "__main__":
    main()
