"""NMR chemical-shift workflow (1H / 13C).

Port of ``cctpu/workflows/calculate_nmr.py``: GIAO shielding tensors ->
shifts delta = sigma_ref - sigma_calc against a TMS reference computed at
the same level (B3LYP/6-311G** by default; DF by size, above nao 160),
or the reference's empirical constants (H 31.0 / C 186.0 ppm) with
``--empirical-ref`` or when the TMS SCF does not converge; anisotropy,
environment-based assignment and Lorentzian-broadened stick spectra (the
PNGs need matplotlib; without it they are skipped). The optimization (up
to 40 steps, unless ``--skip-opt``), the SCFs and the GIAO run on
``--device`` (the card by default).

The computed TMS reference is memoized per (method, basis) in the port's
own file, ``~/.cache/cctpu_torch_tms_ref.json`` (``--tms-memo`` points it
elsewhere), never cctpu's ``cctpu_tms_ref.json``: the port reports only
shieldings it computed. An error other than the TMS SCF's non-convergence
propagates (cctpu falls back to the empirical constants on any error).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from cctpu_torch.geomopt.optimizer import optimize
from cctpu_torch.response.giao_nmr import make_nmr
from cctpu_torch.utils.profiling import PhaseTimer
from cctpu_torch.workflows import common
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, make_scf,
                                          open_reports)
from cctpu_torch.workflows.optimize_geometry import scf_factory

EMPIRICAL_REF = {"H": 31.0, "C": 186.0}      # reference fallback constants
TMS_MEMO = os.path.join("~", ".cache", "cctpu_torch_tms_ref.json")


def _tms_molecule(basis: str):
    """Si(CH3)4 at the standard tetrahedral geometry (r_SiC 1.875 A,
    r_CH 1.09 A), built explicitly: deterministic, no embedding step."""
    from cctpu_torch.core.constants import ANG2BOHR
    from cctpu_torch.core.molecule import Molecule

    dirs = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1],
                     [-1, -1, 1]]) / np.sqrt(3.0)
    syms = ["Si"]
    coords = [np.zeros(3)]
    c_si, c_h = 1.875, 1.09
    for u in dirs:
        c_pos = u * c_si
        syms.append("C")
        coords.append(c_pos)
        # orthonormal frame around u
        v = np.cross(u, [0.0, 0.0, 1.0])
        if np.linalg.norm(v) < 1e-6:
            v = np.cross(u, [0.0, 1.0, 0.0])
        v /= np.linalg.norm(v)
        w = np.cross(u, v)
        for theta in (0.0, 2 * np.pi / 3, 4 * np.pi / 3):
            h_dir = (u / 3.0 + np.sqrt(8.0) / 3.0
                     * (np.cos(theta) * v + np.sin(theta) * w))
            syms.append("H")
            coords.append(c_pos + c_h * h_dir)
    return Molecule(symbols=syms, coords=np.array(coords) * ANG2BOHR,
                    charge=0, spin=0, basis=basis)


_TMS_CACHE = {}


def tms_reference(method, basis, grid_level=2, density_fit=None, log=None,
                  device=None, memo=None):
    """Computed TMS shieldings at the requested level: {'H': sigma, 'C':
    sigma}, or None when the TMS SCF does not converge (callers then use
    ``EMPIRICAL_REF``). A pure (method, basis) constant, memoized in this
    process and in the file ``memo`` (default ``TMS_MEMO``): the 17-atom
    GIAO runs once per level, not once per CLI process."""
    key = (method.lower(), basis.lower())
    path = os.path.expanduser(memo or TMS_MEMO)
    if (key, path) in _TMS_CACHE:
        return _TMS_CACHE[key, path]
    dkey = f"{key[0]}/{key[1]}"
    disk = {}
    if os.path.exists(path):
        with open(path) as f:
            disk = json.load(f)
        if dkey in disk:
            _TMS_CACHE[key, path] = disk[dkey]
            if log:
                log(f"TMS reference loaded from {path} ({dkey})")
            return disk[dkey]
    mol = _tms_molecule(basis)
    mf = make_scf(mol, method, density_fit, grid_level=grid_level,
                  device=device)
    mf.kernel()
    if not mf.converged:
        if log:
            log("computed TMS reference failed (TMS SCF not converged); "
                "using empirical constants")
        _TMS_CACHE[key, path] = None
        return None
    iso = make_nmr(mf, log=log).isotropic()
    syms = mol.element_symbols
    ref = {el: float(np.mean([iso[i] for i, s in enumerate(syms)
                              if s == el])) for el in ("H", "C")}
    _TMS_CACHE[key, path] = ref
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        disk[dkey] = ref
        with open(path, "w") as f:
            json.dump(disk, f, indent=1)
    except OSError as exc:
        if log:
            log(f"TMS memo not written ({exc})")
    return ref


def assign_env(symbol, shift):
    if symbol == "H":
        if shift > 9:
            return "aldehyde/carboxylic H"
        if shift > 6:
            return "aromatic/vinylic H"
        if shift > 2.5:
            return "H alpha to O/N or C=O"
        return "aliphatic H"
    if symbol == "C":
        if shift > 160:
            return "carbonyl/carboxyl C"
        if shift > 100:
            return "aromatic/alkene C"
        if shift > 50:
            return "C-O/C-N carbon"
        return "aliphatic C"
    return ""


def plot_nmr(shifts, symbols, path, nucleus="H") -> bool:
    """Write the Lorentzian-broadened stick spectrum of ``nucleus`` to
    ``path``; False (nothing written) where it has no shifts or matplotlib
    is not installed."""
    vals = [s for sym, s in zip(symbols, shifts) if sym == nucleus]
    if not vals:
        return False
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    width = 0.02 if nucleus == "H" else 0.5
    lo = min(vals) - 1 if nucleus == "H" else min(vals) - 10
    hi = max(vals) + 1 if nucleus == "H" else max(vals) + 10
    x = np.linspace(lo, hi, 2000)
    y = np.zeros_like(x)
    for v in vals:
        y += width ** 2 / ((x - v) ** 2 + width ** 2)
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.plot(x, y)
    ax.set_xlim(hi, lo)                        # reversed ppm axis
    ax.set_xlabel(f"delta ({nucleus}) / ppm")
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def main(argv=None):
    """The CLI; returns a dict of sigma_iso, delta (NaN for elements
    without a reference), anisotropy, the reference used, the symbols, the
    final molecule and the GIAO object (its ``timer`` and ``stats``)."""
    p = argparse.ArgumentParser(description="NMR chemical shifts")
    add_common_args(p, default_method="b3lyp", default_basis="6-311g**")
    p.add_argument("--skip-opt", action="store_true")
    p.add_argument("--empirical-ref", action="store_true",
                   help="skip the computed TMS reference (use the "
                        "reference's empirical constants)")
    p.add_argument("--tms-memo", default=None, metavar="PATH",
                   help=f"the computed TMS reference's memo file "
                        f"(default {TMS_MEMO})")
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "nmr")
    t = Timer()
    try:
        mol = build_molecule(args, log=out.print)
        out.print(f"=== NMR: {args.smiles} {args.method}/{args.basis} ===")

        factory = scf_factory(args)
        if not args.skip_opt:
            res = optimize(factory, mol, maxsteps=40, timer=common.PHASES)
            mol = res.mol
            mf = res.mf
            out.print(f"optimized E = {res.e_tot:.8f} Ha")
        else:
            mf = factory(mol)
            with common.PHASES.phase("scf"):
                mf.kernel()

        nmr = make_nmr(mf, log=out.print, timer=PhaseTimer(mf.device))
        with common.PHASES.phase("giao"):
            nmr.kernel()
        iso = nmr.isotropic()
        aniso = nmr.anisotropy()

        ref = None
        if not args.empirical_ref:
            with common.PHASES.phase("tms"):
                ref = tms_reference(args.method, args.basis,
                                    grid_level=args.grid_level,
                                    density_fit=args.density_fit,
                                    log=out.print, device=args.device,
                                    memo=args.tms_memo)
        if ref is not None:
            out.print(f"\nTMS reference computed at {args.method}/"
                      f"{args.basis}: sigma(H) = {ref['H']:.2f}, sigma(C) "
                      f"= {ref['C']:.2f} ppm (GIAO)")
        else:
            ref = EMPIRICAL_REF
            out.print("\nNOTE: shifts use the reference empirical standards "
                      f"{EMPIRICAL_REF}")
        out.print(f"\n{'atom':>6} {'sigma_iso':>10} {'delta':>8} "
                  f"{'anisotropy':>11}  environment")
        shifts = []
        syms = mol.element_symbols
        for i, sym in enumerate(syms):
            if sym in ref:
                d = ref[sym] - iso[i]
                shifts.append(d)
                out.print(f"{sym}{i:<5d} {iso[i]:10.2f} {d:8.2f} "
                          f"{aniso[i]:11.2f}  {assign_env(sym, d)}")
            else:
                shifts.append(np.nan)
                out.print(f"{sym}{i:<5d} {iso[i]:10.2f} {'-':>8} "
                          f"{aniso[i]:11.2f}")
        for nuc in ("H", "C"):
            png = os.path.join(args.output_dir, f"{tag}_{nuc}nmr.png")
            if plot_nmr(shifts, syms, png, nuc):
                out.print(f"{nuc} spectrum -> {png}")
            elif nuc in syms:
                out.print(f"{nuc} spectrum skipped: matplotlib is not "
                          "installed")
        out.print("(J-coupling not computed, matching the reference's "
                  "documented scope)")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return {"sigma": iso, "delta": np.asarray(shifts), "anisotropy": aniso,
            "ref": ref, "symbols": list(syms), "mol": mol, "nmr": nmr}


if __name__ == "__main__":
    main()
