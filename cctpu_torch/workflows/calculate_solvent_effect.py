"""PCM solvent-effect workflow.

Port of ``cctpu/workflows/calculate_solvent_effect.py``: gas-phase and
PCM energies, dG_solv, the dipole and HOMO-LUMO gap shifts, an optional
re-optimization inside the solvent (``--opt``: the PCM nuclear gradient on
every step) and the 7-solvent comparison table, each solvent's SCF
warm-started from the previous one's density. The SCFs run on
``--device`` (the card by default), on the ``energy`` CLI's route (in-core
J/K up to nao 160, density fitted above it or with ``--density-fit``).
"""

from __future__ import annotations

import argparse

import numpy as np

from cctpu_torch.core.constants import HARTREE2EV, HARTREE2KCAL
from cctpu_torch.solvent.pcm import PCM, SOLVENT_PARAMS
from cctpu_torch.workflows import common
from cctpu_torch.workflows.common import (Timer, add_common_args,
                                          build_molecule, homo_lumo,
                                          make_scf, open_reports, run_scf)

COMPARE = ["water", "dmso", "acetonitrile", "methanol", "dichloromethane",
           "toluene", "hexane"]


def main(argv=None):
    """Returns a dict: ``e_gas``, ``e_sol`` (Ha), ``dg`` (kcal/mol), the
    dipole norms ``mu_gas``, ``mu_sol`` (Debye), the HOMO-LUMO gaps
    ``gap_gas``, ``gap_sol`` (Ha), ``opt`` (the in-solvent
    ``OptResult`` or None) and ``table`` ({solvent: E})."""
    p = argparse.ArgumentParser(description="PCM solvent effects")
    add_common_args(p, default_method="b3lyp", default_basis="6-31g*")
    p.add_argument("--solvent", default="water",
                   choices=sorted(SOLVENT_PARAMS))
    p.add_argument("--compare-solvents", action="store_true",
                   help="run the multi-solvent comparison table")
    p.add_argument("--opt", action="store_true",
                   help="re-optimize the geometry inside the solvent")
    p.add_argument("--pcm-method", default="ief-pcm",
                   choices=["ief-pcm", "c-pcm"])
    p.add_argument("--maxsteps", type=int, default=50)
    args = p.parse_args(argv)
    out, short, log, tag = open_reports(args, "solvent")
    t = Timer()
    try:
        mol = build_molecule(args, log=out.print)
        out.print(f"=== solvent effects: {args.smiles} "
                  f"{args.method}/{args.basis} ===")

        mf_gas, e_gas = run_scf(mol, args.method, args.density_fit,
                                log=out.print, grid_level=args.grid_level,
                                device=args.device)
        mu_gas = float(np.linalg.norm(mf_gas.dip_moment()))
        h_g, l_g = homo_lumo(mf_gas)
        out.print(f"gas phase:  E = {e_gas:.8f} Ha   mu = {mu_gas:.3f} D   "
                  f"gap = {(l_g - h_g) * HARTREE2EV:.3f} eV")

        def factory(m, solvent=args.solvent):
            mf = make_scf(m, args.method, args.density_fit,
                          grid_level=args.grid_level, device=args.device)
            return PCM(mf, solvent=solvent, method=args.pcm_method,
                       timer=common.PHASES)

        last_dm = [mf_gas.make_rdm1()]

        def pcm_run(solvent):
            mf = factory(mol, solvent)
            # warm start from the previous solvent's density (the solvated
            # densities are much closer to each other than to gas phase)
            with common.PHASES.phase(f"scf:pcm:{args.method}"):
                e = mf.kernel(dm0=last_dm[0])
            last_dm[0] = mf.make_rdm1()
            return mf, e

        mf_sol, e_sol = pcm_run(args.solvent)
        res = None
        if args.opt:
            from cctpu_torch.geomopt.optimizer import optimize
            res = optimize(factory, mol, maxsteps=args.maxsteps, verbose=1,
                           timer=common.PHASES)
            tag_c = "converged" if res.converged else "NOT converged"
            out.print(f"in-solvent optimization: {tag_c} in "
                      f"{len(res.energies)} steps, "
                      f"dE = {(res.energies[-1] - e_sol) * HARTREE2KCAL:.3f} "
                      f"kcal/mol vs gas-phase geometry")
            mf_sol, e_sol = res.mf, res.energies[-1]
        dg = (e_sol - e_gas) * HARTREE2KCAL
        mu_s = float(np.linalg.norm(mf_sol.dip_moment()))
        h_s, l_s = homo_lumo(mf_sol)
        out.print(f"{args.solvent} (eps={SOLVENT_PARAMS[args.solvent]}):  "
                  f"E = {e_sol:.8f} Ha")
        out.print(f"  dG_solv = {dg:.2f} kcal/mol")
        out.print(f"  dipole shift: {mu_gas:.3f} -> {mu_s:.3f} D")
        out.print(f"  gap shift: {(l_g - h_g) * HARTREE2EV:.3f} -> "
                  f"{(l_s - h_s) * HARTREE2EV:.3f} eV")

        table = {}
        if args.compare_solvents:
            out.print(f"\n{'solvent':>16} {'eps':>7} {'E (Ha)':>14} "
                      f"{'dG_solv (kcal/mol)':>19}")
            for sol in COMPARE:
                _, table[sol] = pcm_run(sol)
                out.print(f"{sol:>16} {SOLVENT_PARAMS[sol]:7.2f} "
                          f"{table[sol]:14.8f} "
                          f"{(table[sol] - e_gas) * HARTREE2KCAL:19.2f}")
        out.print(f"\nwall time: {t.lap():.1f} s")
    finally:
        short.close()
        log.close()
    return {"e_gas": e_gas, "e_sol": e_sol, "dg": dg, "mu_gas": mu_gas,
            "mu_sol": mu_s, "gap_gas": l_g - h_g, "gap_sol": l_s - h_s,
            "opt": res, "table": table}


if __name__ == "__main__":
    main()
