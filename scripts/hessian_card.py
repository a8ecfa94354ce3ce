"""The analytic Hessian on the routes the workflow CLIs take by default, at
sizes beyond ``chip_smoke.py``'s phase 12: wall time, its split, CG
iterations, kernel launches, peak device memory and FD columns.

    python scripts/hessian_card.py [case ...] [--device cpu]

Cases (all B3LYP, SCFs at conv_tol 1e-12 and an orbital gradient <= 1e-8,
built by ``workflows.common.make_scf`` as the CLIs build them, so DF only
above nao 160):

- ``phenol_incore``: phenol (``utils.measure.PHENOL``) at ``opt-freq``'s
  defaults, 6-31+G** and grid level 3: nao 156, so in-core J/K and the
  direct two-electron Hessian term;
- ``aspirin_df``: aspirin from its SMILES (the port's embedding) at
  ``ir``'s defaults, 6-31G* and grid level 3: nao 198, so density
  fitting; its dX/dR would take 64 GB, beyond ``cphf.DF_DX_BYTES_MAX``,
  so ``hessian_auto`` takes the FD route there, and this case, which
  calls ``analytic_hessian`` directly, shows where the card's memory
  runs out;
- ``water_sto3g_df``, ``water_sto3g_incore``: water at STO-3G, a quick
  check of this script (the CPU).

Each case runs ``analytic_hessian`` with dipoles once, then central
differences (h = 1e-3 bohr) of the port's gradients along one coordinate
of its first atom, and prints one JSON line: the wall time split into
L_RR/L_kR (``transport``, ``1e``, ``2e``, ``xc``, ``nuc``), CG and
dipole, the CG iterations per chunk, |H - H^T| before the symmetrization,
the launches of each kernel, the DF term's dX/dR bytes, the peak device
memory (the card only; also per phase, printed as each ends), the largest
|H - H_FD| on the column, and the count of imaginary modes (at a geometry
that is not a minimum, some may be).
Exits non-zero if the column is more than 1e-4 Ha/bohr^2 off.
"""

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cctpu_torch.core.molecule import Molecule  # noqa: E402
from cctpu_torch.grad.scf_grad import gradient  # noqa: E402
from cctpu_torch.hessian import cphf  # noqa: E402
from cctpu_torch.hessian.frequencies import harmonic_analysis  # noqa: E402
from cctpu_torch.io.embed3d import smiles_to_molecule  # noqa: E402
from cctpu_torch.ops import df_j, df_jk, df_k, df_k_dm  # noqa: E402
from cctpu_torch.utils.measure import ASPIRIN, PHENOL, WATER  # noqa: E402
from cctpu_torch.utils.profiling import PhaseTimer  # noqa: E402
from cctpu_torch.workflows.common import make_scf  # noqa: E402

SCF = dict(conv_tol=1e-12, conv_tol_grad=1e-8, max_cycle=100)
OPS = {"df_jk_fused": df_jk, "df_j": df_j, "df_k": df_k, "df_k_dm": df_k_dm}
# name: (molecule at a basis, grid level)
CASES = {
    "phenol_incore": (lambda: Molecule.from_atoms(PHENOL, basis="6-31+g**"),
                      3),
    "aspirin_df": (lambda: smiles_to_molecule(ASPIRIN, basis="6-31g*"), 3),
    "water_sto3g_df": (lambda: Molecule.from_atoms(WATER, basis="sto-3g"),
                       1),
    "water_sto3g_incore": (lambda: Molecule.from_atoms(WATER,
                                                       basis="sto-3g"), 1),
}
FD_TOL = 1e-4


class MemTimer(PhaseTimer):
    """A ``PhaseTimer`` that also keeps each phase's peak device memory
    (GB) and prints it as the phase ends, so a run that fails still shows
    where the memory went."""

    def __init__(self, device):
        super().__init__(device)
        self.peaks = {}

    @contextlib.contextmanager
    def phase(self, name):
        torch.cuda.reset_peak_memory_stats(self.device)
        with super().phase(name):
            yield
        peak = torch.cuda.max_memory_allocated(self.device) / 1e9
        self.peaks[name] = max(self.peaks.get(name, 0.0), peak)
        print(json.dumps({"phase": name, "peak_mem_GB": peak}), flush=True)


def run(name, device):
    build, grid = CASES[name]
    mol = build()
    df = True if name == "water_sto3g_df" else None    # else by size
    opts = dict(grid_level=grid, device=device, **SCF)
    mf = make_scf(mol, "b3lyp", df, **opts)
    t0 = time.time()
    mf.kernel()
    scf_s = time.time() - t0
    if not mf.converged:
        raise RuntimeError(f"{name}: SCF did not converge")
    cuda = mf.device.type == "cuda"
    for m in OPS.values():
        m.LAUNCHES = 0
    timer, stats = (MemTimer(mf.device) if cuda else PhaseTimer()), {}
    t0 = time.time()
    H, dmu = cphf.analytic_hessian(mf, with_dipole=True, timer=timer,
                                   stats=stats)
    if cuda:
        torch.cuda.synchronize(mf.device)
    wall = time.time() - t0
    ph = timer.phases
    rec = {"case": name, "natm": mol.natm, "nao": mol.nao,
           "density_fit": bool(mf.density_fit), "scf_s": scf_s,
           "scf_cycles": mf.n_cycles, "wall_s": wall,
           "L_RR_L_kR_s": sum(ph.get(k, 0.0) for k in
                              ("transport", "1e", "2e", "xc", "nuc")),
           "cg_s": ph.get("cg", 0.0), "dipole_s": ph.get("dipole", 0.0),
           "phases_s": ph, **stats,
           "launches": {k: m.LAUNCHES for k, m in OPS.items()},
           "peak_mem_GB": max(timer.peaks.values()) if cuda else None,
           "peak_mem_GB_by_phase": timer.peaks if cuda else None}
    rec["df_dx_GB"] = cphf.df_dx_bytes(mf) / 1e9
    # central differences along the first atom's y
    t0 = time.time()
    g = []
    for sgn in (1.0, -1.0):
        c = mol.coords.copy()
        c[0, 1] += sgn * 1e-3
        m2 = make_scf(mol.with_coords(c), "b3lyp", df, **opts)
        m2.kernel(dm0=mf.dm)
        if not m2.converged:
            raise RuntimeError(f"{name}: displaced SCF did not converge")
        g.append(gradient(m2).cpu().numpy().ravel())
    col = (g[0] - g[1]) / 2e-3
    rec["fd_column_s"] = time.time() - t0
    rec["max_abs_dH_vs_port_fd_column"] = float(np.abs(H[1] - col).max())
    rec["n_imaginary"] = int(harmonic_analysis(mol, H, dmu).n_imaginary)
    print(json.dumps(rec), flush=True)
    return rec["max_abs_dH_vs_port_fd_column"] <= FD_TOL


def main(argv):
    device = "cpu" if "--device" in argv and \
        argv[argv.index("--device") + 1] == "cpu" else None
    names = [a for a in argv if a in CASES] or ["phenol_incore",
                                                 "aspirin_df"]
    if device is None:
        print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                       "--format=csv,noheader").read().strip(), flush=True)
    ok = []
    for n in names:
        try:
            ok.append(run(n, device))
        except torch.OutOfMemoryError as e:     # the next case still runs
            print(json.dumps({"case": n, "error": str(e)[:400]}), flush=True)
            ok.append(False)
        torch.cuda.empty_cache()
    sys.exit(0 if all(ok) else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
