"""Shared workflow machinery: flag contract, logging, method dispatch.

Port of ``cctpu/workflows/common.py`` for the methods the port has
(``hf``, ``blyp`` and ``b3lyp``; RHF/RKS for closed shells, UHF/UKS for
``spin != 0``; in-core J/K up to nao 160, density fitted above it or with
``--density-fit``). The flag contract,
the dual short/log reports and their naming scheme
``{smiles}_{script}_{method}_{basis}_{short|log}_report.txt`` are the
reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time
from typing import Optional

from cctpu_torch.core.molecule import Molecule
from cctpu_torch.io.embed3d import smiles_to_molecule


class MultiWriter:
    """Fan stdout-style writes to several streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
            s.flush()

    def flush(self):
        for s in self.streams:
            s.flush()

    def print(self, *args, **kw):
        print(*args, file=self, **kw)


def sanitize(smiles: str) -> str:
    return re.sub(r"[^A-Za-z0-9]", "_", smiles)[:40]


def add_common_args(p: argparse.ArgumentParser, default_method="b3lyp",
                    default_basis="6-31g*"):
    p.add_argument("--smiles", required=True, help="input molecule SMILES")
    p.add_argument("--method", default=default_method,
                   help="hf | blyp | b3lyp (the methods ported so far)")
    p.add_argument("--basis", default=default_basis)
    p.add_argument("--charge", type=int, default=None,
                   help="default: formal charge from SMILES")
    p.add_argument("--spin", type=int, default=0, help="2S = Na - Nb")
    p.add_argument("--use-gpu", action="store_true",
                   help="accepted for reference CLI compatibility (compute "
                        "runs on the CUDA device unless --device cpu)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the SCF and its gradient run (default "
                        "cuda; without a card, cuda raises)")
    p.add_argument("--density-fit", action="store_true", default=None,
                   help="force density fitting (default: auto by size, "
                        "in-core J/K up to nao 160)")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--grid-level", type=int, default=3)
    p.add_argument("--scf-cache", default=None, metavar="DIR",
                   help="warm-start SCFs from, and store converged ones "
                        "in, .npz checkpoints under DIR")
    return p


def open_reports(args, script: str):
    configure_run(args)
    os.makedirs(args.output_dir, exist_ok=True)
    tag = f"{sanitize(args.smiles)}_{script}_{args.method}_" \
          f"{args.basis.replace('*', 's').replace('+', 'p')}"
    short = open(os.path.join(args.output_dir, f"{tag}_short_report.txt"),
                 "w")
    log = open(os.path.join(args.output_dir, f"{tag}_log_report.txt"), "w")
    out = MultiWriter(sys.stdout, short, log)
    # config provenance sidecar: every run records what produced it
    cfg = {k: v for k, v in vars(args).items()
           if isinstance(v, (str, int, float, bool, type(None), list))}
    cfg["_script"] = script
    cfg["_cctpu_torch_version"] = __import__("cctpu_torch").__version__
    with open(os.path.join(args.output_dir, f"{tag}_config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    return out, short, log, tag


def make_scf(mol: Molecule, method: str, density_fit: Optional[bool] = None,
             grid_level: int = 3, **opts):
    """Method string -> SCF object; ``opts`` go to the SCF (``device``
    among them: the card unless ``device="cpu"``)."""
    m = method.lower()
    if density_fit is None:
        density_fit = mol.nao > 160
    if m == "mp2":
        raise NotImplementedError("MP2 is not ported yet (ROADMAP.md "
                                  "queue 1 item 15)")
    open_shell = mol.spin != 0
    if m == "hf":
        from cctpu_torch.scf.hf import RHF, UHF
        mf = (UHF if open_shell else RHF)(mol, density_fit=density_fit,
                                          **opts)
    else:
        from cctpu_torch.dft.rks import RKS, UKS
        mf = (UKS if open_shell else RKS)(mol, xc=m, density_fit=density_fit,
                                          grid_level=grid_level, **opts)
    return mf


# Global run context set once per workflow invocation (open_reports)
PHASES = None      # utils.profiling.PhaseTimer | None
_SCF_CACHE = None  # utils.chkfile.SCFCache | None


def configure_run(args):
    """Install the phase timer and, with ``--scf-cache``, the SCF cache for
    this workflow run."""
    global PHASES, _SCF_CACHE
    from cctpu_torch.utils.profiling import PhaseTimer
    PHASES = PhaseTimer()
    cache_dir = getattr(args, "scf_cache", None)
    if cache_dir:
        from cctpu_torch.utils.chkfile import SCFCache
        _SCF_CACHE = SCFCache(cache_dir)
    else:
        _SCF_CACHE = None
    return PHASES


def report_phases(log=print):
    if PHASES is not None and PHASES.phases:
        log("\nPhase timings:")
        PHASES.report(log)


def run_scf(mol, method, density_fit=None, dm0=None, log=None, **opts):
    """SCF with the fallback ladder: preferred settings -> damped/level-
    shifted retry from the unconverged density. Warm-starts from, and
    stores a converged SCF to, the configured SCF cache."""
    timer = (PHASES.phase(f"scf:{method}") if PHASES is not None
             else contextlib.nullcontext())
    with timer:
        if dm0 is None and _SCF_CACHE is not None:
            dm0 = _SCF_CACHE.get(mol, method)
            if dm0 is not None and log:
                log("SCF warm start from checkpoint cache")
        mf = make_scf(mol, method, density_fit, **opts)
        e = mf.kernel(dm0=dm0)
        if not mf.converged:
            if log:
                log("SCF not converged; retrying with level shift + damping")
            mf2 = make_scf(mol, method, density_fit,
                              level_shift=0.3, damp=0.3, max_cycle=200,
                              **opts)
            e2 = mf2.kernel(dm0=mf.make_rdm1())
            if mf2.converged:
                mf, e = mf2, e2
        if _SCF_CACHE is not None and mf.converged:
            _SCF_CACHE.put(mf, method)
    return mf, e


def build_molecule(args, basis=None, spin=None, log=None) -> Molecule:
    return smiles_to_molecule(args.smiles, charge=args.charge,
                              spin=args.spin if spin is None else spin,
                              basis=basis or args.basis)


def homo_lumo(mf):
    """(HOMO, LUMO) energies; the alpha spin's for UHF/UKS."""
    e = mf.mo_energy.cpu().numpy()
    if e.ndim == 2:
        e = e[0]
        nocc = mf.mol.nalpha
    else:
        nocc = mf.mol.nelectron // 2
    return float(e[nocc - 1]), float(e[nocc])


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def lap(self):
        return time.time() - self.t0
