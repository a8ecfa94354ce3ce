"""The PCM gradient's ``pcm`` phase and the potential integrals' build on
the card, at phenol DF-B3LYP/6-31G* in IEF-PCM water (2,106 points,
nao 110).

1. One SCF (grid level 2, conv_tol 1e-10).
2. ``PCMModel.nuclear_gradient`` with its walk's element budget at a
   quarter of ``PCM_BUDGET`` and at ``PCM_BUDGET``, in the order quarter,
   whole, whole, quarter: each call's seconds, the walk's chunk count and
   the largest difference between the two budgets' gradients.
3. A torch.profiler trace of one ``nuclear_gradient`` and of one
   ``potential_integrals``: the operators with the most device time, the
   device-busy share of the wall time.

Usage (one card):  python scripts/probe_pcm_grad.py [--out DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import torch  # noqa: E402

from cctpu_torch.core.molecule import Molecule  # noqa: E402
from cctpu_torch.dft.rks import RKS  # noqa: E402
from cctpu_torch.solvent import pcm  # noqa: E402
from cctpu_torch.utils.measure import PHENOL  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn, label, out_dir):
    """(device-busy seconds, wall seconds, top operators) of one call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    table = ka.table(sort_by="cuda_time_total", row_limit=15)
    with open(os.path.join(out_dir, f"pcm_trace_{label}.txt"), "w") as f:
        f.write(table)
    busy = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += ev.device_time / 1e6
    top = sorted(((e.key, e.device_time_total / 1e6, e.count) for e in ka
                  if e.device_time_total > 0), key=lambda x: -x[1])[:8]
    return busy, wall, top


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mol = Molecule.from_atoms(PHENOL, basis="6-31g*")
    mf = pcm.PCM(RKS(mol, xc="b3lyp", density_fit=True, grid_level=2,
                     conv_tol=1e-10, max_cycle=60, device=dev))
    e = mf.kernel()
    model = mf._pcm
    dm = mf.make_rdm1()
    print(json.dumps({"E": e, "converged": bool(mf.converged),
                      "npts": int(model.pts.shape[0])}), flush=True)

    whole = pcm.PCM_BUDGET
    budgets = {"quarter": whole // 4, "whole": whole}
    res = {k: {"s": []} for k in budgets}
    grads = {}
    for key in ("quarter", "whole", "whole", "quarter"):
        pcm.PCM_BUDGET = budgets[key]
        try:
            g, s = timed(lambda: model.nuclear_gradient(mf.coords, dm))
            res[key]["chunks"] = sum(1 for _ in pcm._walk(
                mol.basis_set, mf.coords, model.point_ranges(),
                budgets[key]))
        finally:
            pcm.PCM_BUDGET = whole
        res[key]["s"].append(s)
        grads[key] = g
    res["max_abs_diff"] = float((grads["whole"] - grads["quarter"])
                                .abs().max())
    print(json.dumps({"nuclear_gradient": res}), flush=True)

    out = {}
    for label, fn in (
            ("grad", lambda: model.nuclear_gradient(mf.coords, dm)),
            ("ints", lambda: pcm.potential_integrals(
                mol.basis_set, mf.coords, model.pts))):
        fn()
        busy, wall, top = traced(fn, label, args.out)
        out[label] = {"wall_s": wall, "device_busy_s": busy,
                      "idle_share": 1.0 - busy / wall, "top": top}
    print(json.dumps({"traces": out}), flush=True)


if __name__ == "__main__":
    main()
