"""Where the nuclear gradient's time goes on the card.

    python -m cctpu_torch.grad.profile_grad [--route df|incore] \
        [--out grad_profile.json]

Converges phenol B3LYP/6-31G* (grid level 2, conv_tol 1e-12) on the card,
density-fitted and then in-core (or only the ``--route`` given), and prints the card's name and power
limit and, for each route, one JSON line each for:

- ``terms``: two gradient calls, the seconds of each term;
- ``trace``: a torch.profiler trace of one call of each two-electron
  term (DF: 3c and 2c; in-core: the direct 2e term), of the XC term and
  of the whole gradient: CUDA kernels launched, the card's busy time (the
  sum of the kernels' times: one stream, so they do not overlap) against
  the host's wall time, and the kernels that took most of the card's time.

The terms' chunk budget is ``df_grad._GRAD_BUDGET``: to weigh another,
set it and run this again.
"""

import argparse
import json
import time

import torch

from cctpu_torch.core.molecule import Molecule
from cctpu_torch.dft.rks import RKS
from cctpu_torch.grad import df_grad
from cctpu_torch.grad.scf_grad import direct_e2_gradient, gradient
from cctpu_torch.utils.measure import PHENOL, card_line, emit
from cctpu_torch.utils.profiling import PhaseTimer


def trace(fn, dev, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: CUDA kernels launched, the
    card's busy seconds (the sum of the kernels' times) and the host's
    wall seconds, and the ``top`` kernels by card time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() * 1e-6
            by_name[e.name][1] += 1
    busy = sum(t for t, _ in by_name.values())
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels": sum(n for _, n in by_name.values()), "busy_s": busy,
            "wall_s": wall, "idle_share": 1.0 - busy / wall,
            "top": [[name[:60], t, n] for name, (t, n) in tops]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=("df", "incore"), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_grad: no CUDA device")
    dev = torch.device("cuda", 0)
    lines = [card_line()]
    for route in [args.route] if args.route else ("df", "incore"):
        mf = RKS(Molecule.from_atoms(PHENOL, basis="6-31g*"), xc="b3lyp",
                 density_fit=route == "df", grid_level=2, conv_tol=1e-12,
                 conv_tol_grad=1e-8, device=dev)
        mf.kernel()
        assert mf.converged

        calls = []
        for _ in range(2):
            timer = PhaseTimer(dev)
            t0 = time.time()
            gradient(mf, timer)
            torch.cuda.synchronize(dev)
            calls.append({"s": time.time() - t0, "terms_s": timer.phases})
        lines.append({"phase": "terms", "route": route, "calls": calls})

        if route == "df":
            jk = mf.get_jk_builder()
            Ws, Zs = df_grad._wz(jk.B, jk._Linv, mf.dm,
                                 df_grad.occupied_factors(mf), mf.func.hyb)
            basis = mf.mol.basis_set
            e2 = {"3c": trace(lambda: df_grad._grad_3c(
                      basis, jk.aux, mf.coords, Ws), dev),
                  "2c": trace(lambda: df_grad._grad_2c(
                      jk.aux, mf.coords, Zs), dev)}
            del jk, Ws, Zs
        else:
            e2 = {"2e": trace(lambda: direct_e2_gradient(mf), dev)}
        lines.append({"phase": "trace", "route": route, "terms": {
            **e2, "xc": trace(lambda: mf.exc_of_coords(mf.coords, mf.dm),
                              dev),
            "gradient": trace(lambda: gradient(mf), dev)}})
        del mf
        torch.cuda.empty_cache()

    for ln in lines:
        emit(ln)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
