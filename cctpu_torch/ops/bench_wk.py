"""Time the DF J/K kernels on the card beside their plain versions, the
one-call library versions and their bounds, at phenol's, phenoxyl's and
C16H34's shapes (random f64 inputs made on the card from a seed).

    python -m cctpu_torch.ops.bench_wk [--reps 10] [--shapes phenol,c16h34]
                                       [--check] [--staging KT,STAGES]
                                       [--ring-min BYTES] [--ablate BITS]
                                       [--profile]

Prints the card's name and power limit, the ptxas report of the f64
tensor-core instantiations, then one JSON line per kernel and shape:
milliseconds of two alternated rounds (plain, kernel, kernel, plain; each
the median of ``--reps`` calls timed one by one with CUDA events, so the
host's time before each launch is inside), the library call's, the bound,
and ``queued_ms`` / ``host_ms``: the card's and the host's time a call
when many are queued back to back. ``--check`` only builds and holds every
kernel against its plain version once, printing the plans that ran.

For tuning ops/plan.py: ``--staging`` puts one (kt, stages) first in the
plan's STAGING order, ``--ring-min`` sets RING_BYTES_MIN (0: the ring of
tiles never shares W_p^T's shared memory). ``--ablate`` builds the W/K
kernels without parts of wk_mma (bits: 1 the W products, 2 the K products,
4 the jp sums, 8 the J sweep, 16 the reads and writes of a partial K in
device memory); the results are then wrong and only the
times are read. ``--profile`` builds them with clock counters and prints
the clocks thread 0 of a block spends in each phase, averaged over the
blocks. To compare two trees, run the module from each tree's root
in turns within one job on one card.
"""

import argparse
import json
import sys

import torch

import chip_smoke as cs
from cctpu_torch.ops import build, df_j, df_jk, df_k

try:
    from cctpu_torch.ops import plan
except ImportError:          # a tree from before ops/plan.py
    plan = None

# the phases wk_mma's thread 0 clocks with --profile
PROFILE_PHASES = ("wait_copies", "barrier", "issue_copies", "w_products",
                  "jp_and_w_store", "row_barrier", "k_products",
                  "j_sweep_and_loop")
SHAPES = {"phenol": (1770, 110, 25), "phenoxyl": (1671, 108, 25),
          "c16h34": (6038, 292, 65)}


def queued_ms(fn, n: int) -> tuple:
    """(card, host) milliseconds a call of n queued back to back: the
    card's time without the gaps the host leaves before each launch, and
    the host's time to enqueue one."""
    import time
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    host = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--staging", default=None)
    ap.add_argument("--ring-min", type=int, default=None)
    ap.add_argument("--ablate", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--shapes", default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_wk: no CUDA device")
    dev = torch.device("cuda", 0)
    if args.staging and plan is not None:
        kt, st = (int(x) for x in args.staging.split(","))
        plan.STAGING = [(kt, st)] + list(plan.STAGING)
    if args.ring_min is not None and plan is not None:
        plan.RING_BYTES_MIN = args.ring_min
    if args.profile:
        build.NVCC_FLAGS.append("-DWK_PROFILE")
        stash = {}
        inner = plan.workspaces

        def keep(*a, **k):
            stash["ws"] = inner(*a, **k)
            return stash["ws"]
        plan.workspaces = keep
    if args.ablate:
        build.NVCC_FLAGS.append(f"-DWK_ABLATE={args.ablate}")
    cs.emit(cs.card_line())
    build.compile_all()
    for m in (df_jk, df_j, df_k):
        m.build()
    if hasattr(build, "ptxas_report"):
        for lib in ("df_jk_fused", "df_k"):
            cs.emit({"ptxas": lib,
                     "wk_mma": build.ptxas_report(lib, "wk_mma")})
    names = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    for name in names:
        naux, nao, nocc = SHAPES[name]
        B, D, C = cs.device_inputs(naux, nao, nocc, naux, torch.float64, dev)
        D2 = torch.stack([D, D @ D / D.abs().max()])
        reps = args.reps if name != "c16h34" else max(3, args.reps // 3)
        J, K = df_jk.df_jk_fused(B, D, C)
        Jr, Kr = df_jk.df_jk_reference(B, D, C)
        K1 = df_k.df_k_fast(B, C)
        torch.cuda.synchronize()
        errs = {"rel_err_J": cs.rel_err(J, Jr), "rel_err_K": cs.rel_err(K, Kr),
                "rel_err_K_df_k": cs.rel_err(K1, Kr)}
        cs.emit({"shape": name, **errs,
                 "plan_fused": getattr(df_jk, "LAST_PLAN", None),
                 "plan_df_k": getattr(df_k, "LAST_PLAN", None)})
        if args.profile:
            for label, call in (("df_k", lambda: df_k.df_k_fast(B, C)),
                                ("df_jk_fused",
                                 lambda: df_jk.df_jk_fused(B, D, C))):
                call()
                torch.cuda.synchronize()
                clocks = stash["ws"][1][:, :8].mean(dim=0).tolist()
                cs.emit({"shape": name, "kernel": label, "clocks_mean_of_"
                         "blocks": dict(zip(PROFILE_PHASES, clocks))})
            continue
        if max(errs.values()) > 1e-12 and not args.ablate:
            raise RuntimeError(f"bench_wk: a kernel disagrees at {name}")
        del J, K, Jr, Kr, K1
        if args.check:
            continue
        rows = {
            "df_jk_fused": (lambda: df_jk.df_jk_fused(B, D, C),
                            lambda: df_jk.df_jk_reference(B, D, C), None,
                            cs.work("df_jk_fused", naux, nao, nocc)),
            "df_k": (lambda: df_k.df_k_fast(B, C),
                     lambda: df_k.df_k_reference(B, C),
                     lambda: cs.k_library(B, C),
                     cs.work("df_k", naux, nao, nocc)),
            "df_j": (lambda: df_j.df_j_fast(B, D2),
                     lambda: df_j.df_j_reference(B, D2),
                     lambda: torch.einsum("pij,sij,pkl->skl", B, D2, B),
                     cs.work("df_j", naux, nao, nset=2))}
        for kern, (k, p, lib, w) in rows.items():
            t = cs.alternated_ms(k, p, reps, library=lib)
            t["queued_ms"], t["host_ms"] = queued_ms(k, 4 * reps)
            cs.emit({"shape": name, "dims": [naux, nao, nocc],
                     "kernel": kern, **t, **cs.bound(*w)})
        del B, D, C, D2
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
