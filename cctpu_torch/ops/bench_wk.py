"""Time the DF J/K kernels on the card beside their plain versions, the
one-call library versions and their bounds, at phenol's, phenoxyl's and
C16H34's shapes (random f64 inputs made on the card from a seed).

    python -m cctpu_torch.ops.bench_wk [--reps 10] [--shapes phenol,c16h34]
                                       [--check] [--staging KT,STAGES]
                                       [--ring-min BYTES] [--ablate BITS]
                                       [--profile]

Prints the card's name and power limit, the ptxas report of the f64
tensor-core instantiations and of the DF-J kernels, then one JSON line per
kernel and shape (``df_j`` with two densities in f64, ``df_j_nset1`` with
one, ``df_j_f32`` and ``df_j_f32_nset1`` in f32, each with the plan of
ops/plan.py::j_plan that ran and a hash of its f64 result, so that two
trees' results can be compared bit for bit, and the card time a call of
each of its kernels takes, from a torch.profiler trace):
milliseconds of two alternated rounds (plain, kernel, kernel, plain; each
the median of ``--reps`` calls timed one by one with CUDA events, so the
host's time before each launch is inside), the library call's, the bound,
and ``queued_ms`` / ``host_ms``: the card's and the host's time a call
when many are queued back to back. ``--check`` only builds and holds every
kernel against its plain version once, printing the plans that ran; for
``df_j`` at every shape of chip_smoke.py (KERNEL_SHAPES, F64_SHAPES,
C16H34_SHAPE), f64 and f32, one and two densities, repeat calls bitwise.

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
import hashlib
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
# df_j.cu's kernels and the chunk/group sum they share with df_common.cuh
DF_J_KERNELS = ("j_partial", "jp_pass", "partial_sum", "j_sweep")
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
        cs.emit({"ptxas": "df_j", "kernels": build.ptxas_report("df_j", "")})
    if args.check:
        check_df_j(dev)
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
        B32, D32 = B.float(), D2.float()
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
                     cs.work("df_j", naux, nao, nset=2)),
            "df_j_nset1": (lambda: df_j.df_j_fast(B, D),
                           lambda: df_j.df_j_reference(B, D),
                           lambda: torch.einsum("pij,ij,pkl->kl", B, D, B),
                           cs.work("df_j", naux, nao, nset=1)),
            "df_j_f32": (lambda: df_j.df_j_fast(B32, D32),
                         lambda: df_j.df_j_reference(B32, D32),
                         lambda: torch.einsum("pij,sij,pkl->skl", B32, D32,
                                              B32),
                         half(cs.work("df_j", naux, nao, nset=2))),
            "df_j_f32_nset1": (lambda: df_j.df_j_fast(B32, D32[0]),
                               lambda: df_j.df_j_reference(B32, D32[0]),
                               lambda: torch.einsum("pij,ij,pkl->kl", B32,
                                                    D32[0], B32),
                               half(cs.work("df_j", naux, nao, nset=1)))}
        for kern, (k, p, lib, w) in rows.items():
            extra = {}
            if kern == "df_j" or kern.startswith("df_j_"):
                out = k()
                torch.cuda.synchronize()
                extra = {"plan": getattr(df_j, "LAST_PLAN", None),
                         "rel_err": cs.rel_err(out, p()),
                         "sha256_16": hashlib.sha256(
                             out.cpu().numpy().tobytes()).hexdigest()[:16],
                         "traced_ms": traced_ms(k, reps)}
                del out
            t = cs.alternated_ms(k, p, reps, library=lib)
            t["queued_ms"], t["host_ms"] = queued_ms(k, 4 * reps)
            cs.emit({"shape": name, "dims": [naux, nao, nocc],
                     "kernel": kern, **t, **cs.bound(*w), **extra})
        del B, D, C, D2, B32, D32
        torch.cuda.empty_cache()
    return 0


def traced_ms(fn, n: int) -> dict:
    """Card milliseconds a call spends in each of df_j's kernels, from a
    torch.profiler trace of n calls (empty where the trace holds no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        for name in DF_J_KERNELS:
            if us and f"{name}<" in ev.key:
                out[name] = out.get(name, 0.0) + us / n / 1e3
    return out


def half(work):
    """(bytes, flops) of an f32 call: half the f64 bytes."""
    return work[0] / 2, work[1]


def check_df_j(dev):
    """df_j against its plain version at chip_smoke.py's kernel shapes, f64
    and f32, one and two densities; repeat calls bitwise equal."""
    for naux, nao, nocc in cs.KERNEL_SHAPES + cs.F64_SHAPES \
            + [cs.C16H34_SHAPE]:
        for dtype in (torch.float64, torch.float32):
            B, D, _ = cs.device_inputs(naux, nao, nocc, naux + 3, dtype, dev)
            D2 = torch.stack([D, D @ D / D.abs().max()])
            for dm in (D, D2):
                J = df_j.df_j_fast(B, dm)
                plan_j = getattr(df_j, "LAST_PLAN", None)
                same = bool(torch.equal(J, df_j.df_j_fast(B, dm)))
                err = cs.rel_err(J, df_j.df_j_reference(B, dm))
                tol = cs.TOL[str(dtype).split(".")[-1]]
                cs.emit({"check": "df_j", "shape": [naux, nao],
                         "dtype": str(dtype), "nset": dm.shape[0]
                         if dm.ndim == 3 else 1, "rel_err": err,
                         "bitwise_repeat": same, "plan": plan_j})
                if err > tol or not same:
                    raise RuntimeError(f"bench_wk: df_j fails at {naux}/"
                                       f"{nao} {dtype}")
            del B, D, D2, J
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
