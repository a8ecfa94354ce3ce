"""Check and time ``df_k_dm`` (the DF exchange of general densities) on the
card.

    python -m cctpu_torch.ops.bench_k_dm [--routes]

``measure`` is the one check of the kernel at a given B and batch of
densities; ``chip_smoke.py`` phase 11 calls it at the factors its TDDFT
phases built. Run as a module it calls it at random B and non-symmetric D
of those shapes (phenol 6-31G*, its wB97X-D B_lr, aspirin 6-31G*) and at
small odd and unaligned ones, with one density and a Davidson block of 12.
Each line carries the launch plan (``ops/plan.py::k_dm_plan``), the share
of its DMMA work issued on padding, the achieved FP64 TFLOP/s (4*nao flops
per element of B and density over the kernel's time) and the share of the
bound. Prints the card's name and power limit first and the ptxas report;
needs a CUDA device. ``--routes`` instead times, at each shape whose plan
takes tensor copies, the same plan with cp.async in their place
(``route_ms``).
"""

import argparse
import contextlib

import torch

from cctpu_torch.ops import build, df_k_dm, plan
from cctpu_torch.utils.measure import (alternated_ms, bound, card_line,
                                       rel_err, work)

SHAPES = [(37, 16, 1), (61, 15, 3), (40, 130, 2), (13, 257, 5),
          (7, 384, 2), (1770, 110, 1), (1770, 110, 12), (418, 110, 12),
          (2991, 198, 1), (2991, 198, 12)]


def measure(B, D, reps: int = 3) -> dict:
    """``df_k_dm(B, D)`` for D [nset, nao, nao] against its plain twin (the
    einsum, which is also its library call): the f64 error, two calls
    bitwise equal, the last density alone and the batch split in two calls
    bitwise equal to the batch's (``batch_invariant``), kernel / plain ms
    (CUDA events, in turns), the bound, the plan, its padded DMMA share,
    the achieved FP64 TFLOP/s and the share of the bound."""
    naux, nao, nset = int(B.shape[0]), int(B.shape[1]), int(D.shape[0])
    K, K2 = df_k_dm.df_k_dm(B, D), df_k_dm.df_k_dm(B, D)
    Kr = df_k_dm.df_k_dm_reference(B, D)
    one = torch.equal(df_k_dm.df_k_dm(B, D[-1]), K[-1])
    h = max(1, nset // 3)
    split = one if nset == 1 else torch.equal(
        torch.cat([df_k_dm.df_k_dm(B, D[:h]), df_k_dm.df_k_dm(B, D[h:])]), K)
    row = {"max_abs_err": float((K - Kr).abs().max()),
           "rel_err": rel_err(K, Kr),
           "bitwise_repeat": bool(torch.equal(K, K2)),
           "batch_invariant": bool(one and split)}
    del K, K2, Kr
    t = alternated_ms(lambda: df_k_dm.df_k_dm(B, D),
                      lambda: df_k_dm.df_k_dm_reference(B, D), reps)
    t["library_ms"] = t["plain_ms"]
    nbytes, flops = work("df_k_dm", naux, nao, nset=nset)
    b = bound(nbytes, flops)
    plan = df_k_dm.LAST_PLAN
    return {**row, **t, **b,
            "plan": {k: plan[k] for k in ("variant", "nj", "npanel", "nh",
                                          "jt", "stages", "groups", "tma")},
            "padded_share": plan["padded_share"],
            "tflops": flops / t["ms"] / 1e9,
            "bound_share": b["bound_ms"] / t["ms"]}


@contextlib.contextmanager
def _cp_async_plan():
    """``k_dm_plan`` with cp.async in place of the tensor copies."""
    orig = plan.k_dm_plan
    plan.k_dm_plan = lambda *a: {**orig(*a), "tma": 0}
    try:
        yield
    finally:
        plan.k_dm_plan = orig


def route_ms(B, D, reps: int = 5) -> dict:
    """``df_k_dm(B, D)`` with its plan's tensor copies (``ms``) and with
    cp.async in their place (``cp_async_ms``), timed in turns (cp.async,
    tensor copies, tensor copies, cp.async), and whether the two routes
    give bitwise-equal K (they sum in the same order)."""
    def cp_async():
        with _cp_async_plan():
            return df_k_dm.df_k_dm(B, D)
    same = bool(torch.equal(df_k_dm.df_k_dm(B, D), cp_async()))
    t = alternated_ms(lambda: df_k_dm.df_k_dm(B, D), cp_async, reps)
    return {"ms": t["ms"], "cp_async_ms": t["plain_ms"],
            "ms_rounds": t["kernel_ms_rounds"],
            "cp_async_ms_rounds": t["plain_ms_rounds"],
            "bitwise_equal": same}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k_dm: no CUDA device")
    print(card_line())
    build.compile_all(["df_k_dm"])
    print("DMMA in df_k_dm:", build.sass_count("df_k_dm", "DMMA"))
    print("\n".join(build.ptxas_report("df_k_dm", "kdm_mma")))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for naux, nao, nset in SHAPES:
        if args.routes and not plan.k_dm_plan(naux, nao)["tma"]:
            continue
        B = torch.randn((naux, nao, nao), generator=g, dtype=torch.float64,
                        device=dev)
        D = torch.randn((nset, nao, nao), generator=g, dtype=torch.float64,
                        device=dev)
        row = route_ms(B, D) if args.routes else measure(B, D)
        print({"shape": (naux, nao, nset), **row}, flush=True)
        del B, D
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
