"""Check and time ``df_k_dm`` (the DF exchange of general densities) on the
card.

    python -m cctpu_torch.ops.bench_k_dm

``measure`` is the one check of the kernel at a given B and batch of
densities; ``chip_smoke.py`` phase 11 calls it at the factors its TDDFT
phases built. Run as a module it calls it at random B and non-symmetric D
of those shapes (phenol 6-31G*, its wB97X-D B_lr, aspirin 6-31G*) and at
small odd and unaligned ones, with one density and a Davidson block of 12.
Prints the card's name and power limit first; needs a CUDA device.
"""

import torch

from cctpu_torch.ops import build, df_k_dm
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
    (CUDA events, in turns) and the bound."""
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
    return {**row, **t, **bound(*work("df_k_dm", naux, nao, nset=nset))}


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k_dm: no CUDA device")
    print(card_line())
    build.compile_all(["df_k_dm"])
    print("DMMA in df_k_dm:", build.sass_count("df_k_dm", "DMMA"))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for naux, nao, nset in SHAPES:
        B = torch.randn((naux, nao, nao), generator=g, dtype=torch.float64,
                        device=dev)
        D = torch.randn((nset, nao, nao), generator=g, dtype=torch.float64,
                        device=dev)
        print({"shape": (naux, nao, nset), **measure(B, D)}, flush=True)
        del B, D
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
