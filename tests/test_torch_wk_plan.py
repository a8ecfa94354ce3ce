"""The launch plans of the DF kernels (cctpu_torch/ops/plan.py::wk_plan for
the W/K kernels, ::j_plan for DF-J), the one part of them that runs
without a card: every shape chip_smoke.py and tests/test_torch_gpu.py
launch, both element sizes, with and without the fused Coulomb pass, one
and two densities. Needs neither JAX nor a card."""

import pytest
import torch

from cctpu_torch.ops import df_j
from cctpu_torch.ops import plan as P
from test_torch_threads import one_torch_thread  # noqa: F401

CAP = P.SMEM_CAP_H100
# (nao, nocc): chip_smoke.py's kernel shapes, phenol, phenoxyl (both spins),
# the H atom, C16H34, tests/test_torch_gpu.py's shapes (a C32H66-sized row,
# an odd nao, both sides of each plan boundary)
SHAPES = [(32, 8), (16, 3), (24, 5), (110, 25), (108, 25), (108, 24), (2, 1),
          (292, 65), (600, 129), (61, 15), (7, 5), (112, 20), (120, 20),
          (150, 20), (180, 40), (330, 80), (112, 100), (360, 60),
          # a grid of drug-sized shapes between and beyond them
          (64, 16), (90, 45), (128, 32), (160, 40), (200, 50), (256, 64),
          (400, 40), (512, 24)]
CASES = [(nao, nocc, size, with_j) for nao, nocc in SHAPES
         for size in (8, 4) for with_j in (True, False)]
# df_j: both sides of each one_pass | two_pass boundary (f64: nao 168 for
# one density, 118 for two; f32: 240 and 168), C16H34 and a C32H66-sized
# row, odd nao, few and many aux rows
J_SHAPES = [(naux, nao) for naux in (1, 20, 1671, 6038)
            for nao in (2, 15, 118, 119, 168, 169, 240, 241, 292, 293, 600)]
J_CASES = [(naux, nao, nset, size) for naux, nao in J_SHAPES
           for nset in (1, 2) for size in (8, 4)]


def test_every_plan_fits_and_is_consistent():
    """All of CASES in one test: the tier-1 command's xdist scheduling
    depends on the number of collected tests (see ROADMAP queue 3), so the
    cases are not parametrised."""
    for case in CASES:
        _check_plan(*case)
    for case in J_CASES:
        _check_j_plan(*case)


def _check_j_plan(naux, nao, nset, size, sms=P.SMS_H100):
    p = P.j_plan(naux, nao, nset, size, CAP, sms)
    assert p == P.j_plan(naux, nao, nset, size, CAP, sms)     # pure
    ints = P.j_plan_ints(p)
    assert len(ints) == len(P.J_PLAN_INTS) and all(
        isinstance(v, int) for v in ints)
    n2 = nao * nao
    # one_pass exactly where the partial J and the block sum fit
    fits = size * nset * (512 + n2) <= CAP
    assert p["kind"] == ("one_pass" if fits else "two_pass")
    assert ints[0] == int(not fits)
    # the workspace df_j.py allocates for the plan
    assert df_j.workspace(p, torch.empty(0, dtype={8: torch.float64, 4:
                          torch.float32}[size])).numel() == p["ws_elems"]
    if fits:
        assert p["threads"] == 512 and p["smem_bytes"] <= CAP
        assert p["nblk"] <= min(naux, sms)
        assert (p["nblk"] - 1) * p["rows"] < naux <= p["nblk"] * p["rows"]
        # the blocking of the W/K kernels (build.blocks)
        assert (p["nblk"], p["rows"]) == P.blocks(naux, sms)
        assert p["ws_elems"] == p["nblk"] * nset * n2
        return
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 256
    assert p["vec"] == (16 // size if nao % 2 == 0 else 1)
    assert n2 % p["vec"] == 0
    # jp_pass: column chunks of threads x 64 bytes, groups of aux rows
    chunk = p["threads"] * 64 // size
    assert (p["nchunk"] - 1) * chunk < n2 <= p["nchunk"] * chunk
    assert (p["nblk"] - 1) * p["rows"] < naux <= p["nblk"] * p["rows"]
    # the J sweep: a few row groups, and more than one only where one
    # group's blocks number fewer than J_SWEEP_FILL an SM
    g, rows = p["sweep_groups"], p["sweep_rows"]
    assert 1 <= g <= P.J_SWEEP_MAX_GROUPS
    assert (g - 1) * rows < naux <= g * rows
    assert p["sweep_blocks"] * p["threads"] * p["vec"] >= n2
    assert g == 1 or p["sweep_blocks"] * (g - 1) < P.J_SWEEP_FILL * sms
    jsw = g * nset * n2 if g > 1 else 0
    assert p["ws_elems"] == p["nchunk"] * nset * naux + nset * naux + jsw


def _check_plan(nao, nocc, size, with_j):
    p = P.wk_plan(nao, nocc, size, CAP, with_j)
    assert p["smem_bytes"] <= CAP == 232448
    assert p == P.wk_plan(nao, nocc, size, CAP, with_j)       # pure
    ints = P.plan_ints(p)
    assert len(ints) == len(P.PLAN_INTS) and all(
        isinstance(v, int) for v in ints)
    assert (p["j_in"] is None) == (not with_j)
    if size == 4:
        assert p["kind"] == "fma"       # no true-f32 tensor-core path
    if p["kind"] == "fma":
        assert 1 <= p["kt"] <= nao
        assert p["kw_elems"] == nao * nao
        assert (p["ws_elems"] > 0) == (p["w_in"] == "slab")
        return
    var = P.VARIANTS[p["variant"]]
    warps = var["threads"] // 32
    mt, nt = -(-nao // 16), -(-nocc // 8)
    # what the m16n8k4 tiles and the 16-byte copies need
    assert p["kt"] % 4 == 0 and p["kt"] & (p["kt"] - 1) == 0
    assert 2 <= p["stages"] <= 4
    assert p["wm"] * p["wn"] == warps
    assert -(-p["mt_panel"] // p["wm"]) <= var["mtm"]
    assert -(-nt // p["wn"]) <= var["ntm"]
    assert p["npanel"] * p["mt_panel"] >= mt
    assert not (p["alias"] and p["npanel"] > 1)
    # the shared memory the kernel will lay out, summed again
    wt = -(-nao // 8) * 8 * (nt * 8 + 4)
    # the ring stages a tile of B, with J the same tile of D, and one of C
    ring = p["stages"] * p["kt"] * (
        (2 if with_j else 1) * p["mt_panel"] * 16 + nt * 8)
    j = nao * nao if p["j_in"] == "smem" else 0
    assert p["smem_bytes"] == 8 * (
        (max(wt, ring) if p["alias"] else wt + ring) + j) + P.HEADER_BYTES
    # tensor copies only where rows of B start at multiples of 16 bytes
    assert not p["tma"] or (nao % 2 == 0 and p["kt"] in P.TMA_KT
                            and p["mt_panel"] * 16 <= 512)
    # K in registers only where its doubles per thread fit the budget
    ntri = mt * (mt + 1) // 2
    assert p["kw_elems"] == 256 * ntri
    if p["k_in"] == "registers":
        assert 0 < p["k_regs_per_thread"] <= var["k_budget"]
        assert 8 * -(-ntri // warps) == p["k_regs_per_thread"]
    else:
        assert var["k_budget"] == 0 and p["k_regs_per_thread"] == 0


def test_named_plans():
    """Phenol and phenoxyl: tensor-core plan, B read once, W_p in shared
    memory, K in registers, the partial J in shared memory. C16H34: tensor
    cores, one panel, the ring shares W_p's shared memory, K partial in
    device memory, J by the second pass. A C32H66-sized row: W_p fits no
    shared memory, the FMA kernel. K leaves the registers above nao 112. A
    smaller cap gives a smaller plan or raises."""
    for nao, nocc in [(110, 25), (108, 25), (108, 24)]:
        for with_j in (True, False):
            p = P.wk_plan(nao, nocc, 8, CAP, with_j)
            assert (p["kind"], p["variant"], p["npanel"]) == \
                ("mma", "small", 1)
            assert p["w_in"] == "smem" and p["k_in"] == "registers"
            assert p["j_in"] == ("smem" if with_j else None)
    p = P.wk_plan(292, 65, 8, CAP, True)
    assert (p["kind"], p["variant"], p["npanel"], p["alias"]) == \
        ("mma", "large", 1, 1)
    assert (p["k_in"], p["j_in"], p["jw_elems"]) == ("device", "pass", -1)
    q = P.wk_plan(600, 129, 8, CAP, True)
    assert (q["kind"], q["w_in"], q["j_in"]) == ("fma", "slab", "device")
    assert P.wk_plan(112, 20, 8, CAP, False)["k_in"] == "registers"
    assert P.wk_plan(113, 20, 8, CAP, False)["k_in"] == "device"
    p = P.wk_plan(110, 25, 8, 100 * 1024, True)
    assert p["smem_bytes"] <= 100 * 1024
    with pytest.raises(ValueError, match="no plan"):
        P.wk_plan(600, 129, 8, 4096, True)
    with pytest.raises(ValueError, match="itemsize"):
        P.wk_plan(110, 25, 2, CAP, True)
    # df_j: the shapes of every SCF phase of chip_smoke.py (phenoxyl's two
    # densities, phenol BLYP's one, the H atom's) and its kernel shapes keep
    # the one-pass kernel; C16H34 runs two passes, in f64 with 16-byte
    # loads and the J sweep's 167 blocks in two row groups; the boundaries
    for naux, nao, nset in [(1671, 108, 2), (1770, 110, 1), (9, 2, 2),
                            (96, 32, 2), (37, 16, 2), (83, 24, 2),
                            (1770, 110, 2), (61, 15, 2)]:
        for size in (8, 4):
            assert P.j_plan(naux, nao, nset, size, CAP)["kind"] == \
                "one_pass"
    p = P.j_plan(6038, 292, 2, 8, CAP)
    assert (p["kind"], p["vec"], p["nchunk"], p["sweep_blocks"],
            p["sweep_groups"]) == ("two_pass", 2, 42, 167, 2)
    assert 8 * p["ws_elems"] < 8e6      # ~7 MB, not [nblk, 2, nao, nao]
    assert P.j_plan(6038, 293, 1, 8, CAP)["vec"] == 1
    assert P.j_plan(6038, 292, 2, 8, CAP, aligned=False)["vec"] == 1
    for size, nset, last in ((8, 1, 168), (8, 2, 118), (4, 1, 240),
                             (4, 2, 168)):
        assert P.j_plan(100, last, nset, size, CAP)["kind"] == "one_pass"
        assert P.j_plan(100, last + 1, nset, size, CAP)["kind"] == \
            "two_pass"
    with pytest.raises(ValueError, match="nset"):
        P.j_plan(100, 50, 3, 8, CAP)
