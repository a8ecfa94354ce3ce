"""The launch plans of the DF kernels: ``wk_plan`` for the DF-W/K device
code (``csrc/df_wk.cuh``), ``j_plan`` for the DF-J kernels
(``csrc/df_j.cu``; see ``j_plan``'s docstring), ``k_dm_plan`` for the
exchange of general densities (``csrc/df_k_dm.cu``; see its docstring).

``wk_plan`` is the one place where a W/K plan is chosen: a pure function
of the shape, the element size, the shared-memory cap and whether the
Coulomb pass is fused in. The wrappers (``ops/df_jk.py``, ``ops/df_k.py``)
pass its integers to the C entry, which recomputes the shared-memory
bytes from them and refuses a plan that is inconsistent or over the cap
(``cudaErrorInvalidValue``).

Two kinds of plan:

``mma`` (f64 only): ``wk_mma`` of ``df_wk.cuh``. B[p] streams through a
    ring of ``stages`` column tiles of ``kt`` columns (asynchronous
    copies: tensor copies, ``tma``, where nao is even, else cp.async; with
    J each stage also holds the same tile of D), which shares W_p^T's
    shared memory where it would else be too short (``alias``); the warps
    of a block form a ``wm`` x ``wn`` grid, each warp holding up to
    ``mtm`` x ``ntm`` 16x8 accumulators of W_p^T [nao, nocc] in registers
    over the whole k range (in ``npanel`` row panels of ``mt_panel`` 16-row
    tiles when one pass cannot hold them); W_p^T lives in shared memory
    once per aux row; J accumulates in a per-block partial in shared
    memory (``j_in`` ``smem``), or, where that does not fit, the kernel
    only stores jp and a second pass over B adds jp[p] B[p] (``pass``); K
    accumulates on 16x16 super-tiles of the upper triangle, in registers
    for the block's whole aux range where they fit (variant ``small``),
    else in a per-block partial in device memory (variant ``large``).
``fma``: ``wk_partial`` of ``df_wk.cuh`` (FMA loops on 4x4 register
    micro-tiles): every f32 call, and the f64 shapes whose W_p does not
    fit in shared memory beside the tiles.
"""

from __future__ import annotations

import functools
import itertools

THREADS = 512
WARPS = THREADS // 32
SMEM_CAP_H100 = 232448           # bytes a block may opt in to on sm_90
HEADER_BYTES = 1024              # head of wk_mma's shared memory (kHeader)
TMA_KT = (8, 16)                 # tile widths the tensor copies' swizzles fit

# the instantiations of wk_mma (the template arguments in df_wk.cuh:
# threads, MTM x NTM 16x8 accumulator tiles a warp, KREG 16x16 super-tiles
# of K a warp keeps in registers); k_budget is the K accumulator doubles a
# thread of the variant holds (KREG super-tiles x 8)
VARIANTS = {
    "small": {"id": 0, "threads": 512, "mtm": 2, "ntm": 2, "kreg": 2,
              "k_budget": 16},
    "large": {"id": 1, "threads": 256, "mtm": 5, "ntm": 5, "kreg": 0,
              "k_budget": 0},
}
# (kt, stages) of the B-tile ring, best first: tiles of 8 columns or more
# (a barrier per tile), then most columns in flight ((stages - 1) * kt),
# then the wider tile
STAGING = sorted(((kt, st) for kt in (4, 8, 16, 32) for st in (2, 3, 4)),
                 key=lambda c: (c[0] < 8, -(c[1] - 1) * c[0], -c[0]))
# a ring that holds fewer bytes than this beside W_p^T does not cover
# device-memory latency: where W_p^T is computed in one panel, the ring then
# shares W_p^T's shared memory (W_p^T is only alive between a row's last
# tile and the next row's first), at the price of an empty ring at the
# start of every aux row
RING_BYTES_MIN = 96 * 1024
# the FMA kernel's (kt, W_p in shared memory) plans, best first; kt is cut
# to nao
FMA_PLANS = ((None, 1), (None, 0), (32, 1), (16, 1), (8, 1), (16, 0),
             (8, 0), (1, 0))
FMA_TILE = 4                     # its register micro-tile edge (kR)

# the order of the plan integers in the C entries
PLAN_INTS = ("kind", "variant", "kt", "stages", "wm", "mt_panel",
             "w_in_smem", "j_in_smem", "alias", "tma", "smem_bytes")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def blocks(naux: int, sms: int) -> tuple:
    """(nblk, rows per block) of the kernels that give each block one
    contiguous range of aux rows: one range per SM at most."""
    rows = _cdiv(naux, min(naux, sms))
    return _cdiv(naux, rows), rows


def _fma_plan(nao, nocc, itemsize, smem_cap):
    ldw = _cdiv(nao, FMA_TILE) * FMA_TILE
    ldc = _cdiv(nocc, FMA_TILE) * FMA_TILE
    for kt, w_in_smem in FMA_PLANS:
        kt = nao if kt is None else min(kt, nao)
        smem = itemsize * (THREADS + ldw * (kt + 1) + kt * ldc
                           + (ldc * ldw if w_in_smem else 0))
        if smem <= smem_cap:
            return {"kind": "fma", "variant": None, "threads": THREADS,
                    "kt": kt, "stages": 1,
                    "wm": 0, "wn": 0, "mt_panel": 0, "npanel": 1,
                    "alias": 0, "tma": 0,
                    "w_in": "smem" if w_in_smem else "slab",
                    "k_in": "device", "k_regs_per_thread": 0,
                    "smem_bytes": smem,
                    "kw_elems": nao * nao,
                    "ws_elems": 0 if w_in_smem else ldc * ldw, "cp_elems": 0}
    return None


def _warp_grid(mt, nt, var):
    """(wm, mt_panel, npanel) with the fewest mma per warp and k-step."""
    warps = var["threads"] // 32
    best = None
    wn = 1
    while wn <= warps:
        if _cdiv(nt, wn) <= var["ntm"]:
            wm = warps // wn
            npanel = _cdiv(mt, wm * var["mtm"])
            mt_panel = _cdiv(mt, npanel)
            per_warp = (_cdiv(mt_panel, wm), _cdiv(nt, wn))
            cost = (npanel * per_warp[0] * per_warp[1], npanel,
                    sum(per_warp))
            if best is None or cost < best[0]:
                best = (cost, wm, mt_panel, npanel)
        wn *= 2
    return None if best is None else best[1:]


def _mma_plan(nao, nocc, smem_cap, with_j):
    mt8, mt, nt = _cdiv(nao, 8), _cdiv(nao, 16), _cdiv(nocc, 8)
    nc8 = nt * 8
    ldw = nc8 + 4            # stride of W_p^T rows: 4 mod 8, see df_wk.cuh
    ntri = mt * (mt + 1) // 2
    small = VARIANTS["small"]
    name = "small" \
        if ntri <= small["threads"] // 32 * small["kreg"] else "large"
    var = VARIANTS[name]
    warps = var["threads"] // 32
    grid = _warp_grid(mt, nt, var)
    if grid is None:
        return None
    wm, mt_panel, npanel = grid
    wt = 8 * mt8 * 8 * ldw
    # tensor copies (TMA) need rows of B at multiples of 16 bytes, boxes of
    # at most 256 rows (a tile is one box or two) and tiles of TMA_KT
    # columns, no wider than B; where no such ring fits, cp.async and any
    # tile width
    can_tma = nao % 2 == 0 and nao >= TMA_KT[-1] and mt_panel * 16 <= 512
    for tma in ((True, False) if can_tma else (False,)):
        for j_in_smem in ((True, False) if with_j else (False,)):
            j_bytes = 8 * nao * nao if j_in_smem else 0
            found = {}
            for alias in ((False, True) if npanel == 1 else (False,)):
                for kt, stages in STAGING:
                    if kt > 4 and kt >= 2 * nao:
                        continue          # a tile wider than twice B[p]
                    if tma and kt not in TMA_KT:
                        continue
                    ring = 8 * stages * kt * (
                        (2 if with_j else 1) * mt_panel * 16 + nc8)
                    smem = HEADER_BYTES + j_bytes \
                        + (max(wt, ring) if alias else wt + ring)
                    if smem <= smem_cap:
                        found[alias] = (kt, stages, ring, smem)
                        break
            if not found:
                continue
            alias = False not in found or (
                True in found and found[False][2] < RING_BYTES_MIN
                and found[True][2] > found[False][2])
            kt, stages, _, smem = found[alias]
            return {"kind": "mma", "variant": name,
                    "threads": var["threads"], "kt": kt, "stages": stages,
                    "wm": wm, "wn": warps // wm, "mt_panel": mt_panel,
                    "npanel": npanel, "alias": int(alias), "tma": int(tma),
                    "w_in": "smem",
                    "j_in": ("smem" if j_in_smem else "pass")
                    if with_j else None,
                    "k_in": "registers" if var["kreg"] else "device",
                    "k_regs_per_thread":
                        8 * _cdiv(ntri, warps) if var["kreg"] else 0,
                    "smem_bytes": smem, "kw_elems": ntri * 256,
                    "ws_elems": 0,
                    "cp_elems": _cdiv(nao, kt) * kt * nc8 if tma else 0,
                    "jw_elems": (nao * nao if j_in_smem else -1)
                    if with_j else 0}
    return None


def wk_plan(nao: int, nocc: int, itemsize: int, smem_cap: int,
            with_j: bool) -> dict:
    """The plan of one ``df_jk_fused`` (``with_j``) or ``df_k_fast`` call
    for B [naux, nao, nao] and Cocc [nao, nocc] of ``itemsize`` bytes an
    element, on a card whose blocks may use ``smem_cap`` bytes of shared
    memory. Raises ValueError where no plan fits."""
    if nao < 1 or nocc < 1 or itemsize not in (4, 8):
        raise ValueError(f"wk_plan: nao {nao}, nocc {nocc}, itemsize "
                         f"{itemsize}")
    return dict(_wk_plan(nao, nocc, itemsize, smem_cap, bool(with_j)))


@functools.lru_cache(maxsize=256)
def _wk_plan(nao, nocc, itemsize, smem_cap, with_j):
    plan = _mma_plan(nao, nocc, smem_cap, with_j) if itemsize == 8 else None
    if plan is None:
        plan = _fma_plan(nao, nocc, itemsize, smem_cap)
        if plan is None:
            raise ValueError(f"wk_plan: no plan for nao {nao}, nocc {nocc} "
                             f"fits {smem_cap} bytes of shared memory")
        plan["j_in"] = "device" if with_j else None
        plan["jw_elems"] = nao * nao if with_j else 0
    return plan


def plan_ints(plan: dict) -> tuple:
    """The plan as the integers the C entries take, in PLAN_INTS order."""
    mma = plan["kind"] == "mma"
    vals = {"kind": int(mma),
            "variant": VARIANTS[plan["variant"]]["id"] if mma else 0,
            "kt": plan["kt"], "stages": plan["stages"], "wm": plan["wm"],
            "mt_panel": plan["mt_panel"],
            "w_in_smem": int(plan["w_in"] == "smem"),
            "j_in_smem": int(plan["j_in"] == "smem"),
            "alias": plan["alias"], "tma": plan["tma"],
            "smem_bytes": plan["smem_bytes"]}
    return tuple(vals[k] for k in PLAN_INTS)


def workspaces(plan: dict, nblk: int, naux: int, like):
    """(Jw, Kw, Ws) as tensors like ``like`` (B): the Coulomb workspace
    (``jw_elems`` a block: the per-block partial J; -1: jp [naux] for the
    second pass; 0: None, no J), the per-block partial K (``kw_elems`` a
    block: the tile-ordered upper triangle for an ``mma`` plan) and the
    scratch (the FMA kernel's W_p slab, ``ws_elems`` a block; a tensor-copy
    plan's packed C, ``cp_elems``; None where neither is needed)."""
    import torch

    def empty(*shape):
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    jw = plan["jw_elems"]
    return (None if jw == 0 else empty(naux) if jw < 0 else empty(nblk, jw),
            empty(nblk, plan["kw_elems"]),
            empty(nblk, plan["ws_elems"]) if plan["ws_elems"]
            else empty(plan["cp_elems"]) if plan["cp_elems"] else None)


def ptr(t) -> int:
    """The device pointer of a workspace that may be absent."""
    return 0 if t is None else t.data_ptr()


# df_j.cu's launch constants: the one-pass kernel's block (dfc::kThreads);
# the two-pass kernels' block, the bytes of B a jp_pass thread reads from
# each aux row (kJpBytes: 8 doubles or 16 floats), the aux rows of one
# jp_pass block, the most row groups the J sweep splits naux into, and the
# J sweep's blocks per SM below which it splits (at C16H34 one group is 167
# blocks of 256 threads, too few warps an SM to keep B's loads in flight)
J_ONE_PASS_THREADS = 512
J_THREADS = 256
J_JP_BYTES = 64
J_GROUP_ROWS = 128
J_SWEEP_MAX_GROUPS = 8
J_SWEEP_FILL = 2
SMS_H100 = 132
# the order of the plan integers in df_j.cu's C entries
J_PLAN_INTS = ("kind", "nblk", "rows", "threads", "nchunk",
               "sweep_groups", "sweep_rows", "vec")


def j_plan(naux: int, nao: int, nset: int, itemsize: int, smem_cap: int,
           sms: int = SMS_H100, aligned: bool = True) -> dict:
    """The plan of one ``df_j_fast`` call for B [naux, nao, nao] and
    ``nset`` densities of ``itemsize`` bytes an element, on a card of
    ``sms`` SMs whose blocks may use ``smem_cap`` bytes of shared memory;
    ``aligned``: B and D start at multiples of 16 bytes.

    ``one_pass`` where the partial J of all densities fits in shared memory
    beside the block sum (itemsize * nset * (512 + nao^2) <= smem_cap):
    ``j_partial``, ``nblk`` blocks of ``rows`` contiguous aux rows each
    (one range per SM at most), then the block partials summed in block
    order; workspace: the partials, [nblk, nset, nao, nao].
    ``two_pass`` elsewhere: ``jp_pass`` on ``nchunk`` column chunks x
    ``nblk`` groups of ``rows`` aux rows (jp partials [nchunk, nset,
    naux], summed in chunk order into jp [nset, naux]), then ``j_sweep``
    over ``sweep_groups`` groups of ``sweep_rows`` aux rows (their partial J,
    [sweep_groups, nset, nao, nao], summed in group order) where one
    group would have fewer than J_SWEEP_FILL blocks an SM. ``vec``
    elements a load: 16 bytes where every row of B starts 16-byte aligned
    (nao even), else one."""
    if naux < 1 or nao < 1 or nset not in (1, 2) or itemsize not in (4, 8) \
            or sms < 1:
        raise ValueError(f"j_plan: naux {naux}, nao {nao}, nset {nset}, "
                         f"itemsize {itemsize}, sms {sms}")
    n2 = nao * nao
    if itemsize * nset * (J_ONE_PASS_THREADS + n2) <= smem_cap:
        nblk, rows = blocks(naux, sms)
        return {"kind": "one_pass", "nblk": nblk,
                "rows": rows, "threads": J_ONE_PASS_THREADS, "nchunk": 0,
                "sweep_groups": 0, "sweep_rows": 0, "vec": 1,
                "sweep_blocks": 0,
                "smem_bytes": itemsize * nset * (J_ONE_PASS_THREADS + n2),
                "ws_elems": nblk * nset * n2}
    vec = 16 // itemsize if nao % 2 == 0 and aligned else 1
    chunk = J_THREADS * J_JP_BYTES // itemsize
    nchunk = _cdiv(n2, chunk)
    rows = min(naux, J_GROUP_ROWS)
    sweep_blocks = _cdiv(n2 // vec, J_THREADS)
    groups = min(J_SWEEP_MAX_GROUPS, naux,
                 _cdiv(J_SWEEP_FILL * sms, sweep_blocks))
    sweep_rows = _cdiv(naux, groups)
    groups = _cdiv(naux, sweep_rows)
    return {"kind": "two_pass", "nblk": _cdiv(naux, rows),
            "rows": rows, "threads": J_THREADS, "nchunk": nchunk,
            "sweep_groups": groups, "sweep_rows": sweep_rows, "vec": vec,
            "sweep_blocks": sweep_blocks, "smem_bytes": 0,
            "ws_elems": (nchunk + 1) * nset * naux
            + (groups * nset * n2 if groups > 1 else 0)}


def j_plan_ints(plan: dict) -> tuple:
    """The plan as the integers df_j.cu's C entries take, in J_PLAN_INTS
    order (kind: 1 for ``two_pass``)."""
    return tuple(int(plan[k] == "two_pass") if k == "kind" else plan[k]
                 for k in J_PLAN_INTS)


# df_k_dm.cu's launch constants: the columns of a tile (one mma deep: one
# 128-byte swizzled tensor-copy box), the head of the shared memory (the
# stages' mbarriers; 1024 bytes, the alignment of the swizzled tiles after
# it), the tiles a job (one ring stage, one barrier) stages and the ring
# depths, tried in this order
KDM_KT = 16
KDM_HEADER_BYTES = 1024
KDM_JTS = (2, 1)
KDM_STAGES = (4, 3, 2)
# the instantiations of kdm_mma (template arguments in df_k_dm.cu): the 8
# warps form a 2 x 4 grid (warp w takes column group w % 4, so each
# tensor-core sub-partition holds one, and row half w / 4); at most mtk
# 16-row tiles of K and mtw of a V chunk and nt 8-column tiles a warp holds
# in registers; d_res: D[s] in shared memory for the block's whole aux
# range (else its tiles stream through the ring); for nao up to
# 16 * mt_max
KDM_VARIANTS = {
    "a": {"id": 0, "mt_max": 8, "mtk": 4, "mtw": 4, "nt": 2, "d_res": 1},
    "b": {"id": 1, "mt_max": 14, "mtk": 7, "mtw": 4, "nt": 2, "d_res": 0},
    "c": {"id": 2, "mt_max": 24, "mtk": 12, "mtw": 4, "nt": 1, "d_res": 0},
}
# the order of the plan integers in df_k_dm.cu's C entry
KDM_PLAN_INTS = ("variant", "nj", "nh", "jt", "stages", "groups", "rows",
                 "tma", "smem_bytes")


def k_dm_smem_bytes(nao: int, nj: int, nh: int, jt: int, stages: int,
                    d_res: int) -> int:
    """Dynamic shared memory of a ``kdm_mma`` block (df_k_dm.cu recomputes
    the same sum): the header, the ring (a stage holds an A job's jt
    tiles, D[s]'s chunk rows (streamed D) and the panel's rows of B[p], or
    a B job's rows of B[p], rows of jt * KDM_KT + 2 doubles, the cp.async
    stride; 1024-byte multiples), V^T [8 nj, Mp + 2] and, resident, D[s]
    [Mp, Mp + 2]."""
    mt = _cdiv(nao, 16)
    mp, lh = 16 * mt, 16 * _cdiv(mt, nh)
    stage = _cdiv((jt * KDM_KT + 2) * max(8 * nj + (0 if d_res else lh), mp),
                  128) * 128
    return KDM_HEADER_BYTES + 8 * (stages * stage + 8 * nj * (mp + 2) + (
        mp * (mp + 2) if d_res else 0))


def k_dm_plan(naux: int, nao: int, sms: int = SMS_H100,
              smem_cap: int = SMEM_CAP_H100) -> dict:
    """The plan of one ``df_k_dm`` launch for B [naux, nao, nao] on a card
    of ``sms`` SMs whose blocks may use ``smem_cap`` bytes of shared
    memory. It does not take the number of densities: nothing that sets
    the order of a density's sum depends on the batch.

    A block owns the column panel J (``nj`` 8-column tiles) of K[s] for one
    density and one of ``groups`` contiguous ranges of ``rows`` aux rows,
    and keeps K[:, J] in registers over its whole range. Per aux row it
    forms V = D[s] B[p][J, :]^T in ``nh`` chunks of rows (held in registers
    over the l range, then in shared memory) and adds B[p] V. The first
    variant whose tiles hold nao is taken (KDM_VARIANTS), and its panel
    width first by the tensor cores' balance (a panel's n-tiles are split
    over the four sub-partitions: it costs ceil(n-tiles / 4) steps), then
    by the fewest panels (B[p] is read once per panel), then the
    narrowest; ``groups`` fills the card at one density (groups * panels
    >= sms); tensor copies (``tma``) where nao is even and its boxes fit
    (16 <= nao <= 256), else cp.async; two tiles a job (``jt``: one
    barrier per two tiles) where a ring of such jobs fits, else one; the
    deepest ring that fits. ``padded_share``: the share of the DMMA work
    issued on padding (16-row, 8-column and 16-deep tiles); ``sp_share``:
    the issued work over what the busiest sub-partition's steps could
    issue. Raises ValueError where no plan fits."""
    if naux < 1 or not 1 <= nao <= 16 * KDM_VARIANTS["c"]["mt_max"] \
            or sms < 1:
        raise ValueError(f"k_dm_plan: naux {naux}, nao {nao}, sms {sms}")
    return dict(_k_dm_plan(naux, nao, sms, smem_cap))


def _k_dm_variant_plan(naux, nao, sms, smem_cap, var):
    """The plan of one instantiation, or None where its tiles do not hold
    nao or nothing fits. A panel costs ceil(its n-tiles / 4) steps of the
    busiest sub-partition."""
    mt, n8 = _cdiv(nao, 16), _cdiv(nao, 8)
    if mt > var["mt_max"] or _cdiv(mt, 2) > var["mtk"]:
        return None
    nh = 1
    while _cdiv(_cdiv(mt, nh), 2) > var["mtw"]:
        nh += 1
    panels = []
    for nj in range(1, min(4 * var["nt"], n8) + 1):
        npanel = _cdiv(n8, nj)
        last = n8 - (npanel - 1) * nj
        cost = (npanel - 1) * _cdiv(nj, 4) + _cdiv(last, 4)
        panels.append((cost, npanel, nj))
    for (cost, npanel, nj), jt, stages in itertools.product(
            sorted(panels), KDM_JTS, KDM_STAGES):
        smem = k_dm_smem_bytes(nao, nj, nh, jt, stages, var["d_res"])
        if smem > smem_cap:
            continue
        rows = _cdiv(naux, min(naux, _cdiv(sms, npanel)))
        issued = 2 * mt * n8 * mt * 4096
        return {"variant": next(k for k, v in KDM_VARIANTS.items()
                                if v is var),
                "nj": nj, "npanel": npanel, "nh": nh, "jt": jt,
                "stages": stages, "groups": _cdiv(naux, rows), "rows": rows,
                "tma": int(nao % 2 == 0 and 16 <= nao <= 256),
                "d_res": var["d_res"], "smem_bytes": smem,
                "padded_share": 1.0 - 4.0 * nao ** 3 / issued,
                "sp_share": n8 / (4.0 * cost)}
    return None


@functools.lru_cache(maxsize=256)
def _k_dm_plan(naux, nao, sms, smem_cap):
    for var in KDM_VARIANTS.values():
        plan = _k_dm_variant_plan(naux, nao, sms, smem_cap, var)
        if plan is not None:
            return plan
    raise ValueError(f"k_dm_plan: no plan for nao {nao} fits {smem_cap} "
                     "bytes of shared memory")


def k_dm_plan_ints(plan: dict) -> tuple:
    """The plan as the integers df_k_dm.cu's C entry takes, in
    KDM_PLAN_INTS order."""
    return tuple(KDM_VARIANTS[plan["variant"]]["id"] if k == "variant"
                 else plan[k] for k in KDM_PLAN_INTS)
