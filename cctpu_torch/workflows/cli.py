"""`python -m cctpu_torch.workflows.cli <workflow> ...` — the dispatcher
over the workflow CLIs. ``energy``, ``opt`` and ``opt-freq`` are ported so
far; the other names of cctpu's dispatcher are listed and say that they are
not ported yet."""

from __future__ import annotations

import sys

_WORKFLOWS = {
    "energy": ("cctpu_torch.workflows.calculate_energy",
               "single-point energy"),
    "opt": ("cctpu_torch.workflows.optimize_geometry", "geometry opt + freq"),
    "opt-freq": ("cctpu_torch.workflows.opt_freq", "production opt+freq+IR"),
}
# cctpu's other workflows, in ROADMAP.md queue 1 order
_NOT_PORTED = ("ir", "uv", "solvent", "interaction",
               "reaction", "bde", "nmr", "casscf", "ms-pred")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m cctpu_torch.workflows.cli <workflow> "
              "[options]\n\nworkflows:")
        for k, (_, desc) in _WORKFLOWS.items():
            print(f"  {k:12s} {desc}")
        print(f"  not ported yet: {', '.join(_NOT_PORTED)}")
        return 0
    name = argv[0]
    if name in _NOT_PORTED:
        print(f"workflow {name!r} is not ported to cctpu_torch yet "
              "(see ROADMAP.md queue 1)")
        return 1
    if name not in _WORKFLOWS:
        print(f"unknown workflow {name!r}; try: {', '.join(_WORKFLOWS)}")
        return 1
    import importlib
    mod = importlib.import_module(_WORKFLOWS[name][0])
    rc = mod.main(argv[1:])
    from cctpu_torch.workflows.common import report_phases
    report_phases()
    # workflow mains return domain values (energies) for library callers;
    # only a bool/int is a process return code
    return rc if isinstance(rc, (bool, int)) else 0


if __name__ == "__main__":
    sys.exit(main())
