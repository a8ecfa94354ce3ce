"""Phase timers (SURVEY.md §5: the reference has wall-clock bracketing
only; here a structured, accumulating phase timer)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    """Accumulating named phase timer (the reference's time.time()
    bracketing, structured)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def report(self, log=print):
        total = sum(self.phases.values())
        for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            log(f"  {k:28s} {v:8.2f} s  ({100 * v / max(total, 1e-9):4.1f}%)")
        log(f"  {'total':28s} {total:8.2f} s")
