"""Phase timers (SURVEY.md §5: the reference has wall-clock bracketing
only; here a structured, accumulating phase timer)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulating named phase timer (the reference's time.time()
    bracketing, structured). Given a CUDA ``device``, each phase waits for
    the card at its start and its end, so a phase holds its device work."""

    def __init__(self, device=None):
        self.phases: Dict[str, float] = {}
        self.device = None if device is None else torch.device(device)

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.time()
        try:
            yield
        finally:
            self._sync()
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def report(self, log=print):
        total = sum(self.phases.values())
        for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            log(f"  {k:28s} {v:8.2f} s  ({100 * v / max(total, 1e-9):4.1f}%)")
        log(f"  {'total':28s} {total:8.2f} s")


def phase(timer: Optional[PhaseTimer], name: str):
    """``timer.phase(name)``, or nothing to time when ``timer`` is None."""
    return contextlib.nullcontext() if timer is None else timer.phase(name)
