"""Host wall-clock stage timers (counterpart of
``optwboundeigenval_tpu/utils/timing.py``, without its profiler hook).

The reference prints stage times as "Time elapsed: Hh Mm Ss" lines
(``timeHMS``, opt.py:230-235; per-epoch stage timers opt.py:745-757);
the trainer appends ``Timers.report`` to its verbose log.  A timer reads
the host clock around a stage: what the card still has queued at the
stage's end is not in it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


def time_hms(t: float, head: str = "") -> str:
    """timeHMS format (opt.py:230-235)."""
    hrs = int(t // 3600)
    t -= hrs * 3600
    mins = int(t // 60)
    secs = t - mins * 60
    return f"{head}Time elapsed: {hrs:2d} hrs, {mins:2d} min, {secs:4.2f} sec"


class Timers:
    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - start)

    def report(self, names=None) -> str:
        names = names or sorted(self.totals)
        return "\n".join(time_hms(self.totals.get(n, 0.0), f"{n} ") for n in names)
