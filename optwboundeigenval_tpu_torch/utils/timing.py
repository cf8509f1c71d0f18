"""Host wall-clock stage timers and a profiler context (counterpart of
``optwboundeigenval_tpu/utils/timing.py``).

The reference prints stage times as "Time elapsed: Hh Mm Ss" lines
(``timeHMS``, opt.py:230-235; per-epoch stage timers opt.py:745-757);
the trainer appends ``Timers.report`` to its verbose log.  A timer reads
the host clock around a stage: what the card still has queued at the
stage's end is not in it.  :func:`trace` is the JAX package's
``jax.profiler`` context on ``torch.profiler``: a Chrome trace of the CPU
and, on the card, CUDA activity.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``log_dir`` (default ``<tempdir>/torch_trace``) as
    ``<worker>.<time>.pt.trace.json`` when the block ends; yields
    ``log_dir``.  CUDA activity is traced where the card is present."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir
