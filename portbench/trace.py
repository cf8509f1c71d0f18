"""Spans around the program's layers and the device profile of a
``--trace 1`` run.

Spans: each file ``spans/<layer>.py`` lists ``TARGETS``, triples of a
module of the program, an attribute path in it and a span name.  In the
traced run only, :class:`Spans` replaces each attribute by a wrapper
that opens a ``record_function`` and records the host's clock and a pair
of CUDA events around the call, and puts the originals back when it
closes.  A target that no longer exists is listed in ``missing``, and
the metrics that read its span find nothing.

Profile: :func:`profile` runs a few units under ``torch.profiler``
(device activity only: the host's op events would double what the
profiler gathers on a step of 10^5 kernels) and sums the raw device
events by name, as ``chip_smoke.phase_profile`` does.  Busy time is the
union of the device events' intervals; the idle gaps between them are
labelled with the innermost span open on the host at the gap's middle.
"""

from __future__ import annotations

import glob
import importlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch


def _span_files() -> List[str]:
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spans")
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(here, "*.py")) if not p.endswith("__init__.py"))


class Spans:
    """Wrappers around every target of ``spans/``; use as a context."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.records: List[list] = []  # [name, host t0 ns, host t1 ns, event0, event1]
        self.missing: List[str] = []
        self._restore: List[Callable[[], None]] = []

    def __enter__(self):
        for layer in _span_files():
            targets = importlib.import_module(f"portbench.spans.{layer}").TARGETS
            for module_name, attr, name in targets:
                self._install(module_name, attr, name)
        return self

    def __exit__(self, *exc):
        for restore in reversed(self._restore):
            restore()
        self._restore.clear()

    def _install(self, module_name: str, attr: str, name: str) -> None:
        try:
            owner = importlib.import_module(module_name)
            *path, last = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            original = getattr(owner, last)
        except (ImportError, AttributeError):
            self.missing.append(f"{module_name}.{attr}")
            return
        owner_dict_has = last in vars(owner)

        def wrapped(*args, **kwargs):
            rec = [name, time.time_ns(), None, None, None]
            if self.cuda:
                rec[3] = torch.cuda.Event(enable_timing=True)
                rec[3].record()
            try:
                with torch.autograd.profiler.record_function(f"portbench.{name}"):
                    return original(*args, **kwargs)
            finally:
                if self.cuda:
                    rec[4] = torch.cuda.Event(enable_timing=True)
                    rec[4].record()
                rec[2] = time.time_ns()
                self.records.append(rec)

        setattr(owner, last, wrapped)

        def restore():
            if owner_dict_has:
                setattr(owner, last, original)
            else:
                delattr(owner, last)

        self._restore.append(restore)

    def clear(self) -> None:
        self.records.clear()

    def ms(self) -> Dict[str, List[float]]:
        """Each span name's durations in ms: between its CUDA events on the
        card (after a synchronise), else on the host's clock."""
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        for name, t0, t1, e0, e1 in self.records:
            ms = e0.elapsed_time(e1) if e0 is not None else (t1 - t0) / 1e6
            out.setdefault(name, []).append(ms)
        return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(spans: List[list], t: int) -> str:
    """The innermost span open on the host at ``t`` (ns)."""
    best: Optional[list] = None
    for rec in spans:
        if rec[1] <= t <= rec[2] and (best is None or rec[1] >= best[1]):
            best = rec
    return best[0] if best is not None else "outside spans"


def profile(run_units: Callable[[], None], spans: Spans) -> Optional[dict]:
    """``run_units()`` under the profiler: the synchronised wall seconds,
    the device's busy seconds, launches, ``kernels`` ``{name: [n,
    seconds]}`` and idle seconds by the span open on the host.  None where
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    spans.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0, t0 = time.time_ns(), time.perf_counter()
        run_units()
        torch.cuda.synchronize()
        wall, h1 = time.perf_counter() - t0, time.time_ns()
    kernels: Dict[str, list] = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += e.duration_ns() / 1e9
        start = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
        intervals.append((start, start + e.duration_ns()))
    if not intervals:
        return None
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged) / 1e9
    records = [r for r in spans.records if r[2] is not None]
    idle: Dict[str, float] = {}
    edges = [h0] + [x for s, e in merged for x in (s, e)] + [h1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            lab = _label(records, (s + e) // 2)
            idle[lab] = idle.get(lab, 0.0) + (e - s) / 1e9
    return {"wall_s": wall, "busy_s": busy, "launches": sum(n for n, _ in kernels.values()),
            "kernels": kernels, "idle_by_span": idle,
            "clock_offset_s": (merged[0][0] - h0) / 1e9}
