"""Stage timers, the program's spans and host-synchronisation counter, and
a profiler context (counterpart of ``optwboundeigenval_tpu/utils/timing.py``).

Stage timers.  The reference prints stage times as "Time elapsed: Hh Mm
Ss" lines (``timeHMS``, opt.py:230-235; per-epoch stage timers
opt.py:745-757); the trainer appends ``Timers.report`` to its verbose
log.  On the CPU a stage is the host clock around it.  On a CUDA device
it is a pair of CUDA events recorded on the current stream at the
stage's start and end: the device's time from the first work queued in
the stage to the end of the last, which a host clock without a
synchronise cannot see (it times the enqueue).  The pairs are resolved
when :attr:`Timers.totals` is read, which the trainer does once an epoch,
after the epoch has read its results from the device.

Spans.  A step and an audit batch open spans at their layer boundaries
(``train/trainer.py``, ``ops/eigen.py``, ``ops/spectral.py``): ``step`` and
``audit.batch`` open a unit, and every span inside one carries its unit's
number.  Recording is off unless a block runs under :func:`record`; off,
:func:`span` and :func:`unit` return one shared no-op context and the sync
functions do the transfer alone: no record, no clock read, no
``record_function``, no CUDA event, nothing on the device.  On, each span
is a :class:`Span` in host memory (name, start and end, the span open
when it opened, its unit), handed out by the :class:`Recording` when the
block ends.  Start and end are ``time.time_ns()``, the Unix clock in ns to
which ``torch.profiler`` converts its host and device events' times, so a
span and a device event compare directly.  ``record(annotate=True)``
also opens a ``torch.profiler.record_function`` of each span's name, so a
profiler trace shows them; :func:`trace` records so.

Host synchronisations.  Every read of a device value on the host and
every blocking host-to-device copy on the step's and the audit's paths
goes through :func:`read`, :func:`to_host` or :func:`to_device`, one call
a transfer, under a site name (``batch.h2d``, ``eigen.stop``,
``eigen.h2d``, ``spectral.gate``, ``audit.row``, ``step.fetch``,
``mesh.agree``, ``mesh.weight``, ``norm.count``).  Recorded, each is a
span with ``sync=True`` and adds one to :attr:`Recording.syncs` under its
site.  They are counted on every device, so a CPU run counts what the
card would synchronise.

Routes.  Where a layer can take one of several routes, a span of the
route's name opened by :func:`counted` adds one to
:attr:`Recording.counts` under that name: the vGHv pass's ``vghv.eager``,
``vghv.capture`` (a CUDA graph captured, then run once) and
``vghv.replay`` (``ops/spectral.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch


def time_hms(t: float, head: str = "") -> str:
    """timeHMS format (opt.py:230-235)."""
    hrs = int(t // 3600)
    t -= hrs * 3600
    mins = int(t // 60)
    secs = t - mins * 60
    return f"{head}Time elapsed: {hrs:2d} hrs, {mins:2d} min, {secs:4.2f} sec"


class Timers:
    """Stage totals in seconds: the host clock on the CPU, CUDA event
    pairs on a CUDA ``device``."""

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._totals: Dict[str, float] = {}
        self._pending: List[tuple] = []  # (name, start event, end event)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._pending.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] = self._totals.get(name, 0.0) + time.perf_counter() - t0

    @property
    def totals(self) -> Dict[str, float]:
        """Each stage's total, its pending event pairs resolved (a wait
        for the last one's end)."""
        for name, start, end in self._pending:
            end.synchronize()
            self._totals[name] = self._totals.get(name, 0.0) + start.elapsed_time(end) / 1e3
        self._pending.clear()
        return self._totals

    def report(self, names=None) -> str:
        totals = self.totals
        names = names or sorted(totals)
        return "\n".join(time_hms(totals.get(n, 0.0), f"{n} ") for n in names)


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` None while open), ``parent`` (the index in
    ``Recording.spans`` of the span open when it opened, or None),
    ``unit`` (the number of the unit it belongs to, or None outside one)
    and ``sync`` (a host synchronisation)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "unit", "sync")

    def __init__(self, name, start_ns, parent, unit, sync):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.unit, self.sync = parent, unit, sync


class Recording:
    """What one :func:`record` block recorded: ``spans`` in the order they
    opened, ``syncs`` ``{site: host synchronisations}``, ``counts``
    ``{route: times taken}`` and ``units``, the units opened."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans: List[Span] = []
        self.syncs: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.units = 0
        self._open: List[int] = []

    @contextlib.contextmanager
    def span(self, name: str, unit: bool = False, sync: bool = False, count: bool = False):
        parent = self._open[-1] if self._open else None
        if unit:
            number, self.units = self.units, self.units + 1
        else:
            number = self.spans[parent].unit if parent is not None else None
        if sync:
            self.syncs[name] = self.syncs.get(name, 0) + 1
        if count:
            self.counts[name] = self.counts.get(name, 0) + 1
        rec = Span(name, time.time_ns(), parent, number, sync)
        self._open.append(len(self.spans))
        self.spans.append(rec)
        try:
            with torch.profiler.record_function(name) if self.annotate else _OFF:
                yield
        finally:
            rec.end_ns = time.time_ns()
            self._open.pop()


_OFF = contextlib.nullcontext()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("timing_recording", default=None)


@contextlib.contextmanager
def record(annotate: bool = False):
    """Record the program's spans and host synchronisations over the
    block; yields the :class:`Recording`.  Within a recorded block an
    inner ``record`` takes the spans until it ends."""
    rec = Recording(annotate)
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def span(name: str):
    """A span of the layer ``name`` over a ``with`` block."""
    rec = _ACTIVE.get()
    return _OFF if rec is None else rec.span(name)


def unit(name: str):
    """A span that opens a new unit (a step, an audit batch)."""
    rec = _ACTIVE.get()
    return _OFF if rec is None else rec.span(name, unit=True)


def counted(name: str):
    """A span of the route ``name`` that counts one in ``Recording.counts``."""
    rec = _ACTIVE.get()
    return _OFF if rec is None else rec.span(name, count=True)


def read(site: str, t: torch.Tensor) -> Any:
    """``t.tolist()``: a host synchronisation at ``site``."""
    rec = _ACTIVE.get()
    if rec is None:
        return t.tolist()
    with rec.span(site, sync=True):
        return t.tolist()


def to_host(site: str, t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: a host synchronisation at ``site``."""
    rec = _ACTIVE.get()
    if rec is None:
        return t.cpu()
    with rec.span(site, sync=True):
        return t.cpu()


def to_device(site: str, x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)`` of host data: a blocking copy,
    a host synchronisation at ``site``."""
    rec = _ACTIVE.get()
    if rec is None:
        return torch.as_tensor(x, dtype=dtype, device=device)
    with rec.span(site, sync=True):
        return torch.as_tensor(x, dtype=dtype, device=device)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, path: Optional[str] = None):
    """``torch.profiler`` over the block, with the program's spans recorded
    and annotated.  The Chrome trace goes to ``path`` when given (an
    existing file is replaced; raises if none was written), else to
    ``log_dir`` (default ``<tempdir>/torch_trace``) as
    ``<worker>.<time>.pt.trace.json``; yields where.  CUDA activity is
    traced where the card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if path is None:
        log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch_trace")
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)), \
                record(annotate=True):
            yield log_dir
        return
    with torch.profiler.profile(activities=activities) as prof:
        with record(annotate=True):
            yield path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    if not os.path.isfile(path):  # the exporter logs a failure and returns
        raise RuntimeError(f"torch.profiler wrote no trace to {path}")
