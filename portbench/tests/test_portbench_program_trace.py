"""The host-synchronisation readers on a synthetic ``ctx``, and
``program_trace.analyse`` on synthetic spans and device intervals with
known gaps."""

import pytest

from optwboundeigenval_tpu_torch.utils.timing import Span
from portbench import program_trace
from portbench.metrics import host_syncs_per_batch, host_syncs_per_step

TIMING = "optwboundeigenval_tpu_torch.utils.timing"


def _ctx(kind, units, spans, missing=()):
    return {"kind": kind, "units": units, "spans": spans, "missing": list(missing)}


def test_host_sync_readers():
    spans = {"host_sync.read": [0.1] * 8, "host_sync.to_device": [0.2] * 4, "hvp": [5.0] * 4}
    assert host_syncs_per_step.read(_ctx("step", 4, spans)) == 3.0
    assert host_syncs_per_batch.read(_ctx("audit", 3, spans)) == 4.0
    assert host_syncs_per_step.read(_ctx("audit", 4, spans)) is None
    assert host_syncs_per_batch.read(_ctx("step", 3, spans)) is None
    # a program without the sync functions (its parent): nothing to read
    missing = [f"{TIMING}.{a}" for a in ("read", "to_host", "to_device")]
    assert host_syncs_per_step.read(_ctx("step", 4, {}, missing)) is None
    assert host_syncs_per_step.read(_ctx("step", 4, {})) == 0.0


def _span(name, t0, t1, parent=None, unit=0, sync=False):
    s = Span(name, t0, parent, unit, sync)
    s.end_ns = t1
    return s


def test_analyse_known_gaps():
    """One unit over [0, 1000] ns: a step span, a pass [100, 600] and a
    sync span [600, 700] under it.  The device runs [0, 150], [300, 650]
    and [800, 1000]: gaps [150, 300] (midpoint in the pass), [650, 800]
    (opens inside the sync, midpoint 725 after it, in the step)."""
    spans = [_span("step", 0, 1000), _span("pass", 100, 600, parent=0),
             _span("gate", 600, 700, parent=0, sync=True)]
    device = [(0, 150), (300, 650), (800, 1000)]
    launches = [50, 120, 130, 650, 900]
    out = program_trace.analyse(spans, device, launches, 0, 1000)
    assert out["busy_s"] == pytest.approx(700e-9)
    assert out["idle_pct"] == pytest.approx(30.0)
    assert out["idle_by_span"] == pytest.approx({"pass": 150e-9, "step": 150e-9})
    assert out["sync_idle_s"] == pytest.approx({"gate": 150e-9})
    assert out["sync_idle_pct"] == pytest.approx(15.0)
    assert out["self_s"] == pytest.approx({"step": 400e-9, "pass": 500e-9, "gate": 100e-9})
    assert out["launches_by_span"] == {"step": 2, "pass": 2, "gate": 1}
    assert out["host_s"] == pytest.approx(1000e-9) and out["sync_s"] == pytest.approx(100e-9)
    assert out["device_launches"] == 3
    assert out["dispatch_us_per_launch"] == pytest.approx(900 / 1e3 / 3)


def test_analyse_window_edges_and_outside_spans():
    """Idle before the first device event and after the last are gaps too;
    a gap outside every span is labelled so, and no sync opens it."""
    spans = [_span("step", 150, 400)]
    out = program_trace.analyse(spans, [(200, 300), (250, 260)], [], 0, 500)
    assert out["idle_by_span"] == pytest.approx({"step": 200e-9, "outside spans": 200e-9})
    assert out["sync_idle_s"] == {} and out["sync_idle_pct"] == 0.0
    assert out["device_launches"] == 2
