"""A run with the timed path broken underneath, at a toy size on the CPU
(the look for a card skipped), comes out not correct; a sound run comes
out correct.  The faults: a step that returns its state unchanged, half
of the batch left out (the mean over the rest), an answer altered where
it is produced; each from the run's first unit on, and each from the
window's first unit on only (the units set-up drives, and the reference
follows from the start, sound)."""

import pytest
import torch

from conftest import toy
from portbench import harness
from optwboundeigenval_tpu_torch.ops import eigen
from optwboundeigenval_tpu_torch.train.trainer import SpectralTrainer

CELLS = ["dn40-step-b128", "dn40-audit-b128"]


def _run(workload):
    # float64: at a toy size the cells' float32 limits do not apply
    return harness.run(workload, 77, 0.2, False, device="cpu", dtype=torch.float64,
                       **toy(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"]


def _units_before_window(workload):
    traffic = harness.load("traffic", harness.workload(workload)["traffic"])
    return traffic["follow_steps"] + traffic.get("warmup_steps", 0)


def _broken(monkeypatch, owner, name, make, after):
    """``owner.name`` as ``make(original)`` from its call ``after + 1`` on
    (each of these is called once a unit)."""
    sound = getattr(owner, name)
    bad, calls = make(sound), [0]

    def either(*args, **kwargs):
        calls[0] += 1
        return (bad if calls[0] > after else sound)(*args, **kwargs)

    monkeypatch.setattr(owner, name, either)


def _state_unchanged(monkeypatch, workload, after):
    if "audit" in workload:  # the audit's state: the running statistics
        _broken(monkeypatch, SpectralTrainer, "_advance_stats",
                lambda sound: lambda self, params, model_state, batch, key=None: model_state,
                after)
    else:
        _broken(monkeypatch, SpectralTrainer, "_commit", lambda sound: lambda self, *s: None,
                after)


def _half_batch(monkeypatch, workload, after):
    def make(put):
        def half(self, batch):
            out = put(self, batch)
            n = len(out["x"]) // 2
            return {k: t[:n] for k, t in out.items()}
        return half

    _broken(monkeypatch, SpectralTrainer, "put_batch", make, after)


def _answer_altered(monkeypatch, workload, after):
    """A unit's ``rho`` off by a thousandth where the eigensolver produces
    it (a step also takes its penalty's gradient at the altered ``rho``'s
    sign, which is the same)."""
    def make(solve):
        def altered(*args, **kwargs):
            res = solve(*args, **kwargs)
            return res._replace(rho=res.rho * (1 + 1e-3))
        return altered

    _broken(monkeypatch, eigen, "estimate_dominant_eig", make, after)


FAULTS = (_state_unchanged, _half_batch, _answer_altered)


@pytest.mark.parametrize("workload, fault", [(w, f) for w in CELLS for f in FAULTS])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload, 0)
    ctx = _run(workload)
    assert not ctx["correct"], ctx["numbers"]


@pytest.mark.parametrize("workload, fault", [(w, f) for w in CELLS for f in FAULTS])
def test_fault_in_the_window_alone_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload, _units_before_window(workload))
    ctx = _run(workload)
    assert not ctx["correct"], ctx["numbers"]
