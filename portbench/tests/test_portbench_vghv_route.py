"""``vghv_replay_share``'s reader on synthetic spans: the replays' share of
the window's passes, and nothing where the program has no routes (a tree
before the graph route) or ran no pass."""

from portbench.metrics import vghv_replay_share
from portbench.spans import vghv_route


def _ctx(spans, kind="step", missing=()):
    return {"kind": kind, "units": 4, "spans": spans, "missing": list(missing)}


def test_share_of_replays():
    spans = {"vghv.replay": [1.0] * 3, "vghv.eager": [2.0], "vghv": [3.0] * 4}
    assert vghv_replay_share.read(_ctx(spans)) == 0.75
    spans["vghv.capture"] = [5.0]
    assert vghv_replay_share.read(_ctx(spans)) == 0.6
    assert vghv_replay_share.read(_ctx({"vghv.eager": [2.0] * 4})) == 0.0


def test_nothing_without_routes_or_passes():
    missing = [f"{vghv_route.MODULE}.eager_pass", f"{vghv_route.MODULE}.VghvGraphs"]
    assert vghv_replay_share.read(_ctx({"vghv": [3.0]}, missing=missing)) is None
    assert vghv_replay_share.read(_ctx({"vghv": [3.0]})) is None
    assert vghv_replay_share.read(_ctx({"vghv.replay": [1.0]}, kind="audit")) is None
