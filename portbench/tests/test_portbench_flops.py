"""The FLOP counts frozen in each configuration file match a recount
(``flops/count.py``) within 0.1%."""

import json

import pytest

from portbench import harness
from portbench.flops.count import count


@pytest.mark.parametrize("name", ["cxr121", "dn40"])
def test_frozen_counts_match_a_recount(name):
    cfg = json.loads((harness.ROOT / "configs" / f"{name}.json").read_text())
    fresh = count(cfg)
    assert set(fresh) == set(cfg["flops_per_sample"])
    for term, n in cfg["flops_per_sample"].items():
        assert abs(fresh[term] - n) <= 1e-3 * n, (term, fresh[term], n)
