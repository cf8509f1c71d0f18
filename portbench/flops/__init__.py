"""FLOPs of a cell's work from the counts frozen in its configuration
(``count.py`` recounts them).

A configuration's ``flops_per_sample`` holds, per sample at its shapes,
the FLOPs of the convolutions and matmuls of: one ``gradient``; one HVP
over a kept gradient graph (``hvp_kept``); one HVP under ``remat``,
forward and gradient recomputed (``hvp_remat``); one ``vghv`` pass; one
train-mode ``forward`` (the BatchNorm update).

A traffic mix's ``work`` says what one unit (a step, an audit batch)
requires: each term once, or ``"iters"`` times for the unit's
eigensolver products.  The required work counts an HVP as ``hvp_kept``;
the executed work counts it as the configuration runs it
(``hvp_remat`` under ``remat``), so recomputation is executed work but
never required work.
"""

from __future__ import annotations

from typing import Iterable


def unit_flops(counts: dict, work: dict, iters: int, batch: int, executed: bool,
               remat: bool) -> float:
    total = 0.0
    for term, times in work.items():
        n = iters if times == "iters" else times
        if term == "hvp":
            term = "hvp_remat" if executed and remat else "hvp_kept"
        total += n * counts[term]
    return total * batch


def work_flops(counts: dict, work: dict, iters: Iterable[int], batch: int, executed: bool,
               remat: bool) -> float:
    """The FLOPs of units that took ``iters`` products each."""
    return sum(unit_flops(counts, work, i, batch, executed, remat) for i in iters)
