"""ops/spectral.py: the vGHv pass's route, one call a pass: op by op
(``eager_pass``), a CUDA graph captured and run once (``VghvGraphs.capture``)
or replayed (``VghvGraphs.replay``).  None of the three runs under a
capture.

``passes`` gives each route's passes in the spans of a run, or None where
the program has no such routes to wrap."""

MODULE = "optwboundeigenval_tpu_torch.ops.spectral"
TARGETS = [(MODULE, "eager_pass", "vghv.eager"),
           (MODULE, "VghvGraphs.capture", "vghv.capture"),
           (MODULE, "VghvGraphs.replay", "vghv.replay")]


def passes(ctx):
    """``{route span: passes}`` in the traced window (``ctx["spans"]``)."""
    if any(m.startswith(MODULE + ".") for m in ctx["missing"]):
        return None
    return {name: len(ctx["spans"].get(name, ())) for _, _, name in TARGETS}
