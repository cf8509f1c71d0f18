"""Mean ms of one HVP call (``ops/curvature.hvp``, a product under
``remat``), between CUDA events around the call."""


def read(ctx):
    ms = ctx["spans"].get("hvp")
    return sum(ms) / len(ms) if ms else None
