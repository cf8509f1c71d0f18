"""Mean ms a step of the vGHv pass (``ops/spectral.penalty_and_grad``:
the penalty's gate and ``v^T (grad H) v``), between CUDA events."""


def read(ctx):
    ms = ctx["spans"].get("vghv")
    return sum(ms) / len(ms) if ms else None
