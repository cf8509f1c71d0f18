"""The share of the traced window's vGHv passes that replayed a CUDA
graph: ``vghv.replay`` over all three routes (``spans/vghv_route.py``);
None where the program has no routes or ran no pass."""

from portbench.spans import vghv_route


def read(ctx):
    n = vghv_route.passes(ctx)
    if not n or ctx["kind"] != "step" or not sum(n.values()):
        return None
    return n["vghv.replay"] / sum(n.values())
