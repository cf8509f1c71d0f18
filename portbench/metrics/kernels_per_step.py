"""Device launches (kernels, copies, fills) a step of the profiled steps:
one host dispatch each."""


def read(ctx):
    p = ctx["profile"]
    return p["launches"] / p["units"] if p and ctx["kind"] == "step" else None
