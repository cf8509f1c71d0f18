"""Device launches (kernels, copies, fills) an audit batch of the
profiled batches: one host dispatch each."""


def read(ctx):
    p = ctx["profile"]
    return p["launches"] / p["units"] if p and ctx["kind"] == "audit" else None
