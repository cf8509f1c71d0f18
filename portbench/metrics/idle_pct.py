"""Share of the profiled units' synchronised wall time in which no
operation ran on the device, in %."""


def read(ctx):
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"]) if p else None
