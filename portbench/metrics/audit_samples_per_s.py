"""Samples whose batch's dominant eigenvalue ``rho_test`` found, over the
window's synchronised wall time."""


def read(ctx):
    return ctx["samples"] / ctx["window_s"] if ctx["kind"] == "audit" else None
