"""Training samples through whole spectral-regularised steps, over the
window's synchronised wall time."""


def read(ctx):
    return ctx["samples"] / ctx["window_s"] if ctx["kind"] == "step" else None
