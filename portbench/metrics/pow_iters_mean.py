"""The eigensolver's mean products a unit over the traced window, as the
program returns them (``pow_iters`` of a step, the ``iters`` column of
``rho_test``)."""


def read(ctx):
    iters = ctx["iters"]
    return sum(iters) / len(iters) if iters else None
