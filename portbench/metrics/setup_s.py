"""Set-up seconds: from the process's start to the window's (imports,
the CUDA context, the trainer, weights and data, the followed units)."""


def read(ctx):
    return ctx["setup_s"]
