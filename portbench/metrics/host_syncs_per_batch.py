"""Host synchronisations an audit batch over the traced window: the
program's calls of ``utils/timing`` ``read``, ``to_host`` and
``to_device`` (``spans/host_sync.py``) over the window's batches."""

from portbench.spans import host_sync


def read(ctx):
    n = host_sync.count(ctx)
    return n / ctx["units"] if n is not None and ctx["kind"] == "audit" and ctx["units"] else None
