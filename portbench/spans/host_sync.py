"""utils/timing.py: the program's host synchronisations, one call of
``read``, ``to_host`` or ``to_device`` a transfer (a read of a device
value on the host, or a blocking copy of host data to the device).

``count`` is the number of those calls in the spans of a run, or None
where the program has no such calls to wrap."""

MODULE = "optwboundeigenval_tpu_torch.utils.timing"
TARGETS = [(MODULE, attr, f"host_sync.{attr}") for attr in ("read", "to_host", "to_device")]


def count(ctx):
    """Host synchronisations in the traced window (``ctx["spans"]``)."""
    if any(m.startswith(MODULE + ".") for m in ctx["missing"]):
        return None
    return sum(len(ctx["spans"].get(name, ())) for _, _, name in TARGETS)
