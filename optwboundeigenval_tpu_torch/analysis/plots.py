"""Figures where matplotlib is installed.

Every CSV and ``.npz`` of the analysis path is written whatever is
installed; only the PNGs need matplotlib, which the port does not require.
:func:`pyplot` gives ``matplotlib.pyplot`` on the Agg backend, or None
after one line on standard output that says the figures are skipped.
"""

from __future__ import annotations


def pyplot(what: str):
    """``matplotlib.pyplot`` (Agg), or None where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        print(f"{what}: figures skipped, matplotlib is not installed", flush=True)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
