"""Command line entry of the port:

    python -m optwboundeigenval_tpu_torch.main <config> [key=value ...]

``<config>`` names a module of ``optwboundeigenval_tpu_torch.configs``
(default ``usps_cnn_mu0_01_K0``, the reference main.py's); each trailing
``key=value`` is an override of its options, the value read as a Python
literal where it parses as one, e.g.::

    python -m optwboundeigenval_tpu_torch.main forest_best max_iter=5
    python -m optwboundeigenval_tpu_torch.main usps_cnn_mu0_01_K0 device=cpu

The run trains on the GPU and raises on a machine without one, unless
``device='cpu'`` is given.  It writes ``./logs`` and ``./models`` unless
``log_dir=``/``model_dir=`` say otherwise.
"""

from __future__ import annotations

import ast
import sys

from optwboundeigenval_tpu_torch.train.driver import main as run_config

PACKAGE = "optwboundeigenval_tpu_torch.configs."


def main(argv):
    name = argv[1] if len(argv) > 1 else "usps_cnn_mu0_01_K0"
    if not name.startswith(PACKAGE):
        name = PACKAGE + name.removeprefix("configs.")
    overrides = {}
    for arg in argv[2:]:
        key, _, val = arg.partition("=")
        try:
            overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            overrides[key] = val
    return run_config(name, **overrides)


if __name__ == "__main__":
    main(sys.argv)
