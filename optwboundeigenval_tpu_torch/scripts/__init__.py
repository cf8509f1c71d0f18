"""Command-line tools of the port (counterparts of the repository's
``scripts/``), each run as ``python -m optwboundeigenval_tpu_torch.scripts.<name>``
and each taking ``--device`` (the card unless ``cpu`` is given)."""
