"""Data-parallel training over ``torch.distributed`` (``mesh.py``)."""

from optwboundeigenval_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
