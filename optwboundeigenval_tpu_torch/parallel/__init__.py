"""Data and tensor parallelism over ``torch.distributed`` (``mesh.py``,
``sharding.py``)."""

from optwboundeigenval_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from optwboundeigenval_tpu_torch.parallel.sharding import (  # noqa: F401
    gather_params,
    infer_param_specs,
    shard_params,
)
