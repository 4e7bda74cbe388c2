"""Data, sequence, pipeline and tensor parallelism over
``torch.distributed`` (JAX ``parallel/``): the process group and the host
reductions (``distributed``), the rank grid and the parameter layout
(``mesh``), the time-sharded encoder (``sequence``), the GPipe encoder
(``pipeline``) and the model axis's collectives (``tensor``)."""

from .distributed import (  # noqa: F401
    allsum_host_scalars,
    barrier,
    gather_tree_to_host,
    is_multiprocess,
    maybe_initialize_distributed,
)
from .mesh import batch_sharding, make_mesh, shard_batch, shard_params  # noqa: F401
