"""Data, sequence and pipeline parallelism over ``torch.distributed``
(JAX ``parallel/``): the process group and the host reductions
(``distributed``), the rank grid (``mesh``), the time-sharded encoder
(``sequence``) and the GPipe encoder (``pipeline``). The model axis (JAX's
tensor parallelism) is ROADMAP.md item A12, model axis, and raises."""

from .distributed import (  # noqa: F401
    allsum_host_scalars,
    barrier,
    gather_tree_to_host,
    is_multiprocess,
    maybe_initialize_distributed,
)
from .mesh import batch_sharding, make_mesh, shard_batch  # noqa: F401
