"""Multi-process runtime (JAX ``parallel/distributed.py``): the process
group, each rank's device, and the cross-process reductions of host values.

One process per card. Every process runs the same command and joins one
``torch.distributed`` process group; the trainer then all-reduces its
gradients over the group (``train/loop.py``) and sums its validation
counts with ``allsum_host_scalars``.

Configuration comes from the flags or the environment, as in JAX:
  CONFORMER_COORDINATOR    host:port of rank 0 (``--coordinator``)
  CONFORMER_NUM_PROCESSES  the number of processes (``--num_processes``)
  CONFORMER_PROCESS_ID     this process's rank (``--process_id``)
  CONFORMER_DISTRIBUTED=auto  torchrun's environment instead: RANK,
      WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK.
The backend follows the device: NCCL on CUDA, gloo on the CPU. A rank runs
on ``cuda:<local rank>``: LOCAL_RANK where torchrun sets it, else the rank
modulo the cards of its host. NCCL takes one rank per card; two ranks on
one card need gloo, chosen through ``backend=``.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=30)


def maybe_initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> bool:
    """Join the process group when a multi-process run is configured.

    Returns True if the group exists (now or from an earlier call), False
    for a plain one-process run, which changes nothing. ``device`` is the
    device the caller will run on; it picks the backend unless ``backend``
    names one."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("CONFORMER_COORDINATOR")
    env_n = os.environ.get("CONFORMER_NUM_PROCESSES")
    env_id = os.environ.get("CONFORMER_PROCESS_ID")
    if num_processes is None and env_n:
        num_processes = int(env_n)
    if process_id is None and env_id:
        process_id = int(env_id)
    auto = os.environ.get("CONFORMER_DISTRIBUTED", "").lower() in ("auto", "1")
    if coordinator is None and not auto:
        if num_processes is not None or process_id is not None:
            raise ValueError("--num_processes/--process_id need --coordinator "
                             "(or CONFORMER_DISTRIBUTED=auto)")
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    else:       # torchrun: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def local_rank() -> int:
    """LOCAL_RANK where torchrun sets it, else the rank modulo the cards
    of this host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(torch.cuda.device_count(), 1)


def rank_device(device: str | torch.device) -> torch.device:
    """``device``, with a CUDA device that names no index put on this
    rank's card (``cuda:<local rank>``) in a multi-process run."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return dev


def collective_device() -> torch.device:
    """Where host values go for a collective: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allsum_host_scalars(values: dict[str, float], group=None) -> dict[str, float]:
    """Sum a dict of host scalars over the processes of ``group`` (all of
    them by default), in float64 and in sorted key order, so that every
    process sees the global value. One process: the input, unchanged."""
    if not is_multiprocess():
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device=collective_device())
    dist.all_reduce(t, group=group)
    return {k: float(v) for k, v in zip(keys, t.cpu().tolist())}


def gather_tree_to_host(tree, mesh=None):
    """A tree of tensors as the same tree of numpy arrays on every process
    (leaves that are not tensors, such as a step count, pass unchanged).

    Under a pipeline ``mesh``, a leaf of the encoder's stacked layers
    (``mesh.is_stage_leaf``) holds this stage's slice: the whole [L, ...]
    leaf is gathered from every stage (``pipeline.gather_stacked_layers``,
    a collective of the pipe group, which every process of it must call).
    Under a "model" axis a leaf that ``mesh.model_axis`` splits is gathered
    from the model group (``mesh.gather_leaf``) the same way. Other leaves
    are replicated and are copied as they are."""
    from .mesh import gather_leaf, is_stage_leaf, map_tensors
    from .pipeline import gather_stacked_layers

    piped = mesh is not None and mesh.size("pipe") > 1

    def host(path, t):
        t = t.detach()
        if piped and is_stage_leaf(path):
            t = gather_stacked_layers(t, mesh)
        if mesh is not None:
            t = gather_leaf(path, t, mesh)
        return t.cpu().numpy()

    return map_tensors(tree, host)


def barrier() -> None:
    """A sync point of every process; nothing in a one-process run."""
    if is_multiprocess():
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
