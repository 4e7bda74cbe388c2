"""The rank grid (JAX ``parallel/mesh.py``, data axis; the model axis is
ROADMAP.md item A12, model axis, and raises).

JAX lays devices out as ``np.asarray(devices).reshape(...)`` over named
axes. The port lays processes out the same way: one process per device,
ranks row-major over the axes, so that rank r has device r's coordinates.
Each rank keeps one process group per axis: the ranks that share every
other coordinate with it. A batch is split over "data": the rows of the
global batch this rank holds are ``batch_sharding``'s slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch.distributed as dist

from .distributed import process_count, process_index

MODEL_AXIS_TODO = ("tensor parallelism (train.mesh_model > 1) is not ported yet: ROADMAP.md "
                   "item A12, model axis")


@dataclass
class Mesh:
    """Named axes (``shape``, in order), this rank's coordinates on them,
    and its process group along each (None where the axis has one rank,
    or in a one-process run)."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, object] = field(default_factory=dict)
    # pipeline links (pipeline.make_pipeline_mesh): {(stage, stage + 1):
    # the group of those two ranks} for the links this rank is on
    links: dict[tuple[int, int], object] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates, changed by
        ``coords``."""
        return _rank(self.shape, {**self.coords, **coords})


def grid(shape: dict[str, int]) -> Mesh:
    """A mesh of ``shape`` over every process (a size of -1 takes what the
    others leave). The processes must fill it exactly. Every process must
    call this, in the same order as the others (it creates the groups)."""
    n = process_count()
    fixed = 1
    for k in shape.values():
        fixed *= k if k != -1 else 1
    fill = -1 in shape.values()
    if (n % fixed if fill else n != fixed) or n < fixed:
        raise ValueError(f"mesh {shape} needs {'a multiple of ' if fill else ''}{fixed} "
                         f"processes, have {n}")
    shape = {axis: n // fixed if k == -1 else k for axis, k in shape.items()}
    rank = process_index()
    coords, r = {}, rank
    for axis in reversed(shape):
        coords[axis] = r % shape[axis]
        r //= shape[axis]
    mesh = Mesh(shape=shape, coords=dict(reversed(coords.items())))
    if n == 1:
        return mesh
    axes = list(shape)
    for axis in axes:
        # the groups along ``axis``: one for each setting of the other axes
        others = [a for a in axes if a != axis]
        settings = [{}]
        for a in others:
            settings = [{**s, a: i} for s in settings for i in range(shape[a])]
        for s in settings:
            ranks = [_rank(shape, {**s, axis: i}) for i in range(shape[axis])]
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis] = g if len(ranks) > 1 else None
    return mesh


def _rank(shape: dict[str, int], coords: dict[str, int]) -> int:
    r = 0
    for axis, n in shape.items():
        r = r * n + coords[axis]
    return r


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ("data",) mesh over every process; ``model`` > 1 raises."""
    if model > 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    return grid({"data": data})


def batch_sharding(mesh: Mesh, rows: int) -> slice:
    """The rows of a global batch of ``rows`` that this rank holds: its
    data coordinate's contiguous share."""
    d = mesh.size("data")
    if rows % d:
        raise ValueError(f"a global batch of {rows} rows does not split over data={d}")
    per = rows // d
    return slice(mesh.coord("data") * per, (mesh.coord("data") + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch: every leaf with a leading batch
    axis is cut to ``batch_sharding``; other leaves pass through."""
    rows = {len(v) for v in batch.values() if getattr(v, "ndim", 0) >= 1}
    if len(rows) != 1:
        raise ValueError(f"batch leaves disagree on the number of rows: {sorted(rows)}")
    sl = batch_sharding(mesh, rows.pop())
    return {k: v[sl] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


def is_stage_leaf(path: str) -> bool:
    """Whether a dotted leaf path (of params, of Adam moments keyed by
    params' paths, or of a train state holding both) lies in the encoder's
    stacked [L, ...] layers, of which a pipeline stage holds its slice."""
    return "encoder.layers." in path


def is_owner(mesh: Mesh) -> bool:
    """Whether this rank's copy of the ``owned_leaves`` that every rank of
    its seq or pipe group computes alike is the one that counts: seq rank
    0 on the last pipeline stage."""
    return mesh.coord("seq") == 0 and mesh.coord("pipe") == mesh.size("pipe") - 1


def owned_leaves(mesh: Mesh, paths) -> tuple[list[str], list[str]]:
    """How the gradient leaves of the transducer's params (dotted
    ``paths``) stand on this rank after a backward on ``mesh``, as
    (once, staged):
      - ``once``: every rank of a seq or pipe group computes the same
        gradient, which counts from the ``is_owner`` rank only: the
        leaves after the encoder (the sequence and pipeline encoders
        return the whole output on every rank of the group) and, under a
        pipeline, the final LayerNorm, which every stage applies to the
        same broadcast output;
      - ``staged``: a pipeline stage's own layers, summed over its data
        group only.
    Every other leaf holds this rank's share of the gradient, summed over
    every rank: a data shard's rows, a seq rank's frames, and the
    pipeline's embedding, whose gradient reaches stage 0 only."""
    pipe = mesh.size("pipe") > 1
    once = [k for k in paths if not k.startswith("encoder.")
            or (pipe and k.startswith("encoder.after_norm."))]
    staged = [k for k in paths if pipe and is_stage_leaf(k)]
    return once, staged
