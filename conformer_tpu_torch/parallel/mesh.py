"""The rank grid and the parameter layout (JAX ``parallel/mesh.py``).

JAX lays devices out as ``np.asarray(devices).reshape(...)`` over named
axes. The port lays processes out the same way: one process per device,
ranks row-major over the axes, so that rank r has device r's coordinates.
Each rank keeps one process group per axis: the ranks that share every
other coordinate with it; with a "model" axis also the group of the ranks
that share its model coordinate (``MODEL_PEERS``). A batch is split over
"data": the rows of the global batch this rank holds are
``batch_sharding``'s slice.

Tensor parallelism splits the wide matmuls over "model" by JAX's rules
(``_spec_for``, keyed on the same dotted leaf paths): ``model_axis`` says
which axis of a leaf is split, ``shard_params`` cuts a whole tree (JAX's
layout) to this rank's shards and ``gather_leaf`` joins one back. The
collectives of the sharded forward are ``parallel/tensor.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .distributed import process_count, process_index

MODEL_PEERS = "~model"     # the group of the ranks that share this rank's model coordinate


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
    if shape.get("model", 1) > 1:
        for m in range(shape["model"]):
            ranks = [r for r in range(n) if (r // _stride(shape, "model")) % shape["model"] == m]
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[MODEL_PEERS] = g if len(ranks) > 1 else None
    return mesh


def _stride(shape: dict[str, int], axis: str) -> int:
    """The rank distance between neighbours along ``axis``."""
    axes = list(shape)
    s = 1
    for a in axes[axes.index(axis) + 1:]:
        s *= shape[a]
    return s


def _rank(shape: dict[str, int], coords: dict[str, int]) -> int:
    r = 0
    for axis, n in shape.items():
        r = r * n + coords[axis]
    return r


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ("data", "model") mesh over every process (JAX's; without a
    model axis when ``model`` is 1)."""
    return grid({"data": data, "model": model} if model > 1 else {"data": data})


def model_axis(path: str, ndim: int) -> int | None:
    """Which axis of the leaf at dotted ``path`` (``ndim`` axes; encoder
    layer leaves carry the stacked [L] axis first) is split over "model",
    or None where it is replicated: JAX's ``_spec_for``, rule for rule.
    FFN: w_1 [.., D, H] and its bias by H, w_2 [.., H, D] by H. Attention
    (``self_attn``, the encoder's and the decoder's): q, k, v and pos
    project D -> heads x dk, split by their output (head) axis, the q, k,
    v biases too; linear_out by its input axis. The vocabulary
    projections, the joint's ffn_out [J, V] and ctc_lo [D, V], and their
    biases by V; the predictor's embedding [V, E] by V. Every other leaf
    (the row-parallel biases w_2.bias and linear_out.bias, pos_bias_u/v,
    the simple-lattice projections, the decoder's src_attn, embed and
    output_layer, norms, conv, subsampling) is replicated."""
    last, middle = ndim - 1, ndim - 2
    if "feed_forward" in path and ("w_1.kernel" in path or "w_1.bias" in path):
        return last
    if "feed_forward" in path and "w_2.kernel" in path:
        return middle
    if "self_attn" in path and any(f"linear_{x}.kernel" in path for x in ("q", "k", "v", "pos")):
        return last
    if "self_attn" in path and any(f"linear_{x}.bias" in path for x in ("q", "k", "v")):
        return last
    if "self_attn" in path and "linear_out.kernel" in path:
        return middle
    if ("ffn_out.kernel" in path or "ctc_lo.kernel" in path) and ndim >= 2:
        return last
    if "ffn_out.bias" in path or "ctc_lo.bias" in path:
        return last
    if "predictor.embed.embedding" in path:
        return 0
    return None


def is_head_rows(path: str) -> bool:
    """Whether a leaf is a replicated [.., H, dk] table of which each model
    rank reads its own heads' rows (``pos_bias_u``/``pos_bias_v``): its
    gradient is partial on every rank and sums over "model"."""
    return "self_attn.pos_bias_" in path


def shard_leaf(path: str, t, mesh: Mesh):
    """This rank's shard of the whole leaf ``t`` at ``path`` (a view; the
    leaf itself where it is replicated or the mesh has no model axis).
    Raises ValueError where the split axis does not divide by the model
    size, as JAX's ``device_put`` does."""
    m = mesh.size("model")
    axis = model_axis(path, t.ndim) if m > 1 else None
    if axis is None:
        return t
    n = t.shape[axis]
    if n % m:
        raise ValueError(f"{path}: axis {axis} of shape {tuple(t.shape)} has {n} entries, "
                         f"which do not split over model={m}")
    return t.narrow(axis, mesh.coord("model") * (n // m), n // m)


def map_tensors(tree, fn, prefix: str = ""):
    """The tree with each tensor leaf replaced by ``fn(dotted path,
    leaf)``, in ``leaf_paths`` order; other leaves pass unchanged."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tensors(v, fn, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree) if isinstance(tree, torch.Tensor) else tree


def shard_params(params, mesh: Mesh):
    """A whole tree in JAX's layout (params, or Adam moments keyed by the
    params' paths) cut to this rank's model shards, each a contiguous copy
    of its own; replicated leaves pass as they are. Every split leaf is
    checked before any is cut (JAX's ``shard_params``)."""
    map_tensors(params, lambda k, v: shard_leaf(k, v, mesh))

    def cut(k, v):
        s = shard_leaf(k, v, mesh)
        return v if s is v else s.contiguous().clone()

    return map_tensors(params, cut)


def gather_leaf(path: str, t, mesh: Mesh):
    """The whole leaf of this rank's shard ``t`` at ``path``, joined over
    the model group in rank order (a collective of that group, which every
    rank of it must call); ``t`` itself where it is replicated."""
    m = mesh.size("model")
    axis = model_axis(path, t.ndim) if m > 1 else None
    if axis is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(m)]
    dist.all_gather(parts, t, group=mesh.group("model"))
    return torch.cat(parts, dim=axis)


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
    pipeline's embedding, whose gradient reaches stage 0 only. The model
    axis adds its own rules (``model_leaves``)."""
    pipe = mesh.size("pipe") > 1
    once = [k for k in paths if not k.startswith("encoder.")
            or (pipe and k.startswith("encoder.after_norm."))]
    staged = [k for k in paths if pipe and is_stage_leaf(k)]
    return once, staged


def model_leaves(mesh: Mesh, leaves: dict) -> tuple[list[str], list[str]]:
    """How the gradient leaves ({path: tensor}) stand on this rank under a
    "model" axis, beside ``owned_leaves``, as (split, head_rows):
      - ``split``: the leaves ``model_axis`` splits hold this rank's
        shard's gradient, a share of it over the data and seq ranks: they
        sum over the ranks that share this rank's model coordinate
        (``MODEL_PEERS``), never across shards;
      - ``head_rows``: pos_bias_u/v (``is_head_rows``), whose rows each
        model rank reads for its own heads only, hold a share of the
        gradient on every rank and sum over "model" too.
    Every other leaf is replicated and computed whole on each rank of a
    model group (``parallel/tensor.py``'s copy-in sums what flows back
    into replicated activations): it counts once per model group, from
    model coordinate 0. The gradient norm takes each split leaf's squares
    summed over "model" and every other leaf once. Without a model axis
    both lists are empty."""
    if mesh.size("model") == 1:
        return [], []
    split = [k for k, v in leaves.items() if model_axis(k, v.ndim) is not None]
    rows = [k for k in leaves if is_head_rows(k)]
    return split, rows
