"""Pipeline parallelism (JAX ``parallel/pipeline.py``) over the encoder's
stacked [L] layer axis.

The encoder's layers are stacked on a leading [L] axis, the layout a
pipeline wants: stage s of a "pipe" group of S holds the contiguous
layers [s L/S, (s+1) L/S) and only their parameters and Adam moments
(``shard_stacked_layers``). A data shard is split into M microbatches, and
GPipe's schedule runs: stage s works on microbatch m at tick m + s, M + S
- 1 ticks in all, handing each activation to stage s + 1 when it is done;
the backward runs the microbatches back through the stages in reverse.
Each hand-over is a broadcast in the two-rank group of that link, which
NCCL and gloo both take on CUDA tensors. The subsampling, the masks and
the final LayerNorm run replicated on every stage, as in JAX, and under
``cfg.remat`` each layer is recomputed in the backward.

Gradients. ``pipeline_apply`` returns the last stage's output on every
stage (JAX replicates it over "pipe" with a psum), and every stage is to
compute the same loss from it. Its backward starts from the last stage's
gradient and ignores the others'. After the backward, stage s holds:
  - its own layers' gradients (the other stages' are theirs);
  - the embedding's gradient only on stage 0: the other stages' inputs
    come from their neighbours, so their embeddings get none;
  - every leaf that runs after the pipeline (the final LayerNorm, the
    predictor, the joint, the CTC head), the gradient of this stage's
    own loss: the same on every stage, to be taken once, not summed S
    times.
``mesh.owned_leaves`` is that rule; ``train/loop.py`` reduces the
gradients and the global norm that the clip takes by it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models import encoder as enc
from ..models import layers
from .mesh import Mesh, _rank, grid

Params = Any


def make_pipeline_mesh(data: int = -1, pipe: int = 2) -> Mesh:
    """The ("data", "pipe") mesh: layers over "pipe", batch over "data",
    with the two-rank group of each link (s, s + 1) of this rank's pipe."""
    mesh = grid({"data": data, "pipe": pipe})
    if not dist.is_initialized():
        return mesh
    me = dist.get_rank()
    for d in range(mesh.shape["data"]):
        for s in range(pipe - 1):
            ranks = [_rank(mesh.shape, {"data": d, "pipe": s + i}) for i in (0, 1)]
            g = dist.new_group(ranks)
            if me in ranks:
                mesh.links[(s, s + 1)] = g
    return mesh


def stage_layers(num_layers: int, mesh: Mesh) -> slice:
    """This stage's layers of the stack."""
    s, n = mesh.coord("pipe"), mesh.size("pipe")
    if num_layers % n:
        raise ValueError(f"L={num_layers} not divisible by pipe={n}")
    per = num_layers // n
    return slice(s * per, (s + 1) * per)


def shard_stacked_layers(layer_params: Params, mesh: Mesh) -> Params:
    """This stage's contiguous L/S slice of the stacked [L, ...] layers,
    in storage of its own."""
    first = next(iter(_leaves(layer_params)))
    sl = stage_layers(first.shape[0], mesh)
    return _map(lambda t: t[sl].clone(), layer_params)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rebuild(tree, leaves: list):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def _split(t, m: int) -> list:
    return list(t.chunk(m, dim=0))


class _Link:
    """Activations between this stage and its neighbours."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.s = mesh, mesh.coord("pipe")

    def send(self, t: torch.Tensor, to: int) -> None:
        dist.broadcast(t.contiguous(), src=self.mesh.rank_at(pipe=self.s),
                       group=self.mesh.links[tuple(sorted((self.s, to)))])

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        buf = torch.empty_like(like)
        dist.broadcast(buf, src=self.mesh.rank_at(pipe=frm),
                       group=self.mesh.links[tuple(sorted((self.s, frm)))])
        return buf


class _Pipeline(torch.autograd.Function):
    """GPipe over this rank's pipe group: forward and backward as the
    module docstring says. ``spec`` carries everything that is not a
    tensor to differentiate; ``x`` is the local batch (read on stage 0
    only), ``leaves`` this stage's stacked layer leaves."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        mesh, m = spec["mesh"], spec["m"]
        s, n_stages = mesh.coord("pipe"), mesh.size("pipe")
        link = _Link(mesh)
        stacked = _rebuild(spec["tree"], list(leaves))
        xs, consts = _split(x, m), spec["consts"]
        ins, outs = [], []
        for i in range(m):                      # stage s's ticks s .. s + M - 1
            h = xs[i] if s == 0 else link.recv(xs[i], s - 1)
            h = h.detach().requires_grad_(spec["grad"])
            with torch.set_grad_enabled(spec["grad"]):
                y = h
                for j in range(spec["per_stage"]):
                    y = spec["apply_fn"](enc.layer_params(stacked, j), y,
                                         {k: c[i] for k, c in consts.items()}, spec["extras"],
                                         s * spec["per_stage"] + j, i)
            if s < n_stages - 1:
                link.send(y.detach(), s + 1)
            ins.append(h)
            outs.append(y)
        last = mesh.rank_at(pipe=n_stages - 1)
        out = torch.cat([y.detach() for y in outs]) if s == n_stages - 1 else torch.empty_like(x)
        dist.broadcast(out, src=last, group=mesh.group("pipe"))
        ctx.spec, ctx.ins, ctx.outs, ctx.leaves = spec, ins, outs, leaves
        return out

    @staticmethod
    def backward(ctx, g_out):
        mesh, m = ctx.spec["mesh"], ctx.spec["m"]
        s, n_stages = mesh.coord("pipe"), mesh.size("pipe")
        link = _Link(mesh)
        g_outs = _split(g_out, m)
        acc: list = [None] * len(ctx.leaves)
        dx = [None] * m
        for i in reversed(range(m)):
            g = g_outs[i] if s == n_stages - 1 else link.recv(ctx.outs[i], s + 1)
            grads = torch.autograd.grad(ctx.outs[i], [ctx.ins[i], *ctx.leaves], g,
                                        allow_unused=True)
            g_in = grads[0] if grads[0] is not None else torch.zeros_like(ctx.ins[i])
            if s > 0:
                link.send(g_in, s - 1)
            dx[i] = g_in
            acc = [a if d is None else (d if a is None else a + d)
                   for a, d in zip(acc, grads[1:])]
        ctx.ins = ctx.outs = None
        return (None, torch.cat(dx) if s == 0 else None, *acc)


def pipeline_apply(
    layer_params: Params,
    x: torch.Tensor,
    consts: dict,
    extras: dict,
    apply_fn: Callable,
    mesh: Mesh,
    *,
    num_microbatches: int,
    num_layers: int,
) -> torch.Tensor:
    """Apply the stacked layers to x [B_local, T, D] as a pipeline over
    ``mesh``'s "pipe" group -> [B_local, T, D], the last stage's output on
    every stage.

    ``layer_params``: this stage's stacked [L/S, ...] layers. ``consts``:
    per-row side inputs with a leading batch axis (the masks), split into
    microbatches with x. ``extras``: batch-independent side inputs (the
    positions). ``apply_fn(layer_params_i, h, consts_mb, extras,
    global_layer_index, microbatch_index) -> h`` applies one layer. As in
    JAX, L must divide by the pipe size and the global batch by data x
    microbatches."""
    n_stages, m = mesh.size("pipe"), num_microbatches
    sl = stage_layers(num_layers, mesh)
    per_stage = sl.stop - sl.start
    if x.shape[0] % m:
        raise ValueError(f"global batch {x.shape[0] * mesh.size('data')} must divide "
                         f"data({mesh.size('data')}) x microbatches({m})")
    leaves = _leaves(layer_params)
    if leaves[0].shape[0] != per_stage:
        raise ValueError(f"stage holds {leaves[0].shape[0]} layers, expected {per_stage} "
                         f"(L={num_layers} over pipe={n_stages}): see shard_stacked_layers")
    spec = {"mesh": mesh, "m": m, "per_stage": per_stage, "apply_fn": apply_fn,
            "tree": layer_params, "extras": extras, "grad": torch.is_grad_enabled(),
            "consts": {k: _split(c, m) for k, c in consts.items()}}
    return _Pipeline.apply(spec, x, *leaves)


def encoder_forward_pipelined(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg,
    mesh: Mesh,
    *,
    num_microbatches: int = 2,
    cmvn: Params | None = None,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    deterministic: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``encoder_forward`` with the layer stack run as a pipeline over
    ``mesh``'s "pipe" group; ``p["layers"]`` is this stage's slice
    (``shard_stacked_layers``). The subsampling, the masks and the final
    LayerNorm run replicated. Dropout draws from ``gen``, microbatch by
    microbatch, so its masks differ from the unpipelined forward's; a
    deterministic forward matches it. The dynamic chunk comes from
    ``host_gen``, which must stand at the same state on every stage."""
    x, pos_emb, rel_positions, pos_ref = enc._embed(p, enc.input_feats(feats, cfg, cmvn), cfg)
    pad_mask, attn_mask = enc.encoder_masks(feat_lengths, x.shape[1], cfg,
                                            deterministic=deterministic, host_gen=host_gen)
    consts = {"attn_mask": attn_mask, "pad_mask": pad_mask}
    extras = {"pos_emb": pos_emb, "rel_positions": rel_positions, "pos_ref": pos_ref}
    if pos_ref is not None and pos_ref.shape[0] == x.shape[0] > 1:
        consts["pos_ref"] = pos_ref         # "ref_batch": a row per batch row
    remat = cfg.remat and torch.is_grad_enabled()

    def apply_fn(lp, h, c, e, g_idx, mb_idx):
        def layer(lp, h, g):
            return enc.encoder_layer(
                lp, h, c["attn_mask"], e["pos_emb"], c["pad_mask"], cfg,
                rel_positions=e["rel_positions"], pos_ref=c.get("pos_ref", e["pos_ref"]),
                use_pallas=cfg.use_pallas_attention, use_pallas_conv=cfg.use_pallas_conv,
                gen=g, deterministic=deterministic)[0]

        return enc._checkpointed(layer, lp, h, gen) if remat else layer(lp, h, gen)

    x = pipeline_apply(p["layers"], x, consts, extras, apply_fn, mesh,
                       num_microbatches=num_microbatches, num_layers=cfg.encoder_num_layers)
    return layers.layer_norm(p["after_norm"], x), pad_mask


def gather_stacked_layers(layer_params: Params, mesh: Mesh) -> Params:
    """The whole [L, ...] stack on every stage, from each stage's slice
    (a collective of the pipe group), on the slices' device.
    ``layer_params`` is a tree of such slices or one slice."""
    n = mesh.size("pipe")

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous(), group=mesh.group("pipe"))
        return torch.cat(parts)

    return _map(gather, layer_params)
