"""Tensor parallelism over the "model" axis: the collectives that GSPMD
inserts for JAX's model-sharded params (``parallel/mesh.py``
``model_axis``, JAX's ``_spec_for``), written out as autograd Functions
over the model group. JAX has no module of its own for this.

The layout (Megatron's): activations between the sharded blocks are
whole on every rank of a model group; a block reads them through
``copy_in`` (identity; its backward sums the partial input gradients of
the shards over "model"), computes its shard (its heads, its FFN columns,
its vocabulary columns) and joins through ``reduce_out`` (a sum over
"model"; identity backward), after which the replicated bias of a
row-parallel layer is added once. The vocabulary-sharded heads never join
their logits: ``log_probs`` takes the log-softmax over the whole
vocabulary from the shards' row maxima and sums of exponentials and picks
the columns a loss reads, the same on every rank, so that the loss DPs
(the CTC and RNN-T kernels) run on whole, replicated inputs. Dropout
draws the mask of the whole activation from the generator that every rank
of the group holds at the same state and keeps the rank's slice
(``dropout``), so a model group draws exactly what one process draws.

Every collective runs on every rank of the group in the same order: the
forward's in program order, the backward's in autograd's, which is the
same graph on every rank. There is no fallback: a failed collective fails
the step.

``ModelShard.clock``: None, or a list to which each of the model axis's
collectives appends its host ms, between two device synchronisations (a
measurement's own mode: the syncs cost the overlap they remove;
``chip_smoke.py`` phase 8 (e) reads the model axis's share of a step
from it).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh


def _collective(clock, op, t: torch.Tensor, *args, **kw) -> None:
    """``op(*args, **kw)``, timed into ``clock`` when it is a list; ``t``
    names the device to synchronise."""
    if clock is None:
        op(*args, **kw)
        return
    sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    op(*args, **kw)
    sync()
    clock.append((time.perf_counter() - t0) * 1e3)


class Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``, in rank order. Backward:
    with ``sum_grads`` the gradient of this rank's piece summed over the
    group (every rank used every piece in its own computation); without,
    this rank's piece of its own gradient (every rank computed the same
    thing from the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank, sum_grads, clock=None):
        ctx.dim, ctx.group, ctx.rank, ctx.sum, ctx.n = dim, group, rank, sum_grads, x.shape[dim]
        ctx.clock = clock
        parts = [torch.empty_like(x) for _ in range(size)]
        _collective(clock, dist.all_gather, x, parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum:
            g = g.contiguous().clone()      # all_reduce works in place: on a copy of our own
            _collective(ctx.clock, dist.all_reduce, g, g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None, None, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; backward: the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group, clock):
        ctx.group, ctx.clock = group, clock
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _collective(ctx.clock, dist.all_reduce, g, g, group=ctx.group)
        return g, None, None


class _ReduceOut(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group, clock):
        x = x.contiguous().clone()
        _collective(clock, dist.all_reduce, x, x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _VocabLogProbs(torch.autograd.Function):
    """log_softmax over the whole vocabulary, picked at ``ids``: logits
    [..., V/m] of this rank's columns [offset, offset + V/m) and ids [...,
    S] of global columns -> float32 [..., S], the same on every rank.

    Forward: the row maxima all-gathered and their maximum taken (gloo and
    NCCL both take all_gather and a sum on CUDA tensors), then one sum over
    the group of [sum of exp(logits - max), the picked logits], where a
    column outside this rank's range contributes 0. Backward, local: with
    g [..., S] the same on every rank (every rank computes the same loss
    from the same log-probs), d logits = onehot(g) - softmax_shard * sum(g),
    the one-hot scattered at this rank's columns only."""

    @staticmethod
    def forward(ctx, logits, ids, group, size, rank, clock):
        lf = logits.float()
        v = lf.shape[-1]
        local = ids.long() - rank * v
        inside = (local >= 0) & (local < v)
        local = local.clamp(0, v - 1)
        m_loc = lf.amax(dim=-1).contiguous()
        maxima = [torch.empty_like(m_loc) for _ in range(size)]
        _collective(clock, dist.all_gather, m_loc, maxima, m_loc, group=group)
        m = torch.stack(maxima).amax(dim=0)
        picked = torch.where(inside, lf.gather(-1, local), 0.0)
        buf = torch.cat([torch.exp(lf - m[..., None]).sum(dim=-1, keepdim=True), picked], dim=-1)
        _collective(clock, dist.all_reduce, buf, buf, group=group)
        lse = m + torch.log(buf[..., 0])
        ctx.save_for_backward(logits, lse, local, inside)
        return buf[..., 1:] - lse[..., None]

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        g = g.float()
        d = -torch.exp(logits.float() - lse[..., None]) * g.sum(dim=-1, keepdim=True)
        d = d.scatter_add(-1, local, torch.where(inside, g, 0.0))
        return d.to(logits.dtype), None, None, None, None, None


class ModelShard:
    """This rank's place on the "model" axis of ``mesh`` (its group, size
    and coordinate) and the tensor-parallel operations over it, which the
    model functions take as ``model_shard`` (None: one model shard, the
    plain forward)."""

    def __init__(self, mesh: Mesh):
        self.group, self.size = mesh.group("model"), mesh.size("model")
        self.rank = mesh.coord("model")
        self.clock: list[float] | None = None

    def heads(self, num_heads: int) -> tuple[int, int]:
        """(this rank's heads, the first one's global index) of
        ``num_heads``."""
        if num_heads % self.size:
            raise ValueError(f"{num_heads} heads do not split over model={self.size}")
        h = num_heads // self.size
        return h, self.rank * h

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group, self.clock)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group, self.clock)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of this rank's shard ``x`` along ``dim``, the
        same on every rank; backward: this rank's piece of its own
        gradient (every rank computes the same thing from it)."""
        return Gather.apply(x, dim, self.group, self.size, self.rank, False, self.clock)

    def dense_rows(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel dense: x [.., K/m] times this rank's kernel rows
        [K/m, N], summed over the group, plus the replicated bias, once."""
        y = self.reduce_out(torch.matmul(x, p["kernel"].to(x.dtype)))
        return y + p["bias"].to(x.dtype) if "bias" in p else y

    def dropout(self, gen, x: torch.Tensor, rate: float, deterministic: bool,
                dim: int) -> torch.Tensor:
        """``layers.dropout`` of the whole activation, of which ``x`` is
        this rank's slice along ``dim``: the mask of the whole shape is
        drawn from ``gen`` and this rank's slice of it kept."""
        if deterministic or rate <= 0.0:
            return x
        if gen is None:
            raise ValueError("dropout in training needs a torch.Generator")
        dim = dim % x.ndim
        shape = list(x.shape)
        shape[dim] *= self.size
        keep = 1.0 - rate
        mask = torch.rand(shape, generator=gen, device=x.device) < keep
        mask = mask.narrow(dim, self.rank * x.shape[dim], x.shape[dim])
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def log_probs(self, logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """float32 log-probs [..., S] of global columns ``ids`` (leading
        axes as the logits') from this rank's vocabulary columns ``logits``
        [..., V/m]: ``_VocabLogProbs``."""
        return _VocabLogProbs.apply(logits, ids, self.group, self.size, self.rank, self.clock)

    def embedding(self, table: torch.Tensor, ids: torch.Tensor, dtype=None) -> torch.Tensor:
        """Rows ``ids`` of the vocabulary-split table, of which this rank
        holds rows [rank V/m, (rank + 1) V/m): its own rows looked up,
        zeros for the rest, summed over the group."""
        if dtype is not None:
            table = table.to(dtype)
        n = table.shape[0]
        local = ids.long() - self.rank * n
        inside = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), table)
        return self.reduce_out(torch.where(inside[..., None], rows, torch.zeros_like(rows)))
