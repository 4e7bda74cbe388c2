"""Sequence parallelism (JAX ``parallel/sequence.py``): the encoder's time
axis split over a "seq" axis of ranks.

For long audio the [B, T', D] activations and the [B, H, T', T'] scores
outgrow one card long before the weights do. Rank r of a seq group of S
holds frames [r T'/S, (r+1) T'/S) of every layer's activations. Between
ranks cross only:
  - attention's K and V, all-gathered over the group (each rank's queries
    attend to every key), whose backward sums each key's gradient over the
    ranks that read it;
  - the depthwise conv's halo: (K-1)/2 frames of the residual stream from
    each neighbour (K = 15: 7 each side), the conv module run on the
    window and cropped, masked by the global lengths. FFN, LayerNorm and
    the conv's pointwise parts are per frame.
The subsampling and the masks are computed whole on every rank, and each
keeps its frames. The attention kernel runs at Tq = T'/S queries whose
positions start at r T'/S, against Tk = T' keys; the conv-block kernel
takes the window with the window's own valid count.

Gradients: ``encoder_forward_seq`` returns the whole [B, T', D] output on
every rank of the group; every rank is to compute the same loss from it,
and the gather's backward hands each rank the gradient of its own frames
only. So after the backward a rank holds its frames' share of every
encoder leaf's gradient (the group's sum is the gradient), and the whole
gradient of every leaf after the encoder (the same on every rank of the
group). ``mesh.owned_leaves`` is that rule; ``train/loop.py`` sums the
first and takes the second once by it.
"""

from __future__ import annotations

import torch

from ..models import encoder as enc
from ..models import layers
from .mesh import Mesh, grid
from .tensor import Gather as _Gather


def make_seq_mesh(data: int = -1, seq: int = 2, model: int = 1) -> Mesh:
    """The ("data", "seq") mesh: batch over "data", time over "seq"; with
    ``model`` > 1 JAX's 3-axis ("data", "seq", "model") mesh, the params
    split over "model" by ``mesh.model_axis`` (``parallel/tensor.py``)."""
    if model > 1:
        return grid({"data": data, "seq": seq, "model": model})
    return grid({"data": data, "seq": seq})


class SeqShard:
    """One rank's time shard of a [B, T', D] activation: what
    ``models/encoder.encoder_layer`` needs to run a layer on it. ``pad_mask``
    is the whole batch's [B, T'] (True = valid)."""

    def __init__(self, mesh: Mesh, pad_mask: torch.Tensor, kernel_size: int, causal: bool):
        self.group, self.size, self.rank = mesh.group("seq"), mesh.size("seq"), mesh.coord("seq")
        t = pad_mask.shape[1]
        self.t_local = t // self.size
        self.offset = self.rank * self.t_local
        # the depthwise conv's reach: SAME (K-1)//2 left, the rest right;
        # causal K-1 left. No halo past the sequence's ends (zero padding
        # there, as in the whole-sequence conv).
        self.reach = (kernel_size - 1, 0) if causal else (
            (kernel_size - 1) // 2, kernel_size - 1 - (kernel_size - 1) // 2)
        if max(self.reach) > self.t_local:
            raise ValueError(f"a time shard of {self.t_local} frames is shorter than the conv "
                             f"halo {self.reach}")
        self.left = self.reach[0] if self.rank > 0 else 0
        self.right = self.reach[1] if self.rank < self.size - 1 else 0
        self.window_mask = pad_mask[:, self.offset - self.left:
                                    self.offset + self.t_local + self.right]

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's frames of a whole-sequence tensor."""
        return x.narrow(dim, self.offset, self.t_local)

    def gather_kv(self, t: torch.Tensor) -> torch.Tensor:
        """K or V [B, H, T'/S, dk] of this shard -> the sequence's [B, H, T', dk]
        (H: this rank's heads under a model axis)."""
        return _Gather.apply(t, 2, self.group, self.size, self.rank, True)

    def gather_output(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's [B, T'/S, D] output -> the sequence's, the same on
        every rank (backward: this shard's frames of this rank's gradient)."""
        return _Gather.apply(x, 1, self.group, self.size, self.rank, False)

    def window(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(the shard with its neighbours' halo frames on either side, the
        window's pad mask)."""
        lo, hi = self.reach
        edges = torch.cat([x[:, :hi], x[:, x.shape[1] - lo:]], dim=1)       # [B, hi + lo, D]
        every = _Gather.apply(edges, 1, self.group, self.size, self.rank, True)
        w = lo + hi
        parts = []
        if self.left:       # the previous shard's last lo frames
            parts.append(every[:, (self.rank - 1) * w + hi:self.rank * w])
        parts.append(x)
        if self.right:      # the next shard's first hi frames
            parts.append(every[:, (self.rank + 1) * w:(self.rank + 1) * w + hi])
        return torch.cat(parts, dim=1), self.window_mask

    def crop(self, y: torch.Tensor) -> torch.Tensor:
        """A window's output -> the shard's frames."""
        return y[:, self.left:self.left + self.t_local]


def local_positions(p_encoder: dict, shard: SeqShard, t: int, pos_emb, rel_positions):
    """The relative positions of the shard's queries against every key:
    (q_pos = offset + i, k_pos = j) for the factorised bias and the kernel;
    for the skew, the rows of the signed table whose distances run from
    offset + T'/S - 1 down to offset - T' + 1."""
    if rel_positions is not None:
        q_pos, k_pos = rel_positions
        rel_positions = (shard.local(q_pos, 0), k_pos)
    if pos_emb is not None:
        table = p_encoder["pos_table"]
        start = (table.shape[0] + 1) // 2 - shard.t_local - shard.offset
        pos_emb = table[start:start + shard.t_local + t - 1]
    return pos_emb, rel_positions


def encoder_forward_seq(
    p: dict,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg,
    *,
    mesh: Mesh,
    cmvn: dict | None = None,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    deterministic: bool = True,
    model_shard=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``encoder_forward`` with the time axis split over ``mesh``'s "seq"
    group -> (encoder_out [B, T', D], pad_mask [B, T']), both whole on
    every rank of the group. ``model_shard`` (``parallel/tensor.py``):
    the layers' heads and FFN columns split over "model" as well.

    As in JAX, the raw features are right-padded by whole subsampling
    strides (4 frames a subsampled frame) until T' divides the group, the
    padded tail is invalid in every mask, and the output is cropped back.
    The result is the unsharded forward's on the padded batch: the padding
    itself reaches the last valid frames through the conv module's bias
    (the reference's semantics, which its own bucket padding shows too).
    Dropout draws from ``gen``, the dynamic chunk from ``host_gen``, which
    must stand at the same state on every rank of the group."""
    size = mesh.size("seq")
    t_sub = ((feats.shape[1] - 1) // 2 - 1) // 2
    pad_sub = (-t_sub) % size
    if pad_sub:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, 4 * pad_sub))
    x, pos_emb, rel_positions, pos_ref = enc._embed(p, enc.input_feats(feats, cfg, cmvn), cfg)
    t = x.shape[1]
    pad_mask, attn_mask = enc.encoder_masks(feat_lengths, t, cfg, deterministic=deterministic,
                                            host_gen=host_gen)
    shard = SeqShard(mesh, pad_mask, cfg.kernel_size, cfg.causal_conv)
    pos_emb, rel_positions = local_positions(p, shard, t, pos_emb, rel_positions)
    attn_mask = shard.local(attn_mask).contiguous()
    x = shard.local(x)

    def layer(lp, x, g):
        return enc.encoder_layer(
            lp, x, attn_mask, pos_emb, shard.local(pad_mask), cfg,
            rel_positions=rel_positions, pos_ref=pos_ref, use_pallas=cfg.use_pallas_attention,
            use_pallas_conv=cfg.use_pallas_conv, gen=g, deterministic=deterministic,
            seq_shard=shard, model_shard=model_shard,
        )[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.encoder_num_layers):
        lp = enc.layer_params(p["layers"], i)
        x = enc._checkpointed(layer, lp, x, gen) if remat else layer(lp, x, gen)
    out = shard.gather_output(layers.layer_norm(p["after_norm"], x))
    if pad_sub:
        out, pad_mask = out[:, :t_sub], pad_mask[:, :t_sub]
    return out, pad_mask
