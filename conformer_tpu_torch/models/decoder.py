"""Attention (transformer) decoder and its label-smoothing loss (JAX
``models/decoder.py``): a left-to-right decoder, an optional right-to-left
one for bidirectional training and rescoring, and the smoothed KL loss,
weighted into the transducer's loss by ``cfg.attention_weight``.

Pre-norm layers: causal self-attention -> cross-attention over the
encoder output -> FFN, all absolute-position attention in plain PyTorch
(JAX computes it in XLA, outside any Pallas kernel). The layers are
stacked on a leading [L] axis as in JAX and run in a loop over
``layer_params(stacked, i)``. Dropout draws from the caller's
``torch.Generator``; its draws differ from ``jax.random``'s. Under a
model axis (``model_shard``, ``parallel/tensor.py``) the self-attention
and the FFN run this rank's heads and hidden columns, as JAX's rules
split them; the cross-attention, the embedding and the output layer are
replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from . import attention, embedding, feedforward, layers, masks
from .encoder import _stack, layer_params
from .layers import Params


def init_decoder_layer(gen, cfg: ModelConfig) -> Params:
    d = cfg.encoder_dim
    return {
        "self_attn": attention.init_mhsa(gen, d, cfg.num_heads, relative=False),
        "src_attn": attention.init_mhsa(gen, d, cfg.num_heads, relative=False),
        "feed_forward": feedforward.init_ffn(gen, d, cfg.decoder_hidden_dim),
        "norm1": layers.init_layer_norm(d),
        "norm2": layers.init_layer_norm(d),
        "norm3": layers.init_layer_norm(d),
    }


def init_transformer_decoder(gen, cfg: ModelConfig, num_layers: int) -> Params:
    return {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.encoder_dim),
        "pos_table": embedding.sinusoid_table(cfg.max_len, cfg.encoder_dim),
        "layers": _stack([init_decoder_layer(gen, cfg) for _ in range(num_layers)]),
        "after_norm": layers.init_layer_norm(cfg.encoder_dim),
        "output_layer": layers.init_dense(gen, cfg.encoder_dim, cfg.vocab_size),
    }


def init_bi_decoder(gen, cfg: ModelConfig, r_num_layers: int = 0) -> Params:
    """The L2R decoder and, when ``r_num_layers`` > 0, the R2L one."""
    p: Params = {"left_decoder": init_transformer_decoder(gen, cfg, cfg.decoder_num_layers)}
    if r_num_layers > 0:
        p["right_decoder"] = init_transformer_decoder(gen, cfg, r_num_layers)
    return p


def transformer_decoder_forward(
    p: Params,
    memory: torch.Tensor,
    memory_pad_mask: torch.Tensor,
    targets_in: torch.Tensor,
    target_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    model_shard=None,
) -> torch.Tensor:
    """targets_in [B, U] (sos-prefixed), memory [B, T, D] with its pad mask
    [B, T] (True = valid) -> logits [B, U, V]."""
    bsz, u = targets_in.shape
    x = layers.embedding(p["embed"], targets_in, dtype=getattr(torch, cfg.compute_dtype))
    x = x * torch.sqrt(torch.tensor(float(cfg.encoder_dim), dtype=x.dtype))
    x = x + embedding.absolute_pos_embed(p["pos_table"], 0, u).to(x.dtype)[None]
    tgt_valid = masks.make_non_pad_mask(target_lengths, u)
    self_mask = tgt_valid[:, None, :] & masks.make_subsequent_mask(u, x.device)[None]
    cross_mask = memory_pad_mask[:, None, :].expand(bsz, u, memory.shape[1])
    mem = memory.to(x.dtype)
    kw = dict(num_heads=cfg.num_heads, dropout_rate=cfg.attention_dropout, gen=gen,
              deterministic=deterministic)
    for i in range(p["layers"]["norm1"]["scale"].shape[0]):
        lp = layer_params(p["layers"], i)
        y = layers.layer_norm(lp["norm1"], x)
        y, _ = attention.mhsa(lp["self_attn"], y, y, self_mask, model_shard=model_shard, **kw)
        x = x + layers.dropout(gen, y, cfg.dropout, deterministic)
        y = layers.layer_norm(lp["norm2"], x)
        y, _ = attention.mhsa(lp["src_attn"], y, mem, cross_mask, **kw)
        x = x + layers.dropout(gen, y, cfg.dropout, deterministic)
        y = layers.layer_norm(lp["norm3"], x)
        y = feedforward.ffn(lp["feed_forward"], y, dropout_rate=cfg.dropout, gen=gen,
                            deterministic=deterministic, model_shard=model_shard)
        x = x + layers.dropout(gen, y, cfg.dropout, deterministic)
    x = layers.layer_norm(p["after_norm"], x)
    return layers.dense(p["output_layer"], x)


def label_smoothing_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    smoothing: float,
    ignore_id: int = -1,
    normalize_length: bool = False,
) -> torch.Tensor:
    """KL of the log-softmax of logits [B, U, V] from the smoothed targets
    (1 - eps on the label, eps / (V-1) elsewhere); ignore_id positions
    count 0; the sum over positions / B (or / the valid count)."""
    bsz, _, v = logits.shape
    log_probs = torch.log_softmax(logits.reshape(-1, v).float(), dim=-1)
    targets_f = targets.reshape(-1)
    valid = targets_f != ignore_id
    one_hot = F.one_hot(torch.where(valid, targets_f, 0).long(), v).float()
    true_full = torch.full_like(log_probs, smoothing / (v - 1))
    true_full = true_full * (1 - one_hot) + one_hot * (1.0 - smoothing)
    kl = (true_full * (torch.log(true_full.clamp_min(1e-20)) - log_probs)).sum(dim=-1)
    kl = torch.where(valid, kl, 0.0)
    denom = valid.sum().clamp_min(1) if normalize_length else max(bsz, 1)
    return kl.sum() / denom


def attention_loss(
    p: Params,
    memory: torch.Tensor,
    memory_pad_mask: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    model_shard=None,
) -> torch.Tensor:
    """The L2R decoder's smoothed loss, blended with the R2L decoder's by
    ``reverse_weight`` when that is > 0 and the R2L decoder exists."""
    ys_in, ys_out = masks.add_sos_eos(labels, label_lengths, cfg.sos_eos_id,
                                      cfg.sos_eos_id, cfg.ignore_id)
    lens_in = label_lengths + 1
    kw = dict(gen=gen, deterministic=deterministic, model_shard=model_shard)
    logits = transformer_decoder_forward(p["left_decoder"], memory, memory_pad_mask, ys_in,
                                         lens_in, cfg, **kw)
    loss = label_smoothing_loss(logits, ys_out, cfg.lsm_weight, cfg.ignore_id)
    if cfg.reverse_weight > 0 and "right_decoder" in p:
        r_labels = masks.reverse_sequence(labels, label_lengths, cfg.ignore_id)
        r_in, r_out = masks.add_sos_eos(r_labels, label_lengths, cfg.sos_eos_id,
                                        cfg.sos_eos_id, cfg.ignore_id)
        r_logits = transformer_decoder_forward(p["right_decoder"], memory, memory_pad_mask,
                                               r_in, lens_in, cfg, **kw)
        r_loss = label_smoothing_loss(r_logits, r_out, cfg.lsm_weight, cfg.ignore_id)
        loss = (1 - cfg.reverse_weight) * loss + cfg.reverse_weight * r_loss
    return loss
