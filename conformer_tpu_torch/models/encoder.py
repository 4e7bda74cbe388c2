"""Conformer encoder, full-utterance forward (JAX ``models/encoder.py``),
for inference and for training (dropout, dynamic chunk masks).

Layer parameters stay STACKED on a leading [L] axis, as in the JAX pytree;
``encoder_forward`` walks them with a Python loop over per-layer views
(the JAX ``lax.scan``). The streaming half (chunked forward with carried
caches) and ``remat`` come in later slices.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from . import attention, convolution, embedding, feedforward, layers, masks
from .layers import Params


def init_encoder_layer(gen, cfg: ModelConfig) -> Params:
    d = cfg.encoder_dim
    return {
        "feed_forward_macaron": feedforward.init_ffn(gen, d, cfg.hidden_dim),
        "self_attn": attention.init_mhsa(gen, d, cfg.num_heads),
        "conv_module": convolution.init_conv_module(gen, d, cfg.kernel_size),
        "feed_forward": feedforward.init_ffn(gen, d, cfg.hidden_dim),
        "norm_ff_macaron": layers.init_layer_norm(d),
        "norm_mha": layers.init_layer_norm(d),
        "norm_conv": layers.init_layer_norm(d),
        "norm_ff": layers.init_layer_norm(d),
        "norm_final": layers.init_layer_norm(d),
    }


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(stacked: Params, i: int) -> Params:
    """Views of layer ``i`` of the stacked [L, ...] layer parameters."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def init_encoder(gen, cfg: ModelConfig) -> Params:
    _check_supported(cfg)
    embed = convolution.init_subsampling(gen, cfg.input_dim, cfg.encoder_dim)
    stacked = _stack([init_encoder_layer(gen, cfg) for _ in range(cfg.encoder_num_layers)])
    return {
        "embed": embed,
        "layers": stacked,
        "after_norm": layers.init_layer_norm(cfg.encoder_dim),
        "pos_table": embedding.signed_sinusoid_table(cfg.max_len, cfg.encoder_dim),
    }


def _check_supported(cfg: ModelConfig) -> None:
    if not cfg.use_relative or cfg.rel_mode not in ("skew", "decomposed"):
        raise NotImplementedError(
            f"use_relative={cfg.use_relative}, rel_mode={cfg.rel_mode!r}: only the "
            "relative skew and decomposed modes are ported"
        )
    if cfg.conv_norm != "layer_norm" or cfg.causal_conv:
        raise NotImplementedError("only the non-causal LayerNorm conv module is ported")


def _ffn_residual(norm_p: Params, ffn_p: Params, x: torch.Tensor, cfg: ModelConfig,
                  gen, deterministic: bool) -> torch.Tensor:
    """x + 0.5 * dropout(FFN(LN(x))): one macaron half, with the FFN's inner
    dropout and the dropout of its output. With both FFN matmuls int8
    (``ops/quant.quantize_tree(fuse_ffn=True)``) at inference, the half is
    one ``int8_ffn_fused`` call: the kernel on CUDA tensors, its plain
    version on CPU tensors (JAX ``models/encoder.py`` ``_ffn_residual``)."""
    w1, w2 = ffn_p["w_1"], ffn_p["w_2"]
    if deterministic and "kernel_q" in w1 and "kernel_q" in w2:
        from ..ops.int8_ffn import int8_ffn_fused

        return int8_ffn_fused(x, norm_p, w1["kernel_q"], w1["kernel_scale"], w1["bias"],
                              w2["kernel_q"], w2["kernel_scale"], w2["bias"], half=0.5)
    y = feedforward.ffn(ffn_p, layers.layer_norm(norm_p, x), dropout_rate=cfg.dropout,
                        gen=gen, deterministic=deterministic)
    return x + 0.5 * layers.dropout(gen, y, cfg.dropout, deterministic)


def encoder_layer(
    p: Params,
    x: torch.Tensor,
    attn_mask: torch.Tensor | None,
    pos_emb: torch.Tensor | None,
    pad_mask: torch.Tensor | None,
    cfg: ModelConfig,
    *,
    rel_positions: tuple[torch.Tensor, torch.Tensor] | None = None,
    use_pallas: bool = False,
    use_pallas_conv: bool = False,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One macaron Conformer layer; returns (x, conv cache [B, K-1, D]).

    In training (``deterministic=False``) the seven dropout sites of the
    JAX layer draw from ``gen`` in order: the macaron FFN's inner and
    output dropout, the attention probabilities (with ``use_pallas``, one
    seed for the attention kernel's own keep-mask), the attention output,
    the conv output, the second FFN's inner and output dropout. The conv
    kernel has no backward, so it runs only when ``deterministic``, as in
    JAX (``models/encoder.py:308``)."""
    def drop(t):
        return layers.dropout(gen, t, cfg.dropout, deterministic)

    x = _ffn_residual(p["norm_ff_macaron"], p["feed_forward_macaron"], x, cfg, gen,
                      deterministic)
    y = layers.layer_norm(p["norm_mha"], x)
    y = attention.mhsa(
        p["self_attn"], y, y, attn_mask, num_heads=cfg.num_heads,
        pos_emb=pos_emb, rel_positions=rel_positions, use_pallas=use_pallas,
        dropout_rate=cfg.attention_dropout, gen=gen, deterministic=deterministic,
    )
    x = x + drop(y)
    if use_pallas_conv and deterministic:
        from ..ops.conv_block import conv_block

        lengths = (
            pad_mask.sum(dim=1, dtype=torch.int32)
            if pad_mask is not None
            else torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        )
        x, conv_cache = conv_block(
            x, lengths, p["norm_conv"], p["conv_module"], kernel_size=cfg.kernel_size
        )
    else:
        y, conv_cache = convolution.conv_module(
            p["conv_module"], layers.layer_norm(p["norm_conv"], x), pad_mask,
            kernel_size=cfg.kernel_size,
        )
        x = x + drop(y)
    x = _ffn_residual(p["norm_ff"], p["feed_forward"], x, cfg, gen, deterministic)
    return layers.layer_norm(p["norm_final"], x), conv_cache


def _embed(p: Params, feats: torch.Tensor, cfg: ModelConfig):
    """Subsample; return (x [B,T',D], pos_emb or None, rel_positions or None)
    as the JAX ``_embed`` does for the relative modes at offset 0."""
    _check_supported(cfg)
    x = convolution.subsampling(p["embed"], feats)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    rel_positions = (pos, pos)
    if cfg.rel_mode == "decomposed":
        return x, None, rel_positions
    pos_emb = embedding.relative_pos_embed(p["pos_table"], t, t)
    return x, pos_emb, rel_positions if cfg.use_pallas_attention else None


def encoder_forward(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    cmvn: Params | None = None,
    num_decoding_left_chunks: int = -1,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    deterministic: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-utterance forward. feats [B, T, F], feat_lengths [B] ->
    (encoder_out [B, T', D], pad_mask bool [B, T'] True = valid).

    Deterministic: full context, or a static chunk mask when
    ``cfg.static_chunk_size > 0``. Training (``deterministic=False``):
    dropout draws from ``gen`` (on the feats' device) and, with
    ``cfg.use_dynamic_chunk``, one chunk mask per batch is drawn on the
    host generator ``host_gen``."""
    from . import cmvn as cmvn_mod

    if cmvn is not None:
        feats = cmvn_mod.global_cmvn(cmvn, feats)
    feats = feats.to(getattr(torch, cfg.compute_dtype))
    x, pos_emb, rel_positions = _embed(p, feats, cfg)
    pad_mask = masks.make_non_pad_mask(masks.subsampled_lengths(feat_lengths), x.shape[1])
    dynamic = None
    if cfg.use_dynamic_chunk and not deterministic:
        if host_gen is None:
            raise ValueError("dynamic chunk training needs a host torch.Generator")
        dynamic = masks.sample_dynamic_chunk(host_gen, x.shape[1], cfg.use_dynamic_left_chunk)
    attn_mask = masks.make_attn_mask(
        pad_mask, static_chunk_size=cfg.static_chunk_size,
        num_decoding_left_chunks=num_decoding_left_chunks, dynamic_chunk=dynamic,
    ).contiguous()
    for i in range(cfg.encoder_num_layers):
        x, _ = encoder_layer(
            layer_params(p["layers"], i), x, attn_mask, pos_emb, pad_mask, cfg,
            rel_positions=rel_positions, use_pallas=cfg.use_pallas_attention,
            use_pallas_conv=cfg.use_pallas_conv, gen=gen, deterministic=deterministic,
        )
    return layers.layer_norm(p["after_norm"], x), pad_mask
