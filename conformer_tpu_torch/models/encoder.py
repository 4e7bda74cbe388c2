"""Conformer encoder (JAX ``models/encoder.py``): the full-utterance
forward, for inference and for training (dropout, dynamic chunk masks),
and the streaming forward, chunk by chunk with carried attention and conv
caches (``EncoderState``).

Layer parameters stay STACKED on a leading [L] axis, as in the JAX pytree;
both forwards walk them with a Python loop over per-layer views (the JAX
``lax.scan``). With ``cfg.remat`` the full-utterance forward recomputes
each layer in the backward (``torch.utils.checkpoint``; JAX's
``jax.checkpoint`` of the scan body), drawing the same dropout masks.

Positions, by ``cfg.use_relative`` and ``cfg.rel_mode``: relative
("skew", "decomposed"), the reference-parity modes ("ref_abs": absolute
key positions; "ref_batch": the reference's batched-training pe[batch
index]), or absolute sinusoids added to the subsampled frames
(``use_relative=False``). ``cfg.conv_norm`` picks the conv module's
LayerNorm or the reference's BatchNorm.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from . import attention, convolution, embedding, feedforward, layers, masks
from .attention import AttnCache
from .layers import Params


class EncoderState(NamedTuple):
    """Streaming state of chunked execution.

    attn_k/attn_v: [L, B, H, C, dk] right-aligned KV caches
    attn_len:      int32 [B], valid trailing cache slots per row (shared by
                   the layers; per row, so that a slot pool can hold
                   streams that joined at different times)
    conv_cache:    [L, B, K-1, D] post-GLU left context
    offset:        int32 [B], subsampled frames seen per row
    """

    attn_k: torch.Tensor
    attn_v: torch.Tensor
    attn_len: torch.Tensor
    conv_cache: torch.Tensor
    offset: torch.Tensor


def init_encoder_layer(gen, cfg: ModelConfig) -> Params:
    d = cfg.encoder_dim
    return {
        "feed_forward_macaron": feedforward.init_ffn(gen, d, cfg.hidden_dim),
        "self_attn": attention.init_mhsa(gen, d, cfg.num_heads, cfg.use_relative),
        "conv_module": convolution.init_conv_module(gen, d, cfg.kernel_size, cfg.conv_norm),
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
    """The subsampling, the stacked layers, the final LayerNorm and the
    frozen ``pos_table``: the signed relative table, or the absolute one
    when ``use_relative`` is off (the ref modes build their rows from the
    positions and read no table)."""
    embed = convolution.init_subsampling(gen, cfg.input_dim, cfg.encoder_dim)
    stacked = _stack([init_encoder_layer(gen, cfg) for _ in range(cfg.encoder_num_layers)])
    table = (embedding.signed_sinusoid_table if cfg.use_relative
             else embedding.sinusoid_table)(cfg.max_len, cfg.encoder_dim)
    return {
        "embed": embed,
        "layers": stacked,
        "after_norm": layers.init_layer_norm(cfg.encoder_dim),
        "pos_table": table,
    }


def _ffn_residual(norm_p: Params, ffn_p: Params, x: torch.Tensor, cfg: ModelConfig,
                  gen, deterministic: bool, model_shard=None) -> torch.Tensor:
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
                        gen=gen, deterministic=deterministic, model_shard=model_shard)
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
    pos_ref: torch.Tensor | None = None,
    attn_cache: AttnCache | None = None,
    conv_cache: torch.Tensor | None = None,
    use_pallas: bool = False,
    use_pallas_conv: bool = False,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    seq_shard=None,
    model_shard=None,
):
    """One macaron Conformer layer; returns (x, new attention cache or
    None, conv cache [B, K-1, D]), as in JAX.

    In training (``deterministic=False``) the seven dropout sites of the
    JAX layer draw from ``gen`` in order: the macaron FFN's inner and
    output dropout, the attention probabilities (with ``use_pallas``, one
    seed for the attention kernel's own keep-mask), the attention output,
    the conv output, the second FFN's inner and output dropout. The conv
    kernel has no backward, so it runs only when ``deterministic``, and
    only without a conv cache and for the non-causal LayerNorm conv, as in
    JAX (``models/encoder.py:145-150``). With ``pos_ref`` (the ref modes)
    the attention takes its plain products, never the kernel.

    ``seq_shard`` (``parallel/sequence.SeqShard``): x is one rank's time
    shard of a sequence-parallel forward; the attention gathers K and V
    over the seq group, and the conv module reads the halo its depthwise
    kernel needs from the neighbouring shards (the conv cache returned is
    then meaningless). Everything else is per frame.

    ``model_shard`` (``parallel/tensor.ModelShard``): the attention runs
    this rank's heads and the FFNs its hidden columns, each joined over
    "model"; x, the LayerNorms and the conv module (its kernel included)
    stay whole on every rank of the model group."""
    def drop(t):
        return layers.dropout(gen, t, cfg.dropout, deterministic)

    x = _ffn_residual(p["norm_ff_macaron"], p["feed_forward_macaron"], x, cfg, gen,
                      deterministic, model_shard)
    y = layers.layer_norm(p["norm_mha"], x)
    y, new_attn_cache = attention.mhsa(
        p["self_attn"], y, y, attn_mask, num_heads=cfg.num_heads,
        pos_emb=pos_emb, rel_positions=rel_positions, pos_ref=pos_ref, use_pallas=use_pallas,
        cache=attn_cache, dropout_rate=cfg.attention_dropout, gen=gen,
        deterministic=deterministic,
        kv_gather=seq_shard.gather_kv if seq_shard is not None else None,
        model_shard=model_shard,
    )
    x = x + drop(y)
    # a time shard's conv reads its halo: the window, cropped afterwards
    xc, conv_mask = (x, pad_mask) if seq_shard is None else seq_shard.window(x)
    if (use_pallas_conv and deterministic and conv_cache is None
            and cfg.conv_norm == "layer_norm" and not cfg.causal_conv):
        from ..ops.conv_block import conv_block

        lengths = (
            conv_mask.sum(dim=1, dtype=torch.int32)
            if conv_mask is not None
            else torch.full((xc.shape[0],), xc.shape[1], dtype=torch.int32, device=x.device)
        )
        x, conv_cache = conv_block(
            xc, lengths, p["norm_conv"], p["conv_module"], kernel_size=cfg.kernel_size
        )
        if seq_shard is not None:
            x = seq_shard.crop(x)
    else:
        y, conv_cache = convolution.conv_module(
            p["conv_module"], layers.layer_norm(p["norm_conv"], xc), conv_mask,
            kernel_size=cfg.kernel_size, norm_type=cfg.conv_norm, causal=cfg.causal_conv,
            cache=conv_cache,
        )
        if seq_shard is not None:
            y = seq_shard.crop(y)
        x = x + drop(y)
    x = _ffn_residual(p["norm_ff"], p["feed_forward"], x, cfg, gen, deterministic, model_shard)
    x = layers.layer_norm(p["norm_final"], x)
    return x, new_attn_cache, conv_cache


def _embed(p: Params, feats: torch.Tensor, cfg: ModelConfig):
    """Subsample and attach positions at offset 0, as the JAX ``_embed``:
    (x [B,T',D], pos_emb, rel_positions, pos_ref), each None where the
    mode has none. "ref_batch": pos_ref = pe[0:B] [B,1,D]; "ref_abs":
    pe[0:T'] [1,T',D]; absolute: the table's rows 0..T'-1 added to x in
    its dtype."""
    x = convolution.subsampling(p["embed"], feats)
    b, t = x.shape[:2]
    pos = torch.arange(t, device=x.device)
    if not cfg.use_relative:
        pe = embedding.absolute_pos_embed(p["pos_table"], 0, t).to(x.dtype)
        return x + pe[None], None, None, None
    if cfg.rel_mode == "ref_batch":
        pos_ref = embedding.abs_pos_vectors(torch.arange(b, device=x.device), cfg.encoder_dim)
        return x, None, None, pos_ref[:, None, :]
    if cfg.rel_mode == "ref_abs":
        return x, None, None, embedding.abs_pos_vectors(pos, cfg.encoder_dim)[None]
    rel_positions = (pos, pos)
    if cfg.rel_mode == "decomposed":
        return x, None, rel_positions, None
    pos_emb = embedding.relative_pos_embed(p["pos_table"], t, t)
    return x, pos_emb, rel_positions if cfg.use_pallas_attention else None, None


def _checkpointed(layer, lp: Params, x: torch.Tensor,
                  gen: torch.Generator | None) -> torch.Tensor:
    """``layer(lp, x, gen)`` under ``torch.utils.checkpoint``: its
    activations are dropped and recomputed in the backward. The recompute
    must draw the masks and the attention kernel's seed of the first run,
    and ``torch.utils.checkpoint`` restores only the default generators,
    not ``gen``. So both runs draw from a generator of their own set to
    ``gen``'s state at entry, and ``gen`` then takes that generator's
    state at the end of the first run: the stream of draws is the one
    without remat."""
    if gen is None:
        return checkpoint(layer, lp, x, None, use_reentrant=False)
    start = gen.get_state()
    end: list[torch.Tensor] = []

    def run(lp, x):
        g = torch.Generator(device=gen.device)
        g.set_state(start)
        y = layer(lp, x, g)
        if not end:
            end.append(g.get_state())
        return y

    y = checkpoint(run, lp, x, use_reentrant=False)
    gen.set_state(end[0])
    return y


def encoder_forward(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    cmvn: Params | None = None,
    decoding_chunk_size: int = 0,
    num_decoding_left_chunks: int = -1,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    deterministic: bool = True,
    model_shard=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-utterance forward. feats [B, T, F], feat_lengths [B] ->
    (encoder_out [B, T', D], pad_mask bool [B, T'] True = valid).

    Deterministic: full context, or a static chunk mask when
    ``cfg.static_chunk_size > 0``; ``decoding_chunk_size`` is ignored
    there, as in JAX, which reads it only under live dynamic chunks.
    Training (``deterministic=False``): dropout draws from ``gen`` (on the
    feats' device) and, with ``cfg.use_dynamic_chunk``, the chunk mask is
    full context when ``decoding_chunk_size`` < 0, chunks of
    ``decoding_chunk_size`` with ``num_decoding_left_chunks`` when it is >
    0, and otherwise drawn once per batch on the host generator
    ``host_gen``. With ``cfg.remat``, and only while autograd records,
    each layer is recomputed in the backward (``_checkpointed``).
    ``model_shard``: tensor parallelism over "model" (``encoder_layer``)."""
    x, pos_emb, rel_positions, pos_ref = _embed(p, input_feats(feats, cfg, cmvn), cfg)
    pad_mask, attn_mask = encoder_masks(
        feat_lengths, x.shape[1], cfg, deterministic=deterministic,
        decoding_chunk_size=decoding_chunk_size,
        num_decoding_left_chunks=num_decoding_left_chunks, host_gen=host_gen)

    def layer(lp, x, g):
        return encoder_layer(
            lp, x, attn_mask, pos_emb, pad_mask, cfg, rel_positions=rel_positions,
            pos_ref=pos_ref, use_pallas=cfg.use_pallas_attention,
            use_pallas_conv=cfg.use_pallas_conv, gen=g, deterministic=deterministic,
            model_shard=model_shard,
        )[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.encoder_num_layers):
        lp = layer_params(p["layers"], i)
        x = _checkpointed(layer, lp, x, gen) if remat else layer(lp, x, gen)
    return layers.layer_norm(p["after_norm"], x), pad_mask


def input_feats(feats: torch.Tensor, cfg: ModelConfig, cmvn: Params | None) -> torch.Tensor:
    """The features the subsampling takes: CMVN'd when ``cmvn`` is given,
    in the compute dtype."""
    from . import cmvn as cmvn_mod

    if cmvn is not None:
        feats = cmvn_mod.global_cmvn(cmvn, feats)
    return feats.to(getattr(torch, cfg.compute_dtype))


def encoder_masks(
    feat_lengths: torch.Tensor,
    t: int,
    cfg: ModelConfig,
    *,
    deterministic: bool,
    decoding_chunk_size: int = 0,
    num_decoding_left_chunks: int = -1,
    host_gen: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pad_mask [B, t], attn_mask [B, t, t]) of ``encoder_forward`` at
    ``t`` subsampled frames; a training forward's dynamic chunk is drawn
    here, on ``host_gen``."""
    pad_mask = masks.make_non_pad_mask(masks.subsampled_lengths(feat_lengths), t)
    dynamic = None
    if cfg.use_dynamic_chunk and not deterministic:
        if decoding_chunk_size < 0:
            dynamic = (t, -1)
        elif decoding_chunk_size > 0:
            dynamic = (decoding_chunk_size, num_decoding_left_chunks)
        elif host_gen is None:
            raise ValueError("dynamic chunk training needs a host torch.Generator")
        else:
            dynamic = masks.sample_dynamic_chunk(host_gen, t, cfg.use_dynamic_left_chunk)
    attn_mask = masks.make_attn_mask(
        pad_mask, static_chunk_size=cfg.static_chunk_size,
        num_decoding_left_chunks=num_decoding_left_chunks, dynamic_chunk=dynamic,
    ).contiguous()
    return pad_mask, attn_mask


# ------------------------------------------------------------- streaming


def init_encoder_state(cfg: ModelConfig, batch: int, cache_size: int, dtype=None,
                       device=None) -> EncoderState:
    """Fresh streaming state with an attention cache of ``cache_size``
    subsampled frames; the caches in ``dtype`` (default: the compute
    dtype), ``attn_len`` and ``offset`` int32."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    n_layers, h, dk = cfg.encoder_num_layers, cfg.num_heads, cfg.head_dim
    kv = (n_layers, batch, h, cache_size, dk)
    return EncoderState(
        attn_k=torch.zeros(kv, dtype=dtype, device=device),
        attn_v=torch.zeros(kv, dtype=dtype, device=device),
        attn_len=torch.zeros(batch, dtype=torch.int32, device=device),
        conv_cache=torch.zeros((n_layers, batch, cfg.kernel_size - 1, cfg.encoder_dim),
                               dtype=dtype, device=device),
        offset=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def encoder_forward_chunk(
    p: Params,
    chunk_feats: torch.Tensor,
    state: EncoderState,
    cfg: ModelConfig,
    *,
    cmvn: Params | None = None,
) -> tuple[torch.Tensor, EncoderState]:
    """One chunk of raw feature frames [B, Tc_in, F] (Tc_in = 4 (chunk - 1)
    + 7 for ``chunk`` subsampled frames) -> (chunk_out [B, Tc, D], new
    state). Queries attend to every valid cache slot of their row and to
    the whole chunk. Relative positions: queries at C + i, keys at j over
    the C cache slots and the chunk (the kernel and the decomposed bias),
    or the table slice for (Tc, C + Tc) (skew). The ref modes: key j of
    row b at absolute position offset[b] - C + j (negative before the
    stream's start); absolute positions: row b's frames at offset[b] + i,
    clipped to the table."""
    chunk_feats = input_feats(chunk_feats, cfg, cmvn)
    cache_size = state.attn_k.shape[3]
    x = convolution.subsampling(p["embed"], chunk_feats)
    q_len = x.shape[1]
    k_len = cache_size + q_len
    j = torch.arange(k_len, device=x.device)
    rel_positions = pos_emb = pos_ref = None
    if not cfg.use_relative:
        idx = (state.offset[:, None] + torch.arange(q_len, device=x.device)[None, :]).clamp(
            0, p["pos_table"].shape[0] - 1)
        x = x + p["pos_table"][idx.long()].to(x.dtype)
    elif cfg.rel_mode in ("ref_abs", "ref_batch"):
        pos_idx = state.offset[:, None] - cache_size + j[None, :]          # [B, k_len]
        pos_ref = embedding.abs_pos_vectors(pos_idx.reshape(-1), cfg.encoder_dim).reshape(
            x.shape[0], k_len, cfg.encoder_dim)
    elif cfg.rel_mode == "decomposed" or cfg.use_pallas_attention:
        rel_positions = (cache_size + torch.arange(q_len, device=x.device), j)
    else:
        pos_emb = embedding.relative_pos_embed(p["pos_table"], q_len, k_len)
    caches = [AttnCache(k=state.attn_k[i], v=state.attn_v[i], length=state.attn_len)
              for i in range(cfg.encoder_num_layers)]
    attn_mask = attention.cache_valid_mask(caches[0], q_len).contiguous()
    new_k, new_v, new_conv = [], [], []
    for i, cache in enumerate(caches):
        x, attn, conv = encoder_layer(
            layer_params(p["layers"], i), x, attn_mask, pos_emb, None, cfg,
            rel_positions=rel_positions, pos_ref=pos_ref, attn_cache=cache,
            conv_cache=state.conv_cache[i],
            use_pallas=cfg.use_pallas_attention,
        )
        new_k.append(attn.k)
        new_v.append(attn.v)
        new_conv.append(conv)
    new_state = EncoderState(
        attn_k=torch.stack(new_k), attn_v=torch.stack(new_v),
        attn_len=torch.clamp(state.attn_len + q_len, max=cache_size),
        conv_cache=torch.stack(new_conv), offset=state.offset + q_len,
    )
    return layers.layer_norm(p["after_norm"], x), new_state


def chunk_window_params(decoding_chunk_size: int) -> tuple[int, int, int]:
    """(stride, window, context) in raw frames for a chunk of
    ``decoding_chunk_size`` subsampled frames: subsampling x4, context 7."""
    subsampling_rate, context = 4, 7
    stride = subsampling_rate * decoding_chunk_size
    window = (decoding_chunk_size - 1) * subsampling_rate + context
    return stride, window, context


def encoder_forward_chunk_by_chunk(
    p: Params,
    feats: torch.Tensor,
    cfg: ModelConfig,
    *,
    decoding_chunk_size: int,
    num_decoding_left_chunks: int = -1,
    cmvn: Params | None = None,
    max_cache_size: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked forward of whole utterances feats [B, T, F] by a Python
    loop over windows -> (out [B, T', D], pad_mask all True). The cache
    holds ``decoding_chunk_size * num_decoding_left_chunks`` frames, or
    ``max_cache_size`` when the left chunks are unlimited (< 0)."""
    stride, window, context = chunk_window_params(decoding_chunk_size)
    if num_decoding_left_chunks >= 0:
        cache_size = decoding_chunk_size * num_decoding_left_chunks
    else:
        cache_size = max_cache_size
    state = init_encoder_state(cfg, feats.shape[0], cache_size, device=feats.device)
    outs = []
    for cur in range(0, feats.shape[1] - context + 1, stride):
        y, state = encoder_forward_chunk(p, feats[:, cur:cur + window], state, cfg, cmvn=cmvn)
        outs.append(y)
    out = torch.cat(outs, dim=1)
    return out, torch.ones(out.shape[:2], dtype=torch.bool, device=out.device)
