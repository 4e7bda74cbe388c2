"""Transducer model (JAX ``models/transducer.py``): random init, the
inference encoder pass, and the training forward with its losses

    loss = ctc_weight * ctc + transducer_weight * rnnt (+ attention_weight * attn),

where rnnt is the full-lattice transducer loss (its joint through the
fused joint kernels with ``use_pallas_joint``, ``ops/joint_lattice.py``)
or, with ``use_pruned_loss``, the pruned loss plus ``simple_loss_scale``
times the simple-lattice loss, and attn the attention decoder's
label-smoothed loss (``models/decoder.py``) when the params hold a
``decoder`` and ``attention_weight`` > 0.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..params import tree_map
from ..ops.rnnt import rnnt_loss_fused
from ..ops.rnnt_pruned import rnnt_loss_pruned_full
from . import ctc_head, decoder, encoder, joint, layers, masks, predictor
from .layers import Params


def init_transducer(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters of the JAX ``init_transducer`` shapes (encoder,
    predictor, joint, the CTC head, with ``use_pruned_loss`` the
    simple-lattice projections, with ``decoder_num_layers`` > 0 the
    attention decoder, and its R2L half when ``reverse_weight`` > 0),
    drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``.
    The values differ from ``jax.random``'s for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    p = {
        "encoder": encoder.init_encoder(gen, cfg),
        "predictor": predictor.init_predictor(gen, cfg),
        "joint": joint.init_joint(gen, cfg),
        "ctc": {"ctc_lo": layers.init_dense(gen, cfg.encoder_dim, cfg.vocab_size)},
    }
    if cfg.use_pruned_loss:
        p["simple_am_proj"] = layers.init_dense(gen, cfg.encoder_dim, cfg.vocab_size)
        p["simple_lm_proj"] = layers.init_dense(gen, cfg.predictor_dim, cfg.vocab_size)
    if cfg.decoder_num_layers > 0:
        r_layers = cfg.decoder_num_layers if cfg.reverse_weight > 0 else 0
        p["decoder"] = decoder.init_bi_decoder(gen, cfg, r_layers)
    return tree_map(lambda t: t.to(device), p)


def transducer_forward(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    deterministic: bool = False,
    model_shard=None,
) -> dict:
    """Training forward: feats [B, T, F], feat_lengths [B], labels [B, U]
    (padded with 0 or ignore_id), label_lengths [B] -> {loss, loss_ctc,
    loss_rnnt, encoder_out, encoder_out_lens}, plus loss_simple and the
    band starts s_begin [B, T'] with ``use_pruned_loss``.

    Dropout draws from ``gen`` (on the feats' device), the dynamic chunk
    from the host generator ``host_gen``. Rows with feat_length 0 are
    bucket-padding dummies: they count in no loss. The transducer losses
    are means over the valid rows; the lattice DPs take
    ``max(encoder_out_lens, 1)`` frames. ``model_shard``
    (``parallel/tensor.py``): params split over "model" by
    ``parallel/mesh.model_axis``, this rank's shards."""
    encoder_out, encoder_mask = encoder.encoder_forward(
        p["encoder"], feats, feat_lengths, cfg, cmvn=p.get("cmvn"), gen=gen,
        host_gen=host_gen, deterministic=deterministic, model_shard=model_shard,
    )
    return transducer_losses(p, encoder_out, encoder_mask, feat_lengths, labels,
                             label_lengths, cfg, gen=gen, deterministic=deterministic,
                             model_shard=model_shard)


def transducer_losses(
    p: Params,
    encoder_out: torch.Tensor,
    encoder_mask: torch.Tensor,
    feat_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    gen: torch.Generator | None = None,
    deterministic: bool = False,
    n_valid: torch.Tensor | None = None,
    row_share: float = 1.0,
    model_shard=None,
) -> dict:
    """The part of ``transducer_forward`` after the encoder: predictor,
    joint projections, the transducer and CTC losses and, when the params
    hold a decoder and ``attention_weight`` > 0, the attention loss
    (reported as loss_attn).

    Data parallelism: each rank holds a part of the global batch and
    passes ``n_valid``, the global batch's valid rows, by which the
    transducer losses divide (JAX's global masked mean); the CTC loss is a
    sum over rows, and the attention loss's mean over this rank's rows is
    scaled by ``row_share``, its share of the global batch's rows. The
    ranks' losses then sum to the global batch's.

    Tensor parallelism (``model_shard``): the predictor's embedding, the
    CTC head, the joint's ffn_out and the decoder's self-attention and
    FFNs run this rank's shards; every loss comes out whole and the same
    on every rank of the model group."""
    encoder_out_lens = encoder_mask.sum(dim=1, dtype=torch.int32)
    labels_in = masks.add_blank(labels, cfg.blank_id, cfg.ignore_id)
    pred_out = predictor.predictor_forward(p["predictor"], labels_in, cfg, gen=gen,
                                           deterministic=deterministic,
                                           model_shard=model_shard)
    enc_proj, pred_proj = joint.joint_project(p["joint"], encoder_out, pred_out)
    rnnt_text = torch.where(labels == cfg.ignore_id, cfg.blank_id, labels).to(torch.int32)
    row_valid = feat_lengths > 0
    n_valid = (row_valid.float().sum() if n_valid is None else n_valid).clamp_min(1.0)
    t_lens = encoder_out_lens.clamp_min(1)
    u_lens = label_lengths.to(torch.int32)
    impl = "kernel" if cfg.use_pallas_rnnt else "plain"
    w_out, b_out = p["joint"]["ffn_out"]["kernel"], p["joint"]["ffn_out"]["bias"]

    def masked_mean(nll):
        return torch.where(row_valid, nll, 0.0).sum() / n_valid

    out: dict = {}
    if cfg.use_pruned_loss:
        am = layers.dense(p["simple_am_proj"], encoder_out)
        lm = layers.dense(p["simple_lm_proj"], pred_out)
        simple_nll, pruned_nll, s_begin = rnnt_loss_pruned_full(
            am, lm, enc_proj, pred_proj, w_out, b_out, rnnt_text, t_lens, u_lens,
            s_range=cfg.prune_range, blank=cfg.blank_id, lattice_impl=impl,
            simple_impl=impl, t_chunk=cfg.rnnt_t_chunk, model_shard=model_shard,
        )
        out["loss_simple"] = masked_mean(simple_nll)
        out["s_begin"] = s_begin
        loss_rnnt = masked_mean(pruned_nll) + cfg.simple_loss_scale * out["loss_simple"]
    else:
        loss_rnnt = masked_mean(rnnt_loss_fused(
            enc_proj, pred_proj, w_out, b_out, rnnt_text, t_lens, u_lens,
            blank=cfg.blank_id, reduction="none", t_chunk=cfg.rnnt_t_chunk,
            lattice_impl=impl, joint_impl="kernel" if cfg.use_pallas_joint else "plain",
            model_shard=model_shard,
        ))
    loss_ctc = ctc_head.ctc_head_loss(
        p["ctc"], encoder_out, t_lens, rnnt_text, label_lengths, cfg, gen=gen,
        deterministic=deterministic, row_valid=row_valid, model_shard=model_shard,
    )
    loss = cfg.ctc_weight * loss_ctc + cfg.transducer_weight * loss_rnnt
    if cfg.attention_weight > 0 and "decoder" in p:
        out["loss_attn"] = row_share * decoder.attention_loss(
            p["decoder"], encoder_out, encoder_mask, rnnt_text, label_lengths, cfg, gen=gen,
            deterministic=deterministic, model_shard=model_shard)
        loss = loss + cfg.attention_weight * out["loss_attn"]
    out.update(loss=loss, loss_ctc=loss_ctc, loss_rnnt=loss_rnnt, encoder_out=encoder_out,
               encoder_out_lens=encoder_out_lens)
    return out


def encode(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    decoding_chunk_size: int = 0,
    num_decoding_left_chunks: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference encoder pass -> (encoder_out [B, T', D], lengths [B]):
    full context or static-chunk masked (``decoding_chunk_size`` is read
    only by a training forward, as in JAX)."""
    out, mask = encoder.encoder_forward(
        p["encoder"], feats, feat_lengths, cfg, cmvn=p.get("cmvn"),
        decoding_chunk_size=decoding_chunk_size,
        num_decoding_left_chunks=num_decoding_left_chunks,
    )
    return out, mask.sum(dim=1, dtype=torch.int32)
