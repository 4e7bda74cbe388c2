"""Analytic model FLOPs of a transducer training step (the port's own copy
of the JAX package's ``train/flops.py``), for a model FLOP rate and its
share of the card's peak.

The matrix and convolution FLOPs of the configured step, counted from the
config and the batch shape:

  - a [m, k] x [k, n] matmul is 2*m*k*n FLOPs;
  - backward = 2x forward (dW and dX each cost one matmul per matmul);
  - recomputation in the backward is NOT credited (it is real device
    work but not model work), the PaLM / "How to Scale Your Model"
    convention;
  - elementwise, norm, softmax and lattice-DP FLOPs are ignored (<< 1 % of
    the matmul FLOPs at these shapes).

The per-component breakdown is returned so that a report can name where
the FLOPs go.
"""

from __future__ import annotations

from typing import Any

from ..config import ModelConfig


def subsampled_len(t: int) -> int:
    """Frames after the x4 conv subsampling (two valid k=3 s=2 convs)."""
    return ((t - 1) // 2 - 1) // 2


def encoder_flops(cfg: ModelConfig, batch: int, frames: int) -> dict[str, float]:
    """Forward FLOPs of the Conformer encoder on [B, frames, input_dim]."""
    b, d, ffn, k = batch, cfg.encoder_dim, cfg.hidden_dim, cfg.kernel_size
    t1 = (frames - 1) // 2  # after conv1
    tp = subsampled_len(frames)
    f1 = (cfg.input_dim - 1) // 2
    f2 = ((cfg.input_dim - 1) // 2 - 1) // 2

    # Subsampling: conv1 (1->d, 3x3, valid, s=2), conv2 (d->d), linear proj.
    sub = (
        2 * 9 * 1 * d * b * t1 * f1
        + 2 * 9 * d * d * b * tp * f2
        + 2 * (d * f2) * d * b * tp
    )

    n_tok = b * tp
    # Macaron FFNs: two per layer, each two matmuls d<->ffn.
    ffn_f = 2 * (2 * d * ffn + 2 * ffn * d) * n_tok
    # MHSA: QKV+O projections; rel-pos adds the pos projection (skew and
    # decomposed modes both cost one extra dxd apply per token).
    proj_f = (4 + (1 if cfg.use_relative else 0)) * 2 * d * d * n_tok
    # scores QK^T and context AV: 2 * [tp, d] x [d, tp] per head-set.
    attn_f = 2 * 2 * b * tp * tp * d
    # Conv module: pw expand d->2d (GLU), depthwise k, pw project d->d.
    conv_f = (2 * d * 2 * d + 2 * k * d + 2 * d * d) * n_tok

    L = cfg.encoder_num_layers
    return {
        "subsampling": float(sub),
        "ffn": float(L * ffn_f),
        "attn_proj": float(L * proj_f),
        "attn_scores": float(L * attn_f),
        "conv_module": float(L * conv_f),
    }


def transducer_step_flops(
    cfg: ModelConfig, batch: int, frames: int, u: int, *, fwd_bwd: bool = True
) -> dict[str, Any]:
    """FLOPs of one transducer_forward (+backward) on a [B, frames] x [B, u]
    batch. Returns {"total": float, "breakdown": {component: flops}}.
    """
    b = batch
    tp = subsampled_len(frames)
    u1 = u + 1
    d, j, v = cfg.encoder_dim, cfg.join_dim, cfg.vocab_size
    pd, ph = cfg.predictor_dim, cfg.predictor_hidden_size

    parts = encoder_flops(cfg, batch, frames)

    # Predictor LSTM: per step, 4 gates of [in+h] x h; input = embed size
    # for layer 0, h after. Plus the output projection h -> pd.
    lstm = 0.0
    in_dim = cfg.predictor_embed_size
    for _ in range(cfg.predictor_num_layers):
        lstm += 2 * 4 * (in_dim + ph) * ph * b * u1
        in_dim = ph
    lstm += 2 * ph * pd * b * u1
    parts["predictor"] = float(lstm)

    # Joint: enc/pred projections into J, then the lattice output matmul
    # J x V per (t, u) cell — the FLOPs hotspot of the whole step.
    parts["joint_proj"] = float(2 * d * j * b * tp + 2 * pd * j * b * u1)
    if cfg.use_pruned_loss:
        # simple-loss projections over V + pruned joint over s_range cells.
        parts["pruned_simple"] = float(2 * d * v * b * tp + 2 * pd * v * b * u1)
        parts["joint_out"] = float(2 * j * v * b * tp * cfg.prune_range)
    else:
        parts["joint_out"] = float(2 * j * v * b * tp * u1)

    parts["ctc_head"] = float(2 * d * v * b * tp)

    if cfg.attention_weight > 0 and cfg.decoder_num_layers > 0:
        dl = cfg.decoder_num_layers * (1 + (cfg.reverse_weight > 0))
        dh = cfg.decoder_hidden_dim
        # self-attn + cross-attn projections + FFN + output vocab proj
        dec = dl * (
            8 * d * d * b * u1          # self QKVO
            + 8 * d * d * b * u1        # cross QKVO (keys over tp amortized)
            + 2 * 2 * b * u1 * u1 * d   # self scores+AV
            + 2 * 2 * b * u1 * tp * d   # cross scores+AV
            + 2 * (2 * d * dh) * b * u1  # FFN
        ) + 2 * d * v * b * u1
        parts["att_decoder"] = float(dec)

    mult = 3.0 if fwd_bwd else 1.0
    parts = {k: v_ * mult for k, v_ in parts.items()}
    return {"total": float(sum(parts.values())), "breakdown": parts}
