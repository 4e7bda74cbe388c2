"""Additive RNN-T joint (JAX ``models/joint.py``):
logits = ffn_out(tanh(enc_ffn(h_enc) + pred_ffn(g_pred))).

Decoding applies the three projections itself (``decode/greedy.py``
projects the whole encoder output once and a window of frames per step);
the full-lattice joint of training comes with the training slice.
"""

from __future__ import annotations

from ..config import ModelConfig
from . import layers
from .layers import Params


def init_joint(gen, cfg: ModelConfig) -> Params:
    return {
        "enc_ffn": layers.init_dense(gen, cfg.encoder_dim, cfg.join_dim),
        "pred_ffn": layers.init_dense(gen, cfg.predictor_dim, cfg.join_dim),
        "ffn_out": layers.init_dense(gen, cfg.join_dim, cfg.vocab_size),
    }
