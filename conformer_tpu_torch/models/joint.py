"""Additive RNN-T joint (JAX ``models/joint.py``):
logits = ffn_out(tanh(enc_ffn(h_enc) + pred_ffn(g_pred))).

Decoding applies the three projections itself (``decode/greedy.py``
projects the whole encoder output once and a window of frames per step);
training projects with ``joint_project`` and leaves ``ffn_out`` to the
chunked losses (``ops/rnnt.py``, ``ops/rnnt_pruned.py``).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from . import layers
from .layers import Params


def init_joint(gen, cfg: ModelConfig) -> Params:
    return {
        "enc_ffn": layers.init_dense(gen, cfg.encoder_dim, cfg.join_dim),
        "pred_ffn": layers.init_dense(gen, cfg.predictor_dim, cfg.join_dim),
        "ffn_out": layers.init_dense(gen, cfg.join_dim, cfg.vocab_size),
    }


def joint_project(p: Params, enc_out: torch.Tensor, pred_out: torch.Tensor):
    """(enc_ffn(enc_out) [B,T,J], pred_ffn(pred_out) [B,U+1,J])."""
    return layers.dense(p["enc_ffn"], enc_out), layers.dense(p["pred_ffn"], pred_out)
