"""Additive RNN-T joint (JAX ``models/joint.py``):
logits = ffn_out(tanh(enc_ffn(h_enc) + pred_ffn(g_pred))).

Decoding applies the three projections itself (``decode/greedy.py`` and
``decode/beam_batched.py`` project the whole encoder output once);
training projects with ``joint_project`` and leaves ``ffn_out`` to the
chunked losses (``ops/rnnt.py``, ``ops/rnnt_pruned.py``). ``joint_step``
is the host beam's pointwise joint, ``joint_lattice`` the whole [B, T,
U, V] lattice.
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


def joint_lattice(p: Params, enc_out: torch.Tensor, pred_out: torch.Tensor,
                  pre_project: bool = True) -> torch.Tensor:
    """Full lattice logits: enc [B,T,D], pred [B,U,P] -> [B,T,U,V]."""
    if pre_project:
        enc_out, pred_out = joint_project(p, enc_out, pred_out)
    x = enc_out[:, :, None, :] + pred_out[:, None, :, :]
    return layers.dense(p["ffn_out"], torch.tanh(x))


def joint_step(p: Params, enc_frame: torch.Tensor, pred_frame: torch.Tensor,
               pre_project: bool = True) -> torch.Tensor:
    """Pointwise joint for decoding: enc [B, D], pred [B, P] -> [B, V]."""
    if pre_project:
        enc_frame = layers.dense(p["enc_ffn"], enc_frame)
        pred_frame = layers.dense(p["pred_ffn"], pred_frame)
    return layers.dense(p["ffn_out"], torch.tanh(enc_frame + pred_frame))
