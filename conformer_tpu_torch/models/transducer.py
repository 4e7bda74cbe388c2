"""Transducer model: random init and the inference encoder pass (JAX
``models/transducer.py``). The training forward and its losses come with
the training slice.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..params import tree_map
from . import encoder, joint, layers, predictor
from .layers import Params


def init_transducer(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters of the JAX ``init_transducer`` shapes (encoder,
    predictor, joint and the CTC head), drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``.
    The values differ from ``jax.random``'s for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    p = {
        "encoder": encoder.init_encoder(gen, cfg),
        "predictor": predictor.init_predictor(gen, cfg),
        "joint": joint.init_joint(gen, cfg),
        "ctc": {"ctc_lo": layers.init_dense(gen, cfg.encoder_dim, cfg.vocab_size)},
    }
    return tree_map(lambda t: t.to(device), p)


def encode(
    p: Params,
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: ModelConfig,
    *,
    num_decoding_left_chunks: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference encoder pass -> (encoder_out [B, T', D], lengths [B])."""
    out, mask = encoder.encoder_forward(
        p["encoder"], feats, feat_lengths, cfg, cmvn=p.get("cmvn"),
        num_decoding_left_chunks=num_decoding_left_chunks,
    )
    return out, mask.sum(dim=1, dtype=torch.int32)
