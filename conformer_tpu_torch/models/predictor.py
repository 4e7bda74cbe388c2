"""RNN-T prediction network (JAX ``models/predictor.py``): embedding ->
multi-layer LSTM -> projection, as a full-sequence forward (training) and
a single step (decoding).

Gate layout and initialiser follow torch.nn.LSTM (i, f, g, o;
U(-1/sqrt(H), 1/sqrt(H))), with the JAX package's transposed weights
``w_ih`` [I, 4H] and ``w_hh`` [H, 4H].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import ModelConfig
from . import layers
from .layers import Params


class PredictorState(NamedTuple):
    h: torch.Tensor  # [L, B, H]
    c: torch.Tensor  # [L, B, H]


def init_predictor(gen, cfg: ModelConfig) -> Params:
    h = cfg.predictor_hidden_size
    bound = 1.0 / math.sqrt(h)
    rnn = []
    for i in range(cfg.predictor_num_layers):
        in_dim = cfg.predictor_embed_size if i == 0 else h
        rnn.append({
            "w_ih": layers.uniform(gen, (in_dim, 4 * h), bound),
            "w_hh": layers.uniform(gen, (h, 4 * h), bound),
            "b_ih": layers.uniform(gen, (4 * h,), bound),
            "b_hh": layers.uniform(gen, (4 * h,), bound),
        })
    return {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.predictor_embed_size),
        "rnn": rnn,
        "projection": layers.init_dense(gen, h, cfg.predictor_dim),
    }


def init_predictor_state(cfg: ModelConfig, batch: int, device=None) -> PredictorState:
    shape = (cfg.predictor_num_layers, batch, cfg.predictor_hidden_size)
    return PredictorState(
        h=torch.zeros(shape, device=device), c=torch.zeros(shape, device=device)
    )


def _input_gates(lp: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w_ih in float32 from operands in x's dtype; x [..., I]."""
    return torch.matmul(x.float(), lp["w_ih"].to(x.dtype).float())


def _lstm_cell(lp: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               x_gates: torch.Tensor | None = None):
    """One LSTM step, float32 gates; x [B, I], h and c [B, H]. ``x_gates``
    is x's input product when the caller took it for a whole sequence."""
    if x_gates is None:
        x_gates = _input_gates(lp, x)
    gates = (
        x_gates
        + torch.matmul(h.float(), lp["w_hh"].to(h.dtype).float())
        + (lp["b_ih"] + lp["b_hh"])
    )
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c.float() + i * torch.tanh(g)
    h_new = o * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)


def predictor_forward(
    p: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    model_shard=None,
) -> torch.Tensor:
    """Full-sequence forward from a zero state: tokens [B, U] -> [B, U,
    predictor_dim]. In training, dropout (from ``gen``) on the embeddings
    and between LSTM layers, not after the last (torch.nn.LSTM's
    ``dropout``). The input product of each layer is taken for the whole
    sequence at once; the recurrence is a loop over U. ``model_shard``
    (``parallel/tensor.py``): the embedding holds this rank's vocabulary
    rows and is looked up vocabulary-parallel; the rest runs whole."""
    if model_shard is None:
        x = layers.embedding(p["embed"], tokens)
    else:
        x = model_shard.embedding(p["embed"]["embedding"], tokens)
    x = layers.dropout(gen, x, cfg.predictor_embed_dropout, deterministic)
    bsz, u, _ = x.shape
    n = len(p["rnn"])
    for li, lp in enumerate(p["rnn"]):
        x_gates = _input_gates(lp, x)
        h = c = torch.zeros((bsz, cfg.predictor_hidden_size), dtype=x.dtype, device=x.device)
        ys = []
        for t in range(u):
            h, c = _lstm_cell(lp, x[:, t], h, c, x_gates[:, t])
            ys.append(h)
        x = torch.stack(ys, dim=1)
        if li < n - 1:
            x = layers.dropout(gen, x, cfg.predictor_dropout, deterministic)
    return layers.dense(p["projection"], x)


def predictor_step(
    p: Params,
    token: torch.Tensor,
    state: PredictorState,
    cfg: ModelConfig,
    *,
    padding: torch.Tensor | None = None,
) -> tuple[torch.Tensor, PredictorState]:
    """token [B] -> ([B, predictor_dim], new state). Rows with
    ``padding`` != 0 keep their previous (h, c)."""
    x = layers.embedding(p["embed"], token)
    hs, cs = [], []
    for li, lp in enumerate(p["rnn"]):
        h, c = _lstm_cell(lp, x, state.h[li].to(x.dtype), state.c[li].to(x.dtype))
        hs.append(h)
        cs.append(c)
        x = h
    new_h, new_c = torch.stack(hs), torch.stack(cs)
    if padding is not None:
        keep = (padding == 0)[None, :, None]
        new_h = torch.where(keep, new_h, state.h.to(new_h.dtype))
        new_c = torch.where(keep, new_c, state.c.to(new_c.dtype))
    return layers.dense(p["projection"], x), PredictorState(h=new_h, c=new_c)
