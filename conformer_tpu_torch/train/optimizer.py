"""Adam + WarmupLR + global-norm clip (JAX ``train/optimizer.py``, optax).

    lr(step) = base_lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5), s = step+1

is stepped once per optimizer update, and the first update uses lr(0).
The update is optax's ``chain(clip_by_global_norm, adam)``: the norm covers
the trainable leaves only, and a gradient is scaled by max_norm / norm
when norm >= max_norm (no epsilon, unlike ``clip_grad_norm_``).

Frozen leaves (the sinusoid ``pos_table``, batch-norm statistics, the
CMVN statistics) do not change. The JAX package means the same but wraps
the chain in ``optax.masked``, which passes a masked leaf's raw gradient
through as its update, so there ``pos_table`` moves by its gradient on
every step (ROADMAP.md queue C). The port follows the documented intent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..config import TrainConfig

_FROZEN_KEYS = ("pos_table", "cmvn")
_FROZEN_SUFFIXES = ("norm.mean", "norm.var")


def warmup_lr_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        s = float(step + 1)
        if warmup_steps == 0:
            return base_lr * s ** -0.5
        return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, leaf) of every leaf in order, dict keys and list
    indices joined by '.' as the JAX ``trainable_mask`` spells them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(leaf_paths(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def is_trainable(path: str) -> bool:
    return not (any(k in path for k in _FROZEN_KEYS)
                or any(path.endswith(s) for s in _FROZEN_SUFFIXES))


def trainable_mask(params: Any) -> dict[str, bool]:
    """{dotted path: trainable} over every leaf of ``params``."""
    return {path: is_trainable(path) for path, _ in leaf_paths(params)}


@dataclass
class AdamState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class Optimizer:
    """Clip then Adam on the trainable leaves of a params tree; the
    update happens in place, on the device, with no host sync."""

    def __init__(self, cfg: TrainConfig, schedule: Callable[[int], float]):
        self.cfg = cfg
        self.schedule = schedule

    def init(self, params: Any) -> AdamState:
        leaves = [(k, v) for k, v in leaf_paths(params) if is_trainable(k)]
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in leaves},
            nu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in leaves},
        )

    @torch.no_grad()
    def update(self, params: Any, grads: dict[str, torch.Tensor], state: AdamState,
               norm: torch.Tensor | None = None) -> tuple[float, torch.Tensor]:
        """Apply one update from ``grads`` ({path: gradient} of the
        trainable leaves) to ``params`` in place; returns (the lr used,
        the global gradient norm before clipping, on the device). ``norm``,
        when given, is that norm (a pipeline stage holds only some of the
        leaves the norm covers)."""
        cfg = self.cfg
        leaves = {k: v for k, v in leaf_paths(params) if k in state.mu}
        if set(grads) != set(leaves):
            raise ValueError("grads must hold exactly the trainable leaves")
        if norm is None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - cfg.adam_b1 ** state.count
        bc2 = 1.0 - cfg.adam_b2 ** state.count
        for k, p in leaves.items():
            g = grads[k].float()
            g = torch.where(norm < cfg.grad_clip, g, g / norm * cfg.grad_clip)
            mu, nu = state.mu[k], state.nu[k]
            mu.mul_(cfg.adam_b1).add_(g, alpha=1.0 - cfg.adam_b1)
            nu.mul_(cfg.adam_b2).add_(g.square(), alpha=1.0 - cfg.adam_b2)
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
            if cfg.weight_decay > 0:
                step = step + cfg.weight_decay * p.float()
            p.sub_((lr * step).to(p.dtype))
        return lr, norm


def make_optimizer(cfg: TrainConfig) -> tuple[Optimizer, Callable[[int], float]]:
    schedule = warmup_lr_schedule(cfg.lr, cfg.warmup_steps)
    return Optimizer(cfg, schedule), schedule
