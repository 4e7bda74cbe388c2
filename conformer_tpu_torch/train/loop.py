"""Training step (JAX ``train/loop.py`` ``Trainer.__init__`` and
``train_step``) on one card.

A step takes ``accum_grad`` microbatches: each one's gradients are divided
by their number and summed, then one clipped Adam update runs in place on
the device (``train/optimizer.py``). The step syncs with the host once, to
read its metrics. ``fit``, ``validate``, checkpoints and the data pipeline
come in later slices.

Each phase of the step (``encoder_fwd``, ``losses_fwd``, ``backward``,
``optimizer``) is a ``torch.profiler`` range, a few microseconds of host
time when no profiler runs; ``scripts/torch_profile_train.py`` reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from ..config import Config, ModelConfig
from ..models import cmvn as cmvn_mod
from ..models import encoder
from ..models.transducer import init_transducer, transducer_losses
from ..params import tree_map
from ..serve.runner import resolve_device
from .optimizer import is_trainable, leaf_paths, make_optimizer

_METRICS = ("loss", "loss_ctc", "loss_rnnt")


class Trainer:
    """Params (``init_transducer`` from ``cfg.train.seed``, or ``params``: a
    tree of tensors or arrays in the JAX layout, which the trainer copies
    to its device and then owns), the optimizer state, a generator on the
    device for dropout and one on the host for the dynamic chunk masks.
    Runs on the card unless ``device="cpu"``; raises when CUDA is asked
    for and absent. ``phase_end``, when set, is called with each phase's
    name as the phase closes (a profile synchronizes there, so that each
    phase's kernels run inside its range)."""

    def __init__(self, cfg: Config, params: Any = None, device=None):
        if cfg.train.remat or cfg.model.remat:
            raise NotImplementedError("remat is not ported yet (ROADMAP.md queue A)")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_transducer(cfg.model, cfg.train.seed, self.device)
        else:
            params = tree_map(
                lambda a: torch.as_tensor(a, dtype=torch.float32).clone().to(self.device), params)
        if cfg.data.cmvn_path:
            params["cmvn"] = cmvn_mod.init_cmvn_from_file(cfg.data.cmvn_path, self.device)
        self.params = params
        self.trainable = [(k, v) for k, v in leaf_paths(params) if is_trainable(k)]
        for k, v in leaf_paths(params):
            v.requires_grad_(is_trainable(k))
        self.optimizer, self.lr_schedule = make_optimizer(cfg.train)
        self.opt_state = self.optimizer.init(params)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.train.seed + 1)
        self.host_gen = torch.Generator().manual_seed(cfg.train.seed + 2)
        self.step = 0
        self.phase_end: Callable[[str], None] | None = None

    @contextlib.contextmanager
    def _phase(self, name: str):
        with torch.profiler.record_function(name):
            yield
            if self.phase_end is not None:
                self.phase_end(name)

    def _batch(self, b: dict) -> dict:
        return {k: torch.as_tensor(b[k], device=self.device)
                for k in ("feats", "feat_lengths", "labels", "label_lengths")}

    def compute_grads(self, batch: dict, *, deterministic: bool = False,
                      model_cfg: ModelConfig | None = None) -> tuple[dict, dict]:
        """({path: gradient} of the trainable leaves, the forward's output)
        of one microbatch {feats, feat_lengths, labels, label_lengths};
        ``model_cfg`` replaces ``cfg.model`` (e.g. to take the plain path)."""
        cfg, p = model_cfg or self.cfg.model, self.params
        with self._phase("encoder_fwd"):    # transducer_forward, in two phases
            b = self._batch(batch)
            enc, mask = encoder.encoder_forward(
                p["encoder"], b["feats"], b["feat_lengths"], cfg, cmvn=p.get("cmvn"),
                gen=self.gen, host_gen=self.host_gen, deterministic=deterministic)
        with self._phase("losses_fwd"):
            out = transducer_losses(p, enc, mask, b["feat_lengths"], b["labels"],
                                    b["label_lengths"], cfg, gen=self.gen,
                                    deterministic=deterministic)
        with self._phase("backward"):
            leaves = [v for _, v in self.trainable]
            grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(self.trainable, grads)}
        return grads, out

    def train_step(self, microbatches: list[dict]) -> dict:
        """One optimizer step over the microbatches -> {loss, loss_ctc,
        loss_rnnt (means over the microbatches), lr (of this update),
        grad_norm (before clipping; finite iff every gradient is)}."""
        n = len(microbatches)
        acc: dict[str, torch.Tensor] = {}
        metrics = []
        for mb in microbatches:
            grads, out = self.compute_grads(mb)
            with self._phase("backward"):    # the accumulation closes it
                for k, g in grads.items():
                    acc[k] = g / n if k not in acc else acc[k] + g / n
            metrics.append(torch.stack([out[m].detach().float() for m in _METRICS]))
        with self._phase("optimizer"):
            lr, norm = self.optimizer.update(self.params, acc, self.opt_state)
        self.step += 1
        host = torch.cat([torch.stack(metrics).mean(dim=0), norm[None]]).tolist()
        return {**dict(zip(_METRICS, host)), "lr": lr, "grad_norm": host[-1]}


def plain_model_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with every kernel flag off: the plain PyTorch path."""
    return dataclasses.replace(cfg, use_pallas_attention=False, use_pallas_conv=False,
                               use_pallas_rnnt=False, use_pallas_ctc=False,
                               use_pallas_joint=False)
