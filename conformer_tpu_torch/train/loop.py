"""Training loop (JAX ``train/loop.py``): the step, WER validation in each
of JAX's five decode modes, ``fit`` over the host data pipeline, and
checkpoints, in one process or in several (one per card).

A step takes ``accum_grad`` microbatches: each one's gradients are divided
by their number and summed, then one clipped Adam update runs in place on
the device (``train/optimizer.py``). The step syncs with the host once, to
read its metrics (with several data shards, also before each microbatch's
first launch). ``fit`` streams batches from ``data/dataset.py`` through
a background ``Prefetcher``, validates every ``val_check_interval`` steps
(checkpoint ``step_{n}-wer_{x}``), checkpoints at each epoch's end and at
``max_steps``, and resumes from ``train.resume_from``. ``train.remat``
(or ``model.remat``) recomputes each encoder layer in the backward
(``models/encoder.py``).

Several processes (``parallel/``): the ranks form the mesh of
``train.mesh_data`` x ``mesh_seq`` (the time-sharded encoder,
``parallel/sequence.py``) x ``mesh_model`` (tensor parallelism,
``parallel/tensor.py``: each rank holds its shards of the params JAX's
rules split, ``parallel/mesh.model_axis``, and their Adam moments), or
``mesh_data`` x ``mesh_pipe`` (the GPipe encoder,
``parallel/pipeline.py``). Each data shard reads its own part of the
train list. The losses are JAX's masked means over the valid rows of the
*global* batch (its count summed over the data shards, which must present
the same local shape, before the microbatch's first launch), and one
all-reduce a step sums the gradients after the microbatches and before
the clip (a second, over the data group, for a pipeline stage's layers).
Every rank of a seq or pipe group computes the same losses; which
gradients count once, from the group's owner (seq rank 0 on the last
stage), is ``parallel/mesh.owned_leaves``; how the model axis's leaves
sum (a split leaf over the ranks that share its shard, a replicated one
once per model group) is ``parallel/mesh.model_leaves``.
The dynamic chunk's host generator is seeded alike on every rank, so all
draw the same chunk sizes, as JAX draws one for the global batch; the
dropout generator is seeded by rank, with the model coordinate set to 0:
the ranks of a model group draw alike, as their replicated activations
and weights must. ``fit`` runs endless epochs, driven
by ``max_steps``; ``validate`` decodes each rank's shard of the dev set
and sums the counts; ``save`` writes the one-process layout once, from
rank 0.

Each phase of the step (``encoder_fwd``, ``losses_fwd``, ``backward``,
with several processes ``all_reduce``, ``optimizer``) is a
``torch.profiler`` range, a few microseconds of host
time when no profiler runs; ``scripts/torch_profile_train.py`` reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import signal
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, DecodeConfig, ModelConfig
from ..data.dataset import AsrDataset, eval_config
from ..data.tokenizer import Tokenizer, load_vocab
from ..decode.beam_batched import beam_search_batch
from ..decode.ctc_beam_batched import ctc_prefix_beam_decode_batch
from ..decode.ctc_decode import ctc_greedy_decode
from ..decode.greedy import greedy_search_batch
from ..decode.rescoring import attention_rescoring_batch
from ..decode.streaming import streaming_greedy_search
from ..device import resolve_device
from ..models import cmvn as cmvn_mod
from ..models import encoder
from ..models.transducer import encode, init_transducer, transducer_losses
from ..parallel import distributed as pdist
from ..parallel.mesh import (MODEL_PEERS, Mesh, gather_leaf, is_owner, is_stage_leaf,
                             make_mesh, map_tensors, model_leaves, owned_leaves, shard_leaf,
                             shard_params)
from ..parallel.pipeline import (encoder_forward_pipelined, gather_stacked_layers,
                                 make_pipeline_mesh, shard_stacked_layers, stage_layers)
from ..parallel.sequence import encoder_forward_seq, make_seq_mesh
from ..parallel.tensor import ModelShard
from ..params import tree_map
from . import checkpoint as ckpt_mod
from .logging_util import MetricLogger
from .metrics import WordErrorRate
from .optimizer import is_trainable, leaf_paths, make_optimizer

_METRICS = ("loss", "loss_ctc", "loss_rnnt")
DECODE_MODES = ("greedy_rnnt", "beam_rnnt", "greedy_ctc", "prefix_beam_ctc",
                "attention_rescoring")
RANK_SEED_STRIDE = 1_000_003     # dropout generators: seed + 1 + stride * rank


def make_train_state(params, opt_state, step: int = 0) -> dict:
    """The train state a checkpoint holds: {params, opt_state, step}."""
    return {"params": params, "opt_state": opt_state, "step": int(step)}


def make_trainer_mesh(tcfg) -> Mesh:
    """JAX's routing (``train/loop.py:63-91``): a pipeline when
    ``mesh_pipe`` > 1 (not with ``mesh_model`` > 1), else the time-sharded
    encoder when ``mesh_seq`` > 1, else data parallelism, each with the
    model axis of ``mesh_model``, over every process."""
    if tcfg.mesh_pipe > 1 and tcfg.mesh_model > 1:
        raise ValueError("mesh_pipe composes with data parallelism; tensor parallelism "
                         "(mesh_model) uses another path — pick one")
    if tcfg.mesh_pipe > 1:
        return make_pipeline_mesh(tcfg.mesh_data, tcfg.mesh_pipe)
    if tcfg.mesh_seq > 1:
        return make_seq_mesh(tcfg.mesh_data, tcfg.mesh_seq, tcfg.mesh_model)
    return make_mesh(tcfg.mesh_data, tcfg.mesh_model)


class Trainer:
    """Params (``init_transducer`` from ``cfg.train.seed``, or ``params``: a
    tree of tensors or arrays in the JAX layout, which the trainer copies
    to its device and then owns), the optimizer state, a generator on the
    device for dropout and one on the host for the dynamic chunk masks, the
    tokenizer of ``data.vocab_path`` and the metric logger. The CMVN
    statistics of ``data.cmvn_path`` go into params that carry none (the
    random init); given params keep their own, as a JAX restore does.
    ``train.remat`` sets ``model.remat`` in ``cfg``, as in JAX.
    Runs on the card unless ``device="cpu"``; raises when CUDA is asked
    for and absent. In a multi-process run (``parallel/distributed.py``)
    the ranks form ``make_trainer_mesh(cfg.train)``; a pipeline stage
    keeps only its layers and their Adam moments, a model rank its shards
    of the split leaves and theirs. ``phase_end``, when set,
    is called with each phase's name as the phase closes (a profile synchronizes there, so that each
    phase's kernels run inside its range)."""

    def __init__(self, cfg: Config, params: Any = None, device=None, *,
                 use_wandb: bool = False):
        if cfg.train.remat and not cfg.model.remat:
            # train.remat is the user's flag; the encoder reads model.remat
            cfg.model.remat = True
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_trainer_mesh(cfg.train)
        self.rank, self.world = pdist.process_index(), pdist.process_count()
        self.pipe = self.mesh.size("pipe") > 1
        self.owner = is_owner(self.mesh)
        self.model_shard = ModelShard(self.mesh) if self.mesh.size("model") > 1 else None
        if self.pipe:
            self.encoder_fn = functools.partial(
                encoder_forward_pipelined, mesh=self.mesh,
                num_microbatches=cfg.train.pipeline_microbatches)
        elif self.mesh.size("seq") > 1:
            self.encoder_fn = functools.partial(encoder_forward_seq, mesh=self.mesh,
                                                model_shard=self.model_shard)
        else:
            self.encoder_fn = functools.partial(encoder.encoder_forward,
                                                model_shard=self.model_shard)
        if params is None:
            params = init_transducer(cfg.model, cfg.train.seed, self.device)
        else:
            params = tree_map(
                lambda a: torch.as_tensor(a, dtype=torch.float32).clone().to(self.device), params)
        if self.pipe:
            params["encoder"]["layers"] = shard_stacked_layers(params["encoder"]["layers"],
                                                               self.mesh)
        if self.model_shard is not None:
            params = shard_params(params, self.mesh)
        if cfg.data.cmvn_path and "cmvn" not in params:
            params["cmvn"] = cmvn_mod.init_cmvn_from_file(cfg.data.cmvn_path, self.device)
        self.params = params
        self.trainable = [(k, v) for k, v in leaf_paths(params) if is_trainable(k)]
        for k, v in leaf_paths(params):
            v.requires_grad_(is_trainable(k))
        self.optimizer, self.lr_schedule = make_optimizer(cfg.train)
        self.opt_state = self.optimizer.init(params)
        self.gen = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 1 + RANK_SEED_STRIDE * self.mesh.rank_at(model=0))
        # the losses' draws: one stream for the ranks of a seq or pipe group,
        # which compute the same losses
        self.loss_gen = self.gen
        if self.mesh.size("seq") * self.mesh.size("pipe") > 1:
            self.loss_gen = torch.Generator(device=self.device).manual_seed(
                cfg.train.seed + 1 + RANK_SEED_STRIDE * (self.world + self.mesh.coord("data")))
        self.host_gen = torch.Generator().manual_seed(cfg.train.seed + 2)
        self.step = 0
        self.phase_end: Callable[[str], None] | None = None
        self.tokenizer: Tokenizer | None = None
        if cfg.data.vocab_path:
            self.tokenizer = Tokenizer(load_vocab(cfg.data.vocab_path),
                                       bpe_model=cfg.data.bpe_model,
                                       split_with_space=cfg.data.split_with_space)
        self.logger = MetricLogger(
            cfg.train.checkpoint_dir, use_wandb=use_wandb and self.rank == 0,
            name="metrics.jsonl" if self.rank == 0 else f"metrics.rank{self.rank}.jsonl")
        self._preempted = False
        self._stop = False          # a SIGTERM on any rank, agreed at the last step

    # ------------------------------------------------------------ train step

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
            n_valid = self._global_valid_rows(batch)
            b = self._batch(batch)
            enc, mask = self.encoder_fn(
                p["encoder"], b["feats"], b["feat_lengths"], cfg, cmvn=p.get("cmvn"),
                gen=self.gen, host_gen=self.host_gen, deterministic=deterministic)
        with self._phase("losses_fwd"):
            out = transducer_losses(p, enc, mask, b["feat_lengths"], b["labels"],
                                    b["label_lengths"], cfg, gen=self.loss_gen,
                                    deterministic=deterministic,
                                    n_valid=n_valid,
                                    row_share=1.0 / self.mesh.size("data"),
                                    model_shard=self.model_shard)
        with self._phase("backward"):
            leaves = [v for _, v in self.trainable]
            grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(self.trainable, grads)}
        return grads, out

    def _global_valid_rows(self, batch: dict) -> torch.Tensor | None:
        """The valid rows (feat_length > 0) of the global batch, summed on
        the host over the data group, before the microbatch's first launch;
        None with one data shard. The ranks' losses add up to the global
        batch's only if every data shard presents the same local shape
        (JAX's contract, which bucket batching meets): the losses divide
        by the rows and the labels' width, and the dynamic chunk is drawn
        from the frames. So the same sum carries each dimension and its
        square, and shards that differ raise ValueError on every rank."""
        d = self.mesh.size("data")
        if d == 1:
            return None
        dims = dict(zip(("rows", "frames"), np.shape(batch["feats"])[:2]),
                    labels=np.shape(batch["labels"])[1])
        local = {"valid": float((torch.as_tensor(batch["feat_lengths"]).cpu() > 0).sum())}
        for k, v in dims.items():
            local[k], local[k + "^2"] = float(v), float(v) ** 2
        tot = pdist.allsum_host_scalars(local, group=self.mesh.group("data"))
        differ = [k for k in dims if d * tot[k + "^2"] != tot[k] ** 2]
        if differ:
            raise ValueError(
                f"the data shards' local batches differ in {differ} (this rank's: {dims}); "
                "their losses would not add up to the global batch's. Every shard must "
                "present the same shapes, as data.batch_type 'bucket' gives")
        return torch.tensor(tot["valid"], device=self.device)

    def step_grads(self, microbatches: list[dict], *, deterministic: bool = False
                   ) -> tuple[dict, torch.Tensor, torch.Tensor | None]:
        """The step's gradients ({path: gradient}, each microbatch's divided
        by their number, summed over the ranks as the module docstring
        says), its metrics [loss, loss_ctc, loss_rnnt] (global means over
        the microbatches) and, in a multi-process run, the global gradient
        norm (one process: None, the optimizer computes it).
        ``deterministic`` turns dropout and the dynamic chunk off."""
        n = len(microbatches)
        acc: dict[str, torch.Tensor] = {}
        metrics = []
        for mb in microbatches:
            grads, out = self.compute_grads(mb, deterministic=deterministic)
            with self._phase("backward"):    # the accumulation closes it
                for k, g in grads.items():
                    acc[k] = g / n if k not in acc else acc[k] + g / n
            metrics.append(torch.stack([out[m].detach().float() for m in _METRICS]))
        metrics = torch.stack(metrics).mean(dim=0)
        if self.world == 1:
            return acc, metrics, None
        with self._phase("all_reduce"):
            return self._reduce(acc, metrics)

    def _reduce(self, acc: dict, metrics: torch.Tensor):
        """The step's all-reduce, by ``mesh.owned_leaves`` and
        ``mesh.model_leaves``: the leaves computed alike across a seq or
        pipe group count from the owner only, the replicated leaves once
        per model group (from model coordinate 0), the metrics from the
        owner at model coordinate 0; every leaf but a stage's layers and
        the model axis's split leaves, the metrics and the SIGTERM flag are
        summed over every rank in one flat buffer; a stage's layers over
        its data group; a split leaf over the ranks that share its shard.
        The norm takes each leaf once: the summed ones, every stage's
        layers and every model rank's shards."""
        once, staged = owned_leaves(self.mesh, list(acc))
        split, rows = model_leaves(self.mesh, acc)
        lead = self.mesh.coord("model") == 0
        zero = set() if self.owner else set(once)
        if not lead:
            zero |= {k for k in acc if k not in split and k not in rows}
        for k in zero:
            acc[k] = torch.zeros_like(acc[k])
        if not (self.owner and lead):
            metrics = torch.zeros_like(metrics)
        shared = [k for k in acc if k not in staged and k not in split]
        flag = torch.tensor([float(self._preempted)], device=metrics.device)
        flat = torch.cat([*(acc[k].reshape(-1) for k in shared), metrics, flag])
        dist.all_reduce(flat)
        parts = flat.split([*(acc[k].numel() for k in shared), metrics.numel(), 1])
        for k, g in zip(shared, parts):
            acc[k] = g.view_as(acc[k])
        metrics, flag = parts[-2], parts[-1]
        sq = sum(acc[k].square().sum() for k in shared)
        if split:
            flat = torch.cat([acc[k].reshape(-1) for k in split])
            if self.mesh.group(MODEL_PEERS) is not None:
                dist.all_reduce(flat, group=self.mesh.group(MODEL_PEERS))
            for k, g in zip(split, flat.split([acc[k].numel() for k in split])):
                acc[k] = g.view_as(acc[k])
            sq_shard = flat.square().sum().reshape(1)
            dist.all_reduce(sq_shard, group=self.mesh.group("model"))
            sq = sq + sq_shard[0]
        if staged:
            flat = torch.cat([acc[k].reshape(-1) for k in staged])
            if self.mesh.size("data") > 1:
                dist.all_reduce(flat, group=self.mesh.group("data"))
            for k, g in zip(staged, flat.split([acc[k].numel() for k in staged])):
                acc[k] = g.view_as(acc[k])
            sq_stage = flat.square().sum().reshape(1)
            dist.all_reduce(sq_stage, group=self.mesh.group("pipe"))
            sq = sq + sq_stage[0]
        self._stop_flag = flag
        return acc, metrics, torch.sqrt(sq)

    def train_step(self, microbatches: list[dict]) -> dict:
        """One optimizer step over the microbatches -> {loss, loss_ctc,
        loss_rnnt (means over the microbatches), lr (of this update),
        grad_norm (before clipping; finite iff every gradient is)}."""
        acc, metrics, norm = self.step_grads(microbatches)
        with self._phase("optimizer"):
            lr, norm = self.optimizer.update(self.params, acc, self.opt_state, norm=norm)
        self.step += 1
        flag = [self._stop_flag] if self.world > 1 else []
        host = torch.cat([metrics, norm[None], *flag]).tolist()    # the step's one sync
        self._stop = bool(flag) and host[4] > 0
        return {**dict(zip(_METRICS, host)), "lr": lr, "grad_norm": host[3]}

    # ------------------------------------------------------------ validation

    def validate(self, dataset: AsrDataset, max_batches: int | None = None) -> float:
        """Decode ``dataset`` (at most ``max_batches``) -> WER; the (key,
        prediction, truth) triples go to ``<checkpoint_dir>/tmp_prediction.txt``.
        Each batch is encoded and searched in ``decode.mode`` as JAX's
        ``_decode_fn`` does (``decode_search``, the top row of the beams);
        with ``decode.streaming`` the decode is ``streaming_greedy_search``
        at ``decode.decoding_chunk_size`` and ``num_decoding_left_chunks``,
        whatever ``decode.mode`` says, as in JAX. Otherwise an unknown mode
        raises ValueError before any batch, and ``attention_rescoring``
        without a decoder in the params raises ValueError.

        Several processes: each decodes ``dataset``, its own shard
        (``eval_shard``), with the whole params (a pipeline's stages and
        the model axis's shards gathered), writes ``tmp_prediction.rank{r}.txt``, and the error and
        word counts are summed over the ranks before the WER."""
        dcfg, mcfg = self.cfg.decode, self.cfg.model
        if not dcfg.streaming:
            check_mode(dcfg.mode)
        params = self.full_params()
        wer = WordErrorRate()
        os.makedirs(self.cfg.train.checkpoint_dir, exist_ok=True)
        name = "tmp_prediction.txt" if self.world == 1 else f"tmp_prediction.rank{self.rank}.txt"
        out_path = os.path.join(self.cfg.train.checkpoint_dir, name)
        with open(out_path, "w") as out_stream, torch.inference_mode():
            for bi, b in enumerate(dataset):
                if max_batches is not None and bi >= max_batches:
                    break
                feats = torch.as_tensor(b["feats"], device=self.device)
                lens = torch.as_tensor(b["feat_lengths"], device=self.device)
                if dcfg.streaming:
                    hyps, hyp_lens = streaming_greedy_search(
                        params, feats, lens, mcfg,
                        decoding_chunk_size=dcfg.decoding_chunk_size,
                        num_decoding_left_chunks=dcfg.num_decoding_left_chunks,
                        n_steps=dcfg.n_steps, max_hyp_len=dcfg.max_hyp_len)
                else:
                    enc, enc_lens = encode(params, feats, lens, mcfg)
                    hyps, hyp_lens = decode_search(params, enc, enc_lens, mcfg, dcfg)
                    if hyps.ndim == 3:                 # a beam: its best row
                        hyps, hyp_lens = hyps[:, 0], hyp_lens[:, 0]
                hyps, hyp_lens = hyps.cpu().numpy(), hyp_lens.cpu().numpy()
                preds = []
                for i, key in enumerate(b["keys"]):
                    ids = hyps[i, : hyp_lens[i]].tolist()
                    text = (self.tokenizer.decode_ids(ids, stop_id=mcfg.sos_eos_id)
                            if self.tokenizer else " ".join(map(str, ids)))
                    preds.append(text)
                    out_stream.write(f"Key: {key}\nPred: {text}\nTruth: {b['transcripts'][i]}\n")
                wer.update(preds, b["transcripts"])
        if self.world > 1:
            counts = pdist.allsum_host_scalars({"errors": wer.errors, "total": wer.total})
            return counts["errors"] / max(counts["total"], 1.0)
        return wer.compute()

    def full_params(self) -> dict:
        """The whole params: a pipeline stage's layers gathered from every
        stage, a model rank's shards from its model group (collectives),
        else the params."""
        if self.model_shard is not None:
            return map_tensors(self.params, lambda k, v: gather_leaf(k, v, self.mesh))
        if not self.pipe:
            return self.params
        layers = gather_stacked_layers(self.params["encoder"]["layers"], self.mesh)
        return {**self.params, "encoder": {**self.params["encoder"], "layers": layers}}

    def eval_shard(self) -> dict:
        """``AsrDataset``'s shard arguments for a dev or test set: one part
        for each rank, since each decodes with the whole params."""
        return {"shard_id": self.rank, "num_shards": self.world}

    # ------------------------------------------------------------------ fit

    def install_preemption_handler(self):
        """On SIGTERM, checkpoint at the next step boundary and leave
        ``fit`` (resumable with ``--resume_from last``). Returns the handler
        it replaced, for the caller to put back."""
        def on_sigterm(signum, frame):
            self._preempted = True

        return signal.signal(signal.SIGTERM, on_sigterm)

    def _maybe_handle_preemption(self) -> bool:
        # several processes: the flag every rank agreed on at the last step
        if not (self._stop if self.world > 1 else self._preempted):
            return False
        path = self.save()
        self.logger.log(self.step, {"preempted": 1.0}, prefix="train_")
        print(f"SIGTERM: checkpointed to {path}; exiting for resume.")
        return True

    def fit(self) -> None:
        """Train from ``data.train_data_list_path`` until ``max_steps`` or
        ``max_epochs``, validating on ``data.dev_data_list_path``. Several
        processes: each data shard reads its part of the train list."""
        cfg = self.cfg
        train_ds = AsrDataset(cfg.data, mode="train", tokenizer=self.tokenizer,
                              shard_id=self.mesh.coord("data"),
                              num_shards=self.mesh.size("data"))
        dev_ds = AsrDataset(eval_config(cfg.data), mode="dev", tokenizer=self.tokenizer,
                            **self.eval_shard())
        if cfg.train.resume_from:
            self.restore(cfg.train.resume_from)
        if cfg.train.num_sanity_val_steps > 0:
            self.validate(dev_ds, max_batches=cfg.train.num_sanity_val_steps)
        stream = self._train_stream(train_ds)
        if cfg.data.prefetch_depth > 0:
            from ..data.prefetch import Prefetcher

            stream = Prefetcher(stream, depth=cfg.data.prefetch_depth)
        try:
            self._fit_loop(stream, train_ds, dev_ds)
        finally:
            if hasattr(stream, "close"):
                stream.close()

    def _fit_loop(self, stream, train_ds: AsrDataset, dev_ds: AsrDataset) -> None:
        """Steps over ``stream``. Every ``log_every`` steps it logs the mean
        metrics and, for the interval: wall seconds, seconds in
        ``train_step``, seconds waiting for the next batch, audio seconds
        trained."""
        cfg = self.cfg
        accum: list[dict] = []
        running: dict[str, float] = {}
        frame_s = cfg.data.frame_shift / 1000.0
        interval = dict(step_s=0.0, data_wait_s=0.0, audio_s=0.0)
        t_interval = time.perf_counter()
        it = iter(stream)
        while True:
            t0 = time.perf_counter()
            try:
                epoch, batch = next(it)
            except StopIteration:
                return
            interval["data_wait_s"] += time.perf_counter() - t0
            if epoch is None:    # the end of an epoch
                self.save()
                continue
            accum.append(batch)
            if len(accum) < cfg.train.accum_grad:
                continue
            t0 = time.perf_counter()
            metrics = self.train_step(accum)
            interval["step_s"] += time.perf_counter() - t0
            interval["audio_s"] += frame_s * sum(float(np.sum(b["feat_lengths"])) for b in accum)
            accum = []
            if self._maybe_handle_preemption():
                return
            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + v
            if self.step % cfg.train.log_every == 0:
                logs = {k: v / cfg.train.log_every for k, v in running.items()}
                if train_ds.padding_stats.total_frames:
                    logs["padding_efficiency"] = train_ds.padding_stats.efficiency
                now = time.perf_counter()
                logs.update(interval, interval_s=now - t_interval)
                self.logger.log(self.step, logs, prefix="train_")
                running = {}
                interval = dict.fromkeys(interval, 0.0)
                t_interval = now
            if self.step % cfg.train.val_check_interval == 0:
                wer = self.validate(dev_ds)
                self.logger.log(self.step, {"wer": wer}, prefix="valid_")
                self.save(wer=wer)
            if self.step >= cfg.train.max_steps:
                self.save()
                return

    def _train_stream(self, train_ds: AsrDataset):
        """(epoch, batch) pairs for ``max_epochs`` epochs; (None, None)
        marks the end of each epoch. Several processes: shards may hold
        different numbers of batches, so epochs run on without end or
        marks and ``max_steps`` ends the run, every rank presenting a
        batch at every step (JAX's contract); an empty shard ends it."""
        if self.world > 1:
            epoch = 0
            while True:
                train_ds.set_epoch(epoch)
                got = False
                for batch in train_ds:
                    got = True
                    yield epoch, batch
                if not got:
                    return
                epoch += 1
        for epoch in range(self.cfg.train.max_epochs):
            train_ds.set_epoch(epoch)
            for batch in train_ds:
                yield epoch, batch
            yield None, None

    # ----------------------------------------------------------- checkpoints

    def save(self, wer: float | None = None) -> str:
        """Checkpoint the train state; returns its path. Several processes:
        every rank must call this; the state is assembled in the
        one-process layout (a pipeline's stages and the model axis's shards
        gathered), rank 0 writes
        it behind a barrier, and the other ranks return ""."""
        opt = self.opt_state
        state = make_train_state(self.params, {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
                                 self.step)
        if self.world == 1:
            return ckpt_mod.save_checkpoint(self.cfg.train.checkpoint_dir, state,
                                            step=self.step, wer=wer,
                                            keep=self.cfg.train.keep_checkpoints)
        host = pdist.gather_tree_to_host(state, self.mesh)
        path = ""
        if self.rank == 0:
            state = tree_map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
                             host)
            path = ckpt_mod.save_checkpoint(self.cfg.train.checkpoint_dir, state,
                                            step=self.step, wer=wer,
                                            keep=self.cfg.train.keep_checkpoints)
        pdist.barrier()
        return path

    def _copy_in(self, dst: dict, src: dict) -> None:
        """Copy a whole tree's leaves ({path: tensor}) into ``dst``'s in
        place; a pipeline stage takes its slice of the stacked layers, a
        model rank its shard of a split leaf."""
        sl = stage_layers(self.cfg.model.encoder_num_layers, self.mesh) if self.pipe else None
        with torch.no_grad():
            for k, v in dst.items():
                w = src[k]
                v.copy_(shard_leaf(k, w[sl] if sl is not None and is_stage_leaf(k) else w,
                                   self.mesh))

    def restore(self, path_or_dir: str) -> None:
        """Load params, optimizer state and step in place from a checkpoint
        file, a directory (its newest checkpoint), or a name under
        ``checkpoint_dir`` such as ``last``."""
        path = path_or_dir
        ckpt_dir = self.cfg.train.checkpoint_dir
        if not os.path.exists(path) and os.path.exists(os.path.join(ckpt_dir, path)):
            path = os.path.join(ckpt_dir, path)
        if os.path.isdir(path):
            path = ckpt_mod.latest_checkpoint(path)
        elif os.path.basename(path) == "last":
            path = ckpt_mod.latest_checkpoint(os.path.dirname(path))
        if path is None or not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at {path_or_dir!r}")
        state = ckpt_mod.restore_checkpoint(path, self.device)
        self._copy_in(dict(leaf_paths(self.params)), dict(leaf_paths(state["params"])))
        opt = state["opt_state"]
        self.opt_state.count = int(opt["count"])
        self._copy_in(self.opt_state.mu, opt["mu"])
        self._copy_in(self.opt_state.nu, opt["nu"])
        self.step = int(state["step"])

    def load_torch_checkpoint(self, path: str) -> None:
        """Copy a reference / WeNet state dict (``.pt``, ``.pth``, or a
        Lightning ``.ckpt``) into the params in place, by JAX's mapping
        (``train/checkpoint.import_torch_checkpoint``); leaves the file
        does not name keep their values."""
        imported = ckpt_mod.import_torch_checkpoint(path, self.full_params(), self.cfg.model)
        self._copy_in(dict(leaf_paths(self.params)), dict(leaf_paths(imported)))


def check_mode(mode: str) -> None:
    if mode not in DECODE_MODES:
        raise ValueError(f"unknown decode.mode {mode!r}: expected greedy_rnnt | beam_rnnt | "
                         "greedy_ctc | prefix_beam_ctc | attention_rescoring")


def decode_search(p, enc: torch.Tensor, enc_lens: torch.Tensor, mcfg: ModelConfig,
                  dcfg: DecodeConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The search of ``dcfg.mode`` on an encoder output, with JAX's
    ``_decode_fn`` settings -> (tokens [B, K, L], lengths [B, K]) for the
    beams (``beam_rnnt``, ``prefix_beam_ctc``; best first), (tokens [B, L],
    lengths [B]) for the others."""
    check_mode(dcfg.mode)
    mode, max_hyp = dcfg.mode, dcfg.max_hyp_len
    top_c = dcfg.prefix_beam_top_c or mcfg.vocab_size
    if mode == "greedy_rnnt":
        return greedy_search_batch(p, enc, enc_lens, mcfg, n_steps=dcfg.n_steps,
                                   max_hyp_len=max_hyp)[:2]
    if mode == "beam_rnnt":
        return beam_search_batch(p, enc, enc_lens, mcfg, beam_size=dcfg.beam_size,
                                 max_hyp_len=max_hyp, max_expansions=dcfg.beam_expansions,
                                 blank_skip_window=dcfg.beam_blank_skip_window)[:2]
    if mode == "greedy_ctc":
        return ctc_greedy_decode(p, enc, enc_lens, mcfg)
    if mode == "prefix_beam_ctc":
        return ctc_prefix_beam_decode_batch(p, enc, enc_lens, mcfg, beam_size=dcfg.beam_size,
                                            max_hyp_len=max_hyp, top_c=top_c)[:2]
    return attention_rescoring_batch(p, enc, enc_lens, mcfg, beam_size=dcfg.beam_size,
                                     ctc_weight=dcfg.rescore_ctc_weight, max_hyp_len=max_hyp,
                                     top_c=top_c)


def plain_model_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with every kernel flag off: the plain PyTorch path."""
    return dataclasses.replace(cfg, use_pallas_attention=False, use_pallas_conv=False,
                               use_pallas_rnnt=False, use_pallas_ctc=False,
                               use_pallas_joint=False)
