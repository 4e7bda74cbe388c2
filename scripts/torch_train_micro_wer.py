#!/usr/bin/env python3
"""Train the PyTorch/CUDA port (``conformer_tpu_torch``) on the micro
corpus and measure the HELD-OUT WER in every decode mode (the port's
counterpart of ``scripts/train_micro_wer.py``, with the same config, sweep
and files).

Corpus: ``conformer_tpu_torch/tools/make_micro_corpus.py``, eval
utterances of novel word orders and novel augmentation. The eval
waveforms are never seen in training, so the WER is a generalization
number (closed vocabulary).

    # build the corpus from a directory of recordings, then train with
    # the pruned RNN-T loss
    python3 scripts/torch_train_micro_wer.py --corpus build/micro --samples DIR \\
        --exp build/micro_pruned --pruned --steps 3000
    # full-lattice RNN-T loss, same data and seed
    python3 scripts/torch_train_micro_wer.py --corpus build/micro --exp build/micro_full
    # the decode-mode sweep on the newest checkpoint of a run
    python3 scripts/torch_train_micro_wer.py --corpus build/micro --exp build/micro_full \\
        --eval-only

Writes ``<exp>/wer_results.json`` (after training, also the run's wall
seconds, ms per step and the first and last 100-step means of the loss)
and the loss curve in ``<exp>/metrics.jsonl``; ``--save-fixture PATH``
writes the trained params as a JAX-layout ``.npz`` (read by either
package's ``load_params_npz``) with ``PATH.meta.json`` beside it. Runs on
the card unless ``--cpu``, with every kernel flag of the model on (the
config is otherwise JAX's, whose flags are off). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from conformer_tpu_torch.config import Config, ModelConfig  # noqa: E402
from conformer_tpu_torch.data.audio import load_audio  # noqa: E402
from conformer_tpu_torch.data.tokenizer import Tokenizer, load_vocab  # noqa: E402
from conformer_tpu_torch.decode.beam_batched import beam_search_batch  # noqa: E402
from conformer_tpu_torch.decode.ctc_beam_batched import (  # noqa: E402
    ctc_prefix_beam_decode_batch,
)
from conformer_tpu_torch.decode.ctc_decode import ctc_greedy_decode  # noqa: E402
from conformer_tpu_torch.decode.greedy import greedy_search_batch  # noqa: E402
from conformer_tpu_torch.decode.rescoring import attention_rescoring_batch  # noqa: E402
from conformer_tpu_torch.models import transducer  # noqa: E402
from conformer_tpu_torch.ops.fbank import fbank_numpy  # noqa: E402
from conformer_tpu_torch.tools.make_micro_corpus import build_micro_corpus  # noqa: E402
from conformer_tpu_torch.train.checkpoint import save_params_npz  # noqa: E402
from conformer_tpu_torch.train.loop import Trainer  # noqa: E402
from conformer_tpu_torch.train.metrics import WordErrorRate  # noqa: E402
from conformer_tpu_torch.train.optimizer import leaf_paths  # noqa: E402

DEFAULT_CORPUS = os.path.join(REPO, "build", "micro")     # build/ is git-ignored


def build_config(meta: dict, exp: str, *, pruned: bool, steps: int,
                 seed: int = 777) -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        input_dim=80,
        vocab_size=meta["vocab_size"],
        sos_eos_id=meta["vocab_size"] - 1,
        encoder_dim=96,
        encoder_num_layers=3,
        num_heads=4,
        hidden_dim=192,
        kernel_size=7,
        predictor_embed_size=64,
        predictor_hidden_size=64,
        predictor_dim=64,
        predictor_num_layers=1,
        join_dim=96,
        compute_dtype="float32",
        use_dynamic_chunk=False,
        use_dynamic_left_chunk=False,
        ctc_weight=0.2,
        # the attention decoder is trained, so that the rescoring mode runs
        # on trained weights
        attention_weight=0.3,
        decoder_num_layers=1,
        use_pruned_loss=pruned,
    )
    d = cfg.data
    d.train_data_list_path = meta["train_list"]
    d.dev_data_list_path = meta["eval_list"]
    d.test_data_list_path = meta["eval_list"]
    d.vocab_path = meta["vocab_path"]
    d.bpe_model = None
    d.speed_perturb = False      # the corpus is augmented already, from seeds
    d.dither = 0.1
    # no SpecAugment: the corpus is augmented already (noise, gain, speed),
    # and a 20-frame time mask can erase a whole 0.5 s segment-word
    d.spec_aug = False
    d.filter_data = False
    d.sort = True
    d.sort_size = 64
    d.shuffle = True
    d.shuffle_size = 256
    # one bucket: one train-step shape; 280 frames hold 4 x 0.5 s at speed 0.9
    d.batch_type = "bucket"
    d.bucket_boundaries = (280,)
    d.max_frames_in_batch = 32 * 280
    d.max_label_len = 40
    t = cfg.train
    t.lr = 1.5e-3
    t.warmup_steps = 300
    t.accum_grad = 1
    t.max_steps = steps
    t.max_epochs = 100000
    t.seed = seed
    t.val_check_interval = 10**9   # the final evaluation is the sweep below
    t.num_sanity_val_steps = 0
    t.log_every = 25
    t.checkpoint_dir = exp
    return cfg


@torch.inference_mode()
def eval_decode_modes(cfg: Config, params: dict, meta: dict, *, beam_size: int = 8,
                      pad_t: int | None = None, batch: int = 16, modes_filter=None,
                      details: dict | None = None) -> dict:
    """Fixed-shape WER sweep over the eval list, every decode mode, on the
    device of ``params``: features padded to one ``pad_t`` and the list to
    whole batches of ``batch`` with dummy rows of length 1. ``details``,
    when given, receives each mode's hypotheses, tokens emitted, WER and
    encoder output shape [batch, T', D]."""
    dev = leaf_paths(params)[0][1].device
    tok = Tokenizer(load_vocab(meta["vocab_path"]))
    with open(meta["eval_list"]) as f:
        entries = [json.loads(line) for line in f]
    feats_list, lens, truths = [], [], []
    for e in entries:
        wav, sr = load_audio(e["wav_path"])
        f = fbank_numpy(wav * (1 << 15), sample_rate=sr, dither=0.0)
        feats_list.append(f)
        lens.append(len(f))
        truths.append(e["transcript"])
    if pad_t is None:  # one static shape for the whole sweep
        pad_t = (max(lens) + 31) // 32 * 32
    if max(lens) > pad_t:
        raise ValueError(f"pad_t too small: need {max(lens)}")
    n = len(entries)
    n_pad = (n + batch - 1) // batch * batch
    feats = np.zeros((n_pad, pad_t, 80), np.float32)
    flens = np.zeros((n_pad,), np.int32)
    for i, f in enumerate(feats_list):
        feats[i, : len(f)] = f
        flens[i] = len(f)
    flens[n:] = 1  # dummy rows

    mcfg = cfg.model

    def sweep(decode_fn):
        wer = WordErrorRate()
        hyp_texts, tokens = [], 0
        for s in range(0, n_pad, batch):
            fb = torch.from_numpy(feats[s : s + batch]).to(dev)
            lb = torch.from_numpy(flens[s : s + batch]).to(dev)
            enc_out, enc_lens = transducer.encode(params, fb, lb, mcfg)
            enc_shape = tuple(enc_out.shape)
            hyps, hlens = decode_fn(enc_out, enc_lens)
            hyps, hlens = hyps.cpu().numpy(), hlens.cpu().numpy()
            for i in range(batch):
                gi = s + i
                if gi >= n:
                    break
                text = tok.decode_ids(hyps[i, : hlens[i]].tolist(), stop_id=mcfg.sos_eos_id)
                hyp_texts.append(text)
                tokens += int(hlens[i])
                wer.update([text], [truths[gi]])
        return wer.compute(), hyp_texts, tokens, enc_shape

    def greedy(enc_out, enc_lens):
        h, l, _ = greedy_search_batch(params, enc_out, enc_lens, mcfg)
        return h, l

    def beam(expansions, skip=0):
        def run(enc_out, enc_lens):
            toks, lengths, _ = beam_search_batch(
                params, enc_out, enc_lens, mcfg, beam_size=beam_size,
                max_expansions=expansions, max_hyp_len=64, blank_skip_window=skip)
            return toks[:, 0], lengths[:, 0]

        return run

    def ctc_greedy(enc_out, enc_lens):
        return ctc_greedy_decode(params, enc_out, enc_lens, mcfg)

    def ctc_beam(enc_out, enc_lens):
        toks, lengths, _ = ctc_prefix_beam_decode_batch(
            params, enc_out, enc_lens, mcfg, beam_size=beam_size, max_hyp_len=64)
        return toks[:, 0], lengths[:, 0]

    def rescoring(enc_out, enc_lens):
        return attention_rescoring_batch(params, enc_out, enc_lens, mcfg, beam_size=beam_size,
                                         max_hyp_len=64)

    modes = {
        "greedy_rnnt": greedy,
        "beam_rnnt_2exp": beam(2),
        "beam_rnnt_1exp": beam(1),
        # a character model emits in bursts (a word's characters cluster on
        # the segment's first frames), so the beam's expansion cap must
        # cover a frame's burst: 6 matches greedy here, 1-2 truncate
        "beam_rnnt_6exp": beam(6),
        "beam_rnnt_6exp_skip8": beam(6, skip=8),
        "beam_rnnt_2exp_skip8": beam(2, skip=8),
        "beam_rnnt_1exp_skip8": beam(1, skip=8),
        "ctc_greedy": ctc_greedy,
        "ctc_prefix_beam": ctc_beam,
        "attention_rescoring": rescoring,
    }
    if modes_filter is not None:
        modes = {k: v for k, v in modes.items() if k in modes_filter}
    results = {}
    for name, fn in modes.items():
        t0 = time.time()
        wer, hyps, tokens, enc_shape = sweep(fn)
        results[name] = {
            "wer": round(wer, 4),
            "eval_s": round(time.time() - t0, 1),
            "example_hyp": hyps[0],
        }
        if details is not None:
            details[name] = {"hyps": hyps, "tokens": tokens, "wer": wer, "enc_shape": enc_shape}
        print(f"{name:22s} WER {wer:.4f}  ({time.time() - t0:.1f}s)", flush=True)
    results["_truth_example"] = truths[0]
    results["n_eval_utts"] = n
    return results


def train_summary(metrics_path: str, offset: int, start_step: int,
                  wall_s: float) -> dict | None:
    """This run's records of ``metrics.jsonl`` (from byte ``offset``; one
    each ``log_every`` steps, after step ``start_step``): the wall seconds,
    ms per ``train_step`` over all steps and over those after the first
    interval (on the card the first holds the kernels' build at their first
    use), that interval's seconds, and the mean loss of the first and of the
    last 100 steps logged; None when the run logged none."""
    if not os.path.exists(metrics_path):
        return None
    with open(metrics_path) as f:
        f.seek(offset)
        recs = [r for r in map(json.loads, f) if "train_loss" in r]
    if not recs:
        return None
    end, first = recs[-1]["step"], recs[0]
    step_s = sum(r["train_step_s"] for r in recs)
    later = end - first["step"]
    return {"wall_s": round(wall_s, 1), "steps_logged": end - start_step,
            "step_ms": round(step_s / (end - start_step) * 1e3, 3),
            "first_interval_s": round(first["train_step_s"], 3),
            "step_ms_after_first": (round((step_s - first["train_step_s"]) / later * 1e3, 3)
                                    if later else None),
            "loss_first_100": round(float(np.mean(
                [r["train_loss"] for r in recs if r["step"] <= start_step + 100])), 4),
            "loss_last_100": round(float(np.mean(
                [r["train_loss"] for r in recs if r["step"] > end - 100])), 4)}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=DEFAULT_CORPUS)
    ap.add_argument("--samples", default=None,
                    help="recordings to build the corpus from, when --corpus has no meta.json")
    ap.add_argument("--exp", required=True)
    ap.add_argument("--pruned", action="store_true")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--save-fixture", default=None,
                    help="write the trained params as a portable .npz fixture")
    args = ap.parse_args(argv)

    meta_path = os.path.join(args.corpus, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    elif args.samples is None:
        raise SystemExit(f"no corpus at {args.corpus}: give --samples DIR (the recordings) "
                         "to build it")
    else:
        meta = build_micro_corpus(args.corpus, args.samples)

    cfg = build_config(meta, args.exp, pruned=args.pruned, steps=args.steps, seed=args.seed)
    # every kernel of the model on: the attention and conv block kernels in
    # the encoder, the RNN-T, CTC and joint kernels in the losses (JAX's
    # config leaves them off, as XLA runs those paths on the TPU; on CPU
    # tensors each wrapper takes its plain version)
    cfg.model = dataclasses.replace(cfg.model, use_pallas_attention=True, use_pallas_conv=True,
                                    use_pallas_rnnt=True, use_pallas_ctc=True,
                                    use_pallas_joint=True)
    trainer = Trainer(cfg, device="cpu" if args.cpu else None)
    summary = None
    if not args.eval_only:
        metrics = trainer.logger.path
        offset = os.path.getsize(metrics) if os.path.exists(metrics) else 0
        start = trainer.step
        t0 = time.time()
        trainer.fit()
        wall = time.time() - t0
        print(f"training done in {wall:.0f}s", flush=True)
        summary = train_summary(metrics, offset, start, wall)
    else:
        trainer.restore(args.exp)         # the newest checkpoint ("last")

    results = eval_decode_modes(cfg, trainer.params, meta)
    results["pruned_loss"] = args.pruned
    results["steps"] = int(trainer.step)
    if summary is not None:
        results["train"] = summary
    out = os.path.join(args.exp, "wer_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))

    if args.save_fixture:
        save_params_npz(args.save_fixture, trainer.params)
        with open(args.save_fixture + ".meta.json", "w") as f:
            json.dump(
                {
                    "corpus_seed": meta["seed"],
                    "vocab_size": meta["vocab_size"],
                    "steps": results["steps"],
                    "pruned_loss": args.pruned,
                    "wer": {k: vv["wer"] for k, vv in results.items()
                            if isinstance(vv, dict) and "wer" in vv},
                },
                f, indent=1,
            )
        print(f"fixture saved to {args.save_fixture}")


if __name__ == "__main__":
    main()
