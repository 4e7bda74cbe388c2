"""Command line of the port: train and evaluate (JAX ``main.py``).

    python -m conformer_tpu_torch.main --config configs/conformer_m.json --train \
        --set train.checkpoint_dir=experiments/run1

    python -m conformer_tpu_torch.main --config ... --eval --resume --resume_from last

    python -m conformer_tpu_torch.main --config ... --eval --wenet_ckpt_path model.pt

Runs on the card; ``--device cpu`` takes the CPU instead (the port's
counterpart of ``JAX_PLATFORMS=cpu``). ``--wenet_ckpt_path`` imports a
reference / WeNet state dict into the trainer before ``--train`` and
``--eval``.

Several processes (``parallel/distributed.py``): run the same command
once per rank with ``--coordinator host:port --num_processes N
--process_id r`` (or the CONFORMER_* environment, or under torchrun with
CONFORMER_DISTRIBUTED=auto). Each rank takes ``cuda:<local rank>`` over
NCCL, one rank per card, or the CPU over gloo with ``--device cpu``; the
trainer's mesh comes from ``train.mesh_*``.
"""

from __future__ import annotations

import argparse
import signal
import sys

from .config import Config


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="conformer_tpu_torch",
        description="Conformer CTC/RNN-T ASR on PyTorch and CUDA",
    )
    ap.add_argument("--config", type=str, default=None, help="JSON config file")
    ap.add_argument("--set", nargs="*", default=[], metavar="SECTION.KEY=VALUE",
                    help="dotted config overrides")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--streaming_eval", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--resume_from", type=str, default=None)
    ap.add_argument("--wenet_ckpt_path", type=str, default=None)
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--print_config", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; cuda (the default) raises without a card")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of rank 0 for torch.distributed")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = Config.from_json_file(args.config) if args.config else Config()
    if args.set:
        cfg = cfg.apply_overrides(args.set)
    if args.resume_from:
        cfg.train.resume_from = args.resume_from
    if args.streaming_eval:
        cfg.decode.streaming = True
    if args.print_config:
        print(cfg.to_json())
        return 0

    import torch
    import torch.distributed as dist

    from .device import resolve_device
    from .parallel import distributed as pdist

    device = resolve_device(args.device)
    joined = not dist.is_initialized() and pdist.maybe_initialize_distributed(
        args.coordinator, args.num_processes, args.process_id, device=device)
    try:
        device = pdist.rank_device(device)
        if device.type == "cuda" and device.index is not None:     # a rank's own card
            torch.cuda.set_device(device)
        return _run(args, cfg, device)
    finally:
        if joined:          # a group the caller made stays the caller's
            pdist.destroy()


def _run(args, cfg: Config, device) -> int:
    from .train.loop import Trainer

    trainer = Trainer(cfg, device=device, use_wandb=args.wandb)
    try:
        if args.wenet_ckpt_path:
            trainer.load_torch_checkpoint(args.wenet_ckpt_path)
        if args.train:
            previous = trainer.install_preemption_handler()
            try:
                trainer.fit()
            finally:
                signal.signal(signal.SIGTERM, previous)
        if args.eval:
            if args.resume and cfg.train.resume_from:
                trainer.restore(cfg.train.resume_from)
            from .data.dataset import AsrDataset, eval_config

            ds = AsrDataset(eval_config(cfg.data), mode="test", tokenizer=trainer.tokenizer,
                            **trainer.eval_shard())
            wer = trainer.validate(ds)
            print(f"WER: {wer:.6f}")
    finally:
        trainer.logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
