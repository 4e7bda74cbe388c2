#!/usr/bin/env python3
"""Where the time of one recipe training step goes on the GPU, for the
PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_profile_train.py [--batch 32] [--seconds 15] [--iters 3]
        [--full-lattice] [--set model.use_pallas_attention=true ...]

Conformer-M as configs/conformer_m.json trains it (pruned RNN-T + CTC, the
RNN-T and CTC kernel flags on, bf16, accum_grad 2) on random weights from
the config's seed, fed seeded random-normal features with 64 random labels
per row; ``--full-lattice`` trains the full-lattice loss instead
(``use_pruned_loss`` false, ``use_pallas_joint`` true: the joint kernels;
B=24 unless ``--batch`` says otherwise, as ``bench.py --full-lattice``).
It times whole ``Trainer.train_step`` calls (host clock ended by a
synchronize, median of ``--iters`` after a warm-up), then runs the same
``train_step`` phased: the trainer's four profiler ranges (encoder
forward; losses forward: predictor, joint, pruned RNN-T and CTC;
backward; optimizer update) each closed by a synchronize, through
``Trainer.phase_end``, once untraced and once under torch.profiler. For
each phase it prints the wall time (traced and untraced), the
device-busy time, the device's idle share against either wall, the
kernel launches and the kernels that take the most device time; for the
whole step, the device's idle share and the device ms of the joint
kernels (``joint_*`` in the kernel's name). The
synchronizes cost the overlap of one phase's launches with the previous
phase's work, so a phased step is slower than a timed one, and the
profiler adds host time to every launch, so a traced phase is slower than
an untraced one. The last line is one JSON object with all of it. Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import random_batch  # noqa: E402
from conformer_tpu_torch.config import Config  # noqa: E402
from conformer_tpu_torch.train.loop import Trainer  # noqa: E402

PHASES = ("encoder_fwd", "losses_fwd", "backward", "optimizer")


def phased_step(trainer: Trainer, microbatches: list[dict]) -> dict:
    """One ``train_step`` with a synchronize closing each of its phases.
    Returns the host seconds of each phase (from the previous phase's end;
    the glue between phases counts to the next), summed over the
    microbatches."""
    wall = dict.fromkeys(PHASES, 0.0)
    last = [time.perf_counter()]

    def end(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        wall[name] += now - last[0]
        last[0] = now

    trainer.phase_end = end
    try:
        trainer.train_step(microbatches)
    finally:
        trainer.phase_end = None
    return wall


def trace_phases(fn, top: int) -> dict:
    """Per phase: wall ms (summed over its ranges), device-busy ms, idle
    share, launches and the ``top`` kernels by device time, from one
    torch.profiler trace of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    events = prof.events()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CPU and e.name in PHASES]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in PHASES]
    if not kernels:
        return {"device_time": "not measured (the trace shows no device time)"}
    out = {}
    step_wall = step_busy = joint_busy = 0.0
    joint_launches = 0
    for phase in PHASES:
        spans = [(a, b) for name, a, b in ranges if name == phase]
        mine = [k for k in kernels
                if any(a <= k.time_range.start < b for a, b in spans)]
        wall = sum(b - a for a, b in spans)
        busy = sum(k.time_range.end - k.time_range.start for k in mine)
        by_name: dict[str, list] = {}
        for k in mine:
            slot = by_name.setdefault(k.name, [0.0, 0])
            slot[0] += k.time_range.end - k.time_range.start
            slot[1] += 1
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        step_wall += wall
        step_busy += busy
        for name, (us, cnt) in by_name.items():
            if "joint_" in name:
                joint_busy += us
                joint_launches += cnt
        out[phase] = {
            "wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "launches": len(mine),
            "top_kernels": [{"name": name[:90], "ms": us / 1e3, "launches": cnt,
                             "share_of_busy": us / busy if busy else None}
                            for name, (us, cnt) in ranked],
        }
    out["step"] = {"wall_ms": step_wall / 1e3, "device_busy_ms": step_busy / 1e3,
                   "device_idle_share": 1.0 - step_busy / step_wall if step_wall else None,
                   "joint_kernels_ms": joint_busy / 1e3, "joint_kernel_launches": joint_launches}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs", "conformer_m.json"))
    ap.add_argument("--batch", type=int, default=None,
                    help="rows per microbatch (32; 24 with --full-lattice)")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--full-lattice", action="store_true",
                    help="the full-lattice loss through the joint kernels")
    ap.add_argument("--set", nargs="*", default=[], metavar="SECTION.KEY=VALUE",
                    help="config overrides, as conformer_tpu_torch.main takes them")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: needs a CUDA device", file=sys.stderr)
        return 2

    full = ["model.use_pruned_loss=false", "model.use_pallas_joint=true"]
    cfg = Config.from_json_file(args.config).apply_overrides(
        (full if args.full_lattice else []) + args.set)
    if args.batch is None:
        args.batch = 24 if args.full_lattice else 32
    cfg.data.cmvn_path = cfg.data.vocab_path = ""
    trainer = Trainer(cfg, device="cuda")
    mbs = [random_batch(cfg, 10 + i, args.batch, args.seconds)
           for i in range(cfg.train.accum_grad)]
    trainer.train_step(mbs)                  # warm-up
    times = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(mbs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    phased_step(trainer, mbs)                # warm-up of the phased form
    untraced = phased_step(trainer, mbs)
    trace = trace_phases(lambda: phased_step(trainer, mbs), args.top)
    for phase, tr in trace.items():
        if phase in untraced and isinstance(tr, dict):
            # the profiler costs each launch host time: the untraced
            # phase's wall is the one the step pays
            tr["wall_ms_untraced"] = untraced[phase] * 1e3
            tr["device_idle_share_untraced"] = 1.0 - tr["device_busy_ms"] / tr["wall_ms_untraced"]
    if "step" in trace:
        step = trace["step"]
        step["wall_ms_untraced"] = sum(untraced.values()) * 1e3
        step["device_idle_share_untraced"] = 1.0 - step["device_busy_ms"] / step["wall_ms_untraced"]
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(),
        "batch": args.batch, "seconds": args.seconds, "accum_grad": cfg.train.accum_grad,
        "loss": "full lattice" if not cfg.model.use_pruned_loss else "pruned",
        "step_s": step_s, "step_s_all": times,
        "audio_s_per_s": cfg.train.accum_grad * args.batch * args.seconds / step_s,
        "phases": trace,
    }
    for phase, tr in trace.items():
        if isinstance(tr, dict):
            print(f"{phase}: {json.dumps(tr)}")
    print(f"step: {step_s * 1e3:.1f} ms median of {args.iters}, "
          f"{result['audio_s_per_s']:.1f} training audio-s/s on {result['card']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
