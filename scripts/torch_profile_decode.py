#!/usr/bin/env python3
"""Where the time of one batched greedy RNN-T decode goes on the GPU, for
the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_profile_decode.py [--batch 48] [--seconds 15] [--iters 5] [--int8]

Conformer-M (configs/conformer_m.json, bf16, both kernel flags on) on random
weights from the config's seed with +6 on the joint's blank bias, fed
seeded random-normal features, as bench.py's decode phase sets it up.
``--int8`` mirrors ``bench.py --int8``: both FFN matmuls of every encoder
layer int8 (``quantize_tree(..., fuse_ffn=True)``), so each macaron half runs
as one fused int8 FFN kernel (route B of int8 serving). For
the encoder and for the greedy search apart it prints the host time (each
ended by a synchronize, median of ``--iters``) and, from a torch.profiler
trace of one run, the device's busy share, the kernel launches and the
kernels that take the most device time. The last line is one JSON object
with all of it. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from conformer_tpu_torch.config import Config  # noqa: E402
from conformer_tpu_torch.decode.greedy import greedy_search_batch  # noqa: E402
from conformer_tpu_torch.models.transducer import encode  # noqa: E402
from conformer_tpu_torch.ops.quant import quantize_tree  # noqa: E402
from conformer_tpu_torch.serve.runner import INT8_SKIP_KEYS, ModelRunner  # noqa: E402


def timed(fn, iters: int) -> tuple[float, object]:
    """Median host seconds of ``fn`` (synchronized), and its last result."""
    out, times = None, []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def profiled(fn, top: int) -> dict:
    """Device busy share, kernel launches and the ``top`` kernels by device
    time over one run of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if busy_us == 0:
        return {"device_time": "not measured (the trace shows no device time)"}
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches": sum(k[1] for k in kernels),
        "top_kernels": [{"name": name[:90], "ms": us / 1e3, "launches": n,
                         "share_of_busy": us / busy_us}
                        for us, n, name in kernels[:top]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs", "conformer_m.json"))
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="both FFN matmuls int8: the fused int8 FFN kernel (bench.py --int8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_decode: needs a CUDA device", file=sys.stderr)
        return 2

    cfg = Config.from_json_file(args.config)
    cfg.model.use_pallas_attention = cfg.model.use_pallas_conv = True
    cfg.data.cmvn_path = cfg.data.vocab_path = ""
    runner = ModelRunner(cfg, device="cuda")
    runner.params["joint"]["ffn_out"]["bias"][cfg.model.blank_id] += 6.0
    if args.int8:
        runner.params = quantize_tree(runner.params, skip_keys=INT8_SKIP_KEYS, fuse_ffn=True)
    mcfg, dcfg, p = cfg.model, cfg.decode, runner.params
    frames = int(args.seconds * 100)        # 10 ms frame shift
    rng = np.random.default_rng(1)
    feats = torch.as_tensor(
        rng.standard_normal((args.batch, frames, mcfg.input_dim), np.float32), device="cuda")
    lens = torch.full((args.batch,), frames, dtype=torch.int32, device="cuda")

    def run_encode():
        return encode(p, feats, lens, mcfg)

    with torch.inference_mode():
        enc_s, (enc_out, enc_lens) = timed(run_encode, args.iters)

        def run_greedy():
            return greedy_search_batch(p, enc_out, enc_lens, mcfg, n_steps=dcfg.n_steps,
                                       max_hyp_len=dcfg.max_hyp_len)

        greedy_s, (_, hyp_lens, _) = timed(run_greedy, args.iters)
        result = {
            "device": torch.cuda.get_device_name(0),
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip(),
            "int8": args.int8, "batch": args.batch, "seconds": args.seconds, "frames": frames,
            "encoder_frames": int(enc_out.shape[1]),
            "tokens_emitted": int(hyp_lens.sum()),
            "encode_s": enc_s, "greedy_s": greedy_s,
            "audio_s_per_s": args.batch * args.seconds / (enc_s + greedy_s),
            "encode_trace": profiled(run_encode, args.top),
            "greedy_trace": profiled(run_greedy, args.top),
        }
    for phase in ("encode", "greedy"):
        tr = result[f"{phase}_trace"]
        print(f"{phase}: {result[f'{phase}_s'] * 1e3:.3f} ms host; trace {json.dumps(tr)}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
