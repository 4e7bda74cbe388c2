#!/usr/bin/env python3
"""Where the time of one batched decode goes on the GPU, for the
PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_profile_decode.py [--batch 48] [--seconds 15] [--iters 5] [--int8]
        [--modes greedy_rnnt,beam_rnnt,beam_rnnt:8,greedy_ctc,prefix_beam_ctc,attention_rescoring]

Conformer-M (configs/conformer_m.json, bf16, both kernel flags on) on random
weights from the config's seed with +6 on the joint's blank bias, fed
seeded random-normal features, as bench.py's decode phase sets it up.
``--int8`` mirrors ``bench.py --int8``: both FFN matmuls of every encoder
layer int8 (``quantize_tree(..., fuse_ffn=True)``), so each macaron half runs
as one fused int8 FFN kernel (route B of int8 serving). ``--modes``
names the searches, each run on the same encoder output: ``greedy_rnnt``
(the default), ``beam_rnnt`` (``beam_rnnt:W`` with a blank-skip window of
W), ``greedy_ctc``, ``prefix_beam_ctc`` and ``attention_rescoring``, with
the JAX bench's settings (bench.py:175-265: beam 8, 2 expansion rounds,
256 tokens, top_c 16; rescoring with a random 3-layer decoder from seed
15, ctc_weight 0.5, 64 tokens) and, for the CTC modes and rescoring, +6
on the CTC head's blank bias too. For the encoder and for each search
apart it prints the host time (each ended by a synchronize, median of
``--iters``) and, from a torch.profiler trace of one run, the device's
busy share, the kernel launches and the kernels that take the most device
time. The last line is one JSON object with all of it. Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from conformer_tpu_torch.models import decoder  # noqa: E402
from conformer_tpu_torch.models.transducer import encode  # noqa: E402
from conformer_tpu_torch.params import tree_map  # noqa: E402
from conformer_tpu_torch.ops.quant import quantize_tree  # noqa: E402
from conformer_tpu_torch.serve.runner import INT8_SKIP_KEYS, ModelRunner  # noqa: E402
from conformer_tpu_torch.train.loop import decode_search  # noqa: E402


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


def searches(p: dict, mcfg, dcfg, modes: list[str]) -> dict:
    """mode -> (params, its decode config) for ``decode_search``."""
    ctc = dict(p["ctc"]["ctc_lo"])
    ctc["bias"] = ctc["bias"].clone()
    ctc["bias"][mcfg.blank_id] += 6.0
    p_ctc = {**p, "ctc": {"ctc_lo": ctc}}
    if "attention_rescoring" in modes:
        dec = decoder.init_bi_decoder(torch.Generator().manual_seed(15),
                                      dataclasses.replace(mcfg, decoder_num_layers=3))
        p_ctc["decoder"] = tree_map(lambda t: t.to("cuda"), dec)
    bench = dict(beam_size=8, beam_expansions=2, prefix_beam_top_c=16, rescore_ctc_weight=0.5)
    out = {}
    for mode in modes:
        name, _, window = mode.partition(":")
        dc = dataclasses.replace(dcfg, mode=name, beam_blank_skip_window=int(window or 0),
                                 max_hyp_len=64 if name == "attention_rescoring" else 256,
                                 **bench)
        out[mode] = (p if name.endswith("rnnt") else p_ctc, dc)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs", "conformer_m.json"))
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="both FFN matmuls int8: the fused int8 FFN kernel (bench.py --int8)")
    ap.add_argument("--modes", default="greedy_rnnt",
                    help="comma-separated searches; beam_rnnt:W sets a blank-skip window")
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

        result = {
            "device": torch.cuda.get_device_name(0),
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip(),
            "int8": args.int8, "batch": args.batch, "seconds": args.seconds, "frames": frames,
            "encoder_frames": int(enc_out.shape[1]),
            "encode_s": enc_s, "encode_trace": profiled(run_encode, args.top),
        }
        print(f"encode: {enc_s * 1e3:.3f} ms host; trace {json.dumps(result['encode_trace'])}")
        for mode, (q, dc) in searches(p, mcfg, dcfg, args.modes.split(",")).items():
            def run_search():
                return decode_search(q, enc_out, enc_lens, mcfg, dc)

            search_s, (_, hyp_lens) = timed(run_search, args.iters)
            hyp_lens = hyp_lens[:, 0] if hyp_lens.ndim == 2 else hyp_lens
            trace = profiled(run_search, args.top)
            result[mode] = {"s": search_s, "tokens_emitted": int(hyp_lens.sum()),
                            "audio_s_per_s": args.batch * args.seconds / (enc_s + search_s),
                            "trace": trace}
            print(f"{mode}: {search_s * 1e3:.3f} ms host; trace {json.dumps(trace)}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
