#!/usr/bin/env python3
"""Times of the attention and conv-block kernels on one card at the shipped
widths (Conformer-S, -M, -L: the narrow kernels) and at the 1024-wide
Conformer's (d=1024, 8 heads of 128: the wide kernels), bf16, for the
PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_width_times.py [--tree DIR] [--out FILE]

``--tree`` times the ``conformer_tpu_torch`` of another checkout (its
kernels build into that checkout's git-ignored build/), so that two
versions can run in turn within one call on one card (parent, change,
change, parent). Shapes: the attention forward, dq and dkv at the training
shape (B=32, T'=374, dropout 0.1) and the forward at the decode shape
(B=48, no dropout); the conv block at the decode shape (B=48, T'=374, K=15;
B=8 at d=1024). Inputs are seeded, with key padding to random lengths.
Times: CUDA events, mean of 20 calls after a warm-up (the wrapper's host
work included where it outlasts the kernel), and the device time of the
kernels' launches by torch.profiler, mean per call over 20 calls (the key
with " device" at its end; None where the trace recorded none), and the
host's wall time of a call that returns before the device ends, mean over
200 calls started back to back (" host"). Prints
the card and one JSON object, {shape: ms}, with null where the tree's
wrappers refuse the width. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, B, H, T', dk, D, dropout)
ATTENTION = (("M decode", 48, 4, 374, 64, 256, 0.0), ("M train", 32, 4, 374, 64, 256, 0.1),
             ("S train", 32, 4, 374, 36, 144, 0.1), ("L train", 32, 8, 374, 64, 512, 0.1),
             ("1024-wide train", 32, 8, 374, 128, 1024, 0.1))
# (label, B, T', D, K)
CONV = (("M decode", 48, 374, 256, 15), ("S decode", 48, 374, 144, 15),
        ("L decode", 48, 374, 512, 15), ("1024-wide decode", 8, 374, 1024, 15))


def time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float | None:
    """Device time of the CUDA kernels ``fn`` launches, mean per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / iters / 1e3 if us else None


def host_ms(fn, iters: int = 200) -> float:
    """Wall ms of the host per call of ``fn``, the device not waited for."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def both(fn) -> tuple[float, float | None, float]:
    return time_ms(fn), device_ms(fn), host_ms(fn)


def attention_times(gen, b, h, t, dk, d, rate) -> dict:
    import torch

    from conformer_tpu_torch.ops import rel_attention as ra

    dev, dt = "cuda", torch.bfloat16
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[None, None, :] < lens[:, None, None]).expand(b, t, t).contiguous()
    q_u, k, v, g = (torch.randn(b, h, t, dk, generator=gen).to(dev, dt) for _ in range(4))
    ab = (0.2 * torch.randn(b, h, t, d, generator=gen)).to(dev, dt)
    feats = torch.randn(t, d, generator=gen).to(dev, dt)
    args = (q_u, ab, k, v, feats, mask.to(dev))
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    kw = dict(scale=dk ** -0.5, dropout_rate=rate)
    try:
        out, lse = ra.rel_attention(*args, seed=seed, **kw)
    except ValueError:
        return dict.fromkeys(("fwd", "dq", "dkv"), (None, None, None))
    bargs = (*args, seed, g, lse, (g.float() * out.float()).sum(dim=-1))
    return {"fwd": both(lambda: ra.rel_attention(*args, seed=seed, **kw)),
            "dq": both(lambda: ra.rel_attention_bwd_dq(*bargs, **kw)),
            "dkv": both(lambda: ra.rel_attention_bwd_dkv(*bargs, **kw))}


def conv_times(gen, b, t, d, k) -> tuple[float | None, float | None, float | None]:
    import torch

    from conformer_tpu_torch.ops.conv_block import conv_block

    dev = "cuda"

    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    bf16 = torch.bfloat16   # the products' weights in x's dtype: the wrapper casts nothing
    p_conv = {
        "pointwise_conv1": {"kernel": u(1, d, 2 * d, bound=d ** -0.5).to(bf16),
                            "bias": u(2 * d, bound=0.1)},
        "depthwise_conv": {"kernel": u(k, 1, d, bound=k ** -0.5), "bias": u(d, bound=0.1)},
        "norm": {"scale": 1 + u(d, bound=0.2), "bias": u(d, bound=0.1)},
        "pointwise_conv2": {"kernel": u(1, d, d, bound=d ** -0.5).to(bf16),
                            "bias": u(d, bound=0.1)},
    }
    p_norm = {"scale": 1 + u(d, bound=0.1), "bias": u(d, bound=0.05)}
    x = torch.randn(b, t, d, generator=gen).to(dev, bf16)
    lens = torch.randint(t // 4, t + 1, (b,), generator=gen).to(dev, torch.int32)
    try:
        conv_block(x, lens, p_norm, p_conv, kernel_size=k)
    except ValueError:
        return None, None, None
    return both(lambda: conv_block(x, lens, p_norm, p_conv, kernel_size=k))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="checkout whose conformer_tpu_torch is timed")
    ap.add_argument("--out", default="", help="also write the JSON object to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_width_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; tree {os.path.abspath(args.tree)}")
    gen = torch.Generator().manual_seed(5)
    res = {}
    for label, *shape in ATTENTION:
        for name, times in attention_times(gen, *shape).items():
            if name == "fwd" or shape[-1] > 0:
                for suffix, ms in zip(("", " device", " host"), times):
                    res[f"attention {name} {label}{suffix}"] = ms
    for label, *shape in CONV:
        for suffix, ms in zip(("", " device", " host"), conv_times(gen, *shape)):
            res[f"conv {label}{suffix}"] = ms
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
