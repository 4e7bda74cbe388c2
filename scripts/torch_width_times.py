#!/usr/bin/env python3
"""Times of the attention, conv-block, joint and fused int8 FFN kernels on
one card at the shipped widths (Conformer-S, -M, -L: the narrow kernels)
and at wider ones (the 1024-wide Conformer's d=1024, 8 heads of 128, FFN
4096; the joint at J 640 in float32 and 1024: the wide kernels; the
joint in float32 at Conformer-M's J 512 too), for the PyTorch/CUDA port
(``conformer_tpu_torch``).

    python3 scripts/torch_width_times.py [--tree DIR] [--out FILE]

``--tree`` times the ``conformer_tpu_torch`` of another checkout (its
kernels build into that checkout's git-ignored build/), so that two
versions can run in turn within one call on one card (parent, change,
change, parent). Shapes: the attention forward, dq, dkv and the whole
backward as the autograd Function runs it ("bwd") at the training shape
(B=32, T'=374, dropout 0.1) and the forward at the decode shape
(B=48, no dropout); the conv block at the decode shape (B=48, T'=374, K=15;
B=8 at d=1024); the three joint kernels at B=8, T'=374, U=64, V=5002 (3
calls a time) and the fused int8 FFN at route B's decode batches (M = 48
x 374 at Conformer-M and -L, 8 x 374 at the 1024-wide), bf16 x. For the
conv block, the joint and the FFN also the plain version's time, the
bound (the products' operations at the tensor-core or float32 rate
against the bytes of inputs and outputs at 3.35 TB/s; for the float32
joint also at the rate of the 3xTF32 arithmetic its wide route runs, three
tf32 products each at 495 TFLOP/s, " bound 3xtf32") and a yardstick (the
conv block's two products alone by bf16 torch.matmul; the joint's products
alone by torch.matmul in t chunks; the FFN's two products by
torch._int_mm) under " plain", " bound" and " yardstick". Inputs are
seeded, with key padding to random lengths.
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
# (label, B, T', U, V, J, enc dtype): enc bf16 with float32 pred is the model's
JOINT = (("M bf16 J=512", 8, 374, 64, 5002, 512, "bfloat16"),
         ("M f32 J=512", 8, 374, 64, 5002, 512, "float32"),
         ("L bf16 J=640", 8, 374, 64, 5002, 640, "bfloat16"),
         ("L f32 J=640", 8, 374, 64, 5002, 640, "float32"),
         ("bf16 J=1024", 8, 374, 64, 5002, 1024, "bfloat16"))
# (label, M, D, H): route B's fused FFN half, bf16 x
FFN = (("M route B", 17952, 256, 2048), ("L route B", 17952, 512, 2048),
       ("1024-wide route B", 2992, 1024, 4096))
HBM_TBPS, BF16_TFLOPS, F32_TFLOPS, INT8_TOPS, TF32_TFLOPS = 3.35, 989.0, 67.0, 1979.0, 495.0


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
        return dict.fromkeys(("fwd", "dq", "dkv", "bwd"), (None, None, None))
    bargs = (*args, seed, g, lse, (g.float() * out.float()).sum(dim=-1))

    def backward():   # as the autograd backward runs it (a tree without the joint call: both)
        if hasattr(ra, "rel_attention_bwd"):
            return ra.rel_attention_bwd(*bargs, **kw)
        return ra.rel_attention_bwd_dq(*bargs, **kw), ra.rel_attention_bwd_dkv(*bargs, **kw)

    return {"fwd": both(lambda: ra.rel_attention(*args, seed=seed, **kw)),
            "dq": both(lambda: ra.rel_attention_bwd_dq(*bargs, **kw)),
            "dkv": both(lambda: ra.rel_attention_bwd_dkv(*bargs, **kw)),
            "bwd": both(backward)}


def conv_times(gen, b, t, d, k) -> tuple:
    """(ms, device ms, host ms, plain ms, bound ms, yardstick ms) of the bf16
    conv block, or Nones where the tree refuses the width. The bound as
    chip_smoke.conv_block_times takes it: the bytes of x, the weights, out
    and the cache against the pointwise products of the valid frames at
    the bf16 tensor rate and the depthwise taps at the float32 rate; the
    yardstick: the two products alone by bf16 torch.matmul ([B T', D] x
    [D, 2D] and [B T', D] x [D, D])."""
    import torch

    from conformer_tpu_torch.ops.conv_block import conv_block, conv_block_plain, kernel_weights

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
        out = conv_block(x, lens, p_norm, p_conv, kernel_size=k)
    except ValueError:
        return (None,) * 6
    frames = float(lens.sum())
    w = kernel_weights(p_norm, p_conv, bf16)
    n_bytes = sum(a.numel() * a.element_size() for a in (x, lens, *out, *w.values()))
    bound = max(n_bytes / (HBM_TBPS * 1e9), 2.0 * frames * d * 3 * d / (BF16_TFLOPS * 1e9)
                + 2.0 * frames * d * k / (F32_TFLOPS * 1e9))
    y = x.reshape(b * t, d)

    def yard():
        torch.matmul(y, w["w1"])
        torch.matmul(y, w["w2"])

    return (*both(lambda: conv_block(x, lens, p_norm, p_conv, kernel_size=k)),
            time_ms(lambda: conv_block_plain(x, lens, p_norm, p_conv, kernel_size=k)), bound,
            time_ms(yard))


def bound_ms(n_bytes: float, ops: float, rate_tflops: float) -> float:
    return max(n_bytes / (HBM_TBPS * 1e9), ops / (rate_tflops * 1e9))


def joint_times(gen, b, t, u, v, j, dt) -> dict:
    """{kernel: (ms, device ms, host ms, plain ms, bound ms, yardstick ms,
    3xTF32 bound ms (float32; else None))} of the three joint kernels, or
    Nones where the tree refuses J."""
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import joint_lattice as jl

    dtype = getattr(torch, dt)
    x = cs.joint_inputs("cuda", dtype, torch.float32, gen, b, t, u, v, j=j)
    args = (x["enc"], x["pred"], x["w"], x["b"], x["lab"])
    names = ("fwd", "bwd_xp", "bwd_w")
    try:
        logz = jl.joint_lattice_fwd(*args, 0)[2]
    except ValueError:
        return dict.fromkeys(names, (None,) * 7)
    bargs = (*args, logz, x["g_blank"], x["g_emit"], 0)
    cells, rate = b * t * (u + 1), BF16_TFLOPS if dt == "bfloat16" else F32_TFLOPS
    product = 2.0 * cells * j * v
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    lat_bytes = 3 * cells * 4
    yard = cs.joint_yardstick(x, dtype)
    kernels = {"fwd": (lambda: jl.joint_lattice_fwd(*args, 0),
                       lambda: jl.joint_lattice_plain_fwd(*args, 0), 1, in_bytes + lat_bytes),
               "bwd_xp": (lambda: jl.joint_lattice_bwd_xp(*bargs),
                          lambda: jl.joint_lattice_plain_bwd_xp(*bargs), 2,
                          in_bytes + lat_bytes + (b * t + b * (u + 1)) * j * 4),
               "bwd_w": (lambda: jl.joint_lattice_bwd_w(*bargs),
                         lambda: jl.joint_lattice_plain_bwd_w(*bargs), 2,
                         in_bytes + lat_bytes + (j * v + v) * 4)}
    out = {}
    for name, (kern, plain, n_products, n_bytes) in kernels.items():
        ms, dev_ms, host = time_ms(kern, 3), device_ms(kern, 3), host_ms(kern, 3)
        tf32 = bound_ms(n_bytes, 3 * n_products * product, TF32_TFLOPS) if dt == "float32" else None
        out[name] = (ms, dev_ms, host, time_ms(plain, 3),
                     bound_ms(n_bytes, n_products * product, rate), time_ms(yard, 3) * n_products,
                     tf32)
    return out


def ffn_times(gen, m, d, h) -> tuple:
    """(ms, device ms, host ms, plain ms, bound ms, yardstick ms) of the
    fused int8 FFN, or Nones where the tree refuses the widths."""
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import int8_ffn as f8

    ln, _, _, w1, w2 = cs.int8_ffn_weights("cuda", gen, d=d, h=h)
    args = (ln, w1["kernel_q"], w1["kernel_scale"], w1["bias"], w2["kernel_q"],
            w2["kernel_scale"], w2["bias"])
    x = torch.randn(m, d, generator=gen).to("cuda", torch.bfloat16)
    try:
        f8.int8_ffn_fused(x, *args)
    except ValueError:
        return (None,) * 6
    xq = torch.randint(-127, 128, (m, d), generator=gen, dtype=torch.int8).to("cuda")
    hq = torch.randint(-127, 128, (m, h), generator=gen, dtype=torch.int8).to("cuda")

    def yard():
        torch._int_mm(xq, w1["kernel_q"])
        torch._int_mm(hq, w2["kernel_q"])

    kern = lambda: f8.int8_ffn_fused(x, *args)  # noqa: E731
    n_bytes = 2 * m * d * 2 + 2 * d * h + (3 * h + 5 * d) * 4
    return (time_ms(kern), device_ms(kern), host_ms(kern),
            time_ms(lambda: f8.int8_ffn_plain(x, *args)),
            bound_ms(n_bytes, 4.0 * m * d * h, INT8_TOPS), time_ms(yard))


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
    detail = ("", " device", " host", " plain", " bound", " yardstick")
    for label, *shape in CONV:
        for suffix, ms in zip(detail, conv_times(gen, *shape)):
            res[f"conv {label}{suffix}"] = ms
    for label, *shape in JOINT:
        for name, times in joint_times(gen, *shape).items():
            for suffix, ms in zip((*detail, " bound 3xtf32"), times):
                if ms is not None or suffix != " bound 3xtf32":
                    res[f"joint {name} {label}{suffix}"] = ms
    for label, *shape in FFN:
        for suffix, ms in zip(detail, ffn_times(gen, *shape)):
            res[f"int8_ffn {label}{suffix}"] = ms
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
