#!/usr/bin/env python3
"""Where the time of the bf16 conv block kernel goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_conv_ablation.py

As ``scripts/torch_attention_ablation.py`` does for attention: copies of
``csrc/conv_block.cu`` with one stage of a bf16 launch taken out are built
and timed against the unchanged source on the same inputs: the difference
bounds what that stage costs where it does not overlap the rest. Launch 1
(LN_pre, pw1, GLU): the LayerNorm, the pw1 product, the W1 copies.
Launch 2 (depthwise, LN, swish, pw2, residual): the depthwise taps, the pw2
product, the W2 copies, the residual's row writes. The ablated copies
compute wrong results; only their times mean anything. Shapes: the decode
shape of chip_smoke.py (B=48, T'=374, K=15) at Conformer-M's width D=256,
and at -S's and -L's (D=144, 512). Each launch is timed on the device by
torch.profiler over 20 calls of the C entry (mean per call). The copies
build with nvcc into the checkout's git-ignored build/conv_ablation/. The
last line is one JSON object of all times in us. Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

SRC = "conv_block"
# (name, source, [(text, replacement), ...]), applied in order
ABLATIONS = [
    ("base", SRC, []),
    ("launch 1: no LN", SRC,
     [("  for (int r = warp; r < RM; r += NT / 32) {\n    const int m = m0 + r;",
       "  for (int r = warp; r < 0; r += NT / 32) {\n    const int m = m0 + r;")]),
    ("launch 1: no pw1 product", SRC, [("    if (live == 0) continue;", "    if (true) continue;")]),
    ("launch 1: no W1 copies", SRC,
     [("      rel_attn::cp_async<16>(dst + r * Q1_LDW",
       "      if (0) rel_attn::cp_async<16>(dst + r * Q1_LDW")]),
    ("launch 2: no depthwise", SRC,
     [("  for (int c = tid; c < D; c += NT) {\n    float w[KMAX]",
       "  for (int c = tid; c < 0; c += NT) {\n    float w[KMAX]")]),
    ("launch 2: no pw2 product", SRC,
     [("        if (nt < ntiles) {\n          uint32_t bf[2];",
       "        if (false) {\n          uint32_t bf[2];")]),
    ("launch 2: no W2 copies", SRC,
     [("      rel_attn::cp_async<16>(dst + r * ldz + cc, w2",
       "      if (0) rel_attn::cp_async<16>(dst + r * ldz + cc, w2")]),
    ("launch 2: no residual writes", SRC,
     [("    if (t >= Tlen) continue;\n    const uint4 xv", "    if (true) continue;\n    const uint4 xv")]),
]
WIDTHS = (256, 144, 512)
B, T, K = 48, 374, 15


def device_us(fn, n: int = 20) -> dict:
    """Mean device microseconds per call of each launch ("launch 1" and
    "launch 2" by kernel name) over ``n`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"launch 1": 0.0, "launch 2": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = "launch 1" if "pw1_glu" in e.name else "launch 2" if "pw2" in e.name else None
            if key:
                out[key] += (e.time_range.end - e.time_range.start) / n
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import conv_block as cb
    from conformer_tpu_torch.ops import cuda_build
    from torch_attention_ablation import build

    if not torch.cuda.is_available():
        print("torch_conv_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(cuda_build, ABLATIONS, "conv_ablation")
    gen = torch.Generator().manual_seed(0)
    dev = "cuda"
    P = cuda_build.ptr
    times = {}
    for d in WIDTHS:
        x, lens, p_norm, p_conv = cs.conv_inputs(dev, torch.bfloat16, gen, b=B, t=T, d=d, k=K)
        w = cb.kernel_weights(p_norm, p_conv, x.dtype)
        lens32 = lens.to(torch.int32)
        out = torch.empty_like(x)
        cache = torch.empty((B, K - 1, d), dtype=x.dtype, device=dev)
        glu = torch.empty((B, T, d), dtype=torch.float32, device=dev)
        for (name, _), lib in libs.items():
            fn = lib.conv_block_fwd
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
            fn.restype = ctypes.c_int
            call = lambda fn=fn: fn(  # noqa: E731
                P(x), P(lens32), P(w["pre_s"]), P(w["pre_b"]), P(w["w1"]), P(w["b1"]), P(w["wd"]),
                P(w["bd"]), P(w["ln_s"]), P(w["ln_b"]), P(w["w2"]), P(w["b2"]), P(out), P(cache),
                P(glu), cuda_build.stream_ptr(x), B, T, d, K, 1)
            err = call()
            if err != 0:
                raise SystemExit(f"{SRC} '{name}' D={d}: CUDA error {err}")
            us = device_us(call)
            for key, v in us.items():
                times[f"D={d} {key}: {name}"] = v
            print(f"ablation: conv bf16 B={B} T'={T} D={d} K={K}: {name}: launch 1 "
                  f"{us['launch 1']:.2f} us, launch 2 {us['launch 2']:.2f} us")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
