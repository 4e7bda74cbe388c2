#!/usr/bin/env python3
"""Where the time of the bf16 attention kernels goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_attention_ablation.py

No profiler attributes time inside a kernel on the card this runs on, so
this script builds copies of ``csrc/rel_flash_attention.cu`` and
``csrc/rel_flash_attention_bwd.cu`` with one stage of a bf16 kernel taken
out (the score product, the probabilities' elementwise work, the P.V-like
products, the streamed tile copies, the fully masked tiles' skip) and
times each against the unchanged kernel on the same inputs: the
difference bounds what that stage costs where it does not overlap the
rest. The ablated copies compute wrong results; only their times mean
anything. Shapes: the forward at chip_smoke.py's decode shape (B=48,
T'=374, H=4, dk=64, D=256, no dropout) and its training shape (B=32,
dropout 0.1); dq and dkv at the training shape. Each ablation is a text
substitution in the source, checked to apply, so an edit of the kernels
that moves the text fails here loudly. Times: CUDA events, mean of 20
after a warm-up (chip_smoke.time_ms). The copies build with nvcc into the
checkout's git-ignored build/ablation/. The last line is one JSON object
of all times in ms. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (name, source, [(text, replacement), ...]); the replacement applies to the
# first occurrence of the text at or after the previous one's position
FWD_S_LOOP = "      frags(fx, 0);\n      for (int kk = 0; kk < KD; kk += 32) {"
BWD_S_LOOP = "        frags(fx, 0);\n        for (int kk = 0; kk < KD; kk += 32) {"
ABLATIONS = [
    ("base", "rel_flash_attention", []),
    ("fwd: no score product", "rel_flash_attention",
     [(FWD_S_LOOP, FWD_S_LOOP.replace("kk < KD", "kk < 0"))]),
    ("fwd: no exp2 (p = score)", "rel_flash_attention",
     [("const float p = x > 0.5f * NEG_INF ? exp2_approx(x - m_new) : 0.f;",
       "const float p = x;")]),
    ("fwd: no P.V", "rel_flash_attention",
     [("for (int kk = 0; kk < NKT / 2; ++kk) {\n        uint32_t a[4];",
       "for (int kk = 0; kk < 0; ++kk) {\n        uint32_t a[4];")]),
    ("fwd: no streamed copies", "rel_flash_attention",
     [("      load_keys(stage ^ 1, k1);\n", "")]),
    ("fwd: no masked-tile skip", "rel_flash_attention",
     [("if (__syncthreads_or(any)) {", "if (__syncthreads_or(1)) {")]),
    ("base", "rel_flash_attention_bwd", []),
    ("dq: no score product", "rel_flash_attention_bwd",
     [(BWD_S_LOOP, BWD_S_LOOP.replace("kk < KD", "kk < 0"))]),
    ("dq: no dS . [K | F]", "rel_flash_attention_bwd",
     [("for (int kk = 0; kk < QK; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {")]),
    ("dq: no streamed copies", "rel_flash_attention_bwd",
     [("      load_keys(stage ^ 1, k1);\n", "")]),
    ("dkv: no score product", "rel_flash_attention_bwd",
     [(BWD_S_LOOP, "        frags(fx, 0);\n        for (int kk = 0; kk < KD; kk += 32) {"),
      (BWD_S_LOOP, BWD_S_LOOP.replace("kk < KD", "kk < 0"))]),
    ("dkv: no dV, dK products", "rel_flash_attention_bwd",
     [("for (int kk = 0; kk < 2; ++kk) {           // dV += pd^T dO",
       "for (int kk = 0; kk < 0; ++kk) {           // dV += pd^T dO")]),
    ("dkv: no streamed copies", "rel_flash_attention_bwd",
     [("      load_queries(stage ^ 1, q1);\n", "")]),
]


def variant_source(src: str, subs) -> str:
    pos = 0
    for old, new in subs:
        i = src.find(old, pos)
        if i < 0:
            raise SystemExit(f"ablation text not found (the kernel moved?): {old!r}")
        src = src[:i] + new + src[i + len(old):]
        pos = i + len(new)
    return src


def build(cuda_build, ablations=ABLATIONS, out="ablation", csrc=None) -> dict:
    """Compile every ablated copy of the sources under ``csrc`` (this
    checkout's by default) in parallel into build/<out>/; return
    {(name, source): lib}."""
    csrc = cuda_build.CSRC if csrc is None else Path(csrc)
    out_dir = os.path.join(REPO, "build", out)
    procs = []
    for i, (name, source, subs) in enumerate(ablations):
        d = os.path.join(out_dir, f"{i:02d}")
        os.makedirs(d, exist_ok=True)
        text = variant_source((csrc / f"{source}.cu").read_text(), subs)
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(text)
        for h in csrc.glob("*.cuh"):
            with open(os.path.join(d, h.name), "w") as f:
                f.write(h.read_text())
        so = os.path.join(d, "k.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, os.path.join(d, "k.cu")]
        procs.append((name, source, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {source} '{name}':\n{log}")
        libs[(name, source)] = ctypes.CDLL(so)
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops import rel_attention as ra

    if not torch.cuda.is_available():
        print("torch_attention_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(cuda_build)
    gen = torch.Generator().manual_seed(0)
    dev = "cuda"
    P = cuda_build.ptr
    scale = 1 / 8
    decode = cs.attention_inputs(dev, torch.bfloat16, gen)
    train, seed, g = cs.attention_train_inputs(dev, torch.bfloat16, gen, 32, 374)
    out, lse = ra.rel_attention(*train, seed=seed, scale=scale, dropout_rate=cs.ATTN_RATE)
    delta = (g.float() * out.float()).sum(dim=-1)
    drop, thr_bits, inv_keep = ra._drop_args(cs.ATTN_RATE)

    def fwd_call(fn, args, rate):
        q_u = args[0]
        b, h, t, dk = q_u.shape
        d = args[1].shape[-1]
        o = torch.empty_like(q_u)
        ls = torch.empty((b, h, t), device=dev)
        dr, th, ik = ra._drop_args(rate)
        sp = P(seed) if rate > 0 else None
        return lambda: fn(*(P(x) for x in args), sp, P(o), P(ls), cuda_build.stream_ptr(q_u),
                          b, h, t, t, dk, d, 1, dr, th, h, 0, scale, ik)

    def bwd_call(fn, dq: bool):
        q_u = train[0]
        b, h, t, dk = q_u.shape
        d = train[1].shape[-1]
        o1 = torch.empty((b, h, t, dk), device=dev)
        o2 = torch.empty((b, h, t, d if dq else dk), device=dev)
        return lambda: fn(*(P(x) for x in train), P(seed), P(g), P(lse), P(delta), P(o1),
                          P(o2), None, cuda_build.stream_ptr(q_u), b, h, t, t, dk, d, 1, drop,
                          thr_bits, h, 0, scale, inv_keep)

    times = {}
    for (name, source), lib in libs.items():
        if source == "rel_flash_attention":
            fn = lib.rel_flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
            fn.restype = ctypes.c_int
            calls = {"fwd decode B=48": fwd_call(fn, decode, 0.0),
                     "fwd train B=32": fwd_call(fn, train, cs.ATTN_RATE)}
        else:
            calls = {}
            for sym, key in (("rel_flash_attention_bwd_dq", "dq train B=32"),
                             ("rel_flash_attention_bwd_dkv", "dkv train B=32")):
                fn = getattr(lib, sym)
                fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
                fn.restype = ctypes.c_int
                calls[key] = bwd_call(fn, key.startswith("dq"))
        for key, call in calls.items():
            if name != "base" and not name.startswith(key.split()[0]):
                continue
            err = call()
            if err != 0:
                raise SystemExit(f"{source} '{name}' {key}: CUDA error {err}")
            ms = cs.time_ms(call)
            times[f"{key}: {name}"] = ms
            print(f"ablation: {key}: {name}: {ms:.4f} ms")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
