#!/usr/bin/env python3
"""Where the time of the simple-lattice kernels goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_simple_lattice_ablation.py

As ``scripts/torch_conv_ablation.py`` does for the conv block: copies of
``csrc/simple_lattice.cu`` with one stage taken out are built and timed
against the unchanged source on the same inputs: the difference bounds
what that stage costs where it does not overlap the rest. The forward's
product kernel (fwd_partial): the tile loads, the row transform (maxima,
exps, tf32 split), the wgmma products. The backward's product kernel
(bwd_main): the t tiles' loads, the ea planes, the W planes, the wgmma
products, the d am stores. The ablated copies compute wrong results;
only their times mean anything (the forward's merge kernel then meets
cells its guard takes, so only the product kernels' times are reported).
Shape: the training shape of chip_smoke.py (B=32, T'=374, U=64,
V=5002), float32; the backward from the plain version's logZ. Each
kernel is timed on the device by torch.profiler over 10 calls of the C
entry (mean per call). The copies build with nvcc into the checkout's
git-ignored build/simple_lattice_ablation/. The last line is one JSON
object of all times in us. Needs a CUDA device; imports nothing of JAX.
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

SRC = "simple_lattice"
# (name, source, [(text, replacement), ...]), applied in order
ABLATIONS = [
    ("base", SRC, []),
    ("fwd: no tile loads", SRC,
     [("  load(0);\n  cp_commit();\n  for (int it = 0; it < ntile; ++it) {\n"
       "    if (it + 1 < ntile) load(it + 1);",
       "  cp_commit();\n  for (int it = 0; it < ntile; ++it) {\n    if (false) load(it + 1);")]),
    ("fwd: no row transform", SRC,
     [("    if (tid < F_ROWS) {\n      // row tid: its maximum",
       "    if (false) {\n      // row tid: its maximum")]),
    ("fwd: no products", SRC,
     [("    for (int s = 0; s < F_VT / 8; ++s) {\n      wgmma_tf32_n72(acc, desc(alo",
       "    for (int s = 0; s < 0; ++s) {\n      wgmma_tf32_n72(acc, desc(alo")]),
    ("bwd: no t tile loads", SRC,
     [("      if (t0 + B_TT < T) stage_t(t0 + B_TT, u0, ch);",
       "      if (false) stage_t(t0 + B_TT, u0, ch);")]),
    ("bwd: no ea planes", SRC,
     [("      for (int i = tid; i < B_TT / 4 * B_VT; i += 256) {",
       "      for (int i = tid; i < 0; i += 256) {")]),
    ("bwd: no W planes", SRC,
     [("      for (int i = tid; i < B_TT * B_UC / 4; i += 256) {",
       "      for (int i = tid; i < 0; i += 256) {"),
      ("      for (int i = tid; i < B_UC * B_TT / 4; i += 256) {",
       "      for (int i = tid; i < 0; i += 256) {")]),
    ("bwd: no products", SRC,
     [("        for (int s = 0; s < B_UC / 8; ++s) {", "        for (int s = 0; s < 0; ++s) {"),
      ("        for (int s = 0; s < B_TT / 8; ++s) {", "        for (int s = 0; s < 0; ++s) {")]),
    ("bwd: no d am stores", SRC,
     [("      for (int i = tid; i < B_TT * B_VT; i += 256) {\n"
       "        const int r = i / B_VT, cc = i % B_VT, t = t0 + r, v = v0 + cc;\n"
       "        if (t >= T || v >= V) continue;",
       "      for (int i = tid; i < 0; i += 256) {\n"
       "        const int r = i / B_VT, cc = i % B_VT, t = t0 + r, v = v0 + cc;\n"
       "        if (t >= T || v >= V) continue;")]),
]
SHAPE = (32, 374, 64, 5002)
KERNELS = ("fwd_partial_kernel", "fwd_combine_kernel", "rowmax_kernel", "bwd_prep_kernel",
           "bwd_main_kernel", "bwd_guard_kernel")


def device_us(fn, n: int = 10) -> dict:
    """Mean device microseconds per call of each kernel of ``KERNELS`` over
    ``n`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(KERNELS, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in KERNELS:
                if k in e.name:
                    out[k] += (e.time_range.end - e.time_range.start) / n
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops import simple_lattice as sl
    from torch_attention_ablation import build

    if not torch.cuda.is_available():
        print("torch_simple_lattice_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(cuda_build, ABLATIONS, "simple_lattice_ablation")
    b, t, u, v = SHAPE
    x = cs.training_kernel_inputs("cuda", torch.Generator().manual_seed(1), b, t, u, v)
    am, lm, lab = x["am"], x["lm"], x["lab"]
    u1 = u + 1
    logz = sl.simple_lattice_plain_fwd(am, lm, lab, 0)[2]
    outs = [torch.empty(b, t, u1, device="cuda") for _ in range(3)]
    count = torch.empty(1, dtype=torch.int32, device="cuda")
    dam, dlm = torch.empty_like(am), torch.empty_like(lm)
    u1p = -(-u1 // 4) * 4
    bwork = torch.empty(b * (t * u1p + 2 * t + 3 * u1), device="cuda")
    iwork = torch.empty(b * (t + u1), dtype=torch.int32, device="cuda")
    n = ctypes.c_int(0)
    P = cuda_build.ptr
    times = {}
    for (name, _), lib in libs.items():
        splits = lib.simple_lattice_fwd_splits
        splits.argtypes = [ctypes.c_int] * 4
        s = splits(b, t, u1, v)
        work = torch.empty(s * b * (t * u1 + t + u1), device="cuda")
        fwd, bwd = lib.simple_lattice_fwd, lib.simple_lattice_bwd
        fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5

        def call(fwd=fwd, bwd=bwd, work=work, s=s):
            st = cuda_build.stream_ptr(am)
            for err in (fwd(P(am), P(lm), P(lab), P(outs[0]), P(outs[1]), P(outs[2]), P(work),
                            P(count), ctypes.addressof(n), st, b, t, u1, v, 0, s),
                        bwd(P(am), P(lm), P(lab), P(logz), P(x["g_blank"]), P(x["g_emit"]),
                            P(dam), P(dlm), P(bwork), P(iwork), ctypes.addressof(n), st, b, t,
                            u1, v, 0)):
                if err != 0:
                    raise SystemExit(f"{SRC} '{name}': CUDA error {err}")

        us = device_us(call)
        for k in ("fwd_partial_kernel", "bwd_main_kernel"):
            times[f"{k}: {name}"] = us[k]
        if name == "base":
            times.update({f"{k}: base": us[k] for k in KERNELS})
        print(f"ablation: simple lattice f32 B={b} T'={t} U={u} V={v}: {name}: "
              + ", ".join(f"{k} {us[k]:.2f} us" for k in KERNELS if us[k] > 0))
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
