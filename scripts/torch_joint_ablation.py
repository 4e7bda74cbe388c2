#!/usr/bin/env python3
"""Where the time of the bf16 full-lattice joint kernels goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_joint_ablation.py

As ``scripts/torch_attention_ablation.py`` does for attention: copies of
``csrc/joint_lattice.cu`` with one stage of a wgmma kernel taken out are
built and timed against the unchanged source on the same inputs: the
difference bounds what that stage costs where it does not overlap the
rest. The forward's stages ("fwd: ..."): the logits product, the exps of
the online logsumexp, the TMA copies of the W stages, the tanh of the x
tiles. The backward's: the logits product, the exp of the dl epilogue,
the second product, the TMA copies of the streamed tiles, the named
barrier that hands dl between the consumer warpgroups, the extra grids
around the main one. The ablated copies compute wrong results; only their
times mean anything. Shape: chip_smoke.py's training shape of the joint
(B=32, T'=374, U+1=65, J=512, V=5002), bf16 enc and float32 pred as the
model gives them. Each C entry (``joint_lattice_fwd``,
``joint_lattice_bwd_xp``, ``joint_lattice_bwd_w``, all of its grids) is
timed with CUDA events, mean of 5 after a warm-up (chip_smoke.time_ms):
the base copy all three, a forward ablation the forward, a backward one
both backward entries. The copies build with nvcc into the checkout's
git-ignored build/joint_ablation/. The last line is one JSON object of
all times in ms. Needs a CUDA device; imports nothing of JAX.
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

SRC = "joint_lattice"
XP_LOADS = ("        hop::mbar_expect(&full[st], TILE);\n"
            "        unsigned char* dst = ws + st * TILE;\n"
            "        hop::tma_load(dst, &wmap, &full[st], s * 64, 0);\n"
            "        hop::tma_load(dst + JH * 128, &wmap, &full[st], s * 64, JH);\n")
W_LOADS = ("        hop::mbar_expect(&full[st], TILE);\n"
           "        unsigned char* dst = xs + st * TILE;\n"
           "#pragma unroll\n"
           "        for (int a = 0; a < J / 64; ++a)\n"
           "          hop::tma_load(dst + a * ATOM, &xmap, &full[st], 64 * a, begin + 64 * s);\n")
HANDOFF = "      hop::fence_view_async();\n      hop::bar_sync(1, WG_CONSUMERS);\n"
FWD_LOADS = ("          hop::mbar_expect(&full[st], FWD_STAGE);\n"
             "          unsigned char* stage = ring + st * FWD_STAGE;\n"
             "          hop::tma_load(stage, &wmap, &full[st], t * FWD_VT, 64 * k);\n"
             "          hop::tma_load(stage + ATOM, &wmap, &full[st], t * FWD_VT + 64, 64 * k);\n")
FWD_FILL = "    // x = tanh(enc + pred) of this consumer's 64 rows into its swizzled atoms\n"
# (name, source, [(text, replacement), ...]), applied in order
ABLATIONS = [
    ("base", SRC, []),
    ("no logits product", SRC,
     [("  for (int k = 0; k < J / 16; ++k)\n    hop::wgmma<32, 0, 1>",
       "  for (int k = 0; k < 0; ++k)\n    hop::wgmma<32, 0, 1>")]),
    ("no exp (p = logit)", SRC,
     [("const float p = __expf(s[4 * i + 2 * h + e] + bias[2 * i + e] - q.lz);",
       "const float p = s[4 * i + 2 * h + e];")]),
    ("no second product", SRC,
     [("      for (int k = 0; k < 4; ++k)\n        hop::wgmma<JH, 0, 0>",
       "      for (int k = 0; k < 0; ++k)\n        hop::wgmma<JH, 0, 0>"),
      ("        for (int k = 0; k < 4; ++k)\n          hop::wgmma<64, 1, 1>",
       "        for (int k = 0; k < 0; ++k)\n          hop::wgmma<64, 1, 1>")]),
    ("no streamed TMA copies", SRC,
     [(XP_LOADS, "        hop::mbar_arrive(&full[st]);\n"),
      (W_LOADS, "        hop::mbar_arrive(&full[st]);\n")]),
    ("no dl hand-off barrier", SRC, [(HANDOFF, ""), (HANDOFF, "")]),
    ("main grid only", SRC,
     [("  joint_reduce_xp_kernel<<<", "  if (0) joint_reduce_xp_kernel<<<"),
      ("  joint_x_kernel<T, TP><<<", "  if (0) joint_x_kernel<T, TP><<<"),
      ("  joint_reduce_w_kernel<<<", "  if (0) joint_reduce_w_kernel<<<")]),
    ("fwd: no logits product", SRC,
     [("        for (int kk = 0; kk < 4; ++kk)\n          hop::wgmma<128, 0, 1>",
       "        for (int kk = 0; kk < 0; ++kk)\n          hop::wgmma<128, 0, 1>")]),
    ("fwd: no exp (sum of logit - max)", SRC,
     [("s += __expf(acc[4 * i + 2 * h] - mn) + __expf(acc[4 * i + 2 * h + 1] - mn);",
       "s += (acc[4 * i + 2 * h] - mn) + (acc[4 * i + 2 * h + 1] - mn);")]),
    ("fwd: no TMA copies", SRC, [(FWD_LOADS, "          hop::mbar_arrive(&full[st]);\n")]),
    ("fwd: no tanh (x = enc + pred)", SRC,
     [(FWD_FILL, FWD_FILL),
      ("x0 = to_f(joint_x<bf16, TP>(e[0], p[0]));\n          x1 = to_f(joint_x<bf16, TP>(e[1], p[1]));",
       "x0 = to_f(e[0]) + to_f(p[0]);\n          x1 = to_f(e[1]) + to_f(p[1]);")]),
]


def main() -> int:
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops import joint_lattice as jl
    from torch_attention_ablation import build

    if not torch.cuda.is_available():
        print("torch_joint_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(cuda_build, ABLATIONS, "joint_ablation")
    gen = torch.Generator().manual_seed(5)
    dev = "cuda"
    b, t, u, v = cs.JOINT_SHAPES[0]
    x = cs.joint_inputs(dev, torch.bfloat16, torch.float32, gen, b, t, u, v)
    enc, pred = x["enc"], x["pred"]
    logz = jl.joint_lattice_fwd(enc, pred, x["w"], x["b"], x["lab"], 0)[2]
    wk, bk, vp = jl._operands(enc, x["w"], x["b"])
    wf, bf, vpf = jl._operands(enc, x["w"], x["b"], jl._FWD_V_TILE)
    fwd_out = [torch.empty((b, t, u + 1), dtype=torch.float32, device=dev) for _ in range(3)]
    j, u1, m = enc.shape[2], u + 1, b * t * (u + 1)
    n_chunks = jl._bwd_w_chunks(m, v)
    f32 = dict(dtype=torch.float32, device=dev)
    dpre, d_enc, d_pred = (torch.empty(s, **f32) for s in ((m, j), (b, t, j), (b, u1, j)))
    xbuf = torch.empty((m, j), dtype=enc.dtype, device=dev)
    part, dbpart = torch.empty((n_chunks, j, vp), **f32), torch.empty((n_chunks, vp), **f32)
    dw, db = torch.empty((j, vp), **f32), torch.empty((vp,), **f32)
    grids = ctypes.c_int(0)
    P = cuda_build.ptr
    common = (P(enc), P(pred), P(wk), P(bk), P(x["lab"]), P(logz), P(x["g_blank"]),
              P(x["g_emit"]))
    times = {}
    for (name, _), lib in libs.items():
        f_fn, xp_fn, w_fn = lib.joint_lattice_fwd, lib.joint_lattice_bwd_xp, lib.joint_lattice_bwd_w
        f_fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        xp_fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
        w_fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
        f_fn.restype = xp_fn.restype = w_fn.restype = ctypes.c_int
        calls = {
            "fwd": lambda f=f_fn: f(P(enc), P(pred), P(wf), P(bf), P(x["lab"]),
                                    *(P(o) for o in fwd_out), cuda_build.stream_ptr(enc), b, t,
                                    u1, j, v, vpf, 0, 1, 0),
            "bwd_xp": lambda f=xp_fn: f(*common, P(dpre), P(d_enc), P(d_pred),
                                        ctypes.addressof(grids), cuda_build.stream_ptr(enc), b, t,
                                        u1, j, v, vp, 0, 1, 0),
            "bwd_w": lambda f=w_fn: f(*common, P(xbuf), P(part), P(dbpart), P(dw), P(db),
                                      ctypes.addressof(grids), cuda_build.stream_ptr(enc), b, t,
                                      u1, j, v, vp, 0, n_chunks, 1, 0),
        }
        for key, call in calls.items():
            if name != "base" and name.startswith("fwd:") != (key == "fwd"):
                continue
            err = call()
            if err != 0:
                raise SystemExit(f"{SRC} '{name}' {key}: CUDA error {err}")
            ms = cs.time_ms(call, 5)
            times[f"{key}: {name}"] = ms
            print(f"ablation: {key} B={b} T'={t} U+1={u1} V={v}: {name}: {ms:.4f} ms")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
