#!/usr/bin/env python3
"""Where the time of the bf16 attention kernels goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_attention_ablation.py

No profiler attributes time inside a kernel on the card this runs on, so
this script builds copies of ``csrc/rel_flash_attention.cu`` and
``csrc/rel_flash_attention_bwd.cu`` with one stage taken out of the
kernels that Conformer-M's and -L's widths take (the wide route: the
forward, and the backward's three kernels, dS and pd, dS [K | F], dK and
dV): the score and dP products, the softmax's exp2, P.V and the dS / dK /
dV products, the streamed TMA loads, the masked tiles' scan and skip.
Each is timed against the unchanged kernel on the same inputs: the
difference bounds what that stage costs where it does not overlap the
rest. The ablated copies compute wrong results; only their times mean
anything. A route copy sends those widths' forward to the mma.sync kernel
(the narrow route), so that the two designs are timed in one call.
Shapes: Conformer-M's decode shape (B=48, T'=374, H=4, dk=64, D=256, no
dropout) and training shape (B=32, dropout 0.1), Conformer-L's training
shape (B=32, H=8, D=512), the stream's chunk shapes (B=16, Tq=16, Tk=80
and 528) and Conformer-S's decode and training shapes (dk 36, D 144: the
mma.sync forward, and the wide kernels on operands padded to dk 40, the
pads' copies included, as the wrappers run its backward); the stage
ablations at M's shapes, the base and route copies at all; dq, dkv and the
whole backward (the one call of the autograd backward: dS and pd once) at
the training shapes and chip_smoke.py's sequence-parallel and head-shard
shapes. SDPA's forward and backward on the same scores (the
bias precomputed as a float mask) are timed beside them. Each ablation is
a text substitution in the source, checked to apply, so an edit of the
kernels that moves the text fails here loudly. Times: CUDA events, mean of
20 after a warm-up (chip_smoke.time_ms). The copies build with nvcc into
the checkout's git-ignored build/ablation/. The last line is one JSON
object of all times in ms. Needs a CUDA device; imports nothing of JAX.
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
FWD, BWD = "rel_flash_attention", "rel_flash_attention_bwd"
NARROW_ROUTE = "route: the mma.sync kernels"


def drained(acc: str, n: str) -> str:
    """A consumer's loop that takes ``n`` stages of the ring and releases
    them without their products, ``acc`` left zero."""
    return (f"    for (int i = 0; i < {n}; ++i, ++g) {{\n"
            "      await_stage(ring, full, g);\n"
            "      hopper::mbar_arrive(&empty[g % STAGES]);\n"
            "    }\n"
            f"    for (int i = 0; i < 64; ++i) {acc}[i] = 0.f;")


WIDE_FWD = "template <int DKM>\n__global__ void __launch_bounds__(wq::THREADS, 1) rel_flash_fwd_wide_kernel("
FWD_S = "    ring_products<128, 0, 0>(s, ns, ring, full, empty, g, c);"
FWD_LOADS = """          unsigned char* dst = claim(ring, full, empty, g);
          uint64_t* bar = &full[g % STAGES];
          if (d < DKC) {
            tma_load3(dst, &qmap, bar, 64 * d, q0, bh);
            tma_load3(dst + HALF, &kmap, bar, 64 * d, k0, bh);
          } else {
            tma_load3(dst, &abmap, bar, 64 * (d - DKC), q0, bh);
            tma_load3(dst + HALF, &fmap, bar, 64 * (d - DKC), k0, 0);
          }"""
FWD_V = """        unsigned char* dst = claim(ring, full, empty, g, DKC * HALF);   // V
#pragma unroll
        for (int j = 0; j < DKC; ++j)"""
DS_S = "    ring_products<128, 0, 0>(s, ns, ring, full, empty, g, c);\n"
DS_DP = "    ring_products<128, 0, 0>(dp, dkc, ring, full, empty, g, c);"
DSK = "    ring_products<128, 0, 1>(acc, nkc, ring, full, empty, g, c);"
DKV_KK = "      for (int kk = 0; kk < 4; ++kk) {\n        const uint64_t da = desc_mn("
DS_LOADS = """          unsigned char* dst = claim(ring, full, empty, g);
          uint64_t* bar = &full[g % STAGES];
          if (d < dkc) {
            tma_load3(dst, &qmap, bar, 64 * d, q0, bh);
            tma_load3(dst + HALF, &kmap, bar, 64 * d, k0, bh);
          } else if (d < ns) {
            tma_load3(dst, &abmap, bar, 64 * (d - dkc), q0, bh);
            tma_load3(dst + HALF, &fmap, bar, 64 * (d - dkc), k0, 0);
          } else {
            tma_load3(dst, &omap, bar, 64 * (d - ns), q0, bh);
            tma_load3(dst + HALF, &vmap, bar, 64 * (d - ns), k0, bh);
          }"""
LIVE = "  live_tiles(live, mg, q0, Tq, Tk, nkt);\n"
ALL_LIVE = "  for (int t = tid; t < nkt; t += blockDim.x) live[t] = 1;\n  __syncthreads();\n"
ABLATIONS = [
    ("base", FWD, []),
    (NARROW_ROUTE, FWD, [("  if (wide_width(dk, D, true)) {", "  if (false) {"),
                         ("  if (!narrow_width(dk, D, true)) return cudaErrorInvalidValue;\n",
                          "")]),
    ("fwd: no score product", FWD, [(FWD_S, drained("s", "ns"))]),
    ("fwd: no exp2 (p = score)", FWD,
     [(WIDE_FWD, WIDE_FWD),
      ("const float p = x > 0.5f * NEG_INF ? exp2_approx(x - m_new) : 0.f;",
       "const float p = x;")]),
    ("fwd: no P.V", FWD,
     [("    for (int kk = 0; kk < 8; ++kk)\n      wgmma_rs<DKM, 1>(o,",
       "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_rs<DKM, 1>(o,")]),
    ("fwd: no streamed TMA loads", FWD,
     [(FWD_LOADS, "          claim(ring, full, empty, g, 0);"),
      (FWD_V, FWD_V.replace("g, DKC * HALF);", "g, 0);").replace("j < DKC; ++j)", "j < 0; ++j)"))]),
    ("fwd: no masked-tile scan or skip", FWD, [(LIVE, ALL_LIVE)]),
    ("base", BWD, []),
    ("bwd: no score product (dS, pd)", BWD, [(DS_S, drained("s", "ns") + "\n")]),
    ("bwd: no dP product (dS, pd)", BWD, [(DS_DP, drained("dp", "dkc"))]),
    ("bwd: no dS [K | F] (dq)", BWD, [(DSK, drained("acc", "nkc"))]),
    ("bwd: no dK, dV products (dkv)", BWD, [(DKV_KK, DKV_KK.replace("kk < 4", "kk < 0"))]),
    ("bwd: no streamed TMA loads (dS, pd)", BWD,
     [(DS_LOADS, "          claim(ring, full, empty, g, 0);")]),
    ("bwd: no masked-tile scan or skip (dS, pd)", BWD, [(LIVE, ALL_LIVE)]),
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


# the shapes each ablation is timed at (label -> inputs; see main): Conformer-M's
# decode and training shapes, Conformer-L's training shape (H=8, D=512),
# the stream's chunk shapes (B=16, Tq=16 against caches of 64 and 512) and
# Conformer-S's decode and training shapes (dk 36, D 144); the backward
# also at chip_smoke.py's sequence-parallel shape (B=32, Tq=187 against 374
# keys) and head-shard shape (B=32, H=2: heads 2-3 of 4, whose keep-mask
# offset moves no time, timed at heads 0-1)
FWD_SHAPES = ("decode M B=48", "train M B=32", "train L B=32", "chunk B=16 Tk=80",
              "chunk B=16 Tk=528", "decode S B=48", "train S B=32")
BWD_SHAPES = ("train M B=32", "train L B=32", "train S B=32", "seq-parallel Tq=187",
              "head shard H=2")
# Conformer-S's dk 36 is no multiple of 8, so only the mma.sync forward
# takes it; its shapes are also timed with q+u, K, V (and dO) zero-padded
# to dk 40 in each call, the pads' copies included, on the wide kernels:
# the backward always so, as the wrappers run it
S_PAD = 4


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
    dev, bf = "cuda", torch.bfloat16
    P = cuda_build.ptr
    rate = cs.ATTN_RATE
    # label -> (args, seed, dO, dropout rate)
    inputs = {"decode M B=48": (cs.attention_inputs(dev, bf, gen), None, None, 0.0),
              "decode S B=48": (cs.attention_inputs(dev, bf, gen, dk=36, d=144), None, None,
                                0.0)}
    for label, h, dk, d in (("train M B=32", 4, 64, 256), ("train L B=32", 8, 64, 512),
                            ("train S B=32", 4, 36, 144)):
        inputs[label] = (*cs.attention_train_inputs(dev, bf, gen, 32, 374, dk=dk, d=d, h=h),
                         rate)
    inputs["seq-parallel Tq=187"] = (*cs.attention_train_inputs(dev, bf, gen, 32, 187, tk=374),
                                     rate)
    inputs["head shard H=2"] = (*cs.attention_train_inputs(dev, bf, gen, 32, 374, h=2), rate)
    for label, cache in (("chunk B=16 Tk=80", 64), ("chunk B=16 Tk=528", 512)):
        inputs[label] = (cs.stream_attention_inputs(dev, bf, gen, 16, cs.STREAM_CHUNK, cache),
                         None, None, 0.0)
    saved = {}
    for label in BWD_SHAPES:
        args, seed, g, r = inputs[label]
        scale = args[0].shape[-1] ** -0.5
        out, lse = ra.rel_attention(*args, seed=seed, scale=scale, dropout_rate=r)
        saved[label] = (lse, (g.float() * out.float()).sum(dim=-1))

    def dims(args):
        b, h, tq, dk = args[0].shape
        tk, d = args[4].shape
        return b, h, tq, tk, dk, d

    def padded(x, pad):
        return torch.nn.functional.pad(x, (0, pad)) if pad else x

    def fwd_call(fn, label, pad=0):
        args, seed, _, r = inputs[label]
        b, h, tq, tk, dk, d = dims(args)
        o = torch.empty((b, h, tq, dk + pad), dtype=bf, device=dev)
        ls = torch.empty((b, h, tq), device=dev)
        dr, th, ik = ra._drop_args(r)
        sp = P(seed) if r > 0 else None

        def call():
            q_u, ab, k, v, feats, mask = args
            q_u, k, v = (padded(x, pad) for x in (q_u, k, v))
            return fn(P(q_u), P(ab), P(k), P(v), P(feats), P(mask), sp, P(o), P(ls),
                      cuda_build.stream_ptr(o), b, h, tq, tk, dk + pad, d, 1, dr, th, h, 0,
                      dk ** -0.5, ik)
        return call

    def bwd_call(lib, label, kind, pad=0):
        """dq, dkv or the whole backward ("bwd": the one call of the autograd
        backward, dS and pd once) at ``label``'s shape."""
        args, seed, g, r = inputs[label]
        lse, delta = saved[label]
        b, h, tq, tk, dk, d = dims(args)
        dkp = dk + pad
        outs = [(b, h, tq, dkp), (b, h, tq, d)] * (kind != "dkv") + [(b, h, tk, dkp)] * 2 * (
            kind != "dq")
        outs = [torch.empty(x, device=dev) for x in outs]
        scratch = torch.empty(ra.scratch_shape(b, h, tq, tk, kind != "dq"), dtype=bf, device=dev)
        fn = getattr(lib, {"dq": "rel_flash_attention_bwd_dq", "dkv": "rel_flash_attention_bwd_dkv",
                           "bwd": "rel_flash_attention_bwd"}[kind])
        fn.argtypes = ([ctypes.c_void_p] * (12 + len(outs)) + [ctypes.c_int] * 11
                       + [ctypes.c_float] * 2)
        fn.restype = ctypes.c_int
        dr, th, ik = ra._drop_args(r)

        def call():
            q_u, ab, k, v, feats, mask = args
            q_u, k, v, dout = (padded(x, pad) for x in (q_u, k, v, g))
            return fn(P(q_u), P(ab), P(k), P(v), P(feats), P(mask), P(seed), P(dout), P(lse),
                      P(delta), *(P(x) for x in outs), P(scratch),
                      cuda_build.stream_ptr(outs[0]), b, h, tq, tk, dkp, d, 1, dr, th, h, 0,
                      dk ** -0.5, ik)
        return call

    times = {}
    for (name, source), lib in libs.items():
        calls = {}
        every = name == "base" or name.startswith("route")   # the others at M's shapes only
        if source == "rel_flash_attention":
            fn = lib.rel_flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
            fn.restype = ctypes.c_int
            for label in FWD_SHAPES:
                if not (every or " M " in label) or (name == NARROW_ROUTE and " S " in label):
                    continue   # stage ablations at M's shapes; S's forward is mma.sync's
                # Conformer-S's forward as it is and padded to dk 40 (base copy)
                for pad in (0, S_PAD) if " S " in label and name == "base" else (0,):
                    calls[f"fwd {label}{' dk 40 padded' * bool(pad)}"] = fwd_call(fn, label, pad)
        else:
            for kind in ("dq", "dkv", "bwd"):
                for label in BWD_SHAPES:
                    if name == "base" or (kind == "bwd" and " M " in label):
                        pad = S_PAD if " S " in label else 0
                        calls[f"{kind} {label}{' dk 40 padded' * bool(pad)}"] = bwd_call(
                            lib, label, kind, pad)
        for key, call in calls.items():
            err = call()
            if err != 0:
                raise SystemExit(f"{source} '{name}' {key}: CUDA error {err}")
            ms = cs.time_ms(call)
            times[f"{key}: {name}"] = ms
            print(f"ablation: {key}: {name}: {ms:.4f} ms")
    # the yardstick: SDPA on the same scores (the bias precomputed as a float mask)
    for label, (args, seed, g, r) in inputs.items():
        q_u, ab, k, v, feats, mask = args
        scale = q_u.shape[-1] ** -0.5
        bias = (torch.matmul(ab.float(), feats.float().T) * scale).masked_fill(
            ~mask[:, None], float("-inf")).to(bf)
        bias[:, :, :, 0] = torch.where(mask.any(-1)[:, None], bias[:, :, :, 0], 0)
        # as chip_smoke.py's yardsticks: the training shapes' forward on the
        # backward's leaves, the others' on plain tensors
        train = label in BWD_SHAPES
        leaves = [x.detach().clone().requires_grad_(train) for x in (q_u, k, v, bias)]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                *leaves[:3], attn_mask=leaves[3], dropout_p=r, scale=scale)

        with torch.no_grad():
            times[f"fwd {label}: SDPA"] = cs.time_ms(sdpa)
        if label in BWD_SHAPES:
            out = sdpa()
            times[f"bwd {label}: SDPA"] = cs.time_ms(
                lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        print(f"ablation: {label}: SDPA fwd {times[f'fwd {label}: SDPA']:.4f} ms"
              + (f", bwd {times[f'bwd {label}: SDPA']:.4f} ms" if label in BWD_SHAPES else ""))
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
