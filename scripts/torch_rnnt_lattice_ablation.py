#!/usr/bin/env python3
"""Where the time of the transducer lattice DP kernels goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_rnnt_lattice_ablation.py [--parent DIR]

As ``scripts/torch_simple_lattice_ablation.py`` does for the simple
lattice: copies of ``csrc/rnnt_lattice.cu`` with stages taken out are
built and timed against the unchanged source on the same inputs; the
difference bounds what a stage costs where it does not overlap the rest.
The stages of the one-warp kernels (``rnnt_lattice_fwd_warp`` and
``rnnt_lattice_bwd_warp``): the copy warps' staging of the inputs into
the rings, their stores of the outputs from the rings, and the backward's
last pass that scales both outputs; and the wavefront itself (what is left
is the copy warps' work alone). The chain floor takes all of these
out, and also the wavefront warp's reads and writes of the rings and the
backward's occupancies: left are the same grid, the same exchanges
between lanes (a shuffle a diagonal, a barrier a ring block) and the same
T'+U steps of one logaddexp on every cell. The ablated copies compute
wrong results; only their times mean anything. With ``--parent DIR`` (a
checkout of an earlier commit, e.g. unpacked by ``git archive`` into the
git-ignored ``build/``), its ``rnnt_lattice.cu`` is built and timed on
the same inputs as "parent".

Shapes: the training shape of chip_smoke.py (B=32, T'=374, U=64) and the
recipe's longest bucket with labels padded to 200 (B=4, T'=412, U=200),
float32, inputs as chip_smoke.py makes them; the backward from the plain
version's alpha and NLL. Each kernel is timed on the device by
torch.profiler over 20 calls of the C entry (the mean over the launches
the trace recorded), every variant twice, in turn and then in reverse
order. The copies build with
nvcc into the checkout's git-ignored build/rnnt_lattice_ablation/. The
last line is one JSON object of all times in us. Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

SRC = "rnnt_lattice"
# the texts each stage's removal substitutes, in source order
FWD_STAGE = [("      if (k < nblk) stage_inputs<C>(dst, src, k * R, T, U1, cw, lane);",
              "      (void)dst;"),
             ("        stage_inputs<C>(dst, src, lo + 2 * R, T, U1, cw, lane);", "        (void)dst;")]
FWD_STORE = [("        flush_outputs<C>(out, from, lo - R, T, U1, cw, lane);", "        (void)from;"),
             ("    flush_outputs<C>(out, from, (nblk - 1) * R, T, U1, cw, lane);",
              "    (void)from;")]
FWD_RINGS = [("        nb[j] = pb[j * 32];\n        ne[j] = pe[j * 32];",
              "        nb[j] = -0.7f;\n        ne[j] = -0.7f;"),
             ("          nb[j] = pb[sn * S + j * 32];\n          ne[j] = pe[sn * S + j * 32];",
              "          nb[j] = -0.7f;\n          ne[j] = -0.7f;"),
             ("          pa[s * S + j * 32] = al[j];\n", "")]
BWD_STAGE = [("      if (k < nblk) stage_inputs<C>(dst, src, lo_of(k), T, U1, cw, lane);",
              "      (void)dst;"),
             ("        stage_inputs<C>(dst, src, lo - 2 * R, T, U1, cw, lane);", "        (void)dst;")]
BWD_STORE = [("        flush_outputs<C>(out, from, lo + R, T, U1, cw, lane);", "        (void)from;"),
             ("    flush_outputs<C>(out, from, lo_of(nblk - 1), T, U1, cw, lane);",
              "    (void)from;")]
FWD_CHAIN = [("      for (int s = 0; s < R; ++s) {", "      for (int s = 0; s < 0; ++s) {")]
BWD_CHAIN = [("      for (int s = R - 1; s >= 0; --s) {", "      for (int s = R - 1; s >= R; --s) {")]
BWD_SCALE = [("  for (int t0 = (tid >> 5) * 4; t0 < T; t0 += wf_threads(C) / 8) {",
              "  for (int t0 = (tid >> 5) * 4; t0 < 0; t0 += wf_threads(C) / 8) {")]
BWD_RINGS = [("        nb[j] = pb[(R - 1) * S + j * 32];\n        ne[j] = pe[(R - 1) * S + j * 32];\n"
              "        na[j] = pa[(R - 1) * S + j * 32];",
              "        nb[j] = -0.7f;\n        ne[j] = -0.7f;\n        na[j] = -0.7f;"),
             ("          nb[j] = pb[sp * S + j * 32];\n          ne[j] = pe[sp * S + j * 32];\n"
              "          na[j] = pa[sp * S + j * 32];",
              "          nb[j] = -0.7f;\n          ne[j] = -0.7f;\n          na[j] = -0.7f;"),
             ("        for (int j = 0; j < C; ++j) {\n          const float ob",
              "        for (int j = 0; j < 0; ++j) {\n          const float ob"),
             ("        if (lane == 0 && d >= 0 && d < T) srow[d] = rs[0];\n", "")]


def _in_order(*groups):
    """The substitutions of ``groups`` sorted by where they apply in the
    source (``variant_source`` applies them in order)."""
    from conformer_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / f"{SRC}.cu").read_text()
    subs = [s for g in groups for s in g]
    return sorted(subs, key=lambda s: text.find(s[0]))


def ablations() -> list:
    """(name, source, substitutions) of every variant."""
    return [
        ("base", SRC, []),
        ("no staging copies", SRC, _in_order(FWD_STAGE, BWD_STAGE)),
        ("no output stores", SRC, _in_order(FWD_STORE, BWD_STORE)),
        ("bwd: no scale pass", SRC, _in_order(BWD_SCALE)),
        ("no wavefront (the copies alone)", SRC, _in_order(FWD_CHAIN, BWD_CHAIN, BWD_SCALE)),
        ("chain floor", SRC, _in_order(FWD_STAGE, FWD_RINGS, FWD_STORE, BWD_STAGE, BWD_RINGS,
                                       BWD_STORE, BWD_SCALE)),
    ]


ABLATIONS = ablations()
SHAPES = ((32, 374, 64), (4, 412, 200))


def device_us(fn, name: str, n: int = 20, tries: int = 3) -> float:
    """Mean device microseconds of a launch of the kernel whose name holds
    ``name`` (one a call of ``fn``), over the launches that the trace of
    ``n`` calls recorded; a trace that recorded none is taken again, up to
    ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if us:
            return sum(us) / len(us)
    raise SystemExit(f"torch.profiler recorded no {name} launch in {tries} traces")


def build_parent(cuda_build, parent: str) -> ctypes.CDLL:
    """nvcc the parent checkout's rnnt_lattice.cu (its own headers) into
    build/rnnt_lattice_ablation/parent/."""
    csrc = os.path.join(parent, "conformer_tpu_torch", "csrc")
    out = os.path.join(REPO, "build", "rnnt_lattice_ablation", "parent")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "k.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-o", so,
                           os.path.join(csrc, f"{SRC}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for the parent's {SRC}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so)


def main() -> int:
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops import rnnt_lattice as rl
    from torch_attention_ablation import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rnnt_lattice_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = {name: lib for (name, _), lib in build(cuda_build, ABLATIONS,
                                                   "rnnt_lattice_ablation").items()}
    if args.parent:
        libs["parent"] = build_parent(cuda_build, args.parent)
    for lib in libs.values():
        lib.rnnt_lattice_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        lib.rnnt_lattice_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    P = cuda_build.ptr
    gen = torch.Generator().manual_seed(1)
    times = {}
    for b, t, u in SHAPES:
        x = cs.training_kernel_inputs("cuda", gen, b, t, u, 64)
        lpb, lpe, tl, ul, g = x["lp_blank"], x["lp_emit"], x["t_len"], x["u_len"], x["g"]
        nll, alpha = rl.rnnt_lattice_plain_fwd(lpb, lpe, tl, ul)
        outs = [torch.empty_like(alpha) for _ in range(3)] + [torch.empty_like(nll)]
        st = cuda_build.stream_ptr(lpb)

        def calls(lib):
            def fwd():
                err = lib.rnnt_lattice_fwd(P(lpb), P(lpe), P(tl), P(ul), P(outs[3]), P(outs[0]),
                                           st, b, t, u + 1)
                if err:
                    raise SystemExit(f"{SRC} fwd: CUDA error {err}")

            def bwd():
                err = lib.rnnt_lattice_bwd(P(lpb), P(lpe), P(alpha), P(tl), P(ul), P(nll), P(g),
                                           P(outs[1]), P(outs[2]), st, b, t, u + 1)
                if err:
                    raise SystemExit(f"{SRC} bwd: CUDA error {err}")
            return fwd, bwd

        key = f"B={b} T'={t} U={u}"
        runs = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                fwd, bwd = calls(libs[name])
                runs[name].append((device_us(fwd, "rnnt_lattice_fwd"),
                                   device_us(bwd, "rnnt_lattice_bwd")))
        times[key] = {}
        for name, r in runs.items():
            f = [x for x, _ in r]
            bw = [y for _, y in r]
            times[key][name] = {"fwd_us": f, "bwd_us": bw}
            print(f"ablation: rnnt lattice f32 {key}: {name}: fwd {f[0]:.2f}, {f[1]:.2f} us; "
                  f"bwd {bw[0]:.2f}, {bw[1]:.2f} us")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
