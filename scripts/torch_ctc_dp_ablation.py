#!/usr/bin/env python3
"""Where the time of the CTC DP kernels goes on the GPU, by ablation, for
the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_ctc_dp_ablation.py [--parent DIR]

As ``scripts/torch_rnnt_lattice_ablation.py`` does for the transducer
lattice: copies of ``csrc/ctc_dp.cu`` with stages taken out are built and
timed against the unchanged source on the same inputs; the difference
bounds what a stage costs where it does not overlap the rest. The stages
of the chain kernels (``ctc_dp_fwd_chain`` and ``ctc_dp_bwd_chain``): the
stager warps' copies of the input frames into their rings and the chain
warps' reads of them ("no input loads"); the storer warps' stores of alpha
and g_emit, the forward's frozen tail and the backward's zeroed dead frames
("no output stores"); the backward's per-frame normalisation (its storers
write each occupancy times -g, without the frame's sum). The chain floor
takes out all of these and the chain warps' writes of alpha and of the
occupancies (and their exps) into the output ring: left are the same grid,
the same hand-overs between warps (slots and flags, the waits a chunk),
the same shuffles, and each state's update as the kernel computes it (two
nested MUFU logaddexps, the clamp, the length selects) on every step. Then
the same kernels with the row's states cut into at most 1 and 2 warps
instead of 4 (``CHAIN_WARPS``; 1 is one warp running the chain alone).
Probes: each state's two nested logaddexps replaced by one (what the
second costs on the chain), other counts of stager and storer warps, the
helper warps sleeping 32 ns between polls, the flags as release stores and
acquire loads without the block fences, and chunks of 4 steps at every C. The ablated copies compute
wrong results; only their times mean anything. With ``--parent DIR`` (a
checkout of an earlier commit, e.g. unpacked by ``git archive`` into the
git-ignored ``build/``), its ``ctc_dp.cu`` is built and timed on the same
inputs as "parent".

Shapes: the training shape of chip_smoke.py (B=32, T'=374, U=64: S = 129)
and the recipe's longest bucket with labels padded to 200 (B=4, T'=412,
U=200: S = 401), float32, inputs as chip_smoke.py makes them (V=64); the
backward from the plain version's alpha and NLL. Each kernel is timed on
the device by torch.profiler over 20 calls of the C entry (the mean over
the launches the trace recorded), every variant twice, in turn and then in
reverse order. The copies build with nvcc into the checkout's git-ignored
build/ctc_dp_ablation/. The last line is one JSON object of all times in
us. Needs a CUDA device; imports nothing of JAX.
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

SRC = "ctc_dp"
# the texts each stage's removal substitutes
STAGE = [("        for (int a = 0; a < N; ++a) cp_async4(d[a] + 4 * s, src[a] + (size_t)f * S + s);",
          "        (void)d;")]
FWD_READS = [("      load_states<C>(rk + i * FS, ein[i]);\n", "")]
BWD_READS = [("      load_states<C>(re + off + i * FS, ein[i]);\n      load_states<C>(ra + off + i * FS, ain[i]);",
              "      for (int j = 0; j < C; ++j) ein[i][j] = ain[i][j] = -0.7f;")]
STORE = [("        if (f[q] >= 0) out[(size_t)f[q] * S + s] = fr[q][s] * sc[q];",
          "        (void)f[q];")]
FWD_TAIL = [("      if (live[j]) out[(size_t)t * S + st[j]] = al[j];\n  }\n#pragma unroll",
             "      (void)al;\n  }\n#pragma unroll")]
BWD_ZEROS = [("      for (size_t i = (size_t)tz * S + tid - nc - 32 * STAGERS; i < (size_t)T * S; "
              "i += 32 * STORERS)\n        out[i] = 0.f;\n", "")]
BWD_SUM = [("    if (NORM) {\n      float sum[F];", "    if (NORM) {\n      for (int q = 0; q < F; ++q) sc[q] = -gg;\n    }\n    if (false) {\n      float sum[F];")]
FWD_RING_OUT = [("      store_states<C>(ok + i * FS, al);\n", "")]
BWD_OCC = [("        oc[j] = exp_fast(ain[i][j] + be[j] - logz);\n      }\n      store_states<C>(ok + i * FS, oc);",
            "      }")]
RELEASE_ACQUIRE = [
    ('  asm volatile("ld.volatile.shared.s32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");',
     '  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");'),
    ("      if (n == SPIN_LIMIT) __trap();\n  __threadfence_block();\n}",
     "      if (n == SPIN_LIMIT) __trap();\n}"),
    ("    __threadfence_block();\n    st_volatile(flag, v);",
     '    asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(smem_addr(flag)), "r"(v) : "memory");'),
    ("    if (n == SPIN_LIMIT) __trap();\n  }\n  __threadfence_block();\n}",
     "    if (n == SPIN_LIMIT) __trap();\n  }\n}")]
BACKOFF = [("    for (int n = 0; ld_volatile(flag + w) < v; ++n)\n      if (n == SPIN_LIMIT) __trap();",
            "    for (int n = 0; ld_volatile(flag + w) < v; ++n) {\n      if (n == SPIN_LIMIT) __trap();\n"
            "      __nanosleep(32);\n    }")]
ONE_LAE = [("  return lae_fast(lae_fast(x, n1), n2);", "  return lae_fast(x, fmaxf(n1, n2));")]


def warps(n: int, max_c: int) -> list:
    return [("constexpr int CHAIN_WARPS = 4;", f"constexpr int CHAIN_WARPS = {n};"),
            ("constexpr int CHAIN_MAX_C = 4;", f"constexpr int CHAIN_MAX_C = {max_c};")]


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
        ("no input loads", SRC, _in_order(STAGE, FWD_READS, BWD_READS)),
        ("no output stores", SRC, _in_order(STORE, FWD_TAIL, BWD_ZEROS)),
        ("bwd: no normalisation", SRC, _in_order(BWD_SUM)),
        ("chain floor", SRC, _in_order(STAGE, BWD_SUM, STORE, FWD_READS, FWD_RING_OUT, FWD_TAIL,
                                       BWD_ZEROS, BWD_READS, BWD_OCC)),
        ("W <= 1 (one warp)", SRC, _in_order(warps(1, 13))),
        ("W <= 2", SRC, _in_order(warps(2, 7))),
        ("probe: one logaddexp a state", SRC, _in_order(ONE_LAE)),
        ("probe: forward with 2 stagers", SRC,
         [("constexpr int FWD_STAGERS = 4;", "constexpr int FWD_STAGERS = 2;")]),
        ("probe: backward with 4 stagers", SRC,
         [("constexpr int BWD_STAGERS = 2;", "constexpr int BWD_STAGERS = 4;")]),
        ("probe: backward with 4 storers", SRC,
         [("constexpr int BWD_STORERS = 2;", "constexpr int BWD_STORERS = 4;")]),
        ("probe: forward with 2 storers", SRC, [("return c <= 2 ? 2 : 4;", "return 2;")]),
        ("probe: forward with 4 storers", SRC, [("return c <= 2 ? 2 : 4;", "return 4;")]),
        ("probe: helpers back off 32 ns a poll", SRC, BACKOFF),
        ("probe: release / acquire flags, no fences", SRC, _in_order(RELEASE_ACQUIRE)),
        ("probe: K = 4 at every C", SRC, [("return c <= 2 ? 8 : 4;", "return 4;")]),
    ]


ABLATIONS = ablations()
SHAPES = ((32, 374, 64), (4, 412, 200))


def build_parent(cuda_build, parent: str) -> ctypes.CDLL:
    """nvcc the parent checkout's ctc_dp.cu (its own headers) into
    build/ctc_dp_ablation/parent/."""
    csrc = os.path.join(parent, "conformer_tpu_torch", "csrc")
    out = os.path.join(REPO, "build", "ctc_dp_ablation", "parent")
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
    from conformer_tpu_torch.ops import ctc_dp as cd
    from conformer_tpu_torch.ops import cuda_build
    from torch_attention_ablation import build
    from torch_rnnt_lattice_ablation import device_us

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ctc_dp_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = {name: lib for (name, _), lib in build(cuda_build, ABLATIONS, "ctc_dp_ablation").items()}
    if args.parent:
        libs["parent"] = build_parent(cuda_build, args.parent)
    for lib in libs.values():
        lib.ctc_dp_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        lib.ctc_dp_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
    P = cuda_build.ptr
    gen = torch.Generator().manual_seed(1)
    times = {}
    for b, t, u in SHAPES:
        x = cs.training_kernel_inputs("cuda", gen, b, t, u, 64)
        emit, skip, tl, ul, g = x["emit"], x["skip"], x["t_len"], x["u_len"], x["g"]
        s = emit.shape[2]
        nll, alpha = cd.ctc_dp_plain_fwd(emit, skip, tl, ul)
        outs = [torch.empty_like(alpha) for _ in range(2)] + [torch.empty_like(nll)]
        st = cuda_build.stream_ptr(emit)

        def calls(lib):
            def fwd():
                err = lib.ctc_dp_fwd(P(emit), P(skip), P(tl), P(ul), P(outs[2]), P(outs[0]), st,
                                     b, t, s)
                if err:
                    raise SystemExit(f"{SRC} fwd: CUDA error {err}")

            def bwd():
                err = lib.ctc_dp_bwd(P(emit), P(skip), P(alpha), P(tl), P(ul), P(nll), P(g),
                                     P(outs[1]), st, b, t, s)
                if err:
                    raise SystemExit(f"{SRC} bwd: CUDA error {err}")
            return fwd, bwd

        key = f"B={b} T'={t} U={u}"
        runs = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                fwd, bwd = calls(libs[name])
                runs[name].append((device_us(fwd, "ctc_dp_fwd"), device_us(bwd, "ctc_dp_bwd")))
        times[key] = {}
        for name, r in runs.items():
            f = [y for y, _ in r]
            bw = [y for _, y in r]
            times[key][name] = {"fwd_us": f, "bwd_us": bw}
            print(f"ablation: ctc dp f32 {key} (S={s}): {name}: fwd {f[0]:.2f}, {f[1]:.2f} us; "
                  f"bwd {bw[0]:.2f}, {bw[1]:.2f} us")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
