#!/usr/bin/env python3
"""Where the time of the fbank kernel goes on the GPU, by ablation, for the
PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_fbank_ablation.py [--parent DIR]

As ``scripts/torch_ctc_dp_ablation.py`` does for the CTC DP: copies of
``csrc/fbank.cu`` with stages taken out are built and timed against the
unchanged source on the same inputs; the difference bounds what a stage
costs where it does not overlap the rest. The stages: the staging copy of
each tile's span of samples into shared memory ("no staging copy"); the
dither's Box-Muller and with it its hashes ("no dither": each normal is a
constant; at dither 1 only); the FFT ("no FFT": its passes after the
first, which is fused with the framing, and the split pass); the mel sum,
the log and the store ("no mel, log or store"); the mel sum alone ("no
mel sum": each bin takes its first four weights); all but the staging, the
framing and the first pass. Probes: the dither's logf and cosf as the
__logf and __cosf intrinsics (cos over [-pi, pi)); the two dithers' warps
a block swapped; at most 64 registers a thread without dither (at least 4
blocks an SM). The ablated copies compute wrong results; only their
times mean anything. With ``--parent DIR`` (a checkout of an earlier
commit, e.g. unpacked by ``git archive`` into the git-ignored
``build/``), its ``fbank.cu`` is built and timed on the same inputs as
"parent", through its own C entry (the first design's: the DFT as cos and
sin products, the dense mel product).

Shape: chip_smoke.py's, 48 utterances of 15 s of seeded speech-like audio
(16 kHz, 25 ms frames, padded 512, 80 mel bins: 71,904 frames), float32,
dither 0 and 1. Each kernel is timed on the device by torch.profiler over
20 calls of the C entry (the mean over the launches the trace recorded),
every variant twice, in turn and then in reverse order. The copies build
with nvcc into the checkout's git-ignored build/fbank_ablation/. The last
line is one JSON object of all times in us. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

SRC = "fbank"
# the texts each stage's removal substitutes
STAGING = [("  if ((int)threadIdx.x < h) cp_async4(span + threadIdx.x, g + threadIdx.x);\n"
            "  for (int q = threadIdx.x; q < n16; q += kThreads) cp_async16(span + h + 4 * q, "
            "g + h + 4 * q);\n"
            "  if ((int)threadIdx.x < len - tail) cp_async4(span + tail + threadIdx.x, "
            "g + tail + threadIdx.x);\n",
            "  (void)g;\n  (void)n16;\n  (void)tail;\n")]
DITHER = [("  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);",
           "  (void)u1;\n  (void)u2;\n  return 0.5f;")]
FFT = [("      fft<N, R1, REG>(buf, twp, twr, lane);\n", ""),
       ("      fft<N, 1, REG>(buf, twp, twr, lane);\n", ""),
       ("    split_power<N>(buf, pw + f * (N + 3), twp, lane);\n",
        "    pw[f * (N + 3) + lane] = buf[lane].x;\n")]
MEL_LOG_STORE = [("  for (int m0 = warp; m0 < nmel; m0 += 32 * kWarps) {",
                  "  for (int m0 = warp; m0 < 0; m0 += 32 * kWarps) {"),
                 ("  for (int f = warp; f < nfr; f += kWarps)\n    for (int m = lane;",
                  "  for (int f = warp; f < 0; f += kWarps)\n    for (int m = lane;")]
MEL_SUM = [("      for (int j = 0; j < max(ca, cb); j += 4) {",
            "      for (int j = 0; j < min(max(ca, cb), 1); j += 4) {")]
FAST_DITHER = [("  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);",
                "  return sqrtf(-2.0f * __logf(u1)) * -__cosf(kTwoPi * (u2 - 0.5f));")]
WARPS_SWAPPED = [("__host__ __device__ constexpr int warps_of() { return DITHER ? 16 : 8; }",
                  "__host__ __device__ constexpr int warps_of() { return DITHER ? 8 : 16; }")]
REGS_64 = [("return N > 256 ? 1 : DITHER ? 2 : 3;", "return N > 256 ? 1 : DITHER ? 2 : 4;")]

ABLATIONS = [
    ("base", SRC, []),
    ("no staging copy", SRC, STAGING),
    ("no dither", SRC, DITHER),
    ("no FFT", SRC, FFT),
    ("no mel, log or store", SRC, MEL_LOG_STORE),
    ("no mel sum", SRC, MEL_SUM),
    ("framing and first pass only", SRC, FFT + MEL_LOG_STORE),
    ("probe: dither by __logf, __cosf", SRC, FAST_DITHER),
    ("probe: 16 warps a block at dither 0, 8 at dither 1", SRC, WARPS_SWAPPED),
    ("probe: up to 64 registers at dither 0", SRC, REGS_64),
]
BATCH, SECONDS = 48, 15.0


def build_parent(cuda_build, parent: str) -> ctypes.CDLL:
    """nvcc the parent checkout's fbank.cu into build/fbank_ablation/parent/."""
    csrc = os.path.join(parent, "conformer_tpu_torch", "csrc")
    out = os.path.join(REPO, "build", "fbank_ablation", "parent")
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
    from conformer_tpu_torch.ops import fbank_kernel as fk
    from conformer_tpu_torch.ops.fbank import frame_params, num_frames
    from torch_attention_ablation import build
    from torch_rnnt_lattice_ablation import device_us

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fbank_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = {name: lib for (name, _), lib in build(cuda_build, ABLATIONS, "fbank_ablation").items()}
    for lib in libs.values():
        lib.fbank_features.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float]
    if args.parent:
        libs["parent"] = build_parent(cuda_build, args.parent)
        libs["parent"].fbank_features.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                                  + [ctypes.c_float])

    wavs = np.stack([cs.synthetic_wav(400 + i, SECONDS) for i in range(BATCH)])
    wave = torch.as_tensor((wavs * (1 << 15)).astype(np.float32), device="cuda")
    b, n = wave.shape
    ws, shift, padded = frame_params(16000.0, 25.0, 10.0)
    t = num_frames(n, ws, shift)
    _, _, window, cos_m, sin_m, mel_t = fk._constants(16000.0, 80, 25.0, 10.0, "cuda")
    _, tw, info, weights = fk._kernel_tables(16000.0, 80, 25.0, 10.0, "cuda")   # window as above
    out = torch.empty((b, t, 80), dtype=torch.float32, device="cuda")
    P = cuda_build.ptr
    st = cuda_build.stream_ptr(wave)

    def call(name, dither):
        lib = libs[name]

        def run():
            if name == "parent":
                err = lib.fbank_features(P(wave), P(window), P(cos_m), P(sin_m), P(mel_t), P(out),
                                         st, b, n, t, ws, shift, padded // 2, 80, 7, dither)
            else:
                err = lib.fbank_features(P(wave), P(window), P(tw), P(info), P(weights), P(out),
                                         st, b, n, t, ws, shift, padded, tw.shape[0], 80, 7,
                                         dither)
            if err:
                raise SystemExit(f"{SRC} '{name}': CUDA error {err}")
        return run

    times = {}
    for dither in (0.0, 1.0):
        runs = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                runs[name].append(device_us(call(name, dither), "fbank"))
        key = f"B={b} x {SECONDS} s ({b * t} frames), dither {dither:g}"
        times[key] = runs
        for name, r in runs.items():
            print(f"ablation: fbank {key}: {name}: {r[0]:.2f}, {r[1]:.2f} us")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
