#!/usr/bin/env python3
"""Where the time of the two int8 serving kernels goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_int8_ablation.py

As ``scripts/torch_conv_ablation.py`` does for the conv block: copies of
``csrc/int8_matmul.cu`` and ``csrc/int8_ffn.cu`` with one stage taken out
are built and timed against the unchanged sources on the same inputs; the
difference bounds what that stage costs where it does not overlap the
rest. int8_matmul: the rows' quantization, the products, the weight
copies, the dequantized tile's staging in shared memory, the epilogue's
stores. int8_ffn: LayerNorm and the rows' int8, the products (both), the
weight copies, the swish, the hidden's int8 (its IEEE divisions), the
cluster's reduction of the partial sums with dequant, bias, residual and
the stores. A copy without its weight copies completes each ring stage by
a plain arrive, so the pipeline runs on stale tiles. The ablated copies
compute wrong results; only their times mean anything. Shapes, bf16:
int8_matmul at route A's M = 374 and route B's M = 48 x 374 = 17952 (K =
256, N = 2048); int8_ffn at M = 17952, Conformer-M's widths (D = 256, H =
2048) and -S's and -L's (144 / 576, 512 / 2048). Each kernel is timed on
the device by torch.profiler over 20 calls of the C entry (mean per call,
chip_smoke.device_ms).
The copies build with nvcc into the checkout's git-ignored
build/int8_ablation/. The last line is one JSON object of all times in us.
Needs a CUDA device; imports nothing of JAX.

The wide FFN route (D > 512 or H > 2048) at 6d (d)'s batch (M = 8 x 374 =
2992, D 1024 / H 4096), each of its launches by device time: WIDE takes
out its stages in this checkout's source (both GEMMs' products, their TMA
copies (each stage's transaction count completed by hand), their
epilogue stores; the hidden GEMM's swish; its stores of h and the
partial maxima). With ``--parent DIR`` (a
checkout unpacked with git archive into the ignored build/) FIRST_WIDE
does the same for the first wide design, which that checkout still has:
its four launches (ffn_norm_quant_kernel, ffn_gemm_kernel<0> for the
hidden, ffn_hidden_quant_kernel, ffn_gemm_kernel<1> for the output) and,
inside the two GEMMs, the products, the TMA copies and the epilogue
stores, under "parent" in the keys.

    python3 scripts/torch_int8_ablation.py [--parent build/parent] [--wide-only]
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

MM, FFN = "int8_matmul", "int8_ffn"
NO_TMA = ('asm volatile("mbarrier.complete_tx.shared::cta.b64 [%0], %1;\\n" ::'
          '"r"(hopper::saddr(bar)), "r"(pg::STAGE) : "memory");')
# (name, source, [(text, replacement), ...]), applied in order: the
# matmul and the narrow (cluster) FFN
NARROW = [
    ("base", MM, []),
    ("matmul: no quantization", MM,
     [("  for (int r0 = R * warp; r0 < 64; r0 += 8 * R) {",
       "  for (int r0 = R * warp; r0 < 0; r0 += 8 * R) {")]),
    ("matmul: no products", MM,
     [("        hopper::wgmma_s8_n64(acc, hopper::desc(aa",
       "        if (false) hopper::wgmma_s8_n64(acc, hopper::desc(aa")]),
    ("matmul: no weight copies", MM,
     [("          hopper::mbar_expect(&full[st], STAGE);\n"
       "          hopper::tma_load(ring + st * STAGE, &wmap, &full[st], 128 * kc, n0);",
       "          hopper::mbar_arrive(&full[st]);")]),
    ("matmul: no staging", MM,
     [("          store2(reinterpret_cast<T*>(stg_c", "          if (false) store2(reinterpret_cast<T*>(stg_c")]),
    ("matmul: no epilogue stores", MM,
     [("          hopper::tma_store(&omap,", "          if (false) hopper::tma_store(&omap,")]),
    ("base", FFN, []),
    ("ffn: no LayerNorm and x int8", FFN,
     [("    norm_rows<2>(x, lns, lnb, a1s, xss,", "    if (false) norm_rows<2>(x, lns, lnb, a1s, xss,")]),
    ("ffn: no products", FFN,
     [("      hopper::wgmma_s8_n128(acc, hopper::desc(a + kc",
       "      if (false) hopper::wgmma_s8_n128(acc, hopper::desc(a + kc")]),
    ("ffn: no weight copies", FFN,
     [("  hopper::mbar_expect(&full[st], STAGE);\n"
       "  hopper::tma_load(ring + st * STAGE, map, &full[st], k0, n0);",
       "  hopper::mbar_arrive(&full[st]);")]),
    ("ffn: no swish", FFN, [("          float h = swish(", "          float h = (")]),
    ("ffn: no hidden int8", FFN,
     [("        const uint32_t q0 = quant_bits(__int_as_float(acc[s][4 * i + 2 * hh]), sh[hh]);\n"
       "        const uint32_t q1 = quant_bits(__int_as_float(acc[s][4 * i + 2 * hh + 1]), sh[hh]);",
       "        const uint32_t q0 = acc[s][4 * i + 2 * hh];\n"
       "        const uint32_t q1 = acc[s][4 * i + 2 * hh + 1];")]),
    ("ffn: no reduction and stores", FFN,
     [("  for (int idx = tid - 128; idx < 16 * d4; idx += CONSUMERS) {",
       "  for (int idx = tid - 128; idx < 0; idx += CONSUMERS) {")]),
]
# the first wide design, ablated in a --parent checkout that still has it (a
# tree from before hopper_gemm.cuh). Kept, with --parent, while PERF.md cites
# the parent's split it measured (runs DJ, DN, DR); both go when those
# entries are merged away.
FIRST_WIDE = [
    ("base", FFN, []),
    ("no GEMM products", FFN,
     [("      hopper::wgmma_s8_n128(acc, hopper::desc(a + kk * 32), hopper::desc(b + kk * 32),",
       "      if (false) hopper::wgmma_s8_n128(acc, hopper::desc(a + kk * 32), hopper::desc(b + kk * 32),")]),
    ("no GEMM TMA copies", FFN,
     [("        hopper::mbar_expect(&full[st], WG_STAGE);\n"
       "        unsigned char* dst = ring + st * WG_STAGE;\n"
       "        hopper::tma_load(dst, &amap, &full[st], 128 * g, m0);\n"
       "        hopper::tma_load(dst + WG_TILE, &bmap, &full[st], 128 * g, n0);",
       "        hopper::mbar_arrive(&full[st]);")]),
    ("no GEMM epilogue stores", FFN,
     [("          hout[(size_t)m * N + n] = swish(y);",
       "          if (y == 12345.f) hout[(size_t)m * N + n] = swish(y);"),
      ("          out[o] = from_f<T>(__fadd_rn(to_f(x[o]), __fmul_rn(half, y)));",
       "          if (y == 12345.f) out[o] = from_f<T>(__fadd_rn(to_f(x[o]), __fmul_rn(half, y)));")]),
]
# the wide route of this checkout
WIDE = [
    ("wide: base", FFN, []),
    ("wide: no GEMM products", FFN,
     [("        hopper::wgmma_s8_n128(a, hopper::desc(sa + kk * 32), hopper::desc(sb + kk * 32),",
       "        if (false) hopper::wgmma_s8_n128(a, hopper::desc(sa + kk * 32), hopper::desc(sb + kk * 32),")]),
    ("wide: no GEMM TMA copies", FFN,
     [("        hopper::tma_load(dst, &amap, bar, 128 * k, pg::TM * mt);\n"
       "        hopper::tma_load(dst + pg::A_BYTES, &bmap, bar, 128 * k, 128 * nt);",
       NO_TMA)]),
    ("wide: no GEMM epilogue stores", FFN,
     [("          if (m < M && nb + cc < ldo)", "          if (m < 0)"),
      ("          if (m >= M || n >= N) continue;\n          float xv[8];",
       "          if (m >= 0) continue;\n          float xv[8];")]),
    ("wide: no swish", FFN,
     [("            const float hv = swish(y) * (n < N ? 1.f : 0.f);",
       "            const float hv = y * (n < N ? 1.f : 0.f);")]),
    ("wide: no hidden stores (h, pmax)", FFN,
     [("        if (q == 0 && m < M) pmax", "        if (q == 0 && m < 0) pmax"),
      ("          if (m < M && nb + cc < ldo)", "          if (m < 0)")]),
]
ABLATIONS = NARROW + WIDE
WIDE_SHAPE = (2992, 1024, 4096)   # 6d (d): M, D, H
MM_ROWS = (374, 17952)
MM_K, MM_N = 256, 2048
FFN_M = 17952
FFN_WIDTHS = ((256, 2048), (144, 576), (512, 2048))


def wide_args(gen, m, d, h, first: bool):
    """The wide C entry's arguments: the first design's (five scratch
    tensors: xq, s_x, h, hq, s_h) or this checkout's
    (``int8_ffn.wide_scratch``)."""
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops import int8_ffn as f8
    from conformer_tpu_torch.ops.int8_matmul import kernel_layout

    P, dev, f32 = cuda_build.ptr, "cuda", torch.float32
    ln, _, _, w1, w2 = cs.int8_ffn_weights(dev, gen, d=d, h=h)
    x = torch.randn(m, d, generator=gen).to(dev, torch.bfloat16)
    w1t, w2t = kernel_layout(w1["kernel_q"]), kernel_layout(w2["kernel_q"])
    if first:
        scratch = (torch.empty((m, w1t.shape[1]), dtype=torch.int8, device=dev),
                   torch.empty((m,), dtype=f32, device=dev),
                   torch.empty((m, h), dtype=f32, device=dev),
                   torch.empty((m, w2t.shape[1]), dtype=torch.int8, device=dev),
                   torch.empty((m,), dtype=f32, device=dev))
        ptrs = [P(t) for t in scratch]
    else:
        scratch, ptrs = f8.wide_scratch(m, d, h, dev)
    out = torch.empty_like(x)
    keep = (ln, w1, w2, x, w1t, w2t, scratch, out)
    args = (P(x), P(ln["scale"]), P(ln["bias"]), P(w1t), P(w1["kernel_scale"]), P(w1["bias"]),
            P(w2t), P(w2["kernel_scale"]), P(w2["bias"]), P(out), *ptrs,
            cuda_build.stream_ptr(x), m, d, h, 1, 0.5, 1e-5)
    return keep, args


def time_wide(libs, first: bool, tag: str, gen, times: dict) -> None:
    from torch_conv_ablation import launch_us

    m, d, h = WIDE_SHAPE
    keep, args = wide_args(gen, m, d, h, first)
    n_ptrs = len(args) - 6
    for (name, _), lib in libs.items():
        fn = lib.int8_ffn_wide_fwd
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
        fn.restype = ctypes.c_int
        call = lambda fn=fn: fn(*args)  # noqa: E731
        err = call()
        if err != 0:
            raise SystemExit(f"{FFN} wide{tag} '{name}': CUDA error {err}")
        us = launch_us(call)
        for kern, v in us.items():
            times[f"int8_ffn wide{tag} M={m} D={d} H={h} {kern}: {name}"] = v
        print(f"ablation: int8_ffn bf16 wide{tag} M={m} D={d} H={h}: {name}: "
              + ", ".join(f"{kern} {v:.2f} us" for kern, v in us.items())
              + f"; total {sum(us.values()):.2f} us", flush=True)
    del keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout with the first wide design, ablated beside")
    ap.add_argument("--wide-only", action="store_true", help="skip the matmul and the narrow FFN")
    opts = ap.parse_args()
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops.int8_matmul import kernel_layout
    from torch_attention_ablation import build

    if not torch.cuda.is_available():
        print("torch_int8_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(cuda_build, WIDE if opts.wide_only else ABLATIONS, "int8_ablation")
    gen = torch.Generator().manual_seed(0)
    dev, bf16 = "cuda", torch.bfloat16
    P = cuda_build.ptr
    times = {}
    if opts.parent:
        parent = build(cuda_build, FIRST_WIDE, "int8_ablation/parent",
                       csrc=os.path.join(opts.parent, "conformer_tpu_torch", "csrc"))
        time_wide(parent, True, " parent", gen, times)
    wide = {n for n, _, _ in WIDE}
    time_wide({key: lib for key, lib in libs.items() if key[0] in wide}, False, "", gen, times)
    if opts.wide_only:
        print(json.dumps(times))
        return 0

    def run(label, lib_name, fn_name, n_ptrs, n_ints, n_floats, args, kernel):
        for (name, source), lib in libs.items():
            if source != lib_name or name in wide:
                continue
            fn = getattr(lib, fn_name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                           + [ctypes.c_float] * n_floats)
            fn.restype = ctypes.c_int
            call = lambda fn=fn: fn(*args)  # noqa: E731
            err = call()
            if err != 0:
                raise SystemExit(f"{lib_name} '{name}' {label}: CUDA error {err}")
            ms = cs.device_ms(call, kernel)
            if ms is None:
                raise SystemExit(f"{lib_name} '{name}' {label}: the trace recorded no launch")
            times[f"{label}: {name}"] = ms * 1e3
            print(f"ablation: {label}: {name}: {ms * 1e3:.2f} us", flush=True)

    _, _, _, w1, _ = cs.int8_ffn_weights(dev, gen, d=MM_K, h=MM_N)
    w_t = kernel_layout(w1["kernel_q"])
    for m in MM_ROWS:
        x = torch.randn(m, MM_K, generator=gen).to(dev, bf16)
        out = torch.empty((m, MM_N), dtype=bf16, device=dev)
        args = (P(x), P(w_t), P(w1["kernel_scale"]), P(out), cuda_build.stream_ptr(x),
                m, MM_K, MM_N, 1)
        run(f"int8_matmul bf16 M={m} K={MM_K} N={MM_N}", MM, "int8_matmul_fwd", 5, 4, 0, args,
            "int8_matmul_kernel")
    for d, h in FFN_WIDTHS:
        ln, _, _, w1, w2 = cs.int8_ffn_weights(dev, gen, d=d, h=h)
        x = torch.randn(FFN_M, d, generator=gen).to(dev, bf16)
        out = torch.empty_like(x)
        args = (P(x), P(ln["scale"]), P(ln["bias"]), P(kernel_layout(w1["kernel_q"])),
                P(w1["kernel_scale"]), P(w1["bias"]), P(kernel_layout(w2["kernel_q"])),
                P(w2["kernel_scale"]), P(w2["bias"]), P(out), cuda_build.stream_ptr(x),
                FFN_M, d, h, 1, 0.5, 1e-5)
        run(f"int8_ffn bf16 M={FFN_M} D={d} H={h}", FFN, "int8_ffn_fwd", 11, 4, 2, args,
            "int8_ffn_kernel")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
