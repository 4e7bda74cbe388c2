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

The wide bf16 route (D > 512 or K > 32) at 6d's decode shape (B=8,
T'=374, D=1024, K=15), each of its launches by device time
(ln_pre_bf16_kernel, conv_gemm_kernel<0>: pw1 and the GLU,
dw_ln_bf16_kernel, conv_gemm_kernel<1>: pw2 and the residual): WIDE takes
out its stages in this checkout's source (LN_pre; both products; both
GEMMs' TMA copies, each stage's transaction count completed by hand so the
products run on stale tiles; the g stores; the depthwise taps; LN + swish;
the residual stores). With ``--parent DIR`` (a
checkout unpacked with git archive into the ignored build/) FIRST_WIDE
does the same for the first wide design, which that checkout still has:
its launch 1 (pw1_glu_bf16_kernel<true>: LN_pre, the pw1 product, the W1
copies, the g stores) and launch 2 (dw_ln_pw2_bf16_wide_kernel: the
depthwise taps, LN + swish, the pw2 product, the W2 copies, the residual
stores), under "parent" in the keys.

    python3 scripts/torch_conv_ablation.py [--parent build/parent] [--wide-only]
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

SRC = "conv_block"
# (name, source, [(text, replacement), ...]), applied in order: the narrow
# bf16 kernels
NARROW = [
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
# the first wide design, ablated in a --parent checkout that still has it (a
# tree from before hopper_gemm.cuh). Kept, with --parent, while PERF.md cites
# the parent's split it measured (runs DJ, DN, DR); both go when those
# entries are merged away.
FIRST_WIDE = [
    ("base", SRC, []),
    ("no LN_pre", SRC,
     [("    if constexpr (WIDE) {\n      const float2 st = row_stats(yr, D, lane);",
       "    if constexpr (WIDE) {\n      continue;\n      const float2 st = row_stats(yr, D, lane);")]),
    ("no pw1 product", SRC, [("    if (live == 0) continue;", "    if (true) continue;")]),
    ("no W1 copies", SRC,
     [("      rel_attn::cp_async<16>(dst + r * Q1_LDW",
       "      if (0) rel_attn::cp_async<16>(dst + r * Q1_LDW")]),
    ("no g stores", SRC,
     [("        *reinterpret_cast<float2*>(glu + (size_t)m * D + ch) = make_float2(",
       "        if (false) *reinterpret_cast<float2*>(glu + (size_t)m * D + ch) = make_float2(")]),
    ("no depthwise", SRC,
     [("  depthwise_streamed(zs, gb, wd, bd, t0, Tlen, D, K);\n  __syncthreads();\n"
       "  for (int r = warp; r < W2_T; r += NT / 32) {   // LN, swish, rounded to bf16",
       "  __syncthreads();\n"
       "  for (int r = warp; r < W2_T; r += NT / 32) {   // LN, swish, rounded to bf16")]),
    ("no LN + swish", SRC,
     [("  for (int r = warp; r < W2_T; r += NT / 32) {   // LN, swish, rounded to bf16",
       "  for (int r = warp; r < 0; r += NT / 32) {   // LN, swish, rounded to bf16")]),
    ("no pw2 product", SRC,
     [("#pragma unroll\n    for (int j = 0; j < NT8; j += 2) {",
       "#pragma unroll\n    for (int j = 0; j < 0; j += 2) {")]),
    ("no W2 copies", SRC,
     [("    rel_attn::cp_async<16>(dst + r * ld + c, w2 + (size_t)(row0 + r) * D + (ok ? j : 0), ok);",
       "    if (0) rel_attn::cp_async<16>(dst + r * ld + c, w2 + (size_t)(row0 + r) * D + (ok ? j : 0), ok);")]),
    ("no residual stores", SRC,
     [("          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)t * D + c) = __floats2bfloat162_rn(",
       "          if (false) *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)t * D + c) = __floats2bfloat162_rn(")]),
]
# the wide route of this checkout. A copy without its TMA copies completes
# each stage's transaction count by hand, so the products run on stale tiles.
NO_TMA = ('asm volatile("mbarrier.complete_tx.shared::cta.b64 [%0], %1;\\n" ::'
          '"r"(hopper::saddr(bar)), "r"(pg::STAGE) : "memory");')
WIDE = [
    ("wide: base", SRC, []),
    ("wide: no LN_pre", SRC,
     [("    pg::unpack8(p < np ? xr[p] : make_uint4(0u, 0u, 0u, 0u), v[i]);",
       "    pg::unpack8(make_uint4(0u, 0u, 0u, 0u), v[i]);")]),
    ("wide: no products", SRC,
     [("        wq::wgmma_ss<128, 0, 1>(a, hopper::desc(sa + kk * 32),",
       "        if (false) wq::wgmma_ss<128, 0, 1>(a, hopper::desc(sa + kk * 32),")]),
    ("wide: no TMA copies", SRC,
     [("        hopper::tma_load(dst, &amap, bar, 64 * kc, pg::TM * mt);\n", NO_TMA + "\n"),
      ("        hopper::tma_load(dst + pg::A_BYTES, &bmap, bar, n0, 64 * kc);\n"
       "        hopper::tma_load(dst + pg::A_BYTES + pg::ATOM, &bmap, bar, n1, 64 * kc);\n", "")]),
    ("wide: no g stores", SRC,
     [("        if (m < M && c0 + cc < D)\n          *reinterpret_cast<float4*>(glu",
       "        if (m < 0)\n          *reinterpret_cast<float4*>(glu")]),
    ("wide: no depthwise", SRC,
     [("  depthwise_streamed(zs, gb, wd, bd, t0, Tlen, D, K);\n  __syncthreads();\n"
       "  for (int r = warp; r < W2_T && t0 + r < Tlen; r += NT / 32) {",
       "  __syncthreads();\n  for (int r = warp; r < W2_T && t0 + r < Tlen; r += NT / 32) {")]),
    ("wide: no LN + swish", SRC,
     [("  for (int r = warp; r < W2_T && t0 + r < Tlen; r += NT / 32) {",
       "  for (int r = warp; r < 0; r += NT / 32) {")]),
    ("wide: no residual stores", SRC,
     [("          if (m >= M || n >= D) continue;\n          const int bq = m / Tlen;",
       "          if (m >= 0) continue;\n          const int bq = m / Tlen;")]),
]
ABLATIONS = NARROW + WIDE
N_PTRS = 17          # the pointers of this checkout's C entry, its stream included
WIDTHS = (256, 144, 512)
B, T, K = 48, 374, 15
WIDE_SHAPE = (8, 374, 1024, 15)   # 6d's decode: B, T', D, K


def launch_us(fn, n: int = 20) -> dict:
    """Mean device microseconds per call of ``fn`` of each kernel it
    launches, by the kernel's name (its template arguments kept, its
    parameters dropped), over ``n`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / n
    return out


def conv_args(dev, gen, b, t, d, k, n_ptrs: int):
    """The C entry's arguments at one shape: 16 pointers (the first
    design's) or 17 (a bf16 operand scratch [B, T, D] after the glu
    scratch)."""
    import torch

    import chip_smoke as cs
    from conformer_tpu_torch.ops import conv_block as cb
    from conformer_tpu_torch.ops import cuda_build

    P = cuda_build.ptr
    x, lens, p_norm, p_conv = cs.conv_inputs(dev, torch.bfloat16, gen, b=b, t=t, d=d, k=k)
    w = cb.kernel_weights(p_norm, p_conv, x.dtype)
    keep = [x, lens, w, torch.empty_like(x), torch.empty((b, k - 1, d), dtype=x.dtype, device=dev),
            torch.empty((b, t, d), dtype=torch.float32, device=dev), torch.empty_like(x)]
    out, cache, glu, opnd = keep[3:]
    ptrs = [P(x), P(lens), P(w["pre_s"]), P(w["pre_b"]), P(w["w1"]), P(w["b1"]), P(w["wd"]),
            P(w["bd"]), P(w["ln_s"]), P(w["ln_b"]), P(w["w2"]), P(w["b2"]), P(out), P(cache),
            P(glu)] + ([P(opnd)] if n_ptrs == 17 else [])
    return keep, (*ptrs, cuda_build.stream_ptr(x), b, t, d, k, 1)


def time_wide(libs, n_ptrs: int, tag: str, gen, times: dict) -> None:
    b, t, d, k = WIDE_SHAPE
    keep, args = conv_args("cuda", gen, b, t, d, k, n_ptrs)
    for (name, _), lib in libs.items():
        fn = lib.conv_block_fwd
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
        call = lambda fn=fn: fn(*args)  # noqa: E731
        err = call()
        if err != 0:
            raise SystemExit(f"{SRC} {tag} '{name}' D={d}: CUDA error {err}")
        us = launch_us(call)
        for kern, v in us.items():
            times[f"wide{tag} B={b} D={d} K={k} {kern}: {name}"] = v
        print(f"ablation: conv bf16 wide{tag} B={b} T'={t} D={d} K={k}: {name}: "
              + ", ".join(f"{kern} {v:.2f} us" for kern, v in us.items())
              + f"; total {sum(us.values()):.2f} us", flush=True)
    del keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout with the first wide design, ablated beside")
    ap.add_argument("--wide-only", action="store_true", help="skip the narrow widths")
    opts = ap.parse_args()
    import torch

    from conformer_tpu_torch.ops import cuda_build
    from torch_attention_ablation import build

    if not torch.cuda.is_available():
        print("torch_conv_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(cuda_build, WIDE if opts.wide_only else ABLATIONS, "conv_ablation")
    gen = torch.Generator().manual_seed(0)
    times = {}
    if opts.parent:
        parent = build(cuda_build, FIRST_WIDE, "conv_ablation/parent",
                       csrc=os.path.join(opts.parent, "conformer_tpu_torch", "csrc"))
        time_wide(parent, 16, " parent", gen, times)
    wide = {n for n, _, _ in WIDE}
    time_wide({key: lib for key, lib in libs.items() if key[0] in wide}, N_PTRS, "", gen, times)
    for d in () if opts.wide_only else WIDTHS:
        keep, args = conv_args("cuda", gen, B, T, d, K, N_PTRS)
        for (name, _), lib in libs.items():
            if name in wide:
                continue
            fn = lib.conv_block_fwd
            fn.argtypes = [ctypes.c_void_p] * N_PTRS + [ctypes.c_int] * 5
            fn.restype = ctypes.c_int
            call = lambda fn=fn: fn(*args)  # noqa: E731
            err = call()
            if err != 0:
                raise SystemExit(f"{SRC} '{name}' D={d}: CUDA error {err}")
            us = launch_us(call)
            for key, v in us.items():
                times[f"D={d} {key}: {name}"] = v
            print(f"ablation: conv bf16 B={B} T'={T} D={d} K={K}: {name}: "
                  + ", ".join(f"{kern} {v:.2f} us" for kern, v in us.items()))
        del keep
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
