#!/usr/bin/env python3
"""Where the time of the bf16 full-lattice joint kernels, and of the wide
route's forward and backward in both dtypes, goes on the GPU, by
ablation, for the PyTorch/CUDA port (``conformer_tpu_torch``).

    python3 scripts/torch_joint_ablation.py

As ``scripts/torch_attention_ablation.py`` does for attention: copies of
``csrc/joint_lattice.cu`` with one stage of a wgmma kernel taken out are
built and timed against the unchanged source on the same inputs: the
difference bounds what that stage costs where it does not overlap the
rest. The narrow forward's stages ("fwd: ..."): the logits product, the
exps of the online logsumexp, the TMA copies of the W stages, the tanh of
the x tiles. The narrow backward's: the logits product, the exp of the dl
epilogue, the second product, the TMA copies of the streamed tiles, the
named barrier that hands dl between the consumer warpgroups, the extra
grids around the main one. The wide forward's ("wide fwd: ..."): the
logits product and its copies (cut to one K slab of J), the exps of the
logsumexp epilogue, the stores of its (max, sum) partials, the combine
grid. The wide backward's ("wide: ...", timed on the wide forward too,
whose grids share joint_gemm_kernel and joint_tile_kernel): the logits
product and its copies (cut to one K slab of J), the exps of the dl
epilogue, the dl stores (dl's hand-over to the second product through
device memory: the design has no cluster exchange), the second product
and its copies (cut to one K slab), every TMA copy of every product, the
grids that write x and W^T in the operands' layouts. The ablated copies
compute wrong results; only their times mean anything. One copy
("route: ...") is no ablation: its wide forward entry also takes the
bf16 widths of the narrow forward, so that both forwards are timed on the
same inputs at Conformer-M's and -L's J 512 and 640 (B=8, T'=374,
U+1=65, V=5002), the choice of ``NARROW_FWD_J_BF16``. Shapes:
chip_smoke.py's training shape of the joint (B=32, T'=374, U+1=65,
J=512, V=5002), bf16 enc and float32 pred as the model gives them; the
wide route at scripts/torch_width_times.py's B=8, T'=374, U+1=65, V=5002
in bf16 at J 1024 and float32 at J 640. Each C entry
(``joint_lattice_fwd``, ``joint_lattice_bwd_xp``, ``joint_lattice_bwd_w``,
the ``_wide`` ones, all of each one's grids) is timed with CUDA events,
mean of 5 after a warm-up (chip_smoke.time_ms): the base copy all of
them, a narrow forward ablation the narrow forward, a narrow backward one
both narrow backward entries, a wide forward one the wide forward, a
wide one every wide entry in both dtypes. The copies build with nvcc
into the checkout's git-ignored build/joint_ablation/. The last line is
one JSON object of all times in ms. Needs a CUDA device; imports nothing
of JAX.
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
WIDE_LOGITS = ("launch_gemm<T, 128>(x_op, wt_op, J, 1, dl_epi, st)",
               "launch_gemm<T, 256>(x_op, wt_op, J, 1, dl_epi, st)")
WIDE_SECOND = ("launch_gemm<T, 128>(dl_op, w_op, Vp, 1, dpre_epi, st)",
               "launch_gemm<T, 128>(dl_op, w_op, Vp, 1, dpre_epi, st)",
               "launch_gemm<T, 256>(dl_op, w_op, Vp, 1, dpre_epi, st)",
               "launch_gemm<T, 128>(xt_op, dl_op, rows, n_split, part_epi, st)",
               "launch_gemm<T, 256>(xt_op, dl_op, rows, n_split, part_epi, st)")
WIDE_LOADS = ("        hop::mbar_expect(&full[st], G::STAGE);\n"
              "        unsigned char* d = ring + st * G::STAGE;\n"
              "        hop::tma_load(d, &a_hi, &full[st], kc, m0);\n"
              "        hop::tma_load(d + G::A_BYTES, &b_hi, &full[st], kc, n0);\n"
              "        if constexpr (kTf32) {\n"
              "          hop::tma_load(d + G::COPY, &a_lo, &full[st], kc, m0);\n"
              "          hop::tma_load(d + G::COPY + G::A_BYTES, &b_lo, &full[st], kc, n0);\n"
              "        }\n")
WIDE_FWD_LOGITS = "launch_gemm<T, BN>(x_op, wt_op, J, 1, epi, st)"
WIDE_FWD_EXPS = "s += __expf(acc[4 * i + 2 * h] - mx) + __expf(acc[4 * i + 2 * h + 1] - mx);"
WIDE_FWD_GATE = "if (!j_routed(J) || fwd_narrow(J, is_bf16) || Vp % FWD_VT || chunk <= 0"
WIDE_DL_STORES = ("      if (v < Vp) {\n#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n"
                  "          const int r = m + r0 + 8 * h;\n          if (r >= rows) continue;\n")


def one_slab(texts, k: str):
    """Substitutions that give each launch in ``texts`` (in source order)
    a K of 1: its grid copies and multiplies one K slab (64 bf16 or 32
    float32 values) of its J or Vp or chunk, and runs the whole epilogue."""
    return [(t, t.replace(f", {k}, ", ", 1, ", 1)) for t in texts]

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
     [("  *launched = 1;\n  joint_reduce_xp_kernel<<<", "  *launched = 1;\n  if (0) joint_reduce_xp_kernel<<<"),
      ("  joint_x_kernel<bf16, TP><<<", "  if (0) joint_x_kernel<bf16, TP><<<"),
      ("  joint_reduce_w_kernel<<<", "  if (0) joint_reduce_w_kernel<<<")]),
    ("fwd: no logits product", SRC,
     [("        for (int kk = 0; kk < 4; ++kk)\n          hop::wgmma<128, 0, 1>",
       "        for (int kk = 0; kk < 0; ++kk)\n          hop::wgmma<128, 0, 1>")]),
    ("fwd: no exp (sum of logit - max)", SRC,
     [("s += __expf(acc[4 * i + 2 * h] - mn) + __expf(acc[4 * i + 2 * h + 1] - mn);",
       "s += (acc[4 * i + 2 * h] - mn) + (acc[4 * i + 2 * h + 1] - mn);")]),
    ("fwd: no TMA copies", SRC, [(FWD_LOADS, "          hop::mbar_arrive(&full[st]);\n")]),
    ("wide: logits product cut to one K slab", SRC,
     one_slab([WIDE_LOGITS[0], WIDE_LOGITS[1], WIDE_LOGITS[0], WIDE_LOGITS[1]], "J")),
    ("wide: no exp (p = logit)", SRC,
     [("const float p = __expf(acc[4 * i + 2 * h + e] + bv - k.lz);",
       "const float p = acc[4 * i + 2 * h + e];")]),
    ("wide: no dl stores", SRC, [(WIDE_DL_STORES, WIDE_DL_STORES.replace("v < Vp", "v < 0"))]),
    ("wide: second product cut to one K slab", SRC,
     one_slab(WIDE_SECOND[:3], "Vp") + one_slab(WIDE_SECOND[3:], "rows")),
    ("wide: no TMA copies", SRC, [(WIDE_LOADS, "        hop::mbar_arrive(&full[st]);\n")]),
    ("wide: no x and W^T grids", SRC,
     [("  joint_tile_kernel<T, kSplit, Src><<<", "  if (0) joint_tile_kernel<T, kSplit, Src><<<")]),
    ("wide fwd: logits product cut to one K slab", SRC, one_slab([WIDE_FWD_LOGITS], "J")),
    ("wide fwd: no exps (sum of logit - max)", SRC,
     [(WIDE_FWD_EXPS, WIDE_FWD_EXPS.replace("__expf", ""))]),
    ("wide fwd: no partials' stores", SRC, [("      if (q == 0) {\n        pmax[",
                                             "      if (q == 0 && cell < 0) {\n        pmax[")]),
    ("wide fwd: no combine grid", SRC,
     [("  joint_lse_combine_kernel<<<", "  if (0) joint_lse_combine_kernel<<<")]),
    ("route: the wide forward at the narrow widths", SRC,
     [(WIDE_FWD_GATE, WIDE_FWD_GATE.replace(" fwd_narrow(J, is_bf16) ||", ""))]),
    ("fwd: no tanh (x = enc + pred)", SRC,
     [(FWD_FILL, FWD_FILL),
      ("x0 = to_f(joint_x<bf16, TP>(e[0], p[0]));\n          x1 = to_f(joint_x<bf16, TP>(e[1], p[1]));",
       "x0 = to_f(e[0]) + to_f(p[0]);\n          x1 = to_f(e[1]) + to_f(p[1]);")]),
]


# the wide route's shapes: (label, B, T', U, V, J, enc dtype), as
# scripts/torch_width_times.py's rows
WIDE = (("bf16 J=1024", 8, 374, 64, 5002, 1024, "bfloat16"),
        ("f32 J=640", 8, 374, 64, 5002, 640, "float32"))


def wide_calls(cs, jl, cuda_build, gen, label, b, t, u, v, j, dt):
    """{key: fn(lib)} calling the wide C entries (forward and both
    backward entries) of a library on seeded inputs at one shape, with the
    wrappers' scratch."""
    import torch

    dtype = getattr(torch, dt)
    x = cs.joint_inputs("cuda", dtype, torch.float32, gen, b, t, u, v, j=j)
    enc, pred, w = jl.pad_join(x["enc"], x["pred"], x["w"])
    logz = jl.joint_lattice_fwd(x["enc"], x["pred"], x["w"], x["b"], x["lab"], 0)[2]
    wk, bk, vp = jl._operands(enc, w, x["b"])
    u1, m, f32 = u + 1, b * t * (u + 1), dtype == torch.float32
    chunk = jl._wide_chunk(m, vp, 8 if f32 else 2)
    n_split = jl._wide_splits(j, vp, f32)
    s = lambda n: jl._wide_scratch(enc, n)   # noqa: E731
    wt, wn = s(vp * j), (s(j * vp) if f32 else None)
    xbuf, xtbuf, dlbuf = s(chunk * j), s(j * chunk), s(vp * chunk)
    fl = dict(dtype=torch.float32, device="cuda")
    dpre, d_enc, d_pred = (torch.empty(z, **fl) for z in ((m, j), (b, t, j), (b, u1, j)))
    part, dbpart = torch.empty((n_split, j, vp), **fl), torch.empty((-(-m // 128), vp), **fl)
    dw, db = torch.empty((j, vp), **fl), torch.empty((vp,), **fl)
    grids = ctypes.c_int(0)
    P = cuda_build.ptr
    common = (P(enc), P(pred), P(wk), P(bk), P(x["lab"]), P(logz), P(x["g_blank"]),
              P(x["g_emit"]))
    flags = (int(not f32), 0)
    st = cuda_build.stream_ptr(enc)
    wf, bf, vpf = jl._operands(enc, w, x["b"], jl._FWD_V_TILE)
    fchunk = jl._wide_chunk(m, vpf, 8 if f32 else 2)
    wtf, xfbuf = s(vpf * j), s(fchunk * j)
    fpart = torch.empty((2, jl.fwd_tiles(vpf, f32), m), **fl)
    lp = [torch.empty((b, t, u1), **fl) for _ in range(3)]

    def fw(lib):
        fn = lib.joint_lattice_fwd_wide
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
        fn.restype = ctypes.c_int
        return fn(P(enc), P(pred), P(wf), P(bf), P(x["lab"]), *(P(o) for o in lp), P(wtf),
                  P(xfbuf), P(fpart), ctypes.addressof(grids), st, b, t, u1, j, v, vpf, 0,
                  fchunk, *flags)

    def xp(lib):
        fn = lib.joint_lattice_bwd_xp_wide
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
        fn.restype = ctypes.c_int
        return fn(*common, P(wt), None if wn is None else P(wn), P(xbuf), P(dlbuf), P(dpre),
                  P(d_enc), P(d_pred), ctypes.addressof(grids), st, b, t, u1, j, v, vp, 0,
                  chunk, *flags)

    def wg(lib):
        fn = lib.joint_lattice_bwd_w_wide
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 11
        fn.restype = ctypes.c_int
        return fn(*common, P(wt), P(xbuf), P(xtbuf), P(dlbuf), P(part), P(dbpart), P(dw), P(db),
                  ctypes.addressof(grids), st, b, t, u1, j, v, vp, 0, chunk, n_split, *flags)

    return {f"wide fwd {label}": fw, f"wide bwd_xp {label}": xp, f"wide bwd_w {label}": wg}


# the bf16 forward's narrow widths at which the route is timed both ways:
# (label, B, T', U, V, J), as scripts/torch_width_times.py's rows
ROUTE_FWD = (("M bf16 J=512", 8, 374, 64, 5002, 512), ("L bf16 J=640", 8, 374, 64, 5002, 640))


def route_calls(cs, jl, cuda_build, gen, label, b, t, u, v, j):
    """{key: fn(lib)}: the narrow forward entry and the wide one on the same
    seeded bf16 inputs (bf16 enc, float32 pred) at one of the narrow
    kernel's widths, the wide one with the wrapper's scratch."""
    import torch

    x = cs.joint_inputs("cuda", torch.bfloat16, torch.float32, gen, b, t, u, v, j=j)
    enc, pred = x["enc"], x["pred"]
    wf, bf, vpf = jl._operands(enc, x["w"], x["b"], jl._FWD_V_TILE)
    u1, m = u + 1, b * t * (u + 1)
    fl = dict(dtype=torch.float32, device="cuda")
    lp = [torch.empty((b, t, u1), **fl) for _ in range(3)]
    chunk = jl._wide_chunk(m, vpf, 2)
    wt, xbuf = jl._wide_scratch(enc, vpf * j), jl._wide_scratch(enc, chunk * j)
    part = torch.empty((2, jl.fwd_tiles(vpf, False), m), **fl)
    grids = ctypes.c_int(0)
    P = cuda_build.ptr
    common = (P(enc), P(pred), P(wf), P(bf), P(x["lab"]), *(P(o) for o in lp))
    st = cuda_build.stream_ptr(enc)

    def narrow(lib):
        fn = lib.joint_lattice_fwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
        fn.restype = ctypes.c_int
        return fn(*common, ctypes.addressof(grids), st, b, t, u1, j, v, vpf, 0, 1, 0)

    def wide(lib):
        fn = lib.joint_lattice_fwd_wide
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
        fn.restype = ctypes.c_int
        return fn(*common, P(wt), P(xbuf), P(part), ctypes.addressof(grids), st, b, t, u1, j, v,
                  vpf, 0, chunk, 1, 0)

    return {f"route fwd narrow {label}": narrow, f"route fwd wide {label}": wide}


def timed(name: str, key: str) -> bool:
    """Whether the copy ``name`` times the call ``key``: the base copy every
    call but the wide forward at the narrow widths (which its entry
    refuses), the route copy only those, an ablation the calls of its
    kind."""
    if key.startswith("route fwd"):
        return (name == "base") == key.startswith("route fwd narrow") and (
            name == "base" or name.startswith("route"))
    if name == "base":
        return True
    kind = name.split(":")[0] if ":" in name else "bwd"
    key_kind = "fwd" if key == "fwd" else "wide" if key.startswith("wide") else "bwd"
    return kind == key_kind or (kind == "wide fwd" and key.startswith("wide fwd"))


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
    wide = {}
    for shape in WIDE:
        wide.update(wide_calls(cs, jl, cuda_build, gen, *shape))
    for shape in ROUTE_FWD:
        wide.update(route_calls(cs, jl, cuda_build, gen, *shape))
    times = {}
    for (name, _), lib in libs.items():
        f_fn, xp_fn, w_fn = lib.joint_lattice_fwd, lib.joint_lattice_bwd_xp, lib.joint_lattice_bwd_w
        f_fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
        xp_fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
        w_fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
        f_fn.restype = xp_fn.restype = w_fn.restype = ctypes.c_int
        calls = {
            "fwd": lambda f=f_fn: f(P(enc), P(pred), P(wf), P(bf), P(x["lab"]),
                                    *(P(o) for o in fwd_out), ctypes.addressof(grids),
                                    cuda_build.stream_ptr(enc), b, t, u1, j, v, vpf, 0, 1, 0),
            "bwd_xp": lambda f=xp_fn: f(*common, P(dpre), P(d_enc), P(d_pred),
                                        ctypes.addressof(grids), cuda_build.stream_ptr(enc), b, t,
                                        u1, j, v, vp, 0, 1, 0),
            "bwd_w": lambda f=w_fn: f(*common, P(xbuf), P(part), P(dbpart), P(dw), P(db),
                                      ctypes.addressof(grids), cuda_build.stream_ptr(enc), b, t,
                                      u1, j, v, vp, 0, n_chunks, 1, 0),
            **{k: (lambda fn=fn, lb=lib: fn(lb)) for k, fn in wide.items()},
        }
        for key, call in calls.items():
            if not timed(name, key):
                continue
            err = call()
            if err != 0:
                raise SystemExit(f"{SRC} '{name}' {key}: CUDA error {err}")
            ms = cs.time_ms(call, 5)
            times[f"{key}: {name}"] = ms
            shape = "" if key.startswith(("wide", "route")) else f" B={b} T'={t} U+1={u1} V={v}"
            print(f"ablation: {key}{shape}: {name}: {ms:.4f} ms")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
