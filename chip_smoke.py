#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``conformer_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port starts, builds its kernels
and serves on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device  - CUDA present; print the card's name and power limit;
  2. build   - nvcc builds every kernel of the serving path from csrc/;
  3. kernels - each kernel against its plain PyTorch version at the decode
               shapes (B=48, T'=374, D=256, H=4) plus edge cases, in float32
               and bfloat16, with times of kernel, plain version and library
               call beside the bound;
  4. serve   - Conformer-M at full width (configs/conformer_m.json, both
               kernel flags on, random weights from a seed, +6 on the joint's
               blank bias) behind the port's REST server on 127.0.0.1: three
               synthetic wav requests must answer "success", and each kernel
               wrapper must count one launch per encoder layer per request;
  5. parity  - float32 kernel path vs plain path on the served weights and
               on the same weights without the blank bias, which emit on
               most frames (encoder outputs within 1e-3, identical
               hypotheses), then a bfloat16 decode of 48 x 15 s:
               audio-seconds per second and token agreement with the
               plain path.
The last two lines are the kernels JSON line and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

BF16_TFLOPS = 989.0      # H100 SXM dense bf16 tensor rate
F32_TFLOPS = 67.0        # H100 SXM float32 outside the tensor cores
HBM_TBPS = 3.35          # H100 SXM device memory rate
TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # abs and rel; bf16: ~1 ulp at |x| < 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ timing


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int, ops_time_s: float) -> tuple[float, str]:
    t_bytes = n_bytes / (HBM_TBPS * 1e12)
    return max(t_bytes, ops_time_s) * 1e3, "bytes" if t_bytes >= ops_time_s else "operations"


def max_err(got, want, tol: float) -> tuple[float, bool]:
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


# ----------------------------------------------------------------- kernels


def attention_inputs(dev, dtype, gen, b=48, h=4, t=374, dk=64, d=256):
    """Inputs of the decode shape: key padding with lengths [T, T-37, 1,
    ...], one dead query row and one zero-length row (all rows masked)."""
    import torch

    lens = torch.randint(t // 4, t + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([t, t - 37, 1])
    mask = (torch.arange(t)[None, None, :] < lens[:, None, None]).expand(b, t, t).clone()
    mask[1, 5, :] = False
    mask[2] = False
    q_u, k, v = (torch.randn(b, h, t, dk, generator=gen) for _ in range(3))
    ab = 0.2 * torch.randn(b, h, t, d, generator=gen)
    feats = torch.randn(t, d, generator=gen)
    cast = [x.to(dev, dtype) for x in (q_u, ab, k, v, feats)]
    return (*cast, mask.to(dev))


def conv_inputs(dev, dtype, gen, b=48, t=374, d=256, k=15):
    import torch

    lens = torch.randint(t // 4, t + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([t, t // 2, 1])

    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    p_conv = {
        "pointwise_conv1": {"kernel": u(1, d, 2 * d, bound=d ** -0.5), "bias": u(2 * d, bound=d ** -0.5)},
        "depthwise_conv": {"kernel": u(k, 1, d, bound=k ** -0.5), "bias": u(d, bound=k ** -0.5)},
        "norm": {"scale": 1 + u(d, bound=0.2), "bias": u(d, bound=0.1)},
        "pointwise_conv2": {"kernel": u(1, d, d, bound=d ** -0.5), "bias": u(d, bound=d ** -0.5)},
    }
    p_norm = {"scale": 1 + u(d, bound=0.1), "bias": u(d, bound=0.05)}
    x = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    return x, lens.to(dev, torch.int32), p_norm, p_conv


def check_kernels(dev) -> dict:
    """Each kernel vs its plain version in both dtypes; times and bounds
    at the bf16 decode shape (the main path's). Returns the JSON entries
    without ``launches``."""
    import torch

    from conformer_tpu_torch.ops.conv_block import conv_block, conv_block_plain, kernel_weights
    from conformer_tpu_torch.ops.rel_attention import rel_attention, rel_attention_plain

    gen = torch.Generator().manual_seed(0)
    entries = {}
    k_size = 15
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        args = attention_inputs(dev, dtype, gen)
        scale = 1 / 8
        a_out, a_lse = rel_attention(*args, scale=scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = rel_attention_plain(*args, scale=scale)
        err_o, ok_o = max_err(a_out, ref_out, tol)
        err_l, ok_l = max_err(a_lse, ref_lse, tol)
        dead = bool((a_out[2] == 0).all() and (a_out[1, :, 5] == 0).all()
                    and (a_lse[2] == 1e30).all())
        print(f"kernels: rel_flash_attention {name} max_abs_err out {err_o:.3g} lse {err_l:.3g} "
              f"(tol {tol} abs + rel), masked rows zero: {dead}")
        check(ok_o and ok_l and dead, f"rel_flash_attention {name} disagrees with its plain version")

        x, lens, p_norm, p_conv = conv_inputs(dev, dtype, gen, k=k_size)
        out, cache = conv_block(x, lens, p_norm, p_conv, kernel_size=k_size)
        torch.cuda.synchronize()
        ref_out, ref_cache = conv_block_plain(x, lens, p_norm, p_conv, kernel_size=k_size)
        err_c, ok_c = max_err(out, ref_out, tol)
        err_k, ok_k = max_err(cache, ref_cache, tol)
        xs, ls, pn, pc = conv_inputs(dev, dtype, gen, b=3, t=9, k=k_size)   # T < K-1
        out_s, cache_s = conv_block(xs, ls, pn, pc, kernel_size=k_size)
        torch.cuda.synchronize()
        ref_s, ref_cs = conv_block_plain(xs, ls, pn, pc, kernel_size=k_size)
        err_s, ok_s = max_err(out_s, ref_s, tol)
        err_cs, ok_cs = max_err(cache_s, ref_cs, tol)
        print(f"kernels: conv_block {name} max_abs_err out {err_c:.3g} cache {err_k:.3g}; "
              f"T=9<K-1: out {err_s:.3g} cache {err_cs:.3g} (tol {tol} abs + rel)")
        check(ok_c and ok_k and ok_s and ok_cs, f"conv_block {name} disagrees with its plain version")

        if dtype != torch.bfloat16:
            continue
        # --- times at the bf16 decode shape
        q_u, ab, k, v, feats, mask = args
        _, h, _, dk = q_u.shape
        d = ab.shape[-1]
        bias = (torch.matmul(ab.float(), feats.float().T) * scale).masked_fill(
            ~mask[:, None], float("-inf")).to(dtype)
        # the products this run's data needs: unmasked (query, key) pairs only
        attn_ops = 2.0 * h * float(mask.sum()) * (dk + d + dk)
        a_bytes = nbytes(*args, a_out, a_lse)
        a_bound, a_by = bound_ms(a_bytes, attn_ops / (BF16_TFLOPS * 1e12))
        entries["rel_flash_attention"] = {
            "name": "rel_flash_attention", "route": "cuda",
            "source": "conformer_tpu_torch/csrc/rel_flash_attention.cu",
            "replaces": "conformer_tpu/ops/pallas/attention_kernel.py:283",
            "max_abs_err": max(err_o, err_l),
            "ms": time_ms(lambda: rel_attention(*args, scale=scale)),
            "plain_ms": time_ms(lambda: rel_attention_plain(*args, scale=scale)),
            "bound_ms": a_bound, "bound_by": a_by,
            "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q_u, k, v, attn_mask=bias, scale=scale)),
        }
        # frames past a row's length need no product: their pw1 input is
        # zero (bias-only GLU) and their output is masked
        d = x.shape[-1]
        frames = float(lens.sum())
        mm_ops = 2.0 * frames * d * (2 * d) + 2.0 * frames * d * d
        dw_ops = 2.0 * frames * d * k_size
        c_bytes = nbytes(x, out, cache, lens, *kernel_weights(p_norm, p_conv, x.dtype).values())
        c_bound, c_by = bound_ms(
            c_bytes, mm_ops / (BF16_TFLOPS * 1e12) + dw_ops / (F32_TFLOPS * 1e12))
        entries["conv_block"] = {
            "name": "conv_block", "route": "cuda",
            "source": "conformer_tpu_torch/csrc/conv_block.cu",
            "replaces": "conformer_tpu/ops/pallas/conv_kernel.py:107",
            "max_abs_err": max(err_c, err_k, err_s, err_cs),
            "ms": time_ms(lambda: conv_block(x, lens, p_norm, p_conv, kernel_size=k_size)),
            "plain_ms": time_ms(lambda: conv_block_plain(x, lens, p_norm, p_conv,
                                                         kernel_size=k_size)),
            "bound_ms": c_bound, "bound_by": c_by,
            "library_ms": None,
        }
    for e in entries.values():
        print(f"kernels: {e['name']} bf16 B=48 T'=374: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, library {e['library_ms']} ms, bound "
              f"{e['bound_ms'] * 1e3:.2f} us ({e['bound_by']})")
    return entries


# ------------------------------------------------------------------- serve


def synthetic_wav(seed: int, seconds: float, sr: int = 16000) -> np.ndarray:
    """Seeded speech-like audio: harmonic tones whose pitch changes every
    120 ms, amplitude-modulated, over low noise; float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = np.repeat(rng.uniform(90, 260, n // 1920 + 1), 1920)[:n]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(rng.uniform(0.05, 0.2) * np.sin(k * phase) for k in (1, 2, 3, 5))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(n)
    return np.clip(wav, -1, 1).astype(np.float32)


def wav_bytes(wav: np.ndarray, sr: int = 16000) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (wav * 32767).astype(np.int16))
    return buf.getvalue()


def post_wav(url: str, data: bytes) -> dict:
    boundary = "smokeboundary"
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"audio\"; "
        f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def serving_config(path: str):
    from conformer_tpu_torch.config import Config

    cfg = Config.from_json_file(path)
    cfg.model.use_pallas_attention = True
    cfg.model.use_pallas_conv = True
    cfg.data.cmvn_path = ""     # stats and vocab files are not in the repo
    cfg.data.vocab_path = ""
    return cfg


def blank_biased(params: dict, blank_id: int, delta: float) -> dict:
    """A copy of ``params`` with ``delta`` added to the joint's output bias
    at ``blank_id``; every other tensor is shared."""
    out = dict(params["joint"]["ffn_out"])
    out["bias"] = out["bias"].clone()
    out["bias"][blank_id] += delta
    return {**params, "joint": {**params["joint"], "ffn_out": out}}


def make_runner(cfg, device):
    """The port's runner on random weights from cfg.train.seed, with +6 on
    the joint's blank bias as bench.py sets it. Returns the runner and the
    unbiased weights, which emit on most frames."""
    from conformer_tpu_torch.serve.runner import ModelRunner

    runner = ModelRunner(cfg, device=device)
    raw = runner.params
    runner.params = blank_biased(raw, cfg.model.blank_id, 6.0)
    return runner, raw


def serve_requests(runner, seconds=(4.0, 9.5, 15.0)) -> list[dict]:
    """Start the port's REST server on an ephemeral localhost port, POST one
    wav per entry of ``seconds``, and stop the server. Each result holds the
    response and each wrapper's launches during that request."""
    from http.server import ThreadingHTTPServer

    from conformer_tpu_torch.ops.conv_block import conv_block
    from conformer_tpu_torch.ops.rel_attention import rel_attention
    from conformer_tpu_torch.serve.rest_server import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(runner))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    results = []
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/recognize/"
        for i, secs in enumerate(seconds):
            rel_attention.launches = conv_block.launches = 0
            t0 = time.perf_counter()
            resp = post_wav(url, wav_bytes(synthetic_wav(100 + i, secs)))
            results.append({
                "seconds": secs, "latency_s": time.perf_counter() - t0, "response": resp,
                "launches": {"rel_flash_attention": rel_attention.launches,
                             "conv_block": conv_block.launches},
            })
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return results


# ------------------------------------------------------------------ parity


def batch_feats(runner, seconds, seed: int):
    feats = [runner.preprocess_waveform(synthetic_wav(seed + i, s), 16000)[0]
             for i, s in enumerate(seconds)]
    lens = np.array([len(f) for f in feats], np.int32)
    out = np.zeros((len(feats), lens.max(), feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        out[i, : len(f)] = f
    return out, lens


def decode(params, model_cfg, decode_cfg, feats, lens, device):
    import torch

    from conformer_tpu_torch.decode.greedy import greedy_search_batch
    from conformer_tpu_torch.models.transducer import encode

    with torch.inference_mode():
        f = torch.as_tensor(feats, device=device)
        fl = torch.as_tensor(lens, device=device)
        enc, enc_lens = encode(params, f, fl, model_cfg)
        hyps, hl, _ = greedy_search_batch(params, enc, enc_lens, model_cfg,
                                          n_steps=decode_cfg.n_steps,
                                          max_hyp_len=decode_cfg.max_hyp_len)
    return enc, hyps, hl


def hyp_lists(hyps, hl) -> list[list[int]]:
    return [h[: int(n)].tolist() for h, n in zip(hyps.cpu(), hl.cpu())]


def edit_distance(a: list[int], b: list[int]) -> int:
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
    return row[-1]


def plain_cfg(model_cfg):
    return dataclasses.replace(model_cfg, use_pallas_attention=False, use_pallas_conv=False)


def parity_f32(runner, params, device, seconds=(3.0, 7.5, 15.0, 11.0)) -> dict:
    """Kernel path vs plain path in float32 on ``params``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_k = dataclasses.replace(runner.cfg.model, compute_dtype="float32")
    feats, lens = batch_feats(runner, seconds, seed=200)
    enc_k, hyps_k, hl_k = decode(params, cfg_k, runner.cfg.decode, feats, lens, device)
    enc_p, hyps_p, hl_p = decode(params, plain_cfg(cfg_k), runner.cfg.decode, feats, lens, device)
    err = float((enc_k - enc_p).abs().max())
    same = hyp_lists(hyps_k, hl_k) == hyp_lists(hyps_p, hl_p)
    return {"encoder_max_abs_err": err, "hyps_identical": same,
            "hyp_lens": hl_k.tolist(), "finite": bool(torch.isfinite(enc_k).all())}


def token_agreement(a: list[list[int]], b: list[list[int]]) -> tuple[float, int, int]:
    """(1 - edit distance / tokens of ``b``, identical rows, tokens of ``b``)."""
    n_ref = sum(len(x) for x in b)
    errs = sum(edit_distance(x, y) for x, y in zip(a, b))
    return 1.0 - errs / max(n_ref, 1), sum(x == y for x, y in zip(a, b)), n_ref


def decode_bf16_batch(runner, raw_params, device, batch=48, seconds=15.0) -> dict:
    """bf16 batched decode of the served weights, kernel path timed (the
    encoder apart from the whole); the plain path's hypotheses on the
    served and on the unbiased weights give the token agreement."""
    import torch

    from conformer_tpu_torch.models.transducer import encode

    cfg_k, dcfg = runner.cfg.model, runner.cfg.decode
    feats, lens = batch_feats(runner, [seconds] * batch, seed=300)
    decode(runner.params, cfg_k, dcfg, feats, lens, device)       # warm-up
    times, enc_times = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hyps_k, hl_k = decode(runner.params, cfg_k, dcfg, feats, lens, device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        with torch.inference_mode():
            t0 = time.perf_counter()
            encode(runner.params, torch.as_tensor(feats, device=device),
                   torch.as_tensor(lens, device=device), cfg_k)
            torch.cuda.synchronize()
            enc_times.append(time.perf_counter() - t0)
    _, hyps_p, hl_p = decode(runner.params, plain_cfg(cfg_k), dcfg, feats, lens, device)
    served = token_agreement(hyp_lists(hyps_k, hl_k), hyp_lists(hyps_p, hl_p))
    _, hyps_rk, hl_rk = decode(raw_params, cfg_k, dcfg, feats, lens, device)
    _, hyps_rp, hl_rp = decode(raw_params, plain_cfg(cfg_k), dcfg, feats, lens, device)
    raw = token_agreement(hyp_lists(hyps_rk, hl_rk), hyp_lists(hyps_rp, hl_rp))
    return {
        "batch": batch, "seconds": seconds, "decode_s": times, "encode_s": enc_times,
        "audio_s_per_s": batch * seconds / (sum(times) / len(times)),
        "served": served, "unbiased": raw,
    }


# -------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "conformer_tpu_torch")):
        print(f"chip_smoke: no conformer_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from conformer_tpu_torch.ops import cuda_build
    from conformer_tpu_torch.ops.conv_block import conv_block
    from conformer_tpu_torch.ops.rel_attention import rel_attention

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi gave no card line")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"build: {name}: {line.strip()}")

    # 3. kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(dev)

    # 4. serve: the main path, counts set to 0 just before each request
    cfg = serving_config(os.path.join(REPO, "configs", "conformer_m.json"))
    runner, raw_params = make_runner(cfg, dev)
    layers = cfg.model.encoder_num_layers
    results = serve_requests(runner)
    launches = {"rel_flash_attention": 0, "conv_block": 0}
    for r in results:
        resp = r["response"]
        n_tok = len(resp.get("message", "").split())
        print(f"serve: {r['seconds']} s wav -> {resp['status']} in {r['latency_s']:.3f} s, "
              f"{n_tok} tokens, launches {r['launches']}")
        check(resp["status"] == "success", f"request failed: {resp.get('message')}")
        for name, n in r["launches"].items():
            check(n == layers, f"{name} launched {n} times in a request, expected {layers}")
            launches[name] += n
    for name, e in entries.items():
        e["launches"] = launches[name]

    # 5. parity: the served weights, and the unbiased ones, whose
    # hypotheses are long enough to make "identical" a real check
    for name, params in (("served", runner.params), ("unbiased", raw_params)):
        par = parity_f32(runner, params, dev)
        print(f"parity: f32 kernel path vs plain path, {name} weights: encoder max_abs_err "
              f"{par['encoder_max_abs_err']:.3g} (tol 1e-3), hyps identical "
              f"{par['hyps_identical']}, hyp lens {par['hyp_lens']}")
        check(par["finite"] and par["encoder_max_abs_err"] <= 1e-3 and par["hyps_identical"],
              f"f32 kernel path disagrees with the plain path on the {name} weights")
    check(max(par["hyp_lens"]) > 0, "the unbiased weights emitted no token")
    bat = decode_bf16_batch(runner, raw_params, dev)
    print(f"parity: bf16 decode B={bat['batch']} x {bat['seconds']} s, served weights: "
          f"{bat['audio_s_per_s']:.1f} audio-s/s (decode s {bat['decode_s']}, of which "
          f"encoder s {bat['encode_s']})")
    for name in ("served", "unbiased"):
        agree, same, n_ref = bat[name]
        print(f"parity: bf16 kernel path vs plain path, {name} weights: {same}/{bat['batch']} "
              f"rows identical, token agreement {agree:.4f} over {n_ref} tokens")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entries["rel_flash_attention"], entries["conv_block"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
