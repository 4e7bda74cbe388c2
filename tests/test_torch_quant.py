"""Int8 serving in the port against the JAX package, in float32 on the CPU:
the weight quantization and the tree walk, the plain versions of the two
int8 kernels (``ops/int8_matmul.py``, ``ops/int8_ffn.py``) against JAX's
XLA route, its reference and its Pallas kernels in interpret mode, the
encoder on quantized params (route A: the runner's ``quantize_int8``;
route B: ``quantize_tree(fuse_ffn=True)``, the fused FFN), the int8 greedy
decode of the trained fixture through ``ModelRunner``, and the REST server.
"""

import dataclasses
import functools
import json
import threading
import urllib.request
from pathlib import Path
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformer_tpu.serve.runner as j_runner_mod
from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig, tiny_test_config
from conformer_tpu.data import audio as j_audio
from conformer_tpu.models.encoder import encoder_forward as j_encoder
from conformer_tpu.ops import quant as jq
from conformer_tpu.ops.pallas.ffn_kernel import int8_ffn_fused as j_ffn_kernel
from conformer_tpu.ops.pallas.ffn_kernel import int8_ffn_reference as j_ffn_ref
from conformer_tpu.ops.pallas.quant_kernel import int8_matmul_dynamic as j_matmul_kernel
from conformer_tpu.train.checkpoint import load_params_npz
from conformer_tpu_torch.config import Config as PConfig
from conformer_tpu_torch.models import layers as p_layers
from conformer_tpu_torch.models.encoder import encoder_forward as p_encoder
from conformer_tpu_torch.ops import cuda_build
from conformer_tpu_torch.ops import quant as pq
from conformer_tpu_torch.ops.fbank import fbank_numpy
from conformer_tpu_torch.ops.int8_ffn import int8_ffn_fused, int8_ffn_plain
from conformer_tpu_torch.ops import int8_matmul as pim
from conformer_tpu_torch.ops.int8_matmul import int8_matmul_dynamic, int8_matmul_dynamic_plain
from conformer_tpu_torch.models.transducer import init_transducer as p_init
from conformer_tpu_torch.params import from_jax_params, tree_map
from conformer_tpu_torch.serve import rest_server
from conformer_tpu_torch.serve.runner import INT8_SKIP_KEYS, ModelRunner

FIXTURE = "tests/fixtures/micro_trained.npz"
SKIP = ("predictor", "cmvn", "joint", "ctc")       # conformer_tpu/serve/runner.py:66


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}#{i}").items()}
    return {prefix: tree}


def _assert_same_tree(got, want):
    """Same leaf paths; int8 leaves bit for bit, float leaves equal."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k, leaf in w.items():
        ref = np.asarray(leaf)
        out = g[k].numpy()
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)


def _quantized_paths(tree) -> set:
    return {k.rsplit("/", 1)[0] for k in _flat(tree) if k.endswith("/kernel_q")}


def _tiny():
    """tiny_test_config's model with the simple projections, vocab and
    predictor widened so that both expand past min_dim (as at Conformer-M)."""
    cfg = dataclasses.replace(tiny_test_config().model, use_pruned_loss=True, vocab_size=160,
                              sos_eos_id=159, predictor_dim=64)
    return cfg, PConfig.from_dict({"model": dataclasses.asdict(cfg)}).model


@functools.lru_cache(maxsize=None)
def _tiny_jax_params():
    """Seeded tiny params as a JAX tree: the port's init (the same tree as
    JAX's, built in milliseconds where JAX's eager init takes seconds)."""
    return tree_map(lambda t: jnp.asarray(t.numpy()), p_init(_tiny()[1], 0, "cpu"))


# -------------------------------------------------------------- weights


@pytest.mark.parametrize("shape", [(64, 96), (3, 48, 80)], ids=["rank2", "stacked_rank3"])
def test_quantize_dense_params_matches_jax(shape):
    """int8 values bit for bit, scales equal; an all-zero column takes the
    1e-12 floor and quantizes to 0."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 5] = 0.0
    p = {"kernel": w, "bias": rng.standard_normal(shape[-1]).astype(np.float32)}
    want = jq.quantize_dense_params(jax.tree.map(jnp.asarray, p))
    got = pq.quantize_dense_params(from_jax_params(p))
    _assert_same_tree(got, want)
    assert got["kernel_q"].dtype == torch.int8 and got["kernel_scale"].dtype == torch.float32
    assert (got["kernel_q"][..., 5] == 0).all() and (got["kernel_scale"][..., 5] == 1e-12).all()


@pytest.mark.parametrize("flags", [{}, {"fuse_ffn": True}, {"expand_only": False}],
                         ids=["runner_default", "fuse_ffn", "expand_all"])
def test_quantize_tree_matches_jax(flags):
    """The same quantized leaf paths and equal leaves, with the runner's
    skip keys, on tiny transducer params carried over from JAX."""
    jp = _tiny_jax_params()
    want = jq.quantize_tree(jp, skip_keys=SKIP, **flags)
    got = pq.quantize_tree(from_jax_params(jax.tree.map(np.asarray, jp)), skip_keys=SKIP, **flags)
    _assert_same_tree(got, want)
    paths = _quantized_paths(got)
    assert {"/simple_am_proj", "/simple_lm_proj"} <= paths
    assert not any(k.startswith(("/predictor", "/joint", "/ctc")) for k in paths)
    assert not any("conv" in k or "linear_pos" in k for k in paths)
    ffn = "/encoder/layers/feed_forward"
    assert f"{ffn}/w_1" in paths and f"{ffn}_macaron/w_1" in paths
    assert (f"{ffn}/w_2" in paths) == bool(flags)
    assert ("/encoder/layers/self_attn/linear_q" in paths) == ("expand_only" in flags)


def test_from_jax_params_carries_a_quantized_tree():
    """int8 leaves stay torch.int8, scales float32, values equal."""
    want = jq.quantize_tree(_tiny_jax_params(), skip_keys=SKIP, fuse_ffn=True)
    got = from_jax_params(jax.tree.map(np.asarray, want), "cpu")
    _assert_same_tree(got, want)
    w1 = got["encoder"]["layers"]["feed_forward"]["w_1"]
    assert w1["kernel_q"].dtype == torch.int8 and w1["kernel_scale"].dtype == torch.float32


# -------------------------------------------------------------- kernels' plain versions


@pytest.mark.parametrize("m,k,n", [(37, 64, 128), (1, 64, 96), (20, 70, 200), (37, 144, 576)])
def test_int8_matmul_plain_matches_jax(m, k, n):
    """Port plain vs JAX's Pallas kernel (interpret) and XLA route, M not a
    multiple of any tile, M = 1, K = 70 and Conformer-S's K = 144 (not a
    multiple of the int8 tensor cores' depth of 32), and a zero row (its
    output is exactly the bias). Both JAX routes under jit, as JAX serves (``INV_127`` in
    ``ops/int8_matmul.py``): the kernel bit for bit, the XLA route within 1
    ulp of the product and one of the result (the int32 sums are exact on
    both sides; XLA may contract the bias add into an FMA)."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[m // 2] = 0.0
    dense = {"kernel": (rng.standard_normal((k, n)) * 0.1).astype(np.float32),
             "bias": rng.standard_normal(n).astype(np.float32)}
    jp = jq.quantize_dense_params(jax.tree.map(jnp.asarray, dense))
    pp = from_jax_params(jax.tree.map(np.asarray, jp))
    got = int8_matmul_dynamic_plain(torch.from_numpy(x), pp["kernel_q"], pp["kernel_scale"])
    kern = j_matmul_kernel(jnp.asarray(x), jp["kernel_q"], jp["kernel_scale"], tile_m=16,
                           tile_n=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    xla = jax.jit(lambda p, v: jq.int8_dense(p, v, use_kernel=False))(jp, jnp.asarray(x))
    got_dense = pq.int8_dense(pp, torch.from_numpy(x))
    # an FMA rounds once where the port rounds the product and then the
    # sum: one ulp of the product plus one of the result
    bound = np.spacing(np.abs(got.numpy())) + np.spacing(np.abs(np.asarray(xla)))
    assert (np.abs(got_dense.numpy() - np.asarray(xla)) <= bound).all()
    np.testing.assert_array_equal(got_dense[m // 2].numpy(), dense["bias"])
    # a 3-D activation through layers.dense's dispatch
    x3 = torch.from_numpy(x[None])
    assert torch.equal(p_layers.dense(pp, x3)[0], got_dense)


# the subsampling's output dense [19 D, D] that quantize_tree(expand_only=False)
# quantizes: K = 2736 / 4864 / 9728 at Conformer-S / M / L (D = 144 / 256 / 512)
EMBED_OUT_K = {"conformer_s": 2736, "conformer_m": 4864, "conformer_l": 9728}


def test_int8_dense_route_is_a_function_of_k():
    """``int8_dense`` takes the kernel where ``int8_matmul.width_error``
    takes K (K <= KMAX) and the XLA route above it: a function of K alone,
    the same on every device; the shipped widths of the subsampling's
    output dense are all above the kernel's limit."""
    for k in (1, 64, 144, 256, 512, pim.KMAX):
        assert pq.int8_dense_route(k) == "kernel" and pim.width_error(k) is None
    for k in (pim.KMAX + 1, 1216, *EMBED_OUT_K.values()):
        assert pq.int8_dense_route(k) == "xla" and pim.width_error(k) is not None
    for name, k in EMBED_OUT_K.items():
        with open(Path(__file__).resolve().parents[1] / "configs" / f"{name}.json") as f:
            cfg = PConfig.from_dict(json.load(f)).model
        assert k == 19 * cfg.encoder_dim and cfg.input_dim == 80, name


def test_int8_dense_above_kernel_width_matches_jax():
    """An ``expand_only=False`` tree quantizes the subsampling's output dense
    (K = 19 * 64 = 1216 on the tiny params, above the kernel's K <= 1024);
    ``int8_dense`` on it against JAX's ``int8_dense`` (its XLA route under
    jit, ``use_kernel=False``), float32: bit for bit without the bias (the
    int8 values, scales and exact int32 sums equal), and with it within one
    ulp of the product and one of the result, as
    ``test_int8_matmul_plain_matches_jax`` holds the XLA route (XLA may
    contract the bias add into an FMA); a zero row gives exactly the bias.
    Each call counts one call of the XLA route. A 3-D activation takes the
    same route through ``layers.dense``."""
    jp = jq.quantize_tree(_tiny_jax_params(), skip_keys=SKIP, expand_only=False)
    pp = from_jax_params(jax.tree.map(np.asarray, jp))
    jd, pd = jp["encoder"]["embed"]["out"], pp["encoder"]["embed"]["out"]
    k = pd["kernel_q"].shape[0]
    assert k == 1216 and pq.int8_dense_route(k) == "xla"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, k)).astype(np.float32)
    x[1, 4] = 0.0
    xla = jax.jit(lambda p, v: jq.int8_dense(p, v, use_kernel=False))
    before = pq.int8_dense.xla_routes
    no_bias = pq.int8_dense({kk: v for kk, v in pd.items() if kk != "bias"}, torch.from_numpy(x))
    want = xla({kk: v for kk, v in jd.items() if kk != "bias"}, jnp.asarray(x))
    np.testing.assert_array_equal(no_bias.numpy(), np.asarray(want))
    got = pq.int8_dense(pd, torch.from_numpy(x))
    assert pq.int8_dense.xla_routes == before + 2
    want = np.asarray(xla(jd, jnp.asarray(x)))
    bound = np.spacing(np.abs(no_bias.numpy())) + np.spacing(np.abs(want))
    assert (np.abs(got.numpy() - want) <= bound).all()
    np.testing.assert_array_equal(got[1, 4].numpy(), pd["bias"].numpy())
    assert torch.equal(p_layers.dense(pd, torch.from_numpy(x)), got)


def _ffn_args(seed, d=64, h=256, m=50):
    rng = np.random.default_rng(seed)
    w1 = {"kernel": (rng.standard_normal((d, h)) * 0.05).astype(np.float32),
          "bias": (rng.standard_normal(h) * 0.1).astype(np.float32)}
    w2 = {"kernel": (rng.standard_normal((h, d)) * 0.05).astype(np.float32),
          "bias": (rng.standard_normal(d) * 0.1).astype(np.float32)}
    ln = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          "bias": (0.05 * rng.standard_normal(d)).astype(np.float32)}
    x = rng.standard_normal((m, d)).astype(np.float32)
    if m > 3:
        x[3] = 0.0                  # a bucket-padding row: LN gives its bias
    q1, q2 = (jq.quantize_dense_params(jax.tree.map(jnp.asarray, w)) for w in (w1, w2))
    j_args = (jnp.asarray(x), jax.tree.map(jnp.asarray, ln), q1["kernel_q"], q1["kernel_scale"],
              q1["bias"], q2["kernel_q"], q2["kernel_scale"], q2["bias"])
    p_args = (torch.from_numpy(x), *from_jax_params(
        [ln, *(np.asarray(a) for a in j_args[2:])]))
    return j_args, p_args


@pytest.mark.parametrize("m,d,h", [(50, 64, 256), (1, 64, 256), (37, 144, 576)],
                         ids=["50", "1", "conformer_s-D144-H576"])
def test_int8_ffn_plain_matches_jax(m, d, h):
    """Port plain vs JAX's reference and its Pallas kernel (interpret,
    tile_m=32), float32, at JAX's own tolerance (tests/test_int8_ffn.py):
    rtol 1e-2, atol 2e-3 (an ulp of difference in the LayerNorm or the
    sigmoid may flip one int8 value at a rounding boundary); also at
    Conformer-S's widths (D = 144, not a multiple of 32, H = 576)."""
    j_args, p_args = _ffn_args(7, d=d, h=h, m=m)
    got = int8_ffn_plain(*p_args, half=0.5).numpy()
    for want in (j_ffn_ref(*j_args, half=0.5),
                 j_ffn_kernel(*j_args, half=0.5, tile_m=32, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-2, atol=2e-3)
    assert torch.equal(int8_ffn_fused(*p_args, half=0.5), int8_ffn_plain(*p_args, half=0.5))


def test_int8_ffn_plain_bf16_matches_jax():
    """bfloat16 activations, float32 math, output rounded to bfloat16: JAX's
    bf16 tolerance (rtol and atol 2e-2)."""
    j_args, p_args = _ffn_args(8, m=37)
    j_args = (j_args[0].astype(jnp.bfloat16), *j_args[1:])
    p_args = (p_args[0].to(torch.bfloat16), *p_args[1:])
    got = int8_ffn_plain(*p_args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(j_ffn_ref(*j_args), np.float32),
                               rtol=2e-2, atol=2e-2)


def test_wrappers_on_cpu_build_and_count_nothing():
    """CPU tensors take the plain versions: no library is built and no
    launch is counted. A tensor on neither the CPU nor a CUDA device is
    refused."""
    int8_matmul_dynamic.launches = int8_ffn_fused.launches = 0
    _, p_args = _ffn_args(9, m=5)
    int8_ffn_fused(*p_args)
    w_q = torch.ones((64, 8), dtype=torch.int8)
    int8_matmul_dynamic(torch.ones(3, 64), w_q, torch.ones(8))
    assert int8_matmul_dynamic.launches == 0 and int8_ffn_fused.launches == 0
    assert not cuda_build._libs
    with pytest.raises(ValueError, match="CUDA device"):
        int8_matmul_dynamic(torch.ones(3, 64, device="meta"), w_q, torch.ones(8))
    assert {"int8_matmul", "int8_ffn"} <= set(cuda_build.KERNELS)


@pytest.mark.parametrize("k", [144, 256, 70])
def test_kernel_layout_is_exact(k):
    """The kernels' layout of an int8 weight [K, N] is its transpose with K
    zero-padded to a multiple of 32, contiguous; unpadded it gives back
    kernel_q bit for bit."""
    rng = np.random.default_rng(k)
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, 40)).astype(np.int8))
    w_t = pim.pad_transpose(w_q)
    k_pad = -(-k // 32) * 32
    assert w_t.shape == (40, k_pad) and w_t.dtype == torch.int8 and w_t.is_contiguous()
    assert (w_t[:, k:] == 0).all()
    assert torch.equal(pim.unpad_transpose(w_t, k), w_q)


def test_kernel_layout_is_made_once_per_weight():
    """``kernel_layout`` makes a weight's layout at its first use and takes
    it from its cache afterwards (``builds`` counts the layouts made); each
    layer of a stacked weight has its own; an in-place change of the weight
    makes a new one."""
    rng = np.random.default_rng(3)
    stacked = torch.from_numpy(rng.integers(-127, 128, (3, 144, 64)).astype(np.int8))
    before = pim.kernel_layout.builds
    first = [pim.kernel_layout(stacked[i]) for i in range(3)]
    assert pim.kernel_layout.builds == before + 3
    again = [pim.kernel_layout(stacked[i]) for i in range(3)]
    assert all(a is b for a, b in zip(first, again)) and pim.kernel_layout.builds == before + 3
    for i in range(3):
        assert torch.equal(pim.unpad_transpose(first[i], 144), stacked[i])
    stacked[1].neg_()
    changed = pim.kernel_layout(stacked[1])
    assert pim.kernel_layout.builds == before + 4
    assert torch.equal(pim.unpad_transpose(changed, 144), stacked[1])


# -------------------------------------------------------------- encoder


@pytest.mark.parametrize("route", ["A", "B", "expand_all"])
def test_encoder_forward_quantized_matches_jax(route):
    """The encoder on quantized params, port vs JAX, float32. Route A
    (``w_1`` int8, through ``int8_dense``) quantizes the same LayerNorm
    output on both sides: within 1e-4. Route B (the fused FFN) takes its
    own LayerNorm inside the FFN, where an ulp of difference may flip an
    int8 value at a .5 boundary. One step of a hidden value moves the
    half's output by s_h * s2 * |w2q| <= ~1e-3 at this width (JAX's own
    kernel test allows 2e-3 for it); it carries through the later layers
    and the final LayerNorm. atol 5e-3 allows a few such steps, and a
    tenth of the 1.8e-2 by which quantization moves the outputs from the
    float encoder; the mean difference must stay below 1e-4, and at most
    10 % of the outputs may differ by more than 1e-5. "expand_all"
    (``quantize_tree(expand_only=False)``): every dense of the encoder int8,
    the FFN halves fused as in route B (so route B's limits), and the
    subsampling's output dense (K = 1216) through ``int8_dense``'s XLA
    route, once per call."""
    cfg, pcfg = _tiny()
    jp = _tiny_jax_params()
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    flags = {"A": {}, "B": {"fuse_ffn": True}, "expand_all": {"expand_only": False}}[route]
    jqp = jq.quantize_tree(jp, skip_keys=SKIP, **flags)["encoder"]
    pqp = pq.quantize_tree(pp, skip_keys=SKIP, **flags)["encoder"]
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 96, 80)).astype(np.float32)
    lens = np.array([96, 64], np.int32)
    want, mask = jax.jit(lambda p: j_encoder(p, jnp.asarray(feats), jnp.asarray(lens), cfg))(jqp)
    before = pq.int8_dense.xla_routes
    got, p_mask = p_encoder(pqp, torch.from_numpy(feats), torch.from_numpy(lens), pcfg)
    assert pq.int8_dense.xla_routes - before == (route == "expand_all")
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(mask))
    diff = np.abs(got.numpy() - np.asarray(want)) * np.asarray(mask)[..., None]
    if route == "A":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert diff.max() <= 5e-3 and diff.mean() <= 1e-4 and (diff > 1e-5).mean() <= 0.1, (
            diff.max(), diff.mean(), (diff > 1e-5).mean())


# -------------------------------------------------------------- runner and server


def _micro_model():
    """The model of scripts/train_micro_wer.py:38-61 (encoder 96, FFN 192)."""
    return ModelConfig(
        input_dim=80, vocab_size=24, sos_eos_id=23, encoder_dim=96,
        encoder_num_layers=3, num_heads=4, hidden_dim=192, kernel_size=7,
        predictor_embed_size=64, predictor_hidden_size=64, predictor_dim=64,
        predictor_num_layers=1, join_dim=96, compute_dtype="float32",
        use_dynamic_chunk=False, use_dynamic_left_chunk=False, ctc_weight=0.2,
        attention_weight=0.3, decoder_num_layers=1, use_pruned_loss=True,
    )


def _speech_feats(seed, seconds):
    """fbank of seeded harmonic audio whose pitch changes every 120 ms,
    padded to one length."""
    rng = np.random.default_rng(seed)
    feats = []
    for s in seconds:
        n = int(s * 16000)
        f0 = np.repeat(rng.uniform(90, 260, n // 1920 + 1), 1920)[:n]
        phase = 2 * np.pi * np.cumsum(f0) / 16000
        wav = sum(rng.uniform(0.05, 0.3) * np.sin(k * phase) for k in (1, 2, 3, 5))
        wav = wav + 0.01 * rng.standard_normal(n)
        feats.append(fbank_numpy(wav.astype(np.float32) * (1 << 15)))
    lens = np.array([len(f) for f in feats], np.int32)
    out = np.zeros((len(feats), lens.max(), 80), np.float32)
    for i, f in enumerate(feats):
        out[i, : len(f)] = f
    return out, lens


@pytest.mark.parametrize("route", ["A", "B"])
def test_runner_int8_decode_matches_jax_on_trained_fixture(route, monkeypatch):
    """Greedy hypotheses of the int8 runner on micro_trained.npz, token for
    token those of the JAX runner. Route A: both runners quantize with
    ``decode.quantize_int8`` (the JAX runner's init patched to return the
    fixture), and the port's quantized tree equals the JAX runner's. Route
    B: both trees from ``quantize_tree(fuse_ffn=True)``, the port's set as
    ``runner.params``."""
    fixture = load_params_npz(FIXTURE)
    monkeypatch.setattr(j_runner_mod, "init_transducer", lambda *a, **k: fixture)
    jcfg = JConfig()
    jcfg.model = _micro_model()
    jcfg.decode.n_steps = jcfg.decode.max_hyp_len = 64
    jcfg.decode.quantize_int8 = route == "A"
    pcfg = PConfig.from_dict(dataclasses.asdict(jcfg))
    jrunner = j_runner_mod.ModelRunner(jcfg)
    runner = ModelRunner(pcfg, params=FIXTURE, device="cpu")
    if route == "A":
        _assert_same_tree(runner.params, jrunner.params)
        assert "/encoder/layers/feed_forward/w_1" in _quantized_paths(runner.params)
    else:
        jrunner.params = jq.quantize_tree(fixture, skip_keys=SKIP, fuse_ffn=True)
        runner.params = pq.quantize_tree(runner.params, skip_keys=INT8_SKIP_KEYS, fuse_ffn=True)
        _assert_same_tree(runner.params, jrunner.params)
    feats, lens = _speech_feats(2, [1.3, 0.9, 0.45])
    j_hyps, j_lens = jrunner._decode_jit(jrunner.params, jnp.asarray(feats), jnp.asarray(lens))
    hyps, hyp_lens = runner.decode_batch(feats, lens)
    np.testing.assert_array_equal(hyp_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_array_equal(hyps.numpy(), np.asarray(j_hyps))
    assert hyp_lens.min() > 0


def test_rest_server_with_quantize_int8(tmp_path):
    """The REST server in front of an int8 runner answers a POSTed wav with
    "success" and the runner's own transcript."""
    cfg = tiny_test_config()
    cfg.decode.quantize_int8 = True
    cfg.decode.max_hyp_len, cfg.decode.n_steps = 32, 4
    runner = ModelRunner(PConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert _quantized_paths(runner.params) >= {"/encoder/layers/feed_forward/w_1"}
    rng = np.random.default_rng(0)
    path = str(tmp_path / "a.wav")
    j_audio.save_wav(path, (0.1 * rng.standard_normal(16000)).astype(np.float32), 16000)
    want = runner.recognize_file(path).text
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), rest_server.make_handler(runner))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = (b"--B\r\nContent-Disposition: form-data; name=\"audio\"; filename=\"a.wav\""
                b"\r\n\r\n" + open(path, "rb").read() + b"\r\n--B--\r\n")
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/recognize/", data=body, method="POST",
            headers={"Content-Type": "multipart/form-data; boundary=B"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert got == {"status": "success", "message": want}
