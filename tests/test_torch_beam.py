"""The RNN-T beams of the port against the JAX package's: the batched
device beam (``decode/beam_batched.py``) row for row, with prefix merging
on and off, 1 and 2 expansion rounds, blank skipping off and at a window
of 4; the host oracle (``decode/beam.py``); the ``lax.top_k``-contract
helper on crafted ties; ``joint_step`` and ``joint_lattice``.

Both beams get the same encoder output (JAX's, float32), so any
difference is the search's. Two sets of weights:
  - a tiny random init with the joint's output kernel scaled by 16, so
    that the beam emits on most frames and runs into ``max_hyp_len``;
  - the trained tests/fixtures/micro_trained.npz on fbank features of
    synthetic speech (the helpers of tests/test_torch_decode.py).
Tokens and lengths of all K rows must be identical, log-probs within
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import FIXTURE, _micro_cfg, _port_cfg, _synthetic_speech_feats

from conformer_tpu.config import tiny_test_config
from conformer_tpu.decode.beam import rnnt_beam_search as j_host_beam
from conformer_tpu.decode.beam_batched import beam_search_batch as j_beam
from conformer_tpu.models import joint as j_joint
from conformer_tpu.models.transducer import encode as j_encode
from conformer_tpu.models.transducer import init_transducer as j_init
from conformer_tpu.train.checkpoint import load_params_npz
from conformer_tpu_torch.decode import search
from conformer_tpu_torch.decode.beam import rnnt_beam_decode as p_host_decode
from conformer_tpu_torch.decode.beam import rnnt_beam_search as p_host_beam
from conformer_tpu_torch.decode.beam_batched import BeamState, _merge_duplicate_prefixes
from conformer_tpu_torch.decode.beam_batched import beam_search_batch as p_beam
from conformer_tpu_torch.models import joint as p_joint
from conformer_tpu_torch.params import from_jax_params, load_jax_npz

# (merge_prefixes, max_expansions, blank_skip_window): each value of each
# option on both sets of weights, and skipping with and without merging
_COMBOS = [(True, 2, 0), (False, 1, 0), (True, 1, 4), (False, 2, 4)]


def _tiny_case():
    """Random-normal encoder rows (the scale of a LayerNorm's output)."""
    cfg = tiny_test_config().model
    jp = j_init(jax.random.PRNGKey(0), cfg)
    out = jp["joint"]["ffn_out"]
    jp["joint"]["ffn_out"] = {"kernel": out["kernel"] * 16.0, "bias": out["bias"]}
    enc = np.random.default_rng(1).standard_normal((3, 36, cfg.encoder_dim)).astype(np.float32)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, pp, enc, np.array([36, 23, 2], np.int32), dict(beam_size=4, max_hyp_len=12)


def _trained_case():
    """JAX's encoder output of synthetic speech."""
    cfg = _micro_cfg()
    jp = load_params_npz(FIXTURE)
    feats, lens = _synthetic_speech_feats(2, [1.3, 0.9, 0.45])
    enc, enc_lens = j_encode(jp, jnp.asarray(feats), jnp.asarray(lens), cfg)
    return (cfg, jp, load_jax_npz(FIXTURE, "cpu"), np.array(enc), np.array(enc_lens),
            dict(beam_size=8, max_hyp_len=32))


@pytest.fixture(scope="module", params=["tiny", "trained"])
def case(request):
    """(cfg, port cfg, JAX params, port params, encoder output, lengths,
    beam settings)."""
    cfg, jp, pp, enc, lens, kw = _tiny_case() if request.param == "tiny" else _trained_case()
    return cfg, _port_cfg(cfg), jp, pp, enc, lens, kw


def _port(case, **kw):
    _, pcfg, _, pp, enc, lens, base = case
    return [x.numpy() for x in p_beam(pp, torch.from_numpy(enc), torch.from_numpy(lens), pcfg,
                                      **base, **kw)]


def _both(case, **kw):
    cfg, _, jp, _, enc, lens, base = case
    j = j_beam(jp, jnp.asarray(enc), jnp.asarray(lens), cfg, **base, **kw)
    return [np.asarray(x) for x in j], _port(case, **kw)


@pytest.mark.parametrize("merge,expansions,skip", _COMBOS)
def test_beam_matches_jax_every_row(case, merge, expansions, skip):
    (jt, jl, js), (pt, pl, ps) = _both(case, merge_prefixes=merge, max_expansions=expansions,
                                       blank_skip_window=skip)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-4)
    assert jl.max() > 1                            # the beam emits


def test_host_syncs_are_counted_per_iteration(case):
    lens = case[5]
    p_beam.host_syncs = 0
    _port(case)
    assert p_beam.host_syncs == 0                  # the frame loop reads nothing on the host
    _port(case, blank_skip_window=4)
    # at least one iteration per 4 frames of the longest row, one read each,
    # and the last read that ends the loop
    assert int(lens.max()) // 4 + 1 <= p_beam.host_syncs <= int(lens.max()) + 1


def test_blank_skip_exact_in_viterbi_mode(case):
    """Without merging every slot is live once the beam is full, and the
    skip is exact: the same tokens, lengths and scores as frame by frame."""
    t0, l0, s0 = _port(case, merge_prefixes=False)
    for w in (4, 8):
        t1, l1, s1 = _port(case, merge_prefixes=False, blank_skip_window=w)
        np.testing.assert_array_equal(l1, l0)
        np.testing.assert_array_equal(t1, t0)
        np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-5)


def test_merged_prefixes_unique_and_sorted(case):
    t, l, s = _port(case, merge_prefixes=True)
    assert (np.diff(s, axis=1) <= 0).all()
    for b in range(t.shape[0]):
        live = [tuple(t[b, k, :l[b, k]]) for k in range(t.shape[1]) if s[b, k] > -1e20]
        assert len(live) == len(set(live)), (b, live)


def test_merge_helper_pools_duplicates():
    """The JAX test's crafted slots: two copies of "12" pool into slot 0,
    the copy dies, a different label or length is untouched."""
    tokens = torch.tensor([[[1, 2, 0, 0], [1, 2, 9, 9], [1, 3, 0, 0], [1, 2, 0, 0]]],
                          dtype=torch.int32)
    z = torch.zeros((1, 1, 4, 2))
    st = BeamState(tokens=tokens, lengths=torch.tensor([[2, 2, 2, 1]], dtype=torch.int32),
                   log_probs=torch.tensor([[-1.0, -2.0, -0.5, -3.0]]), pred_h=z, pred_c=z,
                   pred_proj=torch.zeros((1, 4, 2)))
    got = _merge_duplicate_prefixes(st).log_probs[0].numpy()
    np.testing.assert_allclose(got[[0, 2, 3]], [np.logaddexp(-1.0, -2.0), -0.5, -3.0], atol=1e-6)
    assert got[1] == search.NEG_INF


@pytest.mark.parametrize("rows", [
    [[0.5, 2.0, 2.0, -1.0, 2.0, 0.5]],                      # a three-way tie at the top
    [[-1e30] * 6],                                          # every slot dead
    [[-1e30, 3.0, -1e30, -1e30, 3.0, -2e30],                # dead slots below the live
     [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]],
    [[-1e30 + 5.0, -1e30, -1e30 - 7.0, 0.0, -1e30, -1e30]],  # -1e30 + logp rounds to -1e30
])
def test_top_k_matches_lax_on_ties(rows):
    x = np.asarray(rows, np.float32)
    for k in (1, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = search.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(search.argsort_desc(torch.from_numpy(x), dim=1).numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(x), axis=1)))


def test_search_modules_use_no_unordered_topk():
    """The decoders take every top-K through search.top_k: no call of
    topk, and every argsort or sort with stable=True (the others promise
    no order among ties)."""
    import ast
    import inspect

    from conformer_tpu_torch.decode import beam_batched, ctc_beam_batched, ctc_decode, rescoring

    for mod in (beam_batched, ctc_beam_batched, ctc_decode, rescoring, search):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                name = node.func.attr
                assert name != "topk", mod.__name__
                if name in ("argsort", "sort"):
                    stable = [k.value for k in node.keywords if k.arg == "stable"]
                    assert stable and stable[0].value is True, (mod.__name__, node.lineno)


def _small_cfg():
    """The JAX test's vocabulary of 4, small enough that neither beam prunes."""
    return dataclasses.replace(
        tiny_test_config().model, vocab_size=4, sos_eos_id=3, predictor_num_layers=1,
        predictor_embed_size=8, predictor_hidden_size=8, predictor_dim=8, join_dim=16)


@pytest.mark.parametrize("seed,t_max", [(11, 2), (5, 4)])
def test_host_beam_matches_jax_and_the_batched_beam(seed, t_max):
    cfg = _small_cfg()
    jp = j_init(jax.random.PRNGKey(seed), cfg)
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    enc = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1), (t_max, cfg.encoder_dim)))
    want = j_host_beam(jp, jnp.asarray(enc), t_max, cfg, beam_size=8, max_expansions=2)
    got = p_host_beam(pp, torch.from_numpy(enc), t_max, _port_cfg(cfg), beam_size=8,
                      max_expansions=2)
    assert [h for h, _ in got] == [h for h, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5)
    assert p_host_decode(pp, torch.from_numpy(enc)[None], torch.tensor([t_max]), _port_cfg(cfg),
                         beam_size=8) == [p_host_beam(pp, torch.from_numpy(enc), t_max,
                                                      _port_cfg(cfg), beam_size=8)[0][0]]
    toks, lens, scores = p_beam(pp, torch.from_numpy(enc)[None], torch.tensor([t_max]),
                                _port_cfg(cfg), beam_size=8, max_expansions=2, max_hyp_len=8)
    assert toks[0, 0, :int(lens[0, 0])].tolist() == got[0][0]
    np.testing.assert_allclose(float(scores[0, 0]), got[0][1], rtol=1e-4)


def test_joint_step_and_lattice_match_jax():
    cfg = tiny_test_config().model
    jp = j_init(jax.random.PRNGKey(3), cfg)["joint"]
    pp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 5, cfg.encoder_dim)).astype(np.float32)
    pred = rng.standard_normal((2, 3, cfg.predictor_dim)).astype(np.float32)
    projected = (rng.standard_normal((2, 5, cfg.join_dim)).astype(np.float32),
                 rng.standard_normal((2, 3, cfg.join_dim)).astype(np.float32))
    for pre in (True, False):
        e, q = (enc, pred) if pre else projected
        want = j_joint.joint_lattice(jp, jnp.asarray(e), jnp.asarray(q), pre_project=pre)
        got = p_joint.joint_lattice(pp, torch.from_numpy(e), torch.from_numpy(q), pre_project=pre)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        want = j_joint.joint_step(jp, jnp.asarray(e[:, 0]), jnp.asarray(q[:, 0]), pre_project=pre)
        got = p_joint.joint_step(pp, torch.from_numpy(e[:, 0]), torch.from_numpy(q[:, 0]),
                                 pre_project=pre)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

