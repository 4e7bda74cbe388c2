"""CTC decoding of the port against the JAX package's: greedy search, the
host prefix beam (the float64 oracle), and the batched device prefix
beam, every one of its K rows, at top_c = V (exact: it must also match
the oracle) and pruned, on repeat-heavy, blank-dominated and
length-masked rows (the cases of tests/test_ctc_beam_batched.py), and on
the trained tests/fixtures/micro_trained.npz's CTC head over synthetic
speech. Tokens and lengths identical, scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import FIXTURE, _micro_cfg, _port_cfg, _synthetic_speech_feats

from conformer_tpu.decode import ctc_beam_batched as j_cbb
from conformer_tpu.decode import ctc_decode as j_cd
from conformer_tpu.models.transducer import encode as j_encode
from conformer_tpu.train.checkpoint import load_params_npz
from conformer_tpu_torch.decode import ctc_beam_batched as p_cbb
from conformer_tpu_torch.decode import ctc_decode as p_cd
from conformer_tpu_torch.params import load_jax_npz


def _log_probs(seed, shape, scale=1.0, blank_boost=0.0):
    logits = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    logits[..., 0] += blank_boost
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


# name -> (log-probs [B, T, V], lengths, beam size, top_c)
_CASES = {
    "random": (_log_probs(0, (3, 12, 6)), [12, 9, 5], 4, 6),
    "repeat_heavy": (_log_probs(7, (2, 10, 4), scale=4.0), [10, 10], 4, 4),
    "blank_dominated": (_log_probs(3, (2, 8, 5), scale=0.1, blank_boost=6.0), [8, 3], 3, 5),
    "length_masked": (_log_probs(11, (3, 10, 5)), [6, 0, 1], 4, 5),
    "pruned": (_log_probs(5, (3, 20, 40), scale=3.0), [20, 13, 7], 8, 16),
}


def _run_both(name, **kw):
    lp, lens, k, top_c = _CASES[name]
    lens = np.asarray(lens, np.int32)
    args = dict(beam_size=k, blank=0, max_hyp_len=16, top_c=top_c, **kw)
    j = j_cbb.ctc_prefix_beam_batch(jnp.asarray(lp), jnp.asarray(lens), **args)
    p = p_cbb.ctc_prefix_beam_batch(torch.from_numpy(lp), torch.from_numpy(lens), **args)
    return [np.asarray(x) for x in j], [x.numpy() for x in p]


@pytest.mark.parametrize("name", list(_CASES))
def test_prefix_beam_matches_jax_every_row(name):
    (jt, jl, js), (pt, pl, ps) = _run_both(name)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", [n for n, c in _CASES.items() if c[3] == c[0].shape[-1]])
def test_exact_search_matches_host_oracle(name):
    """top_c = V: the live slots are the oracle's beam, best first."""
    lp, lens, k, _ = _CASES[name]
    _, (toks, tl, scores) = _run_both(name)
    for b in range(lp.shape[0]):
        host = p_cd.ctc_prefix_beam_search(lp[b], lens[b], beam_size=k, blank=0,
                                           top_k=lp.shape[-1])
        assert host == j_cd.ctc_prefix_beam_search(lp[b], lens[b], beam_size=k, blank=0,
                                                   top_k=lp.shape[-1])
        dev = {tuple(toks[b, j, :tl[b, j]].tolist()): float(scores[b, j])
               for j in range(k) if scores[b, j] > -1e29}
        assert set(dev) == {prefix for prefix, _ in host}
        for prefix, score in host:
            assert dev[prefix] == pytest.approx(score, abs=1e-4)
        assert tuple(toks[b, 0, :tl[b, 0]].tolist()) == host[0][0]


def test_length_masking():
    """Frames past the length do not count: the masked row equals the
    truncated one."""
    lp = _CASES["length_masked"][0][:1]
    kw = dict(beam_size=4, blank=0, max_hyp_len=12, top_c=5)
    full = p_cbb.ctc_prefix_beam_batch(torch.from_numpy(lp), torch.tensor([6]), **kw)
    trunc = p_cbb.ctc_prefix_beam_batch(torch.from_numpy(lp[:, :6].copy()), torch.tensor([6]),
                                        **kw)
    for a, b in zip(full, trunc):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("top_k", [3, 16])
def test_host_oracle_matches_jax(top_k):
    lp = _CASES["pruned"][0]
    for b, n in enumerate((20, 13, 7)):
        assert (p_cd.ctc_prefix_beam_search(lp[b], n, beam_size=8, top_k=top_k)
                == j_cd.ctc_prefix_beam_search(lp[b], n, beam_size=8, top_k=top_k))


def test_greedy_matches_jax_with_ties_and_repeats():
    lp = _log_probs(4, (4, 30, 7), scale=3.0)
    lp[0, 3:9] = lp[0, 3]                 # a run of one frame: repeats collapse
    lp[1, :, 2] = lp[1, :, 5] = 0.0       # every frame ties labels 2 and 5: the first wins
    lp[2, ::2] = lp[2, 0]                 # repeats broken by other frames
    lens = np.array([30, 17, 30, 0], np.int32)
    jh, jl = j_cd.ctc_greedy_search(jnp.asarray(lp), jnp.asarray(lens), blank=0)
    ph, pl = p_cd.ctc_greedy_search(torch.from_numpy(lp), torch.from_numpy(lens), blank=0)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert pl[3] == 0 and pl[0] > 0


@pytest.fixture(scope="module")
def trained():
    cfg = _micro_cfg()
    jp = load_params_npz(FIXTURE)
    feats, lens = _synthetic_speech_feats(3, [1.6, 1.1, 0.6, 0.3])
    enc, enc_lens = j_encode(jp, jnp.asarray(feats), jnp.asarray(lens), cfg)
    return cfg, jp, load_jax_npz(FIXTURE, "cpu"), np.array(enc), np.array(enc_lens)


def test_greedy_decode_on_trained_fixture(trained):
    cfg, jp, pp, enc, lens = trained
    jh, jl = j_cd.ctc_greedy_decode(jp, jnp.asarray(enc), jnp.asarray(lens), cfg)
    ph, pl = p_cd.ctc_greedy_decode(pp, torch.from_numpy(enc), torch.from_numpy(lens),
                                    _port_cfg(cfg))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert np.asarray(jl).min() > 0


@pytest.mark.parametrize("top_c", [16, 24])
def test_prefix_beam_decode_on_trained_fixture(trained, top_c):
    cfg, jp, pp, enc, lens = trained
    kw = dict(beam_size=8, max_hyp_len=32, top_c=top_c)
    jt, jl, js = j_cbb.ctc_prefix_beam_decode_batch(jp, jnp.asarray(enc), jnp.asarray(lens),
                                                    cfg, **kw)
    pt, pl, ps = p_cbb.ctc_prefix_beam_decode_batch(pp, torch.from_numpy(enc),
                                                    torch.from_numpy(lens), _port_cfg(cfg), **kw)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    host = p_cd.ctc_prefix_beam_decode(pp, torch.from_numpy(enc), torch.from_numpy(lens),
                                       _port_cfg(cfg))
    assert host == j_cd.ctc_prefix_beam_decode(jp, jnp.asarray(enc), jnp.asarray(lens), cfg)
