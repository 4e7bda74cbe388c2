"""Model runner for serving (JAX ``serve/runner.py``): load a config and
weights, turn audio into fbank features, and decode full utterances with
greedy RNN-T on the card.

With ``data.vocab_path`` set the transcript is the tokenizer's text (the
port's ``data/tokenizer.py``); without a vocab it is the space-joined
token ids, as in JAX. With ``decode.quantize_int8`` the runner serves int8
weights as the JAX runner does (``ops/quant.py``). Streaming sessions and
the micro-batching scheduler come in later slices.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..data.audio import load_audio, resample
from ..data.tokenizer import Tokenizer, load_vocab
from ..decode.greedy import greedy_search_batch
from ..models import cmvn as cmvn_mod
from ..models.transducer import encode, init_transducer
from ..ops.fbank import fbank_numpy
from ..ops.quant import quantize_tree
from ..params import from_jax_params, load_jax_npz


INT8_SKIP_KEYS = ("predictor", "cmvn", "joint", "ctc")   # the JAX runner's


@dataclass
class Recognition:
    text: str
    tokens: list[int]


def resolve_device(device=None) -> torch.device:
    """``device`` or, when None, the card. Raises when the card is asked
    for and CUDA is absent: the CPU is taken only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


class ModelRunner:
    """Serves one model. ``params`` is None (random init from
    ``cfg.train.seed``), a JAX params tree (nested dicts and lists of
    arrays, int8 leaves of a JAX-quantized tree included), or the path of a
    JAX ``save_params_npz`` file.

    With ``cfg.decode.quantize_int8`` the params are quantized after any
    CMVN load exactly as the JAX runner does: ``quantize_tree`` with the
    skip keys ``("predictor", "cmvn", "joint", "ctc")`` and the defaults
    (``min_dim=64``, ``expand_only=True``, ``fuse_ffn=False``), so the
    expanding FFN matmul ``w_1`` of every encoder layer runs through
    ``int8_matmul_dynamic`` (route A). The fused int8 FFN (route B, JAX's
    ``bench.py --int8``) has no config flag in JAX either: a caller builds
    the tree with ``quantize_tree(runner.params, skip_keys=INT8_SKIP_KEYS,
    fuse_ffn=True)`` and assigns it to ``runner.params`` after
    construction."""

    def __init__(self, cfg: Config, params=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            self.params = init_transducer(cfg.model, cfg.train.seed, self.device)
        elif isinstance(params, str):
            self.params = load_jax_npz(params, self.device)
        else:
            self.params = from_jax_params(params, self.device)
        if cfg.data.cmvn_path:
            self.params["cmvn"] = cmvn_mod.init_cmvn_from_file(cfg.data.cmvn_path, self.device)
        if cfg.decode.quantize_int8:
            # the LSTM predictor stays float (a latency-bound recurrence);
            # CMVN holds statistics, not weights
            self.params = quantize_tree(self.params, skip_keys=INT8_SKIP_KEYS)
        self.tokenizer: Tokenizer | None = None
        if cfg.data.vocab_path:
            self.tokenizer = Tokenizer(load_vocab(cfg.data.vocab_path),
                                       bpe_model=cfg.data.bpe_model)
        self._decode_lock = threading.Lock()

    # --------------------------------------------------------- preprocessing

    def preprocess_file(self, path: str) -> np.ndarray:
        """WAV file -> fbank [1, T, F]."""
        wav, sr = load_audio(path)
        return self.preprocess_waveform(wav, sr)

    def preprocess_waveform(self, wav: np.ndarray, sr: int) -> np.ndarray:
        d = self.cfg.data
        if sr != d.resample_rate:
            wav = resample(wav, sr, d.resample_rate)
        feat = fbank_numpy(
            wav * (1 << 15), sample_rate=d.resample_rate, num_mel_bins=d.num_mel_bins,
            frame_length=d.frame_length, frame_shift=d.frame_shift, dither=0.0,
        )
        return feat[None, ...]

    # ----------------------------------------------------------- recognition

    @torch.inference_mode()
    def decode_batch(self, feats, feat_lens) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched greedy decode of feats [B, T, F] with lengths [B] ->
        (hyps [B, max_hyp_len], hyp_lens [B]) on the runner's device."""
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        feat_lens = torch.as_tensor(feat_lens, dtype=torch.int32, device=self.device)
        with self._decode_lock:
            enc_out, enc_lens = encode(self.params, feats, feat_lens, self.cfg.model)
            hyps, hyp_lens, _ = greedy_search_batch(
                self.params, enc_out, enc_lens, self.cfg.model,
                n_steps=self.cfg.decode.n_steps, max_hyp_len=self.cfg.decode.max_hyp_len,
            )
        return hyps, hyp_lens

    def recognize(self, feats: np.ndarray) -> Recognition:
        """Full-utterance greedy decode of feats [B, T, F]; returns row 0."""
        lens = np.full((feats.shape[0],), feats.shape[1], np.int32)
        hyps, hyp_lens = self.decode_batch(feats, lens)
        ids = hyps[0, : int(hyp_lens[0])].tolist()
        return Recognition(text=self._ids_to_text(ids), tokens=ids)

    def recognize_file(self, path: str) -> Recognition:
        return self.recognize(self.preprocess_file(path))

    def _ids_to_text(self, ids: list[int]) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, ids))
        return self.tokenizer.decode_ids(ids, stop_id=self.cfg.model.sos_eos_id)
