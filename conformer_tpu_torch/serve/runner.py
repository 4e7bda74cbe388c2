"""Model runner for serving (JAX ``serve/runner.py``): load a config and
weights, turn audio into fbank features, decode full utterances with
greedy RNN-T on the card, and stream: live B=1 sessions
(``new_session`` / ``accept_chunk``) and the micro-batching scheduler
(``make_scheduler``), both on the runner's device.

With ``data.vocab_path`` set the transcript is the tokenizer's text (the
port's ``data/tokenizer.py``); without a vocab it is the space-joined
token ids, as in JAX. With ``decode.quantize_int8`` the runner serves int8
weights as the JAX runner does (``ops/quant.py``), to sessions and the
scheduler too.
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
from ..decode.streaming import StreamingSession, new_session, session_accept_chunk
from ..device import resolve_device
from ..models import cmvn as cmvn_mod
from ..models.transducer import encode, init_transducer
from ..ops.fbank import fbank_numpy
from ..ops.quant import quantize_tree
from ..params import from_jax_params, load_jax_npz
from ..train.checkpoint import import_torch_checkpoint


INT8_SKIP_KEYS = ("predictor", "cmvn", "joint", "ctc")   # the JAX runner's
TORCH_CHECKPOINT_SUFFIXES = (".pt", ".ckpt", ".pth")     # the JAX runner's state-dict route


@dataclass
class Recognition:
    text: str
    tokens: list[int]


class ModelRunner:
    """Serves one model. ``params`` is None (random init from
    ``cfg.train.seed``), a JAX params tree (nested dicts and lists of
    arrays, int8 leaves of a JAX-quantized tree included), the path of a
    JAX ``save_params_npz`` file, or the path of a reference / WeNet state
    dict (``.pt``, ``.ckpt``, ``.pth``), imported onto the random init as
    the JAX runner does (``train/checkpoint.import_torch_checkpoint``).

    The CMVN statistics of ``data.cmvn_path`` go into params that carry
    none: the random init, and so the state-dict route, whose mapping has
    no CMVN key. Given weights keep their own, as a JAX restore over the
    init keeps the checkpoint's.

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
        state_dict = isinstance(params, str) and params.endswith(TORCH_CHECKPOINT_SUFFIXES)
        if params is None or state_dict:
            self.params = init_transducer(cfg.model, cfg.train.seed, self.device)
        elif isinstance(params, str):
            self.params = load_jax_npz(params, self.device)
        else:
            self.params = from_jax_params(params, self.device)
        if cfg.data.cmvn_path and "cmvn" not in self.params:
            self.params["cmvn"] = cmvn_mod.init_cmvn_from_file(cfg.data.cmvn_path, self.device)
        if state_dict:
            self.params = import_torch_checkpoint(params, self.params, cfg.model, self.device)
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

    # ------------------------------------------------------------- streaming

    @torch.inference_mode()
    def new_session(self) -> StreamingSession:
        """A fresh live stream whose attention cache holds chunk x max(left
        chunks, 1) frames, at least 64 (the scheduler's rule too)."""
        d = self.cfg.decode
        return new_session(
            self.params, self.cfg.model,
            cache_size=max(d.decoding_chunk_size * max(d.num_decoding_left_chunks, 1), 64),
            device=self.device)

    @torch.inference_mode()
    def accept_chunk(self, session: StreamingSession, wav: np.ndarray,
                     sr: int) -> tuple[StreamingSession, Recognition]:
        """Feed raw audio samples: their fbank is one chunk of the session.
        Returns (the next session, the running transcript)."""
        feats = torch.as_tensor(self.preprocess_waveform(wav, sr), device=self.device)
        with self._decode_lock:
            session = session_accept_chunk(self.params, session, feats, self.cfg.model,
                                           n_steps=self.cfg.decode.n_steps)
        ids = self.session_ids(session)
        return session, Recognition(text=self._ids_to_text(ids), tokens=ids)

    @staticmethod
    def session_ids(session: StreamingSession) -> list[int]:
        return session.hyps[0, : int(session.hyp_len[0])].tolist()

    def make_scheduler(self, n_slots: int = 16, max_wait_ms: float = 2.0):
        """The micro-batching scheduler over this model and device
        (``serve/scheduler.py``): N connections share one [n_slots, Tc, F]
        chunk step per tick."""
        from .scheduler import StreamScheduler

        return StreamScheduler(self.params, self.cfg, n_slots=n_slots,
                               max_wait_ms=max_wait_ms, device=self.device)

    def _ids_to_text(self, ids: list[int]) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, ids))
        return self.tokenizer.decode_ids(ids, stop_id=self.cfg.model.sos_eos_id)
