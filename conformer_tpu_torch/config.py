"""Configuration dataclasses of the PyTorch port.

An own copy of the JAX package's ``config.py`` (the port imports nothing of
``conformer_tpu``): the same fields and defaults, so both packages read the
same ``configs/*.json`` and take the same ``--set`` overrides. The mesh
fields route a multi-process trainer (``train/loop.make_trainer_mesh``).
Fields the port does not read (``donate_state``) are kept so a config
round-trips unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, Sequence


@dataclass
class ModelConfig:
    """Conformer transducer architecture (defaults: Conformer-M)."""

    input_dim: int = 80
    vocab_size: int = 5002
    blank_id: int = 0
    sos_eos_id: int = 5001
    ignore_id: int = -1

    encoder_dim: int = 256
    encoder_num_layers: int = 12
    num_heads: int = 4
    hidden_dim: int = 2048
    kernel_size: int = 15
    dropout: float = 0.1
    attention_dropout: float = 0.1
    pos_enc_dropout: float = 0.1
    max_len: int = 5000
    use_relative: bool = True
    rel_mode: str = "skew"
    # Hand-written CUDA kernels: attention (ops/rel_attention.py; forward,
    # dropout and backward, so training too) and the conv block
    # (ops/conv_block.py; deterministic forwards only); off means the plain
    # PyTorch modules.
    use_pallas_attention: bool = False
    use_pallas_conv: bool = False
    conv_norm: str = "layer_norm"
    causal_conv: bool = False

    use_dynamic_chunk: bool = True
    use_dynamic_left_chunk: bool = True
    static_chunk_size: int = -1

    predictor_embed_size: int = 256
    predictor_hidden_size: int = 256
    predictor_dim: int = 256
    predictor_num_layers: int = 2
    predictor_embed_dropout: float = 0.1
    predictor_dropout: float = 0.1

    join_dim: int = 512

    ctc_weight: float = 0.2
    transducer_weight: float = 0.8
    use_pruned_loss: bool = False
    prune_range: int = 5
    simple_loss_scale: float = 0.5
    use_pallas_rnnt: bool = False
    use_pallas_joint: bool = False
    rnnt_t_chunk: int = 128
    use_pallas_ctc: bool = False
    attention_weight: float = 0.0
    lsm_weight: float = 0.1
    reverse_weight: float = 0.0

    decoder_num_layers: int = 0
    decoder_hidden_dim: int = 2048

    remat: bool = False

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.encoder_dim // self.num_heads


@dataclass
class DataConfig:
    train_data_list_path: str = ""
    dev_data_list_path: str = ""
    test_data_list_path: str = ""
    vocab_path: str = ""
    cmvn_path: str = ""
    bpe_model: str | None = None
    non_lang_syms: str | None = None
    split_with_space: bool = False

    resample_rate: int = 16000
    speed_perturb: bool = True
    speeds: Sequence[float] = (0.9, 1.0, 1.1)

    feat_type: str = "fbank"
    num_mel_bins: int = 80
    frame_length: float = 25.0      # ms
    frame_shift: float = 10.0       # ms
    dither: float = 0.1
    num_ceps: int = 40
    low_freq: float = 20.0
    high_freq: float = 0.0

    spec_aug: bool = True
    num_t_mask: int = 2
    num_f_mask: int = 2
    max_t: int = 50
    max_f: int = 50

    filter_data: bool = True
    max_length: float = 1650
    min_length: float = 10
    token_max_length: int = 200
    token_min_length: int = 1
    min_output_input_ratio: float = 0.0005
    max_output_input_ratio: float = 1.0

    shuffle: bool = True
    shuffle_size: int = 1500
    sort: bool = True
    sort_size: int = 500
    prefetch_depth: int = 4

    batch_type: str = "bucket"
    batch_size: int = 16
    max_frames_in_batch: int = 8000
    bucket_boundaries: Sequence[int] = (256, 512, 768, 1024, 1280, 1650)
    max_label_len: int = 200
    extend_epochs: int = 0


@dataclass
class TrainConfig:
    lr: float = 1e-3
    warmup_steps: int = 25000
    grad_clip: float = 4.0
    accum_grad: int = 2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    max_steps: int = 1_000_000
    max_epochs: int = 1000
    seed: int = 777
    val_check_interval: int = 10000
    num_sanity_val_steps: int = 2
    log_every: int = 100
    checkpoint_dir: str = "experiments/default"
    resume_from: str | None = None
    keep_checkpoints: int = 5

    mesh_data: int = -1
    mesh_model: int = 1
    mesh_pipe: int = 1
    pipeline_microbatches: int = 2
    mesh_seq: int = 1
    donate_state: bool = True
    remat: bool = False


@dataclass
class DecodeConfig:
    mode: str = "greedy_rnnt"
    n_steps: int = 64               # max emissions per frame
    max_hyp_len: int = 256
    beam_size: int = 8
    beam_expansions: int = 2
    beam_blank_skip_window: int = 0
    rescore_ctc_weight: float = 0.5
    prefix_beam_top_c: int = 16
    streaming: bool = False
    decoding_chunk_size: int = 16
    num_decoding_left_chunks: int = -1
    quantize_int8: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp, sub):
            known = {f.name for f in fields(tp)}
            return tp(**{k: v for k, v in sub.items() if k in known})

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            decode=build(DecodeConfig, d.get("decode", {})),
        )

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def apply_overrides(self, overrides: Sequence[str]) -> "Config":
        """A new config with dotted ``section.key=value`` overrides applied,
        each value parsed by the type of the field's current value (bools
        from 1/true/yes, lists as JSON, ``null`` for None)."""
        d = dataclasses.asdict(self)
        for ov in overrides:
            key, _, raw = ov.partition("=")
            section, _, name = key.partition(".")
            if section not in d or name not in d[section]:
                raise KeyError(f"unknown config override: {ov!r}")
            cur = d[section][name]
            if isinstance(cur, bool):
                val: Any = raw.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(raw)
            elif isinstance(cur, float):
                val = float(raw)
            elif isinstance(cur, (list, tuple)):
                val = json.loads(raw)
            else:
                val = None if raw == "null" else raw
            d[section][name] = val
        return Config.from_dict(d)


def tiny_test_config() -> Config:
    """A small config for tests (JAX ``config.tiny_test_config``):
    Conformer-S-like, 2 layers of width 64, float32, no dynamic chunks."""
    cfg = Config()
    cfg.model = ModelConfig(
        input_dim=80,
        vocab_size=64,
        sos_eos_id=63,
        encoder_dim=64,
        encoder_num_layers=2,
        num_heads=4,
        hidden_dim=128,
        kernel_size=7,
        predictor_embed_size=32,
        predictor_hidden_size=32,
        predictor_dim=32,
        predictor_num_layers=1,
        join_dim=64,
        compute_dtype="float32",
        use_dynamic_chunk=False,
        use_dynamic_left_chunk=False,
    )
    cfg.train.accum_grad = 1
    cfg.train.warmup_steps = 10
    return cfg
