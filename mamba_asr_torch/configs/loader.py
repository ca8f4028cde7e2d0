"""Load an hparams YAML (port of mamba_asr_tpu/configs/loader.py, with a
copy of the JAX package's FrontendConfig from training/trainer.py and of
its DataConfig and DecodeConfig).

The stanzas are `name`, `seed`, `model`, `frontend`, `train`, `specaug`,
`data`, `decode` and `parallel`, with every field and default of the JAX
package's. `--section.key value` overrides are applied to the YAML
before it is read and are type-coerced from the dataclass fields. Of the
`parallel` stanza, `sequence_parallel` (ConMamba only, without dynamic
chunks) and `pipeline_stages` with `pipeline_microbatches` (ConMamba with
`scan_layers`, a layer count the stages divide, neither sequence
parallelism nor dynamic chunks) are ported; `tensor_parallel > 1` raises,
naming the ROADMAP item that will take it.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, Dict, Optional, Sequence, Tuple, get_args, get_origin

import yaml

from mamba_asr_torch.models.asr import ASRConfig
from mamba_asr_torch.models.mamba import MambaConfig
from mamba_asr_torch.parallel.encoder_parallel import (
    check_pipeline_parallel,
    check_sequence_parallel,
)
from mamba_asr_torch.parallel.tensor import check_tensor_parallel
from mamba_asr_torch.training.trainer import SpecAugmentConfig, TrainConfig


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Fbank parameters (hparams/CTC/conmamba_large.yaml:102-106)."""

    sample_rate: int = 16000
    n_fft: int = 512
    n_mels: int = 80
    win_length_ms: float = 25.0
    hop_length_ms: float = 10.0

    @property
    def hop(self) -> int:
        return int(round(self.sample_rate * self.hop_length_ms / 1000.0))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Corpus, tokenizer and loader settings."""

    data_folder: str = ""
    output_folder: str = "results"
    train_splits: Tuple[str, ...] = ("train-clean-100",)
    dev_splits: Tuple[str, ...] = ("dev-clean",)
    test_splits: Tuple[str, ...] = ("test-clean", "test-other")
    train_csv: str = "train.csv"
    skip_prep: bool = False
    tokenizer_type: str = "char"  # char (bpe | unigram: not ported)
    vocab_size: int = 31
    sample_rate: int = 16000
    num_buckets: int = 8
    max_batch_seconds: float = 850.0
    max_batch_ex: int = 128
    valid_max_batch_seconds: float = 100.0
    speed_perturb: bool = True
    sorting: str = "random"
    num_workers: int = 0  # decode/perturb threads; 0: one per CPU
    prefetch_batches: int = 4
    create_lexicon: bool = False


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoding settings, every field and default of the JAX package's
    DecodeConfig. The port reads the CTC beam's fields (`training.loop.
    Trainer.ctc_decoder`), the S2S joint search's
    (`serving.recognizer.Recognizer(search="s2s")`) and the LM's
    (`models.lm.load_lm`: lm_path, lm_dtype and the lm_* widths; the
    search's lm_weight and temperature_lm)."""

    # CTC beam search (hparams/CTC/conmamba_large.yaml:168-172, 232-237).
    valid_greedy: bool = True
    test_beam_size: int = 100
    blank_index: int = 0
    beam_prune_logp: float = -12.0
    token_prune_min_logp: float = -1.2
    # S2S joint search (hparams/S2S/conmamba_large.yaml:239-245).
    valid_search_interval: int = 10
    valid_beam_size: int = 10
    s2s_test_beam_size: int = 66
    ctc_weight_decode: float = 0.4
    ctc_candidates: int = 96  # partial CTC scoring (0 = full vocab)
    lm_weight: float = 0.6
    temperature: float = 1.15
    temperature_lm: float = 1.15
    using_eos_threshold: bool = False
    length_normalization: bool = True
    max_decode_ratio: float = 1.0
    min_decode_ratio: float = 0.0
    # Optional LM fused at test decode (empty: no LM, as in every YAML).
    lm_path: str = ""
    lm_dtype: str = "bfloat16"
    lm_d_model: int = 768
    lm_nhead: int = 12
    lm_layers: int = 12
    lm_d_ffn: int = 3072


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The process grid of multi-process training (a copy of the JAX
    package's ParallelConfig): data axis = ranks / (tensor_parallel *
    sequence_parallel * pipeline_stages). tensor_parallel slices every
    parameter JAX's rule shards (at least min_shard_elements elements)
    over that many ranks (parallel/tensor.py); sequence_parallel shards the
    ConMamba encoder's time axis over that many ranks; pipeline_stages
    splits its layers into that many stages run on the GPipe schedule over
    pipeline_microbatches microbatches of each rank's batch
    (parallel/encoder_parallel.py). Tensor parallelism does not combine
    with the other two yet."""

    tensor_parallel: int = 1
    min_shard_elements: int = 16384
    sequence_parallel: int = 1
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    seed: int = 3407
    model: ASRConfig = ASRConfig()
    frontend: FrontendConfig = FrontendConfig()
    train: TrainConfig = TrainConfig()
    specaug: SpecAugmentConfig = SpecAugmentConfig()
    data: DataConfig = DataConfig()
    decode: DecodeConfig = DecodeConfig()
    parallel: ParallelConfig = ParallelConfig()

    @property
    def output_folder(self) -> str:
        return os.path.join(self.data.output_folder, self.name, str(self.seed))


_NESTED = {"model": ASRConfig, "frontend": FrontendConfig, "mamba": MambaConfig,
           "train": TrainConfig, "specaug": SpecAugmentConfig,
           "data": DataConfig, "decode": DecodeConfig, "parallel": ParallelConfig}


def _coerce(field_type, value):
    origin = get_origin(field_type)
    if origin in (tuple, Tuple):
        args = get_args(field_type)
        elem = args[0] if args else str
        return tuple(_coerce(elem, v) for v in value)
    if field_type is float and value is not None:
        return float(value)
    if field_type is int and value is not None and not isinstance(value, bool):
        return int(value)
    if field_type is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes")
    if field_type is Optional[int] and value is not None:
        return int(value)
    return value


def _build(cls, d: Dict[str, Any]):
    field_names = {f.name for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for k, v in d.items():
        if k not in field_names:
            raise KeyError(f"unknown config key '{k}' for {cls.__name__}")
        if k in _NESTED and isinstance(v, dict):
            kwargs[k] = _build(_NESTED[k], v)
        else:
            kwargs[k] = _coerce(hints[k], v)
    return cls(**kwargs)


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None
                ) -> ExperimentConfig:
    with open(path, encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    for dotted, value in (overrides or {}).items():
        node = raw
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    exp = _build(ExperimentConfig, raw)
    check_parallel(exp)
    return exp


def check_parallel(exp: ExperimentConfig) -> None:
    """Raise on a parallel stanza the port cannot train: tensor
    parallelism with sequence or pipeline parallelism
    (`check_tensor_parallel`), sequence parallelism on an encoder other
    than ConMamba or with dynamic-chunk training, or pipeline parallelism
    where `check_pipeline_parallel` refuses it. More stages or model
    ranks than a world's ranks is the grid's error
    (`parallel/mesh.py:make_mesh`)."""
    par = exp.parallel
    check_tensor_parallel(par.tensor_parallel, par.sequence_parallel, par.pipeline_stages)
    if par.pipeline_stages > 1:
        m = exp.model
        check_pipeline_parallel(m.encoder_module, m.scan_layers, m.num_encoder_layers,
                                par.pipeline_stages, par.sequence_parallel,
                                exp.train.dynchunk_size)
    elif par.sequence_parallel > 1:
        check_sequence_parallel(exp.model.encoder_module, exp.train.dynchunk_size)


def parse_overrides(argv: Sequence[str]) -> Dict[str, Any]:
    """`--a.b value` (or `--a.b=value`) pairs -> {"a.b": yaml-parsed value}."""
    out: Dict[str, Any] = {}
    i = 0
    args = list(argv)
    while i < len(args):
        a = args[i]
        if not a.startswith("--"):
            raise ValueError(f"expected --key, got {a}")
        key = a[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(args):
                raise ValueError(f"missing value for --{key}")
            val = args[i + 1]
            i += 2
        out[key] = yaml.safe_load(val)
    return out
