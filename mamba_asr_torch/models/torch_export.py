"""The port's models as reference PyTorch checkpoints (the port's
counterpart of mamba_asr_tpu/models/torch_export.py): the `model.ckpt` of
`nn.ModuleList([CNN, Transformer, (seq_lin,) ctc_lin])` that the
reference's Pretrainer loads, its `normalizer.ckpt`, and the flat
TransformerLM `lm.pt`.

The port's modules already carry the reference's state-dict names
(models/asr.py, models/lm.py), so an export is the model's state dict in
float32 without the weightless position buffers (`.pe`,
`positional_encoding`) that `params_import.load_torch_asr` drops on the
way in. Its keys and values are those `export_asr_params` /
`export_lm_params` write for the same JAX params.

What the JAX exporter cannot write, this one refuses alike, with a
ValueError naming it: the Branchformer (`torch_export.py:268-272`), the
Conformer decoder (the JAX exporter maps every non-Mamba decoder as a
Transformer decoder, `:300-305`, and finds no self-attention in it),
hypermixing attention and a Transformer encoder with RelPosMHAXL (the
reference's Conformer and Transformer layouts hold regularMHA, and the
Conformer's RelPosMHAXL, alone).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from mamba_asr_torch.models.params_import import NOT_WEIGHTS

# encoder_module -> the attention types the reference layout holds for it.
EXPORTABLE = {"conmamba": None, "conformer": ("RelPosMHAXL", "regularMHA"),
              "transformer": ("regularMHA",)}


def check_exportable(cfg) -> None:
    """Raise ValueError where the reference layout cannot hold cfg's model."""
    if cfg.encoder_module not in EXPORTABLE:
        raise ValueError(f"no torch checkpoint layout exists for encoder_module="
                         f"{cfg.encoder_module!r} (the reference cannot construct it)")
    attentions = EXPORTABLE[cfg.encoder_module]
    if attentions is not None and cfg.attention_type not in attentions:
        raise ValueError(f"no torch checkpoint layout exists for a {cfg.encoder_module} "
                         f"encoder with attention_type={cfg.attention_type!r}")
    if cfg.num_decoder_layers > 0 and cfg.decoder_module == "conformer":
        raise ValueError("no torch checkpoint layout exists for decoder_module='conformer' "
                         "(the reference builds Transformer and Mamba decoders only)")


def _weights(module: nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()
            if not any(s in k for s in NOT_WEIGHTS)}


def export_asr_state(model: nn.Module, cfg) -> Dict[str, np.ndarray]:
    """An ASRModel -> the reference `model` ModuleList state dict (float32
    numpy arrays), for the models the reference layout holds."""
    check_exportable(cfg)
    return _weights(model)


def export_lm_state(lm: nn.Module) -> Dict[str, np.ndarray]:
    """A TransformerLM -> SpeechBrain's flat TransformerLM state dict."""
    return _weights(lm)


def export_normalizer_stats(normalizer) -> Dict[str, np.ndarray]:
    """A NormalizerState (count, mean, m2) -> SpeechBrain InputNormalization's
    glob_mean, glob_std = sqrt(m2 / count) (ones when count is 0) and
    count (JAX `torch_export.py:337-350`)."""
    count = float(normalizer.count)
    mean = normalizer.mean.detach().float().cpu().numpy()
    if count > 0:
        std = np.sqrt(normalizer.m2.detach().float().cpu().numpy() / count).astype(np.float32)
    else:
        std = np.ones_like(mean)
    return {"glob_mean": mean, "glob_std": std, "count": np.float32(count)}


def torch_save(sd: Dict[str, np.ndarray], path: str) -> None:
    """torch.save of float32 arrays as tensors (each at least 1-D, as the
    JAX script writes the normaliser's count)."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(np.atleast_1d(v)))
                for k, v in sd.items()}, path)


def save_torch_asr(model: nn.Module, cfg, path: str) -> None:
    torch_save(export_asr_state(model, cfg), path)


def save_torch_lm(lm: nn.Module, path: str) -> None:
    torch_save(export_lm_state(lm), path)
