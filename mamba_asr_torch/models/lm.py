"""The Transformer language model of shallow fusion (port of
mamba_asr_tpu/models/lm.py; SpeechBrain's TransformerLM, the reference's
speechbrain/asr-transformer-transformerlm-librispeech: 12 post-LN layers,
d_model 768, nhead 12, d_ffn 3072, exact GELU, causal self-attention only).

    tokens -> NormalizedEmbedding (x sqrt(d_model)) + sinusoidal PE
           -> TransformerEncoder (models/transformer.py) -> output_proj (float32)

- `forward(tokens (B, S))`: fp32 logits (B, S, V) of the full pass, with
  the look-ahead mask and, in train() mode, the pad-0 key padding mask
  (`lm.py:77-80`).
- `init_cache(n, s_cache)` / `step(tokens (N,), pos, cache, anc)`: one
  position of N hypotheses through every layer's append-only K/V, read
  through the search's ancestor table (K4 on the card); fp32 logits (N, V).
  The position row `pos` of the sinusoidal table equals the full pass's.
- The computation runs in `dtype`; `output_proj` runs in float32 on a
  float32 input (`lm.py:99-101`), softmax in float32 (models/attention.py).

The state dict has SpeechBrain's flat names (`torch_export.py:316-334`):
`custom_src_module.emb.Embedding.weight`, `encoder.layers.{i}.self_att.
att.in_proj_weight|bias`, `.att.out_proj`, `.pos_ffn.ffn.0|3`,
`.norm1|norm2.norm`, `encoder.norm.norm`, `output_proj.w`.

`load_lm` builds the LM of a decode stanza and loads a `.pt` / `.ckpt` /
`.pth` state dict into it (strict). `init_params_` draws flax's init
distributions from a torch generator. `cast_lm_weights` makes the
search's bf16 copy of the weights (all but `output_proj`).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.attention import KV
from mamba_asr_torch.models.layers import SBLinear, cast_copy, dense, flax_init_, row_at
from mamba_asr_torch.models.params_import import NOT_WEIGHTS
from mamba_asr_torch.models.transformer import (
    NormalizedEmbedding,
    TransformerEncoder,
    get_lookahead_mask,
    sinusoidal_position_encoding,
)
from mamba_asr_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PE_MIN = 512  # rows of the cached position table (grown when a call needs more)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 5000, d_model: int = 768, nhead: int = 12,
                 num_layers: int = 12, d_ffn: int = 3072, dropout: float = 0.0,
                 normalize_before: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.custom_src_module = NormalizedEmbedding(vocab_size, d_model, dtype)
        self.encoder = TransformerEncoder(num_layers, d_model, d_ffn, nhead, _gelu_exact,
                                          normalize_before, dtype, dropout)
        self.output_proj = SBLinear(d_model, vocab_size)
        self.vocab_size, self.d_model = vocab_size, d_model
        self.dtype = dtype
        # The cached position table: a buffer (outside the state dict), so
        # that an exported program takes it as an input, as it takes weights.
        self.register_buffer("_pe", None, persistent=False)

    def position_table(self, length: int, device) -> torch.Tensor:
        """Rows 0..length-1 of the float32 sinusoidal table on `device`."""
        if self._pe is None or self._pe.shape[0] < length or self._pe.device != device:
            self._pe = sinusoidal_position_encoding(max(length, PE_MIN),
                                                    self.d_model).to(device)
        return self._pe[:length]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x.float(), self.output_proj.w, torch.float32)

    def forward(self, tokens: torch.Tensor, pad_idx: int = 0) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) float32."""
        s = tokens.shape[1]
        x = (self.custom_src_module(tokens)
             + self.position_table(s, tokens.device).to(self.dtype))
        kpm = tokens == pad_idx if self.training else None
        return self._logits(self.encoder(x, get_lookahead_mask(s, tokens.device), kpm))

    def init_cache(self, n: int, s_cache: int, device=None) -> List[KV]:
        """Every layer's zero-filled (H, s_cache, n, dh) K/V in the compute
        dtype (zeros: the plain beam attention weighs unwritten rows by 0)."""
        return self.encoder.init_cache(n, s_cache, self.d_model, device)

    def step(self, tokens: torch.Tensor, pos, cache: List[KV],
             anc: torch.Tensor) -> torch.Tensor:
        """tokens (N,) at position `pos` (a host int or an
        `ops.beam_attention.StepPos`; below the cache's length) -> logits (N, V)
        float32; writes this position's K/V into `cache`."""
        table = self.position_table(cache[0][0].shape[1], tokens.device)
        x = self.custom_src_module(tokens) + row_at(table, pos).to(self.dtype)
        return self._logits(self.encoder.step(x, pos, cache, anc))


@torch.no_grad()
def init_params_(lm: TransformerLM, generator: torch.Generator) -> TransformerLM:
    """flax's init distributions: lecun-normal Dense kernels, zero biases,
    normal(stddev 1) embedding, unit LayerNorm scales."""
    for module in lm.modules():
        for name, p in module.named_parameters(recurse=False):
            flax_init_(module, name, p, generator)
    return lm


def cast_lm_weights(lm):
    """A TransformerLM with every weight but `output_proj` in its compute
    dtype, in a copy sharing `output_proj`; `lm` itself when there is
    nothing to cast (float32, or already cast)."""
    if all(p.dtype == lm.dtype for name, p in lm.named_parameters()
           if not name.startswith("output_proj.")):
        return lm
    return cast_copy(lm, ("custom_src_module", "encoder"), lm.dtype)


def load_lm(decode, vocab_size: int, device=None) -> Optional[TransformerLM]:
    """The LM of a decode stanza (configs/loader.py:DecodeConfig `lm_*`) at
    `vocab_size`, its weights from `decode.lm_path` loaded with
    strict=True, on `device` (None: the card) and in eval mode; None when
    lm_path is empty. A flax msgpack file raises: the port reads torch
    state dicts only."""
    if not decode.lm_path:
        return None
    if not decode.lm_path.endswith((".pt", ".ckpt", ".pth")):
        raise ValueError(
            f"decode.lm_path {decode.lm_path!r}: the port loads .pt/.ckpt/.pth state "
            "dicts; convert a flax msgpack LM with the JAX package's "
            "mamba_asr_tpu.models.torch_export.save_torch_lm")
    device = resolve_device(device)
    lm = TransformerLM(vocab_size, decode.lm_d_model, decode.lm_nhead, decode.lm_layers,
                       decode.lm_d_ffn, dtype=_DTYPES[decode.lm_dtype])
    state = torch.load(decode.lm_path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):  # the wrappers torch_import.py:471-480 takes
        if key in state and isinstance(state[key], Mapping):
            state = state[key]
            break
    own = lm.state_dict()
    lm.load_state_dict({k: v for k, v in state.items()
                        if k in own or not any(s in k for s in NOT_WEIGHTS)}, strict=True)
    return lm.to(device).eval()
