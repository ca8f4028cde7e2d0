"""Top-level ASR model (port of mamba_asr_tpu/models/asr.py), ConMamba
encoder with the CTC head and, for S2S configs, the Transformer decoder:

    feats -> Conv2d front end -> flatten (B, T', F'*C) -> src_proj ->
    dropout -> ConMamba encoder -> ctc_head (float32) -> log_softmax
    tokens -> NormalizedEmbedding + sinusoidal PE -> TransformerDecoder
           -> seq_head (float32)

`cfg.dropout` applies in train() mode at the JAX package's places
(models/layers.py and conmamba.py say which); eval() has none. The
decoder has none yet (S2S training comes with a later slice).

The module tree is the reference's saved ModuleList, so the state dict
has the names that `export_asr_params` writes and `params_import`
produces: `0` the CNN front end, `1` the TransformerASR (its
`custom_src_module` holds src_proj, `encoder` the ConMamba stack,
`custom_tgt_module` the embedding, `decoder` the decoder), then the
heads: `2` the CTC head without a decoder; `2` the seq head and `3` the
CTC head with one (`torch_export.py:296-310`). The other encoders and
the Mamba and Conformer decoders wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.conmamba import ConmambaEncoder
from mamba_asr_torch.models.layers import (
    ConvolutionFrontEnd,
    SBLinear,
    dense,
    dropout,
    swish,
)
from mamba_asr_torch.models.transformer import (
    NormalizedEmbedding,
    TransformerDecoder,
    get_lookahead_mask,
    lengths_to_padding_mask,
    sinusoidal_position_encoding,
)
from mamba_asr_torch.models.mamba import (
    BiMambaBlock,
    MambaBlock,
    MambaConfig,
    init_a_log_,
    init_dt_bias_,
    init_dt_proj_weight_,
)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch.nn.GELU's default and the reference's."""
    return F.gelu(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "gelu": _gelu_exact,
    "gelu_tanh": _gelu_tanh,
    "relu": F.relu,
    "swish": swish,
    "silu": swish,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Model hyperparameters, a copy of the JAX package's ASRConfig so that
    every hparams YAML loads. `scan_layers` and `remat_layers` are JAX
    compile-time devices and change nothing here; `params_import` accepts
    params of either layout."""

    vocab_size: int = 31
    n_mels: int = 80
    d_model: int = 256
    nhead: int = 4
    num_encoder_layers: int = 18
    num_decoder_layers: int = 0
    d_ffn: int = 1024
    dropout: float = 0.1
    activation: str = "gelu"
    encoder_module: str = "conmamba"
    decoder_module: str = "transformer"
    csgu_linear_units: int = 3072
    gate_activation: str = "identity"
    use_linear_after_conv: bool = False
    attention_type: str = "RelPosMHAXL"
    positional_encoding: str = "fixed_abs_sine"
    kernel_size: int = 31
    bias: bool = True
    causal: bool = False
    max_length: int = 2500
    frontend_channels: Tuple[int, ...] = (64, 32)
    frontend_strides: Tuple[int, ...] = (2, 2)
    mamba: MambaConfig = MambaConfig()
    bidirectional: bool = True
    scan_layers: bool = False
    remat_layers: bool = False
    compute_dtype: str = "float32"
    xavier_parity_init: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def frontend_output_dim(self) -> int:
        f = self.n_mels
        for s in self.frontend_strides:
            f = -(-f // s)
        return f * self.frontend_channels[-1]

    @property
    def downsample(self) -> int:
        d = 1
        for s in self.frontend_strides:
            d *= s
        return d

    def activation_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return _ACTIVATIONS[self.activation]


class _SrcModule(nn.Module):
    """The reference's custom_src_module: `layers.0` is src_proj."""

    def __init__(self, n_in: int, d_model: int):
        super().__init__()
        self.layers = nn.ModuleList([SBLinear(n_in, d_model)])


class _TgtModule(nn.Module):
    """The reference's custom_tgt_module: `layers.0` is the embedding."""

    def __init__(self, vocab_size: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList([NormalizedEmbedding(vocab_size, d_model, dtype)])


class _TransformerASR(nn.Module):
    """Entry `1` of the reference ModuleList: src_proj and the encoder,
    and with a decoder the target embedding and the decoder."""

    def __init__(self, cfg: ASRConfig):
        super().__init__()
        self.custom_src_module = _SrcModule(cfg.frontend_output_dim, cfg.d_model)
        self.encoder = ConmambaEncoder(
            num_layers=cfg.num_encoder_layers, d_model=cfg.d_model,
            d_ffn=cfg.d_ffn, kernel_size=cfg.kernel_size,
            activation=cfg.activation_fn(), bias=cfg.bias, causal=cfg.causal,
            mamba_cfg=cfg.mamba, bidirectional=cfg.bidirectional,
            dtype=cfg.dtype, dropout=cfg.dropout,
        )
        if cfg.num_decoder_layers > 0:
            self.custom_tgt_module = _TgtModule(cfg.vocab_size, cfg.d_model, cfg.dtype)
            self.decoder = TransformerDecoder(
                cfg.num_decoder_layers, cfg.d_model, cfg.d_ffn, cfg.nhead,
                cfg.activation_fn(), cfg.dtype,
            )


class ASRModel(nn.Module):
    """feats (B, T, n_mels) -> enc_out, enc_lengths, ctc_log_probs; with a
    decoder also `decode` (teacher-forced) and the cached `decode_step`."""

    def __init__(self, cfg: ASRConfig):
        super().__init__()
        if cfg.encoder_module != "conmamba":
            raise NotImplementedError(
                f"encoder_module={cfg.encoder_module!r}: only the ConMamba "
                "encoder is ported; the others come with the slice that "
                "ports the other encoders (ROADMAP Slice 4)"
            )
        if cfg.num_decoder_layers > 0 and cfg.decoder_module != "transformer":
            raise NotImplementedError(
                f"decoder_module={cfg.decoder_module!r}: only the Transformer "
                "decoder is ported; the Mamba and Conformer decoders come "
                "with ROADMAP slice 3b"
            )
        if cfg.xavier_parity_init:
            raise NotImplementedError("xavier_parity_init is not ported")
        self.cfg = cfg
        self.add_module("0", ConvolutionFrontEnd(
            out_channels=cfg.frontend_channels,
            kernel_sizes=tuple(3 for _ in cfg.frontend_channels),
            strides=cfg.frontend_strides, dtype=cfg.dtype, dropout=cfg.dropout,
        ))
        self.add_module("1", _TransformerASR(cfg))
        # ctc_lin without a decoder; seq_lin with one, and ctc_lin at "3".
        self.add_module("2", SBLinear(cfg.d_model, cfg.vocab_size))
        if cfg.num_decoder_layers > 0:
            self.add_module("3", SBLinear(cfg.d_model, cfg.vocab_size))
            # Decoder positions 0 .. max_length-1 (not in the state dict).
            self.register_buffer("dec_pe", sinusoidal_position_encoding(
                cfg.max_length, cfg.d_model), persistent=False)

    @property
    def frontend(self) -> ConvolutionFrontEnd:
        return self._modules["0"]

    @property
    def src_proj(self) -> nn.Linear:
        return self._modules["1"].custom_src_module.layers[0].w

    @property
    def encoder(self) -> ConmambaEncoder:
        return self._modules["1"].encoder

    @property
    def has_decoder(self) -> bool:
        return self.cfg.num_decoder_layers > 0

    @property
    def ctc_head(self) -> nn.Linear:
        return self._modules["3" if self.has_decoder else "2"].w

    @property
    def seq_head(self) -> nn.Linear:
        return self._modules["2"].w

    @property
    def tgt_embed(self) -> NormalizedEmbedding:
        return self._modules["1"].custom_tgt_module.layers[0]

    @property
    def decoder(self) -> TransformerDecoder:
        return self._modules["1"].decoder

    def encode(self, feats: torch.Tensor,
               feat_lengths: Optional[torch.Tensor] = None):
        """feats (B, T, n_mels) -> (enc_out (B, T', d_model), enc_lengths)."""
        x = self.frontend(feats)  # (B, T', F', C)
        b, t, f, c = x.shape
        x = dense(x.reshape(b, t, f * c), self.src_proj, self.cfg.dtype)
        x = dropout(x, self.cfg.dropout, self.training)  # src_drop
        if feat_lengths is not None:
            enc_lengths = -(-feat_lengths // self.cfg.downsample)  # ceil div
        else:
            enc_lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        return self.encoder(x), enc_lengths

    def forward(self, feats: torch.Tensor,
                feat_lengths: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        enc, enc_lengths = self.encode(feats, feat_lengths)
        ctc_logits = dense(enc.float(), self.ctc_head, torch.float32)
        return {
            "enc_out": enc,
            "enc_lengths": enc_lengths,
            "ctc_log_probs": F.log_softmax(ctc_logits, dim=-1),
        }

    # -- decoder ------------------------------------------------------------

    def decode(self, tokens: torch.Tensor, enc_out: torch.Tensor,
               enc_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced: tokens (B, S) -> decoder states (B, S, d_model)
        (eval form: no target padding mask)."""
        s = tokens.shape[1]
        tgt = self.tgt_embed(tokens) + self.dec_pe[:s].to(self.cfg.dtype)
        mem_kpm = (None if enc_lengths is None
                   else lengths_to_padding_mask(enc_lengths, enc_out.shape[1]))
        return self.decoder(tgt, enc_out, get_lookahead_mask(s, tokens.device),
                            memory_key_padding_mask=mem_kpm)

    def seq_logits(self, dec: torch.Tensor) -> torch.Tensor:
        """seq_head in float32 (its logits, before any softmax)."""
        return dense(dec.float(), self.seq_head, torch.float32)

    def init_decoder_cache(self, n: int, s_max: int):
        """Append-only self K/V buffers of length s_max for n hypotheses."""
        return self.decoder.init_cache(n, s_max, self.cfg.d_model,
                                       device=self.seq_head.weight.device)

    def prime_decoder_cache(self, enc_out: torch.Tensor, cache,
                            enc_lengths: Optional[torch.Tensor] = None):
        """Project enc_out (B, T, d_model) into every layer's cross K/V
        once; the cache's hypotheses are the B utterances' beams, in
        order."""
        mem_kpm = (None if enc_lengths is None
                   else lengths_to_padding_mask(enc_lengths, enc_out.shape[1]))
        return self.decoder.prime_cache(enc_out, cache, mem_kpm)

    def decode_step(self, token_t: torch.Tensor, pos: int, cache,
                    anc: torch.Tensor):
        """One decode step: token_t (N,) at position `pos` -> (raw seq-head
        logits (N, V) float32, cache)."""
        tgt = self.tgt_embed(token_t) + self.dec_pe[pos].to(self.cfg.dtype)
        dec, cache = self.decoder.step(tgt, pos, cache, anc)
        return self.seq_logits(dec), cache


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in
    (fan_in of the torch layout, which equals flax's for every layer
    here)."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_params_(model: ASRModel, generator: torch.Generator) -> ASRModel:
    """Seeded weights with the JAX package's init rules: lecun-normal
    kernels, zero biases, unit LayerNorm scales, normal(stddev 1) token
    embeddings, and Mamba's S4D A_log, log-uniform dt bias, uniform
    dt_proj and unit D."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, nn.Embedding):
                p.normal_(0.0, 1.0, generator=generator)
            elif isinstance(module, nn.LayerNorm):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name in ("A_log", "A_b_log"):
                init_a_log_(p)
            elif name in ("D", "D_b"):
                p.fill_(1.0)
            elif p.dim() >= 2:
                _lecun_normal_(p, generator)
            else:
                p.zero_()
    mcfg = model.cfg.mamba
    for module in model.modules():
        if isinstance(module, (MambaBlock, BiMambaBlock)):
            for suffix in ("", "_b"):
                dt_proj = getattr(module, f"dt_proj{suffix}", None)
                if dt_proj is not None:
                    init_dt_proj_weight_(dt_proj.weight,
                                         dt_proj.weight.shape[1], mcfg,
                                         generator)
                    init_dt_bias_(dt_proj.bias, mcfg, generator)
    return model
