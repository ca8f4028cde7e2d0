"""Top-level ASR model (port of mamba_asr_tpu/models/asr.py): an encoder
(`encoder_module`) with the CTC head and, for S2S configs, the
Transformer, the Mamba or the Conformer decoder (`decoder_module`):

    feats -> Conv2d front end -> flatten (B, T', F'*C) -> src_proj ->
    dropout -> encoder -> ctc_head (float32) -> log_softmax
    tokens_bos -> NormalizedEmbedding + sinusoidal PE -> TransformerDecoder,
           MambaDecoder or ConformerDecoder -> seq_head (float32)
           -> log_softmax  (S2S configs)

The encoders (JAX `asr.py:345-388`): ConMamba (no mask: padded frames
are scanned, as in JAX), and the Conformer, the Branchformer and the
pre-LN Transformer, which take the key padding mask of `enc_lengths`
and, by `attention_type`, the relative offsets' sine table in the
compute dtype (RelPosMHAXL), nothing (hypermixing, which adds its own
PE), or (regularMHA) the absolute sine PE added to the input, except
the Conformer's regularMHA, which JAX gives no PE at all. A causal model
with hypermixing is refused (ROADMAP Departures).

`forward(feats, lengths, tokens_bos)` is the JAX package's `__call__`
(`asr.py:520-575`): with a decoder and tokens_bos it adds the teacher-
forced `seq_log_probs`. `cfg.dropout` applies in train() mode at the JAX
package's places (models/layers.py, conmamba.py and transformer.py say
which), and in train() mode the decoder's self-attention also masks the
targets' padding (tokens == 0, `asr.py:419`); eval() has neither. The
memory's padding mask applies in both. The Mamba decoder masks nothing
(`asr.py:406`): it scans padded frames and targets, as the JAX package
does. The Conformer decoder masks the memory's padding alone, in both
modes (`asr.py:408-417`).

The module tree is the reference's saved ModuleList, so the state dict
has the names that `export_asr_params` writes and `params_import`
produces: `0` the CNN front end, `1` the TransformerASR (its
`custom_src_module` holds src_proj, `encoder` the encoder stack,
`custom_tgt_module` the embedding, `decoder` the decoder), then the
heads: `2` the CTC head without a decoder; `2` the seq head and `3` the
CTC head with one (`torch_export.py:296-310`). The Conformer decoder has
no reference layout; its names are the port's own (models/conformer.py).

Streaming: `init_streaming_state`, `forward_chunk` (a chunk of the
streamed front end's output through src_proj and the encoder's chunk),
`encode_chunk` and `extend_decoder_cache`; models/streaming.py drives
them.

The decode cache dispatches on the decoder: the Transformer's takes an
s_max and an ancestor table (append-only K/V), the Mamba decoder's
neither (a (conv, ssm) state per Mamba block, reordered by the search).
The Conformer decoder has no cache (JAX has none, `conformer.py:289,
:371`): the search re-scores its prefix through `decode`.

`xavier_reinit_` is the JAX package's `xavier_parity_init`
(`training/trainer.py:555-588`): the Trainer applies it after
`init_params_` when the config sets it, never to imported weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.attention import rel_pos_encoding
from mamba_asr_torch.models.branchformer import BranchformerEncoder
from mamba_asr_torch.models.conformer import ConformerDecoder, ConformerEncoder
from mamba_asr_torch.models.conmamba import ConmambaEncoder, MambaDecoder
from mamba_asr_torch.models.layers import (
    ConvolutionFrontEnd,
    SBLinear,
    dense,
    dropout,
    flax_init_,
    row_at,
    swish,
)
from mamba_asr_torch.models.transformer import (
    NormalizedEmbedding,
    TransformerDecoder,
    TransformerEncoder,
    get_lookahead_mask,
    lengths_to_padding_mask,
    make_chunked_src_mask,
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
STREAMING_ENCODERS = ("conmamba", "conformer", "branchformer")
DECODERS = ("transformer", "mamba", "conformer")


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """Model hyperparameters, a copy of the JAX package's ASRConfig so that
    every hparams YAML loads. `scan_layers` is a JAX compile-time device
    and changes nothing here (`params_import` accepts params of either
    layout). `remat_layers` (recompute the encoder layers' activations in
    the backward) is not ported yet and does nothing: a model that sets it
    keeps every activation (ROADMAP Queue 1 item 14)."""

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


def build_encoder(cfg: ASRConfig) -> nn.Module:
    """The encoder of `cfg.encoder_module` (JAX `asr.py:175-236`)."""
    act, dt = cfg.activation_fn(), cfg.dtype
    mod = cfg.encoder_module
    if mod == "conmamba":
        return ConmambaEncoder(
            num_layers=cfg.num_encoder_layers, d_model=cfg.d_model,
            d_ffn=cfg.d_ffn, kernel_size=cfg.kernel_size,
            activation=act, bias=cfg.bias, causal=cfg.causal,
            mamba_cfg=cfg.mamba, bidirectional=cfg.bidirectional,
            dtype=dt, dropout=cfg.dropout,
        )
    if mod == "conformer":
        return ConformerEncoder(
            cfg.num_encoder_layers, cfg.d_model, cfg.d_ffn, cfg.nhead, cfg.kernel_size,
            act, cfg.bias, cfg.causal, cfg.attention_type, dt, cfg.dropout)
    if mod == "branchformer":
        return BranchformerEncoder(
            cfg.num_encoder_layers, cfg.d_model, cfg.nhead, cfg.kernel_size,
            cfg.csgu_linear_units, cfg.use_linear_after_conv, cfg.gate_activation, act,
            cfg.causal, cfg.attention_type, dt, cfg.dropout)
    if mod == "transformer":
        # JAX passes neither causal, layerdrop nor the FFN type (asr.py:223-234).
        return TransformerEncoder(
            cfg.num_encoder_layers, cfg.d_model, cfg.d_ffn, cfg.nhead, act,
            normalize_before=True, dtype=dt, dropout=cfg.dropout,
            attention_type=cfg.attention_type)
    raise ValueError(f"unknown encoder_module {mod!r}")


class _TransformerASR(nn.Module):
    """Entry `1` of the reference ModuleList: src_proj and the encoder,
    and with a decoder the target embedding and the decoder."""

    def __init__(self, cfg: ASRConfig):
        super().__init__()
        self.custom_src_module = _SrcModule(cfg.frontend_output_dim, cfg.d_model)
        self.encoder = build_encoder(cfg)
        if cfg.num_decoder_layers > 0:
            self.custom_tgt_module = _TgtModule(cfg.vocab_size, cfg.d_model, cfg.dtype)
            if cfg.decoder_module == "mamba":
                self.decoder = MambaDecoder(
                    cfg.num_decoder_layers, cfg.d_model, cfg.d_ffn,
                    cfg.activation_fn(), cfg.mamba, cfg.dtype, cfg.dropout,
                )
            elif cfg.decoder_module == "conformer":
                self.decoder = ConformerDecoder(
                    cfg.num_decoder_layers, cfg.d_model, cfg.d_ffn, cfg.nhead,
                    cfg.kernel_size, cfg.activation_fn(), cfg.bias, cfg.dtype, cfg.dropout,
                )
            else:
                self.decoder = TransformerDecoder(
                    cfg.num_decoder_layers, cfg.d_model, cfg.d_ffn, cfg.nhead,
                    cfg.activation_fn(), cfg.dtype, cfg.dropout,
                )


class ASRModel(nn.Module):
    """feats (B, T, n_mels) -> enc_out, enc_lengths, ctc_log_probs, and with
    a decoder and tokens_bos seq_log_probs; with a decoder also `decode`
    (teacher-forced) and the cached `decode_step`."""

    def __init__(self, cfg: ASRConfig):
        super().__init__()
        if cfg.attention_type == "hypermixing" and cfg.causal \
                and cfg.encoder_module != "conmamba":
            raise ValueError(
                "attention_type=hypermixing mixes every frame: a causal model cannot "
                "take it (the JAX package mixes the future without a word)")
        if cfg.num_decoder_layers > 0 and cfg.decoder_module not in DECODERS:
            raise ValueError(f"unknown decoder_module {cfg.decoder_module!r} "
                             f"(decoders: {', '.join(DECODERS)})")
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
    def encoder(self) -> nn.Module:
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
    def decoder(self) -> Union[TransformerDecoder, MambaDecoder, ConformerDecoder]:
        return self._modules["1"].decoder

    @property
    def mamba_decoder(self) -> bool:
        return self.has_decoder and self.cfg.decoder_module == "mamba"

    @property
    def conformer_decoder(self) -> bool:
        return self.has_decoder and self.cfg.decoder_module == "conformer"

    def encode_pre(self, feats: torch.Tensor,
                   feat_lengths: Optional[torch.Tensor] = None):
        """The front end and the projection: feats (B, T, n_mels) -> (x (B,
        T', d_model), enc_lengths). The split point where the encoder stack
        runs under sequence parallelism (JAX `asr.py:301-325`,
        parallel/encoder_parallel.py); `encode` is this and the stack."""
        x = self.frontend(feats)  # (B, T', F', C)
        b, t, f, c = x.shape
        x = dense(x.reshape(b, t, f * c), self.src_proj, self.cfg.dtype)
        x = dropout(x, self.cfg.dropout, self.training)  # src_drop
        if feat_lengths is not None:
            enc_lengths = -(-feat_lengths // self.cfg.downsample)  # ceil div
        else:
            enc_lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        return x, enc_lengths

    def encode(self, feats: torch.Tensor,
               feat_lengths: Optional[torch.Tensor] = None,
               chunk_size: Optional[int] = None,
               left_context_chunks: Optional[int] = None):
        """feats (B, T, n_mels) -> (enc_out (B, T', d_model), enc_lengths).
        chunk_size (encoder frames): dynamic-chunk training (JAX
        `asr.py:327-387`): the attention encoders take
        `make_chunked_src_mask(T', chunk_size, left_context_chunks)` beside
        the padding mask, and the conv modules (ConMamba's, the
        Conformer's, the Branchformer's CSGU) convolve chunk by chunk; the
        Transformer encoder takes the mask alone."""
        x, enc_lengths = self.encode_pre(feats, feat_lengths)
        b, t = x.shape[:2]
        cfg = self.cfg
        if cfg.encoder_module == "conmamba":
            return self.encoder(x, chunk_size), enc_lengths
        pos = None
        if cfg.attention_type == "RelPosMHAXL":
            pos = rel_pos_encoding(t, cfg.d_model, x.dtype, x.device)
        elif cfg.attention_type != "hypermixing" and cfg.encoder_module != "conformer":
            x = x + sinusoidal_position_encoding(t, cfg.d_model, x.dtype, x.device)
        pad_mask = lengths_to_padding_mask(enc_lengths, t)
        src_mask = None
        if chunk_size is not None:
            src_mask = make_chunked_src_mask(t, chunk_size, left_context_chunks, x.device)
        chunk = {} if cfg.encoder_module == "transformer" else {"chunk_size": chunk_size}
        return self.encoder(x, src_mask=src_mask, src_key_padding_mask=pad_mask,
                            pos_embs=pos, **chunk), enc_lengths

    def forward(self, feats: torch.Tensor,
                feat_lengths: Optional[torch.Tensor] = None,
                tokens_bos: Optional[torch.Tensor] = None,
                chunk_size: Optional[int] = None,
                left_context_chunks: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        enc, enc_lengths = self.encode(feats, feat_lengths, chunk_size, left_context_chunks)
        return self.forward_from_enc(enc, enc_lengths, tokens_bos)

    def forward_from_enc(self, enc: torch.Tensor, enc_lengths: torch.Tensor,
                         tokens_bos: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
        """The heads (and the teacher-forced decoder) on an encoder output:
        the tail of `forward`, on its own where the stack ran outside it
        (sequence parallelism; JAX `asr.py:539-575`)."""
        ctc_logits = dense(enc.float(), self.ctc_head, torch.float32)
        out = {
            "enc_out": enc,
            "enc_lengths": enc_lengths,
            "ctc_log_probs": F.log_softmax(ctc_logits, dim=-1),
        }
        if tokens_bos is not None and self.has_decoder:
            dec = self.decode(tokens_bos, enc, enc_lengths)
            out["seq_log_probs"] = F.log_softmax(self.seq_logits(dec), dim=-1)
        return out

    # -- streaming encode -----------------------------------------------------

    def init_streaming_state(self, batch: int):
        """The encoder's per-layer state for chunked streaming, on the
        model's device (JAX `asr.py:436-446`): ConMamba, the Conformer and
        the Branchformer stream; the others raise."""
        if self.cfg.encoder_module not in STREAMING_ENCODERS:
            raise ValueError(f"encoder_module {self.cfg.encoder_module!r} does not stream "
                             f"(streaming encoders: {', '.join(STREAMING_ENCODERS)})")
        return self.encoder.init_stream_state(batch, self.src_proj.weight.device)

    def forward_chunk(self, fe_out: torch.Tensor, state):
        """The front end's output for one chunk (B, T', F', C) -> src_proj
        -> the encoder's `forward_chunk`: (enc_out (B, T', d_model), the new
        state)."""
        b, t, f, c = fe_out.shape
        x = dense(fe_out.reshape(b, t, f * c), self.src_proj, self.cfg.dtype)
        return self.encoder.forward_chunk(x, state)

    def encode_chunk(self, feats: torch.Tensor, state):
        """One chunk of normalised features (B, T, n_mels) through the
        whole front end (SAME-padded per chunk) and the encoder's chunk
        (JAX `asr.py:448-456`); the streaming sessions stream the front end
        exactly instead (models/streaming.py)."""
        return self.forward_chunk(self.frontend(feats), state)

    def extend_decoder_cache(self, enc_chunk: torch.Tensor, cache):
        """The Mamba decoder's cache advanced over a further chunk of
        encoder memory (JAX `asr.py:492-496`)."""
        if not self.mamba_decoder:
            raise ValueError("extend_decoder_cache needs the Mamba decoder")
        return self.decoder.extend_cache(enc_chunk, cache)

    # -- decoder ------------------------------------------------------------

    def decode(self, tokens: torch.Tensor, enc_out: torch.Tensor,
               enc_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced: tokens (B, S) -> decoder states (B, S, d_model).
        In train() mode the Transformer decoder masks the target's padding
        (tokens == 0) too; the Mamba decoder ignores enc_lengths and
        padding. The Conformer decoder also takes a memory of fewer rows
        than tokens, when tokens' rows are each utterance's beam rows in
        order (B' = g * B: the S2S search's prefix re-score)."""
        s = tokens.shape[1]
        tgt = self.tgt_embed(tokens) + self.dec_pe[:s].to(self.cfg.dtype)
        if self.mamba_decoder:
            return self.decoder(tgt, enc_out)
        mem_kpm = (None if enc_lengths is None
                   else lengths_to_padding_mask(enc_lengths, enc_out.shape[1]))
        if self.conformer_decoder:
            return self.decoder(tgt, enc_out, mem_kpm)
        tgt_kpm = tokens == 0 if self.training else None
        return self.decoder(tgt, enc_out, get_lookahead_mask(s, tokens.device),
                            tgt_key_padding_mask=tgt_kpm, memory_key_padding_mask=mem_kpm)

    def seq_logits(self, dec: torch.Tensor) -> torch.Tensor:
        """seq_head in float32 (its logits, before any softmax)."""
        return dense(dec.float(), self.seq_head, torch.float32)

    def _refuse_conformer_cache(self):
        if self.conformer_decoder:
            raise ValueError("the Conformer decoder has no decode cache (nor has the JAX "
                             "package's): the S2S search re-scores its prefix through "
                             "decode")

    def init_decoder_cache(self, n: int, s_max: Optional[int] = None):
        """The decode cache of n hypotheses: for the Transformer decoder
        append-only self K/V buffers of length s_max; for the Mamba decoder
        zero (conv, ssm) states (no s_max)."""
        self._refuse_conformer_cache()
        device = self.seq_head.weight.device
        if self.mamba_decoder:
            return self.decoder.init_cache(n, device=device)
        if s_max is None:
            raise ValueError("the Transformer decoder's cache needs s_max")
        return self.decoder.init_cache(n, s_max, self.cfg.d_model, device=device)

    def prime_decoder_cache(self, enc_out: torch.Tensor, cache,
                            enc_lengths: Optional[torch.Tensor] = None):
        """Transformer: project enc_out (B, T, d_model) into every layer's
        cross K/V once; the cache's hypotheses are the B utterances' beams,
        in order. Mamba: scan enc_out (one row per hypothesis) into every
        layer's cross-Mamba state; enc_lengths is not used."""
        self._refuse_conformer_cache()
        if self.mamba_decoder:
            return self.decoder.prime_cache(enc_out, cache)
        mem_kpm = (None if enc_lengths is None
                   else lengths_to_padding_mask(enc_lengths, enc_out.shape[1]))
        return self.decoder.prime_cache(enc_out, cache, mem_kpm)

    def decode_step(self, token_t: torch.Tensor, pos, cache,
                    anc: Optional[torch.Tensor] = None):
        """One decode step: token_t (N,) at position `pos` (a host int or a
        `ops.beam_attention.StepPos`) -> (raw seq-head logits (N,
        V) float32, cache). `anc`, the ancestor table, is the Transformer
        decoder's alone."""
        self._refuse_conformer_cache()
        tgt = self.tgt_embed(token_t) + row_at(self.dec_pe, pos).to(self.cfg.dtype)
        if self.mamba_decoder:
            dec, cache = self.decoder.step(tgt, cache)
        else:
            dec, cache = self.decoder.step(tgt, pos, cache, anc)
        return self.seq_logits(dec), cache


@torch.no_grad()
def init_params_(model: ASRModel, generator: torch.Generator) -> ASRModel:
    """Seeded weights with the JAX package's init rules: lecun-normal
    kernels, zero biases, unit LayerNorm scales, normal(stddev 1) token
    embeddings, and Mamba's S4D A_log, log-uniform dt bias, uniform
    dt_proj and unit D (the encoder's and the Mamba decoder's blocks);
    a module with its own rules (RelPosMHAXL's zero u and v, HyperMixing's
    MLPs, the CSGU's near-identity gate) applies them last."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name in ("A_log", "A_b_log"):
                init_a_log_(p)
            elif name in ("D", "D_b"):
                p.fill_(1.0)
            else:
                flax_init_(module, name, p, generator)
    for module in model.modules():
        if hasattr(module, "init_params_"):  # RelPosMHAXL, HyperMixing, the CSGU
            module.init_params_(generator)
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


def xavier_fans(module: nn.Module, name: str, p: torch.Tensor):
    """[(rows of p, fan_in, fan_out)] of a parameter with ndim > 1, the
    fans of the JAX leaf it is imported from (models/params_import.py):
    JAX takes fan_in as the product of every axis but the last and fan_out
    as the last. A Linear or Conv weight is stored out-first, (out, in,
    *taps), where JAX's leaf is (*taps, in, out) (a depthwise conv's (K,
    D), the conv module's pointwise Dense (D, 2D)); the stacked
    `in_proj_weight` (3D, D) is three leaves q, k, v of (D, D); any other
    tensor (A_log, pos_bias_u/v, an embedding, HyperMixing's weights) has
    JAX's layout."""
    if name == "in_proj_weight":
        d = p.shape[0] // 3
        return [(slice(i * d, (i + 1) * d), p.shape[1], d) for i in range(3)]
    if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return [(slice(None), math.prod(p.shape[1:]), p.shape[0])]
    return [(slice(None), math.prod(p.shape[:-1]), p.shape[-1])]


@torch.no_grad()
def xavier_reinit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's init quirk (JAX `trainer.py:565-588`,
    `xavier_parity_init`): every parameter with ndim > 1 drawn anew from
    N(0, 2 / (fan_in + fan_out)) with the fans of its JAX leaf
    (`xavier_fans`), from `generator` (a CPU generator; not JAX's bits).
    It overwrites S4D's A_log, the dt projection and RelPosMHAXL's u and v,
    as the reference does; 1-D tensors stay as they are."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if p.ndim <= 1:
                continue
            for rows, fan_in, fan_out in xavier_fans(module, name, p):
                part = p[rows]
                draw = torch.randn(part.shape, generator=generator, dtype=torch.float32)
                part.copy_(draw * (2.0 / (fan_in + fan_out)) ** 0.5)
    return model
