"""Shared model layers (port of mamba_asr_tpu/models/layers.py): the
positionwise FFN, its 1-D CNN form, the Conformer convolution module
(full sequence and streaming chunks) and the Conv2d front end (whole,
and one block at a time for the streaming front end).

Parameters keep the reference PyTorch names that
`mamba_asr_tpu.models.torch_export.export_asr_params` writes (SpeechBrain's
wrappers `.w` / `.norm`, Sequential indices), so a state dict loads with
`strict=True`. Parameters are float32; each layer computes in its
`dtype`, as a flax module with `dtype=` does: linear and conv layers cast
inputs and weights to it, LayerNorms take statistics in float32 and
return `dtype`.

Dropout sits where the JAX package's does (the FFN after its activation,
the conv module's output, the front end after each conv block) and runs
only in train() mode, through `dropout` below: `F.dropout`, whose masks
draw from torch's default generator for the tensor's device (the
Trainer seeds it). It adds no parameters, so the state dict is unchanged.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from mamba_asr_torch.ops.beam_attention import StepPos

Activation = Callable[[torch.Tensor], torch.Tensor]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`lin` applied in `dtype` (flax nn.Dense(dtype=...)). Under tensor
    parallelism a Linear holding this rank's rows of its weight carries
    `tp_dense` (parallel/tensor.py:column_parallel), which computes this
    rank's output columns and gathers the rest."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    tp_dense = getattr(lin, "tp_dense", None)
    if tp_dense is not None:
        return tp_dense(x.to(dtype), lin.weight.to(dtype), bias)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Inverted dropout in train mode; the identity otherwise or at p 0."""
    return F.dropout(x, p, training=True) if training and p > 0 else x


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=...): float32 statistics, output in dtype.
    Scale and bias stored in bf16 (the beam search's cast decode weights)
    enter as float32, as flax promotes them."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(dtype)


def row_at(table: torch.Tensor, pos) -> torch.Tensor:
    """table[pos] for a host int `pos` or a `StepPos` (its `dev`, which
    must be on the table's device)."""
    if isinstance(pos, StepPos):
        return table.index_select(0, pos.dev.reshape(1))[0]
    return table[pos]


def write_at(buf: torch.Tensor, dim: int, pos, value: torch.Tensor) -> None:
    """buf's slice `pos` along `dim` set to value, in place; `pos` as in
    `row_at`."""
    if isinstance(pos, StepPos):
        buf.index_copy_(dim, pos.dev.reshape(1), value.unsqueeze(dim))
    else:
        buf.select(dim, pos).copy_(value)


def cast_copy(module, keys, dtype):
    """A new module object holding `module`'s submodules, those named in
    `keys` replaced by copies with every parameter in `dtype`; `module`
    stays as it was."""
    out = copy.copy(module)
    out._modules = dict(module._modules)
    with torch.no_grad():
        for key in keys:
            sub = copy.deepcopy(module._modules[key])
            for p in sub.parameters():
                p.data = p.data.to(dtype)
            out._modules[key] = sub
    return out


def flax_init_(module: nn.Module, name: str, p: torch.Tensor,
               generator: torch.Generator) -> None:
    """The JAX package's init of `module`'s parameter `name`: normal(stddev
    1) token embeddings, unit LayerNorm scales, zero biases, and flax's
    default kernel init, a truncated normal of variance 1/fan_in (fan_in of
    the torch layout, which equals flax's for every layer of the port)."""
    if isinstance(module, nn.Embedding):
        p.normal_(0.0, 1.0, generator=generator)
    elif isinstance(module, nn.LayerNorm):
        p.fill_(1.0 if name == "weight" else 0.0)
    elif p.dim() >= 2:
        std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
    else:
        p.zero_()


def stream_stack(encoder: nn.Module, x: torch.Tensor, state: list):
    """An encoder's streaming chunk: each layer's `forward_chunk` in turn,
    then the stack's final LN. Returns (output, the new per-layer state)."""
    new = []
    for layer, s in zip(encoder.layers, state):
        x, s = layer.forward_chunk(x, s)
        new.append(s)
    return layer_norm(x, encoder.norm.norm, encoder.dtype), new


def run_layer(layer: nn.Module, remat: bool, *args) -> torch.Tensor:
    """`layer(*args)`; with `remat` in train() mode under grad, through a
    non-reentrant `torch.utils.checkpoint` (the JAX package's `nn.remat`
    of its stacked body, `models/stacking.py:84-134`): the backward
    recomputes the layer's activations instead of keeping them.
    preserve_rng_state replays the forward's dropout draws in the
    recompute from the generator state the forward began with, also where
    that state was a `DeviceRngStream`'s whose swap has ended since."""
    if remat and layer.training and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False,
                                                 preserve_rng_state=True)
    return layer(*args)


def make_layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class SBLinear(nn.Module):
    """SpeechBrain's Linear wrapper: the layer sits under `.w`."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.w = nn.Linear(n_in, n_out, bias=bias)


class SBLayerNorm(nn.Module):
    """SpeechBrain's LayerNorm wrapper: the norm sits under `.norm`."""

    def __init__(self, d: int):
        super().__init__()
        self.norm = make_layer_norm(d)


class PositionalwiseFeedForward(nn.Module):
    """Dense(d_ffn) -> activation -> dropout -> Dense(d_model). The
    reference keys are `ffn.0` and `ffn.3` (a Sequential with activation
    and dropout between)."""

    def __init__(self, d_model: int, d_ffn: int, activation: Activation = swish,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.ffn = nn.ModuleDict({
            "0": nn.Linear(d_model, d_ffn), "3": nn.Linear(d_ffn, d_model),
        })
        self.activation = activation
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.activation(dense(x, self.ffn["0"], self.dtype))
        h = dropout(h, self.dropout, self.training)
        return dense(h, self.ffn["3"], self.dtype)


class _SBConv1d(nn.Module):
    """SpeechBrain's Conv1d wrapper: the layer sits under `.conv`."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k)


def conv_pads(k: int, causal: bool) -> tuple:
    """(left, right) padding of a stride-1 conv of k taps: flax's "CAUSAL"
    (k-1, 0) or "SAME" ((k-1)//2, k-1-(k-1)//2)."""
    return (k - 1, 0) if causal else ((k - 1) // 2, k - 1 - (k - 1) // 2)


class CNNFeedForward(nn.Module):
    """The 1-D CNN FFN of the Transformer encoder layer (`ffn_type: 1dcnn`,
    JAX `layers.py:CNNFeedForward`): Conv1d(d_ffn, k0) -> ReLU ->
    Conv1d(d_model, k1), SAME or (causal) left padding, no dropout inside.
    Keys `0.conv` and `2.conv`: the reference's Sequential(Conv1d, ReLU,
    Conv1d) of SpeechBrain Conv1d wrappers."""

    def __init__(self, d_model: int, d_ffn: int, kernel_sizes=(3, 3),
                 causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.add_module("0", _SBConv1d(d_model, d_ffn, kernel_sizes[0]))
        self.add_module("2", _SBConv1d(d_ffn, d_model, kernel_sizes[1]))
        self.causal = causal
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2).to(self.dtype)
        for i, key in enumerate(("0", "2")):
            conv = self._modules[key].conv
            h = F.conv1d(F.pad(h, conv_pads(conv.kernel_size[0], self.causal)),
                         conv.weight.to(self.dtype), conv.bias.to(self.dtype))
            if i == 0:
                h = F.relu(h)
        return h.transpose(1, 2)


def dynamic_chunk_depthwise(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor], pad: int,
                            chunk_size: int) -> torch.Tensor:
    """Dynamic Chunk Convolution (JAX `layers.py:228-256`, after
    SpeechBrain's Conformer.py:1090-1213): a depthwise conv of 2 * pad + 1
    taps over (B, T, D), each chunk of chunk_size frames seeing `pad`
    frames of left context and zeros to its right. The sequence is padded
    to whole chunks (the last chunk's missing frames are zeros too), each
    [left context, chunk, zeros] window runs VALID, and the result is cut
    back to T frames. Shared by the conv module and the Branchformer's
    CSGU. weight (D, 1, K) and bias in x's dtype."""
    b, t, d = x.shape
    right = (-t) % chunk_size
    n_chunks = (t + right) // chunk_size
    xp = F.pad(x, (0, 0, pad, right))
    win = pad + chunk_size
    idx = (torch.arange(n_chunks, device=x.device)[:, None] * chunk_size
           + torch.arange(win, device=x.device)[None, :])
    windows = F.pad(xp[:, idx], (0, 0, 0, pad))  # (B, n_chunks, win + pad, D)
    windows = windows.reshape(b * n_chunks, win + pad, d).transpose(1, 2)
    out = F.conv1d(windows, weight, bias, groups=d)  # (B * n_chunks, D, chunk_size)
    return out.transpose(1, 2).reshape(b, n_chunks * chunk_size, d)[:, :t]


class ConvolutionModule(nn.Module):
    """Conformer convolution module, full sequence:
    LN -> pointwise 2x expansion + GLU -> depthwise conv -> LN ->
    activation -> pointwise Dense -> dropout, then zero at the padded
    frames of `mask` (B, L, 1), True = padded (JAX `layers.py:155-162`;
    the Conformer passes its key padding mask, ConMamba none). Non-causal
    pads (K-1)//2 on both sides, causal pads K-1 on the left; with
    chunk_size (dynamic-chunk training, non-causal only) the conv is
    `dynamic_chunk_depthwise`. Streaming: `init_stream_state` and
    `forward_chunk` carry the left tail."""

    def __init__(self, d_model: int, kernel_size: int = 31, bias: bool = True,
                 activation: Activation = swish, causal: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layer_norm = make_layer_norm(d_model)
        # Reference: Conv1d(d, 2d, 1) + GLU; applied here as a Dense.
        self.bottleneck = nn.ModuleDict(
            {"0": nn.Conv1d(d_model, 2 * d_model, 1, bias=bias)}
        )
        self.conv = nn.Conv1d(d_model, d_model, kernel_size, groups=d_model,
                              bias=bias)
        self.after_conv = nn.ModuleDict({
            "0": make_layer_norm(d_model),
            "2": nn.Linear(d_model, d_model, bias=bias),
        })
        self.kernel_size = kernel_size
        self.activation = activation
        self.causal = causal
        self.dtype = dtype
        self.dropout = dropout

    @property
    def padding_amount(self) -> int:
        k = self.kernel_size
        return k - 1 if self.causal else (k - 1) // 2

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        """LN -> pointwise 2x expansion -> GLU, in the compute dtype."""
        dt = self.dtype
        out = layer_norm(x, self.layer_norm, dt)
        pw = self.bottleneck["0"]
        out = F.linear(out, pw.weight[:, :, 0].to(dt),
                       None if pw.bias is None else pw.bias.to(dt))
        a, g = out.chunk(2, dim=-1)
        return a * torch.sigmoid(g)

    def _depthwise(self, out: torch.Tensor, pads: tuple) -> torch.Tensor:
        """The depthwise conv over (B, L, D) with (left, right) time padding."""
        dt = self.dtype
        out = F.pad(out.transpose(1, 2), pads)
        out = F.conv1d(out, self.conv.weight.to(dt),
                       None if self.conv.bias is None else self.conv.bias.to(dt),
                       groups=out.shape[1])
        return out.transpose(1, 2)

    def _post(self, out: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = layer_norm(out, self.after_conv["0"], dt)
        out = dense(self.activation(out), self.after_conv["2"], dt)
        return dropout(out, self.dropout, self.training)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                chunk_size: Optional[int] = None, seq=None) -> torch.Tensor:
        """seq: the axis the time axis is sharded over (sequence
        parallelism): the depthwise conv reads a (p, p) halo of the
        neighbouring shards, (p, 0) when causal (JAX `layers.py:172-183`)."""
        p = self.padding_amount
        out = self._pre(x)
        if seq is not None:
            from mamba_asr_torch.parallel.sequence import sp_halo_exchange

            if chunk_size is not None:
                raise ValueError("dynamic-chunk convolution cannot take sequence "
                                 "parallelism: a chunk would straddle two shards")
            out = self._depthwise(sp_halo_exchange(out, p, 0 if self.causal else p, seq),
                                  (0, 0))
        elif chunk_size is not None:
            if self.causal:
                raise ValueError("dynamic-chunk convolution needs a non-causal conv module")
            dt = self.dtype
            out = dynamic_chunk_depthwise(
                out, self.conv.weight.to(dt),
                None if self.conv.bias is None else self.conv.bias.to(dt), p, chunk_size)
        else:
            out = self._depthwise(out, (p, 0) if self.causal else (p, p))
        out = self._post(out)
        return out if mask is None else out.masked_fill(mask, 0.0)

    def init_stream_state(self, batch: int, dtype: torch.dtype, device=None) -> torch.Tensor:
        """The left-context tail carried across chunks: (B, pad, D) zeros."""
        return torch.zeros(batch, self.padding_amount, self.conv.in_channels, dtype=dtype,
                           device=device)

    def forward_chunk(self, x: torch.Tensor, tail: torch.Tensor):
        """One streaming chunk (JAX `layers.py:204-216`): the conv over
        [tail, chunk]; a non-causal conv sees zeros to its right, a causal
        one is exact. Returns (out, new tail)."""
        out = self._pre(x)
        pad = self.padding_amount
        buf = torch.cat([tail.to(out.dtype), out], dim=1)
        new_tail = buf[:, buf.shape[1] - pad:] if pad else tail
        return self._post(self._depthwise(buf, (0, 0 if self.causal else pad))), new_tail


def same_padding(n: int, k: int, s: int) -> tuple:
    """flax padding="SAME" for one axis: (0, 1) for an even n and (1, 1)
    for an odd one at k=3, s=2 -- input-dependent and asymmetric."""
    out = -(-n // s)
    tot = max((out - 1) * s + k - n, 0)
    return tot // 2, tot - tot // 2


class SBConv2d(nn.Module):
    """SpeechBrain's Conv2d wrapper: the layer sits under `.conv`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.convs = nn.ModuleDict({
            "conv_0": SBConv2d(cin, cout, k, stride),
            "norm_0": SBLayerNorm(cout),
        })


class ConvolutionFrontEnd(nn.Module):
    """Conv2d subsampling stack: (B, T, n_mels) -> (B, T', F', C_last).

    Each block: flax-SAME padding, Conv2d (stride s), LayerNorm over the
    channels only, leaky_relu(0.01), dropout. Time is the conv's H axis
    and mel frequency its W axis; the output is channels-last, as in the
    JAX package, so the caller's (B, T', F'*C) flatten matches.
    """

    def __init__(self, out_channels: Sequence[int] = (64, 32),
                 kernel_sizes: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (2, 2),
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        cin = 1
        for i, (c, k, s) in enumerate(zip(out_channels, kernel_sizes, strides)):
            setattr(self, f"convblock_{i}", _ConvBlock(cin, c, k, s))
            cin = c
        self.kernel_sizes = tuple(kernel_sizes)
        self.strides = tuple(strides)
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = feats[:, None].to(dt)  # (B, 1, T, F)
        for i, (k, s) in enumerate(zip(self.kernel_sizes, self.strides)):
            convs = getattr(self, f"convblock_{i}").convs
            conv = convs["conv_0"].conv
            pt = same_padding(x.shape[2], k, s)
            pf = same_padding(x.shape[3], k, s)
            x = F.pad(x, (pf[0], pf[1], pt[0], pt[1]))
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=s)
            y = layer_norm(x.permute(0, 2, 3, 1), convs["norm_0"].norm, dt)
            y = dropout(F.leaky_relu(y, 0.01), self.dropout, self.training)
            x = y.permute(0, 3, 1, 2)
        return y

    def apply_level(self, i: int, x: torch.Tensor, time_pad: tuple) -> torch.Tensor:
        """One block with explicit time padding and the offline SAME
        padding of frequency (JAX `layers.py:298-322`), for the streaming
        front end: x (B, T, F, C_in) channels-last -> (B, T', F', C_out).
        Mid-stream the caller runs it VALID over buffered inputs (time_pad
        (0, 0)); the flush supplies the offline trailing zero."""
        dt = self.dtype
        k, s = self.kernel_sizes[i], self.strides[i]
        convs = getattr(self, f"convblock_{i}").convs
        conv = convs["conv_0"].conv
        pf = same_padding(x.shape[2], k, s)
        h = F.pad(x.permute(0, 3, 1, 2).to(dt), (pf[0], pf[1], time_pad[0], time_pad[1]))
        h = F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=s)
        return F.leaky_relu(layer_norm(h.permute(0, 2, 3, 1), convs["norm_0"].norm, dt), 0.01)
