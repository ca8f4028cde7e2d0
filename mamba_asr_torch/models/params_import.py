"""Carry the JAX package's trained ASRModel and TransformerLM params into
the port.

The port's own copy of mamba_asr_tpu/models/torch_export.py for every
encoder (ConMamba, Conformer, Transformer, Branchformer; RelPosMHAXL,
regularMHA or hypermixing), the front end, the heads, the Transformer and
Mamba decoders and the TransformerLM (with params_convert.py's scanned ->
unrolled step): a nested dict of arrays, as `ASRModel.init` or
`TransformerLM.init` gives it, becomes a state dict of float32 tensors
under the reference names, which the port's `ASRModel` and
`models.lm.TransformerLM` take with `load_state_dict(strict=True)`.
HyperMixing, the Branchformer and the 1-D CNN FFN have no reference
layout (`export_asr_params` refuses them); they map to the port's own
names (models/hypermixing.py, models/branchformer.py,
models/layers.py:CNNFeedForward).

Orientations: Dense kernels (in, out) -> Linear (out, in); attention's
q, k, v Dense kernels -> one stacked in_proj_weight (3D, D); depthwise taps
(K, D) -> Conv1d (D, 1, K); the conv module's bottleneck Dense (D, 2D) ->
pointwise Conv1d (2D, D, 1); flax Conv2d (kh, kw, I, O) -> (O, I, kh, kw).
Every leaf must be consumed: a leaf this layout cannot hold raises.

A reference checkpoint itself (`load_torch_asr`, recognize and evaluate's
--torch_ckpt) already has these names, and its normaliser statistics
come in through `import_normalizer_stats`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _leaves(node, prefix=()):
    if isinstance(node, Mapping):
        for k, v in node.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield "/".join(prefix)


def _unroll_encoder(params: Mapping[str, Any], num_layers: int) -> Dict[str, Any]:
    """scan_layers params ({'stack': {'layers': {inner: stacked}}}, leading
    depth axis) -> per-layer {'layer_i': ...} subtrees."""
    enc = dict(params["encoder"])
    (stacked,) = enc.pop("stack")["layers"].values()

    def index(node, i):
        if isinstance(node, Mapping):
            return {k: index(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    for i in range(num_layers):
        enc[f"layer_{i}"] = index(stacked, i)
    out = dict(params)
    out["encoder"] = enc
    return out


class _Tree:
    """Consumption-tracked view of a params tree ('/'-joined paths)."""

    def __init__(self, params: Mapping[str, Any]):
        self.params = params
        self.used = set()

    def has(self, path: str) -> bool:
        node = self.params
        for part in path.split("/"):
            if not isinstance(node, Mapping) or part not in node:
                return False
            node = node[part]
        return True

    def take(self, path: str) -> np.ndarray:
        if not self.has(path):
            raise KeyError(f"params tree has no '{path}'")
        node = self.params
        for part in path.split("/"):
            node = node[part]
        self.used.add(path)
        return np.asarray(node, dtype=np.float32)

    def finish(self) -> None:
        unused = sorted(set(_leaves(self.params)) - self.used)
        if unused:
            raise ValueError(
                f"{len(unused)} param leaves have no place in the port's "
                f"model (first 10): {unused[:10]}"
            )


def _linear(t: _Tree, path: str, key: str, out: Dict[str, np.ndarray]):
    out[f"{key}.weight"] = t.take(f"{path}/kernel").T
    if t.has(f"{path}/bias"):
        out[f"{key}.bias"] = t.take(f"{path}/bias")


def _layer_norm(t: _Tree, path: str, key: str, out: Dict[str, np.ndarray]):
    out[f"{key}.weight"] = t.take(f"{path}/scale")
    out[f"{key}.bias"] = t.take(f"{path}/bias")


def _ffn(t: _Tree, path: str, key: str, out):
    _linear(t, f"{path}/Dense_0", f"{key}.ffn.0", out)
    _linear(t, f"{path}/Dense_1", f"{key}.ffn.3", out)


def _scan_head(t: _Tree, path: str, key: str, suffix: str, out):
    out[f"{key}.conv1d{suffix}.weight"] = t.take(f"{path}/conv_w").T[:, None, :]
    if t.has(f"{path}/conv_b"):
        out[f"{key}.conv1d{suffix}.bias"] = t.take(f"{path}/conv_b")
    out[f"{key}.x_proj{suffix}.weight"] = t.take(f"{path}/x_proj/kernel").T
    out[f"{key}.dt_proj{suffix}.weight"] = t.take(f"{path}/dt_kernel").T
    out[f"{key}.dt_proj{suffix}.bias"] = t.take(f"{path}/dt_bias")
    out[f"{key}.A_b_log" if suffix else f"{key}.A_log"] = t.take(f"{path}/A_log")
    out[f"{key}.D{suffix}"] = t.take(f"{path}/D")


def _mamba(t: _Tree, path: str, key: str, out):
    _linear(t, f"{path}/in_proj", f"{key}.in_proj", out)
    _linear(t, f"{path}/out_proj", f"{key}.out_proj", out)
    _scan_head(t, f"{path}/fwd", key, "", out)
    if t.has(f"{path}/bwd"):
        _scan_head(t, f"{path}/bwd", key, "_b", out)


def _conv_module(t: _Tree, path: str, key: str, out):
    _layer_norm(t, f"{path}/layer_norm", f"{key}.layer_norm", out)
    out[f"{key}.bottleneck.0.weight"] = (
        t.take(f"{path}/bottleneck/kernel").T[:, :, None]
    )
    if t.has(f"{path}/bottleneck/bias"):
        out[f"{key}.bottleneck.0.bias"] = t.take(f"{path}/bottleneck/bias")
    out[f"{key}.conv.weight"] = t.take(f"{path}/dw_kernel").T[:, None, :]
    if t.has(f"{path}/dw_bias"):
        out[f"{key}.conv.bias"] = t.take(f"{path}/dw_bias")
    _layer_norm(t, f"{path}/after_norm", f"{key}.after_conv.0", out)
    _linear(t, f"{path}/pointwise_out", f"{key}.after_conv.2", out)


def _encoder_layer(t: _Tree, path: str, key: str, out):
    _layer_norm(t, f"{path}/ffn1_norm", f"{key}.ffn_module1.0", out)
    _ffn(t, f"{path}/ffn1", f"{key}.ffn_module1.1", out)
    _mamba(t, f"{path}/mamba", f"{key}.mamba", out)
    _conv_module(t, f"{path}/conv", f"{key}.convolution_module", out)
    _layer_norm(t, f"{path}/ffn2_norm", f"{key}.ffn_module2.0", out)
    _ffn(t, f"{path}/ffn2", f"{key}.ffn_module2.1", out)
    _layer_norm(t, f"{path}/norm1", f"{key}.norm1.norm", out)
    _layer_norm(t, f"{path}/norm2", f"{key}.norm2.norm", out)


def _mha(t: _Tree, path: str, key: str, out):
    """q, k, v and out Dense layers -> SpeechBrain's `att.in_proj_*` and
    `att.out_proj` (torch_export.py:_sb_mha)."""
    names = ("q", "k", "v")
    out[f"{key}.att.in_proj_weight"] = np.concatenate(
        [t.take(f"{path}/{n}/kernel").T for n in names], axis=0)
    out[f"{key}.att.in_proj_bias"] = np.concatenate(
        [t.take(f"{path}/{n}/bias") for n in names], axis=0)
    _linear(t, f"{path}/out", f"{key}.att.out_proj", out)


def _relpos_mha(t: _Tree, path: str, key: str, out):
    """torch_export.py:_relpos_mha: no-bias q, k, v stacked, `out`, the
    position projection and the (H, dh) biases u and v."""
    out[f"{key}.in_proj_weight"] = np.concatenate(
        [t.take(f"{path}/{n}/kernel").T for n in ("q", "k", "v")], axis=0)
    _linear(t, f"{path}/out", f"{key}.out_proj", out)
    out[f"{key}.linear_pos.weight"] = t.take(f"{path}/pos/kernel").T
    for name in ("pos_bias_u", "pos_bias_v"):
        out[f"{key}.{name}"] = t.take(f"{path}/{name}")


def _hypermixing(t: _Tree, path: str, key: str, out):
    for gen in ("hyper_w1_gen", "hyper_w2_gen"):
        for name in ("fc1_weights", "fc1_biases", "fc2_weights", "fc2_biases"):
            out[f"{key}.{gen}.{name}"] = t.take(f"{path}/{gen}/{name}")
    _layer_norm(t, f"{path}/layer_norm", f"{key}.layer_norm", out)


def _attention(attention_type: str):
    """The mapper of an encoder layer's self-attention."""
    return {"RelPosMHAXL": _relpos_mha, "hypermixing": _hypermixing}.get(
        attention_type, _mha)


def _conformer_layer(t: _Tree, path: str, key: str, attention_type: str, out):
    """torch_export.py:_conformer_encoder_layer."""
    _layer_norm(t, f"{path}/ffn1_norm", f"{key}.ffn_module1.0", out)
    _ffn(t, f"{path}/ffn1", f"{key}.ffn_module1.1", out)
    _attention(attention_type)(t, f"{path}/mha", f"{key}.mha_layer", out)
    _conv_module(t, f"{path}/conv", f"{key}.convolution_module", out)
    _layer_norm(t, f"{path}/ffn2_norm", f"{key}.ffn_module2.0", out)
    _ffn(t, f"{path}/ffn2", f"{key}.ffn_module2.1", out)
    _layer_norm(t, f"{path}/norm1", f"{key}.norm1.norm", out)
    _layer_norm(t, f"{path}/norm2", f"{key}.norm2.norm", out)


def _branchformer_layer(t: _Tree, path: str, key: str, attention_type: str, out):
    """The JAX tree onto the port's own names (models/branchformer.py)."""
    _layer_norm(t, f"{path}/norm_mha", f"{key}.norm_mha", out)
    _layer_norm(t, f"{path}/norm_mlp", f"{key}.norm_mlp", out)
    _attention(attention_type)(t, f"{path}/mha", f"{key}.mha_layer", out)
    mlp = f"{path}/cgmlp"
    _linear(t, f"{mlp}/channel_proj1", f"{key}.cgmlp.channel_proj1", out)
    _csgu(t, f"{mlp}/csgu", f"{key}.cgmlp.csgu", out)
    _linear(t, f"{mlp}/channel_proj2", f"{key}.cgmlp.channel_proj2", out)
    _linear(t, f"{path}/merge_proj", f"{key}.merge_proj", out)


def _csgu(t: _Tree, path: str, key: str, out):
    _layer_norm(t, f"{path}/norm", f"{key}.norm", out)
    out[f"{key}.conv.weight"] = t.take(f"{path}/dw_kernel").T[:, None, :]
    out[f"{key}.conv.bias"] = t.take(f"{path}/dw_bias")
    if t.has(f"{path}/linear_after_conv"):
        _linear(t, f"{path}/linear_after_conv", f"{key}.linear_after_conv", out)


def _decoder_layer(t: _Tree, path: str, key: str, out):
    _mha(t, f"{path}/self_attn", f"{key}.self_attn", out)
    _mha(t, f"{path}/cross_attn", f"{key}.multihead_attn", out)
    _ffn(t, f"{path}/ffn", f"{key}.pos_ffn", out)
    for i in (1, 2, 3):
        _layer_norm(t, f"{path}/norm{i}", f"{key}.norm{i}.norm", out)


def _mamba_decoder_layer(t: _Tree, path: str, key: str, out):
    """torch_export.py:_mamba_decoder_layer."""
    _mamba(t, f"{path}/self_mamba", f"{key}.self_mamba", out)
    _mamba(t, f"{path}/cross_mamba", f"{key}.cross_mamba", out)
    _ffn(t, f"{path}/pos_ffn", f"{key}.pos_ffn", out)
    for i in (1, 2, 3):
        _layer_norm(t, f"{path}/norm{i}", f"{key}.norm{i}.norm", out)


def _transformer_encoder_layer(t: _Tree, path: str, key: str, out,
                               attention_type: str = "regularMHA"):
    """torch_export.py:_transformer_encoder_layer, with RelPosMHAXL or
    hypermixing as `self_att`, and the 1-D CNN FFN (flax Conv (k, in,
    out) -> Conv1d (out, in, k)) where the tree has one."""
    _attention(attention_type)(t, f"{path}/self_att", f"{key}.self_att", out)
    if t.has(f"{path}/ffn/conv1"):
        for i, conv in ((0, "conv1"), (2, "conv2")):
            out[f"{key}.pos_ffn.{i}.conv.weight"] = (
                t.take(f"{path}/ffn/{conv}/kernel").transpose(2, 1, 0))
            out[f"{key}.pos_ffn.{i}.conv.bias"] = t.take(f"{path}/ffn/{conv}/bias")
    else:
        _ffn(t, f"{path}/ffn", f"{key}.pos_ffn", out)
    for i in (1, 2):
        _layer_norm(t, f"{path}/norm{i}", f"{key}.norm{i}.norm", out)


def _encoder_layer_mapper(cfg):
    """The mapper (t, path, key, out) of one layer of cfg's encoder."""
    att = cfg.attention_type
    mappers = {
        "conmamba": _encoder_layer,
        "conformer": lambda t, path, key, out: _conformer_layer(t, path, key, att, out),
        "branchformer": lambda t, path, key, out: _branchformer_layer(t, path, key, att, out),
        "transformer": lambda t, path, key, out: _transformer_encoder_layer(
            t, path, key, out, att),
    }
    if cfg.encoder_module not in mappers:
        raise ValueError(f"unknown encoder_module {cfg.encoder_module!r}")
    return mappers[cfg.encoder_module]


def _frontend(t: _Tree, path: str, key: str, num_blocks: int, out):
    for i in range(num_blocks):
        blk = f"{key}.convblock_{i}.convs"
        out[f"{blk}.conv_0.conv.weight"] = (
            t.take(f"{path}/conv{i}/kernel").transpose(3, 2, 0, 1)
        )
        out[f"{blk}.conv_0.conv.bias"] = t.take(f"{path}/conv{i}/bias")
        _layer_norm(t, f"{path}/norm{i}", f"{blk}.norm_0.norm", out)


def import_asr_params(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX ASRModel params (unrolled or scanned layout; numpy or JAX
    arrays) -> the port's ASRModel state dict for `cfg`."""
    if cfg.num_decoder_layers > 0 and cfg.decoder_module not in ("transformer", "mamba"):
        raise NotImplementedError(
            "params import covers the Transformer and Mamba decoders; the "
            "Conformer decoder comes with ROADMAP slice 3b item 5"
        )
    if "stack" in params.get("encoder", {}):
        params = _unroll_encoder(params, cfg.num_encoder_layers)
    t = _Tree(params)
    out: Dict[str, np.ndarray] = {}
    _frontend(t, "frontend", "0", len(cfg.frontend_channels), out)
    _linear(t, "src_proj", "1.custom_src_module.layers.0.w", out)
    layer = _encoder_layer_mapper(cfg)
    for i in range(cfg.num_encoder_layers):
        layer(t, f"encoder/layer_{i}", f"1.encoder.layers.{i}", out)
    _layer_norm(t, "encoder/norm", "1.encoder.norm.norm", out)
    if cfg.num_decoder_layers > 0:
        out["1.custom_tgt_module.layers.0.emb.Embedding.weight"] = t.take(
            "tgt_embed/embed/embedding")
        layer = _mamba_decoder_layer if cfg.decoder_module == "mamba" else _decoder_layer
        for i in range(cfg.num_decoder_layers):
            layer(t, f"decoder/layer_{i}", f"1.decoder.layers.{i}", out)
        _layer_norm(t, "decoder/norm", "1.decoder.norm.norm", out)
        _linear(t, "seq_head", "2.w", out)
        _linear(t, "ctc_head", "3.w", out)
    else:
        _linear(t, "ctc_head", "2.w", out)
    t.finish()
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def import_lm_params(params: Mapping[str, Any], num_layers: int = 12
                     ) -> Dict[str, torch.Tensor]:
    """JAX TransformerLM params -> the port's TransformerLM state dict, in
    SpeechBrain's flat names (torch_export.py:export_lm_params)."""
    t = _Tree(params)
    out: Dict[str, np.ndarray] = {
        "custom_src_module.emb.Embedding.weight": t.take("embed/embed/embedding")}
    for i in range(num_layers):
        _transformer_encoder_layer(t, f"encoder/layer_{i}", f"encoder.layers.{i}", out)
    _layer_norm(t, "encoder/norm", "encoder.norm.norm", out)
    _linear(t, "out", "output_proj.w", out)
    t.finish()
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


# Reference-checkpoint buffers that carry no weights (the JAX importer's
# ignore_substrings, torch_import.py:88).
NOT_WEIGHTS = (".pe", "positional_encoding")


def _state_dict(path_or_sd) -> Mapping[str, Any]:
    """A reference checkpoint's state dict: the object at a path (read
    with weights_only=True) or the mapping given, unwrapped from
    {"state_dict": ...} or {"model": ...} (JAX `torch_import.py:472-483`)."""
    obj = path_or_sd
    if isinstance(path_or_sd, (str, bytes)):
        obj = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if key in obj and isinstance(obj[key], Mapping):
            return obj[key]
    return obj


def load_torch_asr(path_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """A reference `model.ckpt` (path or state dict; bare or wrapped) ->
    the port's ASRModel state dict for `cfg`, float32, without the
    weightless position buffers. The port's modules carry the reference
    names, so no conversion is needed; the caller's
    `load_state_dict(strict=True)` refuses a key that does not fit (JAX
    `torch_import.py:442-469`)."""
    return {k: torch.as_tensor(v).float() for k, v in _state_dict(path_or_sd).items()
            if not any(s in k for s in NOT_WEIGHTS)}


def import_normalizer_stats(obj: Mapping[str, Any]):
    """A reference `normalizer.ckpt` (glob_mean, glob_std, count) -> the
    port's (count, mean, m2) with m2 = std^2 * count taken in float64, as
    the JAX package's restore does (`cli.py:160-167`)."""
    def arr(x):
        return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                          dtype=np.float32)

    mean, std = arr(obj["glob_mean"]), arr(obj["glob_std"])
    count = float(arr(obj.get("count", 0.0)).reshape(-1)[0])
    m2 = (std.astype(np.float64) ** 2 * count).astype(np.float32)
    return np.float32(count), mean, m2
