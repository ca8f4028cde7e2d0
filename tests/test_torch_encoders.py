"""HyperMixing, the Branchformer and the Transformer ASR encoder of the
PyTorch port against the JAX package, on the CPU, at the tiny size of
tests/test_torch_conformer.py (d_model 16, 2 layers, kernel 7, CSGU 32
units, float32), with its seeded JAX params and inputs (row 1 padded).

- `HyperMixing` with a padding mask within 2e-5; it refuses an
  attn_mask, and a causal model with hypermixing is refused.
- The CSGU (SAME and causal, with linear_after_conv) with a padding mask
  within 2e-5; its near-identity init.
- The Branchformer's CTC log-probs (RelPosMHAXL from the scanned layout
  its YAML sets, regularMHA, hypermixing) within 2e-4.
- The Transformer encoder's CTC log-probs (regularMHA, hypermixing,
  RelPosMHAXL) within 2e-4. JAX's Transformer layer hands RelPosMHAXL the
  decode-cache keywords, which it does not take (a TypeError in JAX), so
  that case runs JAX with a RelPosMHAXL that drops them.
- The 1-D CNN FFN layer (SAME and causal) within 2e-5; layerdrop.
- `import_asr_params` equals `export_asr_params` for the Transformer.
- All 11 YAMLs: the port's parameter count equals JAX's (`jax.eval_shape`
  of the scanned layout, no compile; the count does not depend on the
  layout), and the YAMLs of this slice import and load strictly.
"""

from __future__ import annotations

import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.configs.loader import load_config as jax_load_config
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import attention as jax_att
from mamba_asr_tpu.models import branchformer as jax_bf
from mamba_asr_tpu.models import hypermixing as jax_hm
from mamba_asr_tpu.models import transformer as jax_tf
from mamba_asr_tpu.models.torch_export import export_asr_params

from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import asr, branchformer, hypermixing, transformer
from mamba_asr_torch.models import params_import as pi
from tests.test_param_counts import EXPECTED as PINNED
from tests.test_torch_conformer import (
    _close,
    _sub_state,
    jax_model,
    port_cfg,
    port_forward,
    port_model,
    seeded,
)

torch.set_num_threads(1)

D, H = 16, 2
REPO = pathlib.Path(__file__).resolve().parents[1]


class RelPosNoCache(jax_att.RelPosMHAXL):
    """JAX's RelPosMHAXL, taking and dropping the decode-cache keywords
    that JAX's TransformerEncoderLayer passes to every attention."""

    def __call__(self, query, key, value, attn_mask=None, key_padding_mask=None,
                 pos_embs=None, train=False, cache=None, cache_index=None, anc=None):
        return super().__call__(query, key, value, attn_mask, key_padding_mask,
                                pos_embs, train)


def _x(seed, b=2, t=10, d=D):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)


def _kpm(t=10, valid=(10, 7)):
    return np.arange(t)[None, :] >= np.array(valid)[:, None]


# -- HyperMixing ----------------------------------------------------------------------


def test_hypermixing_matches_jax():
    x, kpm = _x(1), _kpm()
    hm = jax_hm.HyperMixing(input_output_dim=D, hypernet_size=32, num_heads=H)
    params = seeded(hm, 2, *(jnp.asarray(x),) * 3)
    want, _ = hm.apply({"params": params}, *(jnp.asarray(x),) * 3,
                       key_padding_mask=jnp.asarray(kpm))
    port = hypermixing.HyperMixing(D, 32, H)
    port.load_state_dict(_sub_state(pi._hypermixing, params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), key_padding_mask=torch.from_numpy(kpm))
    _close(got.numpy(), np.asarray(want), 2e-5)
    with pytest.raises(ValueError, match="attn_mask"):
        port(torch.from_numpy(x), attn_mask=transformer.get_lookahead_mask(10))


@pytest.mark.parametrize("encoder", ["conformer", "branchformer", "transformer"])
def test_causal_hypermixing_is_refused(encoder):
    cfg = port_cfg(jax_asr.ASRConfig(encoder_module=encoder, attention_type="hypermixing",
                                     causal=True, d_model=D, nhead=H, num_encoder_layers=1))
    with pytest.raises(ValueError, match="causal"):
        asr.ASRModel(cfg)
    with pytest.raises(ValueError, match="causal"):
        transformer.TransformerEncoder(1, D, 24, H, attention_type="hypermixing", causal=True)


# -- the Branchformer ----------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_csgu_matches_jax(causal):
    """The gate half zeroed on padded rows before the conv; the conv taps
    drawn N(0, 1/K) here, not at their near-zero init."""
    x, kpm = _x(3, d=32), _kpm()
    csgu = jax_bf.ConvolutionalSpatialGatingUnit(units=32, kernel_size=7, causal=causal,
                                                 use_linear_after_conv=True,
                                                 gate_activation="gelu")
    params = seeded(csgu, 4, jnp.asarray(x), jnp.asarray(kpm))
    want = csgu.apply({"params": params}, jnp.asarray(x), jnp.asarray(kpm))
    port = branchformer.ConvolutionalSpatialGatingUnit(32, 7, causal, True, "gelu")
    port.load_state_dict(_sub_state(pi._csgu, params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(kpm))
    _close(got.numpy(), np.asarray(want), 2e-5)


def test_csgu_init_is_near_identity():
    pm = asr.init_params_(asr.ASRModel(port_cfg(jax_asr.ASRConfig(
        encoder_module="branchformer", d_model=D, nhead=H, num_encoder_layers=1,
        csgu_linear_units=32, use_linear_after_conv=True))), torch.Generator().manual_seed(0))
    csgu = pm.encoder.layers[0].cgmlp.csgu
    for lin in (csgu.conv, csgu.linear_after_conv):
        assert lin.weight.abs().max() < 1e-5 and (lin.bias == 1).all()
    # Streaming is ported (tests/test_torch_streaming.py holds it against
    # JAX): a chunk from a fresh state fills the window and the CSGU tail.
    y, state = pm.encoder.forward_chunk(torch.ones(2, 6, D), pm.init_streaming_state(2))
    assert tuple(y.shape) == (2, 6, D) and state[0]["mha_left_len"].tolist() == [6, 6]
    assert tuple(state[0]["csgu"].shape) == (2, csgu.padding_amount, 16)


@pytest.fixture(scope="module", params=["RelPosMHAXL", "regularMHA", "hypermixing"])
def branchformer_model(request):
    # The YAML's layout: scanned for RelPosMHAXL (hparams/CTC/branchformer_large.yaml).
    return jax_model(seed=5, encoder_module="branchformer", attention_type=request.param,
                     scan_layers=request.param == "RelPosMHAXL")


def test_branchformer_ctc_log_probs_match_jax(branchformer_model):
    jcfg, _, params, want = branchformer_model
    assert ("stack" in params["encoder"]) == jcfg.scan_layers
    out = port_forward(port_model(jcfg, params))
    _close(out["ctc_log_probs"].numpy(), want["ctc_log_probs"], 2e-4)


# -- the Transformer encoder ---------------------------------------------------------------------


@pytest.fixture(scope="module", params=["regularMHA", "hypermixing", "RelPosMHAXL"])
def transformer_model(request):
    with mock.patch.object(jax_tf, "RelPosMHAXL", RelPosNoCache):
        return jax_model(seed=6, encoder_module="transformer", attention_type=request.param)


def test_transformer_ctc_log_probs_match_jax(transformer_model):
    jcfg, _, params, want = transformer_model
    out = port_forward(port_model(jcfg, params))
    _close(out["ctc_log_probs"].numpy(), want["ctc_log_probs"], 2e-4)


@pytest.mark.parametrize("transformer_model", ["regularMHA"], indirect=True)
def test_transformer_import_equals_export(transformer_model):
    jcfg, _, params, _ = transformer_model
    ours = pi.import_asr_params(params, port_cfg(jcfg))
    theirs = export_asr_params(params, jcfg)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("causal", [False, True])
def test_cnn_ffn_layer_matches_jax(causal):
    """The pre-LN layer with `ffn_type: 1dcnn` (kernels 3 and 4: SAME pads
    (1, 1) and (1, 2); causal (2, 0) and (3, 0))."""
    x, kpm = _x(7), _kpm()
    layer = jax_tf.TransformerEncoderLayer(d_ffn=24, nhead=H, dropout=0.0,
                                           normalize_before=True, ffn_type="1dcnn",
                                           ffn_cnn_kernel_sizes=(3, 4), causal=causal)
    params = seeded(layer, 8, jnp.asarray(x), None, jnp.asarray(kpm))
    want, _ = layer.apply({"params": params}, jnp.asarray(x), None, jnp.asarray(kpm))
    port = transformer.TransformerEncoderLayer(D, 24, H, normalize_before=True,
                                               ffn_type="1dcnn", ffn_cnn_kernel_sizes=(3, 4),
                                               causal=causal)
    port.load_state_dict(_sub_state(pi._transformer_encoder_layer, params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, torch.from_numpy(kpm))
    _close(got.numpy(), np.asarray(want), 2e-5)


def test_layerdrop():
    """Train mode at layerdrop 1: every layer dropped, the output is the
    final LN of the input, as JAX's (eval mode runs every layer). At 0.5 a
    seeded generator decides: the output is the kept layers' composition."""
    x = _x(9)
    stack = jax_tf.TransformerEncoder(num_layers=3, d_ffn=24, nhead=H, dropout=0.0,
                                      layerdrop=1.0, normalize_before=True)
    params = seeded(stack, 10, jnp.asarray(x))
    want, _ = stack.apply({"params": params}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
    full, _ = stack.apply({"params": params}, jnp.asarray(x))
    port = transformer.TransformerEncoder(3, D, 24, H, normalize_before=True, layerdrop=1.0)
    state = {f"layers.{i}.{k}": v for i in range(3) for k, v in
             _sub_state(pi._transformer_encoder_layer, params[f"layer_{i}"]).items()}
    state.update({f"norm.norm.{k}": torch.tensor(np.asarray(params["norm"][n]))
                  for k, n in (("weight", "scale"), ("bias", "bias"))})
    port.load_state_dict(state, strict=True)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        _close(port.train()(tx).numpy(), np.asarray(want), 2e-5)
        _close(port.eval()(tx).numpy(), np.asarray(full), 2e-5)
        port.layerdrop = 0.5
        drops = (torch.rand(3, generator=torch.Generator().manual_seed(0)) < 0.5).tolist()
        assert 0 < sum(drops) < 3
        out = tx
        for layer, drop in zip(port.layers, drops):
            out = out if drop else layer(out)
        want_half = transformer.layer_norm(out, port.norm.norm, torch.float32)
        got = port.train()(tx, generator=torch.Generator().manual_seed(0))
        _close(got.numpy(), want_half.numpy(), 0.0)


# -- the 11 YAMLs ------------------------------------------------------------------------------


YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "hparams").rglob("*.yaml"))
NEW_YAMLS = ("CTC/conformer_large.yaml", "CTC/conformer_large_hypermixing.yaml",
             "CTC/branchformer_large.yaml", "S2S/conformer_small.yaml",
             "S2S/conformer_large.yaml")


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_param_count_matches_jax(path):
    """The port's ASRModel of each YAML (on the meta device: no memory)
    holds as many parameters as JAX's. JAX's count is
    tests/test_param_counts.py's pin where it has one (that test holds the
    pin to `jax.eval_shape`), else `jax.eval_shape` here. For this slice's
    YAMLs the import of JAX-shaped zeros is the port's state dict, key for
    key and shape for shape (S2S/conformer_large.yaml maps as
    S2S/conformer_small.yaml does, at 109 M parameters: counted only)."""
    assert len(YAMLS) == 11
    pinned = dict(PINNED)
    new = path.split("/", 1)[1] in NEW_YAMLS
    with torch.device("meta"):
        pm = asr.ASRModel(loader.load_config(str(REPO / path)).model)
    got = sum(p.numel() for p in pm.parameters())
    if path in pinned and not new:
        assert got == pinned[path]
        return
    jcfg = jax_load_config(str(REPO / path), {"model.scan_layers": True}).model
    model = jax_asr.ASRModel(jcfg)
    args = [jnp.zeros((1, 64, jcfg.n_mels)), jnp.array([64])]
    if jcfg.num_decoder_layers:
        args.append(jnp.zeros((1, 8), jnp.int32))
    shapes = jax.eval_shape(lambda *a: model.init(jax.random.PRNGKey(0), *a), *args)
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == pinned.get(path, want)
    if new and path != "hparams/S2S/conformer_large.yaml":
        zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                       shapes["params"])
        state = pi.import_asr_params(zeros, pm.cfg)
        assert {k: tuple(v.shape) for k, v in state.items()} == \
            {k: tuple(v.shape) for k, v in pm.state_dict().items()}
