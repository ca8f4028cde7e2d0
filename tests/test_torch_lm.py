"""The TransformerLM of the PyTorch port against the JAX package, on the
CPU, at a tiny size (vocab 11, d_model 16, nhead 2, 2 layers, d_ffn 32).
JAX params are drawn from a seed (`seeded_params`: no bias or LayerNorm
at its init value) and reach the port through
`models.params_import.import_lm_params`.

- `TransformerEncoderLayer` and `TransformerEncoder`, pre- and post-LN,
  with a look-ahead and a key padding mask: float32 within 2e-5; bf16
  within 2e-2 of the output's largest value, and as close to the float32
  result as JAX's bf16 (give or take 2e-2 of it).
- `TransformerLM.forward` logits (eval, and train mode at dropout 0 with
  the pad-0 mask) within 2e-5; causality: a later token changes no
  earlier logits.
- Stepped logits through the ancestor table (identity and shuffled
  tables) against JAX's stepped LM with `anc` (beam_gather=True), and
  with the identity table against the port's own full pass: 1e-4.
- `import_lm_params` equals `export_lm_params` key by key; a strict load.
- `load_lm` reads a `.pt` that JAX's `save_torch_lm` wrote (bare and
  wrapped) and gives JAX's logits; it refuses a msgpack path, and returns
  None without a path.
- `init_params_` draws flax's init distributions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mamba_asr_tpu.models import lm as jax_lm
from mamba_asr_tpu.models import transformer as jax_tf
from mamba_asr_tpu.models.torch_export import export_lm_params, save_torch_lm

from mamba_asr_torch.configs.loader import DecodeConfig
from mamba_asr_torch.models import lm as port_lm
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.models import transformer as port_tf
from tests.test_torch_models import _sub_state

torch.set_num_threads(1)

VOCAB, D, H, LAYERS, FFN = 11, 16, 2, 2, 32
LM_DECODE = DecodeConfig(lm_d_model=D, lm_nhead=H, lm_layers=LAYERS, lm_d_ffn=FFN,
                         lm_dtype="float32")


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


def seeded_params(module, seed, *args):
    """A flax module's params tree (its shapes from `jax.eval_shape`, no
    compile) filled from numpy's default_rng(seed): kernels N(0, 1/fan_in),
    embeddings N(0, 1), biases N(0, 0.05^2), LayerNorm scales 1 + N(0,
    0.05^2), so that no bias or LayerNorm sits at its init value."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def fill(path, leaf):
        name, x = path[-1].key, rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.float32(np.sqrt(leaf.shape[0]))
        if name == "embedding":
            return x
        return np.float32(name == "scale") + np.float32(0.05) * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_lm_params(seed=0, vocab=VOCAB, layers=LAYERS, normalize_before=False):
    """(JAX TransformerLM, seeded params)."""
    model = jax_lm.TransformerLM(vocab_size=vocab, d_model=D, nhead=H, num_layers=layers,
                                 d_ffn=FFN, normalize_before=normalize_before)
    return model, seeded_params(model, seed, jnp.ones((1, 4), jnp.int32))


def port_of(params, vocab=VOCAB, layers=LAYERS, dtype=torch.float32, normalize_before=False):
    lm = port_lm.TransformerLM(vocab, D, H, layers, FFN, normalize_before=normalize_before,
                               dtype=dtype)
    lm.load_state_dict(pi.import_lm_params(params, layers), strict=True)
    return lm.eval()


@pytest.fixture(scope="module")
def tiny():
    model, params = jax_lm_params()
    return model, params, port_of(params)


def _tokens(seed, b=3, s=7):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, s)).astype(np.int32)


# -- the encoder stack --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize_before", [True, False])
def test_encoder_layer_and_stack_match_jax(normalize_before, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, D)).astype(np.float32)
    mask = np.triu(np.ones((6, 6), bool), 1)
    kpm = np.zeros((2, 6), bool)
    kpm[1, 4:] = True
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    gelu = lambda v: fnn.gelu(v, approximate=False)  # noqa: E731
    stack = jax_tf.TransformerEncoder(num_layers=2, d_ffn=FFN, nhead=H, dropout=0.0,
                                      activation=gelu, normalize_before=normalize_before,
                                      dtype=jdt)
    params = seeded_params(stack, 3, jnp.asarray(x))
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    masks = (jnp.asarray(mask), jnp.asarray(kpm)), (torch.from_numpy(mask),
                                                    torch.from_numpy(kpm))

    def check(got, want, want32, what):
        """float32: 2e-5. bf16: 2e-2 of the output's largest value (an
        element near 0 after a LayerNorm carries the rounding of the larger
        ones), and no further from the float32 result than JAX's bf16 is,
        give or take 2e-2."""
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            _close(got, want, 2e-5, what)
            return
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-2 * scale, what
        assert (np.abs(got - want32).max()
                <= np.abs(want - want32).max() + 2e-2 * scale), what

    layer = jax_tf.TransformerEncoderLayer(d_ffn=FFN, nhead=H, dropout=0.0, activation=gelu,
                                           normalize_before=normalize_before, dtype=jdt)
    lp = params["layer_1"]
    want, _ = layer.apply({"params": lp}, jx, *masks[0])
    want32, _ = layer.clone(dtype=jnp.float32).apply({"params": lp}, jx.astype(jnp.float32),
                                                     *masks[0])
    port_layer = port_tf.TransformerEncoderLayer(D, FFN, H, port_lm._gelu_exact,
                                                 normalize_before, tdt)
    port_layer.load_state_dict(_sub_state(pi._transformer_encoder_layer, lp), strict=True)
    got = port_layer(tx, *masks[1])
    assert got.dtype == tdt
    check(got, want, np.asarray(want32), "layer")

    want, _ = stack.apply({"params": params}, jx, *masks[0])
    want32, _ = stack.clone(dtype=jnp.float32).apply({"params": params},
                                                     jx.astype(jnp.float32), *masks[0])
    port_stack = port_tf.TransformerEncoder(2, D, FFN, H, port_lm._gelu_exact,
                                            normalize_before, tdt)
    state = {f"layers.{i}.{k}": v for i in range(2) for k, v in
             _sub_state(pi._transformer_encoder_layer, params[f"layer_{i}"]).items()}
    state.update({f"norm.norm.{k}": torch.from_numpy(np.asarray(v)) for k, v in
                  (("weight", params["norm"]["scale"]), ("bias", params["norm"]["bias"]))})
    port_stack.load_state_dict(state, strict=True)
    check(port_stack(tx, *masks[1]), want, np.asarray(want32), "stack")


def test_encoder_refuses_what_is_not_ported():
    """Layerdrop, RelPosMHAXL, hypermixing and the 1-D CNN FFN build (they
    are held against JAX in tests/test_torch_encoders.py); an unknown
    attention or FFN type, and hypermixing in a causal stack, raise."""
    for kw in (dict(layerdrop=0.1), dict(attention_type="RelPosMHAXL"),
               dict(attention_type="hypermixing"), dict(ffn_type="1dcnn")):
        port_tf.TransformerEncoder(1, D, FFN, H, **kw)
    for kw, match in ((dict(attention_type="RelPosMHA"), "attention_type"),
                      (dict(ffn_type="2dcnn"), "ffn_type"),
                      (dict(attention_type="hypermixing", causal=True), "causal")):
        with pytest.raises(ValueError, match=match):
            port_tf.TransformerEncoder(1, D, FFN, H, **kw)


# -- the LM ----------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_lm_full_pass_matches_jax(tiny, train):
    """Eval, and train mode at dropout 0 with pad-0 tokens (the key padding
    mask applies in train mode only, in both packages)."""
    model, params, lm = tiny
    toks = _tokens(2)
    toks[1, 5:] = 0
    want = model.apply({"params": params}, jnp.asarray(toks), train=train)
    lm.train(train)
    got = lm(torch.from_numpy(toks).long())
    lm.eval()
    assert got.dtype == torch.float32 and got.shape == (3, 7, VOCAB)
    _close(got.numpy(), want, 2e-5)


def test_lm_is_causal(tiny):
    _, _, lm = tiny
    toks = torch.from_numpy(_tokens(3)).long()
    base = lm(toks)
    changed = toks.clone()
    changed[:, 4] = (changed[:, 4] % (VOCAB - 1)) + 1
    got = lm(changed)
    torch.testing.assert_close(got[:, :4], base[:, :4], rtol=0, atol=0)
    assert not torch.allclose(got[:, 4:], base[:, 4:])


@pytest.mark.parametrize("table", ["identity", "shuffled"])
def test_lm_steps_through_the_ancestor_table(tiny, table):
    """6 steps of N 6 (B2 x beam 3) at a cache of 8 rows: after each step
    the table's columns follow a reorder within each utterance's beam (the
    identity, or drawn), as the search moves them."""
    model, params, lm = tiny
    rng = np.random.default_rng(4)
    n, s_cache, beam = 6, 8, 3
    jcache = model.init_cache(n, s_cache, beam_gather=True)
    pcache = lm.init_cache(n, s_cache)
    janc = np.tile(np.arange(n, dtype=np.int32), (s_cache, 1))
    step = jax.jit(lambda p, t, s, c, a: model.apply({"params": p}, t, cache=c,
                                                     cache_index=s, anc=a))
    toks = _tokens(5, b=n, s=6)
    steps = []
    for s in range(6):
        janc[s] = np.arange(n)
        want, jcache = step(params, jnp.asarray(toks[:, s]), jnp.int32(s), jcache,
                            jnp.asarray(janc))
        got = lm.step(torch.from_numpy(toks[:, s]).long(), s, pcache,
                      torch.from_numpy(janc.copy()))
        assert got.dtype == torch.float32 and got.shape == (n, VOCAB)
        _close(got.numpy(), want, 1e-4, f"step {s}")
        steps.append(got)
        if table == "shuffled":
            reorder = rng.integers(0, beam, n) + np.repeat(np.arange(2) * beam, beam)
            janc = np.ascontiguousarray(janc[:, reorder])
            toks = toks[reorder]
    if table == "identity":
        full = lm(torch.from_numpy(toks).long())
        _close(torch.stack(steps, 1).numpy(), full.numpy(), 1e-4, "steps vs full pass")


def test_import_lm_params_equals_export_key_by_key(tiny):
    _, params, _ = tiny
    ours = pi.import_lm_params(params, LAYERS)
    theirs = export_lm_params(params, LAYERS)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    lm = port_lm.TransformerLM(VOCAB, D, H, LAYERS, FFN)
    assert set(lm.state_dict()) == set(ours)
    lm.load_state_dict(ours, strict=True)
    with pytest.raises(ValueError, match="no place"):
        pi.import_lm_params(params, LAYERS - 1)


def test_load_lm_reads_a_jax_saved_pt(tiny, tmp_path):
    """save_torch_lm's file, bare and wrapped as {"model": ...} beside a
    positional-encoding buffer: load_lm gives JAX's logits; a msgpack path
    raises; no path gives None."""
    model, params, _ = tiny
    bare = str(tmp_path / "lm.pt")
    save_torch_lm(params, bare, num_layers=LAYERS)
    wrapped = str(tmp_path / "lm.ckpt")
    sd = torch.load(bare, weights_only=True)
    torch.save({"model": {**sd, "positional_encoding.pe": torch.zeros(1, 9, D)}}, wrapped)
    toks = _tokens(6)
    want = model.apply({"params": params}, jnp.asarray(toks))
    for path in (bare, wrapped):
        lm = port_lm.load_lm(dataclasses.replace(LM_DECODE, lm_path=path), VOCAB, "cpu")
        assert not lm.training and lm.dtype == torch.float32
        _close(lm(torch.from_numpy(toks).long()).numpy(), want, 2e-5, path)
    bf16 = port_lm.load_lm(dataclasses.replace(LM_DECODE, lm_path=bare, lm_dtype="bfloat16"),
                           VOCAB, "cpu")
    assert bf16.dtype == torch.bfloat16 and bf16.output_proj.w.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="save_torch_lm"):
        port_lm.load_lm(dataclasses.replace(LM_DECODE, lm_path="lm.msgpack"), VOCAB, "cpu")
    assert port_lm.load_lm(LM_DECODE, VOCAB, "cpu") is None


def test_cast_lm_weights_keeps_the_head_in_float32(tiny):
    _, params, _ = tiny
    lm16 = port_of(params, dtype=torch.bfloat16)
    cast = port_lm.cast_lm_weights(lm16)
    assert cast is not lm16 and port_lm.cast_lm_weights(cast) is cast
    assert all(p.dtype == torch.bfloat16 for p in cast.encoder.parameters())
    assert cast.custom_src_module.weight.dtype == torch.bfloat16
    assert cast.output_proj is lm16.output_proj
    assert all(p.dtype == torch.float32 for p in lm16.parameters())
    # The copy computes what the model does on bf16-rounded weights (its
    # LayerNorms too, as JAX's cast_tree rounds them).
    rounded = port_of(jax.tree_util.tree_map(
        lambda p: np.asarray(jnp.asarray(p).astype(jnp.bfloat16).astype(jnp.float32)), params),
        dtype=torch.bfloat16)
    rounded.output_proj = lm16.output_proj
    toks = torch.from_numpy(_tokens(7)).long()
    torch.testing.assert_close(cast(toks), rounded(toks), rtol=0, atol=0)
    fp32 = port_of(params)
    assert port_lm.cast_lm_weights(fp32) is fp32


def test_seeded_init_follows_flax():
    lm = port_lm.init_params_(port_lm.TransformerLM(VOCAB, 64, 4, 1, 128),
                              torch.Generator().manual_seed(0))
    sd = lm.state_dict()
    assert torch.equal(sd["encoder.norm.norm.weight"], torch.ones(64))
    assert not sd["output_proj.w.bias"].any()
    assert not sd["encoder.layers.0.self_att.att.in_proj_bias"].any()
    emb = sd["custom_src_module.emb.Embedding.weight"]
    assert 0.8 < float(emb.std()) < 1.2
    w = sd["encoder.layers.0.pos_ffn.ffn.0.weight"]  # fan_in 64
    assert 0.8 < float(w.std()) * 8 < 1.2 and float(w.abs().max()) <= 2 / 8 / 0.8796 + 1e-6
