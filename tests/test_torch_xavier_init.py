"""`xavier_parity_init` in the PyTorch port (models/asr.py:xavier_reinit_)
against the law of the JAX package's `xavier_reinit`
(`training/trainer.py:565-588`), on the CPU, at the tiny size of
tests/test_torch_search_paths.py.

The port draws other bits than JAX, so the law is checked per JAX leaf:
each leaf of `jax.eval_shape`'s tree is filled with its index and
imported through `params_import`, which marks every element of the port's
tensors with the leaf it comes from (a stacked in_proj_weight's thirds,
a transposed conv's taps). After the re-draw, each leaf's elements have
the standard deviation (2 / (fan_in + fan_out)) ** 0.5 of its JAX shape
(fan_in all axes but the last, fan_out the last), within 6 standard
errors of a sample std; the draws pooled over all leaves within 6 of
theirs. Every 1-D tensor keeps its values, and no element of a 1-D leaf
is drawn. The Trainer applies it to fresh weights only: imported ones
stay as they were.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.models import asr as jax_asr

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import trainer
from tests.test_torch_s2s_ops import port_cfg
from tests.test_torch_search_paths import FEATS, FLENS, tiny_cfg

torch.set_num_threads(1)

CASES = {
    # The front end's Conv2d, src_proj, ConMamba (Mamba's conv, x/dt
    # projections, A_log, the conv module's pointwise and depthwise convs),
    # the Transformer decoder's stacked q/k/v, the embedding, the heads.
    "conmamba_transformer_dec": dict(decoder_module="transformer"),
    # RelPosMHAXL (no-bias q/k/v, linear_pos, pos_bias_u/v), the
    # Conformer decoder.
    "conformer_relpos_conformer_dec": dict(encoder_module="conformer",
                                           attention_type="RelPosMHAXL",
                                           decoder_module="conformer"),
    # The Branchformer's CSGU, HyperMixing's 3-D weights, the Mamba decoder.
    "branchformer_hypermixing_mamba_dec": dict(encoder_module="branchformer",
                                               attention_type="hypermixing",
                                               csgu_linear_units=64,
                                               decoder_module="mamba"),
}


def leaf_ids(jcfg):
    """(the JAX leaves' shapes by index, the port's state dict with every
    element holding the index of its JAX leaf)."""
    model = jax_asr.ASRModel(jcfg)
    toks = jnp.ones((2, 7), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(FEATS),
                            jnp.asarray(FLENS), toks)["params"]
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    ids = jax.tree_util.tree_unflatten(
        tree, [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])
    return [leaf.shape for leaf in leaves], pi.import_asr_params(ids, port_cfg(jcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_xavier_draws_each_jax_leaf_at_its_std(case):
    jcfg = tiny_cfg(**CASES[case], xavier_parity_init=True)
    shapes, ids = leaf_ids(jcfg)
    pm = asr.ASRModel(port_cfg(jcfg))
    pm.load_state_dict(ids, strict=True)
    asr.xavier_reinit_(pm, torch.Generator().manual_seed(0))
    drawn = {i: [] for i in range(len(shapes))}
    for name, p in pm.state_dict().items():
        if p.ndim <= 1:
            torch.testing.assert_close(p, ids[name], rtol=0, atol=0, msg=name)
            continue
        leaf = ids[name].flatten().long()
        for i in leaf.unique().tolist():
            drawn[i].append(p.flatten()[leaf == i])
    pooled = []
    for i, shape in enumerate(shapes):
        if len(shape) <= 1:
            assert not drawn[i], f"1-D leaf {i} {shape} was drawn"
            continue
        values = torch.cat(drawn[i]).double()
        assert values.numel() == np.prod(shape), (i, shape)
        want = (2.0 / (np.prod(shape[:-1]) + shape[-1])) ** 0.5
        n = values.numel()
        assert abs(values.std().item() / want - 1.0) < 6.0 / (2 * n) ** 0.5, (i, shape)
        pooled.append(values / want)
    pooled = torch.cat(pooled)
    assert abs(pooled.std().item() - 1.0) < 6.0 / (2 * pooled.numel()) ** 0.5
    assert abs(pooled.mean().item()) < 6.0 / pooled.numel() ** 0.5


def test_trainer_reinitialises_fresh_weights_only():
    jcfg = tiny_cfg(decoder_module="transformer")
    pcfg = port_cfg(jcfg)
    fe = FrontendConfig(n_fft=400, n_mels=20)
    train = trainer.TrainConfig(seed=3)
    plain = trainer.Trainer(pcfg, fe, train, device="cpu").model.state_dict()
    xcfg = dataclasses.replace(pcfg, xavier_parity_init=True)
    fresh = trainer.Trainer(xcfg, fe, train, device="cpu").model.state_dict()
    for name, p in plain.items():
        if p.ndim <= 1:
            assert torch.equal(fresh[name], p), name
        else:
            assert not torch.equal(fresh[name], p), name
    a_log = "1.encoder.layers.0.mamba.A_log"
    assert not torch.equal(fresh[a_log], plain[a_log])  # S4D's init overwritten
    imported = trainer.Trainer(xcfg, fe, train, state_dict=plain, device="cpu")
    for name, p in imported.model.state_dict().items():
        assert torch.equal(p, plain[name]), name
