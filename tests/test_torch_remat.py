"""`model.remat_layers` in the PyTorch port: each encoder layer of the
ConMamba, Conformer and Branchformer stacks recomputed in the backward
(`models/layers.py:run_layer`) changes memory, not math.

- One Trainer micro-step (tiny: d_model 16, 2 layers, dropout 0.1,
  SpecAugment on) with remat equals the step without, bit for bit in
  float32 on the CPU: losses and every gradient. The recompute redraws
  the forward's dropout masks (preserve_rng_state).
- The gradients of the summed CTC log-probs against the JAX package's
  ASRModel with `scan_layers` and `remat_layers` (JAX's
  tests/test_models.py:273-300) within 3e-4 of each gradient's largest
  value, for all three encoders; JAX params from `jax.eval_shape` and a
  numpy seed, through `models/params_import.py`.

The port acts on remat_layers alone, where JAX needs scan_layers too
(ROADMAP Queue 3). Sequence parallelism with remat is held against sp
alone in tests/test_torch_pipeline.py (its ranks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import mamba as jax_mamba

from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import trainer
from tests.test_torch_conformer import FEATS, FLENS, jax_cfg, port_cfg, seeded

torch.set_num_threads(1)

GRAD_TOL = 3e-4
ENCODERS = ("conmamba", "conformer", "branchformer")
TINY = {"model.d_model": 16, "model.nhead": 2, "model.num_encoder_layers": 2,
        "model.d_ffn": 16, "model.csgu_linear_units": 32, "model.compute_dtype": "float32",
        "model.mamba.d_state": 4, "frontend.n_mels": 20, "model.n_mels": 20,
        "model.dropout": 0.1, "train.grad_accumulation_factor": 2}
YAMLS = {"conmamba": "hparams/CTC/conmamba_small.yaml",
         "conformer": "hparams/CTC/conformer_large.yaml",
         "branchformer": "hparams/CTC/branchformer_large.yaml"}


def _batch():
    rng = np.random.default_rng(0)
    return {"wav": rng.normal(0, 0.1, (2, 16000)).astype(np.float32),
            "wav_lens": np.array([16000, 12000], np.int32),
            "tokens": rng.integers(1, 30, (2, 8)).astype(np.int32),
            "token_lens": np.array([8, 6], np.int32), "weight": np.ones(2, np.float32)}


@pytest.mark.parametrize("encoder", ENCODERS)
def test_remat_step_equals_the_plain_step_bit_for_bit(encoder):
    runs = []
    for remat in (False, True):
        exp = loader.load_config(YAMLS[encoder], {**TINY, "model.remat_layers": remat})
        assert exp.model.remat_layers is remat and exp.specaug.enabled
        tr = trainer.Trainer(exp.model, exp.frontend, exp.train, exp.specaug, device="cpu")
        assert tr.model.encoder.remat is remat
        m = tr.train_step(_batch())
        assert not bool(m["updated"])  # the gradients are still in .grad
        runs.append((m, {n: p.grad for n, p in tr.model.named_parameters()}))
    (m0, g0), (m1, g1) = runs
    for k in ("loss", "loss_ctc", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def _jax_remat_cfg(encoder):
    extra = {"mamba": jax_mamba.MambaConfig(d_state=4, scan_impl="xla")} \
        if encoder == "conmamba" else {}
    return jax_cfg(encoder_module=encoder, scan_layers=True, remat_layers=True, **extra)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_remat_gradients_match_jax(encoder):
    jcfg = _jax_remat_cfg(encoder)
    model = jax_asr.ASRModel(jcfg)
    feats, flens = jnp.asarray(FEATS), jnp.asarray(FLENS)
    params = seeded(model, 3, feats, flens)
    assert "stack" in params["encoder"]  # the scanned, rematerialised layout

    def loss(p):
        return model.apply({"params": p}, feats, flens)["ctc_log_probs"].sum()

    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))
    pm = asr.ASRModel(port_cfg(jcfg))
    assert pm.cfg.remat_layers and pm.encoder.remat
    pm.load_state_dict(pi.import_asr_params(jax.tree_util.tree_map(np.asarray, params),
                                            pm.cfg), strict=True)
    pm.train()  # remat acts in train mode; dropout is 0
    out = pm(torch.from_numpy(FEATS), torch.from_numpy(FLENS))
    out["ctc_log_probs"].sum().backward()
    want = pi.import_asr_params(grads, pm.cfg)
    for name, p in pm.named_parameters():
        ref = np.asarray(want[name], np.float64)
        atol = GRAD_TOL * max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(p.grad.double().numpy(), ref, rtol=GRAD_TOL, atol=atol,
                                   err_msg=name)
