"""The plain peak probe (mamba_asr_torch/ops/peak_probe.py) against a jnp
restatement of scripts/vpu_peak.py:52-63 (the kernel there is a closure of
`main()` and cannot be imported without editing the script), and the two
measurement tools run on the CPU at tiny sizes.

Tolerance 1e-6 relative: the same float32 operations in the same order in
both; the chains are contracting (x in (0.1, 0.9)), so rounding does not
grow along them.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from mamba_asr_torch.ops.peak_probe import MODES, peak_probe, peak_probe_ref
from mamba_asr_torch.tools import peak_probe as probe_tool
from mamba_asr_torch.tools import scan_variants as variants_tool

TOL = 1e-6

torch.set_num_threads(1)


def _x(seed=0, shape=(2, 64, 128)):
    return np.random.default_rng(seed).uniform(0.1, 0.9, size=shape).astype(np.float32)


def _jax_probe(x, k, independent):
    """scripts/vpu_peak.py:52-63, the kernel body on one block."""
    import jax.numpy as jnp

    x = jnp.asarray(x, jnp.float32)
    if independent:
        accs = [x * (1.0 + 0.125 * i) for i in range(4)]
        for _ in range(k // 4):
            for j in range(4):
                accs[j] = accs[j] * x + (0.25 + 0.125 * j)
        acc = accs[0] + accs[1] + accs[2] + accs[3]
    else:
        acc = x
        for _ in range(k):
            acc = acc * x + 0.5
    return np.asarray(acc)


@pytest.mark.parametrize("mode,k", [("dependent", 64), ("independent", 64),
                                    ("independent", 10), ("dependent", 0)])
def test_plain_probe_matches_the_jax_body(mode, k):
    x = _x(k)
    got = peak_probe_ref(torch.from_numpy(x), k, mode).numpy()
    np.testing.assert_allclose(got, _jax_probe(x, k, mode == "independent"), rtol=TOL, atol=0)


def test_plain_exp2_chain_is_bounded_and_matches_float64():
    """acc = exp2(acc x) / 2 stays in (0.5, 1) and follows the float64
    chain within 1e-6 relative."""
    x = _x(3)
    got = peak_probe_ref(torch.from_numpy(x), 64, "exp2").numpy()
    acc = x.astype(np.float64)
    for _ in range(64):
        acc = np.exp2(acc * x) * 0.5
    assert ((got > 0.5) & (got < 1.0)).all()
    np.testing.assert_allclose(got, acc, rtol=TOL, atol=0)


def test_probe_dispatch_on_cpu_and_its_modes():
    x = torch.from_numpy(_x(4, (3, 5)))
    for mode in MODES:
        assert torch.equal(peak_probe(x, 8, mode), peak_probe_ref(x, 8, mode))
    with pytest.raises(ValueError, match="unknown mode"):
        peak_probe(x, 8, "fma")


def test_peak_probe_tool_on_cpu(capsys):
    assert probe_tool.main(["--device", "cpu", "--b", "1", "--t", "3", "--d", "8",
                            "--k", "4", "--exp2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["mode"] == "exp2" and rec["k2"] == 64 and rec["card"] == "cpu"
    # A CPU run names its times cpu_ms and gives no device rates.
    assert "cpu_ms" in rec and "ms" not in rec and "attained_exp2_per_s" not in rec


def test_scan_variants_tool_on_cpu(capsys):
    """Base is timed first for the deltas; an unknown variant raises (the
    TPU script printed FAILED and went on)."""
    assert variants_tool.main(["--device", "cpu", "--b", "1", "--t", "33", "--d", "16",
                               "--n", "4", "--variants", "noy,base,fusedy"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["variant"] for r in recs] == ["base", "noy", "fusedy"]
    assert recs[0]["delta_cpu_ms"] == 0.0 and all(r["finite"] for r in recs)
    assert all(r["dtype"] == "bfloat16" for r in recs)
    assert recs[2]["kernel_of"] == "base" and "kernel_of" not in recs[1]
    bwd = variants_tool.run(["norevscan"], bwd=True, b=1, t=40, d=16, n=4, device="cpu")
    assert bwd[0]["pass"] == "bwd" and bwd[0]["shape"] == [1, 40, 16, 4]
    with pytest.raises(ValueError, match="unknown fwd variant"):
        variants_tool.run(["nogh"], b=1, t=8, d=8, n=4, device="cpu")
