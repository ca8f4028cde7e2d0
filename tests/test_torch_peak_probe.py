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


DEVICE_FIELDS = ("bound_ms", "bound_by", "bound_share", "held_clock_mhz", "geometry",
                 "fraction_of_published", "fraction_of_held_peak", "whole_k2")


@pytest.mark.parametrize("mode,ms,by", [("dependent", 0.016528, "bytes"),
                                        ("independent", 0.016528, "bytes"),
                                        ("exp2", 0.105926, "operations")])
def test_probe_bound_at_the_tools_shape(mode, ms, by):
    """B32 x 751 x 288 fp32 at k 64: 55.4 MB at 3.35 TB/s bounds both FMA
    modes (0.886 GFLOP take 0.0132 ms at 67 TFLOP/s); 443 M exp2 on 132
    SMs x 16 per clock at 1.98 GHz bound the exp2 mode."""
    got_ms, got_by = probe_tool.probe_bound_ms(32 * 751 * 288, 64, mode, 1.98e9, 132)
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-4)


def test_peak_probe_cpu_record_has_no_device_fields():
    (rec,) = probe_tool.run(("independent",), k=4, b=1, t=3, d=5, device="cpu")
    assert rec["cpu_ms"] >= 0 and rec["finite"]
    assert not set(DEVICE_FIELDS) & set(rec)


@pytest.mark.parametrize("mode", MODES)
def test_plain_probe_on_ragged_and_offset_views(mode):
    """7,474 elements, and the same values as a view one element into its
    storage: the plain loop gives the jnp restatement's values (the exp2
    chain float64's) on both."""
    whole = torch.from_numpy(_x(8, (2 * 37 * 101 + 1,)))
    view = whole[1:]
    assert view.storage_offset() == 1 and view.is_contiguous()
    xs = view.numpy().copy()
    if mode == "exp2":
        want = xs.astype(np.float64)
        for _ in range(70):
            want = np.exp2(want * xs) * 0.5
    else:
        want = _jax_probe(xs, 70, mode == "independent")
    for x in (view, view.clone()):
        np.testing.assert_allclose(peak_probe(x, 70, mode).numpy(), want, rtol=TOL, atol=0)


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_117peak_probe_kernelILi0ELb0EEEvPKfPfxiixPx
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                                /* 0x000fe40000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R4, 0x40, PT ;
        /*0020*/                   FFMA R5, R5, R2, 0.5 ;     /* 0x3f00000005057423 */
                                                                /* 0x000fc80000000002 */
        /*0030*/                   FFMA R8, R8, R14, 0.5 ;    /* 0x3f00000005057423 */
                                                                /* 0x000fd00000000002 */
        /*0040*/                   IADD3 R4, R4, -0x40, RZ ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   FFMA R5, R5, R2, 0.5 ;
        /*0070*/               @P1 BRA 0x60 ;
        /*0080*/                   BRA 0x10 ;
\t\tFunction : _ZN12_GLOBAL__N_117peak_probe_kernelILi2ELb1EEEvPKfPfxiixPx
.L_x_1:
        /*0010*/                   FMUL R3, R5, R2 ;
        /*0020*/                   MUFU.EX2 R4, R3 ;
        /*0030*/                   FMUL R5, R4, 0.5 ;
        /*0040*/              @!P0 BRA `(.L_x_1) ;
"""


def test_sass_loops_finds_each_kernels_chain_loop():
    """The innermost loop with the most FFMAs (MUFUs for exp2), branch
    targets as addresses or as labels; the outer loop is not taken."""
    dep, ex = probe_tool.sass_loops(SASS)
    assert (dep["mode"], dep["timed"], dep["steps"], dep["instructions"]) == (
        "dependent", False, 2, 4)
    assert dep["opcodes"] == {"FFMA": 2, "IADD3": 1, "BRA": 1}
    assert dep["other_per_step"] == 1.0
    assert dep["bank_conflicts"] == 1  # R8 and R14 both even; R5 and R2 not
    assert probe_tool._bank_conflict("FFMA R8, R14, R8, 0.5")
    assert not probe_tool._bank_conflict("FFMA R8, R14.reuse, R8, 0.5")
    assert not probe_tool._bank_conflict("FFMA R10, R7, R10, 0.5")
    assert (ex["mode"], ex["timed"], ex["steps"], ex["opcodes"]["FMUL"]) == ("exp2", True, 1, 2)
    assert ex["other_per_step"] == 1.0 and ex["bank_conflicts"] == 0


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
