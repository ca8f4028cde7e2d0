"""The PyTorch port's tracing utilities (mamba_asr_torch/utils/
profiling.py) against the JAX package's (mamba_asr_tpu/utils/
profiling.py), on the CPU.

- `profile_trace` writes a Chrome / Perfetto trace of the block that
  parses as JSON and holds the block's operators.
- `StepTimer` skips its warmup marks; its times, mean, percentiles and
  summary equal JAX's on the same marks (one fake clock feeds both).
- `rtfx` equals JAX's.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from mamba_asr_tpu.utils import profiling as jax_profiling

from mamba_asr_torch import utils
from mamba_asr_torch.models import layers
from mamba_asr_torch.utils import profiling

torch.set_num_threads(1)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(8, 16)
    lin = torch.nn.Linear(16, 4)
    with utils.profile_trace(str(tmp_path / "trace")):
        layers.dense(x, lin, torch.float32).sum()
    path = tmp_path / "trace" / profiling.TRACE_FILE
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("linear" in n or "addmm" in n for n in names), sorted(names)[:20]
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("warmup", [0, 2, 5])
def test_step_timer_and_rtfx_equal_jax(monkeypatch, warmup):
    ticks = [0.0, 0.5, 0.75, 1.5, 1.625, 2.0, 4.0, 4.25, 4.3, 5.0]

    def run(module):
        clock = iter(ticks)
        with monkeypatch.context() as m:  # the clock both modules read
            m.setattr(module.time, "perf_counter", lambda: next(clock))
            timer = module.StepTimer(warmup=warmup)
            timer.start()
            marks = [timer.mark() for _ in ticks[1:]]
        return (marks, list(timer.times), timer.summary(),
                [timer.percentile(p) for p in (0, 10, 50, 90, 99, 100)])

    got, want = run(profiling), run(jax_profiling)
    assert got == want
    assert len(got[1]) == len(ticks) - 1 - warmup
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary()
    for audio, wall in ((30.0, 0.25), (8.0, 0.0), (0.0, 1.0)):
        assert utils.rtfx(audio, wall) == jax_profiling.rtfx(audio, wall)
