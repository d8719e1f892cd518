"""The port's profiling helpers (utils/profiling.py) against the JAX
package's: the phase timer, runTest's trial statistics and the JSON
metric line; trace() writes a torch.profiler trace where JAX writes a
jax.profiler one."""

import os

import pytest
import torch

from cudavolumerenderer_tpu.utils import profiling as jprof
from cudavolumerenderer_tpu_torch.utils import profiling as tprof


def test_phase_timer_accumulates():
    timer = tprof.PhaseTimer()
    for _ in range(2):
        with timer.phase("load"):
            pass
    with pytest.raises(ValueError):
        with timer.phase("render"):
            raise ValueError("the phase is timed all the same")
    assert set(timer.phases) == {"load", "render"}
    assert all(v >= 0.0 for v in timer.phases.values())
    assert timer.report().startswith("load: ") and " | render: " in timer.report()


@pytest.mark.parametrize("trials", [[(1.0, 5e6, True)],
                                    [(9.0, 1e6, True), (2.0, 4e6, False),
                                     (4.0, 6e6, False)]])
def test_render_stats_equal_jax(trials):
    ours, theirs = tprof.RenderStats(), jprof.RenderStats()
    for elapsed, rays, first in trials:
        ours.add_trial(elapsed, rays, first)
        theirs.add_trial(elapsed, rays, first)
    assert ours.times == theirs.times and ours.rays == theirs.rays
    assert ours.summary(1000) == theirs.summary(1000)


def test_emit_json_line_equals_jax(capsys):
    for baseline in (11.4, 0.0):
        tprof.emit_json_line("mrays_per_sec", 3.14159, "Mrays/s", baseline)
        ours = capsys.readouterr().out
        jprof.emit_json_line("mrays_per_sec", 3.14159, "Mrays/s", baseline)
        assert ours == capsys.readouterr().out


def test_trace_writes_a_profile(tmp_path):
    with tprof.trace(None):
        pass
    with tprof.trace(str(tmp_path)):
        torch.ones(8).cumsum(0)
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))
