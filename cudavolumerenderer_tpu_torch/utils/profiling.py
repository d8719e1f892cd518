"""Profiling and telemetry.

Port of cudavolumerenderer_tpu/utils/profiling.py (reference: the
RAYS_STATISTICS counter and clock() phase timing, Defines.h:49-50,
Main.cpp:64-119): a context-managed phase timer, runTest's trial
statistics, a JSON metric line, and torch.profiler trace capture where
the JAX package uses jax.profiler.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class PhaseTimer:
    """Wall-clock phase timing (the reference's startT/endT pairs)."""

    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}s" for k, v in self.phases.items())


@dataclass
class RenderStats:
    """Per-run statistics mirroring runTest's protocol (Main.cpp:46-121):
    discard-first-trial mean/std, paths/s, Mrays/s."""

    times: List[float] = field(default_factory=list)
    rays: List[float] = field(default_factory=list)

    def add_trial(self, elapsed: float, n_rays: float, first: bool):
        if not first:
            self.times.append(elapsed)
            self.rays.append(n_rays)

    def summary(self, n_paths: int) -> dict:
        if not self.times:
            return {}
        mean_t = float(np.mean(self.times))
        return {
            "mean_time_s": mean_t,
            "std_time_s": float(np.std(self.times)),
            "paths_per_sec": n_paths / mean_t,
            "mrays_per_sec": float(np.mean(self.rays)) / (mean_t * 1e6),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler capture of the CPU and (when present) CUDA
    activity, written to log_dir as a Chrome trace; no-op when log_dir
    is None."""
    if log_dir is None:
        yield
        return
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


def emit_json_line(metric: str, value: float, unit: str, baseline: float):
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(value, 3),
                "unit": unit,
                "vs_baseline": round(value / baseline, 3) if baseline else None,
            }
        )
    )
