"""Per-step timing and device traces.

StepTimer is the JAX package's (``versecrafter_tpu.utils.profiling``):
wall time between consecutive denoise steps, summarised for the model
server's /metrics. device_trace records a torch.profiler trace of the CPU
and, where there is one, the CUDA device, exported as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@contextlib.contextmanager
def device_trace(out_dir: str):
    """torch.profiler trace of the block, written to
    <out_dir>/trace.json (view in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


@dataclass
class StepTimer:
    """Track per-step latency; hand `timer.tick` to pipeline(progress=...)."""

    steps_ms: List[float] = field(default_factory=list)
    _last: Optional[float] = None

    def tick(self, i: int, n: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.steps_ms.append((now - self._last) * 1e3)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.steps_ms:
            return {"steps": 0}
        xs = sorted(self.steps_ms)
        return {
            "steps": len(xs),
            "mean_ms": sum(xs) / len(xs),
            "p50_ms": xs[len(xs) // 2],
            "p90_ms": xs[int(len(xs) * 0.9)],
            "min_ms": xs[0],
            "max_ms": xs[-1],
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"steps_ms": self.steps_ms, **self.summary()}, f)
