"""Profiling / tracing hooks.

Port of ``omr_a2s_multimodal_transformer_tpu/utils/profiling.py``:
- ``trace(path)``: context manager around ``torch.profiler`` (host and, on
  a GPU, device activity) that writes a chrome trace to ``path`` — the
  counterpart of the JAX package's ``jax.profiler`` trace.
- ``StepTimer``: lightweight wall-clock accounting per named phase with an
  EMA, logged through the MetricsLogger. It times the host: a phase that
  launches device work measures its dispatch unless the device pushes back.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(path: str) -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


class StepTimer:
    """Per-phase wall-clock EMA (e.g. data / step / eval)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ema: Dict[str, float] = {}
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            prev = self.ema.get(name)
            self.ema[name] = dt if prev is None else self.decay * prev + (1 - self.decay) * dt

    def summary(self) -> Dict[str, float]:
        out = {}
        for name, total in self.totals.items():
            out[f"time_{name}_total_s"] = round(total, 4)
            out[f"time_{name}_ema_s"] = round(self.ema[name], 5)
        return out
