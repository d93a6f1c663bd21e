"""Profiling and throughput utilities.

Counterpart of `megatts2_hierspeechpp_tpu/utils/profiling.py`:

  - `trace(log_dir)`: a torch.profiler window over the CPU and, where there
    is one, the card, written as a Chrome trace (`trace.json`, viewable in
    chrome://tracing or Perfetto) into log_dir; the profiler object is
    yielded for `key_averages()`;
  - `annotate(name)`: a named span in that trace (torch.profiler.record_function);
  - `Throughput`: audio-seconds / s and tokens / s counters for serving
    and training loops; the per-card rate over the job's cards, one per
    rank (`parallel/mesh.world()`; JAX divides by its device count).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from megatts2_hierspeechpp_torch.parallel import mesh

annotate = record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on leaving it, write `<log_dir>/trace.json`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class Throughput:
    """Streaming counters reported per wall second since construction:
    audio-seconds, tokens and steps, and the audio rate per card of the
    job."""

    started: float = field(default_factory=time.perf_counter)
    audio_seconds: float = 0.0
    tokens: int = 0
    steps: int = 0

    def add(self, audio_seconds: float = 0.0, tokens: int = 0) -> None:
        self.audio_seconds += audio_seconds
        self.tokens += tokens
        self.steps += 1

    def report(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.started, 1e-9)
        return {
            "wall_seconds": dt,
            "audio_seconds_per_sec": self.audio_seconds / dt,
            "audio_seconds_per_sec_per_chip":
                self.audio_seconds / dt / mesh.world(),
            "tokens_per_sec": self.tokens / dt,
            "steps_per_sec": self.steps / dt,
        }
