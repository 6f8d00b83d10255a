"""Tracing and step timing (counterpart of disprcnn_tpu/utils/profiling.py;
the reference hand-timed with a wall-clock Timer and
torch.cuda.synchronize).

- ``trace(log_dir)`` records the block with ``torch.profiler`` (CPU and,
  on the card, CUDA activity) and writes a Chrome trace to
  log_dir/trace.json.
- ``StepTimer`` times a call up to the end of its device work: it
  synchronizes the device of the call's output before it reads the clock.
- ``device_memory_stats`` reports a card's memory in use, its peak and
  its total.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; -> the profiler (its ``key_averages()`` and
    ``trace_path``, the Chrome trace written when the block ends)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def _devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


class StepTimer:
    """Median latency of a call over a sliding window of calls, each timed
    to the end of the work its output waits on."""

    def __init__(self, window: int = 20):
        self.window = window
        self.samples: list[float] = []

    def timed(self, fn, *args, **kwargs):
        """-> (fn's output, seconds)."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in _devices(out, set()):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.samples = (self.samples + [dt])[-self.window:]
        return out, dt

    @property
    def median(self) -> float:
        s = sorted(self.samples)
        return s[len(s) // 2] if s else 0.0


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """A card's bytes in use, their peak since the last reset, and the
    card's total memory; {} for the CPU or without a card."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None and \
        torch.cuda.is_available() else device
    if device is None or torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}
