"""Logging, windowed metrics and a timer (counterpart of
disprcnn_tpu/utils/logging.py; reference utils/logger.py:7-30,
metric_logger.py:8-67, timer.py)."""
from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict, deque


def setup_logger(name: str, save_dir: str = "", rank: int = 0) -> logging.Logger:
    """The logger `name`, writing to stdout and, on rank 0 with a save_dir,
    to save_dir/log.txt. A later call with another save_dir (or none) moves
    the file handler there, so each run writes its own log.txt."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        f"%(asctime)s %(name)s rank{rank} %(levelname)s: %(message)s"
    )
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    path = os.path.abspath(os.path.join(save_dir, "log.txt")) if save_dir and rank == 0 else None
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        if h.baseFilename != path:
            logger.removeHandler(h)
            h.close()
    if path and not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Windowed median/avg of a scalar series (window 20)."""

    def __init__(self, window: int = 20):
        self.deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """SmoothedValues by name; str() gives each as "name: median (global
    average)"."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items()
        )


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.calls = 0
        self._start = None

    def tic(self):
        self._start = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._start
        self.total += dt
        self.calls += 1
        return dt

    @property
    def average_time(self) -> float:
        return self.total / max(self.calls, 1)
