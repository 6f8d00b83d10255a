"""Logging and a timer (counterpart of disprcnn_tpu/utils/logging.py's
setup_logger and Timer; reference utils/logger.py:7-30, timer.py)."""
from __future__ import annotations

import logging
import os
import sys
import time


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
