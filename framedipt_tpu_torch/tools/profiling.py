"""Profiling hooks: a torch.profiler trace and a step-rate timer.

``with trace("/tmp/trace"): ...`` records the host's operators, and the
card's kernels when CUDA is present, and writes a Chrome trace JSON
(viewable in Perfetto or chrome://tracing) into the directory.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import time

import torch

from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path):
    """torch.profiler over the block; on exit the Chrome trace is written
    to ``log_dir/trace_<pid>_<ns>.json`` and its path logged. Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    logger.info(f"profiler trace written to {path}")


def _on_cuda(result) -> bool:
    """Whether any tensor in ``result`` (nested lists, tuples, dicts) lies on
    a CUDA device."""
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_cuda(v) for v in result.values())
    if isinstance(result, list | tuple):
        return any(_on_cuda(v) for v in result)
    return False


class StepTimer:
    """Steps a second over a sliding window; ``step(result)`` first waits for
    the card when a tensor of ``result`` is on it."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []

    def step(self, result=None) -> float | None:
        if result is not None and _on_cuda(result):
            torch.cuda.synchronize()
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else None
