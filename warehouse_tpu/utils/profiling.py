"""Tracing/profiling (SURVEY.md §5.1).

Capability parity with `ray timeline` + RLlib sampler_perf stats:
``trace()`` wraps ``jax.profiler`` (Perfetto/TensorBoard, XLA-op and
collective level), ``annotate()`` marks act/learn phases inside traces,
and ``StepsPerSecond`` is the host-side wall-clock throughput meter.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named range that shows up inside profiler traces."""
    return jax.profiler.TraceAnnotation(name)


class StepsPerSecond:
    """Wall-clock env-steps/s meter with exponential smoothing."""

    def __init__(self, alpha: float = 0.3) -> None:
        self._alpha = alpha
        self._t = None
        self.rate = 0.0

    def update(self, steps: int) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = steps / (now - self._t)
            self.rate = (
                inst if self.rate == 0.0
                else self._alpha * inst + (1 - self._alpha) * self.rate
            )
        self._t = now
        return self.rate

