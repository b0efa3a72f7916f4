"""Metrics/observability (SURVEY.md §5.5).

Capability parity with RLlib's result dicts + tune console/TensorBoard
event files: on-device accumulated scalars are fetched once per outer
chunk and written as JSONL (``metrics.jsonl``) and, when a TensorBoard
directory is given, as event files through flax's writer (an optional
dependency: flax + tensorflow).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Mapping

logger = logging.getLogger("warehouse_tpu")


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None,
                 tensorboard_dir: str | None = None) -> None:
        self._f = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from flax.metrics import tensorboard as _tb
            except ImportError as e:
                raise RuntimeError(
                    "--tensorboard-dir needs the optional packages flax "
                    f"and tensorflow, which are not importable: {e}"
                ) from e
            self._tb = _tb.SummaryWriter(tensorboard_dir)

    def log_meta(self, meta: Mapping) -> None:
        """One non-scalar metadata record (e.g. the devices the run is
        on) at run start — so metrics.jsonl says what produced the
        numbers."""
        rec = {"meta": True, "time": time.time()}
        rec.update(meta)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        logger.info("run meta: %s", json.dumps(meta))

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.scalar(k, float(v), step)
        logger.info(
            "step %d  %s", step,
            "  ".join(f"{k}={float(v):.4g}" for k, v in metrics.items()),
        )

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.flush()
