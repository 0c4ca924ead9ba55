"""Structured metric logging, a copy of ``bin_tpu/utils/logging.py``.

JSONL is the primary sink (one record per log step); stdout gets a compact
human line.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None,
                 stream: IO | None = sys.stdout):
        """``stream=None`` with no jsonl_path is a disabled logger."""
        self._stream = stream
        self._file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)
        self._t0 = time.monotonic()

    def log(self, step: int, **metrics: Any) -> None:
        if self._file is None and self._stream is None:
            return
        record = {"step": step, "wall_s": round(time.monotonic() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        if self._file:
            self._file.write(json.dumps(record) + "\n")
        if self._stream is not None:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items() if k != "step")
            self._stream.write(f"[step {step}] {parts}\n")

    def close(self) -> None:
        if self._file:
            self._file.close()
