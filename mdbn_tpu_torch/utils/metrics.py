"""Observability: JSONL metrics stream + stdlib logging (a copy of
mdbn_tpu/utils/metrics.py, which is pure Python).

The reference's observability was print/matplotlib in a notebook; here every
training run can stream one JSON object per epoch (reconstruction error,
updates/sec, wall seconds, engine) to a metrics file for offline analysis.
"""

from __future__ import annotations

import json
import os
import logging
import time
from typing import Any, Dict, Optional


def get_logger(name: str = "mdbn_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


class MetricsWriter:
    """Append-only JSONL metrics stream; one record per event."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a") if path else None

    def write(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        record = dict(record)
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
