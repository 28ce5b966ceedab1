"""Structured run logging + stage timers (a copy of
``photon_ml_tpu/utils/logging.py``).

Equivalent of the reference's ``PhotonLogger`` (a structured log file
written next to outputs — SURVEY.md §5.5) and its ``Timed`` stage wrappers
(SURVEY.md §5.1). Events are JSON lines so downstream tooling can parse
them; optimizer-level convergence traces live in OptimizationResult's
loss/grad-norm histories and are logged per coordinate by the drivers.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class PhotonLogger:
    """JSONL event logger writing to a file and (optionally) stderr."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields) -> None:
        record = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(record, default=str)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Timed:
    """Context manager timing a stage and logging wall-clock seconds."""

    def __init__(self, logger: Optional[PhotonLogger], stage: str):
        self.logger = logger
        self.stage = stage
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.seconds = time.time() - self._t0
        if self.logger is not None:
            self.logger.log("stage_timing", stage=self.stage, seconds=self.seconds)
