"""Structured per-epoch logging: stdout echo + machine-readable JSONL.

A copy of the JAX package's ``mma_tpu/train/logger.py``, which replaces
the reference's bare ``print`` telemetry (``train.py:91-96``,
``mma.py:199-200``) with records a harness can parse.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, **record):
        record.setdefault("t", round(time.time() - self._t0, 3))
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            parts = []
            for k, v in record.items():
                if isinstance(v, float):
                    parts.append(f"{k}: {v:.4f}")
                else:
                    parts.append(f"{k}: {v}")
            print(" | ".join(parts), flush=True)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
