"""Structured metrics and progress logging: the port's
``mgn_tpu/utils/metrics.py``.  One JSON object per line (``kind`` ``train``,
``valid``, ``checkpoint``, ``resume``, ...) on stdout and/or a file, plus an
optional wandb-like hook."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Optional, TextIO

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, stream: Optional[TextIO] = None, path: Optional[str] = None,
                 wandb_logger: Any = None, quiet: bool = False):
        self.stream = stream if stream is not None else (None if quiet else sys.stdout)
        self.file = open(path, "a") if path else None
        self.wandb = wandb_logger
        self.t0 = time.time()
        self.records = []  # every record logged, for callers that read them back

    def log(self, kind: str, **values: Any) -> None:
        rec = {"kind": kind, "t": round(time.time() - self.t0, 3)}
        for k, v in values.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        self.records.append(rec)
        line = json.dumps(rec)
        if self.stream is not None:
            print(line, file=self.stream, flush=True)
        if self.file is not None:
            print(line, file=self.file, flush=True)
        if self.wandb is not None:
            self.wandb.log({f"{kind}/{k}": v for k, v in rec.items()
                            if isinstance(v, (int, float))})

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
