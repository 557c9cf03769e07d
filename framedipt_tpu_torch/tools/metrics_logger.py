"""Training metrics as a JSONL stream: one line per logged step,
``{"step", "time", <metric>: float, ...}`` in ``<run_dir>/metrics.jsonl``."""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any


class MetricsLogger:
    def __init__(self, run_dir: str | pathlib.Path) -> None:
        self.path = pathlib.Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        """Append one row; values that do not convert to float are left out."""
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
