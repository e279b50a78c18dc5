"""Structured metrics logging (a copy of the JAX package's ``utils/logging.py``).

The reference logs with bare ``print`` (bestengine.py:974-982).  Here a
tiny structured logger appends one JSON object per event to a JSONL file
(greppable, plottable) while still echoing a human-readable line.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, IO


class MetricsLogger:
    def __init__(self, path: str | None = None, stream: IO | None = None):
        self.path = path
        # None = resolve sys.stdout at CALL time: a default bound at
        # import time can be a since-closed capture file (pytest capsys).
        self.stream = stream
        self._file = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        record = {"event": event, "t": round(time.time() - self._t0, 3)}
        record.update(
            {
                k: (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in fields.items()
            }
        )
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        pretty = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
            if k not in ("event", "t")
        )
        stream = self.stream if self.stream is not None else sys.stdout
        try:
            print(f"[{record['t']:9.1f}s] {event}: {pretty}", file=stream)
        except ValueError:  # closed stream (teardown race) — keep JSONL
            pass

    def close(self) -> None:
        if self._file:
            self._file.close()
