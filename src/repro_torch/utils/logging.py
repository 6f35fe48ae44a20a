"""Minimal structured loggers (CSV + JSONL) used by benchmarks and launchers."""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import IO, Optional


class CSVLogger:
    """Append rows to a CSV file (or stdout), writing the header once."""

    def __init__(self, path: Optional[str] = None, fieldnames=None):
        self.path = path
        self.fieldnames = list(fieldnames) if fieldnames else None
        self._writer = None
        self._fh: Optional[IO] = None

    def _ensure(self, row):
        if self._writer is not None:
            return
        if self.fieldnames is None:
            self.fieldnames = list(row.keys())
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "w", newline="")
        else:
            self._fh = sys.stdout
        self._writer = csv.DictWriter(self._fh, fieldnames=self.fieldnames,
                                      extrasaction="ignore")
        self._writer.writeheader()

    def log(self, **row):
        self._ensure(row)
        self._writer.writerow(row)
        self._fh.flush()

    def close(self):
        if self._fh is not None and self._fh is not sys.stdout:
            self._fh.close()


class JSONLLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def log(self, **record):
        record.setdefault("t", time.time())
        self._fh.write(json.dumps(record, default=str) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
