"""Structured training logs: one JSON record per iteration.

Port of ``scfgp_tpu/utils/logging.py``.  The reference only printed to
stdout (``reference: SCFGP/SCFGP.py:53-56,242-244``); this logger appends
one JSON object per iteration (iteration, metric values, wall time) to a
file.  The port trains in one process, which writes ``path`` itself (the
JAX package's process index 0).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:

    def __init__(self, path: Optional[str]):
        self.path = path or None
        self._f = None
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._f = open(self.path, "a")
            self._t0 = time.time()

    def log(self, iteration: int, **metrics):
        if self._f is None:
            return
        rec = {"iter": iteration, "t": round(time.time() - self._t0, 4)}
        rec.update({k: (float(v) if v is not None else None)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
