"""Wall time per pipeline stage.

Counterpart of ``StageTimer`` in hippie_tpu/utils/profiling.py: each
``with timer.stage(name)`` adds its wall time to ``timings[name]``.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict


class StageTimer:
    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.timings.values())
        return json.dumps({**{k: round(v, 3) for k, v in self.timings.items()},
                           "total_s": round(total, 3)})
