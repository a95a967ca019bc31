"""Wall-clock meters and the JSONL scalar log (a copy of
eyoc_tpu/utils/timer.py; reference lib/timer.py:5-73)."""

from __future__ import annotations

import json
import os
import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val * val * n

    @property
    def var(self):
        if self.count == 0:
            return 0.0
        return self.sq_sum / self.count - self.avg ** 2


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0
        self.min_diff = float("inf")

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average=True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        self.min_diff = min(self.min_diff, self.diff)
        return self.avg if average else self.diff


class ScalarWriter:
    """JSONL scalar log, `<out_dir>/scalars.jsonl` (the reference's
    tensorboardX surface, lib/trainer.py:106, 1686-1692)."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
