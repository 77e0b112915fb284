"""Named host timers and a device trace.

``Timers`` accumulates wall time by name (``cli.train`` times its batch
loads, steps, validations, evaluations and saves with it: a phase that
ends in a read of a device value, such as a step's loss, includes the
device's work). ``device_trace`` records ``torch.profiler`` (host, and the
GPU's kernels when there is one) into a Chrome trace, the counterpart of
the JAX package's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timers:
    """Named accumulating host timers."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` around the block, written to
    ``{log_dir}/trace.json`` (Chrome trace format); no-op when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sec_to_hours(seconds: float) -> str:
    """A duration as "H hours M mins S seconds"."""
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = round((seconds % 3600) % 60, 2)
    return f"{h} hours {m} mins {s} seconds"
