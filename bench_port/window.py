"""The measured window: a closed loop of one client, and the statistics of its jobs.

The client starts the next job when the last has ended. The window opens when
the first job starts and closes when the first job that ends at least
``seconds`` after the opening ends, so every job of the window is whole and
no time of the window is left out: the rate is all the updates of all its
jobs over all its seconds, and the tail is the tail of all its jobs.
"""

from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    jobs: List[Tuple[float, float]] = field(default_factory=list)  # (start, end), host clock

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def durations(self) -> List[float]:
        return [b - a for a, b in self.jobs]


def run(job: Callable[[int], None], seconds: float, clock=time.perf_counter,
        hold: Callable[[], bool] = lambda: False,
        agree: Callable[[bool], bool] = lambda stop: stop) -> Window:
    """Call ``job(i)`` for i = 0, 1, ... back to back for ``seconds``, and on
    while ``hold()`` (a traced stretch that has not ended). ``agree`` turns
    this process's decision to close into the one every rank takes."""
    w = Window(start=clock())
    i = 0
    while True:
        t0 = clock()
        job(i)
        t1 = clock()
        w.jobs.append((t0, t1))
        i += 1
        if agree(t1 - w.start >= seconds and not hold()):
            w.end = t1
            return w


def rate(work_per_job: float, window: Window) -> float:
    """Work completed per second over the whole window."""
    return work_per_job * len(window.jobs) / window.seconds


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile of every value (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Reservoir:
    """A uniform sample of ``size`` of the jobs seen, drawn from ``seed``
    (Algorithm R): the same seed and job count keep the same jobs."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept: List[Tuple[int, object]] = []
        self.seen = 0

    def offer(self, index: int, make: Callable[[], object]) -> None:
        """Keep job ``index`` with the right chance; ``make`` gives what to keep."""
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((index, make()))
            return
        slot = self.rng.randrange(self.seen)
        if slot < self.size:
            self.kept[slot] = (index, make())
