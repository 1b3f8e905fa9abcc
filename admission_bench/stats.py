"""The arithmetic of the end-to-end numbers and of the bounds.

A rate is all the work answered inside the window over the window's whole
length; a tail is a percentile over every call (or every object write)
answered inside it. A spread is the distance between the first and third
quartile as ``statistics.quantiles(values, n=4)`` gives them, as a share of
the median."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Sequence


def window_rate(done_times: Iterable[float], oks: Iterable[bool], t0: float, t1: float) -> float:
    """Answers with a verdict that arrived in [t0, t1], per second of it."""
    n = sum(1 for t, ok in zip(done_times, oks) if ok and t0 <= t <= t1)
    return n / (t1 - t0)


def percentile(values: Sequence[float], q: float) -> float | None:
    """The q-th percentile (0-100), linear between closest ranks (numpy's
    default); None for no values."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
