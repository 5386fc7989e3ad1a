"""Window arithmetic: rates over the whole window, the tail over every
step, and device busy time from a trace's intervals."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """All the work completed in the window over all of its seconds."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def step_times_ms(ends_ms: list[float]) -> list[float]:
    """The times between consecutive step ends; ``ends_ms[0]`` is the
    window's start, so every step of the window has a time, the wait of a
    step that waited for the host included."""
    return [b - a for a, b in zip(ends_ms, ends_ms[1:])]


def p95(values: list[float]) -> float:
    """The 95th percentile of all ``values``, interpolated between the
    two nearest ranks (the inclusive method)."""
    if len(values) < 2:
        raise ValueError(f"{len(values)} values have no 95th percentile")
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def union(intervals: list[tuple[float, float]], lo: float,
          hi: float) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    disjoint intervals in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: list[tuple[float, float]], lo: float, hi: float
         ) -> float:
    """The time in [lo, hi] that some interval covers."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float
         ) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)
