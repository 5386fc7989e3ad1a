"""The program's spans in the traced window, on the trace's clock: what
the span readers of this directory share.

The program records its spans (``dpcx_torch.utils.profiling``'s
``RECORDER``) only while a profiler records, stamped by ``time.time_ns()``.
The trace's times are seconds from a base that ``benchmark.trace.Trace``
does not keep, so the two clocks differ by one unknown constant. Every
span that does device work records a pair of CUDA events and stamps each
record call, and the trace holds those calls (``cudaEventRecord`` among
its CUDA runtime calls): ``fit`` finds the constant from them. A span is
kept where it overlaps the trace's window, which leaves out the spans of
an earlier traced window that the run retried. With no recorder (a
program without spans), no span in the window, or a fit whose median
residual is ``FIT_LIMIT_S`` or more, the readers find nothing: None.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark import window

FIT_LIMIT_S = 50e-6
BIN_S = 20e-6  # the offsets' histogram
SAMPLE = 256  # trace calls voted with
RECORD_CALL = "EventRecord"


@dataclasses.dataclass
class Mapped:
    """A recorded span and its host interval on the trace's clock (s)."""

    span: object
    start: float
    end: float

    @property
    def name(self) -> str:
        return self.span.name


def fit(stamps_s: np.ndarray, calls_s: np.ndarray) -> float | None:
    """The constant that carries the recorder's stamps onto the trace's
    calls (trace time = stamp + constant): the offset that most pairs of
    a stamp and a sampled call agree on to within two bins of ``BIN_S``
    (a stamp lies a few us from its own call, while the steps' repeating
    pattern matches a shifted one only loosely; of equal counts the
    smallest offset, which carries the newest stamps), refined by the
    median residual of the stamps that then fall among the calls, each
    against its nearest call. None where no stamp falls among them or the
    median distance from a stamp to its nearest call is ``FIT_LIMIT_S``
    or more."""
    if len(stamps_s) == 0 or len(calls_s) == 0:
        return None
    stamps, calls = np.sort(stamps_s), np.sort(calls_s)
    pick = np.unique(np.linspace(0, len(calls) - 1,
                                 min(SAMPLE, len(calls))).astype(int))
    votes = np.floor((calls[pick, None] - stamps[None, :]) / BIN_S)
    bins, counts = np.unique(votes.astype(np.int64), return_counts=True)
    pairs = counts.copy()  # a bin's votes and its upper neighbour's
    pairs[:-1] += np.where(bins[1:] == bins[:-1] + 1, counts[1:], 0)
    offset = (float(bins[np.argmax(pairs)]) + 1.0) * BIN_S
    for _ in range(2):
        at = stamps + offset
        at = at[(at >= calls[0] - BIN_S) & (at <= calls[-1] + BIN_S)]
        if len(at) == 0:
            return None
        j = np.clip(np.searchsorted(calls, at), 1, len(calls) - 1)
        nearest = np.where(np.abs(calls[j - 1] - at) <= np.abs(calls[j] - at),
                           calls[j - 1], calls[j])
        offset += float(np.median(nearest - at))
    residual = np.abs(nearest - at - np.median(nearest - at))
    return None if float(np.median(residual)) >= FIT_LIMIT_S else offset


def _recorded() -> list | None:
    try:
        from dpcx_torch.utils import profiling
    except ImportError:
        return None
    recorder = getattr(profiling, "RECORDER", None)
    return None if recorder is None else recorder.finished()


def in_window(ctx) -> list[Mapped] | None:
    """The recorded spans that overlap ``ctx.trace``'s window, on its
    clock, in the order they opened; None as the module says."""
    spans = _recorded()
    if not spans:
        return None
    base = min(s.start_ns for s in spans)
    stamps = np.array([(ns - base) * 1e-9 for s in spans
                       if s.event_ns for ns in s.event_ns])
    calls = np.array([(a + b) / 2 for name, a, b in ctx.trace.host
                      if RECORD_CALL in name])
    offset = fit(stamps, calls)
    if offset is None:
        return None
    lo, hi = ctx.trace.lo, ctx.trace.hi
    mapped = [Mapped(s, (s.start_ns - base) * 1e-9 + offset,
                     (s.end_ns - base) * 1e-9 + offset) for s in spans]
    return [m for m in mapped if m.end > lo and m.start < hi] or None


def named(spans: list[Mapped], name: str) -> list[Mapped]:
    return [m for m in spans if m.name == name]


def device_us_per_unit(ctx, name: str, less: tuple = ()) -> float | None:
    """Device microseconds of the spans ``name`` a unit of the window,
    less those of their descendants named in ``less``; None without such
    a span or its events."""
    spans = in_window(ctx)
    if spans is None:
        return None
    outer = named(spans, name)
    if not outer or any(m.span.events is None for m in outer):
        return None
    total = sum(m.span.device_s for m in outer)
    ids = {id(m.span) for m in outer}
    for m in spans:
        if m.name in less and m.span.events is not None:
            p = m.span.parent
            while p is not None and id(p) not in ids:
                p = p.parent
            if p is not None:
                total -= m.span.device_s
    return 1e6 * total / ctx.units


def overlap_s(a: list[tuple[float, float]],
              b: list[tuple[float, float]]) -> float:
    """The time two lists of disjoint intervals in order share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_within(ctx, name: str) -> float | None:
    """The window's seconds in which the device is idle while the host is
    inside a span ``name``; None without such a span."""
    spans = in_window(ctx)
    if spans is None:
        return None
    tr = ctx.trace
    inside = window.union([(m.start, m.end) for m in named(spans, name)],
                          tr.lo, tr.hi)
    if not inside:
        return None
    idle = window.gaps([(s, e) for _, s, e in tr.device], tr.lo, tr.hi)
    return overlap_s(idle, inside)
