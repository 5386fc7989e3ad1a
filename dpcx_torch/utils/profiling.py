"""Profiling and tracing (port of ``dpcx/utils/profiling.py``): a
``torch.profiler`` trace of a block, and the program's spans.

A span marks one layer's stretch of the program:

==================  ===================================================
``train.chunk``     ``train_steps_scan`` / ``_dp``: a chunk of steps
``train.step``      each step of a chunk; the host-fed ``train_step``
``train.draw``      ``scan_batch``: the draw kernel and the gather
``train.forward``   the encoder and decoder forward
``pose.views``      predicted pose from the views: the target views'
                    encoder and pose heads (``model.pose_only``)
``train.loss``      ``compute_loss``: loss terms, camera transform, the
                    renderer's glue
``pose.fanout``     predicted pose: the points, keep weights and cameras
                    broadcast to B x K x V rows, counting the ``bytes``
                    they materialise
``pose.select``     predicted pose: the candidates' scores, the hard
                    min, its gathers, the student and the telemetry
``render.project``  ``pointcloud_project_fn``: the camera transform (on
                    the card, in the kernels' splat stages) and the
                    renderer
``render.fwd``      the renderer's forward launch (K1 / K3; K6)
``train.backward``  ``loss.backward()``
``render.bwd``      the renderer's backward launch (K2 / K4 + K5; K7),
                    on the autograd engine's thread on a card
``train.grads``     unreached gradients zero-filled, the metrics, the
                    exchange, ``grad_norm``
``parallel.all_mean``  ``all_mean_``, counting ``bytes`` exchanged
``train.adam``      ``opt.step()``
``train.readback``  ``train``'s read of a chunk's metrics on the host
==================  ===================================================

Spans are on only while a ``torch.profiler`` records. The outermost span
(one that opens while no span is open, on any thread) looks when it opens,
and its decision holds for every span, on every thread, until it closes.
Off, ``span`` tests two flags (an open outermost span's, the profiler's),
notes that it found spans off, and returns the shared object of its name,
which does nothing: no allocation, no CUDA call, no ``record_function``.
On, a span

- stamps its host start and end with ``time.time_ns()``, the clock of the
  profiler trace's ``ts`` (``ts`` in us is ``time_ns() / 1e3`` less the
  trace's ``baseTimeNanoseconds / 1e3``);
- knows its parent, also across the autograd engine's thread, which no
  thread-local stack reaches: a span that opens on a thread with no open
  span takes the innermost open span of the outermost span's thread;
- carries the absolute step (``step``) of its ``train.step`` or
  ``train.chunk``; one outside a step takes a call number (``call``);
- once CUDA is initialised, records a pair of timing CUDA events on the
  current stream, stamping each ``cudaEventRecord`` call so that a reader
  can fit its clock onto a trace's; ``Span.device_s`` resolves them, and
  is read after a sync;
- is a ``torch.profiler.record_function`` of the same name, so a trace
  nests the spans over their kernels;
- is kept in ``RECORDER``, a bounded buffer that the first span of a new
  profiler session (one that turns spans on after a span found them off)
  clears. Nothing is written out but the profiler's own export.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16  # spans kept, newest last


def _synchronize() -> None:
    """Wait for the card, where anything has run on it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Span:
    """One span as it is recorded: ``name``, ``step`` or ``call``,
    ``parent`` (a ``Span`` or None), ``counts``, the host's ``start_ns``
    and ``end_ns`` (0 while open), and where CUDA was initialised the
    timing ``events`` with the host stamps of their records
    (``event_ns``)."""

    __slots__ = ("name", "step", "call", "parent", "counts", "start_ns",
                 "end_ns", "events", "event_ns", "_annotation")

    def __init__(self, name: str, step: int | None = None,
                 counts: dict | None = None):
        self.name, self.step, self.counts = name, step, counts or {}
        self.call = self.parent = self.events = self.event_ns = None
        self._annotation = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> Span:
        _open(self)
        return self

    def __exit__(self, *exc) -> bool:
        _close(self, exc)
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def device_s(self) -> float | None:
        """Seconds on the span's stream between its two events (None
        without events); read after a sync, once both have completed."""
        if self.events is None:
            return None
        start, end = self.events
        return start.elapsed_time(end) * 1e-3


class Recorder:
    """The spans of the newest profiler session, in the order they
    opened, at most ``capacity`` of them; ``calls`` numbers the outermost
    spans outside a step."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self.calls = 0

    def clear(self) -> None:
        self.spans.clear()

    def finished(self) -> list[Span]:
        return [s for s in list(self.spans) if s.end_ns]


class _Off:
    """What ``span`` returns while spans are off: one object a name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


RECORDER = Recorder()
_OFF: dict[str, _Off] = {}
_LOCK = threading.Lock()  # the outermost span's decision
_local = threading.local()  # .stack: this thread's open spans
_on = False  # an outermost span that turned spans on is open
_outer: Span | None = None  # that span
_outer_stack: list[Span] = []  # its thread's open spans
_seen_off = True  # a span found spans off since they were last on


def span(name: str, step: int | None = None, **counts):
    """A span named ``name`` (a context manager, or a decorator of a
    function each of whose calls it spans), of absolute step ``step``
    (None: its parent's), with ``counts`` (numbers: ``bytes=...``)."""
    global _seen_off
    if _on or _profiler._is_profiler_enabled:
        return Span(name, step, counts)
    _seen_off = True
    off = _OFF.get(name)
    return off if off is not None else _OFF.setdefault(name, _Off(name))


def _decorated(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return spanned


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stamped_event():
    """A timing CUDA event recorded on the current stream, and the host
    time of its record call (the middle of the call, ns)."""
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.time_ns()
    ev.record()
    return ev, (t0 + time.time_ns()) // 2


def _open(s: Span) -> None:
    global _on, _outer, _outer_stack, _seen_off
    stack = _stack()
    with _LOCK:
        if _on:
            s.parent = stack[-1] if stack else (
                _outer_stack[-1] if _outer_stack else None)
        else:
            _on, _outer, _outer_stack = True, s, stack
            if _seen_off:  # a new profiler session
                RECORDER.clear()
                _seen_off = False
    p = s.parent
    if s.step is None and p is not None:
        s.step, s.call = p.step, p.call
    elif s.step is None:
        RECORDER.calls += 1
        s.call = RECORDER.calls
    s._annotation = _profiler.record_function(s.name)
    t0 = time.time_ns()
    s._annotation.__enter__()
    s.start_ns = (t0 + time.time_ns()) // 2  # its annotation's start
    if torch.cuda.is_initialized():
        ev, ns = _stamped_event()
        s.events, s.event_ns = (ev,), (ns,)
    stack.append(s)
    RECORDER.spans.append(s)


def _close(s: Span, exc) -> None:
    global _on, _outer, _outer_stack
    if s.events is not None:
        ev, ns = _stamped_event()
        s.events, s.event_ns = s.events + (ev,), s.event_ns + (ns,)
    s._annotation.__exit__(*exc)
    s.end_ns = time.time_ns()  # its annotation ends late in the exit
    s._annotation = None
    _stack().pop()
    if s is _outer:
        with _LOCK:
            _on, _outer, _outer_stack = False, None, []


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """``torch.profiler`` trace of the block: CPU activity, and CUDA
    activity where there is a card, the program's spans among them. The
    card is synchronised before the profiler stops, and one Chrome trace
    (``*.pt.trace.json``; open it in Perfetto, chrome://tracing or
    TensorBoard's profiler plugin) is written into ``log_dir`` (default:
    ``dpcx-trace`` in the temporary directory). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir or Path(tempfile.gettempdir()) / "dpcx-trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _synchronize()
    prof.export_chrome_trace(str(
        log_dir / f"dpcx_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
