"""The span readers (``benchmark/metrics/_spans.py`` and the metrics that
use it) on a synthetic trace and a synthetic recorder: the clock fit
recovers a planted offset and gives up past its limit, each reader's
arithmetic (self time, the idle inside the steps, the exchange's
bandwidth), an earlier traced window's spans left out, and nothing read
without the program's recorder. On the card (``-m cuda``): under the
benchmark's own ``trace.traced`` the program's spans turn on and the fit
holds."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, manifest
from benchmark.metrics import _spans
from benchmark.trace import Trace

T0 = 1_790_000_000_000_000_000  # ns on the recorder's clock
BASE = T0 - 5_000_000_000  # the trace's base: ts in us = (ns - BASE) / 1e3
STEP_US = 10_000
# a step's spans: name, parent, host (start, end) us into the step, device
# ms between the span's events, counts
STEP = [
    ("train.step", None, (0, 8000), 8.0, {}),
    ("train.draw", "train.step", (100, 500), 0.1, {}),
    ("train.forward", "train.step", (600, 2000), 1.0, {}),
    ("train.loss", "train.step", (2100, 4000), 2.0, {}),
    ("render.project", "train.loss", (2500, 3500), 1.5, {}),
    ("render.fwd", "render.project", (2700, 3300), 1.2, {}),
    ("train.backward", "train.step", (4100, 6500), 3.0, {}),
    ("render.bwd", "train.backward", (4500, 5000), 1.1, {}),
    ("train.grads", "train.step", (6600, 7000), 0.5, {}),
    ("parallel.all_mean", "train.grads", (6650, 6950), 0.4,
     {"bytes": 232_000_000}),
    ("train.adam", "train.step", (7100, 7900), 0.6, {}),
]
# device operations (us on the trace's clock from the window's start):
# idle 3000-4000 and 15000-15500 inside the steps, 9000-9500 between them
KERNELS = [(0, 3000), (4000, 9000), (9500, 15000), (15500, 20000)]


class Ev:
    """A CUDA event's stand-in: the device time of its record, ms."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, other: Ev) -> float:
        return other.ms - self.ms


def make_span(name, start_us, end_us, device_ms, parent, step, counts):
    from dpcx_torch.utils import profiling

    s = profiling.Span(name, step, counts)
    s.parent = parent
    s.start_ns, s.end_ns = T0 + int(start_us * 1e3), T0 + int(end_us * 1e3)
    s.events = (Ev(0.0), Ev(device_ms))
    s.event_ns = (s.start_ns + 2000, s.end_ns - 2000)  # 2 us inside
    return s


def make_recorder(shift_us: float = 0.0, steps: int = 2,
                  step_us: float = STEP_US):
    """A chunk of ``steps`` steps of ``STEP``, ``step_us`` apart, from
    ``shift_us`` after T0."""
    from dpcx_torch.utils import profiling

    rec = profiling.Recorder()
    chunk = make_span("train.chunk", shift_us - 100,
                      shift_us + steps * step_us, 17.0, None, 0, {})
    rec.spans.append(chunk)
    for k in range(steps):
        made = {None: chunk}
        at = shift_us + k * step_us
        for name, parent, (a, b), ms, counts in STEP:
            made[name] = make_span(name, at + a, at + b, ms, made[parent],
                                   k, dict(counts))
            rec.spans.append(made[name])
    return rec


def make_trace(rec, jitter_us: float = 0.0, seed: int = 0,
               kernels=KERNELS) -> Trace:
    """The trace of ``rec``'s window: ``kernels``, a ``cudaEventRecord``
    call at each event stamp (moved by up to ``jitter_us``), and calls that
    are not the program's."""
    rng = np.random.default_rng(seed)
    start = (T0 - BASE) / 1e3

    def x(name, cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [x("kernel_a", "kernel", start + a, b - a) for a, b in kernels]
    for s in rec.spans:
        for ns in s.event_ns:
            mid = (ns - BASE) / 1e3 + rng.uniform(-jitter_us, jitter_us)
            events.append(x("cudaEventRecord", "cuda_runtime", mid - 1, 2))
    end = kernels[-1][1]
    for t in start + np.sort(rng.uniform(0, end, end // 1000)):
        events.append(x("cudaEventRecord", "cuda_runtime", t, 2))
        events.append(x("cudaLaunchKernel", "cuda_runtime", t + 50, 4))
    return Trace(events)


def ctx_of(trace, units=2):
    return harness.MetricContext(trace=trace, units=units, settings={},
                                 rows=0, renders=0, weights=False)


@pytest.fixture
def recorded(monkeypatch):
    """Installs a synthetic recorder as the program's."""
    from dpcx_torch.utils import profiling

    def install(rec):
        monkeypatch.setattr(profiling, "RECORDER", rec)
        return rec

    return install


def read(metric: str, ctx):
    return manifest.cell("car64_depth.train_b256").reader(metric)(ctx)


def test_fit_recovers_a_planted_offset():
    rng = np.random.default_rng(1)
    stamps = np.sort(rng.uniform(0, 4.0, 3000))
    offset = 1234.567891
    calls = np.concatenate([stamps + offset + rng.uniform(-5e-6, 5e-6, 3000),
                            rng.uniform(offset, offset + 4.0, 1500)])
    got = _spans.fit(stamps, calls)
    assert got is not None and abs(got - offset) < 5e-6
    # the stamps of an earlier window, 30 s before, fall outside the calls
    earlier = np.sort(rng.uniform(0, 4.0, 3000)) - 30.0
    both = np.concatenate([earlier, stamps])
    assert abs(_spans.fit(both, calls) - offset) < 5e-6


def test_fit_gives_up_past_its_limit():
    rng = np.random.default_rng(2)
    stamps = np.sort(rng.uniform(0, 4.0, 2000))
    calls = stamps + 7.0 + rng.uniform(-400e-6, 400e-6, 2000)
    assert _spans.fit(stamps, calls) is None
    assert _spans.fit(stamps, np.array([])) is None


def test_spans_land_on_the_trace_clock(recorded):
    rec = recorded(make_recorder())
    spans = _spans.in_window(ctx_of(make_trace(rec, jitter_us=3.0)))
    assert len(spans) == len(rec.spans)
    for m in spans:
        want = (m.span.start_ns - BASE) * 1e-9
        assert abs(m.start - want) < 5e-6, m.name


def test_self_time_arithmetic(recorded):
    """Device us a step: each span's events, the loss and the backward
    less the renderer's launches inside them."""
    ctx = ctx_of(make_trace(recorded(make_recorder())))
    assert read("render_fwd_us.train", ctx) == pytest.approx(1200)
    assert read("render_bwd_us.train", ctx) == pytest.approx(1100)
    assert read("model_fwd_us", ctx) == pytest.approx(1000)
    assert read("loss_us", ctx) == pytest.approx(2000 - 1200)
    assert read("backward_us", ctx) == pytest.approx(3000 - 1100)
    assert read("host_step_us.train", ctx) == pytest.approx(8000, abs=1e-3)


def test_dispatch_idle_on_known_gaps(recorded):
    """Idle 2 ms of a 20 ms window, 1.5 ms of it inside the steps."""
    ctx = ctx_of(make_trace(recorded(make_recorder())))
    assert read("device_idle_pct.train", ctx) == pytest.approx(10.0)
    assert read("dispatch_idle_pct.train", ctx) == pytest.approx(7.5)


def test_exchange(recorded):
    ctx = ctx_of(make_trace(recorded(make_recorder())))
    dp = manifest.cell("car64_depth.train_dp4")
    assert dp.reader("exchange_us")(ctx) == pytest.approx(400)
    assert dp.reader("exchange_gbps")(ctx) == pytest.approx(
        232e6 / 0.4e-3 / 1e9)


def test_an_earlier_window_is_left_out(recorded):
    """A run retries a traced window: the spans of the one before,
    30 s earlier, are in the recorder but not in the trace."""
    rec = make_recorder()
    earlier = make_recorder(shift_us=-30e6, step_us=STEP_US + 300)
    rec.spans.extendleft(reversed(earlier.spans))
    recorded(rec)
    ctx = ctx_of(make_trace(make_recorder()))
    assert len(_spans.in_window(ctx)) == len(rec.spans) // 2
    assert read("render_fwd_us.train", ctx) == pytest.approx(1200)


def test_nothing_read_without_the_program_spans(recorded, monkeypatch):
    from dpcx_torch.utils import profiling

    trace = make_trace(make_recorder())
    names = ("render_fwd_us.train", "host_step_us.train",
             "dispatch_idle_pct.train")
    recorded(profiling.Recorder())  # no span recorded
    assert all(read(n, ctx_of(trace)) is None for n in names)
    rec = recorded(make_recorder(steps=20))  # the fit past its limit
    sparse = [s for s in rec.spans if s.name in ("train.step", "render.fwd")]
    rec.spans.clear()
    rec.spans.extend(sparse)
    noisy = ctx_of(make_trace(rec, jitter_us=400.0,
                              kernels=[(0, 20 * STEP_US)]), units=20)
    assert all(read(n, noisy) is None for n in names)
    monkeypatch.delattr(profiling, "RECORDER")  # a program without spans
    assert all(read(n, ctx_of(trace)) is None for n in names)


@pytest.mark.cuda
def test_spans_turn_on_under_the_benchmark_trace():
    """Renderer calls at a small size under ``trace.traced`` (CUDA
    activity alone): the program's spans record, the fit holds, and the
    renderer's readers read."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import trace
    from benchmark.drivers.train import config
    from dpcx_torch.render.project import pointcloud_project_fn
    from dpcx_torch.utils import profiling

    cfg = config(manifest.cell("car64_depth.render_fwdbwd").settings())
    sigma = torch.tensor(cfg.pc_relative_sigma, device="cuda")
    pts = torch.rand(8, cfg.pc_num_points, 3, device="cuda") - 0.5
    quat = torch.nn.functional.normalize(torch.randn(8, 4, device="cuda"),
                                         dim=-1)

    def call():
        p = pts.detach().requires_grad_(True)
        out = pointcloud_project_fn(cfg, p, quat, sigma)
        (out.silhouette.sum() + out.depth.sum()).backward()

    call()
    torch.cuda.synchronize()
    holder: list = []
    with trace.traced(holder):
        for _ in range(20):
            call()
    names = [s.name for s in profiling.RECORDER.finished()]
    assert names.count("render.fwd") == names.count("render.bwd") == 20
    ctx = ctx_of(holder[-1], units=20)
    spans = _spans.in_window(ctx)
    assert spans is not None and len(spans) == len(names)
    cell = manifest.cell("car64_depth.render_fwdbwd")
    for metric in ("render_fwd_us.render", "render_bwd_us.render"):
        assert cell.reader(metric)(ctx) > 0
