"""The port's spans (``dpcx_torch/utils/profiling.py``) on the CPU: off
they record nothing and make no CUDA call; on, under a ``torch.profiler``,
a training chunk's spans nest as the module's table says and share their
step, the renderer's backward on another thread takes the step's backward
as its parent, the stamps agree with the exported trace's annotations, the
exchange counts its bytes over two gloo ranks, and training is bitwise
the same with spans on. ``train``'s ``steps_per_sec`` leaves out the
first chunk's warm-up."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dpcx_torch import train as ttrain
from dpcx_torch.config import Config
from dpcx_torch.data.dataset import Dataset
from dpcx_torch.render import fused
from dpcx_torch.utils import prng, profiling
from dpcx_torch.utils.profiling import span
from torch_ranks import run_world, spans_world
from torch_workers import share_cores

share_cores()

CFG = Config(vox_size=8, pc_num_points=64, image_size=16,
             encoder_filters=(8,), latent_dim=16, fc_hidden=16,
             pc_decoder_hidden=(16,), num_views=3, views_per_step=2,
             batch_size=3, compute_dtype="float32", pc_relative_sigma=0.15,
             proj_depth=True, drc_weight=0.1, learning_rate=1e-4,
             pc_point_dropout=0.5, renderer="pallas")
# each span's parent in a step of train_steps_scan
PARENTS = {"train.step": "train.chunk", "train.draw": "train.step",
           "train.forward": "train.step", "train.loss": "train.step",
           "render.project": "train.loss", "render.fwd": "render.project",
           "train.backward": "train.step", "render.bwd": "train.backward",
           "train.grads": "train.step", "train.adam": "train.step"}
ANNOTATION_US = 50


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test's spans alone: a profiler session that follows another
    with no span between them keeps adding to the same buffer."""
    profiling.RECORDER.clear()


def _records(cfg, models=4):
    """Records as a run keeps them on the device: blob masks, depths,
    unit quats."""
    rng = np.random.default_rng(0)
    V, D, S = cfg.num_views, cfg.vox_size, cfg.image_size
    yy, xx = np.mgrid[:D, :D] / D - 0.5
    masks = ((yy**2 + xx**2) < rng.uniform(0.15, 0.35, (models, V, 1, 1))
             ** 2).astype(np.float32)
    q = rng.normal(size=(models, V, 4)).astype(np.float32)
    return {"images": torch.tensor(rng.random((models, V, S, S, 3),
                                              np.float32)),
            "masks": torch.tensor(masks),
            "depths": torch.tensor(np.where(masks > 0, 0.1, 1.0)
                                   .astype(np.float32)),
            "quats": torch.tensor(q / np.linalg.norm(q, axis=-1,
                                                     keepdims=True))}


def _plain(ndc_t, vox, sigma, radius, point_weights=None, with_depth=False,
           acc_dtype="float32", save_grid=True):
    """The fused renderer's plain version with its backward written out:
    on the CPU the renderer's forward and backward as a Function, as the
    kernels are on the card."""
    return fused.fused_project_plain(ndc_t, vox, sigma, radius,
                                     point_weights, with_depth, acc_dtype)


def _scan(state, n, records=None):
    return ttrain.train_steps_scan(CFG, state, records or _records(CFG),
                                   prng.prng_key(1), n, project_fn=_plain)


class _Event:
    """A stand-in for ``torch.cuda.Event`` that counts what it is asked."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream=None):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_spans_off_record_nothing_and_call_no_cuda(monkeypatch):
    """With no profiler a chunk records no span and makes no CUDA event,
    though CUDA reads as initialised; a span is one shared object a name.
    Under a profiler the same chunk makes two events a span."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _Event.made = 0
    state = ttrain.create_state(CFG, "cpu", seed=0)
    _scan(state, 1)
    assert len(profiling.RECORDER.spans) == 0 and _Event.made == 0
    assert span("train.step", step=3) is span("train.step")
    assert span("train.step") is not span("train.adam")
    with profile(activities=[ProfilerActivity.CPU]):
        _scan(state, 1)
    spans = profiling.RECORDER.finished()
    assert len(spans) == len(PARENTS) + 1
    assert _Event.made == 2 * len(spans)
    assert all(len(s.event_ns) == 2 and s.device_s == 1e-3 for s in spans)


def test_spans_of_a_scan_nest_and_share_the_step():
    """Two steps from step 5: one chunk of step 5; in each step every span
    of the table under its parent, with the step's absolute number."""
    state = ttrain.create_state(CFG, "cpu", seed=0)
    state.step = 5
    with profile(activities=[ProfilerActivity.CPU]):
        _scan(state, 2)
    spans = profiling.RECORDER.finished()
    (chunk,) = [s for s in spans if s.name == "train.chunk"]
    assert chunk.parent is None and chunk.step == 5
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.step for s in steps] == [5, 6]
    for s in spans:
        if s is not chunk:
            assert s.parent.name == PARENTS[s.name], s.name
            assert s.name == "train.step" or s.step == s.parent.step, s.name
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns, s.name
    for step in steps:
        assert sorted(s.name for s in spans
                      if s.step == step.step and s is not chunk) \
            == sorted(PARENTS)


def test_render_bwd_on_another_thread_takes_the_backward_as_parent():
    """The autograd engine runs a card's backward on a thread of its own:
    a span there takes the innermost open span of the outermost span's
    thread as its parent. With no span open, such a span is outermost
    and takes a call number."""
    seen = []

    def backward():
        with span("render.bwd") as s:
            seen.append(s)

    with profile(activities=[ProfilerActivity.CPU]):
        with span("train.step", step=7):
            with span("train.backward") as b:
                t = threading.Thread(target=backward)
                t.start()
                t.join(60)
        t = threading.Thread(target=backward)
        t.start()
        t.join(60)
    assert not t.is_alive() and len(seen) == 2
    inner, outer = seen
    assert inner.parent is b and inner.step == 7 and inner.call is None
    assert outer.parent is None and outer.step is None and outer.call > 0
    assert outer.call == profiling.RECORDER.calls


def test_spans_from_many_threads_under_one_step():
    """Threads that open spans while the outermost one is open (as the
    autograd engine's do), with the interpreter switching every us: every
    span is kept, each thread's first under the step's open span and the
    rest under its own, and spans are off again once the step closes."""
    import sys

    threads, each = 8, 50
    nested = []  # (inner under outer, outer under the step's backward)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with span("train.step", step=3):
                with span("train.backward") as b:
                    def work():
                        for _ in range(each):
                            with span("render.bwd") as outer:
                                with span("render.fwd") as inner:
                                    pass
                            nested.append((inner.parent is outer,
                                           outer.parent is b))

                    pool = [threading.Thread(target=work)
                            for _ in range(threads)]
                    for t in pool:
                        t.start()
                    for t in pool:
                        t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    assert nested == [(True, True)] * (threads * each)
    spans = profiling.RECORDER.finished()
    assert len(spans) == 2 + 2 * threads * each
    assert all(s.step == 3 for s in spans)
    assert span("render.bwd") is span("render.bwd")  # off again


def test_span_stamps_agree_with_the_trace(tmp_path):
    """Each span's host start and end, against the exported Chrome trace's
    annotation of the same name (the same order), once its
    ``baseTimeNanoseconds`` is applied: within 50 us."""
    state = ttrain.create_state(CFG, "cpu", seed=0)
    records = _records(CFG)
    _scan(state, 1, records)
    with profiling.trace(tmp_path) as log_dir:
        with span("warm-up"):  # the profiler's first annotation
            pass
        _scan(state, 1, records)
    (path,) = log_dir.glob("*.pt.trace.json")
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    marks: dict[str, list] = {}
    for e in sorted(doc["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(e)
    spans = profiling.RECORDER.finished()
    assert len(spans) == len(PARENTS) + 2
    for name in PARENTS.keys() | {"train.chunk"}:
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start_ns)
        assert len(mine) == len(marks[name]), name
        for s, e in zip(mine, marks[name]):
            start_us = e["ts"] + base / 1e3
            assert abs(s.start_ns / 1e3 - start_us) < ANNOTATION_US, name
            assert abs(s.end_ns / 1e3 - start_us - e["dur"]) \
                < ANNOTATION_US, name


def test_a_new_profiler_session_clears_the_spans():
    """Spans of an earlier session are gone once a span found spans off
    and a later session turns them on."""
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            pass
    with span("between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
    assert [s.name for s in profiling.RECORDER.finished()] == ["second"]


def test_spans_leave_training_bitwise_unchanged():
    """Two steps with spans on and with them off, from the same state:
    the same metrics and parameters, bit for bit."""
    runs = []
    for on in (False, True):
        state = ttrain.create_state(CFG, "cpu", seed=0)
        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                m = _scan(state, 2)
            assert profiling.RECORDER.finished()
        else:
            m = _scan(state, 2)
        runs.append((m, state.model.state_dict()))
    (m_a, p_a), (m_b, p_b) = runs
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for k in p_a:
        assert torch.equal(p_a[k], p_b[k]), k


# predicted pose from the views: K 4 candidates of V 2 target views
POSE = CFG.replace(predict_pose=True, pose_from_views=True,
                   pose_predict_num_candidates=4, pose_student=True,
                   proj_depth=False, drc_weight=0.0)
POSE_PARENTS = {"pose.views": "train.forward", "pose.fanout": "train.loss",
                "pose.select": "train.loss"}


@pytest.mark.parametrize("cfg,pose", [(CFG, False), (POSE, True)],
                         ids=["gt_pose", "predicted_pose"])
def test_pose_spans_once_a_step_on_the_pose_path_alone(cfg, pose):
    """Two steps: ``pose.views`` under the forward, ``pose.fanout`` and
    ``pose.select`` under the loss, once a step each with predicted pose
    and never with GT pose; the fan-out counts the bytes of the rows it
    materialises: each sample's points and keep weights and each row's
    camera, B x K x V x (N x (3 + 1) + 4) float32 values."""
    state = ttrain.create_state(cfg, "cpu", seed=0)
    with profile(activities=[ProfilerActivity.CPU]):
        ttrain.train_steps_scan(cfg, state, _records(cfg), prng.prng_key(1),
                                2, project_fn=_plain)
    spans = [s for s in profiling.RECORDER.finished()
             if s.name.startswith("pose.")]
    if not pose:
        assert spans == []
        return
    assert sorted((s.step, s.name) for s in spans) == [
        (step, name) for step in (0, 1) for name in sorted(POSE_PARENTS)]
    for s in spans:
        assert s.parent.name == POSE_PARENTS[s.name], s.name
        assert s.step == s.parent.step
    rows = cfg.batch_size * cfg.pose_predict_num_candidates \
        * cfg.views_per_step
    for s in spans:
        if s.name == "pose.fanout":
            assert s.counts == {
                "bytes": 4 * rows * (cfg.pc_num_points * (3 + 1) + 4)}


def test_all_mean_counts_its_bytes(tmp_path):
    """Over two gloo ranks, ``all_mean_``'s span counts the float32 bytes
    of the concatenation it exchanges, and the tensors come back as the
    ranks' mean."""
    sizes = [3, 5, 7]
    run_world(spans_world, 2, tmp_path, {"sizes": sizes})
    for rank in range(2):
        got = json.loads((tmp_path / f"spans_r{rank}.json").read_text())
        assert got["spans"] == [["parallel.all_mean",
                                 {"bytes": 4 * sum(sizes)}]]
        assert got["mean"]


def test_train_steps_per_sec_leaves_out_the_warm_up(tmp_path, monkeypatch):
    """On a clock where the first chunk takes 100 s (the warm-up) and every
    later one 10 s: the first record keeps the rate since the run's start,
    each later one the steps since the first record over the seconds since
    its read-back."""
    cfg = CFG.replace(checkpoint_dir=str(tmp_path / "run"), log_every=2,
                      save_every=1000)
    m = 4
    records = {k: v.numpy() for k, v in _records(cfg, m).items()}
    records["gt_points"] = np.zeros((m, 1, 3), np.float32)
    ds = Dataset(records, cfg)
    clock = [1000.0]
    real = ttrain.train_steps_scan

    def timed(*a, **k):
        clock[0] += 100.0 if clock[0] == 1000.0 else 10.0
        return real(*a, **k)

    monkeypatch.setattr(ttrain.time, "time", lambda: clock[0])
    monkeypatch.setattr(ttrain, "train_steps_scan", timed)
    _, hist = ttrain.train(cfg, dataset=ds, max_steps=6, device="cpu",
                           use_checkpoints=False)
    assert [(h["step"], h["steps_per_sec"]) for h in hist] == [
        (2, pytest.approx(2 / 100)), (4, pytest.approx(2 / 10)),
        (6, pytest.approx(4 / 20))]
