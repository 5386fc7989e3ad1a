"""The predicted-pose cells: a tiny fixture cell (``tiny_pose.train``) run
whole on the CPU with the timed path sound, with each fault of the pose
path and the shared training faults planted underneath, and with the
lower-precision controls; ``train_mfu.pose``'s count by hand; the
benchmark's pose cell resolving with its metrics."""

from __future__ import annotations

import importlib.util
import json

import pytest

from benchmark import calibrate_pose, check, faults, faults_pose, harness, \
    manifest
from benchmark.tests.conftest import make_root
from benchmark.tests.test_benchmark_run import result_of

CELL = "chairpose.train_b512"
TINY = {"name": "tiny_pose.train", "config": "tiny_pose",
        "traffic": "tiny_pose_train", "chips": 1,
        "why": "a CPU test's predicted-pose training cell"}


@pytest.fixture(scope="module")
def pose_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench_pose"), [TINY])


def test_sound_run_is_correct(pose_root, capsys):
    result = result_of(pose_root, TINY["name"], capsys)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"] == {}  # no CPU number under a device metric
    assert {"select_gap", "quat_gap", "student_gap"} <= set(
        result["checks"])
    assert result["checks"]["select_gap"]["value"] == 0.0


@pytest.mark.parametrize("mode", faults_pose.MODES + (
    "half_batch", "half_loss", "unchanged"))
def test_fault_is_not_correct(pose_root, mode, capsys):
    with faults.planted(mode), faults_pose.planted(mode):
        result = result_of(pose_root, TINY["name"], capsys)
    assert result["correct"] is False


@pytest.mark.parametrize("mode", ["nets_fp8", "render_bf16"])
def test_control_is_not_correct(pose_root, mode):
    cell = manifest.cell(TINY["name"], pose_root)
    r = harness.Run(cell=cell, seed=424242, seconds=0.5, trace=False,
                    t_start=0.0, device="cpu")
    numbers = calibrate_pose.numbers(r, mode)
    assert not check.verdict(numbers, cell.workload["limits"])[0]


def _reader(name):
    path = manifest.ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_mfu_pose_by_hand():
    """Image 32, filters (8, 16), fc 16, latent 16, decoder (16,), N 64, K
    4 with a student, 2 samples of 3 target views from the views: 8
    images through the encoder and the pose head, 2 through the decoder;
    16 x 24 renders at D 16."""
    s = {"image_size": 32, "encoder_filters": [8, 16], "fc_hidden": 16,
         "latent_dim": 16, "pc_decoder_hidden": [16], "pc_num_points": 64,
         "pose_predict_num_candidates": 4, "pose_student": True,
         "pose_from_views": True, "compute_dtype": "float32",
         "vox_size": 16, "pc_relative_sigma": 0.08,
         "pc_relative_sigma_end": 0.02, "gauss_kernel_truncate": 2.5,
         "proj_depth": False, "pallas_acc_dtype": "float32"}
    conv0 = 2 * 16 * 16 * 8 * 3 * 9
    conv1 = 2 * 8 * 8 * 16 * 8 * 9
    image = conv0 + conv1 + 2 * (1024 * 16 + 16 * 16 + 16 * 256
                                 + 256 * 16 + 256 * 4)
    decode = 2 * (16 * 16 + 16 * 16 + 16 * 192 + 16 * 1)
    mod = _reader("train_mfu.pose")
    assert mod.forward_ops(s) == (image, decode, conv0)
    want = 3 * (8 * image + 2 * decode) - 8 * conv0
    assert mod.step_ops(s, 2, 3) == want
    assert mod.step_ops({**s, "pose_from_views": False}, 2, 3) \
        == 3 * (2 * image + 2 * decode) - 2 * conv0

    from benchmark import yardstick

    class Trace:
        window_s = 0.5

    ctx = harness.MetricContext(trace=Trace, units=10, settings=s, rows=2,
                                renders=2 * 4 * 3, weights=True)
    render_s = yardstick.render_peak_seconds(
        yardstick.render_step_work(s, 24, True), False)
    assert mod.read(ctx) == pytest.approx(
        100 * (want / yardstick.PEAK_F32_FLOPS + render_s) / 0.05)


def test_pose_cell_resolves_with_its_metrics():
    cell = manifest.cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "train_pose"
    s = cell.settings()
    assert (s["batch_size"], s["pose_predict_num_candidates"],
            s["views_per_step"], s["vox_size"]) == (512, 8, 4, 32)
    assert {m["name"] for m in cell.end_to_end} == {
        "train_samples_per_s", "train_step_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "pose_views_us", "pose_fanout_us", "pose_fanout_gbps",
        "pose_select_us", "train_mfu.pose", "device_idle_pct.pose",
        "launches_per_step.pose", "syncs_per_step.pose",
        "render_fwd_us.pose", "render_bwd_us.pose",
        "render_roofline_pct.pose"}
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    limits = cell.workload["limits"]
    assert {"select_gap", "quat_gap", "student_gap"} <= set(limits)
    assert all(isinstance(v, float) for v in limits.values())
    assert cell.workload["tie_margin"] > 0


def test_pose_config_is_the_shipped_yaml():
    import dataclasses

    from dpcx_torch.config import load_config

    entry = next(c for c in manifest.load()["configs"]
                 if c["name"] == "chair_pred_pose")
    doc = json.loads((manifest.ROOT / entry["file"]).read_text())
    shipped = dataclasses.asdict(load_config(
        manifest.ROOT / "experiments" / "chair_pred_pose.yaml"))
    assert doc["config"] == {k: list(v) if isinstance(v, tuple) else v
                             for k, v in shipped.items()}
    assert doc["reduced"] == entry["reduced"] == []
