"""Whole runs of the tiny fixture cells on the CPU (the harness's look for a
card skipped), with the timed path sound and with it broken underneath:
``correct`` comes out true, then false for each fault the cell can have
and for the lower-precision controls. Without a card the harness refuses
to measure."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import calibrate, check, faults, harness, manifest, run
from benchmark.tests.conftest import make_root

ARGS = ["--seed", "123456789012", "--seconds", "0.5", "--trace", "0",
        "--device", "cpu"]
CELLS = [w["name"] for w in manifest.load()["workloads"]]
ONE_CHIP = [w["name"] for w in manifest.load()["workloads"]
            if w["chips"] == 1]


def result_of(root, workload, capsys) -> dict:
    assert run.main(["--workload", workload, *ARGS, "--root", str(root)]) \
        == 0
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    for name in result["checks"]:  # the checks end standard error
        assert f"check {name} " in out.err
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return result


def subprocess_result(root, argv) -> dict:
    env = {**os.environ, "PYTHONPATH": str(manifest.ROOT)}
    p = subprocess.run([sys.executable, *argv, *ARGS, "--root", str(root)],
                       capture_output=True, text=True, timeout=600,
                       cwd=manifest.ROOT, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.render"])
def test_sound_run_is_correct(tiny_root, workload, capsys):
    result = result_of(tiny_root, workload, capsys)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"] == {}  # no CPU number under a device metric
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("workload,mode", [
    ("tiny.train", "half_batch"), ("tiny.train", "half_loss"),
    ("tiny.train", "unchanged"),
    ("tiny.render", "altered"), ("tiny.render", "half_renders")])
def test_fault_is_not_correct(tiny_root, workload, mode, capsys):
    with faults.planted(mode):
        result = result_of(tiny_root, workload, capsys)
    assert result["correct"] is False


def test_data_parallel_run_over_two_ranks(tiny_root):
    result = subprocess_result(
        tiny_root, ["-m", "benchmark.run", "--workload", "tiny.train_dp2"])
    assert result["correct"] is True
    assert result["device"]["count"] == 2


def test_exchange_left_out_is_not_correct(tiny_root):
    result = subprocess_result(
        tiny_root, ["-m", "benchmark.faults", "--mode", "no_exchange",
                    "--workload", "tiny.train_dp2"])
    assert result["correct"] is False


def test_half_the_rows_left_out_over_two_ranks_is_not_correct(tiny_root):
    result = subprocess_result(
        tiny_root, ["-m", "benchmark.faults", "--mode", "half_loss",
                    "--workload", "tiny.train_dp2"])
    assert result["correct"] is False
    checks = result["checks"]  # every row rendered: half_gap sees it
    assert checks["half_gap"]["value"] > 0.5
    assert checks["points_gap"]["value"] <= checks["points_gap"]["limit"]


def test_forbidden_module_in_another_rank_is_refused(tiny_root, tmp_path):
    """Rank 1 alone loads a module named ``jax``: the run prints no result
    and exits nonzero."""
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "jax.py").write_text("")
    entry = tmp_path / "entry.py"
    entry.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(tmp_path / 'stub')!r})\n"
        "from benchmark import run\n"
        "if '--rank' in sys.argv:  # the ranks that rank 0 starts\n"
        "    import jax  # noqa: F401\n"
        f"sys.exit(run.main(sys.argv[1:], entry=[{str(entry)!r}]))\n")
    env = {**os.environ, "PYTHONPATH": str(manifest.ROOT)}
    p = subprocess.run([sys.executable, str(entry), "--workload",
                        "tiny.train_dp2", *ARGS, "--root", str(tiny_root)],
                       capture_output=True, text=True, timeout=600,
                       cwd=manifest.ROOT, env=env)
    assert p.returncode != 0 and p.stdout == ""
    assert "rank 1 of the run loaded ['jax']" in p.stderr


@pytest.mark.parametrize("workload,mode", [("tiny.train", "nets_fp8"),
                                           ("tiny.train", "render_bf16"),
                                           ("tiny.render", "render_bf16")])
def test_control_is_not_correct(tiny_root, workload, mode):
    """The lower precision below the configuration's, at a tiny size: the
    float8 nets (the tiny cell's nets are float32) and the renderer's
    bf16 mode."""
    cell = manifest.cell(workload, tiny_root)
    r = harness.Run(cell=cell, seed=424242, seconds=0.5, trace=False,
                    t_start=0.0, device="cpu")
    if cell.traffic["driver"] == "train":
        numbers = calibrate.train_numbers(r, mode)
    else:
        numbers = faults.render_numbers(r, mode)
    assert not check.verdict(numbers, cell.workload["limits"])[0]


@pytest.mark.parametrize("workload", CELLS)
def test_refuses_without_a_card(workload):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        workload, "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=manifest.ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "nothing measured" in p.stderr


def test_refuses_with_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the port is missing: no result, a nonzero exit."""
    make_root(tmp_path, [])
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], *ARGS], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        workload, "--seed", "97", "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=900, cwd=manifest.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert {m["name"] for m in manifest.cell(workload).end_to_end} == set(
        result["metrics"])
