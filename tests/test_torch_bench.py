"""The port's bench verb and measuring tools on the CPU
(``dpcx_torch/bench.py``, ``utils/timing.py``, ``utils/profiling.py``):
the verb's record and exit code, the timing loop's carry dependency, the
trace, and the H100 bounds against PERF.md's kernel table.

The bounds are pure arithmetic on the shapes (and, for the splats, on the
z-ranges of seeded inputs), so they must give the table's numbers to the
digits it prints.
"""

import json
import math

import numpy as np
import pytest
import torch

from dpcx_torch import bench, cli
from dpcx_torch.config import Config
from dpcx_torch.render import aniso
from dpcx_torch.render.gsplat import splat_params
from dpcx_torch.utils import profiling, timing
from torch_workers import share_cores

share_cores()

TINY = bench.Shapes(renders=1, points=64, iters=1, extras=False)


def _run_cli(capsys, argv):
    code = 0
    try:
        cli.main(argv)
    except SystemExit as e:
        code = e.code
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return code, json.loads(lines[0])


def test_cli_bench_cpu_prints_dpcx_keys(capsys):
    """`bench --device cpu` prints one JSON line: dpcx's CPU keys, the
    port's host value, time and H100 bound beside the value, parity in
    both modes, and exits 0; no kernel launches on the CPU."""
    code, rec = _run_cli(capsys, ["bench", "--device", "cpu"])
    assert code == 0
    assert rec["metric"] == bench.METRIC and rec["unit"] == "Mpoints/s"
    assert rec["device"] == "cpu"
    for key in ("value", "value_host", "value_ms", "value_bound"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    # the bound is the card's, so no share of it is read on the CPU
    assert rec["value_share"] is None
    assert rec["value_bound_by"] in ("bytes", "operations")
    assert rec["value_launches"] == {}
    assert rec["parity_ok"] is True
    assert set(rec["parity"]) == {"float32", "bfloat16"}
    assert not [k for k in rec if k.endswith("_error")]
    assert "fp32_value" not in rec  # the CPU runs the headline alone


def test_bench_exits_1_when_parity_fails(capsys, monkeypatch):
    """Tolerances of 0 fail parity: the record is printed with parity_ok
    false, and the verb exits 1."""
    monkeypatch.setattr(bench, "CPU", TINY)
    monkeypatch.setattr(bench, "SIL_TOL", {"float32": 0.0, "bfloat16": 0.0})
    monkeypatch.setattr(bench, "GRAD_TOL", {"float32": 0.0, "bfloat16": 0.0})
    code, rec = _run_cli(capsys, ["bench", "--device", "cpu"])
    assert code == 1
    assert rec["parity_ok"] is False
    assert not any(v["ok"] for v in rec["parity"].values())
    assert rec["value"] > 0


def test_bench_exits_1_when_a_key_errs(capsys, monkeypatch):
    """A key that raises is recorded as null with its error, the run goes
    on to parity, and the verb exits 1: no error is swallowed."""
    monkeypatch.setattr(bench, "CPU", TINY)

    def broken(*a, **k):
        raise RuntimeError("kernel did not build")

    monkeypatch.setattr(bench, "measure", broken)
    code, rec = _run_cli(capsys, ["bench", "--device", "cpu"])
    assert code == 1
    assert rec["value"] is None
    assert rec["value_error"] == "RuntimeError: kernel did not build"
    assert rec["parity_ok"] is True
    assert bench.failed(rec) == ["value_error"]


def test_bench_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    """cuda is the default; without a card the bench raises, it does not
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.bench(torch.device("cuda"), TINY)


@pytest.mark.parametrize("repeats", [1, 3])
def test_bench_scan_keeps_the_carry(repeats):
    """bench_scan on the CPU: a positive time per iteration; every
    iteration reads the carry the one before returned, each run starts
    from carry0, and the untimed run comes first."""
    iters, seen = 4, []

    def body(carry, step):
        seen.append(float(carry))
        return carry + step, carry * 2

    sec = timing.bench_scan(body, torch.tensor(1.0), (torch.tensor(0.5),),
                            iters=iters, repeats=repeats)
    assert sec > 0 and math.isfinite(sec)
    one_run = [1.0 + 0.5 * i for i in range(iters)]
    assert seen == one_run * (1 + repeats)
    times = timing.scan_times(body, torch.tensor(1.0), (torch.tensor(0.5),),
                              iters=iters, repeats=repeats)
    assert times.device is None and len(times.host) == repeats
    assert times.best == min(times.host) and times.host_median > 0


@pytest.mark.parametrize("backward", [False, True])
def test_render_throughput_on_cpu(backward):
    """render_throughput_mpts through the plain renderer: positive and
    finite, forward and forward + backward."""
    cfg = Config(vox_size=16, pc_num_points=128, renderer="pallas",
                 proj_depth=False)
    pts, quat = bench._inputs(2, 128, device="cpu")
    mpts = timing.render_throughput_mpts(cfg, pts, quat, torch.tensor(0.02),
                                         iters=2, backward=backward)
    assert math.isfinite(mpts) and mpts > 0


def test_profiling_on_cpu(tmp_path):
    """trace writes one Chrome trace of the block into its directory."""
    x = torch.ones(64, 64)
    with profiling.trace(tmp_path / "prof") as log_dir:
        (x @ x).sum()
    (path,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# PERF.md's kernel table: the bound column, ms to 4 decimals. Renders:
# car_64 32 x 16000, D 64, R 8, depth; pose 256 x 2048, D 32, R 6;
# multicat 16 x 16000, D 128, R 16; all with point weights
RENDER_BOUNDS = [
    ("K1 f32 car_64", (32, 16000, 64, 8, True, True, False, False), 0.0134),
    ("K1 f32 pose", (256, 2048, 32, 6, False, True, False, False), 0.0098),
    ("K2 f32 car_64", (32, 16000, 64, 8, True, True, True, False), 0.0152),
    ("K2 f32 pose", (256, 2048, 32, 6, False, True, True, False), 0.0153),
    ("K3 f32 multicat", (16, 16000, 128, 16, False, True, False, False),
     0.0959),
    ("K5 f32 multicat", (16, 16000, 128, 16, False, True, True, False),
     0.1002),
    ("K1 bf16 pose", (256, 2048, 32, 6, False, True, False, True), 0.0028),
    ("K1 bf16 car_64", (32, 16000, 64, 8, True, True, False, True), 0.0028),
    ("K2 bf16 pose", (256, 2048, 32, 6, False, True, True, True), 0.0053),
    ("K2 bf16 car_64", (32, 16000, 64, 8, True, True, True, True), 0.0052),
    ("K3 bf16 multicat", (16, 16000, 128, 16, False, True, False, True),
     0.0093),
    ("K5 bf16 multicat", (16, 16000, 128, 16, False, True, True, True),
     0.0196),
]


@pytest.mark.parametrize("args,want", [r[1:] for r in RENDER_BOUNDS],
                         ids=[r[0] for r in RENDER_BOUNDS])
def test_render_bound_gives_the_table(args, want):
    ms, by = bench.render_bound(*args)
    assert round(ms, 4) == want
    assert by in ("bytes", "operations")


# csrc/prng.cu's draws at the car_64_depth step's shapes (PERF.md's table
# of the draw kernels): least us a launch, and its limit
@pytest.mark.parametrize("kind,shape,want_us,want_by", [
    ("dropout_weights", (8, 16000), 0.3286, "operations"),
    ("batch_draws", (8, 5, 4), 0.000181, "operations"),
], ids=["dropout_weights", "batch_draws"])
def test_draw_bound_gives_the_table(kind, shape, want_us, want_by):
    ms, by = bench.draw_bound(kind, *shape)
    assert float(f"{ms * 1e3:.4g}") == want_us and by == want_by


def test_draw_bound_counts_the_alu_pipe():
    """The dropout weights' bound is the ALU pipe's: 43 shifts and logic
    operations an element at PEAK_F32_FLOPS / 4, more than all 73 at the
    dispatch rate; a larger batch scales it, the bytes do not bind."""
    ms, by = bench.draw_bound("dropout_weights", 8, 16000)
    assert ms == pytest.approx(8 * 16000 * 43 / (bench.PEAK_F32_FLOPS / 4)
                               * 1e3, rel=1e-12)
    assert 8 * 16000 * 73 / (bench.PEAK_F32_FLOPS / 2) * 1e3 < ms
    assert bench.draw_bound("dropout_weights", 16, 16000)[0] == \
        pytest.approx(2 * ms, rel=1e-12)


@pytest.fixture(scope="module")
def rgb_splats_case():
    """chip_smoke.py's phase 3b inputs at the rgb_splats render (32 x 4096,
    D 32, seed 10, dropout keep 0.1), drawn on the CPU, and the
    point-cells of their z-ranges."""
    renders, n, vox = 32, 4096, 32
    rng = np.random.default_rng(10)
    q = rng.normal(size=(renders, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pw = rng.uniform(size=(renders, n)) * (
        rng.random((renders, n)) < 0.1) / 0.1
    pts, scales, rot, pw, rgb = (
        torch.tensor(a, dtype=torch.float32) for a in (
            rng.uniform(-0.45, 0.45, (renders, n, 3)),
            rng.uniform(0.005, 0.06, (renders, n, 3)), q, pw,
            rng.uniform(size=(renders, n, 3))))
    mu, _, _, rz = splat_params(pts, scales, rot, vox, pw)
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, vox)
    return dict(rgb=rgb, vox=vox, renders=renders, n=n,
                point_cells=int((z_hi - z_lo).sum()) * vox * vox)


@pytest.mark.parametrize("backward,bf16,want", [
    (False, False, 0.3953), (True, False, 0.7569),
    (False, True, 0.1891), (True, True, 0.5300)],
    ids=["K6 f32", "K7 f32", "K6 bf16", "K7 bf16"])
def test_aniso_bound_gives_the_table(rgb_splats_case, backward, bf16, want):
    ms, by = bench.aniso_bound(rgb_splats_case, backward, bf16)
    assert round(ms, 4) == want and by == "operations"
