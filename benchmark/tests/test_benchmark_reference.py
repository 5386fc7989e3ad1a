"""The plain reference agrees with the port at a tiny size on the CPU: the
random draws bit for bit, the renderer and the model within float32's
rounding, the training steps within it too."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import data
from benchmark.drivers.train import config
from benchmark.reference import model, prng, render
from benchmark.tests.conftest import FIXTURES

SETTINGS = json.loads((FIXTURES / "configs" / "tiny.json").read_text())[
    "config"]


@pytest.mark.parametrize("step", [0, 1, 9999, 2**31 - 1])
def test_draws_bitwise(step):
    from dpcx_torch.utils import prng as port

    key = prng.prng_key(123456789012 + 1)
    assert key == port.prng_key(123456789012 + 1)
    assert prng.fold_in(key, step) == port.fold_in(key, step)
    kk = prng.fold_in(key, step)
    assert prng.split(kk, 4) == port.split(kk, 4)
    rows, k_drop = prng.batch_rows(key, step, 6, 32, 5, 4, "cpu")
    k_m, k_vin, k_tgt, k_drop2 = port.split(kk, 4)
    want = port.batch_draws_plain(k_m, k_vin, k_tgt, None, 6, 32, 5, 4)
    assert k_drop == k_drop2
    assert torch.equal(rows, torch.cat([want[:, :1], want[:, 2:]], dim=1))
    w = prng.dropout_weights(k_drop, 3, 50, 0.1, "cpu")
    assert torch.equal(w, port.dropout_weights_plain(k_drop, 3, 50, 0.1))


def _clouds():
    inp = data.clouds(5, 1, 3, 200, "cpu")[0]
    ct = data.cotangents(5, 1, 3, SETTINGS["vox_size"], "cpu")[0]
    return inp, ct


@pytest.mark.parametrize("weighted", [False, True])
def test_renderer_against_the_port(weighted):
    from dpcx_torch.render.project import pointcloud_project_fn

    inp, ct = _clouds()
    sigma = torch.tensor(0.05)
    w = (torch.rand(3, 200, generator=torch.Generator().manual_seed(0)) * 2
         if weighted else None)
    got = []
    for fn in (lambda p: render.render(SETTINGS, p, inp["quats"], sigma, w),
               lambda p: (lambda o: (o.silhouette, o.depth))(
                   pointcloud_project_fn(config(SETTINGS).replace(
                       renderer="xla"), p, inp["quats"], sigma, w))):
        pts = inp["points"].clone().requires_grad_(True)
        sil, depth = fn(pts)
        (g,) = torch.autograd.grad([sil, depth], pts,
                                   [ct["silhouette"], ct["depth"]])
        got.append((sil, depth, g))
    (rs, rd, rg), (ps, pd, pg) = [[t.detach() for t in x] for x in got]
    assert float((rs - ps).abs().max()) < 1e-5
    assert float((rd - pd).abs().max()) < 1e-5
    assert float((rg - pg).norm() / rg.norm()) < 1e-4


def test_model_against_the_port():
    from dpcx_torch.models.model_pc import ModelPointCloud

    cfg = config(SETTINGS)
    port = ModelPointCloud(cfg, device="cpu")
    named = dict(port.named_parameters())
    w = data.weights(3, {k: tuple(p.shape) for k, p in named.items()}, "cpu")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(w[k])
    images = data.records(3, 2, 2, 32, 16, "cpu")["images"].flatten(0, 1)
    want = port(images)["points"]
    got = model.forward(SETTINGS, w, images)
    assert float((got - want).abs().max()) < 1e-6


def test_training_steps_against_the_port():
    from dpcx_torch.train import create_state, train_steps_scan

    settings = {**SETTINGS, "batch_size": 4}
    cfg = config(settings)
    state = create_state(cfg, "cpu")
    named = dict(state.model.named_parameters())
    w = data.weights(9, {k: tuple(p.shape) for k, p in named.items()}, "cpu")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(w[k])
    recs = data.records(9, 6, 5, 32, 16, "cpu")
    key = prng.prng_key(10)
    losses = [float(train_steps_scan(cfg, state, recs, key, 1)["loss_total"])
              for _ in range(2)]
    ref = model.train_steps(settings, w, recs, key, 2)
    assert ref["losses"] == pytest.approx(losses, rel=1e-5)
    for k, p in named.items():
        assert float((p - ref["params"][k]).abs().max()) < 1e-6, k
