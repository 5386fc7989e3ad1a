"""The port's predicted-pose training step against the benchmark's plain
reference of the pose path (``benchmark/reference/pose.py``) on the CPU, at
a small size of ``chair_pred_pose`` (image 32, N 64, D 16, K 4, V 2, B 4)
with seeded random weights, its nets in float32, from the input view's
pose and from the views': two steps of ``train_steps_scan`` (``update``)
and of the reference from the same records, weights and stream.

Compared: each step's loss (1e-5 relative), the winners (equal wherever
the reference's best two scores lie more than ``TIE`` apart: the
reference follows the program's scores inside that band, as in the
benchmark), the first step's student loss (1e-5 relative), every
parameter's first gradient (1e-4 relative L2, as test_torch_pose_loss.py
holds the port to dpcx; 1e-6 absolute for a gradient that is ~0) and the
parameters after the two Adam steps (1e-6 absolute). Each of
``benchmark/faults_pose.py``'s faults, planted in the port, fails the
comparison.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from benchmark import data, faults_pose
from benchmark.drivers import train_pose
from benchmark.reference import pose as ref_pose
from benchmark.reference import prng as ref_prng
from dpcx_torch import train as ttrain
from dpcx_torch.config import load_config
from dpcx_torch.models import losses
from torch_workers import share_cores

share_cores()

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(image_size=32, encoder_filters=(8, 16), latent_dim=16,
             fc_hidden=16, pc_decoder_hidden=(16,), pc_num_points=64,
             vox_size=16, mask_size=16, pose_predict_num_candidates=4,
             num_views=3, views_per_step=2, batch_size=4, log_every=2,
             compute_dtype="float32")
TIE = 1e-5  # score gaps at f32: the program's and the reference's ~1e-7
STEPS, SEED = 2, 4321
SCORES = losses.candidate_scores


def _cfg(pose_from_views: bool):
    return load_config(ROOT / "experiments" / "chair_pred_pose.yaml") \
        .replace(pose_from_views=pose_from_views, **SMALL)


def _settings(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def _inputs(cfg):
    state = ttrain.create_state(cfg, "cpu", seed=0)
    named = dict(state.model.named_parameters())
    w0 = data.weights(SEED, {k: tuple(p.shape) for k, p in named.items()},
                      "cpu")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(w0[k])
    records = data.records(SEED, 6, cfg.num_views, cfg.image_size,
                           cfg.mask_size, "cpu")
    return state, w0, records, ref_prng.prng_key(SEED + 1)


def _program(cfg, state, records, key) -> dict:
    """``STEPS`` steps of the port, one call each: {"losses", "scores"
    (each step's, as the benchmark's driver records them), "student1",
    "grad1", "params"}."""
    scores = []
    out = {"losses": [], "scores": scores}
    for t in range(STEPS):
        with train_pose.observed(scores):
            metrics = ttrain.train_steps_scan(cfg, state, records, key, 1)
        out["losses"].append(float(metrics["loss_total"]))
        if t == 0:
            out["student1"] = float(metrics["loss_student"])
            out["grad1"] = {k: p.grad.clone()
                            for k, p in state.model.named_parameters()}
    out["params"] = {k: p.detach().clone()
                     for k, p in state.model.named_parameters()}
    return out


def _misses(prog: dict, ref: dict) -> list[str]:
    """What of the program the reference does not bear out."""
    out = []
    for t, (a, b) in enumerate(zip(prog["losses"], ref["losses"])):
        if abs(a - b) > 1e-5 * abs(b):
            out.append(f"loss of step {t}: {a} against {b}")
    if ref["differ"] or not ref["outside"]:
        out.append(f"winners: {ref['differ']} of {ref['outside']} differ")
    for t, (s, w) in enumerate(zip(prog["scores"], ref["winners"])):
        two = torch.topk(ref["scores"][t], 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > TIE
        if not torch.equal(torch.argmin(s, dim=1)[clear], w[clear]):
            out.append(f"winners of step {t}")
    if abs(prog["student1"] - ref["student1"]) > 1e-5 * ref["student1"]:
        out.append(f"student loss {prog['student1']} against "
                   f"{ref['student1']}")
    for k, g in ref["grad1"].items():
        d = float((prog["grad1"][k] - g).norm())
        if d > max(1e-4 * float(g.norm()), 1e-6):
            out.append(f"gradient of {k}: {d} from {float(g.norm())}")
    for k, p in ref["params"].items():
        d = float((prog["params"][k] - p).abs().max())
        if d > 1e-6:
            out.append(f"{k} after {STEPS} steps: {d}")
    return out


def _compare(cfg, mode: str = "sound") -> list[str]:
    state, w0, records, key = _inputs(cfg)
    with faults_pose.planted(mode):
        prog = _program(cfg, state, records, key)
    assert losses.candidate_scores is SCORES  # nothing planted stays
    ref = ref_pose.train_steps(_settings(cfg), w0, records, key, STEPS,
                               follow=prog["scores"], tie_margin=TIE)
    return _misses(prog, ref)


@pytest.mark.parametrize("pose_from_views", [True, False],
                         ids=["from_views", "input_view"])
def test_update_matches_the_reference(pose_from_views):
    assert _compare(_cfg(pose_from_views)) == []


@pytest.mark.parametrize("mode", faults_pose.MODES)
def test_planted_fault_fails_the_comparison(mode):
    misses = _compare(_cfg(True), mode)
    assert misses, mode
    if mode == "live_teacher":  # the same winners, other gradients
        assert any(m.startswith("gradient of pose_head") for m in misses)
    else:
        assert any(m.startswith("winners") for m in misses)


def test_reference_refuses_what_it_leaves_out():
    settings = _settings(_cfg(True).replace(proj_depth=True))
    with pytest.raises(ValueError, match="proj_depth"):
        ref_pose.supported(settings)
