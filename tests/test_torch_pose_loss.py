"""The predicted-pose loss branch of the port against dpcx's (CPU), through
the whole model from the same flax params and batch, in one variant per
sub-branch: pose from the views or the input view, both renderers, softmin,
the student warm-up, both anchor modes, consistency, translations, the rgb
candidate selection, the gauss splats.

Tolerances at f32: every metric rtol 1e-5 (atol 1e-6 for values near 0),
the winners equal, each parameter's gradient within 1e-4 relative L2 of
dpcx's (1e-6 absolute for a gradient that is ~0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcx.models.losses as jlosses
from dpcx.config import Config
from dpcx.data.dataset import Dataset as JDataset
from dpcx.models.model_pc import ModelPointCloud as JModel
from dpcx.train import _prep_batch
from dpcx.train import apply_model as j_apply_model
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import params_from_flax
from dpcx_torch.models import losses as tlosses
from dpcx_torch.models.model_pc import ModelPointCloud
from torch_workers import share_cores

share_cores()

POSE = Config(
    vox_size=16, mask_size=16, pc_num_points=256, image_size=16,
    encoder_filters=(8, 16), latent_dim=24, fc_hidden=32,
    pc_decoder_hidden=(32,), num_views=3, views_per_step=3, batch_size=2,
    compute_dtype="float32", pc_point_dropout=1.0, pc_relative_sigma=0.1,
    learning_rate=1e-4, predict_pose=True, pose_predict_num_candidates=4,
    pose_student=True, pose_student_weight=5.0, pose_from_views=True,
)


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_params(cfg):
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    return _np(JModel(cfg).init(jax.random.PRNGKey(1), dummy))


def _torch_model(cfg, flax_params):
    model = ModelPointCloud(_t(cfg))
    model.load_state_dict(params_from_flax(flax_params))  # strict
    return model


def _records(rng, cfg, models=4):
    """Random but well-formed records: blob masks, depths, unit quats."""
    V, D, S = cfg.num_views, cfg.vox_size, cfg.image_size
    yy, xx = np.mgrid[:D, :D] / D - 0.5
    r = rng.uniform(0.15, 0.35, (models, V, 1, 1))
    masks = ((yy**2 + xx**2) < r**2).astype(np.float32)
    q = rng.normal(size=(models, V, 4)).astype(np.float32)
    return {
        "images": rng.random((models, V, S, S, 3), np.float32),
        "masks": masks,
        "depths": np.where(masks > 0, rng.uniform(-0.3, 0.3, masks.shape),
                           1.0).astype(np.float32),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "gt_points": np.zeros((models, 1, 3), np.float32),
    }


LOSS_CASES = [
    ("pfv", {}, 0),
    ("input_view", {"pose_from_views": False}, 0),
    ("pfv_pallas", {"renderer": "pallas"}, 0),
    ("input_view_pallas_depth", {"pose_from_views": False,
                                 "renderer": "pallas", "proj_depth": True,
                                 "drc_weight": 0.5}, 0),
    ("softmin", {"pose_softmin_temp": 0.5, "pose_softmin_steps": 100}, 10),
    ("student_warmup", {"pose_student_warmup_steps": 100}, 30),
    ("anchor_full", {"pose_anchor_weight": 0.5, "pose_anchor_steps": 100},
     20),
    ("anchor_azimuth", {"pose_anchor_weight": 0.5,
                        "pose_anchor_mode": "azimuth"}, 0),
    ("consistency", {"pose_consistency_weight": 0.3}, 0),
    ("translation_pfv", {"predict_translation": True,
                         "translation_weight": 0.1}, 0),
    ("translation_input_view", {"predict_translation": True,
                                "translation_weight": 0.1,
                                "pose_from_views": False}, 0),
    ("rgb_normalised", {"pc_rgb": True, "rgb_sel_normalize": True,
                        "rgb_warmup_steps": 100}, 40),
    ("rgb_raw_input_view", {"pc_rgb": True, "rgb_sel_normalize": False,
                            "pose_from_views": False}, 0),
    ("gauss", {"pc_gauss": True, "pc_rgb": True, "gsplat_impl": "dense",
               "pose_predict_num_candidates": 2, "views_per_step": 2}, 0),
]


def _spy(monkeypatch, module, name, seen):
    """Record every output of module.name (a tracer under jit)."""
    orig = getattr(module, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("name,kw,step", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_predicted_pose_loss_matches_dpcx(name, kw, step, rng, monkeypatch):
    """The predicted-pose branch through the whole model (apply_model:
    per-view pose heads, the second-view decode) from the same flax
    params and batch: every metric, the winners, and the gradient of every
    parameter. ``renderer: pallas`` runs dpcx's Pallas kernels in
    interpret mode and the port's plain version of the fused renderer."""
    cfg = POSE.replace(**kw)
    cfg.validate()
    fp = _flax_params(cfg)
    ds = JDataset(_records(rng, cfg), cfg)
    b = ds.batch(np.random.default_rng((0, 1)), cfg.batch_size)
    jbatch = _prep_batch(b, cfg)
    tcfg = _t(cfg)
    tbatch = ttrain._prep_batch(b, "cpu", tcfg)
    assert tbatch.keys() == set(jbatch)

    # the winners: argmin's output on both sides, in the same forward
    seen_j, seen_t = [], []
    _spy(monkeypatch, jnp, "argmin", seen_j)
    _spy(monkeypatch, torch, "argmin", seen_t)

    def j_loss(params):
        preds = j_apply_model(cfg, JModel(cfg).apply, params, jbatch)
        total, metrics = jlosses.compute_loss(
            cfg, preds, jbatch, jnp.asarray(step), jax.random.PRNGKey(0),
            train=True)
        return total, (metrics, seen_j[-1])

    (_, (m_j, won_j)), g_j = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(fp)
    model = _torch_model(cfg, fp)
    preds = ttrain.apply_model(tcfg, model, tbatch)
    total, m_t = tlosses.compute_loss(tcfg, preds, tbatch, step, None,
                                      train=True)
    total.backward()
    assert len(seen_j) == len(seen_t) == 1
    np.testing.assert_array_equal(seen_t[0].numpy(), np.asarray(won_j))
    assert seen_t[0].shape == ((2, cfg.views_per_step) if cfg.pose_from_views
                               else (2,))
    assert m_t.keys() == set(m_j), name
    for k in m_t:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = params_from_flax(_np(g_j))
    for n, p in model.named_parameters():
        norm = np.linalg.norm(want[n].numpy())
        err = np.linalg.norm(p.grad.numpy() - want[n].numpy())
        assert err <= 1e-4 * norm + 1e-6, (n, err, norm)
