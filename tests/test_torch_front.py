"""The renderer from world clouds (``render/fused.py::fused_project_world``)
on the CPU: against dpcx, and through its callers.

On CPU tensors the entry fans the clouds out to one row a render, runs
``pc_perspective_transform_t`` and then ``fused_project_t``'s plain
version: the function that the card's kernels, which run the camera
transform in their splat stages, are held to
(``tests/test_torch_front_cuda.py``). Here it is held to dpcx on the same
inputs: ``jnp.repeat`` of the clouds, dpcx's ``pc_perspective_transform_t``
and ``pallas_project_t`` in interpret mode, forward and VJP (d points, d
weights, d quat through ``quaternion_to_matrix``, d translation), at every
grid size's kernel family and in both operand modes. dpcx's side runs in
one subprocess with ``--xla_allow_excess_precision=false``, as in
``tests/test_torch_bf16.py`` (in-process XLA:CPU keeps f32 where the
kernels type bfloat16).

Bounds. f32: sil and depth atol 2e-5 (``tests/test_torch_render.py``'s
bound for the plain version against the Pallas kernel); each gradient
within 1e-5 of the largest of dpcx's (f32 sums in other orders; d quat
and d translation sum a render's points, so an absolute bound would not
carry across them). bfloat16: within 0.25 of the distance between
dpcx-bf16 and dpcx-f32 from dpcx-bf16 (max abs for sil and depth,
relative L2 for the gradients), ``tests/test_torch_bf16.py``'s bound.
In the bfloat16 cases dpcx renders the port's coordinates and chains
its transform's VJP onto its renderer's: the two transforms sum the
rotation in other orders (45% of the coordinates differ, by up to
2.1e-7, at 32 renders x 24 points), and a coordinate an ulp away can
flip a rounded hat, which put the port's sil 0.38 of the modes' distance
from dpcx-bf16 there. The f32 cases hold the transforms to each other.

The GT-pose and predicted-pose losses must give the same loss and
gradients through the entry as through the composition handed in as
``project_fn``, and ``render.project`` counts where the transform ran.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpcx_torch.config import Config
from dpcx_torch.models import losses
from dpcx_torch.render import fused
from dpcx_torch.render.project import pointcloud_project_fn
from dpcx_torch.render.transform import (
    CAMERA_DISTANCE as DIST,
    FOCAL_LENGTH as FOCAL,
    pc_perspective_transform_t,
)
from dpcx_torch.utils import profiling
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
F32_SHARE, BF16_SHARE = 1e-5, 0.25
LEAVES = ("points", "pw", "quat", "trans")

# (clouds C, renders per cloud S, points N, D, acc_dtype, translation,
# keep weights, depth): S 1 / 4 / 32, D 32 / 64 / 128 (K1/K2 below 64,
# K3-K5 above), both operand modes
CASES = [
    (2, 1, 64, 32, "float32", False, True, True),
    (2, 4, 64, 32, "bfloat16", True, True, False),
    (1, 32, 24, 32, "float32", True, False, True),
    (1, 32, 24, 32, "bfloat16", False, True, True),
    (2, 4, 48, 64, "float32", True, True, True),
    (1, 4, 48, 64, "bfloat16", False, False, False),
    (1, 1, 40, 128, "float32", True, True, False),
    (1, 2, 400, 128, "bfloat16", True, True, True),
]
NAMES = [f"C{c}-S{s}-N{n}-D{v}-{a}" for c, s, n, v, a, *_ in CASES]

DPCX_SCRIPT = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
from dpcx.render.pallas_kernel import pallas_project_t
from dpcx.render.transform import pc_perspective_transform_t

inp = dict(np.load(sys.argv[1]))
out = {}
for name in inp["names"]:
    name = str(name)
    vox, radius, depth, fan = (int(v) for v in inp[name + "__meta"])
    focal, dist, sigma = (float(v) for v in inp[name + "__camera"])
    leaves = [k for k in ("points", "pw", "quat", "trans")
              if name + "__" + k in inp]
    args = [jnp.asarray(inp[name + "__" + k]) for k in leaves]
    modes = [str(m) for m in inp[name + "__modes"]]

    def transform(*a):
        kw = dict(zip(leaves, a))
        pw = kw.get("pw")
        ndc = pc_perspective_transform_t(
            jnp.repeat(kw["points"], fan, axis=0), kw["quat"], focal, dist,
            kw.get("trans"))
        return ndc, None if pw is None else jnp.repeat(pw, fan, axis=0)

    for acc in modes:
        def render(ndc, pw):
            sil, dep = pallas_project_t(
                ndc, vox, jnp.float32(sigma), radius, point_weights=pw,
                with_depth=bool(depth), acc_dtype=acc, interpret=True)
            return (sil, dep) if depth else (sil,)

        cts = (jnp.asarray(inp[name + "__dsil"]),)
        if depth:
            cts += (jnp.asarray(inp[name + "__ddepth"]),)
        if name + "__ndc" in inp:  # the port's coordinates, then the chain
            (ndc, pw), vjp_t = jax.vjp(transform, *args)
            prim, vjp_r = jax.vjp(render, jnp.asarray(inp[name + "__ndc"]),
                                  pw)
            grads = vjp_t(vjp_r(cts))
        else:
            prim, vjp = jax.vjp(lambda *a: render(*transform(*a)), *args)
            grads = vjp(cts)
        out[f"{name}__{acc}__sil"] = np.asarray(prim[0])
        out[f"{name}__ndc"] = np.asarray(transform(*args)[0])
        if depth:
            out[f"{name}__{acc}__depth"] = np.asarray(prim[1])
        for k, g in zip(leaves, grads):
            out[f"{name}__{acc}__d_{k}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
"""


def _inputs(case):
    C, S, N, vox, acc, translation, weights, depth = case
    rng = np.random.default_rng(C * 1000 + S * 10 + vox)
    R = C * S
    inp = {
        "points": ((rng.random((C, N, 3)) - 0.5) * 0.8).astype(np.float32),
        "quat": rng.normal(size=(R, 4)).astype(np.float32),
        "dsil": rng.normal(size=(R, vox, vox)).astype(np.float32),
        "ddepth": rng.normal(size=(R, vox, vox)).astype(np.float32),
        "camera": np.array([FOCAL, DIST, 0.06 * vox], np.float32),
        "meta": np.array([vox, max(2, vox // 16), int(depth), S]),
        "modes": np.array(["float32"] + (["bfloat16"] if acc == "bfloat16"
                                         else [])),
    }
    if weights:
        inp["pw"] = rng.random((C, N)).astype(np.float32)
    if translation:
        inp["trans"] = (rng.normal(size=(R, 3)) * 0.05).astype(np.float32)
    if acc == "bfloat16":
        inp["ndc"] = pc_perspective_transform_t(
            torch.from_numpy(inp["points"]).repeat_interleave(S, dim=0),
            torch.from_numpy(inp["quat"]), FOCAL, DIST,
            torch.from_numpy(inp["trans"]) if translation else None).numpy()
    return inp


@pytest.fixture(scope="module")
def dpcx_results(tmp_path_factory):
    """dpcx's forward and VJP of every case (bfloat16 cases in both modes),
    from one subprocess with excess precision off."""
    tmp = tmp_path_factory.mktemp("front")
    arrays = {"names": np.array(NAMES)}
    inputs = {}
    for name, case in zip(NAMES, CASES):
        inputs[name] = _inputs(case)
        for k, v in inputs[name].items():
            arrays[f"{name}__{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", DPCX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return inputs, {k: f[k] for k in f.files}


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_world_entry_is_the_composition(case, dpcx_results):
    """The entry's CPU route against dpcx's transform and Pallas kernel on
    the same inputs, forward and every gradient, within the module's
    bounds."""
    C, S, N, vox, acc, translation, weights, depth = case
    name = NAMES[CASES.index(case)]
    inputs, ref = dpcx_results
    inp = inputs[name]
    leaves = {k: torch.from_numpy(inp[k]).requires_grad_()
              for k in LEAVES if k in inp}
    if acc == "float32":  # the port's transform against dpcx's
        ndc_t = pc_perspective_transform_t(
            leaves["points"].repeat_interleave(S, dim=0), leaves["quat"],
            FOCAL, DIST, leaves.get("trans")).detach().numpy()
        np.testing.assert_allclose(ndc_t, ref[f"{name}__ndc"], rtol=0,
                                   atol=1e-6)
    vox_, radius = int(inp["meta"][0]), int(inp["meta"][1])
    sil, dep = fused.fused_project_world(
        leaves["points"], leaves["quat"], vox_,
        torch.tensor(inp["camera"][2]), radius,
        point_weights=leaves.get("pw"), translation=leaves.get("trans"),
        focal_length=FOCAL, camera_distance=DIST, with_depth=depth,
        acc_dtype=acc)
    assert sil.shape == (C * S, vox, vox)
    assert (dep is None) == (not depth)
    loss = (sil * torch.from_numpy(inp["dsil"])).sum()
    if depth:
        loss = loss + (dep * torch.from_numpy(inp["ddepth"])).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = {"sil": sil.detach().numpy()}
    if depth:
        got["depth"] = dep.detach().numpy()
    got.update({f"d_{k}": g.numpy() for k, g in zip(leaves, grads)})
    for key, a in got.items():
        want = ref[f"{name}__{acc}__{key}"]
        assert np.abs(want).max() > 0, key
        if acc == "float32":
            if key in ("sil", "depth"):
                np.testing.assert_allclose(a, want, atol=2e-5, err_msg=key)
            else:
                err = np.abs(a - want).max()
                assert err <= F32_SHARE * np.abs(want).max(), (key, err)
            continue
        f32 = ref[f"{name}__float32__{key}"]
        if key in ("sil", "depth"):
            err, dist = np.abs(a - want).max(), np.abs(want - f32).max()
        else:
            norm = np.linalg.norm(want)
            err = np.linalg.norm(a - want) / norm
            dist = np.linalg.norm(want - f32) / norm
        print(f"{name} {key}: port vs dpcx-bf16 {err:.3e}, dpcx-bf16 vs "
              f"dpcx-f32 {dist:.3e}")
        assert dist > 1e-4, (key, dist)  # the modes do differ
        assert err <= BF16_SHARE * dist, (key, err, dist)


def _scene(C, S, N, translation, weights, seed):
    g = torch.Generator().manual_seed(seed)
    R = C * S
    points = (torch.rand(C, N, 3, generator=g) - 0.5) * 0.8
    quat = torch.randn(R, 4, generator=g)
    pw = torch.rand(C, N, generator=g) if weights else None
    trans = (torch.randn(R, 3, generator=g) * 0.05) if translation else None
    return points, quat, pw, trans


def test_world_entry_refuses_bad_shapes():
    points, quat, pw, trans = _scene(2, 3, 16, True, True, 7)
    sigma = torch.tensor(1.0)
    with pytest.raises(ValueError, match="multiple"):
        fused.fused_project_world(points, quat[:5], 16, sigma, 2)
    with pytest.raises(ValueError, match=r"points must be \[C, N, 3\]"):
        fused.fused_project_world(points[..., :2], quat, 16, sigma, 2)
    with pytest.raises(ValueError, match="point_weights"):
        fused.fused_project_world(points, quat, 16, sigma, 2,
                                  point_weights=pw[:, :8])
    with pytest.raises(ValueError, match="translation"):
        fused.fused_project_world(points, quat, 16, sigma, 2,
                                  translation=trans[:2])


def _cfg(**overrides) -> Config:
    return Config(
        vox_size=16, mask_size=16, pc_num_points=64, num_views=3,
        views_per_step=3, batch_size=2, renderer="pallas",
        pc_relative_sigma=0.1, pc_point_dropout=1.0,
    ).replace(**overrides)


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    B, V, D = cfg.batch_size, cfg.views_per_step, cfg.vox_size
    q = torch.randn(B, V, 4, generator=g)
    return {"masks": (torch.rand(B, V, D, D, generator=g) > 0.6).float(),
            "depths": torch.rand(B, V, D, D, generator=g) - 0.5,
            "quats": q / q.norm(dim=-1, keepdim=True),
            "quat_in": torch.randn(B, 4, generator=g)}


def _loss_and_grads(cfg, preds, batch, project_fn):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in preds.items()}
    total, metrics = losses.compute_loss(cfg, leaves, batch, step=5,
                                         train=False, project_fn=project_fn)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return total, metrics, {k: g for k, g in zip(leaves, grads)
                            if g is not None}


@pytest.mark.parametrize("branch", ["gt_pose", "predicted_pose"])
def test_losses_through_the_world_entry(branch):
    """Both loss branches give, through ``fused_project_world`` (the
    default route), the loss, metrics and gradients of the composition
    handed in as ``project_fn`` (the torch transform, then
    ``fused_project_t``)."""
    g = torch.Generator().manual_seed(3)
    if branch == "gt_pose":
        cfg = _cfg(proj_depth=True, drc_weight=0.5)
        preds = {"points": (torch.rand(2, 64, 3, generator=g) - 0.5) * 0.8}
    else:
        cfg = _cfg(predict_pose=True, pose_predict_num_candidates=4,
                   pose_from_views=True, predict_translation=True,
                   translation_weight=0.1)
        preds = {"points": (torch.rand(2, 64, 3, generator=g) - 0.5) * 0.8,
                 "quats_views": torch.randn(2, 3, 4, 4, generator=g),
                 "translation": torch.randn(2, 4, 3, generator=g) * 0.05,
                 "translations_views":
                     torch.randn(2, 3, 4, 3, generator=g) * 0.05}
    batch = _batch(cfg, 4)
    got = _loss_and_grads(cfg, preds, batch, None)
    want = _loss_and_grads(cfg, preds, batch, fused.fused_project_t)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        torch.testing.assert_close(got[1][k], want[1][k], rtol=0, atol=0)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert float(want[2][k].abs().max()) > 0, k
        torch.testing.assert_close(got[2][k], want[2][k], rtol=0, atol=0)


@pytest.mark.parametrize("renderer", ["pallas", "xla"])
def test_project_span_counts_the_front(renderer):
    """On either renderer each ``pointcloud_project_fn`` call opens one
    ``render.project`` span, which counts nothing: the route the camera
    transform takes is the configuration's, not a span's to record."""
    cfg = _cfg(renderer=renderer)
    points, quat, _, _ = _scene(6, 1, 64, False, False, 11)
    profiling.RECORDER.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            pointcloud_project_fn(cfg, points, quat, torch.tensor(0.1))
    spans = [s for s in profiling.RECORDER.finished()
             if s.name == "render.project"]
    assert [s.counts for s in spans] == [{}, {}]
    assert all(s.parent is None for s in spans)
