"""The fused renderer's bfloat16 operand mode above D 64 (the depth-blocked
kernels: K3 forward, K4 + K5 backward) against dpcx's Pallas kernels in
that mode (CPU), and one bfloat16 training step at D 72.

As in ``tests/test_torch_bf16.py``, dpcx's side runs in one module-scoped
subprocess with ``--xla_allow_excess_precision=false`` (XLA:CPU otherwise
keeps f32 where the kernels type bfloat16), in interpret mode, in both
modes, and the results come back through an npz.

D 72 gives dpcx's blocked kernels z-blocks of 8 rows (``blocked_params``)
and, at sigma 0.05 D, a blur radius of 9: a raw row lies in the halo of up
to 4 blocks, and K5 rounds each block's partial z transpose on its own.
Half the points lie on a dense shell, so rays saturate.

Bound: the port's plain bfloat16 version is at most 0.25 x the distance
between dpcx-bf16 and dpcx-f32 from dpcx-bf16 (max abs for sil and depth,
relative L2 for the gradients; for the training step, the loss and the
relative L2 of the parameter update). Rounding the full z transpose once,
or blurring in K1's order, lands farther than that.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.models import losses as tlosses
from dpcx_torch.render import fused
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
SHARE = 0.25
D, RADIUS = 72, 9  # dpcx: Dz 8, R = int(2.5 * 0.05 * 72)
# name, renders, points, depth, point weights
CASES = [
    ("d72_depth_weights", 3, 300, True, True),
    ("d72", 2, 400, False, False),
]
NAMES = [c[0] for c in CASES]
# the training step's config (renderer pallas at D 72, float32 compute)
STEP_CFG = dict(
    vox_size=D, pc_num_points=64, image_size=16, encoder_filters=(8,),
    latent_dim=16, fc_hidden=16, pc_decoder_hidden=(16,), num_views=2,
    views_per_step=2, batch_size=2, compute_dtype="float32",
    pc_relative_sigma=0.05, pc_relative_sigma_end=0.05, proj_depth=True,
    drc_weight=0.1, learning_rate=1e-4, renderer="pallas",
    pc_point_dropout=0.5, xla_splat="scatter",
)

DPCX_SCRIPT = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
import dpcx.models.losses as jlosses
from dpcx.config import Config
from dpcx.render.pallas_kernel import pallas_project_t
from dpcx.train import _prep_batch, create_state, train_step

inp = dict(np.load(sys.argv[1]))
out = {}
for name in inp["names"]:
    name = str(name)
    vox, radius, depth, weights = (int(v) for v in inp[name + "__meta"])
    sigma = jnp.float32(inp[name + "__sigma"])
    for acc in ("float32", "bfloat16"):
        def render(ndc, pw):
            sil, dep = pallas_project_t(
                ndc, vox, sigma, radius,
                point_weights=pw if weights else None,
                with_depth=bool(depth), acc_dtype=acc, interpret=True)
            return (sil, dep) if depth else (sil,)

        prim, vjp = jax.vjp(render, jnp.asarray(inp[name + "__ndc"]),
                            jnp.asarray(inp[name + "__pw"]))
        cts = (jnp.asarray(inp[name + "__dsil"]),)
        if depth:
            cts += (jnp.asarray(inp[name + "__ddepth"]),)
        d_ndc, d_pw = vjp(cts)
        out[f"{name}__{acc}__sil"] = np.asarray(prim[0])
        if depth:
            out[f"{name}__{acc}__depth"] = np.asarray(prim[1])
        out[f"{name}__{acc}__d_ndc"] = np.asarray(d_ndc)
        if weights:
            out[f"{name}__{acc}__d_pw"] = np.asarray(d_pw)


def flat(tree, prefix):
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat(v, f"{prefix}{k}/")
        else:
            out[prefix + k] = np.asarray(v)


# one float32 step warms Adam's moments, then one step in each mode
w = jnp.asarray(inp["step__w"])
jlosses.pc_point_dropout_weights = lambda *a: w
cfg = Config(**STEP_CFG)
batches = [{k[len(f"step__b{i}__"):]: inp[k] for k in inp
            if k.startswith(f"step__b{i}__")} for i in (0, 1)]
key = jax.random.PRNGKey(1)
state = create_state(cfg, jax.random.PRNGKey(0))
state, _ = train_step(cfg, state, _prep_batch(batches[0], cfg), key)
adam = state.opt_state[0]
flat(jax.device_get(state.params), "warm__params/")
flat(jax.device_get(adam.mu), "warm__mu/")
flat(jax.device_get(adam.nu), "warm__nu/")
out["warm__count"] = np.asarray(adam.count)
out["warm__step"] = np.asarray(state.step)
for acc in ("float32", "bfloat16"):
    c = cfg.replace(pallas_acc_dtype=acc)
    s, m = train_step(c, jax.tree.map(jnp.copy, state),
                      _prep_batch(batches[1], c), key)
    out[f"step__{acc}__loss"] = np.asarray(m["loss_total"])
    flat(jax.device_get(s.params), f"step__{acc}__params/")
np.savez(sys.argv[2], **out)
""".replace("STEP_CFG", repr(STEP_CFG))


def _inputs(case):
    name, renders, n, depth, weights = case
    rng = np.random.default_rng(n + renders + depth)
    # half on a shell (dense cells), half in a box wider than the grid
    shell = rng.normal(size=(renders, 3, n // 2))
    shell *= 0.3 / np.linalg.norm(shell, axis=1, keepdims=True)
    box = rng.uniform(-0.6, 0.6, (renders, 3, n - n // 2))
    return {
        "ndc": np.concatenate([shell, box], 2).astype(np.float32),
        "pw": rng.uniform(0.0, 2.0, (renders, n)).astype(np.float32),
        "dsil": rng.normal(size=(renders, D, D)).astype(np.float32),
        "ddepth": rng.normal(size=(renders, D, D)).astype(np.float32),
        "sigma": np.float32(0.05 * D),
        "meta": np.array([D, RADIUS, int(depth), int(weights)]),
    }


def _step_inputs():
    """Two training batches (images, blob masks, depths, unit quats) and
    the point dropout weights both sides use."""
    rng = np.random.default_rng(72)
    B, V, S = STEP_CFG["batch_size"], STEP_CFG["num_views"], 16
    yy, xx = np.mgrid[:D, :D] / D - 0.5
    out = {"w": ((rng.random((B, STEP_CFG["pc_num_points"])) < 0.5) / 0.5
                 ).astype(np.float32)}
    for i in (0, 1):
        r = rng.uniform(0.15, 0.35, (B, V, 1, 1))
        masks = ((yy**2 + xx**2) < r**2).astype(np.float32)
        q = rng.normal(size=(B, V, 4))
        out.update({
            f"b{i}__image": rng.random((B, S, S, 3)).astype(np.float32),
            f"b{i}__masks": masks,
            f"b{i}__depths": np.where(masks > 0, rng.uniform(
                -0.3, 0.3, masks.shape), 1.0).astype(np.float32),
            f"b{i}__quats": (q / np.linalg.norm(q, axis=-1, keepdims=True)
                             ).astype(np.float32),
        })
    return out


@pytest.fixture(scope="module")
def dpcx_results(tmp_path_factory):
    """dpcx's forward, gradients and training step in both modes, from one
    subprocess with excess precision off."""
    tmp = tmp_path_factory.mktemp("bf16_blocked")
    arrays = {"names": np.array(NAMES)}
    inputs = {}
    for case in CASES:
        inputs[case[0]] = _inputs(case)
        for k, v in inputs[case[0]].items():
            arrays[f"{case[0]}__{k}"] = v
    inputs["step"] = _step_inputs()
    arrays.update({f"step__{k}": v for k, v in inputs["step"].items()})
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
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return inputs, {k: f[k] for k in f.files}


def _port(inp, depth, weights, grads: bool):
    ndc = torch.from_numpy(inp["ndc"]).requires_grad_(grads)
    pw = (torch.from_numpy(inp["pw"]).requires_grad_(grads) if weights
          else None)
    sil, dep = fused.fused_project_t(
        ndc, D, torch.tensor(inp["sigma"]), RADIUS, point_weights=pw,
        with_depth=depth, acc_dtype="bfloat16")
    if not grads:
        return sil, dep
    loss = (sil * torch.from_numpy(inp["dsil"])).sum()
    if depth:
        loss = loss + (dep * torch.from_numpy(inp["ddepth"])).sum()
    return torch.autograd.grad(loss, (ndc, pw) if weights else (ndc,))


def _check(label, err, dist, floor=1e-4):
    print(f"{label}: port vs dpcx-bf16 {err:.3e}, dpcx-bf16 vs dpcx-f32 "
          f"{dist:.3e}, ratio {err / dist:.3e} (bound {SHARE})")
    assert dist > floor, (label, dist)  # the modes do differ
    assert err <= SHARE * dist, (label, err, dist)


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_bf16_blocked_forward_matches_dpcx(case, dpcx_results):
    """sil and depth of K3's bfloat16 mode (splat, blur z, x, y, each input
    rounded): within SHARE of |dpcx-bf16 - dpcx-f32| (max abs) from
    dpcx-bf16."""
    inputs, ref = dpcx_results
    name, _, _, depth, weights = case
    with torch.no_grad():
        sil, dep = _port(inputs[name], depth, weights, grads=False)
    assert dep is None or depth
    for key, got in [("sil", sil)] + ([("depth", dep)] if depth else []):
        want = ref[f"{name}__bfloat16__{key}"]
        f32 = ref[f"{name}__float32__{key}"]
        _check(f"{name} {key}", np.abs(got.numpy() - want).max(),
               np.abs(want - f32).max())


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_bf16_blocked_gradients_match_dpcx(case, dpcx_results):
    """d ndc (and d weights) through the plain bfloat16 backward of K4 + K5
    (blur transposes x, y, then the z transpose rounded per z-block):
    relative L2 within SHARE of dpcx-bf16's relative L2 distance to
    dpcx-f32."""
    inputs, ref = dpcx_results
    name, _, _, depth, weights = case
    got = _port(inputs[name], depth, weights, grads=True)
    for key, g in zip(("d_ndc", "d_pw"), got):
        want = ref[f"{name}__bfloat16__{key}"]
        f32 = ref[f"{name}__float32__{key}"]
        norm = np.linalg.norm(want)
        _check(f"{name} {key} (relative L2)",
               np.linalg.norm(g.numpy() - want) / norm,
               np.linalg.norm(want - f32) / norm)


def test_bf16_blocked_rounds_the_z_transpose_per_block(dpcx_results):
    """A raw row in several z-blocks' halos takes the f32 sum of each
    block's rounded partial: rounding the whole z transpose once instead
    moves the gradient out of the bound, so the test above sees it."""
    inputs, ref = dpcx_results
    name, _, _, depth, weights = CASES[0]

    def once(dg, K, dz, radius):
        return fused._rnd(torch.einsum("bzyx,zi->biyx", fused._rnd(dg), K))

    real = fused._zblock_transpose
    try:
        fused._zblock_transpose = once
        d_ndc = _port(inputs[name], depth, weights, grads=True)[0]
    finally:
        fused._zblock_transpose = real
    want = ref[f"{name}__bfloat16__d_ndc"]
    dist = np.linalg.norm(want - ref[f"{name}__float32__d_ndc"])
    ratio = np.linalg.norm(d_ndc.numpy() - want) / dist
    print(f"one rounding of the z transpose: ratio {ratio:.3e}")
    assert ratio > SHARE


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def test_bf16_blocked_train_step_matches_dpcx(dpcx_results, monkeypatch):
    """From dpcx's state after one float32 step (params and Adam moments
    carried across by convert.py), one step with pallas_acc_dtype bfloat16
    at D 72: the port's loss and parameter update within SHARE of the
    distance between dpcx's bfloat16 and float32 steps from dpcx's
    bfloat16 step."""
    inputs, ref = dpcx_results
    step = inputs["step"]
    w = torch.from_numpy(step["w"])
    monkeypatch.setattr(tlosses, "pc_point_dropout_weights", lambda *a: w)
    cfg = TConfig(**STEP_CFG).replace(pallas_acc_dtype="bfloat16")
    state = ttrain.create_state(cfg, "cpu")
    warm = params_from_flax(_unflat(ref, "warm__params/"))
    state.model.load_state_dict(warm)
    state.load_adam_state(adam_state_from_optax(
        _unflat(ref, "warm__mu/"), _unflat(ref, "warm__nu/"),
        ref["warm__count"]))
    state.step = int(ref["warm__step"])
    batch = {k[len("b1__"):]: v for k, v in step.items()
             if k.startswith("b1__")}
    m = ttrain.train_step(cfg, state, ttrain._prep_batch(batch, "cpu", cfg),
                          prng.prng_key(1))
    loss = {acc: float(ref[f"step__{acc}__loss"])
            for acc in ("float32", "bfloat16")}
    # the loss is a mean over every pixel: the modes differ by ~1e-5 of it
    _check("train step loss_total", abs(m["loss_total"].item()
                                        - loss["bfloat16"]),
           abs(loss["bfloat16"] - loss["float32"]),
           floor=1e-6 * loss["float32"])

    def update(params):
        return torch.cat([(params[k] - warm[k]).flatten() for k in warm])

    got = update(state.model.state_dict())
    want, f32 = (
        update(params_from_flax(_unflat(ref, f"step__{acc}__params/")))
        for acc in ("bfloat16", "float32"))
    norm = torch.linalg.vector_norm(want).item()
    _check("train step parameter update (relative L2)",
           torch.linalg.vector_norm(got - want).item() / norm,
           torch.linalg.vector_norm(want - f32).item() / norm)
